"""Primary CLI: the precision-ladder comparison workflow.

PyTorch counterpart of ``nbody_tpu.cli`` (reference: main.py:23-212):
build a disk galaxy, run it under several precision modes, write the
four comparison figures and the summary table. Each mode's run keeps its
state on the device and copies its snapshots to the host once.

Usage:
    python -m nbody_tpu_torch --stars 5000 --ticks 2000 --compare float64,int4
    python -m nbody_tpu_torch --quick
    python -m nbody_tpu_torch --stars 131072 --ticks 200 --compare float32,int4 --mesh
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import metrics as metrics_lib
from nbody_tpu_torch.models.direct import DirectSimulation
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops import hopper_nbody
from nbody_tpu_torch.ops.precision import describe_mode, get_mode_from_string
from nbody_tpu_torch.parallel import ring
from nbody_tpu_torch.utils.history import MetricsHistory
from nbody_tpu_torch.utils.profiler import fence
from nbody_tpu_torch.utils.viz import plot_full_comparison, print_summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=("Lossy galaxy simulation (PyTorch / CUDA): testing "
                     "dark matter as rounding errors"),
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""
Examples:
  python -m nbody_tpu_torch --stars 5000 --ticks 2000 --compare float64,int4
  python -m nbody_tpu_torch --quick
  python -m nbody_tpu_torch --stars 10000 --compare float64,float16,int8,int4
  python -m nbody_tpu_torch --stars 131072 --ticks 200 --compare float32,int4 --mesh

Precision modes:
  float64  - native 64-bit baseline
  float32  - 32-bit float
  bfloat16 - brain float (7-bit mantissa)
  float16  - half precision
  int8     - simulated 8-bit (256-level log grid)
  int4     - simulated 4-bit (16-level log grid), most extreme
""")
    p.add_argument("--stars", "-n", type=int, default=3000,
                   help="number of stars (default: 3000)")
    p.add_argument("--ticks", "-t", type=int, default=1000,
                   help="number of simulation ticks (default: 1000)")
    p.add_argument("--compare", "-c", type=str, default="float64,int4",
                   help="comma-separated precision modes (default: float64,int4)")
    p.add_argument("--output", "-o", type=str, default="output",
                   help="output directory for plots")
    p.add_argument("--quick", action="store_true",
                   help="quick test mode (500 stars, 500 ticks)")
    p.add_argument("--no-show", action="store_true",
                   help="don't display plots (always true: headless Agg backend)")
    p.add_argument("--dt", type=float, default=0.01, help="time step")
    p.add_argument("--G", type=float, default=0.001,
                   help="gravitational constant")
    p.add_argument("--seed", type=int, default=42, help="torch RNG seed for ICs")
    p.add_argument("--snapshot-interval", type=int, default=100,
                   help="ticks between on-device metric snapshots")
    p.add_argument("--force-impl", type=str, default="auto",
                   choices=["auto", "dense", "tiled", "kernel"],
                   help="force implementation (auto = the sym_force "
                        "kernel, chunked past its scratch budget)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--mesh", type=int, nargs="?", const=0, default=None,
                   metavar="N",
                   help=("run sharded over an N-device mesh of --device's "
                         "type (bare --mesh = all local devices): particles "
                         "ring-sharded, forces via the half-ring "
                         "Newton's-third-law schedule, energies from the "
                         "energy ring"))
    p.add_argument("--schedule", type=str, default="sym",
                   choices=["sym", "rows"],
                   help="ring force schedule for --mesh runs")
    p.add_argument("--bounds-every", type=int, default=1, metavar="K",
                   help="int-sim modes: recompute the global log-grid "
                        "bounds every K steps instead of every force "
                        "evaluation (K=1 = exact reference semantics)")
    p.add_argument("--ticks-per-dispatch", type=int, default=None,
                   metavar="T",
                   help="mesh runs: cap the ticks of each call into the "
                        "ring runners (identical physics)")
    return p


RING_KERNELS = ("sym_force", "sym_force_uniform", "pair_sym_force",
                "pair_sym_force_uniform", "row_force", "pair_force",
                "max_d2", "pair_max", "pair_pe_rows")
EQUAL_MASS = ("sym_force_uniform", "sym_force_uniform_max",
              "pair_sym_force_uniform")


def force_path(launched: dict, schedule: str | None = None) -> str:
    """Which force path a run took: a mesh run names its ring
    ``schedule`` and the kernels it launched; a single-device run is
    told apart by its kernel launch counts. Launches of the sym kernels'
    equal-mass variants name that variant."""
    def n(*keys):
        return sum(launched.get(k, 0) for k in keys)

    equal = " + ".join(k for k in EQUAL_MASS if n(k))
    variant = f", equal-mass variant ({equal})" if equal else ""
    if schedule is not None:
        name = "rows" if schedule == "rows" else "sym (half ring)"
        kernels = (" + ".join(k for k in RING_KERNELS if n(k))
                   or "no kernel launched: CPU plain versions or the f64 "
                      "baseline")
        return f"ring, {name} schedule ({kernels})"
    if n("pair_sym_force", "pair_sym_force_uniform"):
        return ("chunked Newton's-third-law (sym_force + pair_sym_force)"
                + variant)
    if n("row_force"):
        return "row sweep (row_force)"
    if n("sym_force", "sym_force_uniform"):
        return "single-launch sym_force" + variant
    if n("sym_force_max", "sym_force_uniform_max"):
        return "single-launch sym_force with the fused max" + variant
    return "no force kernel launched (CPU plain versions or the f64 baseline)"


def _resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {name}: CUDA is not available "
                         f"here (pass --device cpu to run on the CPU)")
    return device


def run_compare(args) -> dict:
    device = _resolve_device(args.device)
    if args.quick:
        args.stars = 500
        args.ticks = 500
        print("Quick mode: 500 stars, 500 ticks")

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    print(f"\nDevice: {device} ({name})")

    mode_strings = [s.strip() for s in args.compare.split(",")]
    try:
        modes = [get_mode_from_string(s, strict=True) for s in mode_strings]
    except ValueError as e:
        raise SystemExit(f"error: {e}")
    print("\nPrecision modes to compare:")
    for mode in modes:
        print(f"  - {mode.value}: {describe_mode(mode)}")

    print(f"\nCreating galaxy with {args.stars} stars...")
    gen = torch.Generator().manual_seed(args.seed)
    positions, velocities, masses = create_disk_galaxy(
        gen, num_stars=args.stars, galaxy_radius=10.0, G=args.G,
        device=device)
    print(f"  Position range: [{float(positions.min()):.2f}, "
          f"{float(positions.max()):.2f}]")
    print(f"  Velocity range: [{float(velocities.min()):.2f}, "
          f"{float(velocities.max()):.2f}]")

    cfg = SimConfig(G=args.G, dt=args.dt)
    histories, final_positions = {}, {}

    mesh = None
    if args.mesh is not None:
        try:
            mesh = ring.make_particle_mesh(args.mesh or None, device)
        except ValueError as e:
            raise SystemExit(f"error: --mesh: {e}")
        print(f"\nMesh: {mesh.size} device(s), schedule={args.schedule} "
              f"(particle-ring sharding)")
    elif args.ticks_per_dispatch is not None:
        raise SystemExit("--ticks-per-dispatch requires --mesh (it bounds "
                         "the sharded runners' dispatches; single-device "
                         "runs are chunked via the snapshot interval)")

    for mode in modes:
        print(f"\n{'=' * 50}\nRunning simulation: {mode.value}\n{'=' * 50}")
        launches0 = dict(hopper_nbody.LAUNCHES)
        sim = DirectSimulation(positions, velocities, masses, precision=mode,
                               cfg=cfg, force_impl=args.force_impl,
                               bounds_every=args.bounds_every, device=device,
                               mesh=mesh, schedule=args.schedule,
                               ticks_per_dispatch=args.ticks_per_dispatch)
        snap0 = metrics_lib.to_host(metrics_lib.snapshot(
            sim.positions, sim.velocities, sim.masses, sim.tick, cfg,
            compensated=sim.is_baseline))
        fence(sim.state.positions)
        t0 = time.time()
        snaps, frames = sim.run_with_history(
            args.ticks, snapshot_interval=args.snapshot_interval)
        fence(sim.state.positions)
        wall = time.time() - t0
        h = MetricsHistory.from_snapshots(snaps, initial=snap0)
        histories[mode.value] = h
        final_positions[mode.value] = sim.positions.cpu().numpy()
        pairs_per_sec = args.stars ** 2 * args.ticks / max(wall, 1e-9)
        print(f"  {args.ticks} ticks in {wall:.2f}s "
              f"({args.ticks / max(wall, 1e-9):.1f} ticks/s, "
              f"{pairs_per_sec:.2e} pairwise interactions/s)")
        launched = {k: hopper_nbody.LAUNCHES[k] - launches0[k]
                    for k in hopper_nbody.LAUNCHES}
        print(f"  kernel launches: {json.dumps(launched)}")
        schedule = args.schedule if mesh is not None else None
        print(f"  force path: {force_path(launched, schedule)}")
        for tick, e in zip(h.ticks[::2], h.total_energy[::2]):
            print(f"  Tick {tick}: Energy={e:.4f}")

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"\n{'=' * 50}\nGenerating comparison plots...\n{'=' * 50}")
    try:
        plot_full_comparison(final_positions, histories, save_dir=str(out_dir))
        saved = f"Plots saved to: {out_dir.absolute()}"
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        saved = "Plots skipped: matplotlib is not installed"
    print_summary(histories)
    print(f"\n{saved}")
    print("\nLook for these effects:")
    print("  1. Rotation curve: flatter in quantized mode = 'dark matter'")
    print("  2. Energy: increasing in quantized mode = rounding injecting energy")
    print("  3. Radius: smaller in quantized mode = stars staying more bound")
    return histories


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run_compare(args)


if __name__ == "__main__":
    main()
