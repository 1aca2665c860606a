"""Crash-point hunt: where does reality break?

PyTorch counterpart of ``nbody_tpu.experiments.crash_point_test``
(reference: crash_point_test.py:46-647): a six-class crash detector
(NaN / Inf / teleportation / velocity overflow vs c_sim=100 / energy
singularity / galaxy explosion) applied across four parameter sweeps —
velocity multiplier 1-1000x, dt 0.001-2.0, quantization 1e6 -> 2 levels,
softening 1.0 -> 1e-4 — plus a summary mapping crash points to
physical-constant analogies. The ticks run on ``--device`` (default
``cuda``; with no card it raises and names ``--device cpu``); the detector
reads the state on the host once every ``check`` ticks, as in JAX.

Usage:
    python -m nbody_tpu_torch.experiments.crash_point_test --quick
    python -m nbody_tpu_torch.experiments.crash_point_test --device cpu --stars 48 --ticks 40
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.experiments._common import to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision, Quantizer
from nbody_tpu_torch.utils.reproducibility import seed_key

C_SIM = 100.0  # the simulation's "speed of light"
CHECK = 10     # ticks between crash checks (_run_until_crash)

VELOCITY_MULTIPLIERS = [1, 2, 5, 10, 20, 50, 100, 200, 500, 1000]
DTS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0]
LEVELS = [1000000, 65536, 4096, 256, 64, 16, 8, 4, 3, 2]
SOFTENINGS = [1.0, 0.5, 0.1, 0.05, 0.01, 0.005, 0.001, 5e-4, 1e-4]


@dataclasses.dataclass
class CrashReport:
    parameter: str
    value: float
    crash_type: str
    tick: int
    details: str
    severity: float


def detect_crash(positions, velocities, prev_positions, energy, prev_energy,
                 dt: float, tick: int,
                 ticks_elapsed: int = 1) -> Optional[CrashReport]:
    """Six crash classes (reference: crash_point_test.py:46-139), on host
    numpy.

    ``ticks_elapsed`` is the number of ticks since prev_positions; the
    teleportation threshold scales with it (the reference checks every
    single tick, this engine checks per chunk)."""
    pos = to_host(positions)
    vel = to_host(velocities)
    if np.isnan(pos).any() or np.isnan(vel).any():
        return CrashReport("nan", 0, "NaN_EXPLOSION", tick,
                           "Positions or velocities became NaN", 1.0)
    if np.isinf(pos).any() or np.isinf(vel).any():
        return CrashReport("inf", 0, "INFINITY_OVERFLOW", tick,
                           "Values exceeded representable range", 1.0)

    if prev_positions is not None:
        disp = np.sqrt(((pos - to_host(prev_positions)) ** 2).sum(-1))
        max_disp = float(disp.max())
        max_speed_now = float(np.sqrt((vel ** 2).sum(-1)).max())
        expected = max_speed_now * dt * ticks_elapsed * 10.0
        if max_disp > expected and max_disp > 1.0:
            return CrashReport("teleport", max_disp, "TELEPORTATION", tick,
                               f"Object moved {max_disp:.2f} in one tick "
                               f"(expected max {expected:.2f})",
                               min(1.0, max_disp / 100))

    max_speed = float(np.sqrt((vel ** 2).sum(-1)).max())
    if max_speed > C_SIM:
        return CrashReport("velocity", max_speed, "VELOCITY_OVERFLOW", tick,
                           f"Object exceeds c_sim ({max_speed:.2f} > "
                           f"{C_SIM})", min(1.0, max_speed / (C_SIM * 10)))

    if prev_energy not in (None, 0):
        ratio = abs(energy / prev_energy)
        if ratio > 100 or ratio < 0.01:
            return CrashReport("energy", energy, "ENERGY_SINGULARITY", tick,
                               f"Energy changed by {ratio:.2f}x in one "
                               "interval",
                               min(1.0, abs(np.log10(max(ratio, 1e-12))) / 5))

    max_radius = float(np.sqrt((pos ** 2).sum(-1)).max())
    if max_radius > 1000:
        return CrashReport("radius", max_radius, "GALAXY_EXPLOSION", tick,
                           f"Galaxy radius exploded to {max_radius:.2f}",
                           min(1.0, max_radius / 10000))
    return None


def _run_until_crash(pos, vel, m, quantizer, cfg: SimConfig,
                     max_ticks: int, check: int = CHECK,
                     dynamic: bool = False, device=None):
    # dynamic=True: dt/softening become run-time device scalars, so a
    # sweep over them changes no launch parameter.
    sim = DirectSimulation(pos, vel, m, precision=quantizer,
                           dt=cfg.dt, softening=cfg.softening,
                           dynamic_params=True, device=device) if dynamic \
        else DirectSimulation(pos, vel, m, precision=quantizer, cfg=cfg,
                              device=device)
    prev_pos = None
    prev_energy = None
    energy = sim.get_total_energy()
    for tick in range(0, max_ticks, check):
        prev_pos = to_host(sim.positions)
        prev_energy = energy
        sim.step(check)
        energy = sim.get_total_energy()
        crash = detect_crash(sim.positions, sim.velocities, prev_pos,
                             energy, prev_energy, cfg.dt, tick + check,
                             ticks_elapsed=check)
        if crash:
            return crash
    return None


def find_velocity_crash_point(num_stars, max_ticks, seed, device=None):
    """(reference: crash_point_test.py:142-225)"""
    print("\n--- VELOCITY SWEEP (multiplier 1-1000x) ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    results = []
    for mult in VELOCITY_MULTIPLIERS:
        crash = _run_until_crash(pos, vel * mult, m,
                                 Quantizer(Precision.FLOAT32), SimConfig(),
                                 max_ticks, device=device)
        results.append({"multiplier": mult,
                        "crash": dataclasses.asdict(crash) if crash else None})
        print(f"  v x{mult:4d}: "
              f"{crash.crash_type if crash else 'survived'}")
        if crash and crash.crash_type in ("NaN_EXPLOSION",
                                          "INFINITY_OVERFLOW"):
            break
    first = next((r["multiplier"] for r in results if r["crash"]), None)
    return {"sweep": results, "first_crash_multiplier": first}


def find_dt_crash_point(num_stars, max_ticks, seed, device=None):
    """(reference: crash_point_test.py:228-299)"""
    print("\n--- TIME-STEP SWEEP (dt 0.001-2.0) ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    results = []
    for dt in DTS:
        crash = _run_until_crash(pos, vel, m, Quantizer(Precision.FLOAT32),
                                 SimConfig(dt=dt), max_ticks, dynamic=True,
                                 device=device)
        results.append({"dt": dt,
                        "crash": dataclasses.asdict(crash) if crash else None})
        print(f"  dt={dt:6.3f}: {crash.crash_type if crash else 'survived'}")
    first = next((r["dt"] for r in results if r["crash"]), None)
    return {"sweep": results, "first_crash_dt": first}


def level_quantizer(levels: int) -> Quantizer:
    """float32 from 100000 levels up, else the custom grid of ``levels``."""
    return (Quantizer(Precision.FLOAT32) if levels >= 100000
            else Quantizer(Precision.CUSTOM, custom_levels=levels))


def find_quantization_crash_point(num_stars, max_ticks, seed, device=None):
    """(reference: crash_point_test.py:302-394)"""
    print("\n--- QUANTIZATION SWEEP (1e6 -> 2 levels) ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    results = []
    for levels in LEVELS:
        crash = _run_until_crash(pos, vel, m, level_quantizer(levels),
                                 SimConfig(), max_ticks, device=device)
        results.append({"levels": levels,
                        "crash": dataclasses.asdict(crash) if crash else None})
        print(f"  {levels:>7d} levels: "
              f"{crash.crash_type if crash else 'survived'}")
    first = next((r["levels"] for r in results if r["crash"]), None)
    return {"sweep": results, "first_crash_levels": first}


def find_softening_crash_point(num_stars, max_ticks, seed, device=None):
    """(reference: crash_point_test.py:397-466)"""
    print("\n--- SOFTENING SWEEP (1.0 -> 1e-4) ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    results = []
    for soft in SOFTENINGS:
        crash = _run_until_crash(pos, vel, m, Quantizer(Precision.FLOAT32),
                                 SimConfig(softening=soft), max_ticks,
                                 dynamic=True, device=device)
        results.append({"softening": soft,
                        "crash": dataclasses.asdict(crash) if crash else None})
        print(f"  eps={soft:7.4f}: "
              f"{crash.crash_type if crash else 'survived'}")
    first = next((r["softening"] for r in results if r["crash"]), None)
    return {"sweep": results, "first_crash_softening": first}


def print_crash_summary(report: dict):
    """Physical-constant analogy table
    (reference: crash_point_test.py:548-605)."""
    print("\n" + "=" * 64)
    print("CRASH-POINT SUMMARY: simulation limits vs physical constants")
    print("=" * 64)
    v = report["velocity"]["first_crash_multiplier"]
    print(f"  velocity overflow at ~{v}x baseline"
          f"  <->  speed of light (hard speed limit)" if v else
          "  no velocity crash found in range")
    dt = report["dt"]["first_crash_dt"]
    print(f"  dt instability at {dt}"
          f"  <->  Planck time (minimum meaningful tick)" if dt else
          "  no dt crash found in range")
    lv = report["quantization"]["first_crash_levels"]
    print(f"  quantization breakdown at {lv} levels"
          f"  <->  quantum uncertainty (resolution floor)" if lv else
          "  no quantization crash found in range")
    s = report["softening"]["first_crash_softening"]
    print(f"  softening collapse below {s}"
          f"  <->  Planck length (minimum resolvable distance)" if s else
          "  no softening crash found in range")
    print("=" * 64)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Crash-point hunt")
    p.add_argument("--stars", type=int, default=800)
    p.add_argument("--ticks", type=int, default=300)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/crash_point")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def suite_sizes(argv=None) -> tuple:
    """(stars, ticks) of a main(argv) run."""
    args = build_parser().parse_args(argv)
    return (300, 100) if args.quick else (args.stars, args.ticks)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)
    stars, ticks = suite_sizes(argv)

    report = {
        "velocity": find_velocity_crash_point(stars, ticks, args.seed,
                                              device),
        "dt": find_dt_crash_point(stars, ticks, args.seed, device),
        "quantization": find_quantization_crash_point(stars, ticks,
                                                      args.seed, device),
        "softening": find_softening_crash_point(stars, ticks, args.seed,
                                                device),
    }
    print_crash_summary(report)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "crash_point_report.json").write_text(
        json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()
