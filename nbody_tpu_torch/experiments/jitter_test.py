"""Jitter test: is "dark matter" simulation lag?

PyTorch counterpart of ``nbody_tpu.experiments.jitter_test``
(reference: jitter_test.py:45-535):

* nested multi-scale system — concentric galaxies at radius 10/5/2.5 with
  masses doubling per level (reference: jitter_test.py:45-86);
* frame-rate sweep — run the same *physical* duration at dt in
  {0.1 ... 0.001} and measure trajectory jitter via second differences of
  sampled positions/velocities (reference: jitter_test.py:122-250);
* velocity sweep — probe 0.1c..0.9c of the sim speed limit c=10 and
  measure jitter growth (reference: jitter_test.py:89-119, 253-320);
* verdicts via correlation of jitter with dt and with beta
  (reference: jitter_test.py:427-484).

The runs are on ``--device`` (default ``cuda``; with no card it raises and
names ``--device cpu``); the samples stay on the device until a run's end.

Usage:
    python -m nbody_tpu_torch.experiments.jitter_test --quick
    python -m nbody_tpu_torch.experiments.jitter_test --device cpu --quick
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.experiments._common import to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.reproducibility import seed_key

C_SIM = 10.0  # simulation speed limit for the velocity sweep
NESTED_LEVELS = 3     # disks of the nested system
NUM_SAMPLES = 30      # samples of one measure_jitter run
FRAME_TIME = 2.0      # the frame-rate sweep's physical duration
VELOCITY_DT, VELOCITY_TIME = 0.01, 1.0   # the velocity sweep's runs


def nested_galaxies(generator: torch.Generator, stars_per_level: int = 300,
                    levels: int = NESTED_LEVELS):
    """Concentric multi-scale system (reference: jitter_test.py:45-86): the
    disks are drawn one after another from ``generator`` (JAX splits its
    key ``levels`` ways), level k's masses scaled by 2^k."""
    parts = []
    for lvl in range(levels):
        radius = 10.0 / (2 ** lvl)
        pos, vel, m = create_disk_galaxy(generator,
                                         num_stars=stars_per_level,
                                         galaxy_radius=radius)
        parts.append((pos, vel, m * (2.0 ** lvl)))
    return tuple(torch.cat([torch.as_tensor(p[i]) for p in parts])
                 for i in range(3))


def suite_sizes(quick: bool) -> dict:
    """The sweeps' star counts at --quick or at the full defaults: stars a
    level of the nested system, stars of the velocity sweep's disk."""
    return {"nested_stars": 150 if quick else 300,
            "disk_stars": 150 if quick else 400}


def sample_plan(dt: float, total_time: float,
                num_samples: int = NUM_SAMPLES) -> tuple:
    """(ticks, ticks between samples) of a run of total_time at dt: at
    least one tick a sample."""
    num_ticks = max(int(round(total_time / dt)), num_samples)
    return num_ticks, max(num_ticks // num_samples, 1)


def measure_jitter(pos, vel, m, dt: float, total_time: float,
                   num_samples: int = NUM_SAMPLES, device=None):
    """Second-difference jitter of sampled trajectories
    (reference: jitter_test.py:122-159): run the SAME physical duration
    at step dt, sample num_samples times at (as nearly as possible) equal
    physical spacing, and normalise the second differences by the sample
    spacing squared — an acceleration-noise proxy comparable across dt
    (the raw |d2 P| scales like spacing^2 for perfect physics). The
    samples are stacked on the device and copied to the host once."""
    _, interval = sample_plan(dt, total_time, num_samples)
    sample_dt = interval * dt  # physical spacing between samples
    sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                           dt=dt, dynamic_params=True, device=device)
    e0 = sim.get_total_energy()
    pos_frames, vel_frames = [], []
    for _ in range(num_samples):
        sim.step(interval)
        pos_frames.append(sim.positions)
        vel_frames.append(sim.velocities)
    P = to_host(torch.stack(pos_frames))   # (S, N, D)
    V = to_host(torch.stack(vel_frames))
    pos_jitter = float(np.abs(np.diff(P, n=2, axis=0)).mean()) / sample_dt ** 2
    vel_jitter = float(np.abs(np.diff(V, n=2, axis=0)).mean()) / sample_dt ** 2
    e1 = sim.get_total_energy()
    drift_pct = (e1 - e0) / abs(e0) * 100 if abs(e0) > 1e-12 else 0.0
    return pos_jitter, vel_jitter, drift_pct


FRAME_DTS = [0.1, 0.05, 0.02, 0.01, 0.005, 0.001]
BETAS = [0.1, 0.3, 0.5, 0.7, 0.9]


def frame_rate_sweep(generator: torch.Generator,
                     total_time: float = FRAME_TIME, quick: bool = False,
                     device=None):
    """(reference: jitter_test.py:162-250)"""
    print("\n--- FRAME-RATE SWEEP (same physical time, varying dt) ---")
    pos, vel, m = nested_galaxies(
        generator, stars_per_level=suite_sizes(quick)["nested_stars"])
    rows = []
    for dt in FRAME_DTS:
        pj, vj, drift = measure_jitter(pos, vel, m, dt, total_time,
                                       device=device)
        rows.append({"dt": dt, "pos_jitter": pj, "vel_jitter": vj,
                     "energy_drift_pct": drift})
        print(f"  dt={dt:6.3f}: pos jitter={pj:.3e}  vel jitter={vj:.3e}  "
              f"dE={drift:+.4f}%")
    # correlation of jitter with dt
    logs = np.log10([r["dt"] for r in rows])
    pjs = np.log10([max(r["pos_jitter"], 1e-12) for r in rows])
    corr = float(np.corrcoef(logs, pjs)[0, 1])
    print(f"  corr(log dt, log jitter) = {corr:+.3f}")
    return {"rows": rows, "dt_jitter_correlation": corr,
            "lag_creates_jitter": corr > 0.5}


def velocity_sweep(generator: torch.Generator, quick: bool = False,
                   device=None):
    """(reference: jitter_test.py:253-320): jitter vs fraction of c_sim."""
    print("\n--- VELOCITY SWEEP (0.1c .. 0.9c of c_sim=10) ---")
    pos, vel, m = (torch.as_tensor(a) for a in create_disk_galaxy(
        generator, num_stars=suite_sizes(quick)["disk_stars"]))
    rows = []
    for beta in BETAS:
        boost = beta * C_SIM / max(float(torch.abs(vel).max()), 1e-9)
        pj, vj, drift = measure_jitter(pos, vel * boost, m, dt=VELOCITY_DT,
                                       total_time=VELOCITY_TIME,
                                       device=device)
        rows.append({"beta": beta, "pos_jitter": pj, "vel_jitter": vj,
                     "energy_drift_pct": drift})
        print(f"  v={beta:.1f}c: pos jitter={pj:.3e}  vel jitter={vj:.3e}  "
              f"dE={drift:+.4f}%")
    betas = [r["beta"] for r in rows]
    pjs = [r["pos_jitter"] for r in rows]
    corr = float(np.corrcoef(betas, pjs)[0, 1])
    print(f"  corr(beta, jitter) = {corr:+.3f}")
    return {"rows": rows, "beta_jitter_correlation": corr,
            "speed_creates_jitter": corr > 0.5}


def print_analysis(fr: dict, vs: dict):
    """The reference's full verdict battery (jitter_test.py:427-484):
    analysis tables with per-row energy drift, ratio verdicts (does
    jitter grow >1.5x across the sweep?) AND the correlation verdicts."""
    print("\n" + "=" * 60)
    print("JITTER HYPOTHESIS ANALYSIS")
    print("=" * 60)
    print("\nFRAME RATE TEST:")
    print("-" * 62)
    print(f"{'dt':<10} {'FPS':<8} {'Pos Jitter':<12} {'Vel Jitter':<12} "
          f"{'Energy %':<10}")
    print("-" * 62)
    for r in fr["rows"]:
        print(f"{r['dt']:<10.4f} {1 / r['dt']:<8.0f} "
              f"{r['pos_jitter']:<12.4e} {r['vel_jitter']:<12.4e} "
              f"{r['energy_drift_pct']:<+10.4f}")
    print("\nVELOCITY TEST:")
    print("-" * 50)
    print(f"{'V/c':<8} {'Pos Jitter':<12} {'Vel Jitter':<12} "
          f"{'Energy %':<10}")
    print("-" * 50)
    for r in vs["rows"]:
        print(f"{r['beta']:<8.2f} {r['pos_jitter']:<12.4e} "
              f"{r['vel_jitter']:<12.4e} {r['energy_drift_pct']:<+10.4f}")

    print("\n" + "-" * 40)
    print("VERDICT:")
    # ratio verdicts (reference: :465-484); rows are ordered dt desc =
    # FPS ascending, so [-1] is the highest frame rate / velocity
    fr_jit = [r["vel_jitter"] for r in fr["rows"]]
    fr["jitter_grows_with_fps"] = bool(fr_jit[-1] > fr_jit[0] * 1.5)
    if fr["jitter_grows_with_fps"]:
        print("  + Jitter INCREASES with frame rate "
              "(supports the 'simulation lag' hypothesis)")
    else:
        print("  - Jitter does NOT increase with frame rate")
    vs_jit = [r["vel_jitter"] for r in vs["rows"]]
    vs["jitter_grows_with_speed"] = bool(vs_jit[-1] > vs_jit[0] * 1.5)
    if vs["jitter_grows_with_speed"]:
        print("  + Jitter INCREASES with velocity "
              "(fast objects jitter more, like near light speed)")
    else:
        print("  - Jitter does NOT increase with velocity")
    print(f"  corr(log dt, log jitter) = "
          f"{fr['dt_jitter_correlation']:+.3f} -> frame-rate lag "
          f"{'CONFIRMED' if fr['lag_creates_jitter'] else 'not supported'}")
    print(f"  corr(beta, jitter)       = "
          f"{vs['beta_jitter_correlation']:+.3f} -> speed-jitter "
          f"{'CONFIRMED' if vs['speed_creates_jitter'] else 'not supported'}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Jitter / simulation-lag test")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/jitter")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)

    print("\n" + "=" * 60)
    print("JITTER TEST: is 'dark matter' simulation lag?")
    print("=" * 60)

    # One generator for both sweeps, drawn in turn (JAX splits its key).
    gen = seed_key(args.seed)
    fr = frame_rate_sweep(gen, quick=args.quick, device=device)
    vs = velocity_sweep(gen, quick=args.quick, device=device)

    print_analysis(fr, vs)

    report = {"frame_rate_sweep": fr, "velocity_sweep": vs}
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "jitter_report.json").write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
