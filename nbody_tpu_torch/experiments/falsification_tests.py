"""Falsification tests: three ways the quantization-dark-matter hypothesis
could fail.

PyTorch counterpart of ``nbody_tpu.experiments.falsification_tests``
(reference: falsification_tests.py:44-495):

1. **Convergence** — sweep quantization levels 4 -> 1e6; the artifact must
   vanish as precision increases, or it is an implementation bug.
2. **Bullet cluster** — two colliding galaxies; does the density-weighted
   "gravitational center" separate from the center of mass more under int4
   than under the baseline?
3. **Parameter sensitivity** — softening and dt sweeps at fixed int4; a
   real effect must be robust across reasonable parameters.

Every run is on ``--device`` (default ``cuda``; with no card it raises
and names ``--device cpu``).

Usage:
    python -m nbody_tpu_torch.experiments.falsification_tests --quick
    python -m nbody_tpu_torch.experiments.falsification_tests --device cpu --quick
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.experiments._common import energy_drift_pct, to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision, Quantizer
from nbody_tpu_torch.utils.reproducibility import seed_key


def _quantizer_for_levels(levels: int) -> Quantizer:
    """levels >= 100000 means effectively infinite precision
    (reference: falsification_tests.py:270 threshold)."""
    if levels >= 100000:
        return Quantizer(Precision.FLOAT32)
    return Quantizer(Precision.CUSTOM, custom_levels=levels)


# --------------------------------------------------------------------------
# Hole 1: convergence
# --------------------------------------------------------------------------

CONVERGENCE_LEVELS = [4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512,
                      1024, 4096, 65536, 1000000]


def test_convergence(num_stars: int = 800, num_ticks: int = 300,
                     seed: int = 42, device=None):
    """(reference: falsification_tests.py:44-125)"""
    device = _resolve_device(device)
    print("\n" + "=" * 60)
    print("HOLE 1: CONVERGENCE TEST")
    print("Does the effect -> 0 as precision -> infinity?")
    print("=" * 60)

    levels_list = list(CONVERGENCE_LEVELS)
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars=num_stars)
    drifts = []
    for levels in levels_list:
        sim = DirectSimulation(pos, vel, m,
                               precision=_quantizer_for_levels(levels),
                               quantize_forces=False, device=device)
        e0 = sim.get_total_energy()
        sim.step(num_ticks)
        drift = abs(energy_drift_pct(e0, sim.get_total_energy()))
        drifts.append(drift)
        print(f"  {levels:>8d} levels: |drift| = {drift:8.3f}%")

    # Verdict: high-precision tail must be << low-precision head.
    head = np.mean(drifts[:3])
    tail = np.mean(drifts[-3:])
    converges = tail < head * 0.05 or tail < 0.05
    print(f"\n  Head (coarse) mean: {head:.3f}%, tail (fine) mean: "
          f"{tail:.4f}%")
    print("  VERDICT: " + ("PASS — effect converges to zero; it is a "
                           "precision artifact, not a bug"
                           if converges else
                           "FAIL — effect persists at high precision"))
    return {"levels": levels_list, "drifts": drifts,
            "converges": bool(converges)}


# --------------------------------------------------------------------------
# Hole 2: bullet cluster
# --------------------------------------------------------------------------

def _gravitational_center(positions, masses, eps: float = 0.1):
    """Density-weighted center: weights = m_i * sum_j 1/d_ij
    (reference: falsification_tests.py:221-229). O(N^2) on the
    positions' device."""
    pos = positions
    diff = pos[None, :, :] - pos[:, None, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
    local_density = torch.sum(1.0 / dist, dim=1)
    w = local_density * masses
    return torch.sum(pos * w[:, None], dim=0) / torch.sum(w)


def bullet_initial_conditions(num_stars: int, seed: int):
    """Two disks of radius 5 from one generator, 30 apart along x and
    closing at 1.0 (reference: falsification_tests.py:140-160)."""
    gen = seed_key(seed)
    pos1, vel1, m1 = (torch.as_tensor(a) for a in create_disk_galaxy(
        gen, num_stars=num_stars, galaxy_radius=5.0))
    pos2, vel2, m2 = (torch.as_tensor(a) for a in create_disk_galaxy(
        gen, num_stars=num_stars, galaxy_radius=5.0))
    shift = torch.tensor([1.0, 0.0], dtype=pos1.dtype)
    return (torch.cat([pos1 - 15.0 * shift, pos2 + 15.0 * shift]),
            torch.cat([vel1 + 0.5 * shift, vel2 - 0.5 * shift]),
            torch.cat([m1, m2]))


# float64 = the port's native-f64 baseline; "int4" = 16 custom levels
BULLET_PRECISIONS = (("float64", "float64"),
                     ("int4", Quantizer(Precision.CUSTOM, custom_levels=16)))


def test_bullet_cluster(num_stars: int = 1000, num_ticks: int = 800,
                        seed: int = 42, device=None):
    """(reference: falsification_tests.py:132-255)"""
    device = _resolve_device(device)
    print("\n" + "=" * 60)
    print("HOLE 2: BULLET CLUSTER TEST")
    print("Can 'ghost mass' separate from visible mass in a collision?")
    print("=" * 60)

    positions, velocities, masses = bullet_initial_conditions(num_stars,
                                                              seed)
    cfg = SimConfig(softening=0.2)

    results = {}
    for mode_name, precision in BULLET_PRECISIONS:
        print(f"\n  Running collision with {mode_name} precision...")
        sim = DirectSimulation(positions, velocities, masses,
                               precision=precision,
                               cfg=cfg, quantize_forces=False, device=device)
        coms, gcs, ticks = [], [], []
        for start in range(0, num_ticks, 50):
            sim.step(min(50, num_ticks - start))
            com = (torch.sum(sim.positions * sim.masses[:, None], dim=0)
                   / torch.sum(sim.masses))
            coms.append(com)
            gcs.append(_gravitational_center(sim.positions, sim.masses))
            ticks.append(sim.tick)
        results[mode_name] = {"com": to_host(torch.stack(coms)),
                              "grav_center": to_host(torch.stack(gcs)),
                              "ticks": ticks}

    seps = {}
    for mode, h in results.items():
        coms, gravs = h["com"], h["grav_center"]
        seps[mode] = float(np.sqrt(((coms - gravs) ** 2).sum(axis=1)).max())
        print(f"  {mode}: max |COM - grav center| = {seps[mode]:.4f}")

    separated = seps["int4"] > seps["float64"] * 1.5
    print("\n  VERDICT: " + ("int4 shows MORE separation — could support "
                             "mass/gravity separation"
                             if separated else
                             "no significant separation difference — "
                             "quantization does not reproduce the Bullet "
                             "Cluster"))
    return {"separations": seps, "separated": bool(separated)}


# --------------------------------------------------------------------------
# Hole 4 (reference numbering): parameter sensitivity
# --------------------------------------------------------------------------

SOFTENINGS = (0.01, 0.05, 0.1, 0.3, 0.5, 1.0)
DTS = (0.001, 0.005, 0.01, 0.02, 0.05)


def test_parameter_sensitivity(num_stars: int = 600, num_ticks: int = 300,
                               seed: int = 42, device=None):
    """(reference: falsification_tests.py:262-382): the int4 artifact must
    persist across softening in [0.01, 1.0] and dt in [0.001, 0.05]."""
    device = _resolve_device(device)
    print("\n" + "=" * 60)
    print("HOLE 4: PARAMETER SENSITIVITY TEST")
    print("Is the effect robust across softening and dt?")
    print("=" * 60)

    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars=num_stars)
    q = Quantizer(Precision.INT4_SIM)

    soft_sweep = {}
    for soft in SOFTENINGS:
        sim = DirectSimulation(pos, vel, m, precision=q, softening=soft,
                               dynamic_params=True, device=device)
        e0 = sim.get_total_energy()
        sim.step(num_ticks)
        soft_sweep[soft] = energy_drift_pct(e0, sim.get_total_energy())
        print(f"  softening={soft:5.2f}: drift = {soft_sweep[soft]:+8.3f}%")

    dt_sweep = {}
    for dt in DTS:
        sim = DirectSimulation(pos, vel, m, precision=q, dt=dt,
                               dynamic_params=True, device=device)
        e0 = sim.get_total_energy()
        sim.step(num_ticks)
        dt_sweep[dt] = energy_drift_pct(e0, sim.get_total_energy())
        print(f"  dt={dt:6.3f}:        drift = {dt_sweep[dt]:+8.3f}%")

    # Robust = the artifact (positive drift) appears for the majority of
    # parameter settings (reference: falsification_tests.py:357-380).
    all_drifts = list(soft_sweep.values()) + list(dt_sweep.values())
    positive = sum(1 for d in all_drifts if d > 0.01)
    robust = positive >= len(all_drifts) * 0.6
    print(f"\n  {positive}/{len(all_drifts)} settings show energy injection")
    print("  VERDICT: " + ("ROBUST — effect is not a parameter artifact"
                           if robust else
                           "FRAGILE — effect depends on tuning"))
    return {"softening_sweep": soft_sweep, "dt_sweep": dt_sweep,
            "robust": bool(robust)}


def suite_sizes(stars: int, ticks: int, quick: bool) -> dict:
    """Each hole's (num_stars, num_ticks) for main's arguments: --quick is
    400 stars x 200 ticks; convergence caps at 800 x 300, parameter
    sensitivity at 600 x 300."""
    if quick:
        stars, ticks = 400, 200
    return {"convergence": (min(stars, 800), min(ticks, 300)),
            "bullet_cluster": (stars, ticks),
            "parameter_sensitivity": (min(stars, 600), min(ticks, 300))}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Falsification test suite")
    p.add_argument("--stars", type=int, default=1000)
    p.add_argument("--ticks", type=int, default=800)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/falsification")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    s = suite_sizes(args.stars, args.ticks, args.quick)
    report = {
        "convergence": test_convergence(*s["convergence"], args.seed,
                                        device=args.device),
        "bullet_cluster": test_bullet_cluster(*s["bullet_cluster"],
                                              args.seed, device=args.device),
        "parameter_sensitivity": test_parameter_sensitivity(
            *s["parameter_sensitivity"], args.seed, device=args.device),
    }
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "falsification_report.json").write_text(
        json.dumps(report, indent=2))
    print(f"\nReport written to {out / 'falsification_report.json'}")
    return report


if __name__ == "__main__":
    main()
