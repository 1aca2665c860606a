"""SPARC validation: does the quantization artifact match REAL galaxies?

PyTorch counterpart of ``nbody_tpu.experiments.sparc_test``
(reference: sparc_test.py:29-369): four SPARC-like rotation curves
(observed, baryonic-only prediction, errors) are scaled to simulation
units; float64-baseline and int4 runs are chi^2-compared against both the
observed (dark-matter) curve and the baryonic-only curve — "does int4 look
more like dark matter than the baseline does?" The runs are on
``--device`` (default ``cuda``; with no card it raises and names
``--device cpu``).

Galaxy fixture values follow the published SPARC-style shapes used by the
reference (full dataset: http://astroweb.cwru.edu/SPARC/).

Usage:
    python -m nbody_tpu_torch.experiments.sparc_test --stars 1500 --ticks 400
    python -m nbody_tpu_torch.experiments.sparc_test --device cpu --stars 64 --ticks 40
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from nbody_tpu_torch.diagnostics.metrics import rotation_curve
from nbody_tpu_torch.experiments._common import to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.reproducibility import seed_key


@dataclasses.dataclass
class GalaxyData:
    """(reference schema: sparc_test.py:29-41)"""

    name: str
    distance_mpc: float
    luminosity_solar: float
    scale_length_kpc: float
    observed_radii: np.ndarray
    observed_velocity: np.ndarray
    velocity_error: np.ndarray
    baryonic_velocity: np.ndarray


GALAXY_DATABASE = {
    "NGC2403": GalaxyData(
        "NGC 2403", 3.2, 5.2e9, 1.7,
        np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 13.0, 16.0, 20.0]),
        np.array([40, 70, 100, 115, 125, 130, 132, 130, 128, 125.0]),
        np.array([5, 5, 5, 5, 5, 5, 6, 7, 8, 10.0]),
        np.array([38, 68, 95, 100, 90, 78, 65, 55, 48, 42.0]),
    ),
    "NGC7331": GalaxyData(
        "NGC 7331", 14.7, 5.5e10, 3.2,
        np.array([1, 3, 5, 8, 12, 16, 20, 25, 30.0]),
        np.array([150, 220, 245, 250, 248, 245, 242, 238, 235.0]),
        np.array([10, 8, 6, 5, 5, 6, 8, 10, 12.0]),
        np.array([145, 210, 225, 200, 165, 140, 120, 100, 88.0]),
    ),
    "MilkyWay": GalaxyData(
        "Milky Way", 0.0, 6e10, 2.6,
        np.array([2, 4, 6, 8, 10, 12, 14, 16, 18, 20.0]),
        np.array([200, 220, 225, 225, 220, 218, 215, 212, 210, 208.0]),
        np.array([10, 8, 5, 5, 5, 5, 6, 8, 10, 12.0]),
        np.array([195, 210, 200, 175, 150, 130, 115, 100, 90, 80.0]),
    ),
    "UGC128": GalaxyData(
        "UGC 128 (Low Surface Brightness)", 64.0, 1.2e9, 6.5,
        np.array([2, 5, 10, 15, 20, 25, 30, 35.0]),
        np.array([50, 75, 95, 108, 115, 118, 120, 120.0]),
        np.array([8, 7, 6, 6, 7, 8, 10, 12.0]),
        np.array([30, 45, 50, 45, 38, 32, 28, 25.0]),
    ),
}


def scale_galaxy_to_simulation(galaxy: GalaxyData) -> dict:
    """Normalise radii to sim scale (galaxy_radius ~ 10) and velocities to
    the observed max (reference: sparc_test.py:91-108)."""
    r_max = galaxy.observed_radii.max()
    s = 10.0 / r_max
    v_max = galaxy.observed_velocity.max()
    return {
        "radii_sim": galaxy.observed_radii * s,
        "v_observed": galaxy.observed_velocity / v_max,
        "v_baryonic": galaxy.baryonic_velocity / v_max,
        "v_error": galaxy.velocity_error / v_max,
    }


def compute_fit_quality(sim_radii, sim_velocities, target_radii, target_v,
                        target_err) -> float:
    """Reduced chi^2 of the (normalised) simulated curve vs a target
    (reference: sparc_test.py:173-208)."""
    sim_v = to_host(sim_velocities).astype(float)
    valid = ~np.isnan(sim_v)
    if valid.sum() < 3:
        return float("inf")
    sr, sv = to_host(sim_radii)[valid], sim_v[valid]
    sv = sv / max(sv.max(), 1e-9)
    interp_v = np.interp(target_radii, sr, sv)
    chi2 = np.sum(((interp_v - target_v) / np.maximum(target_err, 1e-3)) ** 2)
    return float(chi2 / len(target_radii))


# float64 is the port's native-f64 baseline
MODES = (Precision.FLOAT64, Precision.INT4_SIM)


def run_galaxy(name: str, galaxy: GalaxyData, num_stars: int,
               num_ticks: int, seed: int, device=None) -> dict:
    device = _resolve_device(device)
    scaled = scale_galaxy_to_simulation(galaxy)
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars=num_stars,
                                     galaxy_radius=10.0)
    out = {"name": galaxy.name}
    for mode in MODES:
        sim = DirectSimulation(pos, vel, m, precision=mode, device=device)
        sim.step(num_ticks)
        curve = rotation_curve(sim.positions, sim.velocities, num_bins=15)
        chi2_obs = compute_fit_quality(curve.radii, curve.velocities,
                                       scaled["radii_sim"],
                                       scaled["v_observed"],
                                       scaled["v_error"])
        chi2_bar = compute_fit_quality(curve.radii, curve.velocities,
                                       scaled["radii_sim"],
                                       scaled["v_baryonic"],
                                       scaled["v_error"])
        out[mode.value] = {"chi2_observed": chi2_obs,
                           "chi2_baryonic": chi2_bar,
                           "fits_dm_better": chi2_obs < chi2_bar}
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SPARC rotation-curve validation")
    p.add_argument("--stars", type=int, default=1500)
    p.add_argument("--ticks", type=int, default=400)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/sparc")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    print("\n" + "=" * 64)
    print("SPARC VALIDATION: simulated curves vs real galaxy shapes")
    print("=" * 64)

    results = {}
    for key_name, galaxy in GALAXY_DATABASE.items():
        print(f"\n  {galaxy.name}:")
        r = run_galaxy(key_name, galaxy, args.stars, args.ticks, args.seed,
                       device=args.device)
        results[key_name] = r
        for mode in (m.value for m in MODES):
            d = r[mode]
            print(f"    {mode:9s}: chi2 vs observed(DM)={d['chi2_observed']:8.2f}  "
                  f"vs baryonic-only={d['chi2_baryonic']:8.2f}  "
                  f"{'-> DM-like' if d['fits_dm_better'] else '-> baryonic-like'}")

    # Verdict: does int4 match the DM curve better than the baseline does?
    int4_dm = sum(1 for r in results.values()
                  if r["int4_sim"]["fits_dm_better"])
    f64_dm = sum(1 for r in results.values()
                 if r["float64"]["fits_dm_better"])
    print(f"\n  int4 fits the DM curve better in {int4_dm}/{len(results)} "
          f"galaxies; float64 in {f64_dm}/{len(results)}")
    verdict = int4_dm > f64_dm
    print("  VERDICT: " + ("int4 artifact mimics dark matter better than "
                           "the baseline" if verdict else
                           "quantization does NOT preferentially mimic "
                           "dark matter on SPARC shapes"))

    payload = {
        "results": results,
        "int4_dm_wins": int4_dm,
        "float64_dm_wins": f64_dm,
        "verdict_int4_more_dm_like": bool(verdict),
    }
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "sparc_results.json").write_text(json.dumps(payload, indent=2,
                                                       default=str))
    return payload


if __name__ == "__main__":
    main()
