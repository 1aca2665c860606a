"""Dark-matter control experiment: what REAL dark matter does.

PyTorch counterpart of ``nbody_tpu.experiments.dark_matter_test``
(reference: dark_matter_test.py:24-217): rotation curves from galaxies with
genuine analytic NFW halos at DM ratios 0/2/5/10x, initial vs final curves,
and an outer-slope table — the yardstick against which quantization
artifacts are compared. The runs are on ``--device`` (default ``cuda``;
with no card it raises and names ``--device cpu``); the figure is skipped
where matplotlib is not installed.

Usage:
    python -m nbody_tpu_torch.experiments.dark_matter_test --stars 2000 --ticks 400
    python -m nbody_tpu_torch.experiments.dark_matter_test --device cpu --stars 128 --ticks 40
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from nbody_tpu_torch.diagnostics.metrics import rotation_curve
from nbody_tpu_torch.experiments._common import (
    outer_slope,
    plot_or_skip,
    to_host,
)
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import (
    create_disk_galaxy,
    create_galaxy_with_halo,
)
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.reproducibility import seed_key

DM_RATIOS = [0.0, 2.0, 5.0, 10.0]


def _curve_lists(curve) -> dict:
    return {"radii": to_host(curve.radii).tolist(),
            "velocities": to_host(curve.velocities).tolist()}


def run_dm_comparison(num_stars: int = 2000, num_ticks: int = 400,
                      seed: int = 42, device=None):
    """(reference: dark_matter_test.py:24-97). Every ratio draws its ICs
    from a fresh generator of ``seed``, as JAX reuses one key."""
    device = _resolve_device(device)
    print("\n" + "=" * 60)
    print("DARK MATTER CONTROL EXPERIMENT")
    print("Rotation curves with REAL (analytic NFW) dark matter halos")
    print("=" * 60)

    results = {}
    for ratio in DM_RATIOS:
        label = f"DM {ratio:g}x"
        print(f"\n  {label}: building ICs and running {num_ticks} ticks...")
        if ratio == 0.0:
            pos, vel, m = create_disk_galaxy(seed_key(seed),
                                             num_stars=num_stars)
        else:
            pos, vel, m = create_galaxy_with_halo(seed_key(seed),
                                                  num_stars=num_stars,
                                                  dm_mass_ratio=ratio)
        sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                               device=device)
        initial_curve = rotation_curve(sim.positions, sim.velocities,
                                       num_bins=15)
        sim.step(num_ticks)
        final_curve = rotation_curve(sim.positions, sim.velocities,
                                     num_bins=15)
        s0, v0 = outer_slope(initial_curve)
        s1, v1 = outer_slope(final_curve)
        results[label] = {
            "dm_ratio": ratio,
            "initial_curve": _curve_lists(initial_curve),
            "final_curve": _curve_lists(final_curve),
            "initial_outer_slope": s0,
            "final_outer_slope": s1,
            "final_mean_outer_v": v1,
        }
        print(f"    outer slope: initial {s0:+.4f} -> final {s1:+.4f}")
    return results


def plot_comparison(results, out_dir: Path):
    """(reference: dark_matter_test.py:100-181)"""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    colors = plt.cm.plasma(np.linspace(0.15, 0.85, len(results)))
    for (label, r), c in zip(results.items(), colors):
        for ax, which in zip(axes, ("initial_curve", "final_curve")):
            cr = np.asarray(r[which]["radii"])
            cv = np.asarray(r[which]["velocities"], float)
            valid = ~np.isnan(cv)
            ax.plot(cr[valid], cv[valid], "o-", ms=3, color=c, label=label)
    axes[0].set_title("Initial rotation curves")
    axes[1].set_title("Final rotation curves")
    for ax in axes:
        ax.set_xlabel("Radius")
        ax.set_ylabel("Circular velocity")
        ax.grid(True, alpha=0.3)
        ax.legend()
    fig.suptitle("Real NFW dark matter: the flat-curve yardstick")
    fig.tight_layout()
    path = out_dir / "dark_matter_curves.png"
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Dark matter control experiment")
    p.add_argument("--stars", type=int, default=2000)
    p.add_argument("--ticks", type=int, default=400)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/dark_matter")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = run_dm_comparison(args.stars, args.ticks, args.seed,
                                device=args.device)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    plot_or_skip(plot_comparison, results, out)

    print("\n" + "-" * 50)
    print(f"{'config':10s} {'init slope':>11s} {'final slope':>12s}")
    for label, r in results.items():
        print(f"{label:10s} {r['initial_outer_slope']:+11.4f} "
              f"{r['final_outer_slope']:+12.4f}")
    print("-" * 50)
    print("More DM -> flatter (less negative) outer slope: that is what a")
    print("REAL dark-matter signature looks like; compare with the")
    print("quantization artifact in sensitivity_test.")

    (out / "dark_matter_results.json").write_text(
        json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
