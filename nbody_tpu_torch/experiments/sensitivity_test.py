"""Sensitivity sweep: effect size vs quantization level count.

PyTorch counterpart of ``nbody_tpu.experiments.sensitivity_test``
(reference: sensitivity_test.py:30-349): 12 level counts from 4 (2-bit) to
100000 ("infinite"), measuring energy drift, rotation-curve outer slope and
galaxy radius, with a monotonicity verdict and a 4-panel figure (skipped
where matplotlib is not installed).

The level count is data — a ``Quantizer(CUSTOM, levels)`` — with no force
quantization, the reference subclass's semantics
(sensitivity_test.py:55-84): on the card each level runs the sym_force
kernel's custom rung with the max_d2 kernel's bounds pass.

Usage:
    python -m nbody_tpu_torch.experiments.sensitivity_test --stars 1500 --ticks 500
    python -m nbody_tpu_torch.experiments.sensitivity_test --device cpu --stars 48 --ticks 60
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from nbody_tpu_torch.diagnostics.metrics import rotation_curve
from nbody_tpu_torch.experiments._common import (
    energy_drift_pct,
    outer_slope,
    plot_or_skip,
    radius_percentile,
)
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision, Quantizer
from nbody_tpu_torch.utils.reproducibility import seed_key

# 2-bit .. "infinite" (reference: sensitivity_test.py:149-162)
DEFAULT_LEVELS = [4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384, 100000]


@dataclasses.dataclass
class SensitivityResult:
    bits: float
    levels: int
    label: str
    energy_drift_pct: float
    outer_slope: float
    mean_outer_velocity: float
    final_radius: float


def _quantizer_for_levels(levels: int) -> Quantizer:
    """levels >= 10000 means effectively infinite -> plain float32."""
    if levels >= 10000:
        return Quantizer(Precision.FLOAT32)
    return Quantizer(Precision.CUSTOM, custom_levels=levels)


def run_level(positions, velocities, masses, levels: int,
              num_ticks: int = 500, device=None) -> SensitivityResult:
    """(reference: sensitivity_test.py:43-134)"""
    q = _quantizer_for_levels(levels)
    sim = DirectSimulation(positions, velocities, masses, precision=q,
                           quantize_forces=False, device=device)
    e0 = sim.get_total_energy()
    sim.step(num_ticks)
    e1 = sim.get_total_energy()

    curve = rotation_curve(sim.positions, sim.velocities, num_bins=12)
    slope, mean_v = outer_slope(curve)
    bits = float(np.log2(levels)) if levels > 1 else 0.0
    return SensitivityResult(
        bits=bits, levels=levels,
        label=f"{levels} levels ({bits:.1f} bits)",
        energy_drift_pct=energy_drift_pct(e0, e1),
        outer_slope=slope, mean_outer_velocity=mean_v,
        final_radius=radius_percentile(sim.positions, 90),
    )


def check_monotonicity(results) -> dict:
    """Key scientific test (reference: sensitivity_test.py:264-284): does
    |drift| decrease monotonically as bits increase?"""
    by_bits = sorted(results, key=lambda r: r.bits)
    drifts = [abs(r.energy_drift_pct) for r in by_bits]
    violations = sum(1 for i in range(1, len(drifts))
                     if drifts[i] > drifts[i - 1] * 1.5 + 1e-9)
    monotone = violations <= max(1, len(drifts) // 6)
    return {"monotone": monotone, "violations": violations,
            "drift_by_bits": {f"{r.bits:.1f}": r.energy_drift_pct
                              for r in by_bits}}


def plot_results(results, out_dir: Path):
    """4-panel figure (reference: sensitivity_test.py:196-262)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    by_bits = sorted(results, key=lambda r: r.bits)
    bits = [r.bits for r in by_bits]
    drifts = [abs(r.energy_drift_pct) for r in by_bits]
    slopes = [r.outer_slope for r in by_bits]
    radii = [r.final_radius for r in by_bits]

    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    axes[0, 0].semilogy(bits, np.maximum(drifts, 1e-6), "o-")
    axes[0, 0].set_xlabel("Effective bits")
    axes[0, 0].set_ylabel("|energy drift| %")
    axes[0, 0].set_title("Drift vs precision")
    # exponential fit (reference: sensitivity_test.py:238-252)
    pos = [(b, d) for b, d in zip(bits, drifts) if d > 1e-8]
    if len(pos) >= 3:
        b_arr = np.array([p[0] for p in pos])
        d_arr = np.log(np.array([p[1] for p in pos]))
        coef = np.polyfit(b_arr, d_arr, 1)
        fit = np.exp(np.polyval(coef, b_arr))
        axes[0, 0].plot(b_arr, fit, "--", alpha=0.6,
                        label=f"exp fit: slope={coef[0]:.2f}/bit")
        axes[0, 0].legend()
    axes[0, 1].plot(bits, slopes, "s-", color="#9b59b6")
    axes[0, 1].set_xlabel("Effective bits")
    axes[0, 1].set_ylabel("Outer rotation-curve slope")
    axes[0, 1].set_title("Flatness (more negative = Keplerian)")
    axes[1, 0].plot(bits, radii, "^-", color="#2ecc71")
    axes[1, 0].set_xlabel("Effective bits")
    axes[1, 0].set_ylabel("Final radius (90th pct)")
    axes[1, 0].set_title("Galaxy size")
    axes[1, 1].plot(bits, [r.mean_outer_velocity for r in by_bits], "d-",
                    color="#f39c12")
    axes[1, 1].set_xlabel("Effective bits")
    axes[1, 1].set_ylabel("Mean outer velocity")
    axes[1, 1].set_title("Outer rotation speed")
    for ax in axes.flat:
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    path = out_dir / "sensitivity_sweep.png"
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def run_sensitivity_sweep(num_stars: int = 1500, num_ticks: int = 500,
                          levels=None, seed: int = 42,
                          out_dir: str = "output/sensitivity", device=None):
    """(reference: sensitivity_test.py:136-193)"""
    device = _resolve_device(device)
    levels = levels or DEFAULT_LEVELS
    print(f"\n{'=' * 60}\nQUANTIZATION SENSITIVITY SWEEP\n{'=' * 60}")
    print(f"Stars: {num_stars}, ticks: {num_ticks}, "
          f"levels: {levels}, device: {device}")

    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars=num_stars)
    results = []
    for lv in levels:
        r = run_level(pos, vel, m, lv, num_ticks, device=device)
        results.append(r)
        print(f"  {r.label:24s} drift={r.energy_drift_pct:+8.3f}%  "
              f"slope={r.outer_slope:+.4f}  radius={r.final_radius:.2f}")

    mono = check_monotonicity(results)
    print(f"\nMonotonicity (key scientific test): "
          f"{'PASS' if mono['monotone'] else 'FAIL'} "
          f"({mono['violations']} violations)")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    plot_or_skip(plot_results, results, out)
    (out / "sensitivity_results.json").write_text(json.dumps({
        "results": [dataclasses.asdict(r) for r in results],
        "monotonicity": mono,
    }, indent=2))
    return results, mono


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Quantization sensitivity sweep")
    p.add_argument("--stars", type=int, default=1500)
    p.add_argument("--ticks", type=int, default=500)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/sensitivity")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run_sensitivity_sweep(args.stars, args.ticks, seed=args.seed,
                                 out_dir=args.output, device=args.device)


if __name__ == "__main__":
    main()
