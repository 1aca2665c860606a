"""Universe stress test: composite "hard mode" boundary scan.

PyTorch counterpart of ``nbody_tpu.experiments.universe_stress_test``
(reference: universe_stress_test.py:81-713): a quick boundary scan across
the four crash axes (velocity / dt / quantization / softening), a
clean-vs-broken ghost-force energy-leak measurement, a mini density
scaling run, a "reality map" figure (skipped, saying so, where matplotlib
is not installed) and a JSON report. The ticks run on ``--device``
(default ``cuda``; with no card it raises and names ``--device cpu``).

Usage:
    python -m nbody_tpu_torch.experiments.universe_stress_test --quick
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from nbody_tpu_torch.experiments import crash_point_test as cpt
from nbody_tpu_torch.experiments import density_limit_test as dlt
from nbody_tpu_torch.experiments._common import energy_drift_pct, plot_or_skip
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.reproducibility import seed_key

DENSITY_TICKS = 50   # ticks a row of the mini density sweep


@dataclasses.dataclass
class UniverseBoundary:
    """(reference: universe_stress_test.py:81-92)"""

    axis: str
    safe_value: float | None
    crash_value: float | None
    crash_type: str | None


def boundary(axis: str, sweep: dict, key: str) -> UniverseBoundary:
    """The last value before the first crash of a sweep, and that crash."""
    crash = next((r for r in sweep["sweep"] if r["crash"]), None)
    safe = None
    for r in sweep["sweep"]:
        if r["crash"]:
            break
        safe = r[key]
    return UniverseBoundary(
        axis=axis, safe_value=safe,
        crash_value=crash[key] if crash else None,
        crash_type=crash["crash"]["crash_type"] if crash else None)


def quick_boundary_scan(num_stars: int, ticks: int, seed: int, device=None):
    """(reference: universe_stress_test.py:119-273)"""
    print("\n--- BOUNDARY SCAN (4 axes) ---")
    vel = cpt.find_velocity_crash_point(num_stars, ticks, seed, device)
    dt = cpt.find_dt_crash_point(num_stars, ticks, seed, device)
    quant = cpt.find_quantization_crash_point(num_stars, ticks, seed, device)
    soft = cpt.find_softening_crash_point(num_stars, ticks, seed, device)
    return [
        boundary("velocity_multiplier", vel, "multiplier"),
        boundary("dt", dt, "dt"),
        boundary("quantization_levels", quant, "levels"),
        boundary("softening", soft, "softening"),
    ]


def measure_energy_leak(num_stars: int, ticks: int, seed: int,
                        device=None) -> dict:
    """Ghost-force leak: per-tick energy injection of broken vs clean
    (reference: universe_stress_test.py:276-347)."""
    print("\n--- ENERGY LEAK (ghost force) ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    rates = {}
    for mode in (Precision.FLOAT32, Precision.INT4_SIM):
        sim = DirectSimulation(pos, vel, m, precision=mode, device=device)
        e0 = sim.get_total_energy()
        sim.step(ticks)
        drift = energy_drift_pct(e0, sim.get_total_energy())
        rates[mode.value] = drift / ticks
        print(f"  {mode.value}: {drift / ticks:+.5f}%/tick")
    ghost = rates["int4_sim"] - rates["float32"]
    print(f"  ghost-force rate (int4 - f32): {ghost:+.5f}%/tick")
    return {"rates_pct_per_tick": rates, "ghost_rate_pct_per_tick": ghost}


def plot_reality_map(boundaries, out_dir: Path):
    """(reference: universe_stress_test.py:350-470)"""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    labels = [b.axis for b in boundaries]
    colors = ["#e74c3c" if b.crash_value is not None else "#2ecc71"
              for b in boundaries]
    bars = ax.barh(labels, [1] * len(labels), color=colors, alpha=0.6)
    for bar, b in zip(bars, boundaries):
        txt = (f"breaks at {b.crash_value} ({b.crash_type})"
               if b.crash_value is not None else "no crash found in range")
        ax.text(0.02, bar.get_y() + bar.get_height() / 2, txt,
                va="center", fontsize=10)
    ax.set_xlim(0, 1)
    ax.set_xticks([])
    ax.set_title("Reality map: where the universe breaks")
    fig.tight_layout()
    path = out_dir / "reality_map.png"
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def suite_sizes(quick: bool) -> dict:
    """Each part's size at --quick or at the full defaults
    (universe_stress_test.py:114-122 of the JAX package)."""
    n = 300 if quick else 600
    ticks = 100 if quick else 300
    return {"stars": n, "ticks": ticks, "leak_ticks": ticks * 2,
            "density_counts": ([100, 400, 1000] if quick
                               else [100, 400, 1000, 4000])}


def run_full_stress_test(quick: bool, seed: int, out_dir: str,
                         device=None) -> dict:
    """(reference: universe_stress_test.py:477-615)"""
    device = _resolve_device(device)
    s = suite_sizes(quick)
    boundaries = quick_boundary_scan(s["stars"], s["ticks"], seed, device)
    leak = measure_energy_leak(s["stars"], s["leak_ticks"], seed, device)
    print("\n--- MINI DENSITY SCALING ---")
    density = dlt.run_density_sweep(s["density_counts"],
                                    ticks_per_size=DENSITY_TICKS, seed=seed,
                                    device=device)
    report = {
        "boundaries": [dataclasses.asdict(b) for b in boundaries],
        "energy_leak": leak,
        "density_scaling": density,
    }
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    plot_or_skip(plot_reality_map, boundaries, out)
    (out / "stress_test_report.json").write_text(
        json.dumps(report, indent=2, default=str))
    print(f"\nReality map + report written to {out}")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Composite universe stress test")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/stress")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)
    print("\n" + "=" * 60)
    print("UNIVERSE STRESS TEST (hard mode)")
    print("=" * 60)
    return run_full_stress_test(args.quick, args.seed, args.output, device)


if __name__ == "__main__":
    main()
