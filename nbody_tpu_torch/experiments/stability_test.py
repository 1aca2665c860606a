"""Stability test: find the quantization stability floor.

PyTorch counterpart of ``nbody_tpu.experiments.stability_test``
(reference: stability_test.py:22-252): run every precision mode until
explosion (NaN/Inf, >1000% drift, unbound) or max_ticks, then print the
stability-floor table and the threshold mode. The ticks run on
``--device`` (default ``cuda``; with no card it raises and names
``--device cpu``).

Usage:
    python -m nbody_tpu_torch.experiments.stability_test --stars 2000 --ticks 2000
    python -m nbody_tpu_torch.experiments.stability_test --device cpu --stars 48 --ticks 100
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

from nbody_tpu_torch.experiments._common import (
    detect_explosion,
    energy_drift_pct,
)
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.reproducibility import seed_key

MODES = [Precision.FLOAT64, Precision.FLOAT32, Precision.BFLOAT16,
         Precision.FLOAT16, Precision.INT8_SIM, Precision.INT4_SIM]
CHECK_INTERVAL = 50   # ticks between explosion checks


@dataclasses.dataclass
class StabilityResult:
    mode: str
    stable_ticks: int
    final_energy: float
    initial_energy: float
    energy_drift_percent: float
    exploded: bool
    runtime_seconds: float


def test_precision_mode(positions, velocities, masses, mode: Precision,
                        max_ticks: int = 2000,
                        check_interval: int = CHECK_INTERVAL,
                        **sim_kwargs) -> StabilityResult:
    """(reference: stability_test.py:64-130) — the ticks run in chunks of
    check_interval steps with one explosion check (one host read) per
    chunk. ``sim_kwargs`` go to DirectSimulation (``device=`` among
    them)."""
    print(f"  Testing {mode.value}...", end=" ", flush=True)
    t0 = time.time()
    sim = DirectSimulation(positions, velocities, masses, precision=mode,
                           **sim_kwargs)
    initial_energy = sim.get_total_energy()
    stable_ticks = 0
    exploded = False

    for tick in range(0, max_ticks, check_interval):
        sim.step(check_interval)
        stable_ticks = tick + check_interval
        if detect_explosion(sim, initial_energy):
            exploded = True
            print(f"EXPLODED at tick {stable_ticks}")
            break
        if stable_ticks % 500 == 0:
            print(stable_ticks, end=" ", flush=True)

    runtime = time.time() - t0
    final_energy = sim.get_total_energy()
    drift = energy_drift_pct(initial_energy, final_energy)
    if not exploded:
        print(f"STABLE ({max_ticks} ticks, {drift:+.2f}% drift)")
    return StabilityResult(mode=mode.value, stable_ticks=stable_ticks,
                           final_energy=final_energy,
                           initial_energy=initial_energy,
                           energy_drift_percent=drift, exploded=exploded,
                           runtime_seconds=runtime)


def run_stability_suite(num_stars: int = 2000, max_ticks: int = 2000,
                        seed: int = 42, device=None, **sim_kwargs):
    """(reference: stability_test.py:133-191)"""
    device = _resolve_device(device)
    print(f"\n{'=' * 60}\nQUANTIZATION STABILITY FLOOR TEST\n{'=' * 60}")
    print(f"Stars: {num_stars}, max ticks: {max_ticks}, device: {device}")

    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars=num_stars)
    results = [test_precision_mode(pos, vel, m, mode, max_ticks,
                                   device=device, **sim_kwargs)
               for mode in MODES]

    print(f"\n{'=' * 60}\nSTABILITY FLOOR RESULTS\n{'=' * 60}")
    print(f"{'Mode':12s} {'Status':10s} {'Ticks':>7s} {'Drift %':>10s} "
          f"{'Runtime s':>10s}")
    print("-" * 60)
    for r in results:
        status = "EXPLODED" if r.exploded else "stable"
        print(f"{r.mode:12s} {status:10s} {r.stable_ticks:7d} "
              f"{r.energy_drift_percent:+10.2f} {r.runtime_seconds:10.2f}")

    # Threshold mode: the first mode (walking down the ladder) that
    # explodes or exceeds 5% drift (reference: stability_test.py:239-247).
    threshold = None
    for r in results:
        if r.exploded or abs(r.energy_drift_percent) > 5.0:
            threshold = r.mode
            break
    if threshold:
        print(f"\nStability floor: physics breaks at '{threshold}'")
    else:
        print("\nAll modes stable within 5% drift at this configuration")
    return results, threshold


def run_multi_seed(num_stars: int, max_ticks: int, n_seeds: int,
                   base_seed: int, device=None):
    """Per-mode drift with t-based 95% CIs across seeds — the statistical
    rigor harness applied to the stability floor
    (reference: reproducibility.py:362-398 + stability suite)."""
    from nbody_tpu_torch.utils.reproducibility import run_with_confidence

    stats = {}
    for mode in MODES:
        def drift_for_seed(seed: int) -> float:
            pos, vel, m = create_disk_galaxy(seed_key(seed),
                                             num_stars=num_stars)
            r = test_precision_mode(pos, vel, m, mode, max_ticks,
                                    device=device)
            return r.energy_drift_percent

        stats[mode.value] = run_with_confidence(
            drift_for_seed, n_seeds=n_seeds, base_seed=base_seed,
            metric_name=f"drift_{mode.value}")
    print(f"\n{'=' * 60}\nMULTI-SEED DRIFT ({n_seeds} seeds, 95% CI)"
          f"\n{'=' * 60}")
    for mode, s in stats.items():
        print(f"{mode:12s} {s.mean:+8.3f}%  "
              f"[{s.ci_95_low:+8.3f}, {s.ci_95_high:+8.3f}]")
    return stats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Quantization stability floor")
    p.add_argument("--stars", type=int, default=2000)
    p.add_argument("--ticks", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--seeds", type=int, default=1,
                   help=">1: multi-seed run with t-based 95% CIs")
    p.add_argument("--output", type=str, default="output/stability")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    results, threshold = run_stability_suite(args.stars, args.ticks,
                                             args.seed, device=args.device)
    payload = {
        "results": [dataclasses.asdict(r) for r in results],
        "threshold_mode": threshold,
        "num_stars": args.stars,
        "max_ticks": args.ticks,
    }
    if args.seeds > 1:
        stats = run_multi_seed(args.stars, args.ticks, args.seeds,
                               args.seed, device=args.device)
        payload["multi_seed"] = {k: dataclasses.asdict(v)
                                 for k, v in stats.items()}
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "stability_results.json").write_text(json.dumps(payload,
                                                           indent=2))
    print(f"\nResults written to {out / 'stability_results.json'}")
    return payload


if __name__ == "__main__":
    main()
