"""Density/scaling limit test: wall time and energy cost vs particle count.

PyTorch counterpart of ``nbody_tpu.experiments.density_limit_test``
(reference: density_limit_test.py:43-544): star counts swept upward under
a clean (float32) and an int4-quantized configuration, measuring per-tick
wall time; a log-log power-law fit of time vs N flags anomalous scaling
(exponent > 2 would mean super-quadratic cost — "reality slows down
superlinearly with density"). The ticks run on ``--device`` (default
``cuda``; with no card it raises and names ``--device cpu``).

Telemetry note: the reference's per-star/per-interaction *power* figures
come from NVML; ``utils.profiler.DeviceProfiler`` samples no power
channel, so the reports keep the energy channels null and the time-based
observables only (SURVEY.md §7 'NVML-shaped features').

Usage:
    python -m nbody_tpu_torch.experiments.density_limit_test
    python -m nbody_tpu_torch.experiments.density_limit_test --device cpu --quick
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import (
    create_disk_galaxy,
    create_plummer_sphere,
)
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.profiler import DeviceProfiler, fence
from nbody_tpu_torch.utils.reproducibility import seed_key

DEFAULT_COUNTS = [100, 250, 500, 1000, 2000, 4000, 8000]
# On the card the small rows sit on the host's issue rate (a tick's
# launches finish before the host has issued the next ones); the
# reference's question — does time grow WORSE than N^2 with density
# (density_limit_test.py:270-316) — is only answerable where the kernels
# set the pace, so the card's default sweep extends to 1M (per-row tick
# counts are bounded by _ticks_for).
DEFAULT_COUNTS_CARD = [1000, 4000, 8000, 16384, 32768, 65536,
                       131072, 262144, 524288, 1048576]
# Pairs a row may measure (_ticks_for); elsewhere the smaller budget keeps
# CPU sweeps bounded. On an NVIDIA H100 80GB HBM3 (700 W power limit) the
# card's budget gave timed regions of 0.18-0.27 s (float32) and
# 0.48-0.93 s (int4) for the rows 32768-262144, and 1.8 / 4.7 s at 1M
# (chip_smoke.py phase probes; PERF.md section 5): past the host's issue
# floor from 65536 up, so the fit sees the kernels.
PAIR_BUDGET_CARD = 6e11
PAIR_BUDGET_HOST = 3e10


def _ticks_for(n: int, ticks_per_size: int, device) -> int:
    """Bound the measured pair work per row so the large-N tail stays
    minutes, not hours; small N keep the full tick count. The budget is
    PAIR_BUDGET_CARD on a CUDA device, else PAIR_BUDGET_HOST; the 1M tail
    stays 5 ticks either way."""
    budget = (PAIR_BUDGET_CARD if torch.device(device).type == "cuda"
              else PAIR_BUDGET_HOST)
    return max(5, min(ticks_per_size, int(budget / max(n * n, 1))))


def run_density_sweep(counts=None, ticks_per_size: int = 1000, seed: int = 42,
                      dim: int = 2, device=None):
    """(reference: density_limit_test.py:206-267)

    ``dim=3`` sweeps the same kernels on Plummer-sphere ICs. Each row
    builds its ICs on the host generator and a fresh DirectSimulation on
    ``device``, runs its ticks once to warm the launches, then times the
    same ticks again, ended by ``fence``."""
    device = _resolve_device(device)
    if counts is None:
        counts = (DEFAULT_COUNTS_CARD if device.type == "cuda"
                  else DEFAULT_COUNTS)
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    make_ics = create_disk_galaxy if dim == 2 else create_plummer_sphere
    print(f"\n{'=' * 60}\nDENSITY LIMIT TEST (dim={dim})\n{'=' * 60}")
    print(f"counts: {counts}, ticks each: <= {ticks_per_size}")

    results = []
    for mode_name, precision in (("clean_float32", Precision.FLOAT32),
                                 ("int4_broken", Precision.INT4_SIM)):
        print(f"\n  --- {mode_name} ---")
        for n in counts:
            ticks = _ticks_for(n, ticks_per_size, device)
            pos, vel, m = make_ics(seed_key(seed), num_stars=n)
            sim = DirectSimulation(pos, vel, m, precision=precision,
                                   device=device)
            del pos, vel, m
            # warm the launches measured below (the kernels' build and
            # first launches stay out of the timed region)
            sim.step(ticks)
            fence(sim.state.positions)

            prof = DeviceProfiler(sample_interval_ms=50,
                                  experiment_name=f"{mode_name}_N{n}",
                                  device=device)
            prof.start()
            t0 = time.perf_counter()
            sim.step(ticks)
            fence(sim.state.positions)
            wall = time.perf_counter() - t0
            prof.stop()
            analysis = prof.analyze()

            ms_per_tick = wall / ticks * 1e3
            crashed = not bool(torch.isfinite(sim.positions).all())
            results.append({
                "mode": mode_name,
                "dim": dim,
                "num_stars": n,
                "ticks": ticks,
                "ms_per_tick": ms_per_tick,
                "pairs_per_sec": n * n * ticks / wall,
                "peak_memory_mb": analysis.peak_memory_mb,
                "power_watts": None,           # not sampled
                "power_per_star": None,        # degraded-mode placeholder
                "crashed": bool(crashed),
            })
            print(f"    N={n:6d}: {ms_per_tick:8.3f} ms/tick "
                  f"({n * n / (ms_per_tick / 1e3):.2e} pairs/s)"
                  + ("  CRASHED" if crashed else ""))
            del sim
            if crashed:
                break
    return results


def analyze_scaling(results) -> dict:
    """Log-log power-law fit on the COMPUTE-BOUND tail
    (reference: density_limit_test.py:270-316).

    The small-N rows sit on a fixed floor (the host's issue of a tick's
    launches), where a power-law fit would report exponent ~0 and the
    super-quadratic anomaly check is vacuous. Rows are classified by their
    distance from the observed floor: only rows >= 4x the cheapest tick
    cost enter the fit. Each result row is annotated with its regime."""
    verdicts = {}
    for mode in ("clean_float32", "int4_broken"):
        rows = [r for r in results if r["mode"] == mode and not r["crashed"]]
        if len(rows) < 3:
            continue
        n = np.array([r["num_stars"] for r in rows], float)
        t = np.array([r["ms_per_tick"] for r in rows], float)
        floor = float(t.min())
        compute_bound = t >= 4.0 * floor
        for r, cb in zip(rows, compute_bound):
            r["regime"] = "compute_bound" if cb else "dispatch_floor"
        if compute_bound.sum() >= 3:
            sel = compute_bound
            regime_note = (f"fit on {int(sel.sum())} compute-bound rows "
                           f"(dispatch floor {floor:.2f} ms/tick)")
        else:
            # whole sweep sits on the floor (CPU runs / tiny sweeps): fall
            # back to the asymptotic-median tail but SAY the verdict is
            # dispatch-dominated rather than reporting a physical exponent
            sel = n >= np.median(n)
            regime_note = ("dispatch-dominated sweep: no compute-bound "
                           "rows; exponent reflects host dispatch, not "
                           "pair physics — extend --counts upward")
        x, y = np.log(n[sel]), np.log(t[sel])
        (exponent, intercept) = np.polyfit(x, y, 1)
        exponent = float(exponent)
        # 95% CI on the fitted exponent (t-distributed slope error; the
        # reference fits with no uncertainty at all,
        # density_limit_test.py:270-316)
        ci95 = None
        dof = int(sel.sum()) - 2
        if dof >= 1 and np.ptp(x) > 0:
            resid = y - (exponent * x + intercept)
            se = float(np.sqrt((resid ** 2).sum() / dof
                               / ((x - x.mean()) ** 2).sum()))
            try:
                from scipy import stats
                tcrit = float(stats.t.ppf(0.975, dof))
            except Exception:
                tcrit = 1.96  # normal approximation
            ci95 = tcrit * se
        verdicts[mode] = {
            "exponent": exponent,
            "exponent_ci95": ci95,
            "dispatch_floor_ms": floor,
            "compute_bound_rows": int(compute_bound.sum()),
            "regime_note": regime_note,
            "anomalous": bool(compute_bound.sum() >= 3 and exponent > 2.2),
            "interpretation": (
                "SUPER-QUADRATIC — density slows reality beyond O(N^2)"
                if compute_bound.sum() >= 3 and exponent > 2.2 else
                f"scaling exponent {exponent:.2f} (<= 2: at or below the "
                "theoretical O(N^2) pairwise cost)"
                if compute_bound.sum() >= 3 else
                "dispatch-dominated: anomaly check not meaningful at this "
                "scale"),
        }
        ci_str = f" +/- {ci95:.2f}" if ci95 is not None else ""
        print(f"  {mode}: time ~ N^{exponent:.2f}{ci_str} [{regime_note}] "
              f"({verdicts[mode]['interpretation']})")
    return verdicts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Density/scaling limit test")
    p.add_argument("--counts", type=str, default=None,
                   help="comma-separated star counts")
    p.add_argument("--ticks", type=int, default=1000,
                   help="per-row tick cap (the pair budget in _ticks_for "
                        "bounds large-N rows below this)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dim", type=int, default=2, choices=(2, 3),
                   help="2: disk-galaxy ICs (reference default); "
                        "3: Plummer-sphere ICs")
    p.add_argument("--output", type=str, default="output/density_limit")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def sweep_plan(argv=None) -> tuple:
    """(counts or None, ticks per size, dim, seed) of a main(argv) run:
    None counts take the device's default sweep."""
    args = build_parser().parse_args(argv)
    counts = ([int(c) for c in args.counts.split(",")] if args.counts
              else None)
    if args.quick:
        counts = [100, 250, 500, 1000, 2000]
        args.ticks = 50
    return counts, args.ticks, args.dim, args.seed


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)
    counts, ticks, dim, seed = sweep_plan(argv)

    results = run_density_sweep(counts, ticks, seed, dim=dim,
                                device=device)
    print(f"\n{'=' * 60}\nSCALING ANALYSIS\n{'=' * 60}")
    verdicts = analyze_scaling(results)

    if args.dim == 3 and args.output == "output/density_limit":
        args.output = "output/density_limit_3d"  # don't clobber the 2-D report
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    report = {
        "results": results, "scaling": verdicts,
        "telemetry_note": "power channels not sampled (DeviceProfiler "
                          "keeps power_watts None); wall-clock "
                          "observables only",
    }
    (out / "density_limit_report.json").write_text(json.dumps(report,
                                                              indent=2))
    return report


if __name__ == "__main__":
    main()
