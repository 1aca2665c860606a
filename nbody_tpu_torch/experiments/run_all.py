"""Run every experiment CLI sequentially and summarize.

PyTorch counterpart of ``nbody_tpu.experiments.run_all``, the
framework-level analogue of the reference's ``run_all_tests`` chain
(reference: ultimate_reality_engine.py:1447-1728), widened to the FULL
L8 suite: all 17 experiments of ``nbody_tpu_torch.experiments`` in quick
or full mode, each on ``--device`` (default ``cuda``; with no card it
raises and names ``--device cpu``), each isolated (one failing suite
never kills the run), timed, with a combined JSON summary.

Usage:
    python -m nbody_tpu_torch.experiments.run_all --device cuda
    python -m nbody_tpu_torch.experiments.run_all --device cpu --only jitter_test
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
import traceback
from pathlib import Path

from nbody_tpu_torch.models.direct import _resolve_device

SUITES = [
    ("stability_test", ["--stars", "600", "--ticks", "400"]),
    ("sensitivity_test", ["--stars", "600", "--ticks", "200"]),
    ("falsification_tests", ["--quick"]),
    ("dark_matter_test", ["--stars", "800", "--ticks", "150"]),
    ("sparc_test", ["--stars", "600", "--ticks", "150"]),
    ("jitter_test", ["--quick"]),
    ("density_limit_test", ["--quick"]),
    ("hardware_leak_test", ["--quick"]),
    ("crash_point_test", ["--quick"]),
    ("universe_stress_test", ["--quick"]),
    ("breakout_tests", ["--quick"]),
    ("extreme_mode", ["--quick", "--skip-oom"]),
    ("red_team_proof", ["--quick"]),
    ("omniverse_tests", ["--quick"]),
    ("orbital_audit", ["--quick"]),
    ("omega_point_test", ["--quick"]),
    ("reality_glitch_tests", ["--quick"]),
]


def suite_module(name: str):
    """The port's module of the suite ``name``."""
    return importlib.import_module(f"nbody_tpu_torch.experiments.{name}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run the full experiment suite")
    p.add_argument("--quick", action="store_true", default=True)
    p.add_argument("--output", type=str, default="output/run_all")
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated subset of suite names")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device for every suite (cuda unless given; "
                        "cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = str(_resolve_device(args.device))

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    wanted = set(args.only.split(",")) if args.only else None

    summary = {}
    t_all = time.time()
    for name, suite_args in SUITES:
        if wanted and name not in wanted:
            continue
        print(f"\n{'#' * 70}\n# {name}\n{'#' * 70}", flush=True)
        mod = suite_module(name)
        t0 = time.time()
        try:
            mod.main(suite_args + ["--output", str(out / name),
                                   "--device", device])
            summary[name] = {"status": "ok",
                             "wall_s": round(time.time() - t0, 1)}
        except SystemExit as e:
            summary[name] = {"status": "ok" if not e.code else
                             f"exit {e.code}",
                             "wall_s": round(time.time() - t0, 1)}
        except Exception as e:  # noqa: BLE001 — suite isolation
            summary[name] = {"status": f"FAILED: {type(e).__name__}: {e}",
                             "wall_s": round(time.time() - t0, 1)}
            traceback.print_exc()

    summary["_total_wall_s"] = round(time.time() - t_all, 1)
    (out / "run_all_summary.json").write_text(json.dumps(summary, indent=2))
    print(f"\n{'=' * 70}\nSUITE SUMMARY\n{'=' * 70}")
    for name, s in summary.items():
        if name.startswith("_"):
            continue
        print(f"  {name:24s} {s['status']:12s} {s['wall_s']:8.1f}s")
    print(f"  total: {summary['_total_wall_s']}s")
    failed = [n for n, s in summary.items()
              if not n.startswith("_") and s["status"] != "ok"]
    print(f"  {'ALL SUITES PASSED' if not failed else f'FAILED: {failed}'}")
    return summary


if __name__ == "__main__":
    main()
