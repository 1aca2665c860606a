"""One traced run of a cell, as ``run.py --trace 1`` makes it, with what
the port's spans show in its window (``spans.py``):

    python3 bench_h100/span_report.py --workload <cell> --seed <n> --seconds <s> [--span-cost <n>]

from the root of a checkout with a card. Prints the spans' report and the
per-span numbers on standard error, and one JSON object last on standard
output: the result line's ``correct`` and per-layer metrics, the traced
rate (``traced_pairs_per_s``: the window's pairs over its seconds, the
profiler's cost included), the traced device operations a tick, and
``spans.metrics`` of the window. ``--span-cost n`` also times n enters
and exits of one span on the host, with no profiler and under one.

The harness keeps no profile on the run, so this tool wraps its
``_read_trace`` to keep the window's; where the window's trace held no
device event (the harness then traced a unit after it), no span is read.
A program without spans reads none and says so.
"""

import argparse
import json
import sys
import time
from pathlib import Path

# The checkout's root, in place of this directory (whose module names
# must not shadow the standard library's).
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from bench_h100 import harness, spans  # noqa: E402


def span_cost_us(n: int) -> dict | None:
    """Host microseconds of one span's enter and exit (the empty loop's
    time taken off), with no profiler and under one tracing the host and
    the card; None where the program has no ``span``."""
    try:
        from nbody_tpu_torch.utils.profiler import span
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile

    def per_span(name):
        t = time.perf_counter()
        for _ in range(n):
            pass
        empty = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(n):
            with span(name):
                pass
        return (time.perf_counter() - t - empty) / n * 1e6

    off = per_span("nbody.cost")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = per_span("nbody.cost")
    return {"off_us": off, "on_us": on, "n": n}


def traced_run(workload: str, seed: int, seconds: float) -> tuple:
    """(the result line, its Run, the window's profile or None)."""
    kept = {}
    read_trace = harness._read_trace

    def keeping(run, entry, st, prof):
        read_trace(run, entry, st, prof)
        if run.trace_source.startswith("torch.profiler over the window"):
            kept["profile"] = prof

    harness._read_trace = keeping
    try:
        line = harness.run_cell(workload, seed, seconds, True)
    finally:
        harness._read_trace = read_trace
    return line, line.pop("_run"), kept.get("profile")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--span-cost", type=int, default=0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    line, run, prof = traced_run(args.workload, args.seed, args.seconds)
    t = time.perf_counter()
    found = spans.read(prof) if prof is not None else None
    read_s = time.perf_counter() - t
    for text in spans.report(found):
        print(text, file=sys.stderr)
    numbers = spans.metrics(found)
    for name, value in numbers.items():
        print(f"span metric {name}: {value!r}", file=sys.stderr)
    ticks = run.summary["work"]["ticks"] if run.summary else 0
    out = {"workload": args.workload, "seed": args.seed,
           "correct": line["correct"], "metrics": line["metrics"],
           "device": line["device"], "setup_s": run.setup_s,
           "window_s": run.window_s, "work": run.work,
           "traced_pairs_per_s": run.work.get("pairs", 0) / run.window_s,
           "device_ops_per_tick": (run.summary["events"] / ticks
                                   if ticks else None),
           "breakdown": line.get("breakdown"),
           "spans": numbers, "spans_read_s": read_s,
           "span_analysis": found}
    if args.span_cost:
        out["span_cost"] = span_cost_us(args.span_cost)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
