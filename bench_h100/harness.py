"""The benchmark's harness: one process runs one cell once.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Load the cell from ``BENCHMARK.json``, its configuration
   (``configs/<config>.json``), traffic (``traffic/<traffic>.json``) and
   limits (``limits/<cell>.json``), and the traffic's entry
   (``entries/<entry>.py``).
2. Set up and warm up (the entry's ``prepare``): every shape the window
   uses, so that nothing builds inside it.
3. Measure: whole units of work (the entry's ``unit``) back to back; the
   window closes at the end of the first unit to finish after
   ``--seconds``. With ``--trace 1`` the window runs under torch.profiler.
4. Judge what the window produced against the plain reference (the
   entry's ``check``), after the memory peak is read and the program is
   freed.
5. Print each compared number beside its limit (the last lines on
   standard error) and the result line, one JSON object (the last line on
   standard output).

Metrics are files: an end-to-end metric's reader is
``end_to_end/<name>.py``, a per-layer metric's ``layer_metrics/<name>.py``,
each with ``read(run) -> float | None``; a reader that finds nothing to
read returns None and the metric is left out of the line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in a run: JAX and the
# JAX package (compared whole: the port's name begins with the latter's).
FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc builds already land in ``build/nbody_tpu_torch``)."""
    base = root / "build" / "bench_h100"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` and the files it names, found by name."""

    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = root, here
        self.data = load_json(root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.here / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return load_json(self.here / "limits" / f"{workload}.json")

    def entry(self, name: str):
        return load_module(self.here / "entries" / f"{name}.py",
                           f"bench_h100_entry_{name}")

    def end_to_end(self, workload: str) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics this cell reports: those that list it."""
        return [m for m in self.data["per_layer"]
                if workload in m["workloads"]]

    def reader(self, kind: str, name: str):
        return load_module(self.here / kind / f"{name}.py",
                           f"bench_h100_{kind}_{name.replace('.', '_')}")


class Run:
    """One run of one cell: its inputs, the work its window did, what the
    trace read, and the program's outputs for the check."""

    def __init__(self, manifest: Manifest, workload: str, seed: int,
                 seconds: float, trace: bool, device: str,
                 traffic_overrides: dict | None = None):
        self.manifest = manifest
        self.workload = manifest.workload(workload)
        self.config = manifest.config(self.workload["config"])
        self.traffic = {**manifest.traffic(self.workload["traffic"]),
                        **(traffic_overrides or {})}
        self.limits = manifest.limits(workload)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.work: dict = {}        # summed over the window's units
        self.stats: dict = {}       # the entry's counters over the window
        self.summary: dict | None = None   # the traced window, if any
        self.trace_source = "not traced"
        self.setup_s = None
        self.window_s = None
        self.memory_peak_bytes = 0
        self.marks: list = []       # (stage of set-up, seconds since start)

    def mark(self, stage: str) -> None:
        self.marks.append((stage, process_age_s()))


def _add(total: dict, work: dict) -> None:
    for k, v in work.items():
        total[k] = total.get(k, 0) + v


def measure(run: Run, program=None):
    """Steps 2-3 for ``run`` on its entry: returns the entry's state after
    the window (``run.work``, ``run.stats``, ``run.summary`` filled).
    ``program`` replaces the system under test (the control, a planted
    fault)."""
    import torch
    entry = run.manifest.entry(run.traffic["entry"])
    st = entry.prepare(run, program)
    _sync(run)
    prof = None
    if run.trace:
        from torch.profiler import profile, record_function
        from bench_h100.devtrace import MARKER
        prof = profile(activities=_activities(run))
        prof.__enter__()
        mark = record_function(MARKER)
        mark.__enter__()
    run.setup_s = process_age_s()
    t0 = time.perf_counter()
    while True:
        _add(run.work, entry.unit(run, st))
        if time.perf_counter() - t0 >= run.seconds:
            break
    _sync(run)
    run.window_s = time.perf_counter() - t0
    if prof is not None:
        mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        _read_trace(run, entry, st, prof)
    run.stats = entry.counters(run, st)
    if run.device.startswith("cuda"):
        run.memory_peak_bytes = max(
            torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count()))
    return entry, st


def _activities(run: Run) -> list:
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if run.device.startswith("cuda") else [])


def _sync(run: Run) -> None:
    if run.device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def _read_trace(run: Run, entry, st, prof) -> None:
    """The window's trace; where it holds no device event (seen once on
    the card, chip_smoke.py's device_ms's reason to retry), up to two more
    units traced alone after the window, the source named."""
    from bench_h100 import devtrace as trace
    roles = trace.load_roles()
    t = time.perf_counter()
    run.summary = trace.summarize(prof, roles)
    if run.summary is not None:
        run.summary["work"] = dict(run.work)
        run.trace_source = (f"torch.profiler over the window "
                            f"({run.summary['events']} device events, "
                            f"read in {time.perf_counter() - t:.1f} s)")
        return
    from torch.profiler import profile, record_function
    for attempt in range(2):
        with profile(activities=_activities(run)) as again:
            with record_function(trace.MARKER):
                work = entry.unit(run, st)
                _sync(run)
        run.summary = trace.summarize(again, roles)
        if run.summary is not None:
            run.summary["work"] = work
            run.trace_source = (f"torch.profiler over one more unit after "
                                f"the window (retry {attempt + 1}: the "
                                f"window's trace held no device event)")
            return
    run.trace_source = ("none: three traces held no device event; the "
                        "trace metrics are not measured")


def metrics(run: Run, specs: list, kind: str) -> dict:
    out = {}
    for spec in specs:
        value = run.manifest.reader(kind, spec["name"]).read(run)
        if value is None:
            print(f"metric {spec['name']}: nothing to read, left out",
                  file=sys.stderr)
            continue
        out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def result(run: Run, checks: list) -> dict:
    """The result line for ``run`` judged by ``checks`` (name, value,
    limit, ok)."""
    import torch
    name = run.workload["name"]
    if run.trace:
        found = metrics(run, run.manifest.per_layer(name), "layer_metrics")
    else:
        found = metrics(run, run.manifest.end_to_end(name), "end_to_end")
    device = {"platform": "gpu" if run.device.startswith("cuda") else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if run.device.startswith("cuda") else "cpu"),
              "count": run.workload["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": all(c[3] for c in checks),
            "attempted": run.work.get("attempted", 0),
            "failed": run.work.get("failed", 0),
            "metrics": found, "device": device}
    if run.trace and run.summary is not None:
        device["busy_s"] = run.summary["busy_s"]
        device["window_s"] = run.summary["window_s"]
        line["breakdown"] = {"device_ops": run.summary["device_ops"],
                             "idle_gaps": run.summary["idle_gaps"]}
    line["checks"] = {c[0]: {"value": c[1], "limit": c[2]} for c in checks}
    return line


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", manifest: Manifest | None = None,
             program=None, traffic_overrides: dict | None = None) -> dict:
    """Steps 1-4: the result line (a dict) for one run."""
    run = Run(manifest or Manifest(), workload, seed, seconds, trace,
              device, traffic_overrides)
    entry, st = measure(run, program)
    outputs = entry.finish(run, st)
    del st
    if device.startswith("cuda"):
        import torch
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = entry.check(run, outputs)
    print(f"reference check: {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    if run.trace:
        print(f"trace source: {run.trace_source}", file=sys.stderr)
        if run.summary is not None:
            from bench_h100 import devtrace
            roles = devtrace.load_roles()
            for name, (n, s) in sorted(run.summary["kernels"].items(),
                                       key=lambda kv: -kv[1][1])[:40]:
                print(f"kernel {name} [{devtrace.role_of(name, roles)}]: "
                      f"{n} launches, {s:.6f} s", file=sys.stderr)
    line = result(run, checks)
    line["_run"] = run
    return line


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace))
    run = line.pop("_run")
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 3
    print("set-up: " + ", ".join(f"{stage} {t:.2f} s"
                                 for stage, t in run.marks), file=sys.stderr)
    print(f"setup_s {run.setup_s:.3f}, window {run.window_s:.3f} s, "
          f"work {json.dumps(run.work)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
