"""Reading the port's program spans in a traced window: the ``nbody.*``
ranges that ``nbody_tpu_torch.utils.profiler.span`` records on the
profiler's clock, the device's work attributed to them, and the device's
idle time split by them.

* Each device operation goes to the innermost span that encloses the host
  runtime call that launched it: the call and the operation share CUPTI's
  correlation id. The device's own clock would not do, as the host runs
  ahead of the device. On the H100 every operation of the cells links to
  its launch, the port's kernels (cudart linked statically) too; one whose
  launch is not in the trace is counted outside every span, by name.
* A span kind's device time is its self time: the operations attributed
  to spans of that kind, not to their children. Operations launched
  outside every span are counted apart.
* Each idle gap of the window is a history gap where it ends at the first
  device operation of a ``nbody.history`` or trails the window's last
  operation, and a bubble otherwise: the two partition the window's idle
  time (the window less the union of its device operations, as
  ``devtrace.summarize`` counts it). The spans' mirrors on the device's
  timeline (``gpu_user_annotation``) are no device operation.

Spans are found by name; nothing of the program is imported. ``read``
takes a finished ``torch.profiler.profile``; ``metrics`` turns its result
into the per-span numbers; ``report`` into lines for a log.
"""

from __future__ import annotations

from bench_h100.devtrace import GAP_LABEL_US, MARKER
from bench_h100.timing import kernel_name

PREFIX = "nbody."
KINDS = ("history", "tick", "force", "bounds", "snapshot", "to_host")
OUTSIDE = "outside"


def events(prof):
    """(name, on the device, start ns, end ns, user annotation,
    correlation id) of every event of a finished profile, from the
    profiler's raw results."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
               e.end_ns(), e.is_user_annotation(), e.correlation_id())


def _innermost(spans: list, times: list) -> tuple:
    """(each span's parent, each time's innermost span): indices into
    ``spans`` ((start, end, kind), nested as one thread's are), -1 for
    none. One sweep by start, an enclosing span before those it holds;
    a time None asks nothing."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][0], -spans[i][1]))
    parent, owner = [-1] * len(spans), [-1] * len(times)
    queries = sorted((t, q) for q, t in enumerate(times) if t is not None)
    stack, k = [], 0
    for t, q in queries + [(float("inf"), -1)]:
        while k < len(order) and spans[order[k]][0] <= t:
            i = order[k]
            while stack and spans[stack[-1]][1] < spans[i][1]:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
            k += 1
        if q < 0:
            break
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        owner[q] = stack[-1] if stack else -1
    return parent, owner


def analyse(evs, marker: str = MARKER) -> dict | None:
    """The window marked ``marker`` in the events ``evs`` (``events``'s
    tuples): {"window_s", "busy_s", "idle_s", "self_s": {kind: s},
    "outside_s", "counts": {kind: spans in the window}, "bubbles_s",
    "history_gaps_s", "bubbles_by": {kind of the operation ending the
    gap: s}, "short_bubbles": [s, n] (bubbles under GAP_LABEL_US),
    "long_bubbles": [s, n], "unlinked": {kernel: operations whose launch
    is not in the trace}, "ops"}; None where the window holds no span or
    no device operation."""
    evs = list(evs)
    marks = [(s, t) for name, dev, s, t, _, _ in evs
             if name == marker and not dev]
    if not marks:
        return None
    w0, w1 = marks[0]
    spans, ops, launch = [], [], {}
    for name, dev, s, t, annotation, corr in evs:
        if name.startswith(PREFIX) or annotation:
            if not dev and name[len(PREFIX):] in KINDS:
                spans.append((s, t, name[len(PREFIX):]))
        elif dev:
            if t > w0 and s < w1:
                ops.append((max(s, w0), min(t, w1), corr,
                            kernel_name(name)))
        elif name.startswith("cu"):
            # A runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
            # cudaMemcpyAsync, ...): CUPTI's correlation id, host time.
            launch.setdefault(corr, s)
    counts = {k: 0 for k in KINDS}
    for s, t, kind in spans:
        if w0 <= s and t <= w1:
            counts[kind] += 1
    if not ops or not any(counts.values()):
        return None

    parent, owner = _innermost(spans, [launch.get(c) for _, _, c, _ in ops])
    history = {-1: -1}              # span -> its history (itself or above)

    def history_of(i):
        if i not in history:
            history[i] = (i if spans[i][2] == "history"
                          else history_of(parent[i]))
        return history[i]

    self_ns = {k: 0 for k in KINDS}
    outside, unlinked = 0, {}
    for (s, t, corr, name), o in zip(ops, owner):
        if o < 0:
            outside += t - s
        else:
            self_ns[spans[o][2]] += t - s
        if corr not in launch:
            unlinked[name] = unlinked.get(name, 0) + 1

    by_start = sorted(range(len(ops)), key=lambda q: ops[q][0])
    first = {}                      # history -> its first operation
    for q in by_start:
        h = history_of(owner[q])
        if h >= 0 and h not in first:
            first[h] = q
    starts_history = set(first.values())
    busy = bubbles = gaps = 0
    bubbles_by, short, long_ = {}, [0, 0], [0, 0]
    end = w0
    for q in by_start:
        s, t = ops[q][0], ops[q][1]
        if s > end:
            if q in starts_history:
                gaps += s - end
            else:
                bubbles += s - end
                k = spans[owner[q]][2] if owner[q] >= 0 else OUTSIDE
                bubbles_by[k] = bubbles_by.get(k, 0) + (s - end)
                size = short if s - end < GAP_LABEL_US * 1e3 else long_
                size[0] += s - end
                size[1] += 1
        if t > end:
            busy += t - max(s, end)
            end = t
    gaps += w1 - end                # the trailing gap
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "idle_s": (w1 - w0 - busy) * 1e-9,
        "self_s": {k: v * 1e-9 for k, v in self_ns.items()},
        "outside_s": outside * 1e-9,
        "counts": counts,
        "bubbles_s": bubbles * 1e-9,
        "history_gaps_s": gaps * 1e-9,
        "bubbles_by": {k: v * 1e-9 for k, v in bubbles_by.items()},
        "short_bubbles": [short[0] * 1e-9, short[1]],
        "long_bubbles": [long_[0] * 1e-9, long_[1]],
        "unlinked": unlinked,
        "ops": len(ops),
    }


def read(prof, marker: str = MARKER) -> dict | None:
    """``analyse`` of a finished torch.profiler profile."""
    return analyse(events(prof), marker)


def metrics(a: dict | None) -> dict:
    """The per-span numbers of an analysis, each left out where the window
    holds no span it is read from:

    * force_span_ms_per_tick: ``nbody.force``'s self device time a tick;
    * bounds_span_ms_per_tick: ``nbody.bounds``'s (the int bounds pass
      with its log grid) a tick;
    * snapshot_span_ms: ``nbody.snapshot``'s a snapshot;
    * bubble_us_per_tick: idle gaps inside histories a tick;
    * history_gap_ms: idle gaps at histories' ends a history."""
    if a is None:
        return {}
    n, own = a["counts"], a["self_s"]
    out = {}
    if n["tick"]:
        if n["force"]:
            out["force_span_ms_per_tick"] = own["force"] / n["tick"] * 1e3
        if n["bounds"]:
            out["bounds_span_ms_per_tick"] = own["bounds"] / n["tick"] * 1e3
        out["bubble_us_per_tick"] = a["bubbles_s"] / n["tick"] * 1e6
    if n["snapshot"]:
        out["snapshot_span_ms"] = own["snapshot"] / n["snapshot"] * 1e3
    if n["history"]:
        out["history_gap_ms"] = a["history_gaps_s"] / n["history"] * 1e3
    return out


def report(a: dict | None) -> list:
    """Lines for a log: each span kind's count and self device time, the
    share of busy time launched outside every span, whether bubbles and
    history gaps add up to the idle time, and the operations whose launch
    the trace lacks."""
    if a is None:
        return ["spans: the window holds no nbody.* span or no device "
                "operation"]
    lines = [f"span nbody.{k}: {a['counts'][k]} in the window, self device "
             f"time {a['self_s'][k]:.6f} s" for k in KINDS]
    busy = a["busy_s"] or float("nan")
    lines.append(f"spans: launched outside every span {a['outside_s']:.6f} s"
                 f" ({100 * a['outside_s'] / busy:.4f}% of busy "
                 f"{a['busy_s']:.6f} s)")
    total = a["bubbles_s"] + a["history_gaps_s"]
    lines.append(f"spans: bubbles {a['bubbles_s']:.6f} s + history gaps "
                 f"{a['history_gaps_s']:.6f} s = {total:.6f} s of idle "
                 f"{a['idle_s']:.6f} s (differ by "
                 f"{abs(total - a['idle_s']) * 1e6:.3f} us)")
    for name in ("short_bubbles", "long_bubbles"):
        s, n = a[name]
        lines.append(f"spans: {name.replace('_', ' ')} (under / from "
                     f"{GAP_LABEL_US:g} us) {s:.6f} s in {n} gaps")
    lines += [f"spans: bubbles ended by {k} {v:.6f} s"
              for k, v in sorted(a["bubbles_by"].items(),
                                 key=lambda kv: -kv[1])]
    lines.append(f"spans: {sum(a['unlinked'].values())} of {a['ops']} "
                 f"device operations have no launch in the trace")
    lines += [f"spans: no launch: {n} x {name[:90]}"
              for name, n in sorted(a["unlinked"].items(),
                                    key=lambda kv: -kv[1])[:12]]
    return lines
