"""Reading a traced window: torch.profiler's device events reduced to
busy time, device time by kernel and by role, and the device's idle gaps
labelled by what the host was doing.

Roles (force, bounds, snapshot, ...) come from the JSON files in
``kernel_roles/``: each gives a ``role`` and regular expressions of the
kernel names (as ``timing.kernel_name`` writes them) that belong to it. A
new kernel design brings a new file; no existing file changes. A kernel
that no file names has the role "other".
"""

from __future__ import annotations

import bisect
import json
import re
from pathlib import Path

from bench_h100.timing import kernel_name

HERE = Path(__file__).resolve().parent
MARKER = "bench_h100.window"
# Idle gaps shorter than this are summed under one label, unread.
GAP_LABEL_US = 20.0
# CPU events searched backwards for the one that holds a gap.
GAP_SCAN = 256


def load_roles(root: Path = HERE / "kernel_roles") -> list:
    """[(role, compiled pattern)] from every roles file, in file order."""
    out = []
    for path in sorted(root.glob("*.json")):
        spec = json.loads(path.read_text())
        out += [(spec["role"], re.compile(p)) for p in spec["patterns"]]
    return out


def role_of(name: str, roles: list) -> str:
    for role, pattern in roles:
        if pattern.search(name):
            return role
    return "other"


def _merge(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _host_label(cpu: list, starts: list, t: float) -> str:
    """The innermost CPU event that holds time t (the latest start among
    those that hold it), searched a bounded way back."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - GAP_SCAN), -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "python between ops"


def _events(prof):
    """(name, on the device, start us, end us, user annotation) of every
    event of a finished profile, from the profiler's raw results (building
    its event tree, ``prof.events()``, takes twenty times as long)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.is_user_annotation())


def summarize(prof, roles: list) -> dict | None:
    """The window marked MARKER in ``prof``: {"window_s", "busy_s",
    "kernels": {name: (launches, s)}, "roles": {role: s}, "device_ops",
    "idle_gaps", "events"}; None where the trace holds no device event in
    the window."""
    events = list(_events(prof))
    marks = [(s, t) for name, dev, s, t, _ in events
             if name == MARKER and not dev]
    if not marks:
        return None
    w0, w1 = marks[0]
    device, cpu = [], []
    for name, dev, s, t, annotation in events:
        if t <= w0 or s >= w1 or name == MARKER:
            continue
        if dev:
            # A user annotation is mirrored on the device's timeline; it
            # is no device operation.
            if not annotation:
                device.append((max(s, w0), min(t, w1), kernel_name(name)))
        else:
            cpu.append((s, t, name))
    if not device:
        return None
    kernels, by_role = {}, {}
    for s, t, name in device:
        n, us = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, us + (t - s))
    for name, (n, us) in kernels.items():
        role = role_of(name, roles)
        by_role[role] = by_role.get(role, 0.0) + us * 1e-6
    busy = _merge([(s, t) for s, t, _ in device])
    busy_us = sum(t - s for s, t in busy)
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps, short = {}, 0.0
    edges = [w0] + [x for s, t in busy for x in (s, t)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        if b - a < GAP_LABEL_US:
            short += b - a
            continue
        label = _host_label(cpu, starts, 0.5 * (a + b))
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    if short:
        gaps[f"gaps under {GAP_LABEL_US:g} us"] = short
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernels": {k: (n, us * 1e-6) for k, (n, us) in kernels.items()},
        "roles": by_role,
        "device_ops": [[k, us * 1e-6] for k, (n, us) in top],
        "idle_gaps": [[k, us * 1e-6] for k, us in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        "events": len(device),
    }
