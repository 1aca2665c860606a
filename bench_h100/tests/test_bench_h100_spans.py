"""``spans.py`` on synthetic traces: host spans, runtime calls and device
operations that share correlation ids, and the spans' mirrors on the
device's timeline, laid out as a run lays them (the host ahead of the
device). On the card (``-m gpu``): a short history of the port, traced.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from bench_h100 import devtrace, harness, spans
from bench_h100.devtrace import MARKER

HISTORIES, TICKS = 2, 3
LEAD, BUBBLE, BETWEEN, TRAIL = 3000, 10, 5000, 2000
# (span path of the launch, kernel name, runtime call, device ns)
TICK_OPS = [(("tick",), "at::native::vectorized_elementwise_kernel<4>",
             "cudaLaunchKernel", 50),
            (("tick", "force", "bounds"), "max_d2_tiled", "cuLaunchKernel",
             100),
            (("tick", "force"), "sym_one_pass<3, 2, false, false>",
             "cuLaunchKernel", 1000),
            (("tick", "force"), "at::native::elementwise_kernel<128, 2>",
             "cudaLaunchKernel", 40)]
CHUNK_OPS = [(("snapshot",), "pair_pe_tiled<2>", "cuLaunchKernel", 500),
             (("to_host",), "Memcpy DtoH (Device -> Pageable)",
              "cudaMemcpyAsync", 200)]
OPS_A_HISTORY = TICKS * len(TICK_OPS) + len(CHUNK_OPS)


class Event:
    def __init__(self, name, dev, s, t, annotation=False, corr=0):
        self._v = (name, dev, s, t, annotation, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def profile_of(evs):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(evs))))


def analyse(evs, **kw):
    return spans.read(profile_of(evs), **kw)


def trace(with_spans=True, mirrors=True, linked=True, outside=False):
    """A window of HISTORIES histories of TICKS ticks and one snapshot.
    The host issues a history's launches in 10 ns steps inside its spans;
    the device runs them later, BUBBLE apart, histories BETWEEN apart.
    ``linked=False`` leaves the sym kernel's runtime call out of the
    trace; ``outside`` adds one operation
    launched after the last history, outside every span."""
    evs, host, dev, corr = [], 100, LEAD, 0
    work = []                       # (span path, name, call, ns, history)
    for h in range(HISTORIES):
        for _ in range(TICKS):
            work += [op + (h,) for op in TICK_OPS]
        work += [op + (h,) for op in CHUNK_OPS]
    spans_at, dev_of = [], {}
    for i, (path, name, call, ns, h) in enumerate(work):
        corr += 1
        if i and work[i - 1][4] != h:
            dev += BETWEEN - BUBBLE
        evs.append(Event(name, True, dev, dev + ns, corr=corr))
        if linked or not name.startswith("sym_one_pass"):
            evs.append(Event(call, False, host, host + 5, corr=corr))
        spans_at.append((host, path, h))
        dev_of[i] = (dev, dev + ns)
        host += 10
        dev += ns + BUBBLE
    dev -= BUBBLE
    if outside:
        corr += 1
        evs.append(Event("cudaLaunchKernel", False, host + 50, host + 55,
                         corr=corr))
        evs.append(Event("outside_kernel", True, dev + 700, dev + 800,
                         corr=corr))
        dev += 800
    w1 = max(dev + TRAIL, host + 100)
    evs.append(Event(MARKER, False, 0, w1, annotation=True))
    if with_spans:
        evs += _span_events(work, spans_at, dev_of, mirrors)
    return evs, w1


def _span_events(work, spans_at, dev_of, mirrors):
    """Host spans around each run of launches that shares a span path
    prefix (a new tick opens where the path restarts), each with its
    mirror from its first operation's start to its last one's end."""
    groups = {}                     # span key -> [launch indices]
    tick = chunk = -1
    for i, (path, _, _, _, h) in enumerate(work):
        if path == ("tick",):
            tick += 1
        if path == ("snapshot",):
            chunk += 1
        keys = [("history", h)]
        if path[0] == "tick":
            keys += [("tick", tick)]
            if "force" in path:
                keys += [("force", tick)]
            if "bounds" in path:
                keys += [("bounds", tick)]
        else:
            keys += [(path[0], chunk)]
        for k in keys:
            groups.setdefault(k, []).append(i)
    evs = []
    for (kind, _), idx in groups.items():
        host0, host1 = spans_at[idx[0]][0] - 1, spans_at[idx[-1]][0] + 6
        evs.append(Event("nbody." + kind, False, host0, host1, True))
        if mirrors:
            evs.append(Event("nbody." + kind, True, dev_of[idx[0]][0],
                             dev_of[idx[-1]][1], True))
    return evs


def test_device_time_goes_to_the_innermost_launching_span():
    a = analyse(trace()[0])
    assert a["counts"] == {"history": 2, "tick": 6, "force": 6, "bounds": 6,
                           "snapshot": 2, "to_host": 2}
    ticks = HISTORIES * TICKS
    own = {k: round(v * 1e9) for k, v in a["self_s"].items()}
    # Self time: the bounds pass is not the force span's, nor the force
    # evaluation the tick's.
    assert own == {"history": 0, "tick": 50 * ticks,
                   "force": 1040 * ticks, "bounds": 100 * ticks,
                   "snapshot": 500 * HISTORIES, "to_host": 200 * HISTORIES}
    assert a["outside_s"] == 0
    assert not a["unlinked"]
    m = spans.metrics(a)
    assert m["force_span_ms_per_tick"] == pytest.approx(1040e-6)
    assert m["bounds_span_ms_per_tick"] == pytest.approx(100e-6)
    assert m["snapshot_span_ms"] == pytest.approx(500e-6)


def test_the_device_clock_alone_does_not_attribute():
    """The host spans lie far from the device's operations in time: only
    the correlation ids tie them."""
    evs, _ = trace(mirrors=False)
    host = [e for e in evs if not e._v[1] and e.name().startswith("nbody.")]
    dev = [e for e in evs if e._v[1]]
    assert max(e.end_ns() for e in host) < min(e.start_ns() for e in dev)
    assert analyse(evs)["self_s"]["force"] == pytest.approx(
        1040e-9 * HISTORIES * TICKS)


def test_mirrors_are_never_busy():
    with_mirrors = analyse(trace()[0])
    without = analyse(trace(mirrors=False)[0])
    for key in ("busy_s", "idle_s", "bubbles_s", "history_gaps_s", "ops"):
        assert with_mirrors[key] == without[key]
    per_history = sum(op[3] for op in TICK_OPS) * TICKS + sum(
        op[3] for op in CHUNK_OPS)
    assert round(with_mirrors["busy_s"] * 1e9) == per_history * HISTORIES


def test_bubbles_and_history_gaps_partition_the_idle_time():
    evs, w1 = trace()
    a = analyse(evs)
    m = spans.metrics(a)
    ticks, histories = HISTORIES * TICKS, HISTORIES
    assert round(a["bubbles_s"] * 1e9) == \
        BUBBLE * (OPS_A_HISTORY - 1) * HISTORIES
    assert round(a["window_s"] * 1e9) == w1
    assert round(a["history_gaps_s"] * 1e9) == LEAD + BETWEEN + TRAIL
    s = devtrace.summarize(profile_of(evs), devtrace.load_roles())
    idle_ns = (s["window_s"] - s["busy_s"]) * 1e9
    split_ns = (m["bubble_us_per_tick"] * ticks * 1e3
                + m["history_gap_ms"] * histories * 1e6)
    gaps = (OPS_A_HISTORY - 1) * HISTORIES + HISTORIES + 1
    assert abs(split_ns - idle_ns) <= 1e3 * gaps
    assert a["short_bubbles"] == [pytest.approx(a["bubbles_s"]),
                                  (OPS_A_HISTORY - 1) * HISTORIES]
    assert a["long_bubbles"] == [0, 0]
    # Each bubble goes to the span that launched the operation ending it.
    assert a["bubbles_by"] == pytest.approx({
        "tick": BUBBLE * 1e-9 * (ticks - histories),
        "bounds": BUBBLE * 1e-9 * ticks,
        "force": 2 * BUBBLE * 1e-9 * ticks,
        "snapshot": BUBBLE * 1e-9 * histories,
        "to_host": BUBBLE * 1e-9 * histories})


def test_operations_launched_outside_every_span_are_counted_apart():
    a = analyse(trace(outside=True)[0])
    assert round(a["outside_s"] * 1e9) == 100
    assert round(a["bubbles_by"]["outside"] * 1e9) == 700
    assert a["short_bubbles"][1] == (OPS_A_HISTORY - 1) * HISTORIES + 1
    assert a["bubbles_s"] + a["history_gaps_s"] == pytest.approx(
        a["idle_s"], abs=1e-12)


def test_an_operation_without_its_launch_counts_outside_by_name():
    linked = analyse(trace()[0])
    cut = analyse(trace(linked=False)[0])
    ticks = HISTORIES * TICKS
    assert cut["unlinked"] == {"sym_one_pass<3, 2, false, false>": ticks}
    assert not linked["unlinked"]
    assert round(cut["outside_s"] * 1e9) == 1000 * ticks
    assert round(cut["self_s"]["force"] * 1e9) == 40 * ticks
    for key in ("busy_s", "idle_s"):
        assert cut[key] == linked[key]


def test_a_window_without_spans_reads_nothing():
    assert analyse(trace(with_spans=False)[0]) is None
    assert spans.metrics(None) == {}
    assert spans.report(None)[0].startswith("spans: the window holds no")
    evs, _ = trace()
    assert analyse(evs, marker="no.such.window") is None


@pytest.mark.parametrize("name", ["launches_per_tick", "force_roofline",
                                  "bounds_ms_per_tick", "snapshot_ms",
                                  "device_idle_pct"])
def test_the_accepted_readers_read_the_same_with_spans(name):
    reader = harness.Manifest().reader("layer_metrics", name)
    values = []
    for with_spans in (False, True):
        summary = devtrace.summarize(
            profile_of(trace(with_spans=with_spans)[0]),
            devtrace.load_roles())
        summary["work"] = {"ticks": HISTORIES * TICKS,
                           "snapshots": HISTORIES}
        run = SimpleNamespace(
            summary=summary, work=summary["work"],
            stats={"launches": {"sym_force_uniform": 6, "max_d2": 12}},
            traffic={"n": 131072, "mode": "int4"},
            config={"dim": 2, "equal_masses": True})
        values.append(reader.read(run))
    assert values[0] is not None and values[0] == values[1]


def test_a_profile_of_the_port_on_the_cpu():
    """The raw events of a real profile hold every field ``events`` reads;
    a CPU run's window holds spans but no device operation."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from nbody_tpu_torch.models.direct import DirectSimulation
    gen = torch.Generator().manual_seed(3)
    sim = DirectSimulation(torch.randn(128, 2, generator=gen),
                           torch.zeros(128, 2), torch.ones(128) / 128,
                           precision="int4", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(MARKER):
            sim.run_with_history(2, 2)
    names = [e[0] for e in spans.events(prof)]
    assert names.count("nbody.tick") == 2 and MARKER in names
    assert spans.read(prof) is None


@pytest.mark.gpu
def test_a_traced_history_on_the_card():
    """Two int4 histories of 5 ticks at 16384 stars, traced: every span
    counted, every operation linked to its launch (the port's kernels,
    cudart linked statically, too), almost nothing outside the spans, and
    the idle time split exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile, record_function
    from nbody_tpu_torch.models.direct import DirectSimulation
    gen = torch.Generator().manual_seed(11)
    n = 16384
    sim = DirectSimulation(torch.randn(n, 2, generator=gen) * 5,
                           torch.randn(n, 2, generator=gen) * 0.05,
                           torch.ones(n) / n, precision="int4")
    sim.run_with_history(5, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARKER):
            for _ in range(2):
                sim.run_with_history(5, 5)
            torch.cuda.synchronize()
    a = spans.read(prof)
    print("\n".join(spans.report(a)))
    assert a["counts"] == {"history": 2, "tick": 10, "force": 10,
                           "bounds": 10, "snapshot": 2, "to_host": 2}
    assert a["self_s"]["force"] > 0 and a["self_s"]["bounds"] > 0
    assert a["self_s"]["snapshot"] > 0 and a["self_s"]["to_host"] > 0
    assert a["outside_s"] < 0.005 * a["busy_s"]
    assert a["bubbles_s"] + a["history_gaps_s"] == pytest.approx(
        a["idle_s"], abs=1e-9)
    assert not a["unlinked"]
