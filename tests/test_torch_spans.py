"""The program spans of nbody_tpu_torch's single-device tick loop
(``utils.profiler.span``), on the CPU under torch.profiler.

A history (``DirectSimulation.run_with_history``) records one
``nbody.history``, one ``nbody.tick`` and one ``nbody.force`` a tick, in
int modes one ``nbody.bounds`` inside each force evaluation, one
``nbody.snapshot`` a chunk and one ``nbody.to_host``; the cached-bounds
stepper records two force evaluations a tick (the launch and its redo).
With no profiler a span is one shared null context, and spans change no
bit of a run.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models import direct as td
from nbody_tpu_torch.models.direct import DirectSimulation
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops import precision as tp
from nbody_tpu_torch.utils import profiler as TP

KINDS = ("history", "tick", "force", "bounds", "snapshot", "to_host")


def _ics(n=192, seed=5):
    gen = torch.Generator().manual_seed(seed)
    pos = torch.randn(n, 2, generator=gen) * 5.0
    vel = torch.randn(n, 2, generator=gen) * 0.05
    return pos, vel, torch.full((n,), 1.0 / n)


def _spans(prof) -> dict:
    """{kind: [(start ns, end ns)]} of the nbody.* spans in a profile."""
    out = {k: [] for k in KINDS}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("nbody.") and e.is_user_annotation():
            out[e.name()[len("nbody."):]].append((e.start_ns(), e.end_ns()))
    return out


def _inside(inner, outer) -> bool:
    """Every interval of ``inner`` lies in some interval of ``outer``."""
    return all(any(a <= s and t <= b for a, b in outer) for s, t in inner)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.mark.parametrize("mode,chunks", [("float32", 1), ("int4", 1),
                                         ("int4", 2)])
def test_a_history_records_each_span(mode, chunks):
    k = 3
    sim = DirectSimulation(*_ics(), precision=mode, device="cpu")
    _, spans = _traced(lambda: sim.run_with_history(k * chunks, k))
    ticks = k * chunks
    assert {kind: len(v) for kind, v in spans.items()} == {
        "history": 1, "tick": ticks, "force": ticks,
        "bounds": ticks if mode == "int4" else 0, "snapshot": chunks,
        "to_host": 1}
    assert _inside(spans["bounds"], spans["force"])
    assert _inside(spans["force"], spans["tick"])
    for kind in ("tick", "snapshot", "to_host"):
        assert _inside(spans[kind], spans["history"])
    # Ticks, snapshots and the copy to the host follow one another.
    flat = sorted(spans["tick"] + spans["snapshot"] + spans["to_host"])
    assert all(a[1] <= b[0] for a, b in zip(flat, flat[1:]))


def test_bounds_every_nests_its_bounds_pass_in_the_force_span():
    sim = DirectSimulation(*_ics(), precision="int4", bounds_every=2,
                           device="cpu")
    _, spans = _traced(lambda: sim.run_with_history(4, 4))
    assert len(spans["force"]) == 4 and len(spans["bounds"]) == 2
    assert _inside(spans["bounds"], spans["force"])


def test_cached_bounds_record_two_force_spans_a_tick():
    q = tp.Quantizer.from_string("int4")
    state = make_state(*_ics(), "cpu")
    _, spans = _traced(lambda: td.run_steps(
        state, q, SimConfig(), "kernel", True, 3, bounds_mode="cached"))
    assert len(spans["tick"]) == 3 and len(spans["force"]) == 6
    assert not spans["bounds"] and not spans["history"]
    assert _inside(spans["force"], spans["tick"])


def test_steps_outside_a_history_record_ticks():
    sim = DirectSimulation(*_ics(), precision="float64", device="cpu")
    _, spans = _traced(lambda: sim.step(2))
    assert len(spans["tick"]) == 2 and len(spans["force"]) == 2
    assert not spans["history"]


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(TP, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert TP.span("nbody.tick") is TP.span("nbody.force") is TP._NO_SPAN
    sim = DirectSimulation(*_ics(), precision="int4", device="cpu")
    sim.run_with_history(2, 1)
    assert sim.tick == 2


def test_a_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(TP.span("nbody.tick"),
                          torch.profiler.record_function)


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_spans_change_no_bit_of_a_run(mode):
    def run():
        sim = DirectSimulation(*_ics(), precision=mode, device="cpu")
        snaps, frames = sim.run_with_history(4, 2)
        return sim.state, snaps, frames

    plain = run()
    traced, spans = _traced(run)
    assert len(spans["tick"]) == 4
    for a, b in ((plain[0].positions, traced[0].positions),
                 (plain[0].velocities, traced[0].velocities),
                 (plain[0].accelerations, traced[0].accelerations)):
        assert torch.equal(a, b)
    for field in plain[1]._fields:
        np.testing.assert_array_equal(getattr(plain[1], field),
                                      getattr(traced[1], field))
    np.testing.assert_array_equal(plain[2], traced[2])
