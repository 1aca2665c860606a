"""The spans and counters of nbody_tpu_torch's multi-device ring
(``parallel/ring.py``), on the CPU on virtual meshes, under torch.profiler.

A history on the ring records the single-device loop's spans
(``nbody.history``, ``nbody.tick``, ``nbody.force``, ``nbody.bounds``,
``nbody.snapshot``, ``nbody.to_host``) and the ring's own
(``nbody.ring.rotate``, ``nbody.ring.reduce``, ``nbody.ring.energy``); with
no profiler a span is one shared null context, and spans change no bit of
a run. ``ring.TRAFFIC`` counts one tick's rotations, reduces, moved bytes
and bounds passes as the sym schedule's formulas in S, N and D give them,
on either side of PRUNED_CANDIDATES, the same on a virtual mesh as on S
cards, and no byte crosses a device on one device.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.direct import DirectSimulation
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops.precision import Quantizer
from nbody_tpu_torch.parallel import ring
from nbody_tpu_torch.utils import profiler as TP

KINDS = ("history", "tick", "force", "bounds", "snapshot", "to_host",
         "ring.rotate", "ring.reduce", "ring.energy")
N = 96


def _ics(n=N, seed=11):
    gen = torch.Generator().manual_seed(seed)
    pos = torch.randn(n, 2, generator=gen) * 5.0
    vel = torch.randn(n, 2, generator=gen) * 0.05
    return pos, vel, torch.full((n,), 1.0 / n)


def _sim(shards=4, mode="int4"):
    return DirectSimulation(*_ics(), precision=mode,
                            mesh=ring.ParticleMesh.virtual(shards, "cpu"))


def _spans(prof) -> dict:
    """{kind: [(start ns, end ns)]} of the nbody.* spans in a profile."""
    out = {k: [] for k in KINDS}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("nbody.") and e.is_user_annotation():
            out[e.name()[len("nbody."):]].append((e.start_ns(), e.end_ns()))
    return out


def _inside(inner, outer) -> bool:
    return all(any(a <= s and t <= b for a, b in outer) for s, t in inner)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _reset():
    for key in ring.TRAFFIC:
        ring.TRAFFIC[key] = 0


def _per_tick(shards: int, n: int, dim: int) -> dict:
    """One int4 tick of the sym schedule with exact bounds, N % S == 0,
    written out: the bounds pass gathers the positions onto the home
    device (the pruned pass runs there, on either side of
    PRUNED_CANDIDATES) and replicates lo and hi; the force pass rotates
    positions, G m, ids and reactions S//2 times and the reactions once
    more home; the force quantization reduces and replicates its min and
    max (4-byte scalars)."""
    h = shards // 2
    return {"rotations": 4 * h + 1, "reduces": 2,
            "moved_bytes": ((shards - 1) * (n // shards) * 4 * dim
                            + h * n * (8 * dim + 8) + 4 * n * dim
                            + 6 * (shards - 1) * 4),
            "moved_bytes_peer": 0, "bounds_passes": 1}


@pytest.mark.parametrize("n", [N, 1104])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_one_tick_moves_what_the_schedule_says(shards, n):
    state = make_state(*_ics(n), "cpu")
    q, cfg = Quantizer.from_string("int4"), SimConfig()
    mesh = ring.ParticleMesh.virtual(shards, "cpu")

    def run(ticks):
        _reset()
        ring.run_steps_sharded(state, q, cfg, mesh, ticks,
                               quantize_forces=True, uniform_gm=True)
        return dict(ring.TRAFFIC)

    one, two = run(1), run(2)
    assert {k: two[k] - one[k] for k in one} == _per_tick(shards, n, 2)


def test_a_history_records_each_span():
    k, chunks = 3, 2
    sim = _sim()
    _, spans = _traced(lambda: sim.run_with_history(k * chunks, k))
    ticks = k * chunks
    counts = {kind: len(v) for kind, v in spans.items()}
    # One force evaluation at the call's entry, one a tick, each with its
    # bounds pass; one energy ring pass a snapshot.
    assert counts["history"] == 1 and counts["to_host"] == 1
    assert counts["tick"] == ticks and counts["snapshot"] == chunks
    assert counts["force"] == counts["bounds"] == ticks + 1
    assert counts["ring.energy"] == chunks
    assert counts["ring.rotate"] > 0 and counts["ring.reduce"] > 0
    assert _inside(spans["bounds"], spans["force"])
    assert _inside(spans["force"], spans["history"])
    assert _inside(spans["ring.energy"], spans["snapshot"])
    for kind in ("tick", "snapshot", "to_host", "ring.rotate",
                 "ring.reduce"):
        assert _inside(spans[kind], spans["history"])
    flat = sorted(spans["tick"] + spans["snapshot"] + spans["to_host"])
    assert all(a[1] <= b[0] for a, b in zip(flat, flat[1:]))


def test_steps_record_ticks_and_forces():
    sim = _sim(mode="float32")
    _, spans = _traced(lambda: sim.step(2))
    assert len(spans["tick"]) == 2 and len(spans["force"]) == 3
    assert not spans["history"] and not spans["bounds"]


def test_without_a_profiler_no_span_is_recorded(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(TP, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    sim = _sim()
    sim.run_with_history(2, 1)
    assert sim.tick == 2


def test_a_virtual_mesh_moves_nothing_between_devices():
    _reset()
    _sim().run_with_history(2, 2)
    assert ring.TRAFFIC["moved_bytes"] > 0
    assert ring.TRAFFIC["moved_bytes_peer"] == 0


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_spans_change_no_bit_of_a_history(mode):
    def run():
        sim = _sim(mode=mode)
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
