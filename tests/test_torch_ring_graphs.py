"""The ring's ticks as CUDA graphs (``parallel/ring.py``'s ``_TickGraphs``)
against its eager ticks, on the card: every card of the machine, or a
virtual mesh of four shards on one card where there are fewer than four.

At 131072 int4 stars of the sym schedule with exact bounds every tick,
two chained calls of the history runner give the same bits (state,
snapshots, frames) and the same counts (``hopper_nbody.LAUNCHES``,
``ring.TRAFFIC``) with graphs as eagerly (``ring._graphable`` patched to
refuse every mesh). On the CPU a mesh never takes graphs, which
``test_a_cpu_mesh_runs_eagerly`` holds.
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Quantizer
from nbody_tpu_torch.parallel import ring


def _state(n, device, seed=5):
    gen = torch.Generator().manual_seed(seed)
    r = torch.rand(n, generator=gen) * 10.0 + 0.5
    th = torch.rand(n, generator=gen) * 6.283185307179586
    pos = torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=1)
    vel = torch.stack([-torch.sin(th), torch.cos(th)], dim=1) * 0.3
    return make_state(pos, vel, torch.full((n,), 1.0 / n), device)


def _history(mesh, state, calls=2, ticks=5, chunks=2):
    """``calls`` chained history calls: their outputs and the counts."""
    for c in (hn.LAUNCHES, ring.TRAFFIC):
        for k in c:
            c[k] = 0
    q, cfg = Quantizer.from_string("int4"), SimConfig()
    out = []
    for _ in range(calls):
        state, snaps, frames = ring.run_with_snapshots_sharded(
            state, q, cfg, mesh, ticks, chunks, quantize_forces=True,
            schedule="sym", n_total=state.positions.shape[0],
            uniform_gm=True)
        out.append((state, snaps, frames))
    return out, dict(hn.LAUNCHES), dict(ring.TRAFFIC)


def test_a_cpu_mesh_runs_eagerly():
    ring._TickGraphs._cache.clear()
    mesh = ring.ParticleMesh.virtual(4, "cpu")
    _history(mesh, _state(64, "cpu"), calls=1, ticks=2, chunks=1)
    assert not ring._TickGraphs._cache
    assert not ring.graph_ticks(mesh)


@pytest.mark.gpu
def test_graph_ticks_are_the_eager_ticks_bit_for_bit(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.device_count() >= 4:
        mesh = ring.make_particle_mesh(4, "cuda")
    else:
        mesh = ring.ParticleMesh.virtual(4, "cuda:0")
    state = _state(131072, mesh.home)
    with monkeypatch.context() as eager_only:
        eager_only.setattr(ring, "_graphable", lambda mesh: False)
        eager, launches_e, traffic_e = _history(mesh, state)
    ring._TickGraphs._cache.clear()
    assert not ring.graph_ticks(mesh)
    graphed, launches_g, traffic_g = _history(mesh, state)
    assert ring.graph_ticks(mesh)
    assert launches_g == launches_e and traffic_g == traffic_e
    for (se, ne, fe), (sg, ng, fg) in zip(eager, graphed):
        for name in ("positions", "velocities", "accelerations"):
            assert torch.equal(getattr(se, name), getattr(sg, name)), name
        for field in ne._fields:
            np.testing.assert_array_equal(getattr(ne, field),
                                          getattr(ng, field))
        np.testing.assert_array_equal(fe, fg)
