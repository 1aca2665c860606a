"""The ring's ticks as CUDA graphs (``parallel/ring.py``'s ``_TickGraphs``)
against its eager ticks, on the card: every card of the machine, or a
virtual mesh of four shards on one card where there are fewer than four.

At 131072 int4 stars of the sym schedule with exact bounds every tick,
two chained calls of the history runner give the same bits (state,
snapshots, frames) and the same counts (``hopper_nbody.LAUNCHES``,
``ring.TRAFFIC``, ``hopper_nbody.BOUNDS_FALLBACKS``) with graphs as
eagerly (``ring._graphable`` patched to refuse every mesh), and, on four
cards, as a virtual mesh of four on the home card: on the upstream disk,
where the pruned bounds pass on the home card never falls back, and on a
thin shell, where its full-set max_d2 runs every tick. On the CPU a mesh
never takes graphs, which ``test_a_cpu_mesh_runs_eagerly`` holds.
"""

import math

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models import galaxy
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Quantizer
from nbody_tpu_torch.parallel import ring

CALLS, TICKS, CHUNKS = 2, 5, 2


def _state(n, device, shape="annulus", seed=5):
    """Equal masses: a uniform annulus of radii 0.5-10.5, the upstream
    disk, or a thin shell of radius 5 at rest (every star a candidate of
    the pruned pass, whatever ten ticks do to it)."""
    gen = torch.Generator().manual_seed(seed)
    if shape == "disk":
        pos, vel, m = galaxy.create_disk_galaxy(gen, n)
        return make_state(pos, vel, m / n, device)
    if shape == "shell":
        th = torch.arange(n, dtype=torch.float64) * (2.0 * math.pi / n)
        pos = (5.0 * torch.stack([torch.cos(th), torch.sin(th)], 1)).float()
        return make_state(pos, torch.zeros_like(pos),
                          torch.full((n,), 1.0 / n), device)
    r = torch.rand(n, generator=gen) * 10.0 + 0.5
    th = torch.rand(n, generator=gen) * 6.283185307179586
    pos = torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=1)
    vel = torch.stack([-torch.sin(th), torch.cos(th)], dim=1) * 0.3
    return make_state(pos, vel, torch.full((n,), 1.0 / n), device)


def _history(mesh, state, calls=CALLS, ticks=TICKS, chunks=CHUNKS):
    """``calls`` chained history calls: their outputs, the counts and the
    pruned bounds pass's fallbacks on the home device."""
    for c in (hn.LAUNCHES, ring.TRAFFIC):
        for k in c:
            c[k] = 0
    for t in hn.BOUNDS_FALLBACKS.values():
        t.zero_()
    q, cfg = Quantizer.from_string("int4"), SimConfig()
    out = []
    for _ in range(calls):
        state, snaps, frames = ring.run_with_snapshots_sharded(
            state, q, cfg, mesh, ticks, chunks, quantize_forces=True,
            schedule="sym", n_total=state.positions.shape[0],
            uniform_gm=True)
        out.append((state, snaps, frames))
    return (out, dict(hn.LAUNCHES), dict(ring.TRAFFIC),
            hn.bounds_fallbacks(mesh.home))


def _same_histories(a, b) -> None:
    for (sa, na, fa), (sb, nb, fb) in zip(a, b):
        for name in ("positions", "velocities", "accelerations"):
            assert torch.equal(getattr(sa, name), getattr(sb, name)), name
        for field in na._fields:
            np.testing.assert_array_equal(getattr(na, field),
                                          getattr(nb, field))
        np.testing.assert_array_equal(fa, fb)


def test_a_cpu_mesh_runs_eagerly():
    ring._TickGraphs._cache.clear()
    mesh = ring.ParticleMesh.virtual(4, "cpu")
    _history(mesh, _state(64, "cpu"), calls=1, ticks=2, chunks=1)
    assert not ring._TickGraphs._cache
    assert not ring.graph_ticks(mesh)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["disk", "shell"])
def test_graph_ticks_are_the_eager_ticks_bit_for_bit(monkeypatch, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.device_count() >= 4:
        mesh = ring.make_particle_mesh(4, "cuda")
    else:
        mesh = ring.ParticleMesh.virtual(4, "cuda:0")
    state = _state(131072, mesh.home, shape)
    with monkeypatch.context() as eager_only:
        eager_only.setattr(ring, "_graphable", lambda mesh: False)
        eager, launches_e, traffic_e, fallbacks_e = _history(mesh, state)
    ring._TickGraphs._cache.clear()
    assert not ring.graph_ticks(mesh)
    graphed, launches_g, traffic_g, fallbacks_g = _history(mesh, state)
    assert ring.graph_ticks(mesh)
    assert launches_g == launches_e and traffic_g == traffic_e
    passes = CALLS * (TICKS * CHUNKS + 1)   # each call's entry force
    assert traffic_g["bounds_passes"] == passes
    assert fallbacks_g == fallbacks_e == (passes if shape == "shell" else 0)
    # The candidates' max_d2 and the full set's, skipped or run; no
    # pair_max pass.
    assert launches_g["max_d2"] == 2 * passes
    assert launches_g["pair_max"] == 0
    _same_histories(eager, graphed)
    if mesh.devices[1] != mesh.home:
        virtual, launches_v, traffic_v, fallbacks_v = _history(
            ring.ParticleMesh.virtual(4, mesh.home), state)
        assert launches_v == launches_g and fallbacks_v == fallbacks_g
        assert traffic_v == dict(traffic_g, moved_bytes_peer=0)
        _same_histories(virtual, graphed)
