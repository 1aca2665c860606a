"""nbody_tpu_torch.parallel.multihost against nbody_tpu.parallel.multihost,
on one process (the CPU).

The cases of tests/test_multihost.py: the single-process paths run for
real, and the agreement over several processes runs on the gathered
digests of a second process faked by monkeypatching the process count and
``torch.distributed.all_gather``. The hash is JAX's, hex for hex, on the
same numpy state. Besides: the layout of a mesh across processes, and the
single-controller paths refusing one. Real processes are
tests/test_torch_multihost_real.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nbody_tpu.parallel import multihost as jmh
from nbody_tpu_torch.engines.cosmo import CosmologicalEngine
from nbody_tpu_torch.models.direct import DirectSimulation
from nbody_tpu_torch.models.state import CosmoState
from nbody_tpu_torch.parallel import multihost, pm_sharded, ring


def _state(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 2)).astype(np.float32),
            rng.standard_normal((n, 2)).astype(np.float32))


def test_initialize_multihost_single_host_is_noop():
    assert multihost.initialize_multihost() is False
    assert multihost.initialize_multihost("127.0.0.1:1", 1, 0) is False
    assert multihost.process_count() == 1


def test_only_gloo_is_a_backend():
    with pytest.raises(ValueError, match="only gloo"):
        multihost.initialize_multihost("127.0.0.1:1", 2, 0, backend="nccl")


def test_make_global_mesh_spans_the_local_mesh():
    local = ring.ParticleMesh.virtual(8, "cpu")
    mesh = multihost.make_global_mesh(local=local)
    assert mesh is local
    assert mesh.shape["shards"] == 8 and list(mesh.local) == list(range(8))
    with pytest.raises(ValueError, match="axis"):
        multihost.make_global_mesh("devices", local=local)


def test_agreement_single_process():
    pos, vel = _state()
    out = multihost.cross_host_state_agreement(torch.from_numpy(pos),
                                               torch.from_numpy(vel))
    assert out["num_processes"] == 1
    assert out["all_equal"] is True
    assert len(out["hash"]) == 16
    assert out["hash"] == jmh.cross_host_state_agreement(
        jnp.asarray(pos), jnp.asarray(vel))["hash"]
    # identical state -> identical hash; perturbed state -> different
    again = multihost.cross_host_state_agreement(torch.from_numpy(pos),
                                                 torch.from_numpy(vel))
    assert again["hash"] == out["hash"]
    perturbed = multihost.cross_host_state_agreement(
        torch.from_numpy(pos + 1e-6), torch.from_numpy(vel))
    assert perturbed["hash"] != out["hash"]
    assert perturbed["hash"] == jmh.cross_host_state_agreement(
        jnp.asarray(pos + 1e-6), jnp.asarray(vel))["hash"]


def _fake_two_hosts(monkeypatch, other_digest_offset: int):
    """Pretend a second process exists whose gathered digest differs by
    the given offset (0 = agreement)."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)

    def fake_all_gather(out, x, group=None):
        out[0].copy_(x)
        out[1].copy_(x + other_digest_offset)

    monkeypatch.setattr(dist, "all_gather", fake_all_gather)


def test_agreement_multi_process_equal(monkeypatch):
    _fake_two_hosts(monkeypatch, other_digest_offset=0)
    pos, vel = _state()
    out = multihost.cross_host_state_agreement(pos, vel)
    assert out["num_processes"] == 2
    assert out["all_equal"] is True


def test_agreement_multi_process_mismatch_detected(monkeypatch):
    _fake_two_hosts(monkeypatch, other_digest_offset=1)
    pos, vel = _state()
    out = multihost.cross_host_state_agreement(pos, vel)
    assert out["num_processes"] == 2
    assert out["all_equal"] is False


def _across(rank=1, counts=(4, 2, 3)):
    local = ring.ParticleMesh.virtual(counts[rank], "cpu")
    return ring.ParticleMesh.across(local, counts, rank, group=None)


def test_mesh_across_processes_layout():
    mesh = _across()
    assert mesh.size == 9 and mesh.shape == {ring.AXIS: 9}
    assert mesh.processes == 3 and mesh.local == range(4, 6)
    assert mesh.devices == (None,) * 4 + (torch.device("cpu"),) * 2 \
        + (None,) * 3
    assert mesh.home == torch.device("cpu")
    assert [mesh.owner(s) for s in range(9)] == [0] * 4 + [1] * 2 + [2] * 3
    assert "process 1: shards 4-5" in repr(mesh)
    blocks = ring._shards(torch.arange(18.0), mesh)
    assert [b is not None for b in blocks] == [False] * 4 + [True] * 2 \
        + [False] * 3
    assert blocks[4].tolist() == [8.0, 9.0]
    with pytest.raises(ValueError, match="holds a single-controller mesh"):
        ring.ParticleMesh.across(ring.ParticleMesh.virtual(3, "cpu"),
                                 (4, 2, 3), 1, None)


def test_collectives_across_fold_every_shard_in_order(monkeypatch):
    """_reduce and _gather on process 1 of shard counts (4, 2, 3): the
    all-gather (faked: every process's values, padded to 4 rows) comes
    back folded in shard order 0..8, the single controller's bits."""
    values = [torch.tensor([0.1 * (s + 1), 1e8 - s]) for s in range(9)]
    mesh = _across()
    offsets = (0, 4, 6)

    def fake_all_gather(out, x, group=None):
        for r, count in enumerate(mesh.counts):
            mine = values[offsets[r]:offsets[r] + count]
            out[r].copy_(torch.stack(mine + [torch.zeros(2)] * (4 - count)))
        assert torch.equal(out[1], x)

    monkeypatch.setattr(dist, "all_gather", fake_all_gather)
    local = [v if s in mesh.local else None for s, v in enumerate(values)]
    one = ring.ParticleMesh.virtual(9, "cpu")
    assert torch.equal(ring._reduce(local, torch.add, mesh),
                       ring._reduce(values, torch.add, one))
    assert torch.equal(ring._gather(local, mesh),
                       ring._gather(values, one))


def test_single_controller_paths_refuse_a_mesh_across_processes():
    mesh = _across()
    pos, vel = _state(n=20)
    m = np.ones(20, np.float32)
    with pytest.raises(ValueError, match="single-controller"):
        DirectSimulation(pos, vel, m, mesh=mesh)
    with pytest.raises(ValueError, match="single-controller"):
        CosmologicalEngine(num_particles=64, dim=2, n_grid=16, mesh=mesh)
    state = CosmoState(torch.from_numpy(pos), torch.from_numpy(vel),
                       torch.from_numpy(m), 10.0, 0)
    with pytest.raises(ValueError, match="single-controller"):
        pm_sharded.run_pm_steps_sharded(state, None, None, None, mesh)
    with pytest.raises(ValueError, match="single-controller"):
        pm_sharded.sharded_fft_density(state.positions, state.masses, 16,
                                       200.0, mesh)
