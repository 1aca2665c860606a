"""The ring's equal-mass tiles (``uniform_gm``) against nbody_tpu's, on CPU.

JAX runs its ring with ``uniform_gm=True`` on ``make_particle_mesh(S)``
over the conftest's virtual CPU devices (its tiles there are the plain jnp
ones, the same function); the port runs ``ParticleMesh.virtual(S, "cpu")``,
whose tiles are the equal-mass variants' plain versions. N=512 with S in
{1, 2, 4}: every shard and every tile is a multiple of 64, so the
equal-mass tiles run; with phantom rows (N % S != 0) the flag is switched
off and the result is bit for bit the general one.

Tolerances as tests/test_torch_ring.py: float32 |err| <= 1e-5 x the row's
summed |terms|; int4 fewer than 2% of the components off by more than
1e-4 max|a|; histories as tests/test_torch_direct.py (float32 positions
rtol 1e-4, atol 1e-5, energies rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.models import direct as jd
from nbody_tpu.models import galaxy as jg
from nbody_tpu.ops import precision as jp
from nbody_tpu.parallel import ring as jring
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models import direct as td
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp
from nbody_tpu_torch.parallel import ring

torch.set_num_threads(1)

CFG, JCFG = SimConfig(), JaxConfig()
N = 512


def _ics(n, seed=0):
    pos, vel, m = jg.create_disk_galaxy(jax.random.PRNGKey(seed),
                                        num_stars=n)
    return tuple(np.asarray(a) for a in (pos, vel, m))


def _t(a):
    return torch.from_numpy(np.array(a))


def _hold(got, want, pos, m, mode):
    assert np.isfinite(got).all()
    q = tp.Quantizer.from_string(mode)
    if mode == "float32":
        scale = hn.sym_force_term_scale(_t(pos), CFG.G * _t(m),
                                        hn.kernel_bounds(_t(pos), q, CFG), q,
                                        False).numpy()
        assert (np.abs(got - want) <= 1e-5 * scale + 1e-12).all()
    else:
        off = np.abs(got - want) > 1e-4 * np.abs(want).max()
        assert off.mean() < 0.02, f"{off.mean():.3%} components off"


@pytest.mark.parametrize("mode", ["float32", "int4"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_ring_uniform_matches_jax(n_shards, mode):
    pos, _, m = _ics(N)
    qf = mode == "int4"
    want = np.asarray(jring.ring_accelerations(
        jnp.asarray(pos), jnp.asarray(m), jp.Quantizer.from_string(mode),
        JCFG, jring.make_particle_mesh(n_shards), quantize_forces=qf,
        uniform_gm=True))
    mesh = ring.ParticleMesh.virtual(n_shards, "cpu")
    q = tp.Quantizer.from_string(mode)
    got = ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh,
                                  quantize_forces=qf, uniform_gm=True)
    _hold(got.numpy(), want, pos, m, mode)
    # the equal-mass tiles ran: another summation order than the general
    # ones (the raw forces)
    general = ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh)
    assert not torch.equal(
        ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh,
                                uniform_gm=True), general)


@pytest.mark.parametrize("n_shards,n", [(3, N), (4, N + 3)])
def test_ring_uniform_off_with_phantom_rows(n_shards, n):
    """N % S != 0: phantom rows need G*m = 0, so the flag changes no bit
    (JAX ring.py:830-832)."""
    pos, vel, m = _ics(n, seed=1)
    mesh = ring.ParticleMesh.virtual(n_shards, "cpu")
    for mode in ("float32", "int4"):
        q = tp.Quantizer.from_string(mode)
        assert torch.equal(
            ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh,
                                    uniform_gm=True),
            ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh))
    from nbody_tpu_torch.models.state import make_state
    st = make_state(_t(pos), _t(vel), _t(m), "cpu")
    a, _ = ring.run_steps_sharded(st, tp.Quantizer(), CFG, mesh, 3,
                                  uniform_gm=True)
    b, _ = ring.run_steps_sharded(st, tp.Quantizer(), CFG, mesh, 3)
    assert torch.equal(a.positions, b.positions)


def test_rows_schedule_ignores_the_flag():
    pos, _, m = _ics(N, seed=2)
    mesh = ring.ParticleMesh.virtual(2, "cpu")
    q = tp.Quantizer()
    assert torch.equal(
        ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh,
                                schedule="rows", uniform_gm=True),
        ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh,
                                schedule="rows"))


def test_mesh_history_with_equal_masses_matches_jax():
    """DirectSimulation(mesh=...) detects the equal masses and hands the
    flag to the ring runners, as JAX's does: S=2, N=512, float32."""
    ics = _ics(N, seed=3)
    jsim = jd.DirectSimulation(*ics, precision="float32",
                               mesh=jring.make_particle_mesh(2))
    tsim = td.DirectSimulation(*ics, precision="float32",
                               mesh=ring.ParticleMesh.virtual(2, "cpu"))
    assert tsim._uniform_gm
    out = []
    for sim in (jsim, tsim):
        e0 = sim.get_total_energy()
        snaps, _ = sim.run_with_history(10, 5)
        out.append((e0, snaps, np.asarray(sim.positions)))
    (je0, js, jpos), (te0, ts, tpos) = out
    np.testing.assert_allclose(tpos, jpos, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.total, np.asarray(js.total), rtol=1e-5)
    # the equal-mass tiles ran on the resident state (N % S == 0)
    ref = td.DirectSimulation(*ics, precision="float32",
                              mesh=ring.ParticleMesh.virtual(2, "cpu"))
    ref._uniform_gm = False
    ref.run_with_history(10, 5)
    assert not torch.equal(ref.positions, tsim.positions)
