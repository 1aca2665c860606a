"""The equal-mass fast path of nbody_tpu_torch against nbody_tpu's, on the CPU.

``uniform_gm`` / ``uniform``: the sym kernels' equal-mass variants (their
plain versions here) against ``pallas_accelerations_sym(uniform_gm=True)``,
``pallas_pair_force_sym(uniform_gm=True)`` and the chunked path in Pallas
interpret mode, as tests/test_pallas_kernel.py:368-504 runs them; the
full-tile rule (a size off TILE gives the general result bit for bit); the
host-side guard at every surface that takes the flag; the engine's
equal-mass detection and its device default. Inputs are made with numpy
from a seed and handed to both packages.

Tolerances: float modes rtol 2e-5, atol 1e-6, JAX's own uniform-against-
general tolerance (tests/test_pallas_kernel.py:384-385); the chunked path
rtol 5e-5, atol 2e-6 against the dense oracle (:455-456); int8, int4 and
custom after ``quantize_force``: the flip rule of PERF.md section 2 (at
most max(4, 1e-4 x components) components beyond the float tolerance, each
at most one grid step of the tensor-global linear grid).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.ops import forces as jf
from nbody_tpu.ops import precision as jp
from nbody_tpu.ops.pallas_nbody import (pallas_accelerations_sym,
                                        pallas_accelerations_sym_chunked,
                                        pallas_pair_force_sym)
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models import direct as td
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

MODES = ["float32", "bf16", "f16", "int8", "int4", "custom"]
CFG, JCFG = SimConfig(), JaxConfig()


def _inputs(n, dim, seed=0):
    """Disk-like (2-D) or Gaussian (3-D) positions and equal masses."""
    rng = np.random.default_rng(seed + 31 * n + dim)
    if dim == 2:
        r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
        a = rng.uniform(0, 2 * np.pi, n)
        pos = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    else:
        pos = rng.standard_normal((n, 3)) * 5.0
    return pos.astype(np.float32), np.ones(n, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def hold(got, want, mode, rtol=2e-5, atol=1e-6):
    """The float rule, or for the int modes the flip rule on the forces
    after quantize_force (both sides already quantized)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    if not tp.Quantizer.from_string(mode).is_int:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        return
    q = tp.Quantizer.from_string(mode)
    step = (want.max() - want.min()) / (q.levels - 1)
    tol = atol + rtol * np.abs(want).max()
    diff = np.abs(got - want)
    off = diff > tol
    assert off.sum() <= max(4, int(1e-4 * want.size)), off.sum()
    assert (diff[off] <= step + tol).all()


def _int_bounds(pos, qt):
    diff = pos[None, :, :].astype(np.float64) - pos[:, None, :]
    max_d2 = np.float32((diff ** 2).sum(-1).max() + CFG.softening_sq)
    lo, hi = tp.dist_sq_log_bounds(qt, torch.tensor(max_d2),
                                   CFG.softening_sq)
    return np.float32(lo), np.float32(hi)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_sym_uniform_plain_matches_jax(mode, dim):
    pos, m = _inputs(512, dim)
    qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
    qf = qt.is_int
    want = pallas_accelerations_sym(jnp.asarray(pos), jnp.asarray(m), qj,
                                    JCFG, quantize_forces=qf, block=128,
                                    block_j=256, uniform_gm=True)
    got = hn.sym_accelerations(_t(pos), _t(m), qt, CFG, quantize_forces=qf,
                               uniform_gm=True)
    hold(got.numpy(), want, mode)
    # the wrapper took the variant: its plain version, the single scale
    bounds = hn.kernel_bounds(_t(pos), qt, CFG)
    gm = CFG.G * _t(m)
    assert torch.equal(hn.sym_force(_t(pos), gm, bounds, qt, False,
                                    uniform=True),
                       hn.sym_force_uniform_plain(_t(pos), gm, bounds, qt,
                                                  False))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_pair_uniform_plain_matches_jax(mode, dim):
    pos, m = _inputs(512, dim, seed=1)
    gm = (CFG.G * m).astype(np.float32)
    qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
    lo, hi = _int_bounds(pos, qt) if qt.is_int else (None, None)
    want_r, want_c = pallas_pair_force_sym(
        jnp.asarray(pos[:256]), jnp.asarray(gm[:256]),
        jnp.asarray(pos[256:]), jnp.asarray(gm[256:]), qj, JCFG,
        log_lo=lo, log_hi=hi, block_i=256, block_j=128, uniform_gm=True)
    bounds = hn.kernel_bounds(_t(pos[:256]), qt, CFG, None, lo, hi)
    rows, cols = hn.pair_sym_force(_t(pos[:256]), _t(gm[:256]),
                                   _t(pos[256:]), _t(gm[256:]), bounds, qt,
                                   uniform=True)
    # the raw tile's forces (no quantize_force in the pair tile): the
    # float rule; an int d^2 bin flip moves one term, the int rule
    for got, want in ((rows, want_r), (cols, want_c)):
        if qt.is_int:
            off = np.abs(got.numpy() - np.asarray(want)) > 1e-4 * np.abs(
                np.asarray(want)).max()
            assert off.mean() < 0.02
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=1e-6)
    r2, c2 = hn.pair_sym_force_uniform_plain(
        _t(pos[:256]), _t(gm[:256]), _t(pos[256:]), _t(gm[256:]), bounds, qt)
    assert torch.equal(rows, r2) and torch.equal(cols, c2)


@pytest.mark.parametrize("n", [1024, 1400])
def test_chunked_uniform_matches_jax_and_dense(n):
    """Chunks of 512: at N=1400 the tail chunk (376) degrades to the
    general kernels, per chunk, as JAX's padded tail chunk does."""
    pos, m = _inputs(n, 2, seed=7)
    qj, qt = jp.Quantizer(), tp.Quantizer()
    want = pallas_accelerations_sym_chunked(jnp.asarray(pos), jnp.asarray(m),
                                            qj, JCFG, chunk=512,
                                            uniform_gm=True)
    dense = jf.dense_accelerations(jnp.asarray(pos), jnp.asarray(m), qj,
                                   JCFG)
    got = hn.sym_accelerations_chunked(_t(pos), _t(m), qt, CFG, chunk=512,
                                       uniform_gm=True)
    for ref in (want, dense):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5,
                                   atol=2e-6)
    if n == 1400:
        # the two full chunks take the variant, the tail the general path
        general = hn.sym_accelerations_chunked(_t(pos), _t(m), qt, CFG,
                                               chunk=512)
        assert not torch.equal(got, general)
        tail = hn.sym_accelerations_chunked(_t(pos[1024:]), _t(m[1024:]), qt,
                                            CFG, chunk=512, uniform_gm=True)
        assert torch.equal(tail, hn.sym_accelerations_chunked(
            _t(pos[1024:]), _t(m[1024:]), qt, CFG, chunk=512))


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_flag_off_the_tile_is_bitwise_general(mode):
    """N=500 (sym) and 250 x 250 (pair): not multiples of TILE, so the flag
    changes no bit."""
    pos, m = _inputs(500, 2, seed=3)
    qt = tp.Quantizer.from_string(mode)
    a = hn.sym_accelerations(_t(pos), _t(m), qt, CFG, uniform_gm=True)
    b = hn.sym_accelerations(_t(pos), _t(m), qt, CFG)
    assert torch.equal(a, b)
    gm = CFG.G * _t(m)
    bounds = hn.kernel_bounds(_t(pos), qt, CFG)
    flagged = hn.pair_sym_force(_t(pos[:250]), gm[:250], _t(pos[250:]),
                                gm[250:], bounds, qt, uniform=True)
    plain = hn.pair_sym_force(_t(pos[:250]), gm[:250], _t(pos[250:]),
                              gm[250:], bounds, qt)
    assert all(torch.equal(x, y) for x, y in zip(flagged, plain))
    # a multiple of TILE does take the variant (another summation order)
    assert not torch.equal(
        hn.sym_accelerations(_t(pos[:448]), _t(m[:448]), qt, CFG,
                             quantize_forces=False, uniform_gm=True),
        hn.sym_accelerations(_t(pos[:448]), _t(m[:448]), qt, CFG,
                             quantize_forces=False))


def test_guard_rejects_unequal_masses_at_every_surface():
    """The counterparts of tests/test_pallas_kernel.py:459-490, and the
    ring's runners (JAX ring.py:67-91)."""
    from nbody_tpu_torch.parallel import ring
    pos, _ = _inputs(512, 2)
    vel = np.zeros_like(pos)
    m_bad = np.linspace(1.0, 2.0, 512, dtype=np.float32)
    q = tp.Quantizer()
    st = make_state(_t(pos), _t(vel), _t(m_bad), "cpu")
    mesh = ring.ParticleMesh.virtual(2, "cpu")
    calls = [
        lambda: hn.sym_accelerations(_t(pos), _t(m_bad), q, CFG,
                                     uniform_gm=True),
        lambda: hn.sym_accelerations(_t(pos), None, q, CFG,
                                     gm=CFG.G * _t(m_bad), uniform_gm=True),
        lambda: hn.sym_accelerations_chunked(_t(pos), _t(m_bad), q, CFG,
                                             chunk=256, uniform_gm=True),
        lambda: td.run_steps(st, q, CFG, "kernel", False, 1,
                             uniform_gm=True),
        lambda: td.run_with_snapshots(st, q, CFG, "kernel", False, 1, 1,
                                      uniform_gm=True),
        lambda: ring.run_steps_sharded(st, q, CFG, mesh, 1,
                                       uniform_gm=True),
        lambda: ring.run_with_snapshots_sharded(st, q, CFG, mesh, 1, 1,
                                                uniform_gm=True),
        lambda: ring.ring_accelerations(_t(pos), _t(m_bad), q, CFG, mesh,
                                        uniform_gm=True),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="uniform_gm"):
            call()
    hn.check_uniform_gm(np.ones(4))
    with pytest.raises(ValueError, match="masses differ"):
        hn.check_uniform_gm(np.arange(4.0))


def test_guard_passes_equal_masses_and_gm_override():
    """Equal masses pass; gm= is what the kernel reads, so gm is what is
    checked (tests/test_pallas_kernel.py:493-504); the unguarded inner
    function does not read the masses at all."""
    pos, m = _inputs(512, 2)
    q = tp.Quantizer()
    a = hn.sym_accelerations(_t(pos), _t(m), q, CFG, uniform_gm=True)
    b = hn.sym_accelerations(_t(pos), _t(np.linspace(1, 2, 512)), q, CFG,
                             gm=CFG.G * _t(m), uniform_gm=True)
    assert torch.equal(a, b)
    assert hn.prevalidated(hn.sym_accelerations) is not hn.sym_accelerations
    inner = hn.prevalidated(hn.sym_accelerations)(
        _t(pos), _t(np.linspace(1, 2, 512).astype(np.float32)), q, CFG,
        uniform_gm=True)
    assert inner.shape == (512, 2)


def test_direct_simulation_detects_equal_masses_and_defaults_to_cuda():
    pos, m = _inputs(128, 2)
    vel = np.zeros_like(pos)
    sim = td.DirectSimulation(pos, vel, m, device="cpu")
    assert sim._uniform_gm and sim.device == torch.device("cpu")
    m2 = m.copy()
    m2[5] = 2.0
    assert not td.DirectSimulation(pos, vel, m2, device="cpu")._uniform_gm
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            td.DirectSimulation(pos, vel, m)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            td.run_comparison(pos, vel, m, modes=["float32"], num_ticks=2)
    # the flag reaches every run: the equal-mass plain version's bits
    sim.step(3)
    ref = td.DirectSimulation(pos, vel, m, device="cpu")
    ref.state = td.run_steps(ref.state, ref.quantizer, ref.cfg, "kernel",
                             False, 3, uniform_gm=True)
    assert torch.equal(sim.positions, ref.positions)


def test_force_fn_takes_the_variant_only_on_the_sym_paths():
    for impl in ("kernel", "kernel_sym_chunked"):
        fn = td._force_fn(impl, 4096, 2, uniform_gm=True)
        assert fn.keywords == {"uniform_gm": True}
    for impl in ("dense", "tiled", "kernel_rows", "kernel_streamed"):
        assert td._force_fn(impl, 4096, 2, uniform_gm=True) is \
            td._FORCE_FNS[impl]
