"""nbody_tpu_torch force layer and kernels' plain versions against nbody_tpu.

On the CPU the kernel wrappers take their plain PyTorch versions, so these
tests hold the plain versions (and the port's pruned bounds pass) to the
JAX package: ``pallas_accelerations_sym`` / ``pallas_max_dist_sq`` in
interpret mode, as the JAX package's own tests run them, and the plain
jnp paths. Inputs are made with numpy from a seed. The CUDA kernels
themselves are held to their plain versions in tests/test_torch_kernels.py.

Tolerances: float modes rtol 5e-5, atol 2e-6 (tests/test_pallas_kernel.py);
int modes <2% of components off by >1e-4 max|a|, because a pair whose d^2
lands within an ulp of a log-grid bin edge can flip a whole bin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.ops import forces as jf
from nbody_tpu.ops import precision as jp
from nbody_tpu.ops.pallas_nbody import (pallas_accelerations_sym,
                                        pallas_max_dist_sq)
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import forces as tf
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

MODES = ["float32", "bf16", "f16", "int8", "int4", "custom"]


def _inputs(n, dim, equal_masses, seed=0):
    """Disk-like (2-D) or Gaussian (3-D) positions and masses, numpy."""
    rng = np.random.default_rng(seed + 31 * n + dim)
    if dim == 2:
        r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
        a = rng.uniform(0, 2 * np.pi, n)
        pos = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    else:
        pos = rng.standard_normal((n, 3)) * 5.0
    m = np.ones(n) if equal_masses else 1.0 + rng.random(n)
    return pos.astype(np.float32), m.astype(np.float32)


def _port(pos, m, mode, softening, quantize):
    cfg = SimConfig(softening=softening)
    q = tp.Quantizer.from_string(mode)
    return hn.sym_accelerations(torch.from_numpy(pos), torch.from_numpy(m),
                                q, cfg, quantize_forces=quantize).numpy()


def _assert_agree(got, want, is_int):
    assert np.isfinite(got).all()
    if is_int:
        scale = np.abs(want).max()
        frac_bad = (np.abs(got - want) > 1e-4 * scale).mean()
        assert frac_bad < 0.02, f"{frac_bad:.3%} components off"
    else:
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=2e-6)


@pytest.mark.parametrize("mode,dim", [(m, 2) for m in MODES]
                         + [("float32", 3), ("int4", 3)])
def test_plain_sym_matches_jax_pallas_interpret(mode, dim):
    pos, m = _inputs(256, dim, equal_masses=False)
    qj = jp.Quantizer.from_string(mode)
    quantize = qj.is_int
    want = np.asarray(pallas_accelerations_sym(
        jnp.asarray(pos), jnp.asarray(m), qj, JaxConfig(),
        quantize_forces=quantize, block=128))
    got = _port(pos, m, mode, 0.1, quantize)
    _assert_agree(got, want, qj.is_int)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [5, 256, 300])
def test_plain_sym_matches_jax_dense(mode, dim, n):
    qj = jp.Quantizer.from_string(mode)
    for equal in (False, True):
        pos, m = _inputs(n, dim, equal)
        want = np.asarray(jf.dense_accelerations(
            jnp.asarray(pos), jnp.asarray(m), qj, JaxConfig(),
            quantize_forces=qj.is_int))
        _assert_agree(_port(pos, m, mode, 0.1, qj.is_int), want, qj.is_int)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_sym_zero_softening_matches_jax_dense(mode, dim):
    """Zero softening: the diagonal must be masked (no 0 * inf)."""
    qj = jp.Quantizer.from_string(mode)
    pos, m = _inputs(300, dim, equal_masses=False, seed=5)
    want = np.asarray(jf.dense_accelerations(
        jnp.asarray(pos), jnp.asarray(m), qj, JaxConfig(softening=0.0),
        quantize_forces=qj.is_int))
    _assert_agree(_port(pos, m, mode, 0.0, qj.is_int), want, qj.is_int)


@pytest.mark.parametrize("mode", MODES)
def test_port_dense_and_tiled_match_jax(mode):
    pos, m = _inputs(300, 2, equal_masses=False, seed=2)
    qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
    want = np.asarray(jf.dense_accelerations(jnp.asarray(pos),
                                             jnp.asarray(m), qj, JaxConfig()))
    pt, mt = torch.from_numpy(pos), torch.from_numpy(m)
    dense = tf.dense_accelerations(pt, mt, qt, SimConfig()).numpy()
    tiled = tf.tiled_accelerations(pt, mt, qt, SimConfig(), block=128).numpy()
    _assert_agree(dense, want, qj.is_int)
    _assert_agree(tiled, want, qj.is_int)


def _ring(n):
    """A ring whose radius peaks gently at angle 0: every point clears the
    pruned pass's radius threshold (so it must fall back to the full set)
    and the largest radii form an arc without the diameter pair."""
    a = np.arange(n) * (2 * np.pi / n)
    r = 10.0 + 0.01 * np.cos(a)
    return np.stack([r * np.cos(a), r * np.sin(a)], 1).astype(np.float32)


@pytest.mark.parametrize("geometry", ["disk", "disk3d", "ring"])
def test_pruned_max_bitwise_equals_full_max(geometry):
    pos = {"disk": lambda: _inputs(300, 2, True)[0],
           "disk3d": lambda: _inputs(300, 3, True)[0],
           "ring": lambda: _ring(300)}[geometry]()
    pt = torch.from_numpy(pos)
    cfg = SimConfig()
    full = tf.max_pairwise_dist_sq(pt, cfg)
    assert torch.equal(full, hn.max_d2_plain(pt) + cfg.softening_sq)
    assert torch.equal(full, hn.max_dist_sq(pt, cfg))
    # 64 candidates out of 300: the disk takes the candidate path, the
    # ring the full-set fallback
    for m in (64, 1024):
        pruned = tf.max_pairwise_dist_sq_pruned(pt, cfg, max_candidates=m)
        assert torch.equal(pruned, full), (m, pruned, full)
    if geometry == "ring":
        r = torch.linalg.vector_norm(pt - pt.mean(0), dim=1)
        cand = pt[torch.topk(r, 64).indices]
        assert hn.max_d2_plain(cand) < hn.max_d2_plain(pt)


def test_max_d2_skip_flag():
    pt = torch.from_numpy(_inputs(300, 2, True)[0])
    one = torch.ones((), dtype=torch.int32)
    assert hn.max_d2(pt, skip=one).item() == 0.0
    assert torch.equal(hn.max_d2(pt, skip=one * 0), hn.max_d2_plain(pt))


@pytest.mark.parametrize("geometry", ["disk", "disk3d", "ring"])
def test_max_pass_within_one_ulp_of_jax(geometry):
    """The JAX variants differ from each other by 1 ulp on the CPU (XLA
    may contract d^2 into an FMA on some of them); allow 1 ulp."""
    pos = {"disk": lambda: _inputs(300, 2, True)[0],
           "disk3d": lambda: _inputs(300, 3, True)[0],
           "ring": lambda: _ring(300)}[geometry]()
    pj = jnp.asarray(pos)
    got = float(tf.max_pairwise_dist_sq_pruned(torch.from_numpy(pos),
                                               SimConfig()))
    for want in (jf.max_pairwise_dist_sq(pj, JaxConfig()),
                 pallas_max_dist_sq(pj, JaxConfig(), block_i=128,
                                    block_j=256),
                 jf.max_pairwise_dist_sq_pruned(pj, JaxConfig())):
        np.testing.assert_allclose(got, float(want), rtol=2e-7)


@pytest.mark.parametrize("dim", [2, 3])
def test_f64_baseline_force_matches_jax_double_double(dim):
    pos, m = _inputs(300, dim, equal_masses=False, seed=9)
    want = np.asarray(jf.baseline_accelerations_dd(
        jnp.asarray(pos), jnp.asarray(m), JaxConfig()))
    got = tf.baseline_accelerations(torch.from_numpy(pos),
                                    torch.from_numpy(m), SimConfig())
    assert got.dtype == torch.float64
    # JAX's pair terms are f32 and its sum is compensated
    # (forces.py:276-285): their rounding scales with the summed |terms|,
    # so components that cancel to near zero get atol = 1e-5 * max|a|.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_wrappers_validate_inputs():
    pt = torch.zeros((8, 2))
    gm = torch.ones(8)
    bounds = torch.zeros(3)
    q = tp.Quantizer()
    with pytest.raises(TypeError):
        hn.sym_force(pt.double(), gm, bounds, q, False)
    with pytest.raises(ValueError):
        hn.sym_force(torch.zeros((8, 4)), gm, bounds, q, False)
    with pytest.raises(ValueError):
        hn.sym_force(pt, torch.ones(7), bounds, q, False)
    with pytest.raises(ValueError):
        hn.sym_force(pt.t().contiguous().t(), gm, bounds, q, False)
    with pytest.raises(ValueError):
        hn.max_d2(pt, skip=torch.ones(()))
