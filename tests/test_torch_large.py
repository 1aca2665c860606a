"""nbody_tpu_torch's large-N force paths against nbody_tpu's, on the CPU.

The row sweep (``accelerations_rows`` / ``accelerations_streamed``), the
Newton's-third-law pair tile (``pair_sym_force``) and the chunked path
(``sym_accelerations_chunked``). On the CPU the kernel wrappers take their
plain PyTorch versions; the JAX side runs its Pallas kernels in interpret
mode, as tests/test_pallas_kernel.py runs them. Inputs are made with numpy
from a seed. The CUDA kernels themselves are held to their plain versions
in tests/test_torch_kernels.py.

Tolerances: float modes rtol 5e-5, atol 2e-6 (tests/test_pallas_kernel.py);
int modes <2% of components off by >1e-4 max|a| (tests/test_torch_forces.py),
because a pair whose d^2 lands within an ulp of a log-grid bin edge can flip
a whole bin between XLA's and torch's log. The pair tile's bf16/f16 cases
take the int rule too: XLA:CPU contracts the pair kernel's d^2 into an FMA,
one ulp off the subtract form, and that flips the f16 rounding of a d^2
near a tie (seen: one pair of 210,000, one reaction off by 2.6e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.ops import precision as jp
from nbody_tpu.ops.pallas_nbody import (pallas_accelerations,
                                        pallas_accelerations_streamed,
                                        pallas_accelerations_sym_chunked,
                                        pallas_pair_force_sym)
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

MODES = ["float32", "bf16", "f16", "int8", "int4", "custom"]
# (softening, run-time softening^2 or None): static 0.1, static 0, and a
# run-time value over the static default.
SOFTENINGS = {"0.1": (0.1, None), "0": (0.0, None), "run-time": (0.1, 0.0025)}


def _inputs(n, dim, seed=0, origin=False):
    """Disk-like (2-D) or Gaussian (3-D) positions, unequal masses, numpy;
    ``origin`` puts particle 0 exactly at the origin."""
    rng = np.random.default_rng(seed + 31 * n + dim)
    if dim == 2:
        r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
        a = rng.uniform(0, 2 * np.pi, n)
        pos = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    else:
        pos = rng.standard_normal((n, 3)) * 5.0
    if origin:
        pos[0] = 0.0
    m = 1.0 + rng.random(n)
    return pos.astype(np.float32), m.astype(np.float32)


def _assert_agree(got, want, is_int):
    assert np.isfinite(got).all()
    if is_int:
        scale = np.abs(want).max()
        frac_bad = (np.abs(got - want) > 1e-4 * scale).mean()
        assert frac_bad < 0.02, f"{frac_bad:.3%} components off"
    else:
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=2e-6)


def _rows_case(jax_fn, port_fn, mode, dim, soft):
    softening, runtime = SOFTENINGS[soft]
    # N=300 pads to 512 on the JAX side; at zero softening a real particle
    # at the origin must stay finite next to the padding (the far-sentinel
    # case of tests/test_pallas_kernel.py:209-240).
    pos, m = _inputs(300, dim, origin=softening == 0.0)
    qj = jp.Quantizer.from_string(mode)
    want = np.asarray(jax_fn(
        jnp.asarray(pos), jnp.asarray(m), qj, JaxConfig(softening=softening),
        quantize_forces=qj.is_int, block_i=128, block_j=256,
        softening_sq=None if runtime is None else jnp.float32(runtime)))
    got = port_fn(
        torch.from_numpy(pos), torch.from_numpy(m),
        tp.Quantizer.from_string(mode), SimConfig(softening=softening),
        quantize_forces=qj.is_int,
        softening_sq=None if runtime is None else torch.tensor(runtime))
    _assert_agree(got.numpy(), want, qj.is_int)


@pytest.mark.parametrize("soft", list(SOFTENINGS))
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_rows_match_jax_pallas_accelerations(mode, dim, soft):
    _rows_case(pallas_accelerations, hn.accelerations_rows, mode, dim, soft)


@pytest.mark.parametrize("soft", list(SOFTENINGS))
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_streamed_matches_jax_pallas_streamed(mode, dim, soft):
    _rows_case(pallas_accelerations_streamed, hn.accelerations_streamed,
               mode, dim, soft)


def _log_bounds(pos, softening_sq, q):
    """Tensor-global int-sim grid bounds over a point set, as numpy f32."""
    diff = pos[None, :, :].astype(np.float64) - pos[:, None, :]
    max_d2 = np.float32((diff ** 2).sum(-1).max() + softening_sq)
    lo, hi = tp.dist_sq_log_bounds(q, torch.tensor(max_d2), softening_sq)
    return np.float32(lo), np.float32(hi)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_pair_sym_force_matches_jax(mode, dim):
    """Disjoint sets of ragged sizes (both pad on the JAX side): the
    receivers' rows and the sources' reactions."""
    pos, m = _inputs(300 + 700, dim, seed=4)
    gm = (0.001 * m).astype(np.float32)
    qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
    lo, hi = _log_bounds(pos, 0.01, qt) if qt.is_int else (None, None)
    want_r, want_c = pallas_pair_force_sym(
        jnp.asarray(pos[:300]), jnp.asarray(gm[:300]),
        jnp.asarray(pos[300:]), jnp.asarray(gm[300:]), qj, JaxConfig(),
        log_lo=lo, log_hi=hi, block_i=128)
    bounds = torch.tensor([0.0 if lo is None else lo,
                           0.0 if hi is None else hi, 0.01],
                          dtype=torch.float32)
    pt, gt = torch.from_numpy(pos), torch.from_numpy(gm)
    rows, cols = hn.pair_sym_force(pt[:300], gt[:300], pt[300:], gt[300:],
                                   bounds, qt)
    assert rows.shape == (300, dim) and cols.shape == (700, dim)
    rounds_d2 = qt.is_int or mode in ("bf16", "f16")
    _assert_agree(rows.numpy(), np.asarray(want_r), rounds_d2)
    _assert_agree(cols.numpy(), np.asarray(want_c), rounds_d2)


def test_pair_sym_force_is_the_sym_force_of_the_union():
    """rows + the union's diagonal blocks = the union's sym forces, and the
    reactions are Newton's third law: sum of gm_a rows = -sum of gm_b
    cols (in f64, to the f32 rounding of the terms)."""
    pos, m = _inputs(500, 2, seed=5)
    gm = torch.from_numpy(0.001 * m)
    pt = torch.from_numpy(pos)
    bounds = torch.tensor([0.0, 0.0, 0.01])
    q = tp.Quantizer()
    rows, cols = hn.pair_sym_force(pt[:200], gm[:200], pt[200:], gm[200:],
                                   bounds, q)
    whole = hn.sym_force(pt, gm, bounds, q, False)
    own_a = hn.sym_force(pt[:200], gm[:200], bounds, q, False)
    own_b = hn.sym_force(pt[200:], gm[200:], bounds, q, False)
    np.testing.assert_allclose((own_a + rows).numpy(), whole[:200].numpy(),
                               rtol=5e-5, atol=2e-6)
    np.testing.assert_allclose((own_b + cols).numpy(), whole[200:].numpy(),
                               rtol=5e-5, atol=2e-6)
    momentum = ((gm[:200, None].double() / 0.001) * rows.double()).sum(0) \
        + ((gm[200:, None].double() / 0.001) * cols.double()).sum(0)
    assert momentum.abs().max() < 1e-5 * rows.abs().max()


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_chunked_matches_jax_chunked(mode):
    """Three chunks of 512 with a ragged last one (1400 = 512 + 512 + 376;
    the JAX side pads it)."""
    pos, m = _inputs(1400, 2, seed=7)
    qj = jp.Quantizer.from_string(mode)
    want = np.asarray(pallas_accelerations_sym_chunked(
        jnp.asarray(pos), jnp.asarray(m), qj, JaxConfig(),
        quantize_forces=qj.is_int, chunk=512))
    got = hn.sym_accelerations_chunked(
        torch.from_numpy(pos), torch.from_numpy(m),
        tp.Quantizer.from_string(mode), SimConfig(),
        quantize_forces=qj.is_int, chunk=512)
    _assert_agree(got.numpy(), want, qj.is_int)


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_chunked_matches_single_sym(mode):
    """The same pairs in another summation order: the chunked path against
    the single-launch sym path on the port's own plain versions (f32:
    rtol 5e-5, atol 2e-6; the int grid is the same, so only order)."""
    pos, m = _inputs(700, 3, seed=8)
    q, cfg = tp.Quantizer.from_string(mode), SimConfig()
    pt, mt = torch.from_numpy(pos), torch.from_numpy(m)
    single = hn.sym_accelerations(pt, mt, q, cfg, quantize_forces=False)
    for chunk in (350, 234, 64):
        got = hn.sym_accelerations_chunked(pt, mt, q, cfg,
                                           quantize_forces=False,
                                           chunk=chunk)
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=5e-5,
                                   atol=2e-6)


def test_chunked_runtime_softening_falls_back_to_rows():
    """Run-time softening routes chunked -> the row sweep (JAX
    pallas_nbody.py:892-895) and matches JAX's fallback."""
    pos, m = _inputs(600, 2, seed=9)
    want = np.asarray(pallas_accelerations_sym_chunked(
        jnp.asarray(pos), jnp.asarray(m), jp.Quantizer(), JaxConfig(),
        chunk=512, softening_sq=jnp.float32(0.04)))
    got = hn.sym_accelerations_chunked(
        torch.from_numpy(pos), torch.from_numpy(m), tp.Quantizer(),
        SimConfig(), chunk=512, softening_sq=torch.tensor(0.04))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=2e-6)
    rows = hn.accelerations_rows(torch.from_numpy(pos), torch.from_numpy(m),
                                 tp.Quantizer(), SimConfig(softening=0.2))
    np.testing.assert_allclose(got.numpy(), rows.numpy(), rtol=5e-5,
                               atol=2e-6)


def test_chunked_zero_softening_matches_jax():
    pos, m = _inputs(600, 2, seed=10, origin=True)
    cfg_j, cfg_t = JaxConfig(softening=0.0), SimConfig(softening=0.0)
    want = np.asarray(pallas_accelerations_sym_chunked(
        jnp.asarray(pos), jnp.asarray(m), jp.Quantizer(), cfg_j, chunk=512))
    got = hn.sym_accelerations_chunked(torch.from_numpy(pos),
                                       torch.from_numpy(m), tp.Quantizer(),
                                       cfg_t, chunk=512)
    _assert_agree(got.numpy(), want, False)


def test_row_force_plain_sampled_rows_and_wrapper_checks():
    pos, m = _inputs(300, 3, seed=11)
    pt, gm = torch.from_numpy(pos), torch.from_numpy(0.001 * m)
    bounds = torch.tensor([0.0, 0.0, 0.0])
    q = tp.Quantizer()
    full = hn.row_force(pt, gm, bounds, q, True)
    rows = torch.tensor([0, 7, 299, 150])
    np.testing.assert_array_equal(
        hn.row_force_plain(pt, gm, bounds, q, True, rows=rows).numpy(),
        full[rows].numpy())
    with pytest.raises(ValueError):
        hn.pair_sym_force(pt, gm, torch.zeros((4, 2)), torch.ones(4),
                          bounds, q)
    with pytest.raises(TypeError):
        hn.row_force(pt.double(), gm, bounds, q, False)
    with pytest.raises(ValueError):
        hn.max_d2(pt, count=torch.zeros(()))


def test_bounds_fallback_counter_on_the_cpu():
    """The pruned pass counts its full-set launches per device: a ring
    takes the fallback, a disk does not."""
    a = np.arange(2000) * (2 * np.pi / 2000)
    r = 10.0 + 0.01 * np.cos(a)
    ring = torch.from_numpy(np.stack([r * np.cos(a), r * np.sin(a)],
                                     1).astype(np.float32))
    disk = torch.from_numpy(_inputs(2000, 2)[0])
    hn.BOUNDS_FALLBACKS.clear()
    hn.max_pairwise_dist_sq_pruned(disk, SimConfig())
    assert hn.bounds_fallbacks("cpu") == 0
    hn.max_pairwise_dist_sq_pruned(ring, SimConfig())
    hn.max_pairwise_dist_sq_pruned(ring, SimConfig())
    assert hn.bounds_fallbacks("cpu") == 2
    hn.BOUNDS_FALLBACKS.clear()
