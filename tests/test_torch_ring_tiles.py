"""The multi-device ring's tiles in nbody_tpu_torch against nbody_tpu's, on the CPU.

pair_force (#10), pair_max (#9) and pair_pe_rows (#7): the port's wrappers,
which take their plain PyTorch versions for CPU tensors, against
``pallas_pair_force``, ``pallas_pair_max`` and ``pallas_pair_pe_rows``
called directly (interpret mode on the CPU, as tests/test_pallas_kernel.py
and tests/test_parallel_ring.py run them). Inputs are made with numpy from
a seed; ragged sizes pad on the JAX side and are counts in the port. The
CUDA kernels are held to the same plain versions in
tests/test_torch_kernels.py.

Tolerances, each with its reason:

* pair_force, float32 / float64 modes: |err| <= 1e-5 x the row's summed
  |terms| (pair_force_term_scale): the same terms summed in another order
  (XLA's lane blocks against torch's row sums); the typical error of a
  k-term f32 sum is sqrt(k) u (~2e-6 at k = 700), its worst case k u (4e-5).
* pair_force, int8 / int4 / custom, bf16 and f16: fewer than 2% of the
  components off by more than 1e-4 max|a| (tests/test_torch_forces.py): a
  d^2 within an ulp of a log-grid bin edge moves a whole bin between XLA's
  and torch's log, and XLA:CPU contracts the Pallas tile's d^2 into an FMA,
  one ulp off the subtract form, which can flip a bf16/f16 rounding tie
  (ROADMAP Queue 3).
* pair_max: bitwise, or one ulp where XLA:CPU contracts d^2 into an FMA.
* pair_pe_rows: relative to the row, 1e-5 (its terms are positive, so the
  row is its summed |terms|; the same order argument as pair_force).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.ops import precision as jp
from nbody_tpu.ops.pallas_nbody import (pallas_pair_force, pallas_pair_max,
                                        pallas_pair_pe_rows)
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

MODES = ["float64", "float32", "bf16", "f16", "int8", "int4", "custom"]
N_I, N_J = 100, 230       # disjoint sets of ragged sizes
N_ONE = 150               # one set as receivers and sources
TERMS_RTOL = 1e-5


def _points(n, dim, seed):
    """Disk-like (2-D) or Gaussian (3-D) positions and unequal masses."""
    rng = np.random.default_rng(seed + 31 * n + dim)
    if dim == 2:
        r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
        a = rng.uniform(0, 2 * np.pi, n)
        pos = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    else:
        pos = rng.standard_normal((n, 3)) * 5.0
    return pos.astype(np.float32), (1.0 + rng.random(n)).astype(np.float32)


def _sets(dim, one_set, seed=0):
    if one_set:
        pos, m = _points(N_ONE, dim, seed)
        return pos, m, pos, m
    pos, m = _points(N_I + N_J, dim, seed)
    return pos[:N_I], m[:N_I], pos[N_I:], m[N_I:]


def _log_bounds(pos, q):
    """The int-sim grid's global (log_lo, log_hi) over a point set, f32."""
    diff = pos[None, :, :].astype(np.float64) - pos[:, None, :]
    max_d2 = np.float32((diff ** 2).sum(-1).max() + 0.01)
    lo, hi = tp.dist_sq_log_bounds(q, torch.tensor(max_d2), 0.01)
    return np.float32(lo), np.float32(hi)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("one_set", [False, True], ids=["disjoint", "one"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_pair_force_matches_jax(mode, dim, one_set):
    xi, _, xj, mj = _sets(dim, one_set)
    gm_j = (0.001 * mj).astype(np.float32)
    qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
    lo = hi = None
    if qt.is_int:
        lo, hi = _log_bounds(np.concatenate([xi, xj]), qt)
    want = np.asarray(pallas_pair_force(
        jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(gm_j), qj, JaxConfig(),
        log_lo=lo, log_hi=hi, block_i=128))
    lo_t = None if lo is None else torch.tensor(lo)
    hi_t = None if hi is None else torch.tensor(hi)
    before = dict(hn.LAUNCHES)
    got = hn.pair_force(_t(xi), _t(xj), _t(gm_j), qt, SimConfig(), lo_t,
                        hi_t).numpy()
    assert hn.LAUNCHES == before  # CPU tensors: the plain version
    assert got.shape == (xi.shape[0], dim) and np.isfinite(got).all()
    if qt.is_int or mode in ("bf16", "f16"):
        off = np.abs(got - want) > 1e-4 * np.abs(want).max()
        assert off.mean() < 0.02, f"{off.mean():.3%} components off"
    else:
        bounds = hn.kernel_bounds(_t(xi), qt, SimConfig())
        scale = hn.pair_force_term_scale(_t(xi), _t(xj), _t(gm_j), bounds,
                                         qt).numpy()
        assert (np.abs(got - want) <= TERMS_RTOL * scale + 1e-12).all()


def _one_ulp(got, want):
    want = np.float32(want)
    return got == want or got in (np.nextafter(want, np.float32(np.inf)),
                                  np.nextafter(want, np.float32(0)))


@pytest.mark.parametrize("valid", ["all", "some", "no receivers"])
@pytest.mark.parametrize("dim", [2, 3])
def test_pair_max_matches_jax(dim, valid):
    xi, _, xj, _ = _sets(dim, one_set=False, seed=1)
    rng = np.random.default_rng(dim)
    vi, vj = {"all": (np.ones(N_I, bool), np.ones(N_J, bool)),
              "some": (rng.random(N_I) < 0.6, rng.random(N_J) < 0.6),
              "no receivers": (np.zeros(N_I, bool), np.ones(N_J, bool))}[valid]
    want = np.float32(pallas_pair_max(jnp.asarray(xi), jnp.asarray(xj),
                                      jnp.asarray(vi), jnp.asarray(vj),
                                      block_i=128))
    got = np.float32(hn.pair_max(_t(xi), _t(xj), _t(vi), _t(vj)))
    assert _one_ulp(got, want), (got, want)
    if valid == "no receivers":
        assert got == 0.0


def test_pair_max_of_one_set_is_max_d2():
    """One set against itself, all valid: bitwise the single-device max."""
    pos, _ = _points(N_ONE, 2, 5)
    ones = torch.ones(N_ONE, dtype=torch.bool)
    assert torch.equal(hn.pair_max(_t(pos), _t(pos), ones, ones),
                       hn.max_d2(_t(pos)))


@pytest.mark.parametrize("ids", ["disjoint", "one set", "overlapping"])
@pytest.mark.parametrize("dim", [2, 3])
def test_pair_pe_rows_matches_jax(dim, ids):
    """Self ids: one set with its own ids (every self-pair masked), and two
    sets sharing the ids of a few particles."""
    xi, mi, xj, mj = _sets(dim, one_set=ids == "one set", seed=2)
    ids_i = np.arange(len(xi), dtype=np.int32)
    ids_j = {"disjoint": np.arange(len(xi), len(xi) + len(xj)),
             "one set": ids_i,
             "overlapping": np.arange(len(xi) - 7, len(xi) - 7 + len(xj))
             }[ids].astype(np.int32)
    want = np.asarray(pallas_pair_pe_rows(
        jnp.asarray(xi), jnp.asarray(mi), jnp.asarray(ids_i), jnp.asarray(xj),
        jnp.asarray(mj), jnp.asarray(ids_j), 0.01, block_i=128))
    got = hn.pair_pe_rows(_t(xi), _t(mi), _t(ids_i), _t(xj), _t(mj),
                          _t(ids_j), 0.01).numpy()
    assert got.shape == (len(xi),) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tile_wrappers_reject_bad_arguments():
    pos, m = _points(20, 2, 3)
    p, g = _t(pos), _t(0.001 * m)
    q4, cfg = tp.Quantizer.from_string("int4"), SimConfig()
    for fn in (hn.pair_force, hn.pair_force_plain):
        with pytest.raises(ValueError, match="need global log bounds"):
            fn(p, p, g, q4, cfg)
    ones = torch.ones(20, dtype=torch.bool)
    with pytest.raises(ValueError, match="bool tensor"):
        hn.pair_max(p, p, ones.to(torch.float32), ones)
    ids = torch.arange(20, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 tensor"):
        hn.pair_pe_rows(p, _t(m), ids.to(torch.int64), p, _t(m), ids, 0.01)
    with pytest.raises(ValueError, match="receivers are 2-D"):
        hn.pair_force(p, torch.zeros((5, 3)), torch.zeros(5),
                      tp.Quantizer.from_string("float32"), cfg)
