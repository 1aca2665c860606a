"""The general pair tile in the one-pass design and the register-tiled row
sweep, and the rules that shape their launches.

``pair_sym_force`` with unequal masses takes the one-pass design
(csrc/one_pass.cuh's body with G m per particle) under the same rule as
its equal-mass variant (``pair_design``: both sets multiples of TILE, more
than ``ONE_PASS_MIN_TILES`` receiver tiles, the (mode family, D) in
``ONE_PASS_ROUTES``); ragged or phantom sets and ``parent=True`` keep the
two-pass tile. ``row_force`` and ``pair_force`` run the register-tiled
kernel (csrc/row_force.cu's row_tiled), its source segments a fixed
function of (n_i, n_j) (``row_segments``); ``parent=True`` reaches the
earlier kernel.

On the CPU these tests hold the rules, the scratch reckoning (the one-pass
scratch under the two-pass reckoning, so the 1M chunking stays 5 x 209728
at D=2 and 6 x 174784 at D=3; the row sweep's segment sums far under
``SCRATCH_BUDGET``), the wrappers' ``parent`` flags on CPU tensors, and the
plain versions (which the wrappers take for CPU tensors) against the JAX
package: ``pair_sym_force_plain`` with unequal masses against
``pallas_pair_force_sym`` (Pallas interpret mode) at odd multiples of 64
and ragged sizes; ``accelerations_rows`` against ``pallas_accelerations``
at zero softening (self-masked) across a 512-receiver block; ``pair_force``
against ``pallas_pair_force`` at ragged sizes. Tolerances as in
tests/test_torch_sym_uniform.py and tests/test_torch_large.py: float rtol
2e-5 / atol 1e-6 for the pair tile (5e-5 / 2e-6 for the row sweep), int
modes fewer than 2% of components off by more than 1e-4 max|a| (a d^2
within an ulp of a log-grid bin edge flips a bin between XLA's and torch's
log). The ``gpu`` tests hold both kernels to their plain versions on the
card by PERF.md section 2's rules, and bitwise run to run; they skip
without a card:

    python -m pytest --noconftest -q -m gpu tests/test_torch_redesign_rows_general.py
"""

import math

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

CFG = SimConfig()
FAMILIES = {"float32": "float", "bf16": "float", "f16": "float",
            "int8": "int", "int4": "int", "custom": "int"}
ODD_PAIRS = ((192, 320), (320, 192))          # 3 and 5 tiles of 64
RAGGED_PAIRS = ((131, 517), (300, 64))        # not multiples of 64


def _inputs(n, dim, seed=0):
    """Disk-like (2-D) or Gaussian (3-D) positions and unequal masses."""
    rng = np.random.default_rng(seed + 31 * n + dim)
    if dim == 2:
        r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
        a = rng.uniform(0, 2 * np.pi, n)
        pos = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    else:
        pos = rng.standard_normal((n, 3)) * 5.0
    return pos.astype(np.float32), (1.0 + rng.random(n)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _q(mode):
    return tp.Quantizer.from_string(mode)


# --------------------------------------------------------------------------
# The routing rule of the general pair tile
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [1, 256, 257, 2731, 3277])
@pytest.mark.parametrize("mode", list(FAMILIES))
@pytest.mark.parametrize("dim", [2, 3])
def test_general_pair_design_follows_the_equal_mass_rule(tiles, mode, dim):
    q = _q(mode)
    want = ("one_pass" if tiles > hn.ONE_PASS_MIN_TILES
            and (FAMILIES[mode], dim) in hn.ONE_PASS_ROUTES else "two_pass")
    n = tiles * hn.TILE
    for n_b in (n, hn.TILE, 209728):
        assert hn.pair_design(n, n_b, dim, q) == want
        assert hn.pair_design(n, n_b, dim, q, parent=True) == "two_pass"


@pytest.mark.parametrize("n_a,n_b", [(131075, 131075), (209727, 209728),
                                     (209728, 209727), (43691, 43691),
                                     (32769, 32769)])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_ragged_and_phantom_sets_keep_the_two_pass_tile(n_a, n_b, mode):
    """Off the tile (the ring's 131075, its phantom shards 43691 and 32769)
    neither kind takes the one-pass design."""
    for dim in (2, 3):
        assert hn.pair_design(n_a, n_b, dim, _q(mode)) == "two_pass"


@pytest.mark.parametrize("routes", [frozenset(), frozenset({("int", 3)})])
def test_general_routes_follow_one_pass_routes(monkeypatch, routes):
    """Emptying ONE_PASS_ROUTES (a whole path's A/B) takes the general tile
    back to the two-pass design, as it does the equal-mass one."""
    monkeypatch.setattr(hn, "ONE_PASS_ROUTES", routes)
    for mode, family in FAMILIES.items():
        for dim in (2, 3):
            assert hn.pair_design(209728, 209728, dim, _q(mode)) == (
                "one_pass" if (family, dim) in routes else "two_pass")


# --------------------------------------------------------------------------
# Scratch reckoning
# --------------------------------------------------------------------------

def _bytes(shapes):
    return sum(4 * math.prod(s) for s in shapes)


@pytest.mark.parametrize("n_a,n_b", [(209728, 209728), (209664, 209728),
                                     (174784, 174784), (174656, 174784),
                                     (524288, 174784), (16448, 16576)])
@pytest.mark.parametrize("dim", [2, 3])
def test_general_one_pass_scratch_under_the_two_pass_reckoning(n_a, n_b, dim):
    """The general launch allocates the one-pass shapes, bounded by the
    two-pass reckoning the chunk rule and the ring's source chunking use."""
    rows, cols = hn.pair_one_pass_scratch(n_a, n_b, dim)
    assert rows[2] == hn.ONE_PASS_RECEIVERS and cols[1] == rows[0]
    assert rows[0] * hn.ONE_PASS_RECEIVERS >= n_a
    assert cols[0] * hn.TILE == n_b
    assert _bytes((rows, cols)) <= hn.pair_sym_force_scratch_bytes(n_a, n_b,
                                                                   dim)


@pytest.mark.parametrize("dim,chunk,chunks", [(2, 209728, 5), (3, 174784, 6)])
def test_the_1m_chunking_is_unchanged_and_general_pairs_go_one_pass(
        dim, chunk, chunks):
    assert hn.sym_chunk_size(1_048_576, dim) == chunk
    assert -(-1_048_576 // chunk) == chunks
    last = 1_048_576 - (chunks - 1) * chunk
    for n_a, n_b in ((chunk, chunk), (chunk, last)):
        for mode in ("float32", "int4"):
            assert hn.pair_design(n_a, n_b, dim, _q(mode)) == "one_pass"


# --------------------------------------------------------------------------
# The row sweep's segment rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,want", [(131072, (64, 16)),
                                    (1_048_576, (8, 1024)),
                                    (5000, (40, 1)), (5, (1, 1))])
def test_row_segments_at_the_paths_shapes(n, want):
    assert hn.row_segments(n, n) == want


@pytest.mark.parametrize("n_i", [1, 5, 300, 511, 512, 513, 4099, 16448,
                                 32768, 131072, 131075, 524288, 1_048_576])
@pytest.mark.parametrize("n_j", [1, 127, 128, 1009, 32771, 131072,
                                 1_048_576])
def test_row_segments_cover_every_tile_once(n_i, n_j):
    nseg, seg = hn.row_segments(n_i, n_j)
    tiles = -(-n_j // hn.ROW_SOURCE_TILE)
    blocks = -(-n_i // hn.ROW_BLOCK_RECEIVERS)
    assert 1 <= nseg <= min(tiles, 65535) and seg >= 1
    assert (nseg - 1) * seg < tiles <= nseg * seg   # no empty segment
    # the grid aims at ROW_TARGET_BLOCKS blocks, within a factor of 2
    assert blocks * nseg >= min(hn.ROW_TARGET_BLOCKS, blocks * tiles) // 2
    assert nseg <= max(1, -(-hn.ROW_TARGET_BLOCKS // blocks))


@pytest.mark.parametrize("n", [131072, 1_048_576])
@pytest.mark.parametrize("dim", [2, 3])
def test_row_scratch_at_131072_and_1m_under_the_budget(n, dim):
    shape = hn.row_scratch(n, n, dim)
    nseg, _ = hn.row_segments(n, n)
    assert shape == (-(-n // hn.ROW_BLOCK_RECEIVERS), nseg,
                     hn.ROW_BLOCK_RECEIVERS, dim)
    assert hn.row_scratch_bytes(n, n, dim) == 4 * math.prod(shape)
    assert hn.row_scratch_bytes(n, n, dim) <= 110_000_000 < \
        hn.SCRATCH_BUDGET


def test_one_segment_needs_no_scratch():
    assert hn.row_segments(5, 5) == (1, 1)
    assert hn.row_scratch(5, 5, 2) is None
    assert hn.row_scratch_bytes(5, 5, 3) == 0


# --------------------------------------------------------------------------
# The wrappers on CPU tensors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("parent", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_row_force_parent_flag_takes_the_plain_version_on_the_cpu(parent,
                                                                  masked):
    pos, m = _inputs(577, 2, seed=1)
    q = _q("int4")
    bounds = hn.kernel_bounds(_t(pos), q, CFG)
    gm = CFG.G * _t(m)
    before = dict(hn.LAUNCHES)
    got = hn.row_force(_t(pos), gm, bounds, q, masked, parent=parent)
    assert hn.LAUNCHES == before
    assert torch.equal(got, hn.row_force_plain(_t(pos), gm, bounds, q,
                                               masked))


@pytest.mark.parametrize("parent", [False, True])
def test_pair_force_parent_flag_takes_the_plain_version_on_the_cpu(parent):
    pos, m = _inputs(517 + 389, 3, seed=2)
    gm = CFG.G * _t(m)
    q = _q("float32")
    got = hn.pair_force(_t(pos[:517]), _t(pos[517:]), gm[517:], q, CFG,
                        parent=parent)
    assert torch.equal(got, hn.pair_force_plain(_t(pos[:517]), _t(pos[517:]),
                                                gm[517:], q, CFG))
    with pytest.raises(ValueError):
        hn.pair_force(_t(pos[:517]), _t(pos[517:]), gm[:5], q, CFG,
                      parent=parent)


# --------------------------------------------------------------------------
# The plain versions against JAX
# --------------------------------------------------------------------------

def _agree(got, want, is_int, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    if is_int:
        off = np.abs(got - want) > 1e-4 * np.abs(want).max()
        assert off.mean() < 0.02, f"{off.mean():.3%} components off"
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _int_bounds(pos, q, soft):
    diff = pos[None, :, :].astype(np.float64) - pos[:, None, :]
    max_d2 = np.float32((diff ** 2).sum(-1).max() + soft)
    lo, hi = tp.dist_sq_log_bounds(q, torch.tensor(max_d2), soft)
    return np.float32(lo), np.float32(hi)


@pytest.mark.parametrize("n_a,n_b", ODD_PAIRS + RAGGED_PAIRS)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_general_pair_plain_matches_jax(n_a, n_b, dim, mode):
    """Unequal masses: the receivers' rows and the sources' reactions of
    the general function, through the wrapper (its plain version on the
    CPU)."""
    import jax.numpy as jnp

    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.ops import precision as jp
    from nbody_tpu.ops.pallas_nbody import pallas_pair_force_sym

    pos, m = _inputs(n_a + n_b, dim, seed=3)
    gm = (CFG.G * m).astype(np.float32)
    qj, qt = jp.Quantizer.from_string(mode), _q(mode)
    lo, hi = (_int_bounds(pos, qt, CFG.softening_sq) if qt.is_int
              else (None, None))
    want_r, want_c = pallas_pair_force_sym(
        jnp.asarray(pos[:n_a]), jnp.asarray(gm[:n_a]),
        jnp.asarray(pos[n_a:]), jnp.asarray(gm[n_a:]), qj, JaxConfig(),
        log_lo=lo, log_hi=hi, interpret=True)
    bounds = hn.kernel_bounds(_t(pos[:n_a]), qt, CFG, None, lo, hi)
    before = dict(hn.LAUNCHES)
    rows, cols = hn.pair_sym_force(_t(pos[:n_a]), _t(gm[:n_a]),
                                   _t(pos[n_a:]), _t(gm[n_a:]), bounds, qt)
    assert hn.LAUNCHES == before
    assert rows.shape == (n_a, dim) and cols.shape == (n_b, dim)
    _agree(rows, want_r, qt.is_int, 2e-5, 1e-6)
    _agree(cols, want_c, qt.is_int, 2e-5, 1e-6)


@pytest.mark.parametrize("n", [577, 1100])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_rows_at_zero_softening_match_jax(n, dim, mode):
    """The self-masked row sweep across a 512-receiver block and ragged
    128-source tiles; particle 0 at the origin stays finite beside JAX's
    padding."""
    import jax.numpy as jnp

    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.ops import precision as jp
    from nbody_tpu.ops.pallas_nbody import pallas_accelerations

    pos, m = _inputs(n, dim, seed=4)
    pos[0] = 0.0
    qj = jp.Quantizer.from_string(mode)
    want = pallas_accelerations(
        jnp.asarray(pos), jnp.asarray(m), qj, JaxConfig(softening=0.0),
        quantize_forces=qj.is_int, block_i=128, block_j=256)
    got = hn.accelerations_rows(_t(pos), _t(m), _q(mode),
                                SimConfig(softening=0.0),
                                quantize_forces=qj.is_int)
    _agree(got, want, qj.is_int, 5e-5, 2e-6)


@pytest.mark.parametrize("n_i,n_j", [(517, 389), (1, 700)])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_pair_force_plain_matches_jax_at_ragged_sizes(n_i, n_j, dim, mode):
    import jax.numpy as jnp

    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.ops import precision as jp
    from nbody_tpu.ops.pallas_nbody import pallas_pair_force

    pos, m = _inputs(n_i + n_j, dim, seed=5)
    gm_j = (0.001 * m[n_i:]).astype(np.float32)
    qj, qt = jp.Quantizer.from_string(mode), _q(mode)
    lo = hi = None
    if qt.is_int:
        lo, hi = _int_bounds(pos, qt, CFG.softening_sq)
    want = pallas_pair_force(jnp.asarray(pos[:n_i]), jnp.asarray(pos[n_i:]),
                             jnp.asarray(gm_j), qj, JaxConfig(), log_lo=lo,
                             log_hi=hi, block_i=128)
    got = hn.pair_force(_t(pos[:n_i]), _t(pos[n_i:]), _t(gm_j), qt, CFG,
                        None if lo is None else torch.tensor(lo),
                        None if hi is None else torch.tensor(hi))
    assert got.shape == (n_i, dim)
    _agree(got, want, qt.is_int, 5e-5, 2e-6)


# --------------------------------------------------------------------------
# On the card: both kernels against their plain versions
# --------------------------------------------------------------------------

RTOL, ATOL = 5e-5, 2e-6   # PERF.md section 2's float rule


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_rule(got, want, q, scale=None):
    """PERF.md section 2: |err| <= ATOL + RTOL max(|a|, s) elementwise
    (s the summed |terms| where given); int8 / int4 after quantize_force at
    most max(4, 1e-4 x components) apart, each by one grid step."""
    assert bool(torch.isfinite(got).all())
    ref = want.abs() if scale is None else torch.maximum(want.abs(), scale)
    assert bool(((got - want).abs() <= ATOL + RTOL * ref).all()), \
        float(((got - want).abs() / (ATOL + RTOL * ref)).max())
    if not q.is_int:
        return
    gq, wq = tp.quantize_force(got, q), tp.quantize_force(want, q)
    step = (want.max() - want.min()) / (q.levels - 1)
    tol = ATOL + RTOL * want.abs().max()
    diff = (gq - wq).abs()
    off = diff > tol
    assert int(off.sum()) <= max(4, math.floor(1e-4 * want.numel()))
    assert bool((diff[off] <= step + tol).all())


def _card_bounds(pos, q, soft, cuda):
    lo, hi = tp.dist_sq_log_bounds(q, hn.max_d2_plain(pos) + soft, soft)
    if not q.is_int:
        lo = hi = lo * 0
    return torch.stack([lo, hi, torch.full((), soft, device=cuda)])


@pytest.mark.gpu
@pytest.mark.parametrize("n_a,n_b", ((16448, 16576), (16576, 16448)))
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_general_one_pass_pair_against_plain(cuda, n_a, n_b, dim, mode):
    pos, m = _inputs(n_a + n_b, dim, seed=6)
    pos = _t(pos).to(cuda)
    gm = (CFG.G * _t(m)).to(cuda)
    q = _q(mode)
    bounds = _card_bounds(pos, q, 0.01, cuda)
    pa, pb, ga, gb = pos[:n_a], pos[n_a:], gm[:n_a], gm[n_a:]
    assert hn.pair_design(n_a, n_b, dim, q) == "one_pass"
    before = dict(hn.LAUNCHES)
    rows, cols = hn.pair_sym_force(pa, ga, pb, gb, bounds, q)
    assert hn.LAUNCHES["pair_sym_force"] == before["pair_sym_force"] + 1
    assert hn.LAUNCHES["pair_sym_force_uniform"] == \
        before["pair_sym_force_uniform"]
    rw, cw = hn.pair_sym_force_plain(pa, ga, pb, gb, bounds, q)
    _card_rule(rows, rw, q)
    _card_rule(cols, cw, q)
    for got, want in zip(hn.pair_sym_force(pa, ga, pb, gb, bounds, q,
                                           parent=True), (rw, cw)):
        _card_rule(got, want, q)
    for _ in range(20):
        r, c = hn.pair_sym_force(pa, ga, pb, gb, bounds, q)
        assert torch.equal(r, rows) and torch.equal(c, cols)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [577, 32832])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
@pytest.mark.parametrize("soft,masked", [(0.01, False), (0.0, True)])
def test_tiled_row_force_against_plain(cuda, n, dim, mode, soft, masked):
    pos, m = _inputs(n, dim, seed=7)
    pos = _t(pos).to(cuda)
    gm = (CFG.G * _t(m)).to(cuda)
    q = _q(mode)
    bounds = _card_bounds(pos, q, soft, cuda)
    before = hn.LAUNCHES["row_force"]
    got = hn.row_force(pos, gm, bounds, q, masked)
    assert hn.LAUNCHES["row_force"] == before + 1
    want = hn.row_force_plain(pos, gm, bounds, q, masked)
    scale = hn.sym_force_term_scale(pos, gm, bounds, q, masked)
    _card_rule(got, want, q, scale)
    _card_rule(hn.row_force(pos, gm, bounds, q, masked, parent=True), want,
               q, scale)
    assert all(torch.equal(hn.row_force(pos, gm, bounds, q, masked), got)
               for _ in range(20))


@pytest.mark.gpu
@pytest.mark.parametrize("n_i,n_j", [(517, 389), (1, 700), (32832, 32771)])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_tiled_pair_force_against_plain(cuda, n_i, n_j, dim, mode):
    pos, m = _inputs(n_i + n_j, dim, seed=8)
    pos = _t(pos).to(cuda)
    gm = (CFG.G * _t(m)).to(cuda)
    q = _q(mode)
    bounds = _card_bounds(pos, q, CFG.softening_sq, cuda)
    lo, hi = (bounds[0], bounds[1]) if q.is_int else (None, None)
    xi, xj, gm_j = pos[:n_i], pos[n_i:], gm[n_i:]
    before = hn.LAUNCHES["pair_force"]
    got = hn.pair_force(xi, xj, gm_j, q, CFG, lo, hi)
    assert hn.LAUNCHES["pair_force"] == before + 1
    want = hn.pair_force_plain(xi, xj, gm_j, q, CFG, lo, hi)
    scale = hn.pair_force_term_scale(xi, xj, gm_j, bounds, q)
    _card_rule(got, want, q, scale)
    _card_rule(hn.pair_force(xi, xj, gm_j, q, CFG, lo, hi, parent=True), want,
               q, scale)
    assert all(torch.equal(hn.pair_force(xi, xj, gm_j, q, CFG, lo, hi), got)
               for _ in range(20))
