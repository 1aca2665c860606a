"""The equal-mass sym kernels' one-pass design, and the rule that picks it.

sym_force_uniform and pair_sym_force_uniform run one of two designs on the
card, a fixed function of T in the wrapper (``uniform_design``), the same
in every mode and D: the one-pass design (csrc/one_pass.cuh: t = w diff
formed once, added into the rows and the reactions in the same iteration,
256 receivers a block) past ``ONE_PASS_MIN_TILES``, else the two-pass
tile. The general kernels and the fused max follow the same rule
(tests/test_torch_redesign_sym_general_max.py); the skip and count flags
and the T <= 256 triangle keep their routes.

On the CPU these tests hold the rule, the routes, the wrappers' arguments,
the scratch reckoning (``sym_force_scratch_bytes`` and
``pair_sym_force_scratch_bytes`` bound either design's allocation, and the
1M chunking stays 5 x 209728 at D=2 and 6 x 174784 at D=3), and the plain
versions (which the wrappers take for CPU tensors) at odd multiples of 64
against ``pallas_accelerations_sym(uniform_gm=True)`` and
``pallas_pair_force_sym(uniform_gm=True)`` in Pallas interpret mode, with
the tolerances of tests/test_torch_uniform.py (float rtol 2e-5, atol 1e-6;
int modes after quantize_force the flip rule; the raw int pair tile <2% of
components off by >1e-4 max|a|). The int chain's per-launch table
(``ops/int_table.py``, ``hopper_nbody.int_chain_design``): its plain model
against ``_pair_weight`` float by float around every edge and on strided
sweeps, and the route a function of the level count alone. The ``gpu``
tests hold the one-pass kernels against their plain versions at those odd
shapes and at ragged 256-receiver tails, bitwise run to run over 100
launches, the card's table against the chain on every float of its range
(the int4 disk's grids, random grids, every level count the route sends
to tables), and its fallback under stale bounds; they skip without a card:

    python -m pytest --noconftest -q -m gpu tests/test_torch_sym_uniform.py
"""

import math

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import int_table as it
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

CFG = SimConfig()
ODD_NS = (192, 320, 448)       # 3, 5 and 7 tiles of 64: ragged 256-tails
PAIR_SHAPES = ((192, 320), (320, 192))
FAMILIES = {"float32": "float", "bf16": "float", "f16": "float",
            "int8": "int", "int4": "int", "custom": "int"}


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


def _q(mode):
    return tp.Quantizer.from_string(mode)


# --------------------------------------------------------------------------
# The rule and the routes (pure functions)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [1, 64, 256, 257, 512, 2048, 2731, 3277])
@pytest.mark.parametrize("mode", list(FAMILIES))
@pytest.mark.parametrize("dim", [2, 3])
def test_uniform_design_is_a_function_of_tiles_mode_and_dim(tiles, mode,
                                                             dim):
    want = "one_pass" if tiles > hn.ONE_PASS_MIN_TILES else "two_pass"
    assert hn.uniform_design(tiles, _q(mode), dim) == want
    # every N with the same T takes the same design
    for n in (tiles * hn.TILE, (tiles - 1) * hn.TILE + 64):
        assert hn.sym_design(n, dim, _q(mode)) == (
            "one_pass" if want == "one_pass" else hn.sym_schedule(n))


def test_the_rule_edge_is_the_triangles():
    """sym_force_uniform keeps the triangle up to 256 tiles and takes
    the one-pass design beyond."""
    assert hn.ONE_PASS_MIN_TILES == hn.TRIANGLE_MAX_TILES
    edge = hn.TRIANGLE_MAX_TILES * hn.TILE
    q = _q("float32")
    assert hn.sym_design(edge, 2, q) == "triangle"
    assert hn.sym_design(edge + hn.TILE, 2, q) == "one_pass"


@pytest.mark.parametrize("n", [131072, 209728, 174784])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_flagged_general_and_parent_launches_keep_their_routes(n, mode):
    q = _q(mode)
    for dim in (2, 3):
        routed = hn.uniform_design(-(-n // hn.TILE), q, dim)
        # the general kernel follows the equal-mass rule (the one-pass body
        # with G m per particle); the skip / count flags take the T x T
        # grid of the two-pass tile, whatever the rule says
        assert hn.sym_design(n, dim, q) == (
            "one_pass" if routed == "one_pass" else "square")
        assert hn.sym_design(n, dim, q, flagged=True) == \
            "square"
        # off the tile: the T x T grid of the two-pass tile
        assert hn.sym_design(n + 1, dim, q) == "square"
        # the general pair tile follows the same rule as the equal-mass one
        # (its one-pass body carries G m per particle)
        assert hn.pair_design(n, n, dim, q) == routed
        assert hn.pair_design(n, n + 1, dim, q) == "two_pass"
        assert hn.pair_design(n + 1, n, dim, q) == "two_pass"
        # the fused max alone follows the rule too; with skip it does not
        assert hn.sym_design(n, dim, q, fused_max=True) == (
            "one_pass" if routed == "one_pass" else "square")
        assert hn.sym_design(n, dim, q, flagged=True, fused_max=True) == \
            "square"
        assert hn.pair_design(n, 64, dim, q) == routed


@pytest.mark.parametrize("n", [64, 5000, 16384])
def test_small_n_keeps_the_triangle_and_the_two_pass_pair(n):
    for mode in ("float32", "int4"):
        for dim in (2, 3):
            assert hn.sym_design(n, dim, _q(mode)) == "triangle"
            assert hn.pair_design(n - n % 64 or 64, 4096, dim,
                                  _q(mode)) == "two_pass"


# --------------------------------------------------------------------------
# Scratch reckoning
# --------------------------------------------------------------------------

def _bytes(shapes):
    return sum(4 * math.prod(s) for s in shapes)


@pytest.mark.parametrize("tiles", [257, 258, 259, 260, 511, 2048, 2731, 3277,
                                   5575])
@pytest.mark.parametrize("dim", [2, 3])
def test_sym_scratch_bytes_bound_both_designs(tiles, dim):
    """sym_force_scratch_bytes still reckons the two-pass design's (T, T,
    64, D) and bounds the one-pass design's wherever the rule routes there
    (T > ONE_PASS_MIN_TILES)."""
    n = tiles * hn.TILE
    reckoned = hn.sym_force_scratch_bytes(n, dim)
    assert reckoned == 4 * dim * tiles * tiles * hn.TILE
    one = _bytes(hn.sym_one_pass_scratch(n, dim))
    assert one <= reckoned
    rows, cols = hn.sym_one_pass_scratch(n, dim)
    assert rows[2] == hn.ONE_PASS_RECEIVERS and cols[1] == rows[0]
    assert rows[0] * hn.ONE_PASS_RECEIVERS >= n


@pytest.mark.parametrize("ta", [257, 259, 512, 2731, 3277])
@pytest.mark.parametrize("tb", [1, 2, 31, 257, 512, 2731, 3277, 8192])
@pytest.mark.parametrize("dim", [2, 3])
def test_pair_scratch_bytes_bound_both_designs(ta, tb, dim):
    """pair_sym_force_scratch_bytes reckons the two-pass design and bounds
    the one-pass design's allocation wherever the rule routes there (more
    than ONE_PASS_MIN_TILES receiver tiles), thin source sets included."""
    n_a, n_b = ta * hn.TILE, tb * hn.TILE
    reckoned = hn.pair_sym_force_scratch_bytes(n_a, n_b, dim)
    nseg = -(-tb // hn.PAIR_SEGMENT_TILES)
    assert reckoned == 4 * dim * hn.TILE * (ta * nseg + tb * ta)
    assert _bytes(hn.pair_one_pass_scratch(n_a, n_b, dim)) <= reckoned


@pytest.mark.parametrize("dim,chunk", [(2, 209728), (3, 174784)])
def test_the_1m_chunking_stays_as_it_was(dim, chunk):
    """The chunk rule reckons the two-pass scratch, so the 1M path keeps 5
    chunks of 209728 at D=2 and 6 of 174784 at D=3 (launch counts of
    PERF.md section 2: 5 + 10 and 6 + 15)."""
    assert hn.sym_chunk_size(1_048_576, dim) == chunk
    assert chunk % hn.TILE == 0
    chunks = -(-1_048_576 // chunk)
    assert chunks == {2: 5, 3: 6}[dim]
    # every chunk, the shorter last one included, is a multiple of TILE
    # and takes the equal-mass variant in the rule's design
    last = 1_048_576 - (chunks - 1) * chunk
    assert last % hn.TILE == 0
    for n in (chunk, last):
        assert hn.sym_design(n, dim, _q("float32")) == "one_pass"


# --------------------------------------------------------------------------
# The wrappers' arguments
# --------------------------------------------------------------------------

def _pair_inputs(n_a, n_b, dim, mode):
    pos, m = _inputs(n_a + n_b, dim, seed=5)
    gm = CFG.G * _t(m)
    q = _q(mode)
    bounds = hn.kernel_bounds(_t(pos), q, CFG)
    return _t(pos[:n_a]), gm[:n_a], _t(pos[n_a:]), gm[n_a:], bounds, q


def test_pair_keeps_the_argument_checks():
    pa, ga, pb, gb, bounds, q = _pair_inputs(192, 320, 2, "int4")
    with pytest.raises(TypeError):
        hn.pair_sym_force(pa.double(), ga, pb, gb, bounds, q, uniform=True)
    with pytest.raises(ValueError):
        hn.pair_sym_force(pa, ga, pb[:, :1].contiguous(), gb, bounds, q,
                          uniform=True)
    with pytest.raises(ValueError):
        hn.pair_sym_force(pa, ga, pb, gb[:5], bounds, q, uniform=True)
    with pytest.raises(ValueError):
        hn.pair_sym_force(pa, ga, pb, gb, bounds[:2], q, uniform=True)


@pytest.mark.parametrize("uniform", [False, True])
def test_pair_takes_the_plain_version_on_the_cpu(uniform):
    pa, ga, pb, gb, bounds, q = _pair_inputs(192, 320, 3, "float32")
    got = hn.pair_sym_force(pa, ga, pb, gb, bounds, q, uniform=uniform)
    plain = (hn.pair_sym_force_uniform_plain if uniform
             else hn.pair_sym_force_plain)
    want = plain(pa, ga, pb, gb, bounds, q)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------------------
# The plain versions against JAX at odd multiples of 64
# --------------------------------------------------------------------------

def hold(got, want, mode, rtol=2e-5, atol=1e-6):
    """tests/test_torch_uniform.py's rule: the float tolerance, or for the
    int modes the flip rule after quantize_force (both sides quantized)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    q = _q(mode)
    if not q.is_int:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        return
    step = (want.max() - want.min()) / (q.levels - 1)
    tol = atol + rtol * np.abs(want).max()
    diff = np.abs(got - want)
    off = diff > tol
    assert off.sum() <= max(4, int(1e-4 * want.size)), off.sum()
    assert (diff[off] <= step + tol).all()


def _int_bounds(pos, q):
    diff = pos[None, :, :].astype(np.float64) - pos[:, None, :]
    max_d2 = np.float32((diff ** 2).sum(-1).max() + CFG.softening_sq)
    lo, hi = tp.dist_sq_log_bounds(q, torch.tensor(max_d2), CFG.softening_sq)
    return np.float32(lo), np.float32(hi)


@pytest.mark.parametrize("n", ODD_NS)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_sym_uniform_plain_matches_jax_at_odd_multiples_of_64(n, dim, mode):
    import jax.numpy as jnp

    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.ops import precision as jp
    from nbody_tpu.ops.pallas_nbody import pallas_accelerations_sym

    pos, m = _inputs(n, dim, seed=2)
    qj, qt = jp.Quantizer.from_string(mode), _q(mode)
    want = pallas_accelerations_sym(jnp.asarray(pos), jnp.asarray(m), qj,
                                    JaxConfig(), quantize_forces=qt.is_int,
                                    uniform_gm=True, interpret=True)
    got = hn.sym_accelerations(_t(pos), _t(m), qt, CFG,
                               quantize_forces=qt.is_int, uniform_gm=True)
    hold(got.numpy(), want, mode)
    # the wrapper took the variant's plain version (n is on the tile)
    bounds = hn.kernel_bounds(_t(pos), qt, CFG)
    gm = CFG.G * _t(m)
    assert torch.equal(
        hn.sym_force(_t(pos), gm, bounds, qt, False, uniform=True),
        hn.sym_force_uniform_plain(_t(pos), gm, bounds, qt, False))


@pytest.mark.parametrize("n_a,n_b", PAIR_SHAPES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_pair_uniform_plain_matches_jax_at_odd_multiples_of_64(n_a, n_b, dim,
                                                              mode):
    import jax.numpy as jnp

    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.ops import precision as jp
    from nbody_tpu.ops.pallas_nbody import pallas_pair_force_sym

    pos, m = _inputs(n_a + n_b, dim, seed=3)
    gm = (CFG.G * m).astype(np.float32)
    qj, qt = jp.Quantizer.from_string(mode), _q(mode)
    lo, hi = _int_bounds(pos, qt) if qt.is_int else (None, None)
    want_r, want_c = pallas_pair_force_sym(
        jnp.asarray(pos[:n_a]), jnp.asarray(gm[:n_a]),
        jnp.asarray(pos[n_a:]), jnp.asarray(gm[n_a:]), qj, JaxConfig(),
        log_lo=lo, log_hi=hi, uniform_gm=True, interpret=True)
    bounds = hn.kernel_bounds(_t(pos[:n_a]), qt, CFG, None, lo, hi)
    rows, cols = hn.pair_sym_force(_t(pos[:n_a]), _t(gm[:n_a]),
                                   _t(pos[n_a:]), _t(gm[n_a:]), bounds, qt,
                                   uniform=True)
    for got, want in ((rows, want_r), (cols, want_c)):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        if qt.is_int:
            off = np.abs(got - want) > 1e-4 * np.abs(want).max()
            assert off.mean() < 0.02
        else:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


# --------------------------------------------------------------------------
# The int chain's table: its plain model and its route
# --------------------------------------------------------------------------

# (levels, log span, eps^2, offset of log_lo from log(lo)): the int4 disk's
# span, narrower and wider ones, a softening above min_d2, a grid whose
# log_lo is not log(lo) (k0 != 0), the custom and int8 level counts.
TABLE_GRIDS = ((16, 12.8, 0.01, 0.0), (16, 2.0, 0.01, 0.0),
               (16, 30.0, 0.25, 0.0), (16, 9.0, 0.001, -1.3),
               (64, 11.0, 0.01, 0.0), (256, 12.8, 0.01, 0.0),
               (2, 5.0, 0.01, 0.7), (100, 0.5, 0.01, 0.0))


def _table_grid(levels, span, soft, offset):
    q = tp.Quantizer(tp.Precision.CUSTOM, custom_levels=levels)
    lo = math.log(max(soft, q.min_dist_sq)) + offset
    return q, torch.tensor([lo, lo + span, soft], dtype=torch.float32)


def _sweep_floats(table, step):
    """Every float within 512 bit patterns of each kept edge, and every
    step-th float from lo to twice the table's end."""
    edges = it._bits(table.edge[:table.m])
    near = (edges[:, None] + torch.arange(-512, 513)[None, :]).flatten()
    lo = int(it._bits(table.lo))
    hi = int(it._bits(torch.tensor(min(2 * table.end, 3e38))))
    u = torch.cat([near, torch.arange(lo, hi, step)])
    u = u[(u >= lo) & (u < 0x7F800000)]
    return it._floats(u)


@pytest.mark.parametrize("grid", TABLE_GRIDS)
def test_int_table_model_matches_the_chain(grid):
    """The plain build's k and w equal _pair_weight's chain, bit for bit,
    on every float it covers; NaN (the chain's block) past its end."""
    q, bounds = _table_grid(*grid)
    table = it.table_plain(bounds, q)
    assert table.m >= min(q.levels, 8)
    chain = hn._int_grid(bounds, q)
    x = _sweep_floats(table, 4099)
    k, w = it.lookup_plain(x, table, q)
    inside = (x >= table.lo) & (x < table.end)
    assert bool(inside.any()) and bool((~inside).any())
    assert bool(torch.isnan(w[~inside]).all())
    want_k = hn._chain_k(torch.clamp(x, min=q.min_dist_sq), chain)
    want_w = hn._pair_weight(x, q, chain)
    assert torch.equal(k[inside], want_k[inside])
    assert torch.equal(w[inside].view(torch.int32),
                       want_w[inside].view(torch.int32))


@pytest.mark.parametrize("grid", TABLE_GRIDS)
def test_int_table_edges_are_the_least_floats_of_each_index(grid):
    """e_j is the least float at which the chain's k reaches k0 + j: k
    there is k0 + j and one float below it k0 + j - 1; the kept edges are
    strictly increasing and each lies in a bucket of its own."""
    q, bounds = _table_grid(*grid)
    table = it.table_plain(bounds, q)
    chain = hn._int_grid(bounds, q)
    kept = table.edge[:table.m]
    below = it._floats(it._bits(kept) - 1)
    j = torch.arange(1, table.m + 1, dtype=torch.float32)
    assert torch.equal(hn._chain_k(kept, chain), table.k0 + j)
    assert torch.equal(hn._chain_k(torch.clamp(below, min=q.min_dist_sq),
                                   chain), table.k0 + j - 1)
    buckets = it._bits(kept) >> table.shift
    assert bool((buckets[1:] > buckets[:-1]).all())
    assert int(buckets[-1]) - table.base < it.buckets(q.levels)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("grid", TABLE_GRIDS[:4])
def test_offsets_land_on_the_table_edges(grid, dim):
    """The fuzz's on-edge pairs: an offset from the origin whose softened
    d^2, formed as the kernels form it, is a kept edge (the chain's k
    steps there) or the float below it; most edges are reached."""
    q, bounds = _table_grid(*grid)
    soft = float(bounds[2])
    edges = it.edges_of(bounds, q)
    below = it._floats(it._bits(edges) - 1)
    targets = torch.cat([edges, below]).numpy()
    offsets, hit = it.offsets_on(targets, soft, dim)
    assert len(hit) >= 0.75 * len(targets)
    o = torch.from_numpy(offsets)
    d2 = o[:, 0] * o[:, 0]
    for d in range(1, dim):
        d2 = d2 + o[:, d] * o[:, d]
    x = d2 + torch.tensor(soft)
    assert torch.equal(x, torch.tensor(hit, dtype=torch.float32))
    k = hn._chain_k(torch.clamp(x, min=q.min_dist_sq), hn._int_grid(bounds,
                                                                     q))
    on_edge = torch.isin(x, edges)
    k0 = it.table_plain(bounds, q).k0
    want = k0 + torch.searchsorted(edges, x, right=True).to(torch.float32)
    assert bool(on_edge.any()) and bool((~on_edge).any())
    assert torch.equal(k, want)


@pytest.mark.parametrize("levels", [1, 2, 16, 64, 255, 256, 257, 4096])
@pytest.mark.parametrize("mode", ["int8", "int4", "custom", "float32",
                                  "bf16", "f16"])
def test_int_chain_design_depends_only_on_levels(levels, mode):
    """Table or chain is a function of the level count alone: every int
    mode with that many levels takes int_chain_design(levels)'s route,
    with the device counter; the float modes pass neither."""
    q = tp.Quantizer.from_string(mode, custom_levels=levels)
    want = "table" if 1 <= levels <= hn.INT_TABLE_MAX_LEVELS else "chain"
    assert hn.int_chain_design(levels) == want
    flag, counter = hn._one_pass_int_args(q, torch.device("cpu"))
    if q.is_int:
        assert (flag == 1) == (hn.int_chain_design(q.levels) == "table")
        assert (counter is None) == (flag == 0)
    else:
        assert (flag, counter) == (0, None)


def test_int_table_fits_every_routed_level_count():
    """A table of every level count the route sends there fits the dynamic
    shared memory a launch takes without an opt-in, as one_pass.cuh's
    op_table_bytes reckons it."""
    for levels in (1, 16, 64, hn.INT_TABLE_MAX_LEVELS):
        edges = levels + hn.INT_TABLE_SLACK
        assert hn.int_table_bytes(levels) == (
            it.buckets(levels) * 16 + (2 * edges + 1) * 4)
        assert hn.int_table_bytes(levels) <= 48 * 1024


# --------------------------------------------------------------------------
# On the card: the one-pass kernels against their plain versions
# --------------------------------------------------------------------------

RTOL, ATOL = 5e-5, 2e-6   # PERF.md section 2's float rule


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_rule(got, want, q):
    """PERF.md section 2: |err| <= ATOL + RTOL max|a| elementwise; int8 /
    int4 after quantize_force at most max(4, 1e-4 x components) apart, each
    by one grid step."""
    assert bool(torch.isfinite(got).all())
    tol = ATOL + RTOL * want.abs()
    if not q.is_int:
        assert bool(((got - want).abs() <= tol).all()), \
            float(((got - want).abs() / tol).max())
        return
    gq, wq = tp.quantize_force(got, q), tp.quantize_force(want, q)
    step = (want.max() - want.min()) / (q.levels - 1)
    diff = (gq - wq).abs()
    off = diff > ATOL + RTOL * want.abs().max()
    assert int(off.sum()) <= max(4, math.floor(1e-4 * want.numel()))
    assert bool((diff[off] <= step + ATOL + RTOL * want.abs().max()).all())


def _card_inputs(n, dim, mode, cuda, soft=0.01):
    pos, m = _inputs(n, dim, seed=11)
    pos = _t(pos).to(cuda)
    gm = (CFG.G * _t(m)).to(cuda)
    q = _q(mode)
    lo, hi = tp.dist_sq_log_bounds(q, hn.max_d2_plain(pos) + soft, soft)
    if not q.is_int:
        lo = hi = lo * 0
    return pos, gm, torch.stack([lo, hi, torch.full((), soft,
                                                    device=cuda)]), q


@pytest.mark.gpu
@pytest.mark.parametrize("n", ODD_NS + (16448, 16576))
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_one_pass_sym_against_plain(cuda, monkeypatch, n, dim, mode):
    """At the odd multiples of 64 (the rule's edge lowered to 0 so that
    the one-pass design serves them) and at 257 and 259 tiles (ragged
    256-receiver tails under the real rule), softening 0.1 and 0."""
    if n in ODD_NS:
        monkeypatch.setattr(hn, "ONE_PASS_MIN_TILES", 0)
    for soft, masked in ((0.01, False), (0.0, True)):
        pos, gm, bounds, q = _card_inputs(n, dim, mode, cuda, soft)
        assert hn.sym_design(n, dim, q) == "one_pass"
        before = hn.LAUNCHES["sym_force_uniform"]
        got = hn.sym_force(pos, gm, bounds, q, masked, uniform=True)
        assert hn.LAUNCHES["sym_force_uniform"] == before + 1
        want = hn.sym_force_uniform_plain(pos, gm, bounds, q, masked)
        if masked:   # cancelling terms: the summed |terms| scale
            scale = hn.sym_force_term_scale(pos, gm, bounds, q, masked)
            tol = ATOL + RTOL * torch.maximum(want.abs(), scale)
            assert bool(((got - want).abs() <= tol).all())
        else:
            _card_rule(got, want, q)


@pytest.mark.gpu
@pytest.mark.parametrize("n_a,n_b", PAIR_SHAPES + ((16448, 320),
                                                   (16576, 16448)))
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_one_pass_pair_against_plain(cuda, monkeypatch, n_a, n_b, dim, mode):
    if n_a in ODD_NS:
        monkeypatch.setattr(hn, "ONE_PASS_MIN_TILES", 0)
    pos, gm, bounds, q = _card_inputs(n_a + n_b, dim, mode, cuda)
    pa, pb, ga, gb = pos[:n_a], pos[n_a:], gm[:n_a], gm[n_a:]
    assert hn.pair_design(n_a, n_b, dim, q) == "one_pass"
    rows, cols = hn.pair_sym_force(pa, ga, pb, gb, bounds, q, uniform=True)
    rw, cw = hn.pair_sym_force_uniform_plain(pa, ga, pb, gb, bounds, q)
    _card_rule(rows, rw, q)
    _card_rule(cols, cw, q)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_one_pass_bitwise_over_100_launches(cuda, mode):
    pos, gm, bounds, q = _card_inputs(16448 + 320, 2, mode, cuda)
    p1, g1 = pos[:16448], gm[:16448]
    first = hn.sym_force(p1, g1, bounds, q, False, uniform=True)
    assert all(torch.equal(hn.sym_force(p1, g1, bounds, q, False,
                                        uniform=True), first)
               for _ in range(100))
    r0, c0 = hn.pair_sym_force(p1, g1, pos[16448:], gm[16448:], bounds, q,
                               uniform=True)
    for _ in range(100):
        r, c = hn.pair_sym_force(p1, g1, pos[16448:], gm[16448:], bounds, q,
                                 uniform=True)
        assert torch.equal(r, r0) and torch.equal(c, c0)


def _card_sweep(bounds, q):
    """The card's table against the chain on every float from lo to twice
    its end (to the largest float): 0 mismatches, and the floats past its
    end taken by the chain."""
    meta = it.sweep(bounds, q, 0, 1)
    lo = max(float(bounds[2]), q.min_dist_sq)
    u_lo = int(it._bits(torch.tensor(lo)))
    end = float(meta["edge"][meta["m"] - 1]) if meta["m"] else lo
    u_end = int(it._bits(torch.tensor(end)))
    u_hi = min(int(it._bits(torch.tensor(min(2 * end, 3.4e38)))),
               0x7F7FFFFF)
    got = it.sweep(bounds, q, u_lo, u_hi - u_lo + 1)
    assert got["mismatches"] == 0, (bounds.tolist(), q.levels, got["first"])
    assert got["outside"] == u_hi - min(u_end, u_hi + 1) + 1
    return got


@pytest.mark.gpu
def test_int_table_exhaustive_on_the_card(cuda):
    """On every float of its range the table built on the card gives the
    accurate chain's weight bit for bit: the int4 disk's grids at its ICs
    and after each of ticks 1-100, 50 seeded random grids, and each level
    count the route sends to tables (on the disk's IC grid)."""
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy

    q4 = _q("int4")
    p0, v0, m0 = create_disk_galaxy(torch.Generator().manual_seed(42),
                                    num_stars=131072, device=cuda)
    sim = DirectSimulation(p0, v0, m0, precision="int4", device=cuda)
    grids = [hn.kernel_bounds(sim.positions.contiguous(), q4, CFG)]
    for _ in range(100):
        sim.step(1)
        grids.append(hn.kernel_bounds(sim.positions.contiguous(), q4, CFG))
    for bounds in grids:
        assert _card_sweep(bounds, q4)["m"] == q4.levels + hn.INT_TABLE_SLACK
    rng = np.random.default_rng(20261018)
    for _ in range(50):
        lo = math.log(0.01) + rng.uniform(-2.0, 1.0)
        bounds = torch.tensor([lo, lo + rng.uniform(0.5, 25.0),
                               rng.choice([0.0, 0.01, 0.25])],
                              dtype=torch.float32, device=cuda)
        _card_sweep(bounds, q4)
    for levels in range(1, hn.INT_TABLE_MAX_LEVELS + 1):
        q = tp.Quantizer(tp.Precision.CUSTOM, custom_levels=levels)
        assert hn.int_chain_design(levels) == "table"
        _card_sweep(grids[0], q)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int4", "custom", "int8"])
def test_int_table_falls_back_under_stale_bounds(cuda, monkeypatch, mode):
    """The one-pass body with the table equals the chain's route bit for
    bit: under the exact grid, with no block on the chain up to 64 levels
    (int8's 8 slack bins span less than the bounding boxes' factor of up to
    2 in d^2 over a block's largest pair), and under the grid of a cloud
    100 times smaller (pairs past the table's end) with blocks counted in
    INT_CHAIN_FALLBACKS; sym_force and pair_sym_force."""
    n = 16448
    pos, gm, exact, q = _card_inputs(n + 320, 2, mode, cuda)
    stale = hn.kernel_bounds(pos * 0.01, q, CFG)
    runs = {}
    for route in ("table", "chain"):
        if route == "chain":
            monkeypatch.setattr(hn, "INT_TABLE_MAX_LEVELS", 0)
        for label, bounds in (("exact", exact), ("stale", stale)):
            hn.INT_CHAIN_FALLBACKS.clear()
            out = (hn.sym_force(pos[:n], gm[:n], bounds, q, False,
                                uniform=True),
                   *hn.pair_sym_force(pos[:n], gm[:n], pos[n:], gm[n:],
                                      bounds, q, uniform=True))
            runs[route, label] = (out, hn.int_chain_fallbacks(pos.device))
    for label in ("exact", "stale"):
        (table, fell), (chain, none) = runs["table", label], runs[
            "chain", label]
        assert all(torch.equal(a, b) for a, b in zip(table, chain)), label
        assert none == 0
        if label == "stale":
            assert fell > 0
        elif q.levels <= 64:
            assert fell == 0
