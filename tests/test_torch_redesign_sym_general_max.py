"""The general sym_force and the fused max on the one-pass body past 256
tiles, pair_max as one register-tiled launch, and the rules that route them.

``sym_force`` over a multiple of TILE past ``ONE_PASS_MIN_TILES`` tiles,
for the (mode family, D) in ``ONE_PASS_ROUTES``, takes the one-pass design
(csrc/one_pass.cuh) whatever its masses (G m per particle for unequal
ones) and with or without the fused max (``max_out``); launches with a
skip or count flag (the cached redo), ``parent=True``, ragged N and the
fused max at T <= 256 keep the T x T grid of the two-pass tile, and
unflagged launches at T <= 256 the triangle (``sym_design``). ``pair_max``
runs one register-tiled launch over ``pair_max_segments``' grid;
``parent=True`` reaches the earlier two launches.

On the CPU these tests hold the rules, the wrappers' flags on CPU tensors
(the plain versions), and the plain versions against the JAX package in
Pallas interpret mode: ``sym_force_plain`` with unequal masses against
``pallas_accelerations_sym`` at odd multiples of 64 (float rtol 2e-5, atol
1e-6; int4 after quantize_force the flip rule of
tests/test_torch_sym_uniform.py); the fused max
(``sym_accelerations(emit_max=True)``) against JAX's ``emit_max``, its max
bitwise the port's max pass and within one ulp of JAX's (XLA:CPU contracts
d^2 into an FMA, ROADMAP Queue 3), its forces bitwise those without it;
``pair_max_plain`` against ``pallas_pair_max`` with the ring's tail
phantoms, scattered phantoms and no valid pair, each max bitwise or within
that one ulp (0 exactly where no pair is valid). The ``gpu`` cases of
tests/test_torch_kernels.py hold the kernels themselves on the card.

    python -m pytest -q tests/test_torch_redesign_sym_general_max.py
"""

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
TILES = (1, 256, 257, 2731, 3277)
ODD_NS = (192, 320, 448)       # 3, 5 and 7 tiles of 64: ragged 256-tails


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
# The routes (pure functions)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("mode", list(FAMILIES))
@pytest.mark.parametrize("dim", [2, 3])
def test_general_and_fused_launches_follow_the_one_pass_rule(tiles, mode,
                                                             dim):
    """With or without the fused max (either kind of masses: the rule does
    not take the kind): the one-pass body wherever uniform_design routes
    the tiles; else the triangle for an unflagged launch and the T x T
    grid for the fused max."""
    q, n = _q(mode), tiles * hn.TILE
    routed = hn.uniform_design(tiles, q, dim) == "one_pass"
    assert routed == (tiles > hn.ONE_PASS_MIN_TILES
                      and (FAMILIES[mode], dim) in hn.ONE_PASS_ROUTES)
    assert hn.sym_design(n, dim, q) == (
        "one_pass" if routed else hn.sym_schedule(n))
    assert hn.sym_design(n, dim, q, fused_max=True) == (
        "one_pass" if routed else "square")


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("mode", list(FAMILIES))
@pytest.mark.parametrize("dim", [2, 3])
def test_skip_count_parent_and_ragged_keep_the_two_pass_tile(tiles, mode,
                                                             dim):
    """The cached redo's skip / count flags and parent=True take the T x T
    grid whatever the rule says; ragged N keeps the earlier routes."""
    q, n = _q(mode), tiles * hn.TILE
    for fused in (False, True):
        assert hn.sym_design(n, dim, q, flagged=True,
                             fused_max=fused) == "square"
        assert hn.sym_design(n, dim, q, parent=True,
                             fused_max=fused) == "square"
        assert hn.sym_design(n + 1, dim, q, fused_max=fused) == (
            "square" if fused else hn.sym_schedule(n + 1))


@pytest.mark.parametrize("routes", [frozenset(),
                                    frozenset({("float", 2)}),
                                    frozenset({("int", 3)})])
def test_general_and_fused_routes_follow_one_pass_routes(monkeypatch,
                                                         routes):
    monkeypatch.setattr(hn, "ONE_PASS_ROUTES", routes)
    n = 2731 * hn.TILE
    for mode, family in FAMILIES.items():
        for dim in (2, 3):
            routed = (family, dim) in routes
            assert hn.sym_design(n, dim, _q(mode)) == (
                "one_pass" if routed else "square")
            assert hn.sym_design(n, dim, _q(mode), fused_max=True) == (
                "one_pass" if routed else "square")


def test_the_fused_max_at_256_tiles_stays_on_the_t_by_t_grid():
    """The cached 5000 run's and the triangle's edge: the fused max keeps
    the T x T grid up to 256 tiles, the unflagged launch the triangle."""
    edge = hn.TRIANGLE_MAX_TILES * hn.TILE
    for mode in ("int8", "int4", "custom"):
        for dim in (2, 3):
            for n in (5000, edge):
                assert hn.sym_design(n, dim, _q(mode), fused_max=True) == \
                    "square"
                assert hn.sym_design(n, dim, _q(mode)) == "triangle"


@pytest.mark.parametrize("dim,chunk", [(2, 209728), (3, 174784)])
def test_the_1m_chunks_take_the_general_one_pass_body(dim, chunk):
    """The chunk rule reckons the two-pass scratch (an upper bound of the
    one-pass body's), so the 1M path keeps 5 chunks of 209728 at D=2 and 6
    of 174784 at D=3, and every chunk's general sym_force goes one-pass."""
    assert hn.sym_chunk_size(1_048_576, dim) == chunk
    assert hn.sym_force_scratch_bytes(chunk, dim) >= sum(
        4 * int(np.prod(s)) for s in hn.sym_one_pass_scratch(chunk, dim))
    chunks = -(-1_048_576 // chunk)
    for n in (chunk, 1_048_576 - (chunks - 1) * chunk):
        for mode in ("float32", "int4"):
            assert hn.sym_design(n, dim, _q(mode)) == "one_pass"


# --------------------------------------------------------------------------
# pair_max's grid rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_i,n_j,want", [
    (131072, 131072, (64, 16)),   # the --mesh path on one card
    (32769, 32769, (129, 2)),     # a shard of 131075 over S=4
    (1, 1000, (8, 1)), (5000, 5000, (40, 1))])
def test_pair_max_segments_at_the_paths_shapes(n_i, n_j, want):
    assert hn.pair_max_segments(n_i, n_j) == want


@pytest.mark.parametrize("n_i,n_j", [(1, 1), (512, 128), (513, 129),
                                     (4099, 1009), (32769, 32769),
                                     (131072, 131072), (262144, 131075)])
def test_pair_max_segments_cover_every_tile_once(n_i, n_j):
    """Segments of seg consecutive source tiles, the last one non-empty,
    and no more blocks than the target asks (or one segment)."""
    nseg, seg = hn.pair_max_segments(n_i, n_j)
    tiles = -(-n_j // hn.PAIR_MAX_SOURCE_TILE)
    assert (nseg - 1) * seg < tiles <= nseg * seg
    blocks = -(-n_i // hn.PAIR_MAX_RECEIVERS)
    assert nseg == 1 or blocks * (nseg - 1) < hn.PAIR_MAX_TARGET_BLOCKS
    assert hn.pair_max_segments(n_i, n_j) == hn._segments(
        n_i, n_j, hn.PAIR_MAX_RECEIVERS, hn.PAIR_MAX_SOURCE_TILE,
        hn.PAIR_MAX_TARGET_BLOCKS)


@pytest.mark.parametrize("parent", [False, True])
def test_pair_max_parent_flag_takes_the_plain_version_on_the_cpu(parent):
    pos, _ = _inputs(300, 2, seed=4)
    rng = np.random.default_rng(4)
    vi, vj = _t(rng.random(120) < 0.8), _t(rng.random(180) < 0.8)
    xi, xj = _t(pos[:120]), _t(pos[120:])
    before = dict(hn.LAUNCHES)
    got = hn.pair_max(xi, xj, vi, vj, parent=parent)
    assert hn.LAUNCHES == before
    assert torch.equal(got, hn.pair_max_plain(xi, xj, vi, vj))
    with pytest.raises(ValueError):
        hn.pair_max(xi, xj, vi.float(), vj, parent=parent)


# --------------------------------------------------------------------------
# The plain versions against JAX (Pallas interpret mode)
# --------------------------------------------------------------------------

def hold(got, want, mode, rtol=2e-5, atol=1e-6):
    """tests/test_torch_sym_uniform.py's rule: the float tolerance, or for
    the int modes the flip rule after quantize_force (both sides
    quantized)."""
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


def _one_ulp(got, want):
    """Bitwise, or one ulp where XLA:CPU contracts d^2 into an FMA."""
    want = np.float32(want)
    return got == want or got in (np.nextafter(want, np.float32(np.inf)),
                                  np.nextafter(want, np.float32(0)))


@pytest.mark.parametrize("n", ODD_NS)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_general_sym_plain_matches_jax_at_odd_multiples_of_64(n, dim, mode):
    import jax.numpy as jnp

    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.ops import precision as jp
    from nbody_tpu.ops.pallas_nbody import pallas_accelerations_sym

    pos, m = _inputs(n, dim, seed=2)
    qj, qt = jp.Quantizer.from_string(mode), _q(mode)
    want = pallas_accelerations_sym(jnp.asarray(pos), jnp.asarray(m), qj,
                                    JaxConfig(), quantize_forces=qt.is_int,
                                    interpret=True)
    got = hn.sym_accelerations(_t(pos), _t(m), qt, CFG,
                               quantize_forces=qt.is_int)
    hold(got.numpy(), want, mode)
    # the wrapper took the general plain version for the CPU tensor
    bounds = hn.kernel_bounds(_t(pos), qt, CFG)
    gm = CFG.G * _t(m)
    before = dict(hn.LAUNCHES)
    assert torch.equal(hn.sym_force(_t(pos), gm, bounds, qt, False),
                       hn.sym_force_plain(_t(pos), gm, bounds, qt, False))
    assert hn.LAUNCHES == before


@pytest.mark.parametrize("n,uniform", [(320, False), (448, False),
                                       (448, True)])
@pytest.mark.parametrize("dim", [2, 3])
def test_fused_max_matches_jax_emit_max(n, uniform, dim):
    import jax.numpy as jnp

    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.ops import precision as jp
    from nbody_tpu.ops.pallas_nbody import pallas_accelerations_sym

    pos, m = _inputs(n, dim, seed=6)
    if uniform:
        m = np.ones_like(m)
    q = _q("int4")
    own_max = hn.max_d2_plain(_t(pos)) + CFG.softening_sq
    lo, hi = tp.dist_sq_log_bounds(q, own_max, CFG.softening_sq)
    acc, mx = hn.sym_accelerations(_t(pos), _t(m), q, CFG, log_lo=lo,
                                   log_hi=hi, uniform_gm=uniform,
                                   emit_max=True)
    jacc, jmx = pallas_accelerations_sym(
        jnp.asarray(pos), jnp.asarray(m), jp.Quantizer.from_string("int4"),
        JaxConfig(), log_lo=jnp.float32(lo), log_hi=jnp.float32(hi),
        uniform_gm=uniform, emit_max=True, interpret=True)
    assert torch.equal(mx, own_max)
    assert _one_ulp(np.float32(mx), np.float32(jmx)), (float(mx), float(jmx))
    hold(acc.numpy(), jacc, "int4")
    assert torch.equal(acc, hn.sym_accelerations(
        _t(pos), _t(m), q, CFG, log_lo=lo, log_hi=hi, uniform_gm=uniform))


def _ring_layout(n_total, shards, dim, seed):
    """A ring layout: n_total points padded to ``shards`` equal shards, the
    phantoms at the tail of the last shard (parallel/ring.py's padding),
    and each shard's validity."""
    pos, _ = _inputs(n_total, dim, seed)
    size = -(-n_total // shards)
    pad = np.full((size * shards - n_total, dim), 1e18, np.float32)
    pos = np.concatenate([pos, pad])
    valid = np.arange(size * shards) < n_total
    return ([pos[s * size:(s + 1) * size] for s in range(shards)],
            [valid[s * size:(s + 1) * size] for s in range(shards)])


@pytest.mark.parametrize("layout", ["tail phantoms", "scattered",
                                    "no valid pair"])
@pytest.mark.parametrize("dim", [2, 3])
def test_pair_max_plain_matches_jax(layout, dim):
    """Every shard pair of a ring layout of 301 points over 4 shards (3
    phantoms at the last shard's tail), the same with a third of the
    points invalid at random, and with no valid receiver: bitwise, or one
    ulp (XLA:CPU's FMA); 0 exactly where no pair is valid."""
    import jax.numpy as jnp

    from nbody_tpu.ops.pallas_nbody import pallas_pair_max

    shards, valid = _ring_layout(301, 4, dim, seed=8)
    rng = np.random.default_rng(dim)
    if layout == "scattered":
        valid = [v & (rng.random(v.shape[0]) < 0.67) for v in valid]
    elif layout == "no valid pair":
        valid = [np.zeros_like(v) for v in valid]
    for a in range(4):
        for b in range(4):
            args = (shards[a], shards[b], valid[a], valid[b])
            want = np.float32(pallas_pair_max(*(jnp.asarray(x)
                                                for x in args),
                                              block_i=128))
            got = hn.pair_max(*(_t(x) for x in args))
            assert torch.equal(got, hn.pair_max_plain(*(_t(x)
                                                         for x in args)))
            assert _one_ulp(np.float32(got), want), (a, b, float(got), want)
            if layout == "no valid pair":
                assert float(got) == 0.0 and want == 0.0
