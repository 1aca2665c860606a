"""pair_pe_rows and max_d2 in their register-tiled designs past 16384
points, the snapshot energy on pair_pe_rows, and the rules that route them.

``pair_pe_rows`` over more than ``TILED_MIN_N`` receivers takes the
register-tiled design (``pe_design``: 4 receivers a thread, sources in
segments by ``pe_segments``, the id mask only on the tile pairs whose id
ranges meet, ``id_ranges``); ``max_d2`` past
``TILED_MIN_N`` points runs pair_max's register-tiled body over one set's
triangle (``max_d2_design``), 4097-16384 keep the 256-point single launch
and N <= 4096 the 64-point one. ``metrics.potential_energy`` on the card
past ``TILED_MIN_N`` particles sums pair_pe_rows' rows in f64
(``energy_route``), except for the float64 baseline (``compensated``).

On the CPU these tests hold the rules at their edges, the segment rule,
the id-range tile classification for adversarial ids (every equal pair in
a masked tile pair; one set masks only the diagonal tiles), the plain
pair_pe_rows against JAX's ``pallas_pair_pe_rows`` in Pallas interpret
mode (relative to the row, 1e-5: the same terms summed in another order,
as tests/test_torch_ring_tiles.py), and the routed energy's composition
(the plain rows, their f64 sum, -G/2) against JAX's
``metrics.potential_energy`` (relative 1e-6: f32 row sums of a few
thousand positive terms, each within ~n u of its exact sum). The ``gpu``
cases of tests/test_torch_kernels.py hold the kernels themselves.

    python -m pytest -q tests/test_torch_pe_max_redesign.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.diagnostics import metrics as jm
from nbody_tpu.ops.pallas_nbody import pallas_pair_pe_rows
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import metrics as tm
from nbody_tpu_torch.models.direct import DirectSimulation
from nbody_tpu_torch.ops import hopper_nbody as hn

torch.set_num_threads(1)

ID_PATTERNS = ("own", "random", "permuted", "duplicated", "overlapping",
               "disjoint")


def _cases(patterns, sizes):
    """(pattern, (n_i, n_j)) pairs; "own" (one set) only at equal sizes."""
    return [(p, s) for p in patterns for s in sizes
            if p != "own" or s[0] == s[1]]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


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


def _ids(pattern, n_i, n_j, seed):
    """Receiver and source ids (non-negative, below 2^24: the TPU kernel
    stages them as f32). "own": one set's own ids (n_i == n_j)."""
    rng = np.random.default_rng(seed)
    if pattern == "own":
        ids = np.arange(n_i)
        return ids, ids
    if pattern == "random":
        return rng.integers(0, 50, n_i), rng.integers(0, 50, n_j)
    if pattern == "permuted":
        return rng.permutation(n_i), rng.permutation(n_j)
    if pattern == "duplicated":
        return np.arange(n_i) // 3, np.arange(n_j) // 7
    if pattern == "overlapping":
        return np.arange(n_i), np.arange(n_i - 40, n_i - 40 + n_j)
    return np.arange(n_i), np.arange(n_i, n_i + n_j)   # disjoint


# --------------------------------------------------------------------------
# The route rules at their edges
# --------------------------------------------------------------------------

def test_tiled_edge_is_the_one_pass_edge():
    assert hn.TILED_MIN_N == hn.ONE_PASS_MIN_TILES * hn.TILE == 16384


@pytest.mark.parametrize("n_i,want", [
    (1, "per_receiver"), (16384, "per_receiver"), (16385, "tiled"),
    (131072, "tiled"), (1_048_576, "tiled")])
def test_pe_design(n_i, want):
    for n_j in (1, 300, 131072):
        assert hn.pe_design(n_i, n_j) == want


@pytest.mark.parametrize("n,want", [
    (1, "single_64"), (4096, "single_64"), (4097, "single_256"),
    (16384, "single_256"), (16385, "tiled"), (131072, "tiled"),
    (1_048_576, "tiled")])
def test_max_d2_design(n, want):
    assert hn.max_d2_design(n) == want


@pytest.mark.parametrize("n,device,compensated,want", [
    (16384, "cuda", False, "plain"), (16385, "cuda", False, "kernel"),
    (131072, "cuda", False, "kernel"), (16385, "cuda", True, "plain"),
    (131072, "cuda", True, "plain"), (131072, "cpu", False, "plain"),
    (5000, "cuda", False, "plain")])
def test_energy_route(n, device, compensated, want):
    assert tm.energy_route(n, device, compensated) == want


# --------------------------------------------------------------------------
# The segment rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_i,n_j,want", [
    ((131072, 131072, (64, 16))), ((1_048_576, 1_048_576, (8, 1024))),
    ((16385, 16385, (129, 1))), ((43691, 43691, (171, 2))),
    ((32769, 32769, (129, 2)))])
def test_pe_segments_at_the_paths_shapes(n_i, n_j, want):
    assert hn.pe_segments(n_i, n_j) == want


@pytest.mark.parametrize("n_i,n_j", [
    (16385, 300), (16385, 16385), (20011, 20011), (131072, 131072),
    (131075, 131075), (43691, 43691), (32769, 32769), (300, 1_048_576),
    (1_048_576, 1_048_576)])
def test_pe_segments_cover_every_tile_once(n_i, n_j):
    nseg, seg = hn.pe_segments(n_i, n_j)
    tiles = -(-n_j // hn.PE_SOURCE_TILE)
    assert 1 <= seg and 1 <= nseg <= tiles and nseg <= 65535
    assert (nseg - 1) * seg < tiles <= nseg * seg
    blocks = -(-n_i // hn.PE_RECEIVERS)
    assert blocks * nseg <= max(hn.PE_TARGET_BLOCKS, blocks) + 2 * blocks
    shape = hn.pe_scratch(n_i, n_j)
    assert (shape is None) == (nseg == 1)
    if shape is not None:
        assert shape == (blocks, nseg, hn.PE_RECEIVERS)


# --------------------------------------------------------------------------
# The id-range tile classification
# --------------------------------------------------------------------------

def _masked_tiles(ids_recv, ids_src):
    """(receiver blocks, source tiles) bool: the tile pairs the
    register-tiled pair_pe_rows runs in its masked copy, those whose
    ``id_ranges`` meet (csrc/pair_pe_rows.cu's test, ``sr.y >= rr.x &&
    sr.x <= rr.y``)."""
    rr = hn.id_ranges(ids_recv, hn.PE_RECEIVERS)
    sr = hn.id_ranges(ids_src, hn.PE_SOURCE_TILE)
    return (sr[None, :, 1] >= rr[:, None, 0]) & (sr[None, :, 0]
                                                 <= rr[:, None, 1])


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1500])
@pytest.mark.parametrize("width", [128, 512])
def test_id_ranges_are_each_runs_min_and_max(n, width):
    ids = np.random.default_rng(n).integers(-1000, 1000, n).astype(np.int32)
    got = hn.id_ranges(_t(ids), width).numpy()
    runs = [ids[k:k + width] for k in range(0, n, width)]
    assert got.dtype == np.int32 and got.shape == (len(runs), 2)
    assert (got[:, 0] == [r.min() for r in runs]).all()
    assert (got[:, 1] == [r.max() for r in runs]).all()


@pytest.mark.parametrize("pattern,sizes", _cases(
    ID_PATTERNS, [(1500, 1500), (1500, 1300), (700, 2049), (1, 130)]))
def test_every_equal_pair_lies_in_a_masked_tile(pattern, sizes):
    n_i, n_j = sizes
    ids_i, ids_j = _ids(pattern, n_i, n_j, seed=n_i + n_j)
    masked = _masked_tiles(_t(ids_i.astype(np.int32)),
                                _t(ids_j.astype(np.int32))).numpy()
    assert masked.shape == (-(-n_i // hn.PE_RECEIVERS),
                            -(-n_j // hn.PE_SOURCE_TILE))
    i, j = np.nonzero(ids_i[:, None] == ids_j[None, :])
    assert masked[i // hn.PE_RECEIVERS, j // hn.PE_SOURCE_TILE].all()
    if pattern == "disjoint":
        assert not masked.any()


@pytest.mark.parametrize("n", [1, 600, 1500, 4097, 16385])
def test_one_set_masks_only_the_diagonal_tiles(n):
    ids = torch.arange(n, dtype=torch.int32)
    masked = _masked_tiles(ids, ids).numpy()
    b = np.arange(masked.shape[0])[:, None] * hn.PE_RECEIVERS
    j = np.arange(masked.shape[1])[None, :] * hn.PE_SOURCE_TILE
    overlap = (j < b + hn.PE_RECEIVERS) & (j + hn.PE_SOURCE_TILE > b)
    assert (masked == overlap).all()
    assert masked.sum(axis=1).max() <= hn.PE_RECEIVERS // hn.PE_SOURCE_TILE


# --------------------------------------------------------------------------
# pair_pe_rows' plain version against JAX's tile in Pallas interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pattern,sizes", _cases(
    ID_PATTERNS, [(150, 150), (130, 300), (300, 77)]))
@pytest.mark.parametrize("dim", [2, 3])
def test_pair_pe_rows_plain_matches_jax(dim, pattern, sizes):
    n_i, n_j = sizes
    pos, m = _points(n_i + n_j, dim, seed=3)
    xi, mi = pos[:n_i], m[:n_i]
    xj, mj = (xi, mi) if pattern == "own" else (pos[n_i:], m[n_i:])
    ids_i, ids_j = (x.astype(np.int32) for x in _ids(pattern, n_i, n_j,
                                                     seed=dim))
    for soft in (0.01, 0.0025):
        want = np.asarray(pallas_pair_pe_rows(
            jnp.asarray(xi), jnp.asarray(mi), jnp.asarray(ids_i),
            jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(ids_j), soft,
            block_i=128))
        before = dict(hn.LAUNCHES)
        got = hn.pair_pe_rows(_t(xi), _t(mi), _t(ids_i), _t(xj), _t(mj),
                              _t(ids_j), soft).numpy()
        assert hn.LAUNCHES == before   # CPU tensors: the plain version
        assert got.shape == (n_i,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)


# --------------------------------------------------------------------------
# The routed snapshot energy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2000, 3001])
@pytest.mark.parametrize("soft", [None, 0.0025])
def test_rows_energy_matches_jax_potential_energy(n, soft):
    """-G/2 x the f64 sum of pair_pe_rows' rows (the plain rows on the
    CPU, the kernel's on the card) against JAX's compensated sum."""
    pos, m = _points(n, 2, seed=11)
    want = float(jm.potential_energy(jnp.asarray(pos), jnp.asarray(m),
                                     JaxConfig(), softening_sq=soft))
    got = tm.pe_rows_energy(_t(pos), _t(m), SimConfig(),
                            SimConfig().softening_sq if soft is None
                            else soft)
    assert got.dtype == torch.float64
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    plain = float(tm.potential_energy(_t(pos), _t(m), SimConfig(),
                                      softening_sq=soft))
    assert abs(plain - want) <= 1e-6 * abs(want)


def _record_routes(monkeypatch, route):
    """energy_route replaced by one that records its arguments and answers
    ``route``."""
    seen = []

    def fake(n, device_type, compensated=False):
        seen.append((n, device_type, compensated))
        return "plain" if compensated else route

    monkeypatch.setattr(tm, "energy_route", fake)
    return seen


def test_potential_energy_takes_the_route(monkeypatch):
    """The "kernel" route is pe_rows_energy (CPU tensors: its plain rows,
    no launch), the "plain" route (here: compensated) pair_potential_sum."""
    pos, m = (_t(x) for x in _points(600, 2, seed=5))
    cfg = SimConfig()
    seen = _record_routes(monkeypatch, "kernel")
    before = dict(hn.LAUNCHES)
    kernel = tm.potential_energy(pos, m, cfg)
    assert hn.LAUNCHES == before
    assert seen == [(600, "cpu", False)]
    assert torch.equal(kernel, tm.pe_rows_energy(pos, m, cfg,
                                                 cfg.softening_sq))
    plain = tm.potential_energy(pos, m, cfg, compensated=True)
    assert seen[-1] == (600, "cpu", True)
    ids = torch.arange(600)
    assert torch.equal(plain, -0.5 * cfg.G * tm.pair_potential_sum(
        pos, m, ids, pos, m, ids, cfg.softening_sq))
    assert abs(float(kernel) - float(plain)) <= 1e-6 * abs(float(plain))


@pytest.mark.parametrize("precision,compensated", [("float64", True),
                                                   ("float32", False),
                                                   ("int4", False)])
def test_float64_baseline_keeps_the_plain_energy(monkeypatch, precision,
                                                 compensated):
    """The float64 baseline's snapshots and energy getters pass
    compensated=True (its precision anchor keeps the plain f64 sum); every
    other mode lets the route decide."""
    pos, m = _points(300, 2, seed=9)
    vel = np.zeros_like(pos)
    sim = DirectSimulation(pos, vel, m, precision=precision, device="cpu")
    seen = _record_routes(monkeypatch, "plain")
    sim.get_potential_energy()
    sim.get_total_energy()
    sim.run_with_history(4, 2)
    assert len(seen) == 4
    assert all(c == compensated for _, _, c in seen)
