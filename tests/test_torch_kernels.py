"""The CUDA kernels of nbody_tpu_torch against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without an NVIDIA GPU (the
CUDA kernels have no CPU mode). This file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels.py

Tolerances as in tests/test_torch_forces.py: float modes rtol 5e-5,
atol 2e-6; int modes <2% of components off by >1e-4 max|a|.
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics.tolerance import pe_bound_rtol
from nbody_tpu_torch.ops import forces, hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

MODES = ["float32", "bf16", "f16", "int8", "int4", "custom"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _disk(n, dim, seed=0):
    rng = np.random.default_rng(seed + n + dim)
    if dim == 3:
        return (rng.standard_normal((n, 3)) * 5.0).astype(np.float32)
    r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
    a = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(a), r * np.sin(a)], 1).astype(np.float32)


def _ring(n):
    """Radius peaking gently at angle 0: the pruned pass must fall back."""
    a = np.arange(n) * (2 * np.pi / n)
    r = 10.0 + 0.01 * np.cos(a)
    return np.stack([r * np.cos(a), r * np.sin(a)], 1).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [7, 1000])
def test_sym_force_kernel_matches_plain(cuda, mode, dim, n):
    rng = np.random.default_rng(n)
    pt = torch.from_numpy(_disk(n, dim)).to(cuda)
    gm = (0.001 * (1.0 + torch.from_numpy(rng.random(n)).float())).to(cuda)
    q = tp.Quantizer.from_string(mode)
    lo, hi = tp.dist_sq_log_bounds(q, hn.max_d2_plain(pt) + 0.01, 0.01)
    bounds = torch.stack([lo, hi, torch.full((), 0.01, device=cuda)])
    before = hn.LAUNCHES["sym_force"]
    got = hn.sym_force(pt, gm, bounds, q, False)
    assert hn.LAUNCHES["sym_force"] == before + 1
    want = hn.sym_force_plain(pt, gm, bounds, q, False)
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got_np).all()
    if q.is_int:
        off = np.abs(got_np - want_np) > 1e-4 * np.abs(want_np).max()
        assert off.mean() < 0.02
    else:
        np.testing.assert_allclose(got_np, want_np, rtol=5e-5, atol=2e-6)
    assert torch.equal(got, hn.sym_force(pt, gm, bounds, q, False))


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", ["disk", "disk3d", "ring"])
def test_max_d2_kernel_bitwise(cuda, geometry):
    pos = {"disk": lambda: _disk(3000, 2), "disk3d": lambda: _disk(3000, 3),
           "ring": lambda: _ring(3000)}[geometry]()
    pt = torch.from_numpy(pos).to(cuda)
    before = hn.LAUNCHES["max_d2"]
    assert torch.equal(hn.max_d2(pt), hn.max_d2_plain(pt))
    assert hn.LAUNCHES["max_d2"] == before + 1
    cfg = SimConfig()
    assert torch.equal(forces.max_pairwise_dist_sq_pruned(pt, cfg),
                       forces.max_pairwise_dist_sq(pt, cfg))
    one = torch.ones((), dtype=torch.int32, device=cuda)
    assert hn.max_d2(pt, skip=one).item() == 0.0


@pytest.mark.gpu
def test_sym_accelerations_on_card_matches_cpu_plain(cuda):
    """The public force on the card against the same call on CPU tensors
    (the plain version): int4 with its pruned bounds, quantized forces."""
    pos = _disk(2000, 2)
    m = np.ones(2000, np.float32)
    q, cfg = tp.Quantizer.from_string("int4"), SimConfig()
    got = hn.sym_accelerations(torch.from_numpy(pos).to(cuda),
                               torch.from_numpy(m).to(cuda), q, cfg)
    want = hn.sym_accelerations(torch.from_numpy(pos), torch.from_numpy(m),
                                q, cfg)
    off = (got.cpu() - want).abs() > 1e-4 * want.abs().max()
    assert off.float().mean().item() < 0.02


def _bounds(q, pt, soft, device):
    lo, hi = tp.dist_sq_log_bounds(q, hn.max_d2_plain(pt) + soft, soft)
    if not q.is_int:
        lo = hi = lo * 0
    return torch.stack([lo, hi, torch.full((), soft, device=device)])


def _hold(got, want, q, scale=None):
    """The float rule elementwise (with the summed |terms| where given);
    int modes as above."""
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got_np).all()
    if q.is_int:
        off = np.abs(got_np - want_np) > 1e-4 * np.abs(want_np).max()
        assert off.mean() < 0.02
        return
    bound = 2e-6 + 5e-5 * np.abs(want_np)
    if scale is not None:
        bound = np.maximum(bound, 2e-6 + 5e-5 * scale.cpu().numpy())
    assert (np.abs(got_np - want_np) <= bound).all()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("soft,masked", [(0.01, False), (0.0, True),
                                         (0.0025, True)])
def test_row_force_kernel_matches_plain(cuda, mode, dim, soft, masked):
    """Softening 0.1, 0 and a run-time 0.05 (self-masked); zero softening
    is held with the summed |terms| (terms of near pairs cancel)."""
    rng = np.random.default_rng(3)
    pt = torch.from_numpy(_disk(1000, dim, seed=3)).to(cuda)
    gm = (0.001 * (1.0 + torch.from_numpy(rng.random(1000)).float())).to(cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, soft, cuda)
    before = hn.LAUNCHES["row_force"]
    got = hn.row_force(pt, gm, bounds, q, masked)
    assert hn.LAUNCHES["row_force"] == before + 1
    want = hn.row_force_plain(pt, gm, bounds, q, masked)
    scale = (hn.sym_force_term_scale(pt, gm, bounds, q, masked)
             if soft == 0.0 else None)
    _hold(got, want, q, scale)
    assert torch.equal(got, hn.row_force(pt, gm, bounds, q, masked))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_a,n_b", [(300, 1100), (1000, 64), (1, 5)])
def test_pair_sym_force_kernel_matches_plain(cuda, mode, dim, n_a, n_b):
    rng = np.random.default_rng(n_a)
    pt = torch.from_numpy(_disk(n_a + n_b, dim, seed=4)).to(cuda)
    gm = (0.001 * (1.0 + torch.from_numpy(rng.random(n_a + n_b)).float())
          ).to(cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    args = (pt[:n_a], gm[:n_a], pt[n_a:], gm[n_a:], bounds, q)
    before = hn.LAUNCHES["pair_sym_force"]
    rows, cols = hn.pair_sym_force(*args)
    assert hn.LAUNCHES["pair_sym_force"] == before + 1
    want_r, want_c = hn.pair_sym_force_plain(*args)
    _hold(rows, want_r, q)
    _hold(cols, want_c, q)
    rows2, cols2 = hn.pair_sym_force(*args)
    assert torch.equal(rows, rows2) and torch.equal(cols, cols2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["float32", "int4"])
@pytest.mark.parametrize("chunk", [5000, 3334, 1000])
def test_chunked_matches_single_launch_sym_force(cuda, mode, chunk):
    """2, 3 (ragged) and 10 chunks against one sym_force launch: the same
    pairs in another order, held with the summed |terms| where needed."""
    pt = torch.from_numpy(_disk(10000, 2, seed=5)).to(cuda)
    m = torch.ones(10000, device=cuda)
    q, cfg = tp.Quantizer.from_string(mode), SimConfig()
    single = hn.sym_accelerations(pt, m, q, cfg, quantize_forces=False)
    n_chunks = -(-10000 // chunk)
    before = dict(hn.LAUNCHES)
    got = hn.sym_accelerations_chunked(pt, m, q, cfg, quantize_forces=False,
                                       chunk=chunk)
    assert hn.LAUNCHES["sym_force"] - before["sym_force"] == n_chunks
    assert (hn.LAUNCHES["pair_sym_force"] - before["pair_sym_force"]
            == n_chunks * (n_chunks - 1) // 2)
    bounds = hn.kernel_bounds(pt, q, cfg)
    scale = hn.sym_force_term_scale(pt, cfg.G * m, bounds, q, False)
    bound = 2e-6 + 5e-5 * torch.maximum(single.abs(), scale)
    assert bool(((got - single).abs() <= bound).all())
    assert torch.equal(got, hn.sym_accelerations_chunked(
        pt, m, q, cfg, quantize_forces=False, chunk=chunk))


@pytest.mark.gpu
def test_zero_softening_chunked_routes_to_row_force(cuda):
    pt = torch.from_numpy(_disk(3000, 3, seed=6)).to(cuda)
    m = torch.ones(3000, device=cuda)
    before = dict(hn.LAUNCHES)
    acc = hn.sym_accelerations_chunked(pt, m, tp.Quantizer(),
                                       SimConfig(softening=0.0), chunk=1000)
    assert hn.LAUNCHES["row_force"] == before["row_force"] + 1
    assert hn.LAUNCHES["pair_sym_force"] == before["pair_sym_force"]
    assert bool(torch.isfinite(acc).all())


# --------------------------------------------------------------------------
# The multi-device ring's tiles: pair_force (#10), pair_max (#9),
# pair_pe_rows (#7)
# --------------------------------------------------------------------------

RING_SHAPES = [(700, 700), (300, 1100), (1, 1000), (1009, 67)]


def _two_sets(n_i, n_j, dim, seed, cuda):
    """Receivers and sources; (n, n) is one set used as both."""
    rng = np.random.default_rng(seed)
    if n_i == n_j:
        pt = torch.from_numpy(_disk(n_i, dim, seed)).to(cuda)
        gm = (0.001 * (1.0 + torch.from_numpy(rng.random(n_i)).float())
              ).to(cuda)
        return pt, pt, gm, gm
    pt = torch.from_numpy(_disk(n_i + n_j, dim, seed)).to(cuda)
    gm = (0.001 * (1.0 + torch.from_numpy(rng.random(n_i + n_j)).float())
          ).to(cuda)
    return pt[:n_i], pt[n_i:], gm[:n_i], gm[n_i:]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_i,n_j", RING_SHAPES)
def test_pair_force_kernel_matches_plain(cuda, mode, dim, n_i, n_j):
    """Receivers due to sources, one set or two, held with the summed
    |terms| (another summation order of the same terms)."""
    xi, xj, _, gm_j = _two_sets(n_i, n_j, dim, 7, cuda)
    q, cfg = tp.Quantizer.from_string(mode), SimConfig()
    bounds = _bounds(q, torch.cat([xi, xj]), cfg.softening_sq, cuda)
    lo, hi = (bounds[0], bounds[1]) if q.is_int else (None, None)
    before = hn.LAUNCHES["pair_force"]
    got = hn.pair_force(xi, xj, gm_j, q, cfg, lo, hi)
    assert hn.LAUNCHES["pair_force"] == before + 1
    want = hn.pair_force_plain(xi, xj, gm_j, q, cfg, lo, hi)
    _hold(got, want, q, hn.pair_force_term_scale(xi, xj, gm_j, bounds, q))
    assert torch.equal(got, hn.pair_force(xi, xj, gm_j, q, cfg, lo, hi))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_i,n_j", RING_SHAPES)
def test_pair_max_kernel_bitwise(cuda, dim, n_i, n_j):
    xi, xj, _, _ = _two_sets(n_i, n_j, dim, 8, cuda)
    rng = np.random.default_rng(n_i)
    for vi, vj in ((np.ones(n_i, bool), np.ones(n_j, bool)),
                   (rng.random(n_i) < 0.7, rng.random(n_j) < 0.7),
                   (np.zeros(n_i, bool), np.ones(n_j, bool))):
        vi_t, vj_t = torch.from_numpy(vi).to(cuda), torch.from_numpy(vj).to(cuda)
        before = hn.LAUNCHES["pair_max"]
        got = hn.pair_max(xi, xj, vi_t, vj_t)
        assert hn.LAUNCHES["pair_max"] == before + 1
        assert torch.equal(got, hn.pair_max_plain(xi, xj, vi_t, vj_t))
    if n_i == n_j:
        ones = torch.ones(n_i, dtype=torch.bool, device=cuda)
        assert torch.equal(hn.pair_max(xi, xi, ones, ones), hn.max_d2(xi))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_i,n_j", RING_SHAPES)
@pytest.mark.parametrize("soft", [0.01, 0.0])
def test_pair_pe_rows_kernel_matches_plain(cuda, dim, n_i, n_j, soft):
    """Row sums of positive terms, relative to the row itself (the summed
    |terms|): two fixed summation orders of up to n_j terms. One set gets
    its own ids (the self-pair masked), two sets ids that overlap in one
    particle."""
    xi, xj, mi, mj = _two_sets(n_i, n_j, dim, 9, cuda)
    ids_i = torch.arange(n_i, dtype=torch.int32, device=cuda)
    ids_j = (ids_i if n_i == n_j else
             torch.arange(n_i - 1, n_i - 1 + n_j, dtype=torch.int32,
                          device=cuda))
    args = (xi, mi, ids_i, xj, mj, ids_j, soft)
    before = hn.LAUNCHES["pair_pe_rows"]
    got = hn.pair_pe_rows(*args)
    assert hn.LAUNCHES["pair_pe_rows"] == before + 1
    want = hn.pair_pe_rows_plain(*args)
    assert bool(torch.isfinite(got).all())
    rtol = 2 * (128 + -(-n_j // 128) + 4) * 2.0 ** -24
    assert bool(((got - want).abs() <= rtol * want.abs() + 1e-30).all())
    assert torch.equal(got, hn.pair_pe_rows(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["sym", "rows"])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_virtual_ring_on_card_matches_single_device(cuda, schedule, mode):
    """Three shards on the card, N unaligned (phantom rows): one force
    evaluation against single-launch sym_force, the ring's max d^2 bitwise
    the single-device max, and exact launch counts (the int bounds on one
    controller: the pruned pass on the home card, two max_d2 launches past
    PRUNED_CANDIDATES, no pair_max)."""
    from nbody_tpu_torch.diagnostics import metrics
    from nbody_tpu_torch.parallel import ring
    n, S = 3001, 3
    pt = torch.from_numpy(_disk(n, 2, seed=10)).to(cuda)
    m = torch.ones(n, device=cuda)
    q, cfg = tp.Quantizer.from_string(mode), SimConfig()
    mesh = ring.ParticleMesh.virtual(S, cuda)
    before = dict(hn.LAUNCHES)
    got = ring.ring_accelerations(pt, m, q, cfg, mesh, schedule=schedule)
    launched = {k: hn.LAUNCHES[k] - before[k] for k in hn.LAUNCHES}
    want = {"sym_force": S, "pair_sym_force": S * (S - 1) // 2,
            "pair_force": 0} if schedule == "sym" else \
        {"sym_force": 0, "pair_sym_force": 0, "pair_force": S * S}
    want["pair_max"] = 0
    want["max_d2"] = (2 if n > hn.PRUNED_CANDIDATES else 1) if q.is_int else 0
    assert {k: launched[k] for k in want} == want
    single = hn.sym_accelerations(pt, m, q, cfg, quantize_forces=False)
    scale = hn.sym_force_term_scale(pt, cfg.G * m, hn.kernel_bounds(pt, q, cfg),
                                    q, False)
    assert bool(((got - single).abs()
                 <= 2e-6 + 5e-5 * torch.maximum(single.abs(), scale)).all())
    pos, _, mp, ids = ring._padded(pt, None, m, mesh)
    assert torch.equal(ring._ring_max_d2(mesh, ring._shards(pos, mesh),
                                         ring._shards(ids, mesh), n, cfg),
                       hn.max_d2(pt) + cfg.softening_sq)
    pe = ring.ring_potential_energy(pt, m, cfg, mesh)
    assert float(pe) == pytest.approx(
        float(metrics.potential_energy(pt, m, cfg)), rel=1e-6)


# --------------------------------------------------------------------------
# The sym kernels' equal-mass variants, the fused max and the skip flag,
# and the lab's variants of the equal-mass kernel
# --------------------------------------------------------------------------

def _equal(n, dim, seed, cuda):
    pt = torch.from_numpy(_disk(n, dim, seed)).to(cuda)
    return pt, torch.full((n,), 0.001, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [1024, 4096])
def test_sym_force_uniform_kernel_matches_plain(cuda, mode, dim, n):
    pt, gm = _equal(n, dim, 11, cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    before = dict(hn.LAUNCHES)
    got = hn.sym_force(pt, gm, bounds, q, False, uniform=True)
    assert hn.LAUNCHES["sym_force_uniform"] == \
        before["sym_force_uniform"] + 1
    assert hn.LAUNCHES["sym_force"] == before["sym_force"]
    _hold(got, hn.sym_force_uniform_plain(pt, gm, bounds, q, False), q)
    assert torch.equal(got, hn.sym_force(pt, gm, bounds, q, False,
                                         uniform=True))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_uniform_flag_off_the_tile_is_bitwise_general(cuda, mode):
    """N=1000 and 300 x 1100 are not multiples of the tile: the flag gives
    the general kernels' bits and counts as a general launch."""
    pt, gm = _equal(1400, 2, 12, cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    before = dict(hn.LAUNCHES)
    assert torch.equal(hn.sym_force(pt[:1000], gm[:1000], bounds, q, False,
                                    uniform=True),
                       hn.sym_force(pt[:1000], gm[:1000], bounds, q, False))
    args = (pt[:300], gm[:300], pt[300:], gm[300:], bounds, q)
    flagged = hn.pair_sym_force(*args, uniform=True)
    assert all(torch.equal(a, b)
               for a, b in zip(flagged, hn.pair_sym_force(*args)))
    assert hn.LAUNCHES["sym_force"] == before["sym_force"] + 2
    assert hn.LAUNCHES["pair_sym_force"] == before["pair_sym_force"] + 2
    assert hn.LAUNCHES["sym_force_uniform"] == before["sym_force_uniform"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_a,n_b", [(1024, 2048), (1024, 64)])
def test_pair_sym_force_uniform_kernel_matches_plain(cuda, mode, dim, n_a,
                                                     n_b):
    pt, gm = _equal(n_a + n_b, dim, 13, cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    args = (pt[:n_a], gm[:n_a], pt[n_a:], gm[n_a:], bounds, q)
    before = hn.LAUNCHES["pair_sym_force_uniform"]
    rows, cols = hn.pair_sym_force(*args, uniform=True)
    assert hn.LAUNCHES["pair_sym_force_uniform"] == before + 1
    want_r, want_c = hn.pair_sym_force_uniform_plain(*args)
    _hold(rows, want_r, q)
    _hold(cols, want_c, q)
    rows2, cols2 = hn.pair_sym_force(*args, uniform=True)
    assert torch.equal(rows, rows2) and torch.equal(cols, cols2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "int4", "custom"])
@pytest.mark.parametrize("n,uniform", [(1000, False), (4096, True),
                                       (4096, False)])
def test_fused_max_bitwise_and_forces_unchanged(cuda, mode, n, uniform):
    pt, gm = _equal(n, 2, 14, cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    mx = torch.empty((), device=cuda)
    key = hn._variant("sym_force", uniform, True)
    before = hn.LAUNCHES[key]
    got = hn.sym_force(pt, gm, bounds, q, False, uniform=uniform, max_out=mx)
    assert hn.LAUNCHES[key] == before + 1
    assert torch.equal(mx, hn.max_d2(pt))
    assert torch.equal(mx, hn.max_d2_plain(pt))
    assert torch.equal(got, hn.sym_force(pt, gm, bounds, q, False,
                                         uniform=uniform))


@pytest.mark.gpu
@pytest.mark.parametrize("n,dim,mode,uniform,masked,fused", [
    (2048, 2, "int4", True, False, False), (2048, 2, "int4", True, False, True),
    (2050, 3, "float32", False, True, False),
    (4100, 2, "bfloat16", False, False, False),
    (64, 3, "int8", True, True, False)])
def test_skip_flag_skips_the_launch(cuda, n, dim, mode, uniform, masked,
                                    fused):
    """skip != 0: zero forces, a zero max, and the run counter unchanged;
    skip == 0: the launch runs, bitwise the unflagged one, and counts.
    Without the fused max a flagged launch walks the tile pairs: ragged
    tiles and the self-mask included."""
    pt, gm = _equal(n, dim, 15, cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.0 if masked else 0.01, cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    one = torch.ones((), dtype=torch.int32, device=cuda)
    mx = torch.full((), 7.0, device=cuda) if fused else None
    out = hn.sym_force(pt, gm, bounds, q, masked, uniform=uniform,
                       max_out=mx, skip=one, count=count)
    assert not bool(out.any()) and int(count) == 0
    if fused:
        assert float(mx) == 0.0
    ran = hn.sym_force(pt, gm, bounds, q, masked, uniform=uniform,
                       max_out=mx, skip=one * 0, count=count)
    assert int(count) == 1
    assert torch.equal(ran, hn.sym_force(pt, gm, bounds, q, masked,
                                         uniform=uniform))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["float32", "int4"])
@pytest.mark.parametrize("variant", ["seedsoft", "wide2", "wide3", "wide4"])
def test_lab_kernels_match_plain(cuda, mode, variant):
    from nbody_tpu_torch.lab import kernel_lab
    pt, gm = _equal(4096, 2, 16, cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    key = f"sym_force_lab_{variant}"
    before = kernel_lab.LAUNCHES[key]
    got = kernel_lab.sym_force_lab(pt, gm, bounds, q, False, variant)
    assert kernel_lab.LAUNCHES[key] == before + 1
    _hold(got, kernel_lab.sym_force_lab_plain(pt, gm, bounds, q, False,
                                              variant), q)
    assert torch.equal(got, kernel_lab.sym_force_lab(pt, gm, bounds, q,
                                                     False, variant))


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant,mode", [
    ("base2", "int4"), ("rt2", "float32"), ("rt2", "int4"),
    ("rt3", "float32"), ("rt3", "int4"), ("wideacc", "float32"),
    ("wideacc", "int4"), ("base2_wideacc", "int4")])
def test_r4_lab_kernels_match_plain(cuda, variant, mode, masked):
    """The round-4 lab variants (N = 3072, a multiple of every tile side),
    softening 0.1 and zero; zero softening holds to the summed |terms|."""
    from nbody_tpu_torch.lab import kernel_lab
    pt, gm = _equal(3072, 2, 17, cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.0 if masked else 0.01, cuda)
    key = f"sym_force_lab_{variant}"
    before = kernel_lab.LAUNCHES[key]
    got = kernel_lab.sym_force_lab(pt, gm, bounds, q, masked, variant)
    assert kernel_lab.LAUNCHES[key] == before + 1
    scale = (hn.sym_force_term_scale(pt, gm, bounds, q, masked) if masked
             else None)
    _hold(got, kernel_lab.sym_force_lab_plain(pt, gm, bounds, q, masked,
                                              variant), q, scale)
    assert torch.equal(got, kernel_lab.sym_force_lab(pt, gm, bounds, q,
                                                     masked, variant))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_mxu_kernel_matches_plain(cuda, precision, dim):
    """The round-5 tensor-core kernel (N = 3072) against its plain version
    at each precision, the float rule on the function's summed |terms|
    (its sums cancel down to |a|); bitwise run to run."""
    from nbody_tpu_torch.lab import kernel_lab_r5 as k5
    pt = torch.from_numpy(_disk(3072, dim, 18)).to(cuda)
    gm = torch.full((), 1e-3, device=cuda)
    key = f"sym_force_mxu_{precision}"
    before = k5.LAUNCHES[key]
    got = k5.sym_force_mxu(pt, gm, 0.01, precision)
    assert k5.LAUNCHES[key] == before + 1
    _hold(got, k5.sym_force_mxu_plain(pt, gm, 0.01, precision),
          tp.Quantizer.from_string("float32"),
          k5.mxu_term_scale(pt, gm, 0.01))
    assert torch.equal(got, k5.sym_force_mxu(pt, gm, 0.01, precision))


# --------------------------------------------------------------------------
# The one-pass body past 256 tiles for the general sym_force and the fused
# max, and pair_max's register-tiled launch
# --------------------------------------------------------------------------

def _general(n, dim, seed, cuda):
    rng = np.random.default_rng(seed)
    pt = torch.from_numpy(_disk(n, dim, seed)).to(cuda)
    gm = (0.001 * (1.0 + torch.from_numpy(rng.random(n)).float())).to(cuda)
    return pt, gm


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [16448, 16576])
def test_general_one_pass_sym_force_matches_plain(cuda, mode, dim, n):
    """257 and 259 tiles (ragged 256-receiver tails): the general route on
    the one-pass body, one sym_force count, bitwise run to run."""
    pt, gm = _general(n, dim, 31, cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    assert hn.sym_design(n, dim, q) == "one_pass"
    before = dict(hn.LAUNCHES)
    got = hn.sym_force(pt, gm, bounds, q, False)
    assert hn.LAUNCHES == {**before, "sym_force": before["sym_force"] + 1}
    _hold(got, hn.sym_force_plain(pt, gm, bounds, q, False), q)
    assert torch.equal(got, hn.sym_force(pt, gm, bounds, q, False))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "int4", "custom"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("uniform", [False, True])
def test_one_pass_fused_max_bitwise_and_forces_unchanged(cuda, mode, dim,
                                                         uniform):
    """The fused max on the one-pass body at 16448 (257 tiles): bitwise
    max_d2's and the plain max's, the forces bitwise the unflagged
    launch's, one sym_force_max / sym_force_uniform_max count."""
    n = 16448
    pt, gm = _general(n, dim, 32, cuda)
    if uniform:
        gm = torch.full_like(gm, 0.001)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    assert hn.sym_design(n, dim, q, fused_max=True) == "one_pass"
    key = hn._variant("sym_force", uniform, True)
    mx = torch.empty((), device=cuda)
    before = hn.LAUNCHES[key]
    got = hn.sym_force(pt, gm, bounds, q, False, uniform=uniform, max_out=mx)
    assert hn.LAUNCHES[key] == before + 1
    assert torch.equal(mx, hn.max_d2(pt))
    assert torch.equal(mx, hn.max_d2_plain(pt))
    assert torch.equal(got, hn.sym_force(pt, gm, bounds, q, False,
                                         uniform=uniform))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("layout", ["all valid", "tail phantom",
                                    "scattered", "none valid"])
def test_tiled_pair_max_bitwise_plain(cuda, dim, layout):
    """The register-tiled pair_max bitwise its plain version, over 100
    consecutive launches."""
    n_i, n_j = 4099, 5001
    xi, xj, _, _ = _two_sets(n_i, n_j, dim, 33, cuda)
    rng = np.random.default_rng(dim)
    vi, vj = {"all valid": (np.ones(n_i, bool), np.ones(n_j, bool)),
              "tail phantom": (np.arange(n_i) < n_i - 1,
                               np.arange(n_j) < n_j - 3),
              "scattered": (rng.random(n_i) < 0.7, rng.random(n_j) < 0.7),
              "none valid": (np.zeros(n_i, bool), np.ones(n_j, bool))}[layout]
    vi, vj = torch.from_numpy(vi).to(cuda), torch.from_numpy(vj).to(cuda)
    before = hn.LAUNCHES["pair_max"]
    got = hn.pair_max(xi, xj, vi, vj)
    assert hn.LAUNCHES["pair_max"] == before + 1
    assert torch.equal(got, hn.pair_max_plain(xi, xj, vi, vj))
    assert all(torch.equal(hn.pair_max(xi, xj, vi, vj), got)
               for _ in range(100))
    if layout == "none valid":
        assert float(got) == 0.0


# --------------------------------------------------------------------------
# pair_pe_rows and max_d2 in their register-tiled designs past 16384 points
# --------------------------------------------------------------------------

PE_SHAPES = [(16384, 16384), (16385, 16385), (20011, 20011),
             (131072, 131072), (131075, 131075), (16385, 300)]


def _pe_ids(pattern, n_i, n_j, cuda):
    """Receiver and source ids; "own" one set's (n_i == n_j) or each
    set's own arange."""
    rng = np.random.default_rng(n_i + n_j)
    ids = {"own": (np.arange(n_i), np.arange(n_j)),
           "permuted": (rng.permutation(n_i), rng.permutation(n_j)),
           "duplicated": (np.arange(n_i) // 3, np.arange(n_j) // 7),
           "overlapping": (np.arange(n_i), np.arange(n_i - 40, n_i - 40 + n_j)),
           "disjoint": (np.arange(n_i), np.arange(n_i, n_i + n_j))}[pattern]
    return tuple(torch.from_numpy(x.astype(np.int32)).to(cuda) for x in ids)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["own", "permuted", "duplicated",
                                     "overlapping", "disjoint"])
@pytest.mark.parametrize("n_i,n_j", PE_SHAPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_tiled_pair_pe_rows_matches_plain(cuda, dim, n_i, n_j, pattern):
    """The routed design against the plain version within its bound, on
    both sides of the route's edge (16384 one thread a receiver, 16385
    register-tiled), ragged and prime N, adversarial ids, softening 0.1
    and 0; bitwise run to run."""
    xi, xj, mi, mj = _two_sets(n_i, n_j, dim, 41, cuda)
    mi, mj = mi * 1000.0, mj * 1000.0
    ids_i, ids_j = _pe_ids(pattern, n_i, n_j, cuda)
    for soft in (0.01, 0.0):
        args = (xi, mi, ids_i, xj, mj, ids_j, soft)
        before = hn.LAUNCHES["pair_pe_rows"]
        got = hn.pair_pe_rows(*args)
        assert hn.LAUNCHES["pair_pe_rows"] == before + 1
        want = hn.pair_pe_rows_plain(*args)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin)
        err = (got - want).abs()[fin]
        assert bool((err <= pe_bound_rtol(n_i, n_j) * want.abs()[fin]).all())
        assert torch.equal(got, hn.pair_pe_rows(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4097, 16384, 16385, 20011, 131072,
                               131075])
@pytest.mark.parametrize("dim", [2, 3])
def test_max_d2_designs_bitwise_at_the_route_edges(cuda, dim, n):
    """Every design bitwise the plain version; the skip flag gives 0 and
    counts nothing, a run counts one; bitwise over 20 consecutive
    launches."""
    pt = torch.from_numpy(_disk(n, dim, 43)).to(cuda)
    want = hn.max_d2_plain(pt)
    before = hn.LAUNCHES["max_d2"]
    got = hn.max_d2(pt)
    assert hn.LAUNCHES["max_d2"] == before + 1
    assert torch.equal(got, want)
    one = torch.ones((), dtype=torch.int32, device=cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    assert float(hn.max_d2(pt, skip=one, count=count)) == 0.0
    assert torch.equal(hn.max_d2(pt, skip=one * 0, count=count), want)
    assert int(count) == 1
    assert all(torch.equal(hn.max_d2(pt), want) for _ in range(20))


def _pm_positions(n, dim, box, layout, seed=0):
    rng = np.random.default_rng(seed + n + dim)
    pos = rng.uniform(0.0, box, (n, dim)).astype(np.float32)
    if layout == "clustered":       # most particles in a few cells
        pos[: n - n // 10] = (box * 0.5 + rng.uniform(0, box / 40,
                              (n - n // 10, dim))).astype(np.float32)
    elif layout == "edge":          # on the box edge, wrapped negatives
        pos[: n // 4] = np.float32(box)
        pos[n // 4: n // 2] = np.float32(-1e-9) % np.float32(box)
    return pos


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["uniform", "clustered", "edge"])
@pytest.mark.parametrize("dim, n_grid, box", [(2, 128, 200.0),
                                              (3, 64, 400.0)])
@pytest.mark.parametrize("deposit", ["ngp_deposit", "cic_deposit"])
def test_pm_deposit_bitwise_its_plain_version(cuda, deposit, dim, n_grid,
                                              box, layout):
    """The deposit kernel (csrc/pm_deposit.cu) bitwise its plain version on
    a CPU copy of the segment sums' inputs (the keys and weights the
    deposit makes on the card, each sum added to the last), bitwise from
    run to run, one launch a segment sum (NGP one, CIC one a corner)."""
    from nbody_tpu_torch.ops import pm

    pos = torch.from_numpy(_pm_positions(20000, dim, box, layout)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(dim).uniform(
        0.5, 1.5, 20000).astype(np.float32)).to(cuda)
    kind = deposit.split("_")[0]
    segments = list(pm.deposit_segments(pos, w, n_grid, box, kind))
    cells = n_grid ** dim
    got = want = None
    for keys, ws in segments:
        want = pm.segment_sum(keys.cpu(), ws.cpu(), cells, want)
        got = pm.segment_sum(keys, ws, cells, got)
    assert torch.equal(got.cpu(), want)
    before = pm.LAUNCHES["pm_deposit"]
    again = getattr(pm, deposit)(pos, w, n_grid, box)
    assert pm.LAUNCHES["pm_deposit"] == before + len(segments)
    assert len(segments) == (1 if kind == "ngp" else 2 ** dim)
    assert torch.equal(again.reshape(-1), got)
    assert all(torch.equal(getattr(pm, deposit)(pos, w, n_grid, box), again)
               for _ in range(5))


@pytest.mark.gpu
def test_pm_segment_sum_edges(cuda):
    """Empty cells written as prev (or 0), one segment, keys all in one
    cell, and a sum in particle order (not sorted by value)."""
    from nbody_tpu_torch.ops import pm

    keys = torch.tensor([3, 3, 0, 3], dtype=torch.int32)
    w = torch.tensor([1e8, 1.0, 2.0, -1e8])
    prev = torch.arange(5, dtype=torch.float32)
    for p in (None, prev):
        want = pm.segment_sum(keys, w, 5, p)
        got = pm.segment_sum(keys.to(cuda), w.to(cuda), 5,
                             None if p is None else p.to(cuda))
        assert torch.equal(got.cpu(), want)
    assert float(want[3]) == 3.0    # 3 + ((1e8 + 1) - 1e8): 1 is lost
    one = torch.zeros(1000, dtype=torch.int32)
    ws = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(pm.segment_sum(one.to(cuda), ws.to(cuda), 1).cpu(),
                       pm.segment_sum(one, ws, 1))


def _pm_bits(t):
    return t.cpu().contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("long_run", [1, 32])
@pytest.mark.parametrize("n, cells", [(20000, 64 ** 3), (262144, 256 ** 3)])
@pytest.mark.parametrize("name", ["one_cell", "runs_R", "runs_R1",
                                  "long_first", "long_last", "alternating",
                                  "sparse", "ties", "straddle", "cells1",
                                  "n1"])
def test_pm_deposit_runs_adversarial_keys(cuda, name, n, cells, long_run):
    """The run-centric deposit on diagnostics.deposit_cases' keys, with and
    without prev: bitwise (float32 bits) its plain version and itself run
    to run; its long pass took exactly the runs
    longer than long_run (the work list's count), and it counts the
    launches of pm.deposit_launches."""
    from nbody_tpu_torch.diagnostics.deposit_cases import (
        case_weights, deposit_key_cases)
    from nbody_tpu_torch.ops import pm

    keys, cells = next((k, c) for case, k, c in
                       deposit_key_cases(n, cells, long_run, 5)
                       if case == name)
    w = torch.from_numpy(case_weights(len(keys), 5))
    kc = torch.from_numpy(keys)
    sorted_keys, perm = pm.sort_keys(kc.to(cuda))
    _, lengths, _ = pm.sorted_runs(sorted_keys, cells)
    prev = torch.from_numpy(np.random.default_rng(9).standard_normal(
        cells).astype(np.float32))
    prev[::7] = -0.0
    for p in (None, prev):
        want = pm.segment_sum_plain(kc, w, cells, p)
        pc = None if p is None else p.to(cuda)
        scratch = torch.empty(pm.long_list_size(len(keys), long_run),
                              dtype=torch.int32, device=cuda)
        before = dict(pm.LAUNCHES)
        got = pm.deposit_sorted(sorted_keys, perm, w.to(cuda), cells, pc,
                                long_run=long_run, long_list=scratch)
        expect = pm.deposit_launches(len(keys), long_run)
        assert {k: pm.LAUNCHES[k] - before[k] for k in expect} == expect
        assert int(scratch[0]) == int((lengths > long_run).sum())
        assert torch.equal(_pm_bits(got), _pm_bits(want))
        assert all(torch.equal(_pm_bits(pm.deposit_sorted(
            sorted_keys, perm, w.to(cuda), cells, pc, long_run=long_run)),
            _pm_bits(want)) for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["uniform", "clustered", "one_cell"])
@pytest.mark.parametrize("dim, n_grid, box", [(2, 512, 200.0),
                                              (3, 256, 400.0)])
@pytest.mark.parametrize("deposit", ["ngp_deposit", "cic_deposit"])
def test_pm_deposit_in_place_chain_vs_out_of_place(cuda, deposit, dim,
                                                   n_grid, box, layout):
    """NGP and CIC at N=262144 through the entry points (CIC's later
    corners added into the grid in place): bitwise (float32 bits) the
    out-of-place chain of segment_sum(prev=...), the plain version on a
    CPU copy, and itself run to run."""
    from nbody_tpu_torch.ops import pm

    n = 262144
    pos_np = _pm_positions(n, dim, box, "clustered" if layout == "clustered"
                           else "uniform")
    if layout == "one_cell":
        pos_np[:] = np.float32(box * 0.3)
    pos = torch.from_numpy(pos_np).to(cuda)
    w = torch.from_numpy(np.random.default_rng(dim).uniform(
        0.5, 1.5, n).astype(np.float32)).to(cuda)
    cells = n_grid ** dim
    kind = deposit.split("_")[0]
    chain = want = None
    for keys, ws in pm.deposit_segments(pos, w, n_grid, box, kind):
        want = pm.segment_sum_plain(keys.cpu(), ws.cpu(), cells, want)
        chain = pm.segment_sum(keys, ws, cells, chain)
    got = getattr(pm, deposit)(pos, w, n_grid, box).reshape(-1)
    assert torch.equal(_pm_bits(got), _pm_bits(want))
    assert torch.equal(_pm_bits(chain), _pm_bits(want))
    assert all(torch.equal(_pm_bits(getattr(pm, deposit)(
        pos, w, n_grid, box).reshape(-1)), _pm_bits(got)) for _ in range(3))
