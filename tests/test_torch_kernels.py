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
