"""The plain reference against a brute-force pairwise sum at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from bench_h100 import ics, reference

CFG = {"family": "exponential_disk", "dim": 2, "galaxy_radius": 10.0,
       "core_mass_fraction": 0.3, "velocity_dispersion": 0.1, "mass": 1.0,
       "G": 0.001, "ic_seed": 42}


def brute(pos, m, G, eps2, grid=None):
    """acc and U by a double loop in float64 (numpy)."""
    n, dim = pos.shape
    acc = np.zeros((n, dim))
    u = 0.0
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            d = pos[j] - pos[i]
            d2 = float(d @ d) + eps2
            if j > i:
                u -= G * m[i] * m[j] / math.sqrt(d2)
            if grid is not None:
                levels, min_d2, lo, hi = grid
                x = max(d2, min_d2)
                k = np.round((math.log(x) - lo) / (hi - lo) * (levels - 1))
                d2 = max(math.exp(k / (levels - 1) * (hi - lo) + lo), min_d2)
            acc[i] += G * m[j] * d * d2 ** -1.5
    return acc, u


@pytest.fixture(params=[("exponential_disk", 2), ("plummer_sphere", 3)])
def small(request):
    family, dim = request.param
    cfg = dict(CFG, family=family, dim=dim, scale_radius=10.0)
    pos, vel, m = ics.make(cfg, 48, 2 ** 31 + 5, "cpu")
    return pos.double().numpy(), vel, m.double().numpy(), pos, m


def test_float_accelerations_and_potential(small):
    pos_np, _, m_np, pos, m = small
    want, u = brute(pos_np, m_np, 0.001, 0.01)
    rows = torch.arange(pos.shape[0])
    got, scale = reference.accelerations(pos, 0.001 * m.double(), rows,
                                         0.01, want_scale=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    assert (scale.numpy() >= np.abs(want) - 1e-15).all()
    assert reference.potential(pos, m, 0.001, 0.01,
                               dtype=torch.float64) == pytest.approx(
        u, rel=1e-12)
    # float32 terms with float64 sums: float32's rounding.
    assert reference.potential(pos, m, 0.001, 0.01) == pytest.approx(
        u, rel=1e-6)


def test_int4_accelerations(small):
    pos_np, _, m_np, pos, m = small
    n = pos_np.shape[0]
    d2max = max(float((pos_np[i] - pos_np[j]) @ (pos_np[i] - pos_np[j]))
                for i in range(n) for j in range(n))
    assert reference.max_pair_d2(pos) == pytest.approx(d2max, rel=1e-12)
    lo, hi = reference.log_grid(pos, 0.01, 0.01)
    assert lo == pytest.approx(math.log(0.01))
    assert hi == pytest.approx(math.log(d2max + 0.01))
    grid = (16, 0.01, lo, hi)
    want, _ = brute(pos_np, m_np, 0.001, 0.01, grid)
    got, _ = reference.accelerations(pos, 0.001 * m.double(),
                                     torch.arange(n), 0.01, grid=grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    snapped, step = reference.quantize_force(got, 16)
    levels = (snapped - got.min()) / step
    np.testing.assert_allclose(levels.numpy(), np.round(levels.numpy()),
                               atol=1e-9)
    assert float((snapped - got).abs().max()) <= 0.5 * step + 1e-12


def test_sampled_rows_match_all_rows(small):
    _, _, _, pos, m = small
    gm = 0.001 * m.double()
    n = pos.shape[0]
    full, _ = reference.accelerations(pos, gm, torch.arange(n), 0.01)
    rows = torch.tensor([0, 7, 31, n - 1])
    part, _ = reference.accelerations(pos, gm, rows, 0.01)
    torch.testing.assert_close(part, full[rows], rtol=0, atol=0)


def test_blocked_sums_equal_one_block(small, monkeypatch):
    _, _, _, pos, m = small
    gm = 0.001 * m.double()
    rows = torch.arange(pos.shape[0])
    one, _ = reference.accelerations(pos, gm, rows, 0.01)
    u1 = reference.potential(pos, m, 0.001, 0.01, dtype=torch.float64)
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", 64 * 5)
    many, _ = reference.accelerations(pos, gm, rows, 0.01)
    torch.testing.assert_close(many, one, rtol=1e-13, atol=1e-16)
    assert reference.potential(pos, m, 0.001, 0.01,
                               dtype=torch.float64) == pytest.approx(
        u1, rel=1e-13)


def test_kdk_and_kinetic():
    pos = torch.tensor([[1.0, 0.0]])
    vel = torch.tensor([[0.0, 2.0]])
    a0 = torch.tensor([[-1.0, 0.0]])
    a1 = torch.tensor([[-3.0, 0.0]])
    p, v = reference.kdk(pos, vel, a0, a1, 0.1)
    # half = v + a0 dt/2; p = x + half dt; v' = half + a1 dt/2.
    torch.testing.assert_close(p, torch.tensor([[0.995, 0.2]],
                                               dtype=torch.float64))
    torch.testing.assert_close(v, torch.tensor([[-0.2, 2.0]],
                                               dtype=torch.float64))
    assert reference.kinetic(vel, torch.tensor([3.0])) == pytest.approx(6.0)


def test_ics_one_realization_in_the_seed_s_order():
    a = ics.make(CFG, 64, 2 ** 31 + 11, "cpu")
    b = ics.make(CFG, 64, 2 ** 31 + 11, "cpu")
    c = ics.make(CFG, 64, 2 ** 31 + 12, "cpu")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    # The same stars: sorted by x, the two orders agree.
    for x, y in zip(a[:2], c[:2]):
        torch.testing.assert_close(x[a[0][:, 0].argsort()],
                                   y[c[0][:, 0].argsort()], rtol=0, atol=0)
    other = ics.make(dict(CFG, ic_seed=43), 64, 2 ** 31 + 11, "cpu")
    assert not torch.equal(a[0].sort(dim=0).values,
                           other[0].sort(dim=0).values)
