"""The main path's two kernels, sym_force and max_d2, and their schedules.

sym_force's unflagged launch runs its tile pairs on one of two grids, a
fixed function of T = ceil(N / TILE) in the wrapper: "triangle" (one block
per tile pair I <= J) or "square" (the T x T grid, whose blocks with I > J
exit at once; a launch with a count or skip flag takes it at every T); the
same reduce_partials follows both, and both give the same bits. max_d2
makes one launch with tiles of 64 or 256 points, its per-block maxima
folded by the block that takes the last integer ticket.

On the CPU these tests hold the routing rules, the ticket and the wrappers'
arguments, and the plain versions (which the wrappers take for CPU tensors)
against the JAX package at the main path's N=5000, off the 64-row tile:
``pallas_accelerations_sym`` in Pallas interpret mode and the dense jnp
forces, float32 and int4, with the tolerances of tests/test_torch_forces.py
(float rtol 5e-5, atol 2e-6; int modes <2% of components off by >1e-4
max|a|). The ``gpu`` tests hold the triangle bitwise the T x T grid and
max_d2 bitwise its plain version on the card; they skip without one:

    python -m pytest --noconftest -q -m gpu tests/test_torch_schedules.py
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

STARS = 5000   # the canonical compare's N: 78 * 64 + 8, off the tile


def _disk(n, dim, seed=0):
    rng = np.random.default_rng(seed + n + dim)
    if dim == 3:
        return (rng.standard_normal((n, 3)) * 5.0).astype(np.float32)
    r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
    a = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(a), r * np.sin(a)], 1).astype(np.float32)


# --------------------------------------------------------------------------
# Routing and the ticket buffer (pure functions)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 64, 65, 300, 4099, STARS, 131072,
                               174784, 209728])
def test_sym_schedule_is_a_function_of_the_tile_count(n):
    tiles = -(-n // hn.TILE)
    want = "triangle" if tiles <= hn.TRIANGLE_MAX_TILES else "square"
    assert hn.sym_schedule(n) == want
    # Every N with the same T takes the same grid.
    assert hn.sym_schedule(tiles * hn.TILE) == want
    assert hn.sym_schedule((tiles - 1) * hn.TILE + 1) == want


def test_sym_schedule_routes_the_main_path_to_the_triangle():
    assert hn.sym_schedule(STARS) == "triangle"
    edge = hn.TRIANGLE_MAX_TILES * hn.TILE
    assert hn.sym_schedule(edge) == "triangle"
    assert hn.sym_schedule(edge + 1) == "square"


@pytest.mark.parametrize("n,tile", [(1, 64), (1024, 64), (hn.MAX_D2_SMALL_N,
                                                          64),
                                    (hn.MAX_D2_SMALL_N + 1, 256),
                                    (STARS, 256), (1_048_576, 256)])
def test_max_d2_tile(n, tile):
    """The pruned pass's 1024 candidates take 64-point tiles (136 tile
    pairs, about one a SM); the full 5000 and the 1M fallback 256."""
    assert hn.max_d2_tile(n) == tile


def test_max_d2_ticket_is_one_zeroed_int32_per_device(monkeypatch):
    """max_d2's last-block ticket: one int32 a device, allocated zeroed
    once, whatever N."""
    monkeypatch.setattr(hn, "TICKETS", {})
    dev = torch.device("cpu")
    t = hn.ticket(dev)
    assert t.dtype == torch.int32 and t.shape == () and int(t) == 0
    assert hn.ticket(dev) is t
    assert list(hn.TICKETS) == ["cpu"]


# --------------------------------------------------------------------------
# Validation of the new arguments
# --------------------------------------------------------------------------

def _small():
    pt = torch.from_numpy(_disk(100, 2))
    gm = torch.full((100,), 1e-3)
    q = tp.Quantizer.from_string("int4")
    lo, hi = tp.dist_sq_log_bounds(q, hn.max_d2_plain(pt) + 0.01, 0.01)
    return pt, gm, torch.stack([lo, hi, torch.full((), 0.01)]), q


def test_the_flags_and_the_input_validation():
    """The skip and count flags on a CPU tensor, as the kernels honour
    them; the inputs are validated."""
    pt, gm, bounds, q = _small()
    flag = torch.zeros((), dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int32)
    out = hn.sym_force(pt, gm, bounds, q, False, skip=flag, count=count)
    assert torch.equal(out, hn.sym_force_plain(pt, gm, bounds, q, False))
    assert int(count) == 1
    with pytest.raises(ValueError):
        hn.max_d2(pt, skip=torch.ones(()))
    with pytest.raises(TypeError):
        hn.sym_force(pt.double(), gm, bounds, q, False)


def test_cpu_tensors_take_the_plain_version():
    pt, gm, bounds, q = _small()
    assert torch.equal(hn.sym_force(pt, gm, bounds, q, False),
                       hn.sym_force_plain(pt, gm, bounds, q, False))
    one = torch.ones((), dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int32)
    assert torch.equal(hn.max_d2(pt), hn.max_d2_plain(pt))
    assert hn.max_d2(pt, skip=one, count=count).item() == 0
    assert int(count) == 0


# --------------------------------------------------------------------------
# The plain versions against JAX at the main path's N
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["float32", "int4"])
@pytest.mark.parametrize("equal", [True, False])
def test_plain_sym_matches_jax_at_the_main_path_size(mode, equal):
    """N=5000, D=2 disk: the port's sym_accelerations on CPU tensors (the
    plain version) against pallas_accelerations_sym in interpret mode and
    against the dense jnp forces."""
    import jax.numpy as jnp

    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.ops import forces as jf
    from nbody_tpu.ops import precision as jp
    from nbody_tpu.ops.pallas_nbody import pallas_accelerations_sym

    pos = _disk(STARS, 2, seed=8)
    rng = np.random.default_rng(8)
    m = (np.ones(STARS) if equal else 1.0 + rng.random(STARS)).astype(
        np.float32)
    qj = jp.Quantizer.from_string(mode)
    got = hn.sym_accelerations(torch.from_numpy(pos), torch.from_numpy(m),
                               tp.Quantizer.from_string(mode), SimConfig(),
                               quantize_forces=qj.is_int,
                               uniform_gm=equal).numpy()
    assert np.isfinite(got).all()
    for want in (pallas_accelerations_sym(jnp.asarray(pos), jnp.asarray(m),
                                          qj, JaxConfig(),
                                          quantize_forces=qj.is_int,
                                          interpret=True),
                 jf.dense_accelerations(jnp.asarray(pos), jnp.asarray(m), qj,
                                        JaxConfig(),
                                        quantize_forces=qj.is_int)):
        want = np.asarray(want)
        if qj.is_int:
            off = np.abs(got - want) > 1e-4 * np.abs(want).max()
            assert off.mean() < 0.02, f"{off.mean():.3%} components off"
        else:
            np.testing.assert_allclose(got, want, rtol=5e-5, atol=2e-6)


# --------------------------------------------------------------------------
# On the card: the schedules bitwise
# --------------------------------------------------------------------------

MODES = ["float64", "float32", "bf16", "f16", "int8", "int4", "custom"]
SOFTENINGS = [(0.01, False), (0.0, True), (0.0025, True)]   # 0.1, 0, run-time


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bounds(q, pt, soft, device):
    lo, hi = tp.dist_sq_log_bounds(q, hn.max_d2_plain(pt) + soft, soft)
    if not q.is_int:
        lo = hi = lo * 0
    return torch.stack([lo, hi, torch.full((), soft, device=device)])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5, 64, 300, 4099, STARS])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("equal", [False, True])
def test_triangle_bitwise_the_square_grid(cuda, n, dim, equal):
    """Every mode, softening 0.1 / 0 / run-time, unequal and equal masses
    (the equal-mass variant where N is a multiple of the tile); a count
    flag takes the T x T grid at every T."""
    rng = np.random.default_rng(n)
    pt = torch.from_numpy(_disk(n, dim, seed=19)).to(cuda)
    gm = (torch.full((n,), 1e-3) if equal else
          1e-3 * (1.0 + torch.from_numpy(rng.random(n)).float())).to(cuda)
    for mode in MODES:
        q = tp.Quantizer.from_string(mode)
        for soft, masked in SOFTENINGS:
            bounds = _bounds(q, pt, soft, cuda)
            tri = hn.sym_force(pt, gm, bounds, q, masked, uniform=equal)
            square = hn.sym_force(pt, gm, bounds, q, masked, uniform=equal,
                                  count=torch.zeros((), dtype=torch.int32,
                                                    device=cuda))
            assert torch.equal(tri, square), (mode, soft)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_triangle_bitwise_over_100_launches(cuda, mode):
    pt = torch.from_numpy(_disk(STARS, 2, seed=20)).to(cuda)
    gm = torch.full((STARS,), 1e-3, device=cuda)
    q = tp.Quantizer.from_string(mode)
    bounds = _bounds(q, pt, 0.01, cuda)
    before = hn.LAUNCHES["sym_force"]
    first = hn.sym_force(pt, gm, bounds, q, False)
    outs = [hn.sym_force(pt, gm, bounds, q, False) for _ in range(100)]
    assert all(torch.equal(o, first) for o in outs)
    assert hn.LAUNCHES["sym_force"] == before + 101


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, STARS])
def test_max_d2_bitwise_skipped_and_running(cuda, n):
    """100 launches that run, bitwise the plain max, each counted once (the
    single launch's ticket is back at 0 after every launch), and one
    skipped launch: 0, not counted."""
    pt = torch.from_numpy(_disk(n, 2, seed=21)).to(cuda)
    one = torch.ones((), dtype=torch.int32, device=cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    assert hn.max_d2(pt, skip=one, count=count).item() == 0.0
    assert int(count) == 0
    want = hn.max_d2_plain(pt)
    for _ in range(100):
        got = hn.max_d2(pt, skip=one * 0, count=count)
        assert torch.equal(got, want)
    assert int(count) == 100
    assert torch.equal(hn.max_d2(pt), want)
    assert int(hn.ticket(cuda)) == 0
