"""The deposit kernel's run-centric design, modelled on the CPU.

``csrc/pm_deposit.cu`` sums each run of sorted particles (one cell's) in
particle order: a thread a run of at most ``pm.LONG_RUN``, a block a longer
one, after a fill of the grid (0, or prev + 0), and CIC's later corners add
into the running grid in place. ``pm.deposit_runs_plain`` is that
decomposition step by step; here it is held bit for bit (the float32 bit
patterns, so -0.0 and +0.0 differ) against the plain version
(``segment_sum_plain``) and ``jax.ops.segment_sum`` on the adversarial keys
of ``diagnostics.deposit_cases``, and the in-place CIC chain against the
out-of-place one and the numpy CIC oracle of tests/test_torch_pm.py. The
kernel itself is held to the same cases on the card
(tests/test_torch_kernels.py, ``chip_smoke.py --phases pm``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu_torch.diagnostics.deposit_cases import (case_weights,
                                                       deposit_key_cases)
from nbody_tpu_torch.ops import pm
from test_torch_pm import _cic_oracle, _edge_inputs, _inputs

torch.set_num_threads(1)

N, CELLS = 3000, 4096
CASES = [name for name, _, _ in deposit_key_cases(N, CELLS, pm.LONG_RUN)]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _case(name, long_run, seed=0):
    for case, keys, cells in deposit_key_cases(N, CELLS, long_run, seed):
        if case == name:
            return keys, cells, case_weights(len(keys), seed)
    raise KeyError(name)


def _model(keys, w, cells, prev=None, long_run=pm.LONG_RUN):
    sorted_keys, perm = pm.sort_keys(torch.from_numpy(keys))
    return pm.deposit_runs_plain(sorted_keys, perm, torch.from_numpy(w),
                                 cells, prev, long_run=long_run)


def _long_starts(keys, cells, long_run):
    """First sorted index of each in-range run longer than long_run."""
    ks = np.sort(keys, kind="stable")
    values, first, counts = np.unique(ks, return_index=True,
                                      return_counts=True)
    keep = (values >= 0) & (values < cells) & (counts > long_run)
    return first[keep]


@pytest.mark.parametrize("long_run", [4, pm.LONG_RUN])
@pytest.mark.parametrize("name", CASES)
def test_runs_model_is_plain_and_jax_bitwise(name, long_run):
    """Every adversarial key set, with and without prev: the model's grid
    is the plain version's and JAX's bit for bit, and exactly the runs
    longer than long_run went to the long pass."""
    keys, cells, w = _case(name, long_run)
    grid, longs = _model(keys, w, cells, long_run=long_run)
    plain = pm.segment_sum_plain(torch.from_numpy(keys), torch.from_numpy(w),
                                 cells)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(w), jnp.asarray(keys),
                                          num_segments=cells))
    np.testing.assert_array_equal(_bits(grid), _bits(plain))
    np.testing.assert_array_equal(_bits(grid), _bits(want))
    np.testing.assert_array_equal(np.sort(longs.numpy()),
                                  _long_starts(keys, cells, long_run))
    prev = np.random.default_rng(7).standard_normal(cells).astype(np.float32)
    got, _ = _model(keys, w, cells, torch.from_numpy(prev), long_run)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(np.asarray(jnp.asarray(prev) + want)))


def test_the_cases_reach_every_edge():
    """The key sets hold what they are named for, at the default R."""
    r = pm.LONG_RUN
    lengths = {}
    for name, keys, cells in deposit_key_cases(N, CELLS, r):
        sk, _ = pm.sort_keys(torch.from_numpy(keys))
        starts, lens, run_keys = pm.sorted_runs(sk, cells)
        lengths[name] = (starts.numpy(), lens.numpy(), cells)
    assert lengths["one_cell"][1].tolist() == [N]
    assert (lengths["runs_R"][1][:-1] == r).all()
    assert (lengths["runs_R1"][1][:-1] == r + 1).all()
    for name, at in (("long_first", 0), ("long_last", -1)):
        starts, lens, _ = lengths[name]
        assert lens[at] > r and lens.max() == lens[at]
    assert lengths["long_last"][0][-1] + lengths["long_last"][1][-1] == N
    lens = lengths["alternating"][1]
    assert ((lens[:-1] > r) != (lens[1:] > r)).sum() >= len(lens) // 2
    starts, lens, cells = lengths["sparse"]
    assert len(lens) <= 64 < cells
    starts, lens, _ = lengths["straddle"]
    ends = starts + lens
    assert ((starts // 256) != ((ends - 1) // 256)).sum() > 1
    assert lengths["cells1"][2] == 1 and lengths["n1"][1].tolist() == [1]


@pytest.mark.parametrize("long_run", [1, pm.LONG_RUN])
def test_out_of_range_keys_are_never_summed(long_run):
    """Keys below 0 or from ``cells`` on are dropped, as JAX drops them,
    whatever their run's length."""
    rng = np.random.default_rng(3)
    keys = rng.integers(-5, 70, 2000).astype(np.int32)
    keys[:100] = -1
    keys[100:200] = 64
    w = case_weights(2000, 3)
    grid, longs = _model(keys, w, 64, long_run=long_run)
    want = jax.ops.segment_sum(jnp.asarray(w), jnp.asarray(keys),
                               num_segments=64)
    np.testing.assert_array_equal(_bits(grid), _bits(np.asarray(want)))
    np.testing.assert_array_equal(np.sort(longs.numpy()),
                                  _long_starts(keys, 64, long_run))


def test_sort_keeps_particle_order_within_a_cell():
    """Unsorted keys with ties: the stable sort's permutation runs up
    within every cell, so each run is added in particle order."""
    keys, cells, _ = _case("ties", pm.LONG_RUN)
    sorted_keys, perm = pm.sort_keys(torch.from_numpy(keys))
    assert (np.diff(sorted_keys.numpy()) >= 0).all()
    same = np.diff(sorted_keys.numpy()) == 0
    assert (np.diff(perm.numpy())[same] > 0).all()
    assert same.sum() > N // 2


def _cic_chain(pos, w, n_grid, box, in_place):
    """The corners' sums chained: each corner's sorted keys through the
    model, into the running grid in place or as prev + sum."""
    pos, w = torch.from_numpy(pos), torch.from_numpy(w)
    cells = n_grid ** pos.shape[1]
    grid = None
    for keys, ws in pm.deposit_segments(pos, w, n_grid, box, "cic"):
        sorted_keys, perm = pm.sort_keys(keys)
        if grid is not None and in_place:
            pm.deposit_runs_plain(sorted_keys, perm, ws, cells, into=grid,
                                  long_run=4)
        else:
            grid = pm.deposit_runs_plain(sorted_keys, perm, ws, cells, grid,
                                         long_run=4)[0]
    return grid


@pytest.mark.parametrize("layout", ["uniform", "edge", "one_cell"])
@pytest.mark.parametrize("dim, n_grid, box", [(2, 32, 100.0),
                                              (3, 16, 50.0)])
def test_cic_in_place_chain_is_the_out_of_place_chain(dim, n_grid, box,
                                                      layout):
    """CIC's corners added into the running grid in place, only occupied
    cells touched: bitwise the out-of-place chain, the port's cic_deposit
    and the numpy CIC oracle."""
    if layout == "edge":
        pos, w = _edge_inputs(dim, box)
    else:
        pos, w = _inputs(dim, box, n=800)
        if layout == "one_cell":
            pos[:] = np.float32(box * 0.3)
    in_place = _cic_chain(pos, w, n_grid, box, True)
    np.testing.assert_array_equal(_bits(in_place),
                                  _bits(_cic_chain(pos, w, n_grid, box,
                                                   False)))
    np.testing.assert_array_equal(
        _bits(in_place), _bits(_cic_oracle(pos, w, n_grid, box).reshape(-1)))
    np.testing.assert_array_equal(
        _bits(in_place), _bits(pm.cic_deposit(torch.from_numpy(pos),
                                              torch.from_numpy(w), n_grid,
                                              box).reshape(-1)))


def test_prev_with_negative_zero_keeps_the_out_of_place_contract():
    """segment_sum(prev=...) with -0.0 planted in prev, at empty and at
    occupied cells (one whose run sums to +0.0): the fill's prev + 0 and
    then the add give bitwise prev + segment_sum_plain, -0.0 made +0.0."""
    keys = np.array([3, 3, 5, 1, 1, 1], np.int32)
    w = np.array([2.5, -2.5, 1.0, 1e8, 1.0, -1e8], np.float32)
    prev = np.array([-0.0, -0.0, 4.0, -0.0, 1.0, -0.0, -0.0, 2.0],
                    np.float32)
    want = prev + pm.segment_sum_plain(torch.from_numpy(keys),
                                       torch.from_numpy(w), 8).numpy()
    got, _ = _model(keys, w, 8, torch.from_numpy(prev), long_run=2)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    public = pm.segment_sum(torch.from_numpy(keys), torch.from_numpy(w), 8,
                            torch.from_numpy(prev))
    np.testing.assert_array_equal(_bits(public), _bits(want))
    assert not np.signbit(want).any()       # every -0.0 became +0.0
    # In place, an untouched cell keeps its -0.0: in place is for grids
    # that hold none, as every deposit grid does.
    into = torch.from_numpy(prev.copy())
    sk, perm = pm.sort_keys(torch.from_numpy(keys))
    pm.deposit_runs_plain(sk, perm, torch.from_numpy(w), 8, into=into)
    assert np.signbit(into.numpy()[[0, 6]]).all()


@pytest.mark.parametrize("deposit", ["ngp_deposit", "cic_deposit"])
def test_no_deposit_grid_holds_negative_zero(deposit):
    """Weights that cancel in their cells (w and -w at one position):
    a cell that sums to zero holds +0.0, never -0.0, so adding in place
    is exact."""
    pos, w = _inputs(3, 50.0, n=400)
    pos = np.concatenate([pos, pos])
    w = np.concatenate([w, -w])
    grid = getattr(pm, deposit)(torch.from_numpy(pos), torch.from_numpy(w),
                                16, 50.0).numpy()
    zeros = grid[grid == 0]
    assert len(zeros) > grid.size // 2 and not np.signbit(zeros).any()
    chain = _cic_chain(pos, w, 16, 50.0, True).numpy()
    assert not np.signbit(chain[chain == 0]).any()


def test_deposit_launches_rule():
    """One deposit counts one "pm_deposit", a fill always and a long pass
    exactly when n > long_run."""
    r = pm.LONG_RUN
    assert set(pm.LAUNCHES) == {"pm_deposit", "pm_deposit_fill",
                                "pm_deposit_long"}
    assert pm.deposit_launches(r, r) == {"pm_deposit": 1,
                                         "pm_deposit_fill": 1,
                                         "pm_deposit_long": 0}
    assert pm.deposit_launches(r + 1, r)["pm_deposit_long"] == 1
    assert pm.deposit_launches(1)["pm_deposit_long"] == 0
    assert pm.deposit_launches(262144)["pm_deposit_long"] == 1


@pytest.mark.parametrize("n, long_run", [(0, 32), (1, 32), (32, 32),
                                         (33, 32), (262144, 32), (10, 1),
                                         (3000, 4)])
def test_long_list_holds_every_long_run(n, long_run):
    """The long pass's scratch holds the count and the most runs longer
    than long_run that n particles can make: n // (long_run + 1)."""
    assert pm.long_list_size(n, long_run) >= 1 + n // (long_run + 1)
    keys = np.repeat(np.arange(n // (long_run + 1) + 1),
                     long_run + 1)[:n].astype(np.int32)
    assert len(_long_starts(keys, n + 1, long_run)) \
        <= pm.long_list_size(n, long_run) - 1


def test_cpu_path_launches_nothing_and_the_kernel_needs_the_card():
    """On the CPU the deposit is the plain version and counts no launch;
    deposit_sorted, the kernel's wrapper, refuses a CPU tensor."""
    before = dict(pm.LAUNCHES)
    keys, cells, w = _case("ties", pm.LONG_RUN)
    kt, wt = torch.from_numpy(keys), torch.from_numpy(w)
    pm.segment_sum(kt, wt, cells)
    pm.cic_deposit(torch.rand(50, 2), torch.ones(50), 8, 1.0)
    assert pm.LAUNCHES == before
    with pytest.raises(ValueError):
        pm.deposit_sorted(*pm.sort_keys(kt), wt, cells)
    with pytest.raises(ValueError):
        pm.deposit_sorted(*pm.sort_keys(kt), wt, cells, long_run=0)
    with pytest.raises(ValueError):
        pm.deposit_sorted(*pm.sort_keys(kt), wt, cells,
                          into=torch.zeros(cells + 1))
    with pytest.raises(ValueError):
        pm.deposit_sorted(*pm.sort_keys(kt), wt, cells, torch.zeros(cells),
                          into=torch.zeros(cells))
