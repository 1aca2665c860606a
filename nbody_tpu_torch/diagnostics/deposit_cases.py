"""Adversarial cell keys for the deposit kernel's run-centric design.

``csrc/pm_deposit.cu`` gives a run of sorted particles (one cell's) to one
thread when it is at most ``long_run`` long and to a block otherwise, so
its edges are the run lengths ``long_run`` and ``long_run + 1``, runs at
the first and the last sorted index, runs that straddle the run pass's
256-particle blocks and the long pass's 896-weight pieces, empty cells,
one cell, and one particle. ``deposit_key_cases`` builds each from a seed,
in a shuffled particle order (the deposit's sort puts ties back in
particle order), with weights whose sums depend on their order.
"""

from __future__ import annotations

import numpy as np


def _runs(rng, lengths, cells: int, spacing: int = 1) -> np.ndarray:
    """Keys of runs of the given lengths in increasing cells (every
    ``spacing``-th cell from a random offset), shuffled."""
    first = int(rng.integers(0, max(1, cells - spacing * len(lengths))))
    keys = np.repeat(first + spacing * np.arange(len(lengths)), lengths)
    return rng.permutation(keys).astype(np.int32)


def _fill(lengths, n: int) -> list:
    """The lengths cycled until they hold n particles, the last cut."""
    out, total, i = [], 0, 0
    while total < n:
        out.append(min(lengths[i % len(lengths)], n - total))
        total += out[-1]
        i += 1
    return out


def deposit_key_cases(n: int, cells: int, long_run: int,
                      seed: int = 0) -> list:
    """[(name, keys int32 (n,) or (1,), cells)] for a deposit of n
    particles into ``cells`` cells (cells >= n // long_run)."""
    rng = np.random.default_rng(seed)
    r = long_run
    cases = [("one_cell", np.full(n, cells // 2, np.int32), cells)]
    for name, length in (("runs_R", r), ("runs_R1", r + 1)):
        cases.append((name, _runs(rng, _fill([length], n), cells,
                                  spacing=max(1, cells // (n // length + 1))),
                      cells))
    rest = rng.integers(1, cells, n - n // 4).astype(np.int32)
    cases.append(("long_first", rng.permutation(np.concatenate(
        [np.zeros(n // 4, np.int32), rest])), cells))
    rest = rng.integers(0, cells - 1, n - n // 4).astype(np.int32)
    cases.append(("long_last", rng.permutation(np.concatenate(
        [np.full(n // 4, cells - 1, np.int32), rest])), cells))
    alternating = _fill([3 * r + 5, 1, 2 * r + 1, r, r + 1, 7], n)
    cases.append(("alternating", _runs(rng, alternating, cells,
                                       spacing=max(1, cells // (n + 1))),
                  cells))
    # Most cells empty, and empty stretches before, between and after.
    sparse = rng.choice(np.arange(cells // 3, 2 * cells // 3, 7),
                        size=min(n, 64), replace=False)
    cases.append(("sparse", rng.choice(sparse, n).astype(np.int32), cells))
    ties = _fill(list(rng.integers(1, 3 * r, 64)), n)
    cases.append(("ties", _runs(rng, ties, cells), cells))
    straddle = _fill(list(rng.integers(r + 1, 2000, 64)), n)
    cases.append(("straddle", _runs(rng, straddle, cells), cells))
    cases.append(("cells1", np.zeros(n, np.int32), 1))
    cases.append(("n1", np.array([cells - 1], np.int32), cells))
    return cases


def case_weights(n: int, seed: int = 0) -> np.ndarray:
    """float32 weights over six decades, both signs: a sum in another
    order rounds differently."""
    rng = np.random.default_rng(seed + 1)
    return (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
            ).astype(np.float32)
