"""Shared helpers for the experiment CLIs (L8 layer).

PyTorch counterpart of ``nbody_tpu.experiments._common``: the verdict
helpers run on host numpy, as in JAX; ``observer_effect_rates`` times
``DirectSimulation`` on its device, fenced with ``utils.profiler.fence``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nbody_tpu_torch.models.direct import DirectSimulation
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.profiler import fence


def to_host(x) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def detect_explosion(sim: DirectSimulation, initial_energy: float) -> bool:
    """Explosion predicate (reference: stability_test.py:34-61):
    NaN/Inf state, >1000% energy drift, or bound system gone unbound."""
    finite = (torch.isfinite(sim.positions).all()
              & torch.isfinite(sim.velocities).all())
    if not bool(finite):
        return True
    current = sim.get_total_energy()
    if abs(initial_energy) > 1e-10:
        if abs(current - initial_energy) / abs(initial_energy) > 10.0:
            return True
    if initial_energy < 0 and current > abs(initial_energy):
        return True
    return False


def outer_slope(curve, num_bins_min: int = 4):
    """Linear fit of the outer half of a rotation curve
    (reference: sensitivity_test.py:103-117). Returns (slope, mean_outer_v)."""
    radii = to_host(curve.radii if hasattr(curve, "radii")
                    else curve["radii"]).astype(float)
    vels = to_host(curve.velocities if hasattr(curve, "velocities")
                   else curve["velocities"]).astype(float)
    valid = ~np.isnan(vels)
    radii, vels = radii[valid], vels[valid]
    if len(vels) < num_bins_min:
        return 0.0, 0.0
    mid = len(vels) // 2
    outer_r, outer_v = radii[mid:], vels[mid:]
    if len(outer_r) < 2:
        return 0.0, 0.0
    slope = float(np.polyfit(outer_r, outer_v, 1)[0])
    return slope, float(outer_v.mean())


def radius_percentile(positions, pct: float = 90.0) -> float:
    r = np.sqrt((to_host(positions) ** 2).sum(axis=1))
    return float(np.percentile(r, pct))


def energy_drift_pct(initial: float, final: float) -> float:
    if abs(initial) < 1e-10:
        return 0.0
    return (final - initial) / abs(initial) * 100.0


def observer_effect_rates(positions, velocities, masses, num_ticks: int,
                          chunk: int = 10, repeats: int = 2, device=None):
    """Tick rates with and without per-chunk host 'observation' transfers
    — shared by breakout_tests (lazy loading) and red_team_proof
    (observer effect). Warms the chunk-sized launch sequence first so the
    kernels' build and first launches never land inside the timed
    window."""

    def run(observe: bool) -> float:
        sim = DirectSimulation(positions, velocities, masses,
                               precision=Precision.FLOAT32, device=device)
        sim.step(chunk)  # warm the chunk-sized launches
        fence(sim.state.positions)
        t0 = time.perf_counter()
        for _ in range(num_ticks // chunk):
            sim.step(chunk)
            if observe:
                _ = to_host(sim.positions)  # full-state observation
            else:
                # The same fence kind as the observed arm, so that the
                # only difference between the arms is the full-state
                # transfer itself.
                fence(sim.state.positions)
        return num_ticks / (time.perf_counter() - t0)

    rate_free = max(run(False) for _ in range(repeats))
    rate_obs = max(run(True) for _ in range(repeats))
    return rate_free, rate_obs


def plot_or_skip(plot_fn, *args):
    """``plot_fn(*args)`` (a figure's path), or None with one line that
    says the plots were skipped where matplotlib is not installed; any
    other missing module still raises."""
    try:
        return plot_fn(*args)
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        print("Plots skipped: matplotlib is not installed")
        return None
