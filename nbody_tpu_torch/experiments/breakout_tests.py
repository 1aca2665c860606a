"""Breakout tests: four active-interference probes at reality's seams.

PyTorch counterpart of ``nbody_tpu.experiments.breakout_tests``
(reference: breakout_tests.py:63-776):

1. **Precision wall** — a two-body close approach; rhythmic jitter in the
   separation series (coefficient of variation of per-interval deltas)
   marks the precision floor (reference: :63-208).
2. **Lazy loading** — identical run with/without per-chunk host
   "observation" transfers; >5% slowdown = the universe renders on demand
   (reference: :215-358). On the card this measures the device->host
   snapshot tax directly.
3. **Lattice symmetry** — energy drift for motion along axes vs diagonals;
   a significant difference (two-sample t-test) betrays the grid
   (reference: :365-520; 50x7-direction design condensed).
4. **Memory leak** — precision-cascade / overflow / underflow loops on a
   0-d float32 tensor on the device; record the iteration where values
   die (reference: :527-654). PyTorch keeps IEEE subnormals on the CPU
   and on the card (nothing here flushes them), so the halving loop
   reaches 0 after 150 steps where a flushing device stops at 127.

The ticks run on ``--device`` (default ``cuda``; with no card it raises
and names ``--device cpu``).

Usage:
    python -m nbody_tpu_torch.experiments.breakout_tests --quick
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.experiments._common import observer_effect_rates, to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.reproducibility import seed_key

WALL_CHUNK = 10       # ticks between the precision wall's samples
LATTICE_STARS = 200   # each lattice trial's disk
CASCADE_CHUNK = 10    # round trips between the cascade's host reads


def precision_wall_test(num_ticks: int = 400, device=None) -> dict:
    """(reference: breakout_tests.py:63-208)"""
    print("\n--- BREAKOUT 1: PRECISION WALL ---")
    cfg = SimConfig(G=1.0, softening=1e-4, dt=1e-3)
    pos = torch.tensor([[-1.0, 0.0], [1.0, 0.0]])
    vel = torch.tensor([[0.05, 0.02], [-0.05, -0.02]])
    m = torch.ones(2)
    sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                           cfg=cfg, force_impl="dense", device=device)
    seps = []
    for _ in range(num_ticks // WALL_CHUNK):
        sim.step(WALL_CHUNK)
        p = to_host(sim.positions)
        seps.append(float(np.linalg.norm(p[0] - p[1])))
    deltas = np.abs(np.diff(seps))
    deltas = deltas[deltas > 0]
    cv = float(deltas.std() / deltas.mean()) if len(deltas) > 3 else 0.0
    rhythmic = cv < 0.3  # suspiciously regular stepping
    print(f"  min separation {min(seps):.5f}, delta CV={cv:.3f} "
          f"({'RHYTHMIC (wall suspected)' if rhythmic else 'irregular'})")
    return {"min_separation": min(seps), "delta_cv": cv,
            "rhythmic_jitter": bool(rhythmic)}


def lazy_loading_test(num_stars: int = 500, num_ticks: int = 300,
                      seed: int = 42, device=None) -> dict:
    """(reference: breakout_tests.py:215-358)"""
    print("\n--- BREAKOUT 2: LAZY LOADING (observer effect) ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    rate_free, rate_obs = observer_effect_rates(pos, vel, m, num_ticks,
                                                device=device)
    t_unobserved = num_ticks / rate_free
    t_observed = num_ticks / rate_obs
    overhead = (t_observed / t_unobserved - 1.0) * 100.0
    evidence = overhead > 5.0
    print(f"  unobserved {t_unobserved:.3f}s, observed {t_observed:.3f}s "
          f"-> overhead {overhead:+.1f}% "
          f"({'OBSERVER EFFECT' if evidence else 'no evidence'})")
    return {"unobserved_s": t_unobserved, "observed_s": t_observed,
            "overhead_percent": overhead, "observer_effect": bool(evidence)}


def lattice_symmetry_test(trials: int = 12, num_ticks: int = 150,
                          seed: int = 42, device=None) -> dict:
    """(reference: breakout_tests.py:365-520)"""
    print("\n--- BREAKOUT 3: LATTICE SYMMETRY ---")
    angles_axis = [0.0, math.pi / 2, math.pi, 3 * math.pi / 2]
    angles_diag = [math.pi / 4, 3 * math.pi / 4, 5 * math.pi / 4]

    def drift_for_angle(angle: float, trial: int) -> float:
        pos, vel, m = create_disk_galaxy(seed_key(seed + trial),
                                         LATTICE_STARS)
        boost = 0.5 * torch.tensor([math.cos(angle), math.sin(angle)])
        sim = DirectSimulation(pos, vel + boost[None, :], m,
                               precision=Precision.FLOAT32, device=device)
        e0 = sim.get_total_energy()
        sim.step(num_ticks)
        return abs((sim.get_total_energy() - e0) / e0)

    axis_drifts, diag_drifts = [], []
    for t in range(trials):
        axis_drifts.append(drift_for_angle(
            angles_axis[t % len(angles_axis)], t))
        diag_drifts.append(drift_for_angle(
            angles_diag[t % len(angles_diag)], t))
    a, d = np.asarray(axis_drifts), np.asarray(diag_drifts)
    try:
        from scipy import stats
        t_stat, p_val = stats.ttest_ind(a, d, equal_var=False)
        t_stat, p_val = float(t_stat), float(p_val)
    except Exception:
        pooled = math.sqrt(a.var(ddof=1) / len(a) + d.var(ddof=1) / len(d))
        t_stat = float((a.mean() - d.mean()) / max(pooled, 1e-12))
        p_val = 1.0
    anisotropic = p_val < 0.05
    print(f"  axis drift {a.mean():.2e} +/- {a.std():.1e}, "
          f"diagonal {d.mean():.2e} +/- {d.std():.1e}")
    print(f"  t={t_stat:.2f}, p={p_val:.3f} "
          f"({'LATTICE DETECTED' if anisotropic else 'isotropic'})")
    return {"axis_mean": float(a.mean()), "diag_mean": float(d.mean()),
            "t_stat": t_stat, "p_value": p_val,
            "anisotropic": bool(anisotropic)}


def cascade(v: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` inexact round trips (v / 3) * 3 on the device, each a
    division and a multiplication of their own (two launches, nothing
    fused into an FMA): each rounds once."""
    for _ in range(steps):
        v = torch.mul(torch.div(v, 3.0), 3.0)
    return v


def memory_leak_test(max_iters: int = 200, device=None) -> dict:
    """(reference: breakout_tests.py:527-654): where do the cascade loops
    die? (precision cascade /3 *3, overflow x2, underflow x0.5 on a 0-d
    float32 tensor on ``device``, read on the host each step)."""
    print("\n--- BREAKOUT 4: MEMORY LEAK / VALUE DEATH ---")
    device = _resolve_device(device)

    def one():
        return torch.ones((), dtype=torch.float32, device=device)

    results = {}
    # precision cascade: how many round trips until the drift random walk
    # crosses 1e-6 relative?
    drifted_at = None
    v = one()
    for i in range(max_iters):
        v = cascade(v, CASCADE_CHUNK)
        if abs(float(v) - 1.0) > 1e-6:
            drifted_at = (i + 1) * CASCADE_CHUNK
            break
    results["precision_cascade_drift_iter"] = drifted_at
    results["precision_cascade_final_drift"] = abs(float(v) - 1.0)

    # overflow: x *= 2 until inf
    v = one()
    inf_at = None
    for i in range(max_iters):
        v = v * 2.0
        if not math.isfinite(float(v)):
            inf_at = i + 1
            break
    results["overflow_inf_iter"] = inf_at

    # underflow: x *= 0.5 until 0
    v = one()
    zero_at = None
    for i in range(max_iters):
        v = v * 0.5
        if float(v) == 0.0:
            zero_at = i + 1
            break
    results["underflow_zero_iter"] = zero_at
    print(f"  overflow -> inf after {inf_at} doublings (f32 max ~2^128)")
    print(f"  underflow -> 0 after {zero_at} halvings "
          f"(FTZ: 127 if flushed, 150 with denormals)")
    results["ftz_detected"] = bool(zero_at is not None and zero_at <= 130)
    return results


def suite_sizes(quick: bool) -> dict:
    """Each probe's size at --quick or at the full defaults
    (breakout_tests.py:182-191 of the JAX package)."""
    ticks = 150 if quick else 300
    return {"wall_ticks": ticks, "lazy_stars": 300 if quick else 500,
            "lazy_ticks": ticks, "lattice_trials": 8 if quick else 12,
            "lattice_ticks": 100 if quick else 150}


def run_all_breakout_tests(quick: bool = False, seed: int = 42,
                           device=None) -> dict:
    """(reference: breakout_tests.py:661-750)"""
    device = _resolve_device(device)
    s = suite_sizes(quick)
    report = {
        "precision_wall": precision_wall_test(s["wall_ticks"], device),
        "lazy_loading": lazy_loading_test(s["lazy_stars"], s["lazy_ticks"],
                                          seed, device),
        "lattice_symmetry": lattice_symmetry_test(s["lattice_trials"],
                                                  s["lattice_ticks"], seed,
                                                  device),
        "memory_leak": memory_leak_test(device=device),
    }
    evidence = sum([
        report["precision_wall"]["rhythmic_jitter"],
        report["lazy_loading"]["observer_effect"],
        report["lattice_symmetry"]["anisotropic"],
        report["memory_leak"]["ftz_detected"],
    ])
    report["verdict"] = {
        "evidence_count": evidence,
        "conclusion": (f"{evidence}/4 probes returned positive evidence of "
                       "substrate artifacts"),
    }
    print(f"\nAGGREGATE: {report['verdict']['conclusion']}")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Breakout test suite")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/breakout")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)

    print("\n" + "=" * 60)
    print("BREAKOUT TESTS: active interference probes")
    print("=" * 60)
    report = run_all_breakout_tests(args.quick, args.seed, device)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "breakout_results.json").write_text(
        json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()
