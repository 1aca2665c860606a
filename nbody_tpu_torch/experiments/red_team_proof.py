"""Red-team proof: cross-machine Reality Stability Index (RSI).

PyTorch counterpart of ``nbody_tpu.experiments.red_team_proof``
(reference: red_team_proof.py:99-804): four measurements composed into a
0-100 RSI score, exported as JSON named per device + SHA hash, with a
two-file comparison mode for cross-substrate runs:

* temporal jitter — per-tick wall time with completion fences; CV and
  3-sigma anomalous tick count (reference: :154-247);
* divergence vs Heisenberg — parallel universes (standard vs
  reversed-sum + fp16), dx*dv vs an "hbar/2" scale, Lyapunov exponent
  (reference: :254-358);
* entropy drift — zlib bits/float over a sustained run (reference: :365-463);
* observer effect — tick rate with/without host transfers (reference: :470-563).

The ticks run on ``--device`` (default ``cuda``; with no card it raises
and names ``--device cpu``). The report's ``platform`` is the device's
type and ``device_kind`` the card's name (``"cpu"`` on the CPU).

Usage:
    python -m nbody_tpu_torch.experiments.red_team_proof --quick
    python -m nbody_tpu_torch.experiments.red_team_proof --compare a.json b.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.diagnostics.glitch import measure_state_entropy
from nbody_tpu_torch.diagnostics.multiverse import MultiverseSim
from nbody_tpu_torch.experiments._common import observer_effect_rates
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.profiler import fence
from nbody_tpu_torch.utils.reproducibility import seed_key

HBAR_SIM = 1e-8  # arbitrary "hbar/2" comparison scale (reference: :300)
JITTER_WARM = 10     # ticks that warm the jitter probe after its first
ENTROPY_CHUNK = 50   # ticks between the entropy drift's samples
DIVERGENCE_MAX_STARS = 300


def temporal_jitter_test(num_stars: int, num_ticks: int, seed: int,
                         device=None) -> dict:
    """(reference: red_team_proof.py:154-247)"""
    print("\n--- RSI 1: TEMPORAL JITTER ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                           device=device)
    sim.step(1)  # warm the single-tick launches measured below
    sim.step(JITTER_WARM)
    fence(sim.state.positions)
    times = []
    for _ in range(num_ticks):
        t0 = time.perf_counter_ns()
        sim.step(1)
        fence(sim.state.positions)
        times.append((time.perf_counter_ns() - t0) / 1e6)
    arr = np.asarray(times)
    cv = float(arr.std() / arr.mean())
    anomalous = int((np.abs(arr - arr.mean()) > 3 * arr.std()).sum())
    print(f"  mean {arr.mean():.3f} ms, CV={cv:.3f}, "
          f"3-sigma anomalous ticks: {anomalous}/{num_ticks}")
    return {"mean_ms": float(arr.mean()), "cv": cv,
            "anomalous_ticks": anomalous, "num_ticks": num_ticks}


def divergence_test(num_stars: int, num_ticks: int, seed: int,
                    device=None) -> dict:
    """(reference: red_team_proof.py:254-358)"""
    print("\n--- RSI 2: DIVERGENCE vs HEISENBERG ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    mv = MultiverseSim(pos, vel, m, device=device)
    rep = mv.run(num_ticks=num_ticks, interval=max(num_ticks // 8, 10))
    above_hbar = rep.heisenberg_product > HBAR_SIM
    print(f"  dx*dv = {rep.heisenberg_product:.3e} vs hbar/2 ~ {HBAR_SIM}")
    print(f"  Lyapunov: {rep.lyapunov_reversed:+.4f}/tick")
    return {"heisenberg_product": rep.heisenberg_product,
            "above_hbar": bool(above_hbar),
            "lyapunov": rep.lyapunov_reversed,
            "final_divergence": rep.divergence_reversed[-1]}


def entropy_drift_test(num_stars: int, duration_s: float, seed: int,
                       device=None) -> dict:
    """(reference: red_team_proof.py:365-463): int4 chunks of
    ENTROPY_CHUNK ticks for ``duration_s``, a sample after each; how many
    ran depends on the device's speed (``samples``)."""
    print("\n--- RSI 3: ENTROPY DRIFT ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    sim = DirectSimulation(pos, vel, m, precision=Precision.INT4_SIM,
                           device=device)
    rows = []
    t_end = time.monotonic() + duration_s
    while time.monotonic() < t_end:
        sim.step(ENTROPY_CHUNK)
        ent = measure_state_entropy(sim.positions, sim.velocities)
        rows.append(ent.bits_per_float)
    drift = rows[-1] - rows[0] if len(rows) >= 2 else 0.0
    print(f"  {len(rows)} samples, bits/float {rows[0]:.2f} -> {rows[-1]:.2f} "
          f"(drift {drift:+.3f})")
    return {"samples": len(rows), "bits_first": rows[0],
            "bits_last": rows[-1], "drift": drift}


def observer_effect_test(num_stars: int, num_ticks: int, seed: int,
                         device=None) -> dict:
    """(reference: red_team_proof.py:470-563)"""
    print("\n--- RSI 4: OBSERVER EFFECT ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    rate_free, rate_obs = observer_effect_rates(pos, vel, m, num_ticks,
                                                device=device)
    slowdown = (1.0 - rate_obs / rate_free) * 100.0
    print(f"  unobserved {rate_free:.0f} ticks/s, observed {rate_obs:.0f} "
          f"ticks/s -> slowdown {slowdown:+.1f}%")
    return {"rate_unobserved": rate_free, "rate_observed": rate_obs,
            "slowdown_percent": slowdown}


def compute_rsi(jitter, divergence, entropy, observer) -> float:
    """Weighted composite 0-100 (reference: red_team_proof.py:570-607)."""
    jitter_score = max(0.0, 1.0 - jitter["cv"])
    div_score = max(0.0, 1.0 - min(divergence["final_divergence"] * 1e3,
                                   1.0))
    entropy_score = max(0.0, 1.0 - min(abs(entropy["drift"]), 1.0))
    observer_score = max(0.0, 1.0 - max(observer["slowdown_percent"],
                                        0.0) / 100.0)
    return 100.0 * (0.3 * jitter_score + 0.3 * div_score
                    + 0.2 * entropy_score + 0.2 * observer_score)


def suite_sizes(quick: bool) -> dict:
    """Each probe's size at --quick or at the full defaults
    (red_team_proof.py:125-137 of the JAX package)."""
    n = 200 if quick else 400
    ticks = 60 if quick else 150
    return {"stars": n, "jitter_ticks": ticks,
            "divergence_stars": min(n, DIVERGENCE_MAX_STARS),
            "divergence_ticks": ticks,
            "entropy_s": 3.0 if quick else 10.0,
            "observer_ticks": ticks * 2}


def run_rsi(quick: bool, seed: int, out_dir: str, device=None) -> dict:
    device = _resolve_device(device)
    s = suite_sizes(quick)
    n = s["stars"]
    report = {
        "platform": device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else device.type),
        "temporal_jitter": temporal_jitter_test(n, s["jitter_ticks"], seed,
                                                device),
        "divergence": divergence_test(s["divergence_stars"],
                                      s["divergence_ticks"], seed, device),
        "entropy_drift": entropy_drift_test(n, s["entropy_s"], seed,
                                            device),
        "observer_effect": observer_effect_test(n, s["observer_ticks"],
                                                seed, device),
    }
    report["rsi"] = compute_rsi(report["temporal_jitter"],
                                report["divergence"],
                                report["entropy_drift"],
                                report["observer_effect"])
    payload = json.dumps(report, indent=2, default=str)
    report["sha256"] = hashlib.sha256(payload.encode()).hexdigest()[:16]
    print(f"\n  REALITY STABILITY INDEX: {report['rsi']:.1f}/100 "
          f"(hash {report['sha256']})")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fname = out / f"rsi_{report['device_kind'].replace(' ', '_')}.json"
    fname.write_text(json.dumps(report, indent=2, default=str))
    print(f"  written to {fname}")
    return report


def compare_rsi_files(path_a: str, path_b: str):
    """Two-machine comparison (reference: red_team_proof.py:727-774)."""
    a = json.loads(Path(path_a).read_text())
    b = json.loads(Path(path_b).read_text())
    print(f"\nRSI COMPARISON: {a['device_kind']} vs {b['device_kind']}")
    print(f"  RSI: {a['rsi']:.1f} vs {b['rsi']:.1f} "
          f"(delta {abs(a['rsi'] - b['rsi']):.1f})")
    la = a["divergence"]["lyapunov"]
    lb = b["divergence"]["lyapunov"]
    print(f"  Lyapunov: {la:+.4f} vs {lb:+.4f}")
    if la and lb and abs(la - lb) / max(abs(la), abs(lb), 1e-12) < 0.1:
        print("  -> Lyapunov rates agree within 10%: candidate 'universal "
              "constant' across substrates")
    else:
        print("  -> Lyapunov rates differ: substrate-dependent chaos")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Red-team RSI proof")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/red_team")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"),
                   help="compare two rsi_*.json files")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.compare:
        compare_rsi_files(*args.compare)
        return None
    device = _resolve_device(args.device)
    print("\n" + "=" * 60)
    print("RED TEAM PROOF: Reality Stability Index")
    print("=" * 60)
    return run_rsi(args.quick, args.seed, args.output, device)


if __name__ == "__main__":
    main()
