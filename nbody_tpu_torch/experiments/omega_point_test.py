"""Omega point test: the "final boss" — map the coordinates where the
simulated universe breaks down.

PyTorch counterpart of ``nbody_tpu.experiments.omega_point_test``
(reference: omega_point_test.py:173-1233):

* **BekensteinBoundTest** — pack density upward until throughput collapses
  (the "digital black hole", reference: :173-324);
* **TemporalAliasingTest** — log-spaced dt sweep, find the critical dt and
  the sharpness of the stability phase transition (reference: :331-443);
* **EntropyLeakTest** — sustained int4 run: ghost-energy injection rate
  and extrapolated "time to heat death" (reference: :450-588);
* **PhaseSpaceScanner** — (precision x velocity x density) grid with
  butterfly detection via 1e-5-perturbed twin runs (reference: :595-766;
  the reference's 1e-10 seed perturbation is below f32 resolution — the
  smallest representable nudge is used instead);
* **TriplePointHunter** — average the boundary points into breakdown
  coordinates with physical-constant analogies (reference: :773-908);
* simulation-probability score (reference: :1046-1183).

The ticks run on ``--device`` (default ``cuda``; with no card it raises
and names ``--device cpu``); the heatmap is skipped, saying so, where
matplotlib is not installed.

Usage:
    python -m nbody_tpu_torch.experiments.omega_point_test --quick
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.experiments._common import plot_or_skip, to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.profiler import fence
from nbody_tpu_torch.utils.reproducibility import seed_key

BEKENSTEIN_RADII = [10.0, 5.0, 2.0, 1.0, 0.5, 0.2]
PROBE_TICKS = 100          # ticks a Bekenstein / aliasing / phase run
ENTROPY_CHECKPOINTS = 10   # energy samples over the entropy leak's run
PHASE_PRECISIONS = [Precision.FLOAT32, Precision.INT8_SIM,
                    Precision.INT4_SIM]
PHASE_RADII = [10.0, 2.0]
BUTTERFLY_NUDGE = 1e-5


def suite_sizes(quick: bool) -> dict:
    """Each probe's size at --quick or at the full defaults
    (omega_point_test.py:41-160 of the JAX package)."""
    return {"bekenstein_stars": 300 if quick else 600,
            "aliasing_stars": 200 if quick else 400,
            "aliasing_dts": 12 if quick else 25,
            "entropy_stars": 300 if quick else 600,
            "entropy_ticks": 2000 if quick else 50000,
            "phase_stars": 150 if quick else 300,
            "phase_vel_mults": [1.0, 5.0] if quick else [1.0, 5.0, 20.0]}


def finite(sim: DirectSimulation) -> bool:
    return bool(torch.isfinite(sim.positions).all())


def bekenstein_bound_test(quick: bool, seed: int, device=None) -> dict:
    """(reference: omega_point_test.py:173-324)"""
    print("\n--- OMEGA 1: BEKENSTEIN BOUND (digital black hole) ---")
    rows = []
    n = suite_sizes(quick)["bekenstein_stars"]
    for radius in BEKENSTEIN_RADII:
        pos, vel, m = create_disk_galaxy(seed_key(seed), n,
                                         galaxy_radius=radius)
        sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                               device=device)
        sim.step(PROBE_TICKS)  # warm the launches timed below
        fence(sim.state.positions)
        t0 = time.perf_counter()
        sim.step(PROBE_TICKS)
        fence(sim.state.positions)
        tps = PROBE_TICKS / (time.perf_counter() - t0)
        density = n / (radius * radius)
        stable = finite(sim)
        rows.append({"radius": radius, "density": density,
                     "ticks_per_sec": tps, "stable": stable})
        print(f"  r={radius:5.1f} (rho={density:9.1f}): {tps:8.1f} ticks/s"
              + ("" if stable else "  BROKE"))
    tps0 = rows[0]["ticks_per_sec"]
    collapse = next((r for r in rows
                     if r["ticks_per_sec"] < tps0 * 0.5 or not r["stable"]),
                    None)
    return {"rows": rows,
            "collapse_density": collapse["density"] if collapse else None}


def temporal_aliasing_test(quick: bool, seed: int, device=None) -> dict:
    """(reference: omega_point_test.py:331-443)"""
    print("\n--- OMEGA 2: TEMPORAL ALIASING (critical dt) ---")
    s = suite_sizes(quick)
    dts = np.logspace(np.log10(0.001), np.log10(5.0), s["aliasing_dts"])
    pos, vel, m = create_disk_galaxy(seed_key(seed), s["aliasing_stars"])
    rows = []
    for dt in dts:
        sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                               dt=float(dt), dynamic_params=True,
                               device=device)
        e0 = sim.get_total_energy()
        sim.step(PROBE_TICKS)
        e1 = sim.get_total_energy()
        drift = abs((e1 - e0) / e0) if abs(e0) > 1e-12 else 0.0
        stable = bool(finite(sim) and drift < 1.0)
        rows.append({"dt": float(dt), "drift": float(drift),
                     "stable": stable})
    critical = next((r["dt"] for r in rows if not r["stable"]), None)
    # sharpness: drift ratio across the transition
    drifts = [max(r["drift"], 1e-12) for r in rows]
    sharpness = float(np.max(np.abs(np.diff(np.log10(drifts)))))
    print(f"  critical dt: {critical}, transition sharpness "
          f"(max decade jump): {sharpness:.1f}")
    return {"rows": rows, "critical_dt": critical, "sharpness": sharpness}


def entropy_leak_test(quick: bool, seed: int, device=None) -> dict:
    """(reference: omega_point_test.py:450-588). Full mode runs the
    reference's 50k-tick horizon."""
    print("\n--- OMEGA 3: ENTROPY LEAK (time to heat death) ---")
    s = suite_sizes(quick)
    ticks = s["entropy_ticks"]
    pos, vel, m = create_disk_galaxy(seed_key(seed), s["entropy_stars"])
    sim = DirectSimulation(pos, vel, m, precision=Precision.INT4_SIM,
                           device=device)
    e0 = sim.get_total_energy()
    energies, checkpoints = [], []
    chunk = ticks // ENTROPY_CHECKPOINTS
    for k in range(ENTROPY_CHECKPOINTS):
        sim.step(chunk)
        energies.append(sim.get_total_energy())
        checkpoints.append((k + 1) * chunk)
    rate_per_tick = (energies[-1] - e0) / abs(e0) / ticks
    # "heat death": when injected ghost energy ~ |E0| (drift = 100%)
    ticks_to_heat_death = (1.0 / rate_per_tick if rate_per_tick > 0
                           else float("inf"))
    print(f"  ghost energy rate: {rate_per_tick * 100:.5f}%/tick -> "
          f"heat death in ~{ticks_to_heat_death:,.0f} ticks")
    return {"ticks": checkpoints, "energies": energies,
            "rate_per_tick": rate_per_tick,
            "ticks_to_heat_death": ticks_to_heat_death}


def phase_space_scanner(quick: bool, seed: int, device=None) -> dict:
    """(reference: omega_point_test.py:595-766)"""
    print("\n--- OMEGA 4: PHASE SPACE SCANNER ---")
    s = suite_sizes(quick)
    n = s["phase_stars"]
    cells = []
    for prec in PHASE_PRECISIONS:
        for vm in s["phase_vel_mults"]:
            for radius in PHASE_RADII:
                pos, vel, m = create_disk_galaxy(seed_key(seed), n,
                                                 galaxy_radius=radius)
                sim = DirectSimulation(pos, vel * vm, m, precision=prec,
                                       device=device)
                # butterfly twin: smallest representable nudge
                pos_b = pos.clone()
                pos_b[0, 0] += BUTTERFLY_NUDGE
                twin = DirectSimulation(pos_b, vel * vm, m, precision=prec,
                                        device=device)
                e0 = sim.get_total_energy()
                sim.step(PROBE_TICKS)
                twin.step(PROBE_TICKS)
                drift = abs((sim.get_total_energy() - e0) / e0)
                butterfly = float(np.abs(
                    to_host(sim.positions) - to_host(twin.positions)).mean())
                stable = bool(finite(sim) and drift < 1.0)
                cells.append({
                    "precision": prec.value, "vel_mult": vm,
                    "radius": radius, "drift": float(drift),
                    "butterfly_divergence": butterfly, "stable": stable})
    unstable = [c for c in cells if not c["stable"]]
    print(f"  scanned {len(cells)} phase-space cells, "
          f"{len(unstable)} unstable")
    return {"cells": cells, "unstable_count": len(unstable)}


def triple_point_hunter(bek, temporal, phase) -> dict:
    """(reference: omega_point_test.py:773-908)"""
    print("\n--- OMEGA 5: TRIPLE POINT HUNTER ---")
    coords = {
        "critical_density": bek.get("collapse_density"),
        "critical_dt": temporal.get("critical_dt"),
        "unstable_fraction": (phase["unstable_count"]
                              / max(len(phase["cells"]), 1)),
    }
    analogies = {
        "critical_dt <-> Planck time": coords["critical_dt"],
        "critical_density <-> Bekenstein bound": coords["critical_density"],
        "speed limit <-> c (see crash_point_test)": 100.0,
    }
    for k, v in analogies.items():
        print(f"  {k}: {v}")
    return {"breakdown_coordinates": coords, "analogies": analogies}


PRECISION_BITS = {"float32": 32, "int8_sim": 8, "int4_sim": 4}

# physical anchors (reference: omega_point_test.py:40-43, :984-1039)
C_LIGHT = 2.998e8            # m/s
PLANCK_TIME = 5.391e-44      # s
PLANCK_LENGTH = 1.616e-35    # m
FP32_MIN_SUBNORMAL = 1.4e-45


def generate_reality_heatmap(cells, output_path) -> str:
    """3-D stability map + the three 2-D projections
    (reference: omega_point_test.py:915-977), rendered headless."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    print("\n  Generating reality heatmap...")
    bits = [PRECISION_BITS.get(c["precision"], 32) for c in cells]
    vels = [c["vel_mult"] for c in cells]
    dens = [c["radius"] for c in cells]  # proxy axis: packing radius
    drifts = [min(c["drift"] * 100, 100.0) for c in cells]
    colors = ["#2ecc71" if c["stable"] else "#e74c3c" for c in cells]
    sizes = [max(10, min(100, d)) for d in drifts]

    fig = plt.figure(figsize=(16, 12))
    ax1 = fig.add_subplot(2, 2, 1, projection="3d")
    ax1.scatter(bits, vels, dens, c=colors, s=sizes, alpha=0.6)
    ax1.set_xlabel("Precision (bits)")
    ax1.set_ylabel("Velocity (x)")
    ax1.set_zlabel("Packing radius")
    ax1.set_title("Reality Stability Map\n(green=stable, red=unstable)")

    for idx, (x, y, xl, yl) in enumerate(
            [(bits, vels, "Precision (bits)", "Velocity (x)"),
             (vels, dens, "Velocity (x)", "Packing radius"),
             (bits, dens, "Precision (bits)", "Packing radius")],
            start=2):
        ax = fig.add_subplot(2, 2, idx)
        sc = ax.scatter(x, y, c=drifts, cmap="hot", s=50, alpha=0.7)
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        fig.colorbar(sc, ax=ax, label="Energy drift %")
    fig.suptitle("OMEGA POINT - Reality Phase Space", fontweight="bold")
    fig.tight_layout()
    fig.savefig(output_path, dpi=120)
    plt.close(fig)
    print(f"  saved to {output_path}")
    return str(output_path)


def generate_physical_comparison(bek, temporal, entropy, phase) -> dict:
    """Simulation breakdown limits vs physical constants
    (reference: omega_point_test.py:984-1039)."""
    max_stable_v = max((c["vel_mult"] for c in phase["cells"]
                        if c["stable"]), default=0.0)
    comparison = {
        "Max Velocity": {
            "simulation_value": f"{max_stable_v:.1f}x stable ceiling",
            "physical_equivalent": "Speed of light (c)",
            "physical_value": f"{C_LIGHT:.2e} m/s",
        },
        "Time Step (dt)": {
            "simulation_value": (f"{temporal['critical_dt']:.4f} units"
                                 if temporal.get("critical_dt")
                                 else "no breakdown found"),
            "physical_equivalent": "Planck time (t_p)",
            "physical_value": f"{PLANCK_TIME:.2e} s",
        },
        "Min Precision": {
            "simulation_value": f"{FP32_MIN_SUBNORMAL:.2e} (f32 subnormal)",
            "physical_equivalent": "Planck length (l_p)",
            "physical_value": f"{PLANCK_LENGTH:.2e} m",
            "ratio": f"{FP32_MIN_SUBNORMAL / PLANCK_LENGTH:.2e}",
        },
        "Ghost Energy Rate": {
            "simulation_value": f"{entropy['rate_per_tick']:.2e}/tick",
            "physical_equivalent": "Dark energy",
            "physical_value": "68% of universe",
            "sim_equivalent": (
                f"{min(entropy['rate_per_tick'] * 1e4, 10.0):.2%} of "
                "initial energy per 10k ticks"),
        },
        "Max Density": {
            "simulation_value": (
                f"{bek['collapse_density']:.0f} stars/unit^2 collapse"
                if bek.get("collapse_density")
                else "no throughput collapse found"),
            "physical_equivalent": "Bekenstein bound",
            "physical_value": "S <= 2*pi*R*E/(hbar*c)",
        },
    }
    print("\n--- PHYSICAL CONSTANTS COMPARISON ---")
    for k, row in comparison.items():
        print(f"  {k:18s}: {row['simulation_value']:36s} <-> "
              f"{row['physical_equivalent']} ({row['physical_value']})")
    return comparison


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Omega point: breakdown map")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/omega_point")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)

    print("\n" + "=" * 60)
    print("OMEGA POINT TEST: mapping the edges of simulated reality")
    print("=" * 60)
    bek = bekenstein_bound_test(args.quick, args.seed, device)
    temporal = temporal_aliasing_test(args.quick, args.seed, device)
    entropy = entropy_leak_test(args.quick, args.seed, device)
    phase = phase_space_scanner(args.quick, args.seed, device)
    triple = triple_point_hunter(bek, temporal, phase)

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    heatmap = plot_or_skip(generate_reality_heatmap, phase["cells"],
                           out / "reality_heatmap.png")
    constants = generate_physical_comparison(bek, temporal, entropy, phase)

    # simulation-probability score (reference: :1046-1183): fraction of
    # probes that found sharp, constant-like breakdown boundaries.
    findings = [
        bek["collapse_density"] is not None,
        temporal["critical_dt"] is not None,
        entropy["rate_per_tick"] > 0,
        phase["unstable_count"] > 0,
    ]
    prob = sum(findings) / len(findings)
    print(f"\n  SIMULATION PROBABILITY SCORE: {prob:.0%} of probes found "
          "hard breakdown boundaries")

    report = {"bekenstein": bek, "temporal_aliasing": temporal,
              "entropy_leak": entropy, "phase_space": phase,
              "triple_point": triple,
              "physical_comparison": constants,
              "reality_heatmap": heatmap,
              "simulation_probability": prob}
    (out / "omega_point_report.json").write_text(
        json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()
