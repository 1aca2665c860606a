"""Reality glitch tests: four probes for simulation artifacts.

PyTorch counterpart of ``nbody_tpu.experiments.reality_glitch_tests``
(reference: reality_glitch_tests.py:63-1255):

1. **Subnormal singularity** — drive softening toward the denormal range
   with forced subnormal injection; census + performance-cliff timing
   (reference: :85-131). PyTorch keeps IEEE subnormals on the CPU and on
   the card (nothing here flushes them), so the injection makes 2 x
   INJECTED denormals where a flushing device makes none; the census is
   taken after each chunk's ticks, whose first kick has made them normal
   again either way, and ``ftz_detected`` (JAX's key: the census stayed
   0) reads that census, not the device's rounding mode.
2. **Multiverse divergence** — reversed-summation and fp16 twins
   (reference: :148-256) via diagnostics.multiverse.
3. **Entropy horizon** — zlib compression ratio / bits-per-float drift
   (reference: :273-298).
4. **Spatial aliasing** — projectile faster than wall-thickness/dt clips
   through a particle wall (reference: :315-437).

The ticks run on ``--device`` (default ``cuda``; with no card it raises
and names ``--device cpu``). ``--animate`` runs the four-panel dashboard;
where matplotlib is not installed it steps the probes, renders nothing
and says so once.

Usage:
    python -m nbody_tpu_torch.experiments.reality_glitch_tests --quick
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics.glitch import (
    count_subnormals,
    measure_state_entropy,
)
from nbody_tpu_torch.diagnostics.multiverse import MultiverseSim
from nbody_tpu_torch.experiments._common import to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.anim import has_matplotlib
from nbody_tpu_torch.utils.profiler import fence
from nbody_tpu_torch.utils.reproducibility import seed_key

STRESS_SOFTENING = 1e-18  # the subnormal probes' softening
INJECTED = 10             # stars whose velocity is scaled by 1e-40
SUBNORMAL_CHUNK = 20
ENTROPY_CHUNK = 50


def inject_subnormals(sim: DirectSimulation) -> None:
    """Scale the first INJECTED stars' velocities by 1e-40 (reference:
    reality_glitch_tests.py:105-109): float32 subnormals where kept."""
    vel = sim.state.velocities.clone()
    vel[:INJECTED] *= 1e-40
    sim.state = sim.state._replace(velocities=vel)


# --------------------------------------------------------------------------
# 1. Subnormal singularity
# --------------------------------------------------------------------------

def subnormal_singularity_test(num_stars: int = 300, num_ticks: int = 200,
                               seed: int = 42, device=None) -> dict:
    """(reference: reality_glitch_tests.py:85-131)"""
    print("\n--- TEST 1: SUBNORMAL SINGULARITY ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                           cfg=SimConfig(softening=STRESS_SOFTENING),
                           device=device)
    timings, census = [], []
    for chunk in range(num_ticks // SUBNORMAL_CHUNK):
        inject_subnormals(sim)
        t0 = time.perf_counter()
        sim.step(SUBNORMAL_CHUNK)
        fence(sim.state.positions)
        timings.append((time.perf_counter() - t0) * 1e3)
        sm = count_subnormals(sim.state.velocities)
        census.append(int(sm.subnormal_count))
        print(f"  chunk {chunk}: {timings[-1]:7.1f} ms, "
              f"subnormals={census[-1]}, zeros={int(sm.zero_count)}")
    cliff = (max(timings) / max(min(timings), 1e-9)) if timings else 1.0
    result = {
        "timings_ms": timings,
        "subnormal_counts": census,
        "performance_cliff_ratio": cliff,
        "ftz_detected": max(census) == 0,
        "verdict": ("no subnormal in the velocities after any chunk "
                    "(census 0): no denormal flood, no slowdown cliff"
                    if max(census) == 0 else
                    f"denormals survive; cliff ratio {cliff:.1f}x"),
    }
    print(f"  {result['verdict']}")
    return result


# --------------------------------------------------------------------------
# 2. Multiverse divergence
# --------------------------------------------------------------------------

def multiverse_divergence_test(num_stars: int = 300, num_ticks: int = 200,
                               seed: int = 42, device=None) -> dict:
    """(reference: reality_glitch_tests.py:148-256)"""
    print("\n--- TEST 2: MULTIVERSE DIVERGENCE ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    mv = MultiverseSim(pos, vel, m, device=device)
    report = mv.run(num_ticks=num_ticks, interval=max(num_ticks // 10, 10))
    print(f"  |A-B| (reversed sum) final: {report.divergence_reversed[-1]:.3e}")
    print(f"  |A-C| (fp16)         final: {report.divergence_fp16[-1]:.3e}")
    print(f"  Lyapunov (reversed): {report.lyapunov_reversed:+.4f}/tick")
    print(f"  Lyapunov (fp16):     {report.lyapunov_fp16:+.4f}/tick")
    print(f"  Heisenberg-like dx*dv: {report.heisenberg_product:.3e}")
    return {
        "ticks": report.ticks,
        "divergence_reversed": report.divergence_reversed,
        "divergence_fp16": report.divergence_fp16,
        "lyapunov_reversed": report.lyapunov_reversed,
        "lyapunov_fp16": report.lyapunov_fp16,
        "entropy_bits_a": report.entropy_bits_a,
        "entropy_bits_b": report.entropy_bits_b,
        "heisenberg_product": report.heisenberg_product,
        "chaotic_amplification": report.lyapunov_reversed > 0,
    }


# --------------------------------------------------------------------------
# 3. Entropy horizon
# --------------------------------------------------------------------------

def entropy_horizon_test(num_stars: int = 500, num_ticks: int = 300,
                         seed: int = 42, device=None) -> dict:
    """(reference: reality_glitch_tests.py:273-298)"""
    print("\n--- TEST 3: ENTROPY HORIZON ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    sim = DirectSimulation(pos, vel, m, precision=Precision.INT4_SIM,
                           device=device)
    rows = []
    for chunk in range(num_ticks // ENTROPY_CHUNK):
        sim.step(ENTROPY_CHUNK)
        ent = measure_state_entropy(sim.positions, sim.velocities)
        rows.append({"tick": sim.tick,
                     "compression_ratio": ent.compression_ratio,
                     "bits_per_float": ent.bits_per_float})
        print(f"  tick {sim.tick:4d}: ratio={ent.compression_ratio:.3f} "
              f"bits/float={ent.bits_per_float:.2f}")
    drift = (rows[-1]["bits_per_float"] - rows[0]["bits_per_float"]
             if len(rows) >= 2 else 0.0)
    print(f"  entropy drift: {drift:+.3f} bits/float over the run")
    return {"rows": rows, "bits_per_float_drift": drift}


# --------------------------------------------------------------------------
# 4. Spatial aliasing
# --------------------------------------------------------------------------

def wall_heights(wall_stars: int) -> torch.Tensor:
    """The wall's y coordinates: uniform on [-10, 10) from a generator
    seeded 0."""
    return torch.rand(wall_stars, generator=seed_key(0)) * 20.0 - 10.0


def spatial_aliasing_test(wall_stars: int = 200, v_projectile: float = 50.0,
                          dt: float = 0.1, num_ticks: int = 60,
                          device=None) -> dict:
    """(reference: reality_glitch_tests.py:315-437): wall at x=0 with
    thickness << v*dt; a projectile should clip straight through. The
    projectile is read on the host every tick."""
    print("\n--- TEST 4: SPATIAL ALIASING ---")
    wall_y = wall_heights(wall_stars)
    wall = torch.stack([torch.zeros(wall_stars), wall_y], dim=1)
    # offset chosen so tick samples straddle (not land on) the wall plane
    projectile = torch.tensor([[-28.7, 0.0]])
    positions = torch.cat([wall, projectile])
    velocities = torch.zeros_like(positions)
    velocities[-1, 0] = v_projectile
    masses = torch.ones(wall_stars + 1)
    masses[-1] = 10.0

    sim = DirectSimulation(positions, velocities, masses,
                           precision=Precision.FLOAT32,
                           cfg=SimConfig(dt=dt, softening=0.1),
                           device=device)
    step_distance = v_projectile * dt
    interaction_range = 0.5
    min_dist, crossed_tick = float("inf"), None
    sampled_inside_wall = False
    for t in range(num_ticks):
        x_before = float(sim.positions[-1, 0])
        sim.step(1)
        pos = sim.positions
        x_after = float(pos[-1, 0])
        # Did the discrete trajectory ever SAMPLE a point inside the
        # wall's interaction slab |x| < range? If not, the wall never had
        # a tick in which to act — the aliasing "tunnel".
        if abs(x_after) < interaction_range:
            sampled_inside_wall = True
        d = float(torch.min(torch.linalg.vector_norm(pos[:-1] - pos[-1],
                                                     dim=1)))
        min_dist = min(min_dist, d)
        if crossed_tick is None and x_before < 0.0 <= x_after:
            crossed_tick = t
            print(f"  projectile crossed the wall plane at tick {t} "
                  f"(jump {x_after - x_before:.2f} per tick)")
    clipped = (crossed_tick is not None and step_distance > 1.0
               and not sampled_inside_wall)
    print(f"  step distance {step_distance:.1f} vs interaction slab "
          f"+/-{interaction_range}; sampled inside wall: "
          f"{sampled_inside_wall}; min approach {min_dist:.2f}")
    print("  VERDICT: " + ("CLIP-THROUGH (spatial aliasing confirmed)"
                           if clipped else "no aliasing at this speed"))
    return {"step_distance": step_distance, "min_approach": min_dist,
            "crossed_tick": crossed_tick,
            "sampled_inside_wall": sampled_inside_wall,
            "clip_through": bool(clipped)}


# --------------------------------------------------------------------------
# Live dashboard (reference: RealityGlitchVisualizer,
# reality_glitch_tests.py:444-1218)
# --------------------------------------------------------------------------

class RealityGlitchDashboard:
    """Four live panels + terminal anomaly log + final verdict.

    Panels mirror the reference's 4-panel FuncAnimation dashboard:
    1. the subnormal-stressed galaxy (scatter, colored by |v|),
    2. subnormal census per frame,
    3. multiverse divergence (|A-B| reversed-sum, |A-C| fp16, log scale),
    4. entropy bits/float of the int4 universe.

    Runs interactively when a display exists, else renders to a gif via
    utils.anim.LiveAnimation.
    """

    def __init__(self, num_stars: int = 200, seed: int = 42,
                 ticks_per_frame: int = 5, device=None):
        pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
        self.stress = DirectSimulation(
            pos, vel, m, precision=Precision.FLOAT32,
            cfg=SimConfig(softening=STRESS_SOFTENING), device=device)
        self.mv = MultiverseSim(pos, vel, m, device=device)
        self.ent_sim = DirectSimulation(pos, vel, m,
                                        precision=Precision.INT4_SIM,
                                        device=device)
        self.ticks_per_frame = ticks_per_frame
        self.hist = {"frame": [], "subnormals": [], "div_rev": [],
                     "div_fp16": [], "bits": []}
        self.anomalies = []

    def _log_anomaly(self, msg: str):
        """Terminal anomaly log (reference prints these live)."""
        self.anomalies.append(msg)
        print(f"  [ANOMALY] {msg}")

    def advance(self):
        """One dashboard tick: advance all probe sims and histories."""
        inject_subnormals(self.stress)
        self.stress.step(self.ticks_per_frame)
        sub = int(count_subnormals(self.stress.state.velocities)
                  .subnormal_count)
        db, dc = self.mv.step(self.ticks_per_frame)
        self.ent_sim.step(self.ticks_per_frame)
        ent = measure_state_entropy(self.ent_sim.positions,
                                    self.ent_sim.velocities)
        h = self.hist
        h["frame"].append(len(h["frame"]))
        h["subnormals"].append(sub)
        h["div_rev"].append(db)
        h["div_fp16"].append(dc)
        h["bits"].append(ent.bits_per_float)
        if sub > 0:
            self._log_anomaly(f"subnormal flood: {sub} denormals")
        if len(h["div_rev"]) > 1 and db > 10 * max(h["div_rev"][-2], 1e-12):
            self._log_anomaly(f"divergence jump |A-B| -> {db:.3e}")
        if len(h["bits"]) > 1 and abs(h["bits"][-1] - h["bits"][-2]) > 1.0:
            self._log_anomaly(
                f"entropy step {h['bits'][-2]:.2f} -> {h['bits'][-1]:.2f} "
                "bits/float")

    def make_figure(self):
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(12, 8), facecolor="#0b0b16")
        for ax in axes.ravel():
            ax.set_facecolor("#101020")
            ax.tick_params(colors="white")
            for spine in ax.spines.values():
                spine.set_color("#444466")
            ax.title.set_color("white")
        fig.suptitle("REALITY GLITCH DASHBOARD", color="white")
        return fig, axes

    def update(self, frame, axes):
        self.advance()
        h = self.hist
        ax = axes[0, 0]
        ax.clear()
        ax.set_facecolor("black")
        p = to_host(self.stress.positions)
        v = np.linalg.norm(to_host(self.stress.velocities), axis=1)
        ax.scatter(p[:, 0], p[:, 1], s=1.5, c=v, cmap="plasma")
        ax.set_title(f"subnormal-stressed universe (tick "
                     f"{self.stress.tick})", color="white")

        ax = axes[0, 1]
        ax.clear()
        ax.plot(h["frame"], h["subnormals"], color="#e74c3c")
        ax.set_title("subnormal census (flatline 0 where flushed)",
                     color="white")

        ax = axes[1, 0]
        ax.clear()
        ax.semilogy(h["frame"],
                    np.maximum(h["div_rev"], 1e-12), color="#f39c12",
                    label="|A-B| reversed sum")
        ax.semilogy(h["frame"],
                    np.maximum(h["div_fp16"], 1e-12), color="#9b59b6",
                    label="|A-C| fp16")
        ax.legend(facecolor="#101020", labelcolor="white")
        ax.set_title("multiverse divergence", color="white")

        ax = axes[1, 1]
        ax.clear()
        ax.plot(h["frame"], h["bits"], color="#2ecc71")
        ax.set_title("int4 universe entropy (bits/float)", color="white")
        for ax in axes.ravel():
            ax.tick_params(colors="white")
            ax.set_facecolor(ax.get_facecolor() or "#101020")
        return []

    def final_verdict(self) -> dict:
        h = self.hist
        return {
            "frames": len(h["frame"]),
            "max_subnormals": max(h["subnormals"], default=0),
            "final_divergence_reversed": (h["div_rev"][-1]
                                          if h["div_rev"] else 0.0),
            "final_divergence_fp16": (h["div_fp16"][-1]
                                      if h["div_fp16"] else 0.0),
            "entropy_drift_bits": ((h["bits"][-1] - h["bits"][0])
                                   if len(h["bits"]) >= 2 else 0.0),
            "anomalies": self.anomalies,
        }


def run_dashboard(num_stars: int = 200, seed: int = 42, frames: int = 12,
                  ticks_per_frame: int = 5, save_path=None,
                  headless=None, device=None) -> dict:
    """Build and run the live dashboard; returns the final verdict dict.
    Without matplotlib the probes advance ``frames`` times and nothing is
    rendered (said once)."""
    from nbody_tpu_torch.utils.anim import LiveAnimation

    dash = RealityGlitchDashboard(num_stars, seed, ticks_per_frame, device)
    if not has_matplotlib():
        print("Dashboard skipped: matplotlib is not installed (the probes "
              "run, nothing is rendered)")
        for _ in range(frames):
            dash.advance()
        return dash.final_verdict()
    anim = LiveAnimation(dash.make_figure, dash.update, frames=frames,
                         interval_ms=100)
    path = anim.run(save_path=save_path, headless=headless)
    verdict = dash.final_verdict()
    if path is not None:
        verdict["animation"] = str(path)
        print(f"  dashboard animation written to {path}")
    return verdict


def suite_sizes(quick: bool) -> dict:
    """Each probe's (stars, ticks) at --quick or at the full defaults
    (reality_glitch_tests.py:365-379 of the JAX package); the spatial
    aliasing runs at its function's defaults."""
    n = 150 if quick else 300
    ticks = 100 if quick else 200
    return {"subnormal_singularity": (n, ticks),
            "multiverse_divergence": (n, ticks),
            "entropy_horizon": (n + 200, ticks + 100)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Reality glitch test suite")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/reality_glitch")
    p.add_argument("--animate", action="store_true",
                   help="run the 4-panel live dashboard (interactive with "
                        "a display, else renders a gif)")
    p.add_argument("--frames", type=int, default=12,
                   help="dashboard frames in headless/gif mode")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)

    if args.animate:
        out = Path(args.output)
        out.mkdir(parents=True, exist_ok=True)
        verdict = run_dashboard(
            num_stars=100 if args.quick else 200, seed=args.seed,
            frames=max(4, args.frames // 2) if args.quick else args.frames,
            save_path=out / "glitch_dashboard.gif", device=device)
        (out / "glitch_dashboard.json").write_text(
            json.dumps(verdict, indent=2))
        print(json.dumps(verdict, indent=2))
        return verdict
    s = suite_sizes(args.quick)

    print("\n" + "=" * 60)
    print("REALITY GLITCH TESTS")
    print("=" * 60)
    report = {
        "subnormal_singularity": subnormal_singularity_test(
            *s["subnormal_singularity"], args.seed, device),
        "multiverse_divergence": multiverse_divergence_test(
            *s["multiverse_divergence"], args.seed, device),
        "entropy_horizon": entropy_horizon_test(*s["entropy_horizon"],
                                                args.seed, device),
        "spatial_aliasing": spatial_aliasing_test(device=device),
    }
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "reality_glitch_report.json").write_text(
        json.dumps(report, indent=2, default=str))
    print(f"\nReport written to {out / 'reality_glitch_report.json'}")
    return report


if __name__ == "__main__":
    main()
