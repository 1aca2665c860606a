"""Realtime precision-compare viewer: clean vs broken, live.

PyTorch counterpart of ``nbody_tpu.realtime.visual`` (reference:
realtime_visual.py:37-387): a clean (float32) and a broken (16-level
log-quantized, ``Quantizer(CUSTOM, 16)`` without force quantization)
galaxy stepped in lockstep on ``DirectSimulation``, rendered as a
dashboard of both galaxies + divergence map + energy drift + the "GHOST
FORCE" meter (broken minus clean drift; "DARK MATTER!" above 5%) + live
rotation curves.

On the card each tick is one launch of the sym_force kernel a universe
(2000 stars = 31 x 64 + 16: the general kernel), and the broken universe
adds its bounds pass (two max_d2 launches a tick past 1024 stars). The
disk is drawn on a CPU ``torch.Generator`` seeded by ``seed``.

Headless mode writes PNG frames; ``--animate`` a FuncAnimation. Where
matplotlib is not installed the viewer steps, renders nothing and says
so once.

Usage:
    python -m nbody_tpu_torch.realtime.visual --stars 2000 --frames 6
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.diagnostics.metrics import rotation_curve
from nbody_tpu_torch.models.direct import DirectSimulation
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision, Quantizer
from nbody_tpu_torch.realtime.engine import SKIPPED
from nbody_tpu_torch.utils.anim import has_matplotlib

GHOST_FORCE_DM_THRESHOLD = 5.0  # percent (reference: realtime_visual.py:240)
TITLES = {"clean": "CLEAN (float32)", "broken": "BROKEN (16-level log)"}


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _galaxy_panel(ax, p, title):
    ax.clear()
    ax.scatter(p[:, 0], p[:, 1], s=0.8, c="white", alpha=0.6)
    ax.set_facecolor("black")
    ax.set_xlim(-20, 20)
    ax.set_ylim(-20, 20)
    ax.set_title(title, color="white")
    ax.tick_params(colors="white")


class PrecisionCompareViewer:
    def __init__(self, num_stars: int = 2000, seed: int = 42,
                 steps_per_frame: int = 5,
                 out_dir: str = "output/realtime_visual",
                 mode: str = "compare", device=None):
        """mode: 'compare' runs both universes; 'clean'/'broken' run and
        render only that universe (reference: realtime_visual.py:362-383).
        ``device``: cuda unless named."""
        pos, vel, m = create_disk_galaxy(torch.Generator().manual_seed(seed),
                                         num_stars)
        self.mode = mode
        self.clean = None
        self.broken = None
        if mode in ("compare", "clean"):
            self.clean = DirectSimulation(pos, vel, m,
                                          precision=Precision.FLOAT32,
                                          device=device)
            self.e0_clean = self.clean.get_total_energy()
        if mode in ("compare", "broken"):
            self.broken = DirectSimulation(
                pos, vel, m,
                precision=Quantizer(Precision.CUSTOM, custom_levels=16),
                quantize_forces=False, device=device)
            self.e0_broken = self.broken.get_total_energy()
        self.steps_per_frame = steps_per_frame
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.history = {"ticks": [], "drift_clean": [], "drift_broken": [],
                        "ghost": []}
        self.frame_idx = 0
        self.plots = has_matplotlib()
        self._said = False

    @property
    def tick(self) -> int:
        sim = self.clean or self.broken
        return sim.tick

    def _skipped(self) -> None:
        if not self._said:
            print(SKIPPED)
            self._said = True

    def step(self):
        drift_c = drift_b = 0.0
        if self.clean is not None:
            self.clean.step(self.steps_per_frame)
            drift_c = ((self.clean.get_total_energy() - self.e0_clean)
                       / abs(self.e0_clean) * 100)
        if self.broken is not None:
            self.broken.step(self.steps_per_frame)
            drift_b = ((self.broken.get_total_energy() - self.e0_broken)
                       / abs(self.e0_broken) * 100)
        self.history["ticks"].append(self.tick)
        self.history["drift_clean"].append(drift_c)
        self.history["drift_broken"].append(drift_b)
        self.history["ghost"].append(drift_b - drift_c
                                     if self.mode == "compare" else 0.0)

    def _save(self, fig, name: str) -> Path:
        import matplotlib.pyplot as plt

        fig.tight_layout()
        path = self.out_dir / f"{name}_{self.frame_idx:04d}.png"
        fig.savefig(path, dpi=100, facecolor="#0b0b16")
        plt.close(fig)
        self.frame_idx += 1
        return path

    def _render_single(self):
        """Single-universe frame for --mode clean/broken."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sim = self.clean if self.mode == "clean" else self.broken
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 6),
                                       facecolor="#0b0b16")
        _galaxy_panel(ax1, _host(sim.positions),
                      f"{self.mode.upper()} universe, tick {self.tick}")
        ax2.plot(self.history["ticks"], self.history[f"drift_{self.mode}"],
                 color="#2ecc71" if self.mode == "clean" else "#e74c3c")
        ax2.set_title("Energy drift %", color="white")
        ax2.set_facecolor("#101020")
        ax2.tick_params(colors="white")
        return self._save(fig, self.mode)

    def _make_figure(self):
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(16, 9), facecolor="#0b0b16")
        gs = fig.add_gridspec(2, 3)
        axes = {
            "clean": fig.add_subplot(gs[0, 0]),
            "broken": fig.add_subplot(gs[0, 1]),
            "div": fig.add_subplot(gs[0, 2]),
            "drift": fig.add_subplot(gs[1, 0]),
            "ghost": fig.add_subplot(gs[1, 1]),
            "curves": fig.add_subplot(gs[1, 2]),
        }
        return fig, axes

    def _draw(self, axes):
        """The compare dashboard's six panels; returns the divergence
        map's scatter."""
        pc, pb = _host(self.clean.positions), _host(self.broken.positions)
        for key, p in (("clean", pc), ("broken", pb)):
            _galaxy_panel(axes[key], p, TITLES[key])

        ax = axes["div"]
        ax.clear()
        div = np.linalg.norm(pc - pb, axis=1)
        sc = ax.scatter(pc[:, 0], pc[:, 1], s=1.2, c=div, cmap="inferno",
                        vmin=0, vmax=max(float(div.max()), 1e-6))
        ax.set_facecolor("black")
        ax.set_xlim(-20, 20)
        ax.set_ylim(-20, 20)
        ax.set_title("DIVERGENCE MAP", color="white")
        ax.tick_params(colors="white")

        ax = axes["drift"]
        ax.clear()
        ax.plot(self.history["ticks"], self.history["drift_clean"],
                color="#2ecc71", label="clean")
        ax.plot(self.history["ticks"], self.history["drift_broken"],
                color="#e74c3c", label="broken")
        ax.set_title("Energy drift %", color="white")
        ax.set_facecolor("#101020")
        ax.tick_params(colors="white")
        ax.legend()

        ax = axes["ghost"]
        ax.clear()
        ghost = self.history["ghost"][-1] if self.history["ghost"] else 0.0
        color = "#e74c3c" if ghost > GHOST_FORCE_DM_THRESHOLD else "#f39c12"
        ax.bar(["GHOST FORCE"], [ghost], color=color)
        label = ("DARK MATTER!" if ghost > GHOST_FORCE_DM_THRESHOLD
                 else f"{ghost:+.2f}%")
        ax.set_title(f"Ghost force meter: {label}", color="white")
        ax.set_facecolor("#101020")
        ax.tick_params(colors="white")

        ax = axes["curves"]
        ax.clear()
        for sim, color, label in ((self.clean, "#2ecc71", "clean"),
                                  (self.broken, "#e74c3c", "broken")):
            c = rotation_curve(sim.positions, sim.velocities, num_bins=14)
            r = _host(c.radii)
            v = _host(c.velocities).astype(float)
            valid = ~np.isnan(v)
            ax.plot(r[valid], v[valid], "o-", ms=3, color=color,
                    label=label)
        ax.set_title("Live rotation curves", color="white")
        ax.set_facecolor("#101020")
        ax.tick_params(colors="white")
        ax.legend()
        return sc

    def render_frame(self):
        """One PNG of the current state; None (said once) without
        matplotlib."""
        if not self.plots:
            self._skipped()
            return None
        if self.mode != "compare":
            return self._render_single()
        import matplotlib
        matplotlib.use("Agg")

        fig, axes = self._make_figure()
        fig.colorbar(self._draw(axes), ax=axes["div"])
        fig.suptitle(f"tick {self.clean.tick}", color="white")
        return self._save(fig, "compare")

    def animate(self, frames: int = 20, save_path=None, headless=None):
        """Live compare dashboard (reference FuncAnimation:
        realtime_visual.py:142-174), stepping both universes per frame.
        Without matplotlib the frames are stepped, nothing is rendered and
        None is returned."""
        if not self.plots:
            self._skipped()
            for _ in range(frames):
                self.step()
            return None
        from nbody_tpu_torch.utils.anim import LiveAnimation

        def update(frame, axes):
            self.step()
            self._draw(axes)
            return []

        anim = LiveAnimation(self._make_figure, update, frames=frames,
                             interval_ms=100)
        return anim.run(save_path=save_path
                        or self.out_dir / "compare.gif",
                        headless=headless)


def main(argv=None):
    p = argparse.ArgumentParser(description="Realtime precision viewer")
    p.add_argument("--stars", type=int, default=2000)
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--ticks-per-frame", type=int, default=50)
    p.add_argument("--mode", choices=["compare", "clean", "broken"],
                   default="compare")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/realtime_visual")
    p.add_argument("--animate", action="store_true",
                   help="live FuncAnimation (gif when headless) instead "
                        "of per-frame PNGs; compare mode only")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    args = p.parse_args(argv)

    viewer = PrecisionCompareViewer(args.stars, args.seed,
                                    steps_per_frame=args.ticks_per_frame,
                                    out_dir=args.output, mode=args.mode,
                                    device=args.device)
    if args.animate and args.mode == "compare":
        path = viewer.animate(frames=args.frames)
        if path:
            print(f"animation written to {path}")
        (Path(args.output) / "ghost_history.json").write_text(
            json.dumps(viewer.history, indent=2))
        return viewer
    t0 = time.time()
    for f in range(args.frames):
        viewer.step()
        path = viewer.render_frame()
        g = viewer.history["ghost"][-1]
        print(f"  frame {f}: tick {viewer.tick}, ghost force "
              f"{g:+.2f}% -> {path}")
    print(f"\n{args.frames} frames in {time.time() - t0:.1f}s; final ghost "
          f"force {viewer.history['ghost'][-1]:+.2f}%")
    (Path(args.output) / "ghost_history.json").write_text(
        json.dumps(viewer.history, indent=2))
    return viewer


if __name__ == "__main__":
    main()
