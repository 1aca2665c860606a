"""3-D dashboard renderer for the volumetric engines.

PyTorch counterpart of ``nbody_tpu.engines.dashboard3d`` (reference:
universe_3d.py:1358-1540, universe_genesis.py:518-741): a 3-D scatter
with a rotating viewpoint, the epoch timeline, P(k) and BAO. Three
surfaces on one layout: per-frame PNGs (headless batch), a live
FuncAnimation when a display exists, or a gif/mp4 render headless (via
``utils.anim``); the camera spins across frames as the live visualizer's
does.

matplotlib is imported at first use. Where it is not installed the
dashboard renders nothing, says so once, and returns None: the engine
runs all the same.
"""

from __future__ import annotations

from pathlib import Path

from nbody_tpu_torch.engines.epochs import EPOCHS, get_current_epoch
from nbody_tpu_torch.utils.anim import has_matplotlib

SKIPPED = "Plots skipped: matplotlib is not installed"


class Dashboard3D:
    def __init__(self, engine, out_dir: str = "output/universe3d",
                 spin_degrees_per_frame: float = 12.0):
        self.engine = engine
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.frame_idx = 0
        self.azim = 30.0
        self.spin = spin_degrees_per_frame
        self.bao_history: list[tuple[float, float]] = []
        self.plots = has_matplotlib()
        self._said = False

    def _skipped(self) -> None:
        if not self._said:
            print(SKIPPED)
            self._said = True

    def _make_figure(self):
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(16, 9), facecolor="#0b0b16")
        gs = fig.add_gridspec(2, 3)
        axes = (fig.add_subplot(gs[:, :2], projection="3d"),
                fig.add_subplot(gs[0, 2]), fig.add_subplot(gs[1, 2]))
        return fig, axes

    def _draw(self, axes):
        u = self.engine
        bao = u.get_bao_scale()
        self.bao_history.append((u.redshift, bao))
        ax, ax_t, ax_p = axes

        ax.clear()
        pos = u.positions.cpu().numpy()
        ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=0.5, c="white",
                   alpha=0.4)
        ax.set_facecolor("black")
        ax.view_init(elev=20.0, azim=self.azim)
        self.azim = (self.azim + self.spin) % 360.0
        info = EPOCHS[get_current_epoch(u.redshift)]
        ax.set_title(f"z={u.redshift:.2f}  t={u.time_gyr:.3f} Gyr  "
                     f"[{info.name}]  {u.precision_str}", color="white")
        ax.set_xlim(0, u.cfg.box_size)
        ax.set_ylim(0, u.cfg.box_size)
        ax.set_zlim(0, u.cfg.box_size)
        ax.tick_params(colors="white")

        # epoch timeline
        ax_t.clear()
        names = [EPOCHS[e].name for e in EPOCHS]
        zs = [EPOCHS[e].redshift for e in EPOCHS]
        colors = ["#2ecc71" if z >= u.redshift else "#444466" for z in zs]
        ax_t.barh(range(len(names)), [1] * len(names), color=colors,
                  alpha=0.8)
        ax_t.set_yticks(range(len(names)))
        ax_t.set_yticklabels(names, fontsize=7, color="white")
        ax_t.set_xticks([])
        ax_t.set_title("Epoch timeline", color="white")
        ax_t.set_facecolor("#101020")

        # P(k)
        ax_p.clear()
        k, pk = u.compute_power_spectrum(n_grid=32)
        valid = pk > 0
        if valid.sum():
            ax_p.loglog(k[valid], pk[valid], "-o", ms=3, color="#1abc9c")
        ax_p.set_title(f"P(k)  BAO={bao:.0f} Mpc  glitches="
                       f"{u.glitch_detector.get_glitch_count()}",
                       color="white")
        ax_p.set_facecolor("#101020")
        ax_p.tick_params(colors="white")

    def render_frame(self, tag: str = None):
        """One PNG of the dashboard; its path, or None without
        matplotlib."""
        if not self.plots:
            self._skipped()
            return None
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = self._make_figure()
        self._draw(axes)
        fig.tight_layout()
        name = tag or f"frame3d_t{self.engine.tick:04d}"
        path = self.out_dir / f"{name}.png"
        fig.savefig(path, dpi=110, facecolor="#0b0b16")
        plt.close(fig)
        self.frame_idx += 1
        return path

    def animate(self, dz: float = 1.0, steps_per_frame: int = 2,
                frames: int = 25, save_path=None, headless=None):
        """Rotating live view (reference: universe_3d.py:1358-1540): the
        engine advances between redraws while the camera spins. None
        without matplotlib."""
        if not self.plots:
            self._skipped()
            return None
        from nbody_tpu_torch.utils.anim import LiveAnimation

        def update(frame, axes):
            if not self.engine.completed:
                self.engine.step(dz, num_steps=steps_per_frame)
            self._draw(axes)
            return []

        anim = LiveAnimation(self._make_figure, update, frames=frames,
                             interval_ms=50)
        return anim.run(save_path=save_path
                        or self.out_dir / "universe3d.gif",
                        headless=headless)
