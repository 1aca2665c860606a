"""Universe2D: 2-D cosmological engine + dashboard (CLI).

PyTorch counterpart of ``nbody_tpu.engines.universe2d`` (reference:
universe_2d.py:884-1749): Planck-2018 evolution from z=50 with BAO initial
conditions, the quantized-k^2 precision hook, glitch detection and
physics-exploit probes, power-spectrum/BAO/clustering measurements and a
matplotlib dashboard (static frames headless; animated when interactive).
Runs on the card unless given ``--device cpu``; ``--mesh`` runs the
sharded PM over every local device of that type (``parallel/pm_sharded.py``;
one card, or the CPU, is a mesh of one). Where matplotlib is not installed
the frames are skipped and the run says so.

Usage:
    python -m nbody_tpu_torch.engines.universe2d --precision int4 --particles 10000
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

from nbody_tpu_torch.engines.cosmo import CosmologicalEngine
from nbody_tpu_torch.engines.epochs import EPOCHS
from nbody_tpu_torch.utils.anim import has_matplotlib


class Universe2D(CosmologicalEngine):
    """2-D engine preset (reference: universe_2d.py:884): 128^2 PM grid,
    200 Mpc box, NFW dark-matter background."""

    def __init__(self, num_particles: int = 10000,
                 box_size_mpc: float = 200.0, start_redshift: float = 50.0,
                 precision: str = "float32", dm_ratio: float = 5.0,
                 seed: int = 42, **kw):
        super().__init__(num_particles=num_particles,
                         box_size_mpc=box_size_mpc,
                         start_redshift=start_redshift, precision=precision,
                         dm_ratio=dm_ratio, seed=seed, dim=2, n_grid=128,
                         **kw)


class Universe2DDashboard:
    """Dashboard renderer (reference: universe_2d.py:1296-1562, a 20 FPS
    FuncAnimation). Three surfaces on the same panel layout:
    ``render_frame`` (one PNG), ``animate`` (live FuncAnimation with a
    display, gif/mp4 render headless — via utils.anim)."""

    def __init__(self, universe: Universe2D, out_dir: str = "output/universe2d"):
        self.u = universe
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)

    def _make_figure(self):
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(16, 9), facecolor="#0b0b16")
        gs = fig.add_gridspec(2, 3)
        axes = (fig.add_subplot(gs[:, :2]), fig.add_subplot(gs[0, 2]),
                fig.add_subplot(gs[1, 2]))
        return fig, axes

    def _draw(self, axes):
        u = self.u
        ax, ax2, ax3 = axes
        ax.clear()
        pos = u.positions.cpu().numpy()
        ax.scatter(pos[:, 0], pos[:, 1], s=0.5, c="white", alpha=0.6)
        ax.set_facecolor("black")
        ax.set_xlim(0, u.cfg.box_size)
        ax.set_ylim(0, u.cfg.box_size)
        info = EPOCHS[u.current_epoch]
        ax.set_title(f"z={u.redshift:.2f}  t={u.time_gyr:.3f} Gyr  "
                     f"[{info.name}]  {u.precision_str}",
                     color="white")
        ax.tick_params(colors="white")

        ax2.clear()
        k, pk = u.compute_power_spectrum()
        valid = pk > 0
        if valid.sum():
            ax2.loglog(k[valid], pk[valid], "-o", ms=3, color="#1abc9c")
        ax2.set_title("P(k)", color="white")
        ax2.set_facecolor("#101020")
        ax2.tick_params(colors="white")

        ax3.clear()
        if u.history["energy"]:
            ax3.plot(u.history["energy"], color="#f39c12")
        ax3.set_title(f"Kinetic energy  (glitches: "
                      f"{u.glitch_detector.get_glitch_count()})",
                      color="white")
        ax3.set_facecolor("#101020")
        ax3.tick_params(colors="white")

    def render_frame(self, tag: str = None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = self._make_figure()
        self._draw(axes)
        fig.tight_layout()
        name = tag or f"frame_t{self.u.tick:04d}"
        path = self.out_dir / f"{name}.png"
        fig.savefig(path, dpi=110, facecolor="#0b0b16")
        plt.close(fig)
        return path

    def animate(self, dz: float = 1.0, steps_per_frame: int = 2,
                frames: int = 25, save_path=None, headless=None):
        """Live dashboard: steps the engine between redraws
        (reference cadence: universe_2d.py:1391-1418). Interactive with a
        display; otherwise renders save_path (default universe2d.gif)."""
        from nbody_tpu_torch.utils.anim import LiveAnimation

        def update(frame, axes):
            if not self.u.completed:
                self.u.step(dz, num_steps=steps_per_frame)
            self._draw(axes)
            return []

        anim = LiveAnimation(self._make_figure, update, frames=frames,
                             interval_ms=50)
        return anim.run(save_path=save_path
                        or self.out_dir / "universe2d.gif",
                        headless=headless)


def make_mesh(wanted: bool, device):
    """The presets' ``--mesh``: a mesh over every local device of
    ``device``'s type, its shard count printed; None without the flag."""
    if not wanted:
        return None
    from nbody_tpu_torch.parallel import pm_sharded

    mesh = pm_sharded.make_particle_mesh(device=device)
    print(f"sharded PM over {mesh.size} device(s)")
    return mesh


def write_report(u: Universe2D, path: Path):
    report = {
        "engine": "universe2d",
        "device": str(u.device),
        "precision": u.precision_str,
        "num_particles": u.num_particles,
        "box_size_mpc": u.cfg.box_size,
        "final_redshift": u.redshift,
        "final_time_gyr": u.time_gyr,
        "ticks": u.tick,
        "bao_scale_mpc": u.get_bao_scale(),
        "clustering": u.get_clustering(),
        "glitch_count": u.glitch_detector.get_glitch_count(),
        "glitch_summary": u.glitch_detector.get_glitch_summary(),
        # the paper's headline observable: per-step energy
        # non-conservation magnitude vs epoch (paper: ~2.7% at z=10
        # growing to 119.4% at z~0.05)
        "energy_nonconservation_curve": [
            {"redshift": ev.redshift, "magnitude_pct": ev.magnitude * 100}
            for ev in u.glitch_detector.events
            if ev.glitch_type == "energy_jump"],
        "exploit_summary": u.exploit_engine.get_exploit_summary(),
        "energy_first": u.history["energy"][0] if u.history["energy"] else None,
        "energy_last": u.history["energy"][-1] if u.history["energy"] else None,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, default=str))
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="2D cosmological universe "
                                            "(PyTorch / CUDA)")
    p.add_argument("--particles", type=int, default=10000)
    p.add_argument("--box-size", type=float, default=200.0)
    p.add_argument("--start-z", type=float, default=50.0)
    p.add_argument("--dz", type=float, default=1.0)
    p.add_argument("--precision", type=str, default="float32")
    p.add_argument("--dm-ratio", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--mesh", action="store_true",
                   help="run the sharded PM pipeline over all local "
                        "devices of --device's type "
                        "(parallel/pm_sharded.py)")
    p.add_argument("--output", type=str, default="output/universe2d")
    p.add_argument("--frames", type=int, default=5,
                   help="dashboard frames to render across the run")
    p.add_argument("--headless", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-headless opens the interactive dashboard "
                        "window when a display exists")
    p.add_argument("--animate", action="store_true",
                   help="run the live FuncAnimation dashboard instead of "
                        "periodic PNG frames (gif when headless)")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="enable checkpoint/resume in this directory")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    mesh = make_mesh(args.mesh, args.device)
    u = Universe2D(num_particles=args.particles, box_size_mpc=args.box_size,
                   start_redshift=args.start_z, precision=args.precision,
                   dm_ratio=args.dm_ratio, seed=args.seed,
                   device=args.device, mesh=mesh)
    ckpt = None
    if args.checkpoint_dir:
        from nbody_tpu_torch.utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir)
        resumed = u.restore_latest(ckpt)
        if resumed is not None:
            print(f"resumed from checkpoint at tick {resumed} "
                  f"(z={u.redshift:.2f})")
    plots = has_matplotlib()
    if not plots:
        print("Plots skipped: matplotlib is not installed")
    dash = Universe2DDashboard(u, args.output)
    report_path = Path(args.output) / "universe2d_report.json"

    if args.animate and plots:
        path = dash.animate(dz=args.dz, frames=args.frames * 5,
                            headless=args.headless or None)
        if path:
            print(f"animation written to {path}")
        report = write_report(u, report_path)
        print(json.dumps(report, indent=2, default=str))
        return report

    total_steps = int((args.start_z - u.cfg.min_redshift) / args.dz) + 1
    frame_every = max(1, total_steps // max(args.frames, 1))
    t0 = time.time()
    rendered = 0
    while not u.completed:
        u.step(args.dz, num_steps=min(10, frame_every))
        if u.tick // frame_every > rendered:
            rendered += 1
            if plots:
                dash.render_frame()
            if ckpt:
                u.save_checkpoint(ckpt)
            print(f"tick {u.tick}: z={u.redshift:.2f} "
                  f"BAO={u.get_bao_scale():.1f} Mpc "
                  f"clustering={u.get_clustering():.3f} "
                  f"glitches={u.glitch_detector.get_glitch_count()}")
    wall = time.time() - t0
    if plots:
        dash.render_frame(tag="final")
    report = write_report(u, report_path)
    print(f"\nDone in {wall:.1f}s on {u.device}: {u.tick} epochs, "
          f"z={args.start_z:g} -> {u.redshift:.2f}")
    print(json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()
