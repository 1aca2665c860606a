"""Live FuncAnimation dashboard runner: interactive or headless.

The reference ships four live matplotlib dashboards — the 20 FPS 2-D
cosmology view (reference: universe_2d.py:1296-1562), the rotating 3-D
viewer (reference: universe_3d.py:1358-1540), the 4-panel reality-glitch
dashboard with a terminal anomaly log (reference:
reality_glitch_tests.py:444-1218) and the realtime engine dashboard
(reference: realtime_reality_engine.py:521-759). All of them are
``FuncAnimation`` loops that assume a display.

This module is the shared runner those dashboards build on (PyTorch
port's copy of ``nbody_tpu.utils.anim``):

* with an interactive display (``$DISPLAY``/``$WAYLAND_DISPLAY`` or a GUI
  backend already selected), the animation runs live via ``plt.show()``;
* headless (this box, CI), the SAME animation is rendered with
  ``FuncAnimation.save`` to a gif (pillow, always available) or mp4
  (ffmpeg, when present) — so the live-dashboard capability is testable
  without a display.

Design note: the update callbacks consume host-side snapshots the engines
stream out of their device chunks, keeping render cadence and device
cadence decoupled (the reference steps the sim inside the matplotlib
timer callback, which serialises physics behind the GUI).

matplotlib is imported at first use, never with this module: a machine
without it runs the engines all the same, and ``has_matplotlib`` lets a
caller say that rendering was skipped.
"""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path
from typing import Callable, Optional


def has_matplotlib() -> bool:
    """True when matplotlib can be imported here."""
    return importlib.util.find_spec("matplotlib") is not None


def has_display() -> bool:
    """True when an interactive matplotlib session is possible."""
    if os.environ.get("MPLBACKEND", "").lower() == "agg":
        return False
    if os.name == "nt":  # pragma: no cover - not this box
        return True
    return bool(os.environ.get("DISPLAY")
                or os.environ.get("WAYLAND_DISPLAY"))


def pick_writer(path: Path):
    """Animation writer for the output suffix; falls back to pillow/gif."""
    from matplotlib.animation import writers

    suffix = path.suffix.lower()
    if suffix in (".mp4", ".m4v", ".mov") and writers.is_available("ffmpeg"):
        return "ffmpeg", path
    if suffix != ".gif":
        path = path.with_suffix(".gif")
    return "pillow", path


class LiveAnimation:
    """One dashboard: a figure factory + per-frame update.

    ``make_figure()`` returns (fig, artists_state) — any object the update
    closure wants (axes, line artists, text boxes). ``update(frame,
    artists_state)`` advances the dashboard one frame. ``frames`` bounds
    headless rendering (interactive mode runs until the window closes
    unless ``frames`` is finite and ``repeat=False`` semantics apply).
    """

    def __init__(self, make_figure: Callable, update: Callable,
                 frames: int = 60, interval_ms: int = 50):
        self.make_figure = make_figure
        self.update = update
        self.frames = frames
        self.interval_ms = interval_ms

    def run(self, save_path: Optional[str] = None,
            headless: Optional[bool] = None,
            fps: Optional[int] = None) -> Optional[Path]:
        """Run the dashboard.

        headless=None auto-selects: display present -> interactive window;
        otherwise render to ``save_path`` (default dashboard.gif). Returns
        the written path in headless mode, None in interactive mode.
        """
        if headless is None:
            headless = not has_display()

        import matplotlib
        if headless:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        fig, state = self.make_figure()
        anim = FuncAnimation(fig, self.update, frames=self.frames,
                             fargs=(state,), interval=self.interval_ms,
                             repeat=False, cache_frame_data=False)
        if not headless:
            plt.show()
            plt.close(fig)
            return None

        path = Path(save_path or "output/dashboard.gif")
        path.parent.mkdir(parents=True, exist_ok=True)
        writer, path = pick_writer(path)
        anim.save(str(path), writer=writer,
                  fps=fps or max(1, round(1000 / self.interval_ms)))
        plt.close(fig)
        return path
