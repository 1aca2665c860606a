"""Static comparison plots for precision-ladder runs.

Capability-parity with the reference plot set
(reference: visualization.py:14-313): final-state galaxy scatter, rotation
curves with Keplerian reference, absolute + relative energy evolution,
90th-percentile radius evolution, and the text summary table. All inputs
are host numpy (``MetricsHistory`` / position arrays already streamed off
device); matplotlib (imported at first plot) uses the Agg backend so
headless runs always work. Copy of ``nbody_tpu.utils.viz``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from nbody_tpu_torch.utils.history import MetricsHistory

_BG = "#101020"


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at first plot so
    that the summary works where matplotlib is not installed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _mode_colors(n):
    return _pyplot().cm.viridis(np.linspace(0.2, 0.9, n))


def plot_galaxy_comparison(final_positions: Dict[str, np.ndarray],
                           save_path=None,
                           title="Galaxy comparison: precision effects"):
    """Side-by-side final-state scatter per mode (reference: visualization.py:14-59)."""
    plt = _pyplot()
    modes = list(final_positions)
    fig, axes = plt.subplots(1, len(modes), figsize=(5 * len(modes), 5),
                             squeeze=False)
    for ax, mode in zip(axes[0], modes):
        pos = np.asarray(final_positions[mode])
        ax.scatter(pos[:, 0], pos[:, 1], s=1, alpha=0.5, c="white")
        ax.set_facecolor("black")
        ax.set_aspect("equal")
        ax.set_title(mode, color="white")
        ax.tick_params(colors="white")
        extent = max(np.abs(pos).max() * 1.1, 15.0)
        ax.set_xlim(-extent, extent)
        ax.set_ylim(-extent, extent)
    fig.patch.set_facecolor(_BG)
    fig.suptitle(title, color="white")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, facecolor=_BG, bbox_inches="tight")
    return fig


def plot_rotation_curves(histories: Dict[str, MetricsHistory], save_path=None,
                         title="Rotation curves: the dark-matter signature"):
    """Final rotation curve per mode + Keplerian reference
    (reference: visualization.py:62-121)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    for (mode, h), color in zip(histories.items(),
                                _mode_colors(len(histories))):
        if not h.rotation_curves:
            continue
        curve = h.rotation_curves[-1]
        r = np.asarray(curve["radii"])
        v = np.asarray(curve["velocities"])
        valid = ~np.isnan(v)
        ax.plot(r[valid], v[valid], "o-", color=color, label=mode,
                markersize=4, linewidth=2)
    r_ref = np.linspace(1, 15, 50)
    ax.plot(r_ref, 1.5 / np.sqrt(r_ref), "--", color="red", alpha=0.5,
            linewidth=1.5, label="Keplerian (no dark matter)")
    ax.set_xlabel("Radius")
    ax.set_ylabel("Circular velocity")
    ax.set_title(title)
    ax.legend(loc="upper right")
    ax.grid(True, alpha=0.3)
    ax.set_xlim(0, None)
    ax.set_ylim(0, None)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_energy_evolution(histories: Dict[str, MetricsHistory], save_path=None,
                          title="Energy evolution: rounding-error injection"):
    """Absolute energy + % drift panels (reference: visualization.py:124-192)."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
    colors = _mode_colors(len(histories))
    for (mode, h), color in zip(histories.items(), colors):
        ax1.plot(h.ticks, h.total_energy, color=color, label=mode,
                 linewidth=2)
        e0 = h.total_energy[0] if h.total_energy else 0.0
        if abs(e0) > 1e-10:
            rel = [(e - e0) / abs(e0) * 100 for e in h.total_energy]
            ax2.plot(h.ticks, rel, color=color, label=mode, linewidth=2)
    ax1.set_xlabel("Tick")
    ax1.set_ylabel("Total energy")
    ax1.set_title("Total energy over time")
    ax1.legend()
    ax1.grid(True, alpha=0.3)
    ax2.set_xlabel("Tick")
    ax2.set_ylabel("Energy change (%)")
    ax2.set_title("Energy drift (% of initial)")
    ax2.axhline(0, color="red", linestyle="--", alpha=0.5)
    ax2.legend()
    ax2.grid(True, alpha=0.3)
    fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_radius_evolution(histories: Dict[str, MetricsHistory], save_path=None,
                          title="Galaxy radius: does quantization keep stars bound?"):
    """90th-percentile radius vs tick (reference: visualization.py:195-233)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    for (mode, h), color in zip(histories.items(),
                                _mode_colors(len(histories))):
        ax.plot(h.ticks, h.galaxy_radius_90, color=color, label=mode,
                linewidth=2)
    ax.set_xlabel("Tick")
    ax.set_ylabel("Galaxy radius (90th percentile)")
    ax.set_title(title)
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def plot_full_comparison(final_positions: Dict[str, np.ndarray],
                         histories: Dict[str, MetricsHistory],
                         save_dir: str = "output"):
    """All four comparison figures (reference: visualization.py:236-278)."""
    plt = _pyplot()
    out = Path(save_dir)
    out.mkdir(parents=True, exist_ok=True)
    figs = [
        plot_galaxy_comparison(final_positions,
                               out / "galaxy_comparison.png"),
        plot_rotation_curves(histories, out / "rotation_curves.png"),
        plot_energy_evolution(histories, out / "energy_evolution.png"),
        plot_radius_evolution(histories, out / "radius_evolution.png"),
    ]
    for f in figs:
        plt.close(f)
    return figs


def print_summary(histories: Dict[str, MetricsHistory]):
    """Text summary table (reference: visualization.py:281-313)."""
    print("\n" + "=" * 60)
    print("SIMULATION RESULTS SUMMARY")
    print("=" * 60)
    for mode, h in histories.items():
        print(f"\n{mode}:")
        print("-" * 40)
        drift = h.energy_drift_pct
        if drift is not None:
            print(f"  Energy drift: {drift:+.2f}%")
        if h.galaxy_radius_90:
            r0, r1 = h.galaxy_radius_90[0], h.galaxy_radius_90[-1]
            change = (r1 - r0) / r0 * 100 if r0 > 0 else 0.0
            print(f"  Radius change: {change:+.2f}%")
            print(f"  Final radius: {r1:.2f}")
        if h.bound_fraction:
            print(f"  Final bound fraction: {h.bound_fraction[-1]:.1%}")
        if h.velocity_dispersion:
            d0, d1 = h.velocity_dispersion[0], h.velocity_dispersion[-1]
            change = (d1 - d0) / d0 * 100 if d0 > 0 else 0.0
            print(f"  Velocity dispersion change: {change:+.2f}%")
    print("\n" + "=" * 60)
