"""Host-side metrics history assembled from on-device Snapshot stacks.

Copy of ``nbody_tpu.utils.history`` (numpy only; the JAX package cannot be
imported without jax). The engines emit stacked ``Snapshot``s, copied to
the host once per run; this module converts them into plain-numpy time
series equivalent to the reference's ``SimulationMetrics`` accumulation
(reference: metrics.py:12-22, collect_metrics:159-179) for plotting and
summaries.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class MetricsHistory:
    """Time series of every diagnostic the reference records."""

    ticks: List[int] = dataclasses.field(default_factory=list)
    total_energy: List[float] = dataclasses.field(default_factory=list)
    kinetic_energy: List[float] = dataclasses.field(default_factory=list)
    potential_energy: List[float] = dataclasses.field(default_factory=list)
    galaxy_radius_90: List[float] = dataclasses.field(default_factory=list)
    bound_fraction: List[float] = dataclasses.field(default_factory=list)
    velocity_dispersion: List[float] = dataclasses.field(default_factory=list)
    rotation_curves: List[dict] = dataclasses.field(default_factory=list)

    @classmethod
    def from_snapshots(cls, snaps, initial=None) -> "MetricsHistory":
        """Build from a stacked Snapshot pytree (leading axis = interval),
        optionally prepending a single tick-0 Snapshot."""
        h = cls()
        if initial is not None:
            h._append_single(initial)
        n = int(np.asarray(snaps.tick).shape[0])
        tick = np.asarray(snaps.tick)
        ke = np.asarray(snaps.kinetic)
        pe = np.asarray(snaps.potential)
        te = np.asarray(snaps.total)
        r90 = np.asarray(snaps.radius_90)
        bf = np.asarray(snaps.bound_frac)
        disp = np.asarray(snaps.dispersion)
        cr = np.asarray(snaps.curve_radii)
        cv = np.asarray(snaps.curve_velocities)
        cc = np.asarray(snaps.curve_counts)
        for i in range(n):
            h.ticks.append(int(tick[i]))
            h.kinetic_energy.append(float(ke[i]))
            h.potential_energy.append(float(pe[i]))
            h.total_energy.append(float(te[i]))
            h.galaxy_radius_90.append(float(r90[i]))
            h.bound_fraction.append(float(bf[i]))
            h.velocity_dispersion.append(float(disp[i]))
            h.rotation_curves.append({
                "radii": cr[i], "velocities": cv[i],
                "num_stars_per_bin": cc[i],
            })
        return h

    def _append_single(self, snap):
        self.ticks.append(int(np.asarray(snap.tick)))
        self.kinetic_energy.append(float(np.asarray(snap.kinetic)))
        self.potential_energy.append(float(np.asarray(snap.potential)))
        self.total_energy.append(float(np.asarray(snap.total)))
        self.galaxy_radius_90.append(float(np.asarray(snap.radius_90)))
        self.bound_fraction.append(float(np.asarray(snap.bound_frac)))
        self.velocity_dispersion.append(float(np.asarray(snap.dispersion)))
        self.rotation_curves.append({
            "radii": np.asarray(snap.curve_radii),
            "velocities": np.asarray(snap.curve_velocities),
            "num_stars_per_bin": np.asarray(snap.curve_counts),
        })

    @property
    def energy_drift_pct(self) -> Optional[float]:
        if not self.total_energy:
            return None
        e0 = self.total_energy[0]
        if abs(e0) < 1e-10:
            return 0.0
        return (self.total_energy[-1] - e0) / abs(e0) * 100.0
