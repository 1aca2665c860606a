"""Behavioral gate of the PM engine against the torch reference's cached runs.

Port-owned copy of the rule of ``tools/pm_reference_parity.py`` (its
``ReferenceCosmology``, ``detector_counts``, ``drift_curve``,
``clustering_contrast``, ``drift_at_z`` and ``compare_mode``), which the
port may not import: the reference's flagship workload, the 2-D
``universe_2d`` PM loop (N=10000 or 1024, NGP 128^2 grid, 200 Mpc box,
z 50 -> 0.01 with dz = 1, quantized k^2), run by ``CosmologicalEngine``
from the reference's own cached ICs under the reference's clock, and held
to the cached reference trajectory (and its permuted twin, where cached)
on three observables: the energy-drift envelope, the glitch-event counts
and the final clustering contrast.

The cached files live in ``tools/reference_cache/`` and are read as JSON:
``pm_ics_n{n}_z50_seed42.json`` (ICs) and
``pm_ref_n{n}_z50_seed42_{mode}[_perm].json`` (reference runs).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.config import Cosmology

CACHE_DIR = Path(__file__).resolve().parents[2] / "tools" / "reference_cache"

# The reference's 14-point lookup table of cosmic time
# (universe_2d.py:188-217).
_Z_TABLE = np.array([0, 0.1, 0.5, 1, 2, 3, 5, 10, 20, 50, 100, 500,
                     1000, 1100], dtype=np.float64)
_T_TABLE = np.array([13.8, 12.5, 8.6, 5.9, 3.3, 2.2, 1.2, 0.47, 0.18,
                     0.05, 0.017, 0.001, 0.0004, 0.00038], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ReferenceCosmology(Cosmology):
    """Planck-2018 with the reference's exact clock: its lookup-table
    cosmic time and omega_r = 9.4e-5 (universe_2d.py:172), so the engine's
    (z, dt, H, a) schedule is the reference run's. Only for the gate."""

    omega_r: float = 9.4e-5

    def cosmic_time_gyr(self, z: float, n_steps: int = 0) -> float:
        if z >= 1100:
            return 0.00038 * (1100.0 / z) ** 1.5
        if z <= 0:
            return 13.8
        return float(np.interp(z, _Z_TABLE, _T_TABLE))


def load_ics(n: int):
    """The reference's cached ICs: (positions, velocities, mass scalar)."""
    blob = json.loads((CACHE_DIR / f"pm_ics_n{n}_z50_seed42.json").read_text())
    return (np.asarray(blob["positions"], np.float32),
            np.asarray(blob["velocities"], np.float32), float(blob["mass"]))


def load_reference(n: int, mode: str, perturbed: bool = False):
    """A cached reference run (None where it was never cached)."""
    tag = "_perm" if perturbed else ""
    path = CACHE_DIR / f"pm_ref_n{n}_z50_seed42_{mode}{tag}.json"
    return json.loads(path.read_text()) if path.exists() else None


def run_engine(ics, mode: str, device, mesh=None):
    """``CosmologicalEngine`` on the gate's workload from ``ics``, run to
    completion in chunks of 10 (through the sharded PM on ``mesh``, whose
    first device is ``device``); returns (its series in the reference
    run's form, the engine)."""
    from nbody_tpu_torch.engines.cosmo import CosmologicalEngine

    pos, vel, mass = ics

    def ic_fn(generator, num_side, cfg, start_redshift, cosmo):
        return (torch.from_numpy(pos), torch.from_numpy(vel),
                torch.full((pos.shape[0],), mass, dtype=torch.float32))

    eng = CosmologicalEngine(
        num_particles=pos.shape[0], box_size_mpc=200.0, start_redshift=50.0,
        precision=mode, dm_ratio=5.0, seed=42, dim=2, n_grid=128,
        deposit="ngp", cosmo=ReferenceCosmology(), glitch_threshold=0.05,
        ic_fn=ic_fn, device=device, mesh=mesh)
    eng.run_to_completion(dz=1.0, chunk=10)
    return {
        "n": int(pos.shape[0]),
        "redshifts": [float(z) for z in eng.history["redshift"][1:]],
        "energies": [float(e) for e in eng.history["energy"]],
        "momenta": [[float(p[0]), float(p[1])]
                    for p in eng.glitch_detector.momentum_history],
        "final_pos": eng.positions.cpu().numpy().tolist(),
    }, eng


def detector_counts(energies, momenta, threshold: float = 0.05):
    """The reference GlitchDetector's energy-jump and momentum-drift logic
    (universe_2d.py:355-401), applied identically to both series."""
    e_events = 0
    hist = []
    for e in energies:
        hist.append(e)
        if len(hist) < 3:
            continue
        prev = hist[-2]
        if prev != 0 and abs(hist[-1] - prev) / abs(prev + 1e-10) > threshold:
            e_events += 1
    m_events = 0
    mh = []
    for p in momenta:
        mh.append(p)
        if len(mh) < 2:
            continue
        if math.hypot(p[0], p[1]) > threshold * 1000.0:
            m_events += 1
    return e_events, m_events


def drift_curve(energies):
    """Per-step energy drift vs the first recorded energy, in percent."""
    e0 = energies[0]
    return [(e - e0) / abs(e0) * 100.0 for e in energies]


def clustering_contrast(final_pos, box: float = 200.0, n_grid: int = 32):
    """density std/mean on a coarse NGP grid (universe_2d.py:1279-1293),
    numpy, applied to both sides."""
    pos = np.asarray(final_pos)
    ij = (pos / box * n_grid).astype(np.int64) % n_grid
    density = np.zeros((n_grid, n_grid))
    np.add.at(density, (ij[:, 0], ij[:, 1]), 1.0)
    return float(density.std() / density.mean())


def drift_at_z(drifts, redshifts, z_target: float):
    idx = int(np.argmin(np.abs(np.asarray(redshifts) - z_target)))
    return drifts[idx]


def compare_mode(ref: dict, ours: dict, twin: dict | None) -> dict:
    """The gate's row: drift envelope, event counts and clustering of
    ``ours`` against ``ref`` (widened by the reference's own chaos where
    its permuted twin exists); ``row["agree"]`` is the verdict."""
    ref_drift = drift_curve(ref["energies"])
    our_drift = drift_curve(ours["energies"])
    steps = min(len(ref_drift), len(our_drift))

    spread = 0.0
    e_ev_spread = 0
    clus_spread = 0.0
    if twin is not None:
        twin_drift = drift_curve(twin["energies"])
        spread = abs(ref_drift[-1] - twin_drift[-1])
        te, _ = detector_counts(twin["energies"], twin["momenta"])
        re_, _ = detector_counts(ref["energies"], ref["momenta"])
        e_ev_spread = abs(re_ - te)
        clus_spread = abs(clustering_contrast(ref["final_pos"])
                          - clustering_contrast(twin["final_pos"]))

    final_ref, final_our = ref_drift[steps - 1], our_drift[steps - 1]
    scale = max(abs(final_ref), abs(final_our), 1.0)
    # Envelope: half the drift magnitude class, floored at 5 percentage
    # points, widened by 2x the reference's self-chaos.
    tol = max(0.5 * scale, 5.0, 2.0 * spread)
    drift_agree = abs(final_ref - final_our) < tol

    re_ev, rm_ev = detector_counts(ref["energies"], ref["momenta"])
    oe_ev, om_ev = detector_counts(ours["energies"], ours["momenta"])
    ev_tol = max(2, 2 * e_ev_spread)
    events_agree = (abs(re_ev - oe_ev) <= ev_tol
                    and abs(rm_ev - om_ev) <= 2)

    clus_ref = clustering_contrast(ref["final_pos"])
    clus_our = clustering_contrast(ours["final_pos"])
    clus_tol = max(0.25 * clus_ref, 2.0 * clus_spread)
    clus_agree = abs(clus_ref - clus_our) < clus_tol

    return {
        "n": ref["n"], "steps": steps,
        "final_drift_reference": final_ref,
        "final_drift_ours": final_our,
        "envelope_tolerance": tol,
        "drift_envelope_agree": bool(drift_agree),
        "drift_at_z10_reference": drift_at_z(ref_drift, ref["redshifts"],
                                             10.0),
        "drift_at_z10_ours": drift_at_z(our_drift, ours["redshifts"], 10.0),
        "energy_events_reference": re_ev,
        "energy_events_ours": oe_ev,
        "momentum_events_reference": rm_ev,
        "momentum_events_ours": om_ev,
        "event_tolerance_energy": ev_tol,
        "events_agree": bool(events_agree),
        "clustering_reference": clus_ref,
        "clustering_ours": clus_our,
        "clustering_tolerance": clus_tol,
        "clustering_agree": bool(clus_agree),
        "agree": bool(drift_agree and events_agree and clus_agree),
    }


def row_text(label: str, row: dict) -> str:
    """One line of a gate row: drift, events, clustering, verdicts."""
    return (f"{label}: final drift ours {row['final_drift_ours']:+.4f}% vs "
            f"reference {row['final_drift_reference']:+.4f}% (tol "
            f"{row['envelope_tolerance']:.2f}) "
            f"{'AGREE' if row['drift_envelope_agree'] else 'DISAGREE'}; "
            f"events E/M ours {row['energy_events_ours']}/"
            f"{row['momentum_events_ours']} vs "
            f"{row['energy_events_reference']}/"
            f"{row['momentum_events_reference']} "
            f"{'AGREE' if row['events_agree'] else 'DISAGREE'}; clustering "
            f"ours {row['clustering_ours']:.4f} vs "
            f"{row['clustering_reference']:.4f} (tol "
            f"{row['clustering_tolerance']:.4f}) "
            f"{'AGREE' if row['clustering_agree'] else 'DISAGREE'}")
