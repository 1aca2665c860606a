"""On-device simulation diagnostics.

PyTorch counterpart of ``nbody_tpu.diagnostics.metrics``. Every function
runs on the tensors' device and returns device tensors; nothing here
waits on the host, so a run takes its snapshots on the device and copies
them to the host once (``to_host`` / ``stack_snapshots``). The JAX
package's compensated (double-double) sums become float64 accumulation;
potential energy keeps f32 pair terms with an f64 sum, row-blocked, and
past ``hopper_nbody.TILED_MIN_N`` particles on the card sums the f32 rows
of the pair_pe_rows kernel in f64 instead (``energy_route``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody as hn

# Which sum the routed potential energy takes on the card: "kernel" (the
# route of energy_route) or "plain" (the O(N^2) f64 sum of f32 terms at
# every N), which an A/B of a whole path sets for that path's run.
ENERGY_DESIGN = "kernel"


# --------------------------------------------------------------------------
# Energies (reference: simulation.py:170-196)
# --------------------------------------------------------------------------

def kinetic_energy(velocities, masses) -> torch.Tensor:
    """KE = 0.5 * sum_i m_i |v_i|^2: f32 |v|^2, f64 products and sum."""
    v_sq = (velocities * velocities).sum(dim=-1)
    return 0.5 * (masses.to(torch.float64) * v_sq.to(torch.float64)).sum()


def energy_route(n: int, device_type: str, compensated: bool = False) -> str:
    """Which sum potential_energy takes for n particles on a device of
    ``device_type``: "kernel" (the f64 sum of pair_pe_rows' f32 rows, the
    tile JAX's ring runs for the same sum) on the card past
    hn.TILED_MIN_N particles, else "plain" (f64 sums of f32 pair terms).
    ``compensated`` (the float64 baseline's precision anchor) keeps the
    plain sum at every N: the kernel's f32 row sums add a rounding the
    anchor must not carry (parallel/ring.py's energy pass does the same)."""
    return ("kernel" if device_type == "cuda" and n > hn.TILED_MIN_N
            and not compensated else "plain")


def pe_rows_energy(positions, masses, cfg: SimConfig,
                   softening_sq) -> torch.Tensor:
    """U = -G/2 * (the f64 sum of pair_pe_rows' rows) over one set with its
    own ids: every unordered pair is in two rows. 0-d f64."""
    pos = positions.to(torch.float32).contiguous()
    m = masses.to(torch.float32).contiguous()
    ids = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    rows = hn.pair_pe_rows(pos, m, ids, pos, m, ids, softening_sq)
    return -0.5 * cfg.G * rows.to(torch.float64).sum()


def potential_energy(positions, masses, cfg: SimConfig,
                     block: int = 1024, softening_sq=None,
                     compensated: bool = False) -> torch.Tensor:
    """U = -G * sum_{i<j} m_i m_j / sqrt(|x_i - x_j|^2 + eps^2).

    Row-blocked (O(block * N) memory), f32 pair terms summed in f64;
    counts every unordered pair once via 0.5x the full masked matrix; on
    the card past hn.TILED_MIN_N particles, unless ``compensated``, the
    pair_pe_rows kernel's rows summed in f64 (``energy_route``,
    ``pe_rows_energy``). ``softening_sq`` optionally replaces cfg's (a
    run-time value)."""
    if softening_sq is None:
        softening_sq = cfg.softening_sq
    if ENERGY_DESIGN == "kernel" and energy_route(
            positions.shape[0], positions.device.type,
            compensated) == "kernel":
        return pe_rows_energy(positions, masses, cfg, softening_sq)
    pos = positions.to(torch.float32)
    m = masses.to(torch.float32)
    ids = torch.arange(pos.shape[0], device=pos.device)
    return -0.5 * cfg.G * pair_potential_sum(pos, m, ids, pos, m, ids,
                                             softening_sq, block)


def pair_potential_sum(pos_i, m_i, ids_i, pos_j, m_j, ids_j, softening_sq,
                       block: int = 1024) -> torch.Tensor:
    """sum over (i, j) with ids_i != ids_j of m_i m_j / sqrt(|x_i - x_j|^2
    + eps^2) between receivers i and sources j (f32): f32 terms summed in
    f64, row-blocked. One set gives twice the pairwise potential sum; the
    multi-device ring's compensated energy pass sums it over shard pairs.
    0-d f64."""
    total = torch.zeros((), dtype=torch.float64, device=pos_i.device)
    for r0 in range(0, pos_i.shape[0], block):
        diff = pos_j[None, :, :] - pos_i[r0:r0 + block, None, :]
        d2 = (diff * diff).sum(dim=-1) + softening_sq
        pair = m_i[r0:r0 + block, None] * m_j[None, :] * torch.rsqrt(d2)
        pair = torch.where(ids_i[r0:r0 + block, None] != ids_j[None, :],
                           pair, 0.0)
        total = total + pair.to(torch.float64).sum()
    return total


def total_energy(positions, velocities, masses, cfg: SimConfig,
                 softening_sq=None, compensated: bool = False) -> torch.Tensor:
    return kinetic_energy(velocities, masses) + potential_energy(
        positions, masses, cfg, softening_sq=softening_sq,
        compensated=compensated)


# --------------------------------------------------------------------------
# Structure diagnostics (reference: metrics.py:25-156)
# --------------------------------------------------------------------------

class RotationCurve(NamedTuple):
    radii: torch.Tensor       # (num_bins,) bin centers
    velocities: torch.Tensor  # (num_bins,) mean tangential velocity (nan if empty)
    counts: torch.Tensor      # (num_bins,) stars per bin


def _radius(positions) -> torch.Tensor:
    return torch.sqrt((positions * positions).sum(dim=-1))


def rotation_curve(positions, velocities, num_bins: int = 20,
                   max_radius=None) -> RotationCurve:
    """Mean tangential velocity vs radius — the dark-matter diagnostic
    (reference: metrics.py:25-78). Binned with a one-hot mask and plain
    sums, so the result does not depend on atomics' order."""
    r = _radius(positions)
    if max_radius is None:
        max_radius = r.max()
    else:
        max_radius = torch.as_tensor(max_radius, dtype=torch.float32,
                                     device=positions.device)
    lz = positions[:, 0] * velocities[:, 1] - positions[:, 1] * velocities[:, 0]
    v_t = torch.abs(lz) / torch.clamp(r, min=0.1)

    steps = torch.arange(num_bins + 1, dtype=torch.float32,
                         device=positions.device)
    edges = steps * (max_radius / num_bins)
    centers = 0.5 * (edges[:-1] + edges[1:])
    bin_width = max_radius / num_bins
    idx = torch.clamp(torch.floor(r / torch.clamp(bin_width, min=1e-9)),
                      0, num_bins - 1).to(torch.int64)
    onehot = idx[:, None] == torch.arange(num_bins, device=positions.device)
    sums = torch.where(onehot, v_t[:, None], 0.0).sum(dim=0)
    counts = onehot.sum(dim=0)
    means = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                        float("nan"))
    return RotationCurve(centers, means, counts.to(torch.int32))


def galaxy_radius(positions, percentile: float = 90.0) -> torch.Tensor:
    """Radius containing `percentile`% of particles (reference: metrics.py:81-95)."""
    r = _radius(positions)
    n = r.shape[0]
    k = min(int(n * percentile / 100.0), n - 1)
    return torch.sort(r).values[k]


def bound_fraction(positions, velocities, masses,
                   G: float = 0.001) -> torch.Tensor:
    """Fraction of particles with v < v_escape from the enclosed mass
    (reference: metrics.py:98-145): sort by radius from the center of
    mass, cumsum masses for M(<r), compare |v| to sqrt(2 G M / r)."""
    total_mass = masses.sum()
    com = (positions * masses[:, None]).sum(dim=0) / total_mass
    r = _radius(positions - com)
    order = torch.argsort(r, stable=True)
    cum_mass = torch.cumsum(masses[order], dim=0)
    enclosed = torch.empty_like(masses).scatter_(0, order, cum_mass)
    v_esc = torch.sqrt(2.0 * G * enclosed / torch.clamp(r, min=0.1))
    v_mag = _radius(velocities)
    return (v_mag < v_esc).to(torch.float32).mean()


def velocity_dispersion(velocities) -> torch.Tensor:
    """Std of |v| — heating indicator (reference: metrics.py:148-156)."""
    return torch.std(_radius(velocities), correction=0)


# --------------------------------------------------------------------------
# Snapshot
# --------------------------------------------------------------------------

class Snapshot(NamedTuple):
    """Everything collect_metrics records (reference: metrics.py:159-179)."""

    tick: object
    kinetic: object
    potential: object
    total: object
    radius_90: object
    bound_frac: object
    dispersion: object
    curve_radii: object
    curve_velocities: object
    curve_counts: object


def snapshot(positions, velocities, masses, tick: int, cfg: SimConfig,
             num_bins: int = 20, potential=None,
             compensated: bool = False) -> Snapshot:
    """One snapshot of device tensors (``tick`` stays a host int).
    ``potential`` is the potential energy where the caller already has it
    (the multi-device ring's energy pass); else potential_energy's routed
    O(N^2) sum (``compensated``: the float64 baseline's plain sum)."""
    ke = kinetic_energy(velocities, masses)
    pe = (potential_energy(positions, masses, cfg, compensated=compensated)
          if potential is None else potential)
    curve = rotation_curve(positions, velocities, num_bins=num_bins)
    return Snapshot(
        tick=int(tick),
        kinetic=ke,
        potential=pe,
        total=ke + pe,
        radius_90=galaxy_radius(positions, 90.0),
        bound_frac=bound_fraction(positions, velocities, masses, cfg.G),
        dispersion=velocity_dispersion(velocities),
        curve_radii=curve.radii,
        curve_velocities=curve.velocities,
        curve_counts=curve.counts,
    )


def stack_snapshots(snaps) -> Snapshot:
    """Stack device snapshots along a leading interval axis and copy them
    to the host in one go: a Snapshot of numpy arrays."""
    fields = {"tick": np.asarray([s.tick for s in snaps], np.int64)}
    for name in Snapshot._fields[1:]:
        fields[name] = torch.stack(
            [getattr(s, name) for s in snaps]).cpu().numpy()
    return Snapshot(**fields)


def to_host(snap: Snapshot) -> Snapshot:
    """One device snapshot as numpy values."""
    return Snapshot(**{
        name: (np.asarray(v) if not isinstance(v, torch.Tensor)
               else v.cpu().numpy())
        for name, v in snap._asdict().items()})


def compare_rotation_curves(curve1, curve2):
    """Outer-slope flatness comparison (reference: metrics.py:182-227).

    Host-side (numpy) analysis of two RotationCurve-like dicts/tuples."""
    def field(c, name):
        v = c[name] if isinstance(c, dict) else getattr(c, name)
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        return np.asarray(v, dtype=float)

    v1, v2 = field(curve1, "velocities"), field(curve2, "velocities")
    r1 = field(curve1, "radii")

    valid = ~(np.isnan(v1) | np.isnan(v2))
    if valid.sum() == 0:
        return {"error": "No valid comparison points"}
    v1v, v2v, rv = v1[valid], v2[valid], r1[valid]
    outer = rv > np.median(rv)
    if outer.sum() > 2:
        slope1 = np.polyfit(rv[outer], v1v[outer], 1)[0]
        slope2 = np.polyfit(rv[outer], v2v[outer], 1)[0]
    else:
        slope1 = slope2 = 0.0
    return {
        "mean_velocity_diff": float((v2v - v1v).mean()),
        "outer_slope_baseline": float(slope1),
        "outer_slope_quantized": float(slope2),
        "flatness_increase": float(slope2 - slope1),
        "num_valid_bins": int(valid.sum()),
    }
