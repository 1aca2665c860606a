"""Sharded particle mesh: particle-parallel PM over a 1-D mesh.

PyTorch counterpart of ``nbody_tpu.parallel.pm_sharded``. Particles are
sharded over the ring's 1-D ``ParticleMesh``; one controller drives every
shard with ``parallel/ring.py``'s collectives, in shard order:

* ``psum`` / ``pmin`` / ``pmax`` are ``ring._reduce`` on shard 0's device,
  handed back to each shard (``ring._replicate``); ``all_gather`` is
  ``ring._gather`` (a ``cat`` in shard order);
* the tiled ``psum_scatter`` is ``_reduce_scatter``: block t of every
  shard's tensor, summed in shard order 0..S-1 on shard t's device;
* the FFT's transposes are ``_all_to_all``: block u of every shard's
  tensor goes to shard u and the blocks are concatenated in shard order (a
  list of ``.to(device)`` copies; views on one device).

On a mesh of one every collective is the identity, so a mesh of one gives
the single-device engine's bits.

Two runners:

* ``run_pm_steps_sharded``, the replicated grid: each shard deposits its
  particles into a full grid, the grids are summed in shard order, the
  Poisson solve runs once on shard 0's device and its gradient grids go
  to every shard, and each shard gathers its own particles;
* ``run_pm_steps_sharded_fft``, the n_grid >= 256 path: the deposits are
  reduce-scattered to x-slabs, the Poisson solve runs slab-decomposed
  (``poisson_accel_slabs``), and the gradient grids stay slabs for the
  slab gather (positions all-gathered, each shard's partial gather from
  its slab, a reduce-scatter over the particle axis) or are all-gathered
  for a local gather.

The distributed Poisson solve writes out what GSPMD inserts for JAX: the
real FFT over each x-slab's local axes, an all-to-all that cuts axis 1
into S pieces (``torch.tensor_split``) so each shard holds whole x
columns, the FFT along x, the quantized-k^2 division and the gradient
multipliers on the shard's slice of ``pm._poisson_consts``, and the
inverse in reverse. Axis 1 is the y axis for D=3 (n_grid entries, which
S divides on this path) and the half spectrum's n_grid/2 + 1 columns for
D=2, which no S > 1 divides: there the first (n_grid/2 + 1) % S shards
take one column more.

Phantom (padding) rows sit at the origin, not at the ring's far sentinel
``ring._PAD_FAR``: ``p / box * n`` at 2e18 overflows the int32 cell
index. They weigh 0 in every deposit, their accelerations are zeroed
before and after the force quantizer, and they stay out of its bounds and
of the stream's sums. ``gather=False`` returns the state padded to the
shard boundary on the mesh's first device (the ring's convention for
resident state); pass it back with ``n_valid=<real N>``.

Each shard's deposit is the ``pm_deposit`` kernel on its 1/S of the
particles (``ops/pm.py``), so S > 1 sums the grid in another order than
one deposit does, as JAX's ``psum`` does.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from nbody_tpu_torch.diagnostics import glitch as glitch_lib
from nbody_tpu_torch.engines.cosmo import CosmoState, PMConfig, StepStream
from nbody_tpu_torch.ops import pm
from nbody_tpu_torch.ops.precision import Precision, Quantizer, quantize_force
from nbody_tpu_torch.parallel.ring import (
    AXIS,
    ParticleMesh,
    _gather,
    _pad_to_shards,
    _reduce,
    _replicate,
    _shards,
    make_particle_mesh,
)

__all__ = ["AXIS", "GATHER_MODES", "ParticleMesh", "make_particle_mesh",
           "pm_accelerations_sharded", "poisson_accel_slabs",
           "run_pm_steps_sharded",
           "run_pm_steps_sharded_fft", "sharded_fft_density"]

GATHER_MODES = ("auto", "replicate", "slab")


# --------------------------------------------------------------------------
# Collectives of the slab decomposition
# --------------------------------------------------------------------------

def _reduce_scatter(values: list, mesh: ParticleMesh, dim: int = 0) -> list:
    """Tiled psum_scatter: shard t gets block t (``tensor_split`` along
    ``dim``) of every shard's value, summed in shard order on its device."""
    n = mesh.size
    blocks = [v.tensor_split(n, dim=dim) for v in values]
    out = []
    for t, dev in enumerate(mesh.devices):
        acc = blocks[0][t].to(dev)
        for b in blocks[1:]:
            acc = acc + b[t].to(dev)
        out.append(acc)
    return out


def _all_to_all(values: list, mesh: ParticleMesh, split: int,
                cat: int) -> list:
    """Shard u gets block u (``tensor_split`` along ``split``) of every
    shard's value, concatenated in shard order along ``cat``."""
    n = mesh.size
    blocks = [v.tensor_split(n, dim=split) for v in values]
    return [torch.cat([b[u].to(dev) for b in blocks], dim=cat)
            for u, dev in enumerate(mesh.devices)]


def _grid_means(slabs: list, mesh: ParticleMesh, cells: int) -> list:
    """The mean of a grid held as x-slabs, on every shard: ``torch.mean``
    on a mesh of one (the single-device bits), else the psum of the
    per-slab sums over the cell count."""
    if mesh.size == 1:
        return [torch.mean(slabs[0])]
    return _replicate(_reduce([s.sum() for s in slabs], torch.add, mesh)
                      / cells, mesh)


@functools.lru_cache(maxsize=16)
def _slab_consts(n_grid: int, box_size: float, dim: int, q: Quantizer,
                 devices: tuple) -> list:
    """Per shard: its slice along axis 1 of the half spectrum's constants
    (quantized k^2, the k = 0 mask, the gradient multipliers), on its
    device. The quantizer runs on the whole spectrum (its tensor-global
    bounds), before the cut."""
    k_sq_q, k0, grads = pm._poisson_consts(n_grid, box_size, dim, q,
                                           devices[0])
    n = len(devices)
    parts = [t.tensor_split(n, dim=1) for t in [k_sq_q, k0, *grads]]
    return [tuple(p[u].to(dev) for p in parts)
            for u, dev in enumerate(devices)]


@functools.lru_cache(maxsize=16)
def _dm_slabs(box_size: float, n_grid: int, dm_ratio: float, dim: int,
              devices: tuple) -> list:
    """The dark-matter background as x-slabs, slab t on shard t's device."""
    dm = pm.dm_background_field(box_size, n_grid, dm_ratio, dim, devices[0])
    return [b.to(dev) for b, dev in
            zip(dm.tensor_split(len(devices), dim=0), devices)]


def warm_constants(cfg: PMConfig, q: Quantizer, mesh: ParticleMesh) -> None:
    """Build the slab path's constants on every shard's device at set-up,
    so that no step waits on their copies."""
    if cfg.n_grid % mesh.size == 0:
        _slab_consts(cfg.n_grid, cfg.box_size, cfg.dim, q, mesh.devices)
        if cfg.dm_ratio > 0:
            _dm_slabs(cfg.box_size, cfg.n_grid, cfg.dm_ratio, cfg.dim,
                      mesh.devices)


# --------------------------------------------------------------------------
# The distributed Poisson solve
# --------------------------------------------------------------------------

def poisson_accel_slabs(slabs: list, box_size: float, n_grid: int,
                        q: Quantizer, G: float, scales: list, dim: int,
                        mesh: ParticleMesh) -> list:
    """``pm.poisson_accel_grids`` on a density held as x-slabs (slab t on
    shard t's device; ``scales``: the scale factor on each shard's device).
    Returns, per shard, its x-slab of each of the D gradient grids. A mesh
    of one calls ``pm.poisson_accel_grids`` itself."""
    if mesh.size == 1:
        return [pm.poisson_accel_grids(slabs[0], box_size, n_grid, q, G,
                                       scales[0], dim)]
    local = tuple(range(1, dim))
    means = _grid_means(slabs, mesh, n_grid ** dim)
    spec = [torch.fft.rfftn((s - m) / (m + 1e-10), dim=local)
            for s, m in zip(slabs, means)]
    spec = _all_to_all(spec, mesh, split=1, cat=0)
    consts = _slab_consts(n_grid, box_size, dim, q, mesh.devices)
    out = [[] for _ in range(dim)]
    for x, m, scale, (k_sq_q, k0, *grads) in zip(spec, means, scales,
                                                 consts):
        if not x.numel():
            # More shards than the half spectrum's n_grid // 2 + 1
            # columns: this shard holds none (an FFT of nothing raises).
            for d in range(dim):
                out[d].append(x)
            continue
        delta_k = torch.fft.fft(x, dim=0)
        phi_k = (-4.0 * math.pi * G * m) * delta_k / k_sq_q / scale
        phi_k = torch.where(k0, torch.zeros_like(phi_k), phi_k)
        for d in range(dim):
            out[d].append(torch.fft.ifft(grads[d] * phi_k, dim=0))
    grids = [[torch.fft.irfftn(b, s=(n_grid,) * (dim - 1), dim=local)
              for b in _all_to_all(out[d], mesh, split=0, cat=1)]
             for d in range(dim)]
    return [[grids[d][t] for d in range(dim)] for t in range(mesh.size)]


# --------------------------------------------------------------------------
# The runners
# --------------------------------------------------------------------------

class _Layout(NamedTuple):
    """A state padded to the shard boundary and cut into shards."""

    n_total: int
    masses: torch.Tensor   # padded, on the state's device
    pos: list              # per shard
    vel: list
    mass: list
    valid: list            # bool per row
    weight: list           # float32 of valid: 1 real, 0 phantom


def _layout(positions, velocities, masses, mesh: ParticleMesh,
            n_valid) -> _Layout:
    """Phantom rows at the origin with zero mass and velocity."""
    mesh.require_single_controller("the sharded particle mesh")
    n_total = n_valid if n_valid is not None else positions.shape[0]
    pos, vel, m = (_pad_to_shards(x, mesh.size)
                   for x in (positions, velocities, masses))
    ids = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    p_l, v_l, m_l, ids_l = (_shards(x, mesh) for x in (pos, vel, m, ids))
    valid = [i < n_total for i in ids_l]
    return _Layout(n_total, m, p_l, v_l, m_l, valid,
                   [ok.to(torch.float32) for ok in valid])


def _quantized(acc: list, valid: list, q: Quantizer, mesh: ParticleMesh,
               masked) -> list:
    """quantize_force on the global bounds of the real rows (pmin / pmax of
    the masked per-shard extrema), phantom rows masked by ``masked``."""
    lo = _reduce([torch.amin(torch.where(ok[:, None], a, math.inf))
                  for a, ok in zip(acc, valid)], torch.minimum, mesh)
    hi = _reduce([torch.amax(torch.where(ok[:, None], a, -math.inf))
                  for a, ok in zip(acc, valid)], torch.maximum, mesh)
    return [masked(quantize_force(a, q, lo=lo_s, hi=hi_s), s)
            for s, (a, lo_s, hi_s) in enumerate(
                zip(acc, _replicate(lo, mesh), _replicate(hi, mesh)))]


def _wants_quantizer(q: Quantizer, quantize_forces: bool) -> bool:
    """The PM engines quantize forces for INT4 / INT8 only, not CUSTOM
    (engines.cosmo.pm_accelerations)."""
    return quantize_forces and q.mode in (Precision.INT4_SIM,
                                          Precision.INT8_SIM)


def _run(state: CosmoState, schedule, cfg: PMConfig, mesh: ParticleMesh,
         force, lay: _Layout, gather: bool):
    """The step loop of both runners over a host (z, dt, H, a) schedule:
    ``force(p_l, scales)`` gives each shard's accelerations; integration
    and the StepStream are engines.cosmo.run_pm_steps's, per shard, the
    sums psum'd in shard order. No host read."""
    p_l, v_l = lay.pos, lay.vel
    sched_host = np.stack([np.asarray(x, np.float32) for x in schedule])
    steps = sched_host.shape[1]
    on = {d: glitch_lib.to_device_async(sched_host, d)
          for d in dict.fromkeys(mesh.devices)}
    sched = [on[d] for d in mesh.devices]
    mw = [m * w for m, w in zip(lay.mass, lay.weight)]
    kes, moms, subs = [], [], []
    for i in range(steps):
        acc = force(p_l, [s[3, i] for s in sched])
        v_l = [v + a * s[1, i]
               - cfg.hubble_drag * s[2, i] * v * s[1, i] * cfg.unit_scale
               for v, a, s in zip(v_l, acc, sched)]
        p_l = [(p + v * s[1, i] / s[3, i] * cfg.unit_scale) % cfg.box_size
               for p, v, s in zip(p_l, v_l, sched)]
        kes.append(_reduce([0.5 * torch.sum(m * torch.sum(v * v, dim=-1))
                            for m, v in zip(mw, v_l)], torch.add, mesh))
        moms.append(_reduce([torch.sum(m[:, None] * v, dim=0)
                             for m, v in zip(mw, v_l)], torch.add, mesh))
        subs.append(_reduce(
            [glitch_lib.count_subnormals(
                torch.where(ok[:, None], p, 1.0)).subnormal_count
             for p, ok in zip(p_l, lay.valid)], torch.add, mesh))
    pos, vel = _gather(p_l, mesh), _gather(v_l, mesh)
    n = lay.n_total
    if gather:
        pos, vel, masses = pos[:n], vel[:n], state.masses
    else:
        masses = lay.masses.to(mesh.devices[0])
    new = CosmoState(pos, vel, masses, float(sched_host[0, -1]),
                     state.tick + steps)
    return new, StepStream(torch.stack(kes), torch.stack(moms),
                           torch.stack(subs), sched[0][0])


def _local_pm_accel(mesh: ParticleMesh, pos_l: list, mass_l: list,
                    valid_l: list, q: Quantizer, cfg: PMConfig,
                    scale) -> list:
    """The replicated-grid PM force of every shard: per-shard deposits of
    m * valid summed in shard order (psum), the dark-matter background,
    one Poisson solve on shard 0's device whose grids go to every shard,
    and each shard's local gather. ``valid_l``: float32 weights (1 real, 0
    phantom); ``scale`` on shard 0's device."""
    deposit = pm.cic_deposit if cfg.deposit == "cic" else pm.ngp_deposit
    gather = pm.cic_gather if cfg.deposit == "cic" else pm.ngp_gather
    density = _reduce([deposit(p, m * w, cfg.n_grid, cfg.box_size)
                       for p, m, w in zip(pos_l, mass_l, valid_l)],
                      torch.add, mesh)
    if cfg.dm_ratio > 0:
        dm = pm.dm_background_field(cfg.box_size, cfg.n_grid, cfg.dm_ratio,
                                    cfg.dim, density.device)
        density = density + dm * torch.mean(density)
    grids = pm.poisson_accel_grids(density, cfg.box_size, cfg.n_grid, q,
                                   cfg.G, scale, cfg.dim)
    on = [_replicate(g, mesh) for g in grids]
    return [gather([g[s] for g in on], p, cfg.n_grid, cfg.box_size)
            for s, p in enumerate(pos_l)]


def _replicated_force(lay: _Layout, q: Quantizer, cfg: PMConfig,
                      mesh: ParticleMesh, quantize_forces: bool):
    """force(p_l, scales) of the replicated-grid runner: phantom rows
    zeroed before and after the quantizer."""
    def masked(a, s):
        return torch.where(lay.valid[s][:, None], a, 0.0)

    def force(p_l, scales):
        acc = _local_pm_accel(mesh, p_l, lay.mass, lay.weight, q, cfg,
                              scales[0])
        acc = [masked(a, s) for s, a in enumerate(acc)]
        if _wants_quantizer(q, quantize_forces):
            acc = _quantized(acc, lay.valid, q, mesh, masked)
        return acc

    return force


def _deposit_scattered(pos_l: list, mass_l: list, valid_l: list,
                       cfg: PMConfig, mesh: ParticleMesh) -> list:
    """Each shard deposits its particles into a full local grid; the
    reduce-scatter in shard order leaves shard t holding x-slab t of the
    summed density."""
    deposit = pm.cic_deposit if cfg.deposit == "cic" else pm.ngp_deposit
    return _reduce_scatter([deposit(p, m * w, cfg.n_grid, cfg.box_size)
                            for p, m, w in zip(pos_l, mass_l, valid_l)],
                           mesh)


def _slab_force(lay: _Layout, q: Quantizer, cfg: PMConfig,
                mesh: ParticleMesh, quantize_forces: bool, mode: str):
    """force(p_l, scales) of the slab-FFT runner with its gather ``mode``
    ("slab" or "replicate"); n_grid divisible by the mesh."""
    slab = cfg.n_grid // mesh.size
    gather_fn = pm.cic_gather if cfg.deposit == "cic" else pm.ngp_gather
    gather_slab = (pm.cic_gather_slab if cfg.deposit == "cic"
                   else pm.ngp_gather_slab)

    def masked(a, s):
        return a * lay.weight[s][:, None]

    def force(p_l, scales):
        density = _deposit_scattered(p_l, lay.mass, lay.weight, cfg, mesh)
        if cfg.dm_ratio > 0:
            means = _grid_means(density, mesh, cfg.n_grid ** cfg.dim)
            dm = _dm_slabs(cfg.box_size, cfg.n_grid, cfg.dm_ratio, cfg.dim,
                           mesh.devices)
            density = [d + b * m for d, b, m in zip(density, dm, means)]
        grids = poisson_accel_slabs(density, cfg.box_size, cfg.n_grid, q,
                                    cfg.G, scales, cfg.dim, mesh)
        if mode == "slab":
            p_full = _gather(p_l, mesh)
            parts = [gather_slab(g, p_full.to(dev), cfg.n_grid,
                                 cfg.box_size, t * slab)
                     for t, (g, dev) in enumerate(zip(grids, mesh.devices))]
            acc = _reduce_scatter(parts, mesh)
        else:
            full = [_gather([g[d] for g in grids], mesh)
                    for d in range(cfg.dim)]
            on = [_replicate(g, mesh) for g in full]
            acc = [gather_fn([g[s] for g in on], p, cfg.n_grid,
                             cfg.box_size) for s, p in enumerate(p_l)]
        acc = [masked(a, s) for s, a in enumerate(acc)]
        if _wants_quantizer(q, quantize_forces):
            acc = _quantized(acc, lay.valid, q, mesh, masked)
        return acc

    return force


def _route(gather_mode: str, cfg: PMConfig, mesh: ParticleMesh,
           n_total: int) -> str:
    """The slab-FFT runner's route: "slab" or "replicate", or "replicated"
    (the replicated-grid runner) where the mesh does not divide n_grid."""
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"unknown gather_mode: {gather_mode}; valid: "
                         f"{GATHER_MODES}")
    if cfg.n_grid % mesh.size:
        if gather_mode == "slab":
            raise ValueError(
                f"slab gather needs n_grid divisible by the mesh "
                f"(n_grid={cfg.n_grid}, shards={mesh.size}); use "
                f"gather_mode='auto' to fall back to the replicated grid")
        return "replicated"
    if gather_mode == "auto":
        return "slab" if cfg.n_grid ** cfg.dim > 2 * n_total else "replicate"
    return gather_mode


def _force(lay: _Layout, q: Quantizer, cfg: PMConfig, mesh: ParticleMesh,
           quantize_forces: bool, route: str):
    if route == "replicated":
        return _replicated_force(lay, q, cfg, mesh, quantize_forces)
    return _slab_force(lay, q, cfg, mesh, quantize_forces, route)


def run_pm_steps_sharded(state: CosmoState, schedule, q: Quantizer,
                         cfg: PMConfig, mesh: ParticleMesh,
                         quantize_forces: bool = True,
                         n_valid: int | None = None, gather: bool = True):
    """Sharded ``engines.cosmo.run_pm_steps`` on the replicated grid.

    Returns (state, StepStream) with the single-device runner's per-step
    diagnostics. ``gather=False`` returns the state padded to the shard
    boundary on the mesh's first device; pass it back with
    ``n_valid=<real N>`` so phantom rows stay frozen. ``gather=True``
    returns the real rows only."""
    lay = _layout(state.positions, state.velocities, state.masses, mesh,
                  n_valid)
    return _run(state, schedule, cfg, mesh,
                _replicated_force(lay, q, cfg, mesh, quantize_forces), lay,
                gather)


def run_pm_steps_sharded_fft(state: CosmoState, schedule, q: Quantizer,
                             cfg: PMConfig, mesh: ParticleMesh,
                             quantize_forces: bool = True,
                             gather_mode: str = "auto",
                             n_valid: int | None = None,
                             gather: bool = True):
    """Large-grid sharded PM: the deposit reduce-scattered to x-slabs, the
    slab-decomposed Poisson solve with the quantized-|k|^2 hook, and the
    gather.

    ``gather_mode``: ``"replicate"`` all-gathers the D gradient grids for
    a local gather on each shard; ``"slab"`` keeps them slabs,
    all-gathers the (N, D) positions, gathers each shard's partials from
    its slab and reduce-scatters them over the particle axis (2 N D
    floats moved instead of D n_grid^dim); ``"auto"`` takes the slab
    gather when the grid outweighs twice the particle rows. With n_grid
    not divisible by the mesh, ``"auto"`` and ``"replicate"`` fall back
    to ``run_pm_steps_sharded`` and ``"slab"`` raises. ``n_valid`` /
    ``gather`` as in ``run_pm_steps_sharded``."""
    n_total = n_valid if n_valid is not None else state.positions.shape[0]
    route = _route(gather_mode, cfg, mesh, n_total)
    lay = _layout(state.positions, state.velocities, state.masses, mesh,
                  n_valid)
    return _run(state, schedule, cfg, mesh,
                _force(lay, q, cfg, mesh, quantize_forces, route), lay,
                gather)


def pm_accelerations_sharded(positions, masses, q: Quantizer, cfg: PMConfig,
                             mesh: ParticleMesh, scale,
                             quantize_forces: bool, route: str,
                             n_valid: int | None = None) -> torch.Tensor:
    """One force evaluation of a runner's ``route``: "replicated" (the
    replicated-grid runner) or a ``gather_mode`` of the slab-FFT runner,
    resolved as it resolves it: ``engines.cosmo.pm_accelerations`` through
    the mesh, the (N, D) accelerations of the real rows on shard 0's
    device. ``scale`` on shard 0's device."""
    lay = _layout(positions, torch.zeros_like(positions), masses, mesh,
                  n_valid)
    if route != "replicated":
        route = _route(route, cfg, mesh, lay.n_total)
    scales = _replicate(torch.as_tensor(scale, device=mesh.devices[0]), mesh)
    acc = _force(lay, q, cfg, mesh, quantize_forces, route)(lay.pos, scales)
    return _gather(acc, mesh)[:lay.n_total]


def sharded_fft_density(positions, weights, n_grid: int, box_size: float,
                        mesh: ParticleMesh) -> torch.Tensor:
    """The density's full complex FFT with the grid held as x-slabs: each
    shard's NGP deposit reduce-scattered to slabs, the FFT over each
    slab's local axes, the all-to-all, the FFT along x. Returns the whole
    spectrum, in shard order, on shard 0's device (``torch.fft.fftn`` of
    the summed grid itself on a mesh of one)."""
    mesh.require_single_controller("the sharded particle mesh")
    pos = _pad_to_shards(positions, mesh.size)
    w = _pad_to_shards(weights, mesh.size)
    slabs = _reduce_scatter([pm.ngp_deposit(p, ws, n_grid, box_size)
                             for p, ws in zip(_shards(pos, mesh),
                                              _shards(w, mesh))], mesh)
    if mesh.size == 1:
        return torch.fft.fftn(slabs[0])
    local = tuple(range(1, positions.shape[1]))
    spec = _all_to_all([torch.fft.fftn(s, dim=local) for s in slabs], mesh,
                       split=1, cat=0)
    return torch.cat([torch.fft.fft(x, dim=0).to(mesh.devices[0])
                      for x in spec], dim=1)
