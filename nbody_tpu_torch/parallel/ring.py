"""Multi-device particle parallelism: ring-passed all-pairs forces.

PyTorch counterpart of ``nbody_tpu.parallel.ring``. Particles are sharded
over a 1-D mesh of S devices; the O(N^2) interaction is computed by
rotating *source* blocks around the ring while each shard accumulates the
forces on its resident receiver block. The int-sim modes take their
global log-grid bounds from a max ring pass first, and snapshots take the
potential energy from an energy ring pass.

One controller drives every shard. JAX writes the ring as a per-device
body under ``shard_map``; here a ``ParticleMesh`` is an ordered list of S
devices, one per shard, the per-device bodies of the JAX module take
lists of per-shard tensors, and each ring step is a Python loop over the
shards:

* ``ppermute`` is a list rotation (``_rotate``): shard s takes block
  (s - k) % S, a peer copy across GPUs and no copy on one device;
* ``psum`` / ``pmax`` / ``pmin`` reduce the per-shard values in shard
  order 0..S-1 on shard 0's device (``_reduce``) and hand the result back
  to each shard: a fixed order, so every run gives the same bits;
* ``all_gather`` is a ``torch.cat`` in shard order (``_gather``);
* ``axis_index`` is the loop index, so the even ring's half-distance step
  (JAX's ``lax.cond``) is a host-side ``if`` that costs no sync.

A shard's tensor is never updated in place: on one device the rotation
aliases one tensor between shards.

Why one controller: it is what ``shard_map`` over local devices is, and
JAX's ``--mesh`` takes local devices only; NCCL cannot put two ranks on
one GPU, and ``ParticleMesh.virtual(S, device)`` puts S shards on one
device (the counterpart of the forced host-device count the JAX tests run
the ring on), so a single card runs the tiles between shards, the even
ring's skipped step and the reactions' trip home.

Tiles: ``tile_impl="auto"`` is the kernel path, the wrappers of
``ops.hopper_nbody``, which launch their CUDA kernels for CUDA tensors and
take their plain PyTorch versions for CPU tensors. ``"jnp"`` names JAX's
plain id-masked broadcast tile: the reference the tests hold the kernel
path to (its zero-softening routing above all); it builds (B, B, D)
tensors and is never run on the card. JAX's TPU size thresholds for
picking a tile are not carried over. Sources are chunked where one pair
tile's per-tile scratch would pass ``hopper_nbody.SCRATCH_BUDGET`` (the
card's counterpart of the TPU's VMEM residency budget).

Equal masses: ``uniform_gm=True`` (the sym schedule only) sends the
diagonal and pair tiles to the sym kernels' equal-mass variants, where
each launch's full-tile rule still decides; it is switched off whenever
the padded layout has phantom rows (N % S != 0), which need G*m = 0 to
stay inert (JAX ring.py:818-832).

Zero softening: JAX routes the ring tiles to the id-masked broadcast
tile. The kernel path computes the same function: the diagonal block goes
to ``row_force`` with its self-mask, and blocks of two shards need no
mask, because distinct shards share no id. Phantom (padding) rows are
zeroed afterwards, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import metrics as metrics_lib
from nbody_tpu_torch.models.state import BaselineState, ParticleState
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import (
    Quantizer,
    dist_sq_log_bounds,
    quantize_distance_squared,
    quantize_force,
)

AXIS = "shards"

# Far sentinel of phantom (padding) positions (nbody_tpu.ops.pallas_nbody's
# _PAD_FAR): every phantom pair weight stays finite or zero in all modes.
_PAD_FAR = 2.0e18

SCHEDULES = ("sym", "rows")
TILE_IMPLS = ("auto", "jnp")


class EnergyStream(NamedTuple):
    """Per-chunk energies of a sharded run: KE from per-shard f64 sums, PE
    from the energy ring pass (the reference's headline drift observable,
    simulation.py:170-196). Each a (n_chunks,) f64 tensor."""

    kinetic: torch.Tensor
    potential: torch.Tensor
    total: torch.Tensor


class ParticleMesh:
    """A 1-D mesh: an ordered list of S devices, one per shard."""

    def __init__(self, devices):
        self.devices = tuple(_normalise(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @classmethod
    def virtual(cls, n_shards: int, device) -> "ParticleMesh":
        """S shards on one device: the whole ring, tiles between shards
        included, on one GPU (or the CPU)."""
        if n_shards < 1:
            raise ValueError("a mesh needs at least one shard")
        return cls([device] * n_shards)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    def __repr__(self) -> str:
        return f"ParticleMesh({[str(d) for d in self.devices]})"


def _normalise(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_particle_mesh(n_devices: int | None = None,
                       device="cuda") -> ParticleMesh:
    """1-D mesh over all (or the first n) local devices of ``device``'s
    type, as JAX takes ``jax.devices()[:n]``: every visible GPU for CUDA,
    the one CPU device otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"asked for a mesh of {n_devices} device(s); "
                             f"{len(devices)} {device.type} device(s) here")
        devices = devices[:n_devices]
    return ParticleMesh(devices)


# --------------------------------------------------------------------------
# Collectives of the single controller
# --------------------------------------------------------------------------

def _pad_to_shards(x: torch.Tensor, n_shards: int, fill=0.0) -> torch.Tensor:
    """Pad the leading axis to a multiple of n_shards. POSITION arrays
    must pass fill=_PAD_FAR: a phantom at the origin under zero softening
    collides with any real particle at the origin (0 * inf = NaN slips
    past the gm=0 guard). At the far sentinel every phantom pair weight is
    finite or zero in all modes, and the bounds and energy passes exclude
    phantoms by id."""
    pad = (-x.shape[0]) % n_shards
    if pad:
        x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                     dtype=x.dtype, device=x.device)])
    return x


def _shards(x: torch.Tensor, mesh: ParticleMesh) -> list:
    """x (padded to the shard boundary) as S equal blocks, block s on
    device s (views on one device)."""
    b = x.shape[0] // mesh.size
    return [x[s * b:(s + 1) * b].to(d, non_blocking=True)
            for s, d in enumerate(mesh.devices)]


def _gather(blocks: list, mesh: ParticleMesh) -> torch.Tensor:
    """all_gather: the blocks concatenated in shard order on shard 0's
    device."""
    return torch.cat([x.to(mesh.devices[0]) for x in blocks])


def _rotate(blocks: list, k: int, mesh: ParticleMesh) -> list:
    """ppermute by k: shard s takes block (s - k) % S."""
    n = mesh.size
    return [blocks[(s - k) % n].to(mesh.devices[s], non_blocking=True)
            for s in range(n)]


def _reduce(values: list, op, mesh: ParticleMesh) -> torch.Tensor:
    """psum / pmax / pmin: ``op`` over per-shard values in shard order, on
    shard 0's device."""
    home = mesh.devices[0]
    out = values[0].to(home)
    for v in values[1:]:
        out = op(out, v.to(home))
    return out


def _replicate(x: torch.Tensor, mesh: ParticleMesh) -> list:
    """One copy of x on every shard's device."""
    return [x.to(d) for d in mesh.devices]


def _valid(ids: list, n_total: int) -> list:
    return [i < n_total for i in ids]


# --------------------------------------------------------------------------
# Tiles
# --------------------------------------------------------------------------

def _resolve_tile_impl(tile_impl: str) -> str:
    """'auto' is the kernel path (hopper_nbody's wrappers: the CUDA
    kernels for CUDA tensors, their plain versions for CPU tensors);
    'jnp' the plain id-masked broadcast tile, the tests' reference."""
    if tile_impl not in TILE_IMPLS:
        raise ValueError(f"unknown tile impl: {tile_impl}; valid: "
                         f"{TILE_IMPLS}")
    return tile_impl


def _src_chunk_size(n_i: int, n_j: int, dim: int) -> int:
    """Source chunk of one pair_sym_force launch between n_i receivers and
    n_j sources: all n_j while the launch's per-tile scratch fits
    SCRATCH_BUDGET, else the largest multiple of TILE that fits (at least
    one tile), spread evenly over n_j. At N=1,048,576 over 2 shards one
    524288^2 tile would need ~35 GB."""
    def fits(c):
        return hn.pair_sym_force_scratch_bytes(n_i, c, dim) \
            <= hn.SCRATCH_BUDGET

    if fits(n_j):
        return n_j
    lo, hi = 1, -(-n_j // hn.TILE)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid * hn.TILE):
            lo = mid
        else:
            hi = mid - 1
    n_chunks = -(-n_j // (lo * hn.TILE))
    even = -(-n_j // n_chunks)
    return -(-even // hn.TILE) * hn.TILE


def _broadcast_w(xi, ids_i, xj, ids_j, q: Quantizer, cfg: SimConfig,
                 log_lo, log_hi):
    """The 'jnp' tile's (Bi, Bj) weights, pairs of equal id masked, and
    its (Bi, Bj, D) differences x_j - x_i."""
    diff = xj[None, :, :] - xi[:, None, :]
    d2 = (diff * diff).sum(dim=-1) + cfg.softening_sq
    d2q = quantize_distance_squared(d2, q, log_lo=log_lo, log_hi=log_hi)
    inv_d = torch.rsqrt(d2q.to(torch.float32))
    w = inv_d * inv_d * inv_d
    return torch.where(ids_i[:, None] == ids_j[None, :], 0.0, w), diff


def _tile_force(xi, ids_i, xj, gm_j, ids_j, q: Quantizer, cfg: SimConfig,
                log_lo, log_hi, impl: str = "auto",
                diagonal: bool = False) -> torch.Tensor:
    """(Bi, D) accelerations of receivers xi due to sources xj: the rows
    schedule's tile. The kernel path is pair_force (#10); ``diagonal``
    (xj is xi) at zero softening (or one too small for a finite self
    weight, hn.static_self_masked) takes row_force with its self-mask."""
    if _resolve_tile_impl(impl) == "auto":
        if diagonal and hn.static_self_masked(cfg):
            bounds = hn.kernel_bounds(xi, q, cfg, None, log_lo, log_hi)
            return hn.row_force(xi, gm_j, bounds, q, True)
        return hn.pair_force(xi, xj, gm_j, q, cfg, log_lo, log_hi)
    w, diff = _broadcast_w(xi, ids_i, xj, ids_j, q, cfg, log_lo, log_hi)
    return ((gm_j[None, :] * w)[:, :, None] * diff).sum(dim=1)


def _tile_force_sym(xi, gm_i, ids_i, xj, gm_j, ids_j, q: Quantizer,
                    cfg: SimConfig, log_lo, log_hi, impl: str,
                    uniform_gm: bool = False) -> tuple:
    """Newton's-third-law pair tile between two disjoint blocks: returns
    (acc_on_i, reaction_on_j) from ONE evaluation of the pair weights, the
    per-step tile of the half-ring schedule. The kernel path is
    pair_sym_force (#6), source-chunked past the scratch budget, each
    launch in its equal-mass variant under ``uniform_gm`` where the
    full-tile rule allows; it needs no id mask at any softening, since the
    blocks share no id. The 'jnp' tile ignores ``uniform_gm`` (the same
    function)."""
    if _resolve_tile_impl(impl) == "auto":
        bounds = hn.kernel_bounds(xi, q, cfg, None, log_lo, log_hi)
        nj = xj.shape[0]
        chunk = _src_chunk_size(xi.shape[0], nj, xi.shape[1])
        rows, cols = None, []
        for c0 in range(0, nj, chunk):
            sl = slice(c0, min(c0 + chunk, nj))
            r, c = hn.pair_sym_force(xi, gm_i, xj[sl], gm_j[sl], bounds, q,
                                     uniform=uniform_gm)
            rows = r if rows is None else rows + r
            cols.append(c)
        return rows, torch.cat(cols) if len(cols) > 1 else cols[0]
    w, diff = _broadcast_w(xi, ids_i, xj, ids_j, q, cfg, log_lo, log_hi)
    acc_i = ((gm_j[None, :] * w)[:, :, None] * diff).sum(dim=1)
    reac_j = -((gm_i[:, None] * w)[:, :, None] * diff).sum(dim=0)
    return acc_i, reac_j


def _diagonal_sym(pos, gm, ids, q: Quantizer, cfg: SimConfig, log_lo,
                  log_hi, impl: str, uniform_gm: bool = False) -> torch.Tensor:
    """A shard's intra-block accelerations for the sym schedule: sym_force
    (#1), or the chunked path (#5) past its scratch budget, with the
    ring's global int bounds (and the equal-mass variants under
    ``uniform_gm``, checked by the runner); zero softening (or one too
    small for a finite self weight) takes the self-masked row sweep."""
    if impl == "jnp" or hn.static_self_masked(cfg):
        return _tile_force(pos, ids, pos, gm, ids, q, cfg, log_lo, log_hi,
                           impl, diagonal=True)
    fn = (hn.sym_accelerations if hn.sym_force_fits(*pos.shape)
          else hn.sym_accelerations_chunked)
    return hn.prevalidated(fn)(pos, None, q, cfg, quantize_forces=False,
                               log_lo=log_lo, log_hi=log_hi, gm=gm,
                               uniform_gm=uniform_gm)


# --------------------------------------------------------------------------
# Ring passes
# --------------------------------------------------------------------------

def _ring_max_d2(mesh: ParticleMesh, pos: list, ids: list, n_total: int,
                 cfg: SimConfig) -> torch.Tensor:
    """Global max softened pairwise d^2 via a max-reduction ring pass of
    pair_max tiles (#9), on shard 0's device. Both sides of each tile
    mask their phantom rows, as the reference bounds span only the real
    (N, N) tensor. d^2 is symmetric and the result is pmax'd, so block
    pair {a, b} needs only one of its two shards to visit it: S//2 + 1
    ring steps, S * (S//2 + 1) launches. Max is exact: the result is
    bitwise the single-device max_d2 of the real particles."""
    valid = _valid(ids, n_total)
    best = [None] * mesh.size
    pos_j, valid_j = pos, valid
    for k in range(mesh.size // 2 + 1):
        if k:
            pos_j, valid_j = _rotate(pos_j, 1, mesh), _rotate(valid_j, 1,
                                                              mesh)
        for s in range(mesh.size):
            m = hn.pair_max(pos[s], pos_j[s], valid[s], valid_j[s])
            best[s] = m if best[s] is None else torch.maximum(best[s], m)
    return _reduce(best, torch.maximum, mesh) + cfg.softening_sq


def _ring_log_bounds(mesh, pos, ids, n_total, q: Quantizer,
                     cfg: SimConfig) -> tuple:
    """Per-shard (log_lo, log_hi) lists of the int-sim grid from the
    ring max pass."""
    lo, hi = dist_sq_log_bounds(q, _ring_max_d2(mesh, pos, ids, n_total,
                                                cfg), cfg.softening_sq)
    return _replicate(lo, mesh), _replicate(hi, mesh)


def _real_rows(mesh: ParticleMesh, x: list, n_total: int) -> list:
    """Each shard's real (non-phantom) rows: phantoms are the tail of the
    padded global order, so a prefix of each shard."""
    b = x[0].shape[0]
    return [xs[:min(max(n_total - s * b, 0), b)] for s, xs in enumerate(x)]


def _ring_pe_local(mesh: ParticleMesh, pos: list, m: list, ids: list,
                   n_total: int, cfg: SimConfig,
                   compensated: bool = False) -> torch.Tensor:
    """Pairwise potential energy via the same ring, 0-d f64 on shard 0's
    device: U = -G * sum_{i<j} m_i m_j / sqrt(|x_i - x_j|^2 + eps^2)
    (reference: simulation.py:176-192). Every unordered pair is visited
    twice across the S ring steps (once per direction), so the sum is
    halved.

    Each step's tile is pair_pe_rows (#7), whose f32 row sums are summed
    in f64 (the port's counterpart of JAX's dd_sum). ``compensated=True``
    (the float64 baseline's precision anchor) takes the plain tile with
    f64 sums of f32 terms (metrics.pair_potential_sum) instead: the
    kernel's f32 row sums add per-row rounding the anchor must not carry.
    Phantom rows are left out (not masked): at zero softening two
    coincident far-sentinel phantoms would give 0 * rsqrt(0) = NaN, and at
    eps^2 > 0 they add exact zeros."""
    pos_r, m_r, ids_r = (_real_rows(mesh, x, n_total) for x in (pos, m, ids))
    local = [torch.zeros((), dtype=torch.float64, device=d)
             for d in mesh.devices]
    pos_j, m_j, ids_j = pos_r, m_r, ids_r
    for k in range(mesh.size):
        if k:
            pos_j, m_j, ids_j = (_rotate(x, 1, mesh)
                                 for x in (pos_j, m_j, ids_j))
        for s in range(mesh.size):
            if not (pos_r[s].shape[0] and pos_j[s].shape[0]):
                continue  # a shard of phantoms only (N < S - 1 tiny)
            if compensated:
                part = metrics_lib.pair_potential_sum(
                    pos_r[s], m_r[s], ids_r[s], pos_j[s], m_j[s], ids_j[s],
                    cfg.softening_sq)
            else:
                part = hn.pair_pe_rows(pos_r[s], m_r[s], ids_r[s], pos_j[s],
                                       m_j[s], ids_j[s],
                                       cfg.softening_sq).to(
                                           torch.float64).sum()
            local[s] = local[s] + part
    return -0.5 * cfg.G * _reduce(local, torch.add, mesh)


def _finish_ring(mesh, acc: list, ids: list, n_total: int, q: Quantizer,
                 quantize_forces: bool) -> list:
    """Freeze phantom rows (they neither integrate nor enter the
    quantization bounds), then for int8/int4 quantize on the linear grid
    over the GLOBAL acc min/max (reference: quantization.py:74-88 on the
    full (N, D) tensor)."""
    valid = [(v < n_total)[:, None] for v in ids]
    acc = [torch.where(v, a, 0.0) for a, v in zip(acc, valid)]
    if quantize_forces and q.is_int:
        inf = float("inf")
        lo = _replicate(_reduce([torch.where(v, a, inf).min()
                                 for a, v in zip(acc, valid)],
                                torch.minimum, mesh), mesh)
        hi = _replicate(_reduce([torch.where(v, a, -inf).max()
                                 for a, v in zip(acc, valid)],
                                torch.maximum, mesh), mesh)
        acc = [torch.where(v, quantize_force(a, q, lo=lo[s], hi=hi[s]), 0.0)
               for s, (a, v) in enumerate(zip(acc, valid))]
    return acc


def _ring_accelerations_local(mesh: ParticleMesh, pos: list, gm: list,
                              ids: list, n_total: int, q: Quantizer,
                              cfg: SimConfig, quantize_forces: bool,
                              tile_impl: str = "auto") -> list:
    """The plain full ring (``schedule='rows'``): source blocks visit every
    shard, S steps of S tiles, every ordered pair evaluated; the kernel
    path launches pair_force (#10) S^2 times an evaluation. ``ids`` are
    global particle indices (>= n_total marks a phantom; phantoms carry
    zero G*m)."""
    if q.is_int:
        log_lo, log_hi = _ring_log_bounds(mesh, pos, ids, n_total, q, cfg)
    else:
        log_lo = log_hi = [None] * mesh.size
    acc = [None] * mesh.size
    pos_j, gm_j, ids_j = pos, gm, ids
    for k in range(mesh.size):
        if k:
            pos_j, gm_j, ids_j = (_rotate(x, 1, mesh)
                                  for x in (pos_j, gm_j, ids_j))
        for s in range(mesh.size):
            a = _tile_force(pos[s], ids[s], pos_j[s], gm_j[s], ids_j[s], q,
                            cfg, log_lo[s], log_hi[s], tile_impl,
                            diagonal=k == 0)
            acc[s] = a if acc[s] is None else acc[s] + a
    return _finish_ring(mesh, acc, ids, n_total, q, quantize_forces)


def _ring_accelerations_sym_local(mesh: ParticleMesh, pos: list, gm: list,
                                  ids: list, n_total: int, q: Quantizer,
                                  cfg: SimConfig, quantize_forces: bool,
                                  tile_impl: str = "auto",
                                  ext_bounds=None,
                                  uniform_gm: bool = False) -> list:
    """Half-ring Newton's-third-law schedule: every unordered pair once.

    Source blocks travel only HALF way around the ring (S//2 hops); each
    visited tile is evaluated once for both its direct and reaction forces
    (pair_sym_force, #6), and the reaction accumulator rides along with
    the traveling block; one final rotation by -S//2 delivers every
    block's reactions home. The diagonal block uses the single-device
    symmetric kernel (#1, or #5 past its scratch budget). An evaluation
    launches S sym_force and S(S-1)/2 pair_sym_force (unchunked). For an
    even ring the half-distance step is seen from both ends; only the
    lower half of the ring computes it. ``ext_bounds`` are per-shard
    (log_lo, log_hi) lists owned by the caller (bounds reuse);
    ``uniform_gm`` reaches every tile (phantom-free layouts only)."""
    n = mesh.size
    if ext_bounds is not None:
        log_lo, log_hi = ext_bounds
    elif q.is_int:
        log_lo, log_hi = _ring_log_bounds(mesh, pos, ids, n_total, q, cfg)
    else:
        log_lo = log_hi = [None] * n
    impl = _resolve_tile_impl(tile_impl)

    acc = [_diagonal_sym(pos[s], gm[s], ids[s], q, cfg, log_lo[s],
                         log_hi[s], impl, uniform_gm) for s in range(n)]
    racc = [torch.zeros_like(p) for p in pos]
    pos_j, gm_j, ids_j = pos, gm, ids

    def visit(s):
        d_acc, d_reac = _tile_force_sym(pos[s], gm[s], ids[s], pos_j[s],
                                        gm_j[s], ids_j[s], q, cfg, log_lo[s],
                                        log_hi[s], impl, uniform_gm)
        acc[s] = acc[s] + d_acc
        racc[s] = racc[s] + d_reac

    half = n // 2
    # Ring distances 1..half (odd S) / 1..half-1 (even S: the half-distance
    # step is seen from both ends and handled below).
    n_uncond = half + 1 if n % 2 else half
    for _ in range(1, n_uncond):
        pos_j, gm_j, ids_j, racc = (_rotate(x, 1, mesh)
                                    for x in (pos_j, gm_j, ids_j, racc))
        for s in range(n):
            visit(s)
    if n % 2 == 0 and n > 1:
        pos_j, gm_j, ids_j, racc = (_rotate(x, 1, mesh)
                                    for x in (pos_j, gm_j, ids_j, racc))
        for s in range(half):
            visit(s)
    if half:
        home = _rotate(racc, -half, mesh)
        acc = [a + r for a, r in zip(acc, home)]
    return _finish_ring(mesh, acc, ids, n_total, q, quantize_forces)


def _ring_accelerations_dd_local(mesh: ParticleMesh, pos: list, gm: list,
                                 ids: list, n_total: int,
                                 cfg: SimConfig) -> list:
    """Ring force of the float64 baseline: native f64 pair terms and sums
    (forces.baseline_pair_accelerations), the counterpart of JAX's
    double-double ring as the port's single-device baseline is native
    f64. Phantom rows zeroed."""
    acc = [None] * mesh.size
    pos_j, gm_j, ids_j = pos, gm, ids
    for k in range(mesh.size):
        if k:
            pos_j, gm_j, ids_j = (_rotate(x, 1, mesh)
                                  for x in (pos_j, gm_j, ids_j))
        for s in range(mesh.size):
            a = forces.baseline_pair_accelerations(pos[s], ids[s], pos_j[s],
                                                   gm_j[s], ids_j[s], cfg)
            acc[s] = a if acc[s] is None else acc[s] + a
    return [torch.where((i < n_total)[:, None], a, 0.0)
            for a, i in zip(acc, ids)]


# --------------------------------------------------------------------------
# Runners
# --------------------------------------------------------------------------

def _check_run_args(schedule: str, bounds_every: int) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule: {schedule}; valid: {SCHEDULES}")
    if bounds_every < 1:
        raise ValueError("bounds_every must be >= 1")


def _padded(positions, velocities, masses, mesh: ParticleMesh) -> tuple:
    """Positions (far-sentinel), velocities and masses padded to the shard
    boundary, and the global ids (int32) of the padded order."""
    pos = _pad_to_shards(positions, mesh.size, fill=_PAD_FAR)
    vel = None if velocities is None else _pad_to_shards(velocities,
                                                          mesh.size)
    m = _pad_to_shards(masses, mesh.size)
    ids = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return pos, vel, m, ids


def _make_ring_force(mesh, q: Quantizer, cfg: SimConfig, gm, ids, n_total,
                     quantize_forces: bool, schedule: str,
                     bounds_reuse: bool, pos,
                     uniform_gm: bool = False) -> tuple:
    """(force, bounds_of, b0) for the sharded leapfrog loops. ``force(p,
    b)`` ignores ``b`` unless bounds reuse is active, where ``b`` is the
    externally owned per-shard log-grid bounds; b0 is the entry force's.
    ``uniform_gm`` reaches the sym schedule only (the rows schedule has no
    equal-mass variant)."""
    def bounds_of(p):
        return _ring_log_bounds(mesh, p, ids, n_total, q, cfg)

    if schedule == "sym":
        def force(p, b):
            return _ring_accelerations_sym_local(
                mesh, p, gm, ids, n_total, q, cfg, quantize_forces,
                ext_bounds=b if bounds_reuse else None,
                uniform_gm=uniform_gm)
    else:
        def force(p, b):
            return _ring_accelerations_local(mesh, p, gm, ids, n_total, q,
                                             cfg, quantize_forces)
    return force, bounds_of, bounds_of(pos) if bounds_reuse else None


def _make_ring_step(cfg: SimConfig, force, bounds_of, bounds_reuse: bool,
                    bounds_every: int):
    """KDK step over the per-shard carry (p, v, a, bounds, step_idx), the
    single-device leapfrog_step's arithmetic element for element."""
    half_dt = cfg.dt * 0.5

    def one_step(carry):
        p, v, a, b, k = carry
        v = [vs + acs * half_dt for vs, acs in zip(v, a)]
        p = [ps + vs * cfg.dt for ps, vs in zip(p, v)]
        if bounds_reuse and k % bounds_every == 0:
            # amortised global-bounds pass: recompute every k-th step on
            # the freshly drifted positions, reuse in between
            b = bounds_of(p)
        a = force(p, b)
        v = [vs + acs * half_dt for vs, acs in zip(v, a)]
        return p, v, a, b, k + 1

    return one_step


def _start(state, q: Quantizer, cfg: SimConfig, mesh: ParticleMesh,
           quantize_forces: bool, schedule: str, n_total, bounds_every: int,
           uniform_gm: bool):
    """Shard a ParticleState and build its step; returns (n_total, padded
    masses, per-shard masses and ids, one_step, carry with the entry
    force). ``uniform_gm`` is switched off on a layout with phantom rows."""
    _check_run_args(schedule, bounds_every)
    if n_total is None:
        n_total = state.positions.shape[0]
    pos, vel, masses, ids = _padded(state.positions, state.velocities,
                                    state.masses, mesh)
    uniform_gm = uniform_gm and pos.shape[0] == n_total
    pos_l, vel_l, m_l, ids_l = (_shards(x, mesh)
                                for x in (pos, vel, masses, ids))
    gm_l = _shards(cfg.G * masses, mesh)
    bounds_reuse = q.is_int and bounds_every > 1 and schedule == "sym"
    force, bounds_of, b0 = _make_ring_force(mesh, q, cfg, gm_l, ids_l,
                                            n_total, quantize_forces,
                                            schedule, bounds_reuse, pos_l,
                                            uniform_gm)
    one_step = _make_ring_step(cfg, force, bounds_of, bounds_reuse,
                               bounds_every)
    carry = (pos_l, vel_l, force(pos_l, b0), b0, 0)
    return n_total, masses, m_l, ids_l, one_step, carry


@hn.guard_uniform_gm(("masses", (0,)))
def run_steps_sharded(state: ParticleState, q: Quantizer, cfg: SimConfig,
                      mesh: ParticleMesh, num_steps: int,
                      quantize_forces: bool = False,
                      steps_per_chunk: int = 0, gather: bool = True,
                      schedule: str = "sym", n_total: int | None = None,
                      bounds_every: int = 1, uniform_gm: bool = False):
    """Sharded leapfrog run: the ring force inside a loop over ticks.

    Returns (final ParticleState, per-chunk EnergyStream). The state on
    the way in may be an already padded resident state (``n_total`` marks
    the real count; rows past it are phantoms). Its acceleration is
    recomputed from the positions at entry, a pure function of them.
    ``steps_per_chunk=0`` takes no energies. ``gather=False`` returns the
    state padded to the shard boundary (zero-mass phantom rows), to chain
    calls; the state lives on the mesh's first device. ``schedule='sym'``
    is the half-ring Newton's-third-law schedule, 'rows' the plain full
    ring. ``bounds_every=k`` (int-sim modes, sym schedule) recomputes the
    global bounds pass every k-th step; k=1 is the exact reference
    semantics. ``uniform_gm=True`` asserts equal masses (checked on the
    host unless called through ``hopper_nbody.prevalidated``): the sym
    schedule's tiles take their equal-mass variants, switched off when
    N % S != 0 (phantom rows)."""
    n_total, masses, m_l, ids_l, one_step, carry = _start(
        state, q, cfg, mesh, quantize_forces, schedule, n_total,
        bounds_every, uniform_gm)
    kinetic, potential = [], []
    chunk = min(steps_per_chunk, num_steps)
    n_chunks = num_steps // chunk if chunk else 0
    for _ in range(n_chunks):
        for _ in range(chunk):
            carry = one_step(carry)
        p, v = carry[0], carry[1]
        valid = _valid(ids_l, n_total)
        kinetic.append(0.5 * _reduce(
            [(torch.where(ok, ms, 0.0).to(torch.float64)
              * (vs * vs).sum(dim=-1).to(torch.float64)).sum()
             for ms, vs, ok in zip(m_l, v, valid)], torch.add, mesh))
        potential.append(_ring_pe_local(mesh, p, m_l, ids_l, n_total, cfg))
    for _ in range(num_steps - n_chunks * chunk):
        carry = one_step(carry)
    if kinetic:
        ke, pe = torch.stack(kinetic), torch.stack(potential)
    else:
        ke = pe = torch.zeros(1, dtype=torch.float64,
                              device=mesh.devices[0])
    p, v, a = carry[:3]
    trim = (lambda x: x[:n_total]) if gather else (lambda x: x)
    new_state = ParticleState(
        positions=trim(_gather(p, mesh)), velocities=trim(_gather(v, mesh)),
        masses=trim(masses.to(mesh.devices[0])),
        accelerations=trim(_gather(a, mesh)), tick=state.tick + num_steps)
    return new_state, EnergyStream(ke, pe, ke + pe)


def _chunk_snapshot(mesh, p: list, v: list, m_full, tick: int, pe,
                    n_total: int, cfg: SimConfig, num_bins: int):
    """Snapshot from the gathered, trimmed frame plus the ring's potential
    energy: the structure diagnostics are the single-device metrics'."""
    pg = _gather(p, mesh)[:n_total]
    vg = _gather(v, mesh)[:n_total]
    snap = metrics_lib.snapshot(pg, vg, m_full, tick, cfg, num_bins=num_bins,
                                potential=pe)
    return snap, pg


def _stacked(snaps: list, frames: list) -> tuple:
    return (metrics_lib.stack_snapshots(snaps),
            torch.stack(frames).cpu().numpy())


@hn.guard_uniform_gm(("masses", (0,)))
def run_with_snapshots_sharded(state: ParticleState, q: Quantizer,
                               cfg: SimConfig, mesh: ParticleMesh,
                               steps_per_chunk: int, num_chunks: int,
                               quantize_forces: bool = False,
                               num_bins: int = 20, schedule: str = "sym",
                               n_total: int | None = None,
                               bounds_every: int = 1,
                               uniform_gm: bool = False):
    """Sharded history run, the multi-device ``models.direct.
    run_with_snapshots`` (reference: simulation.py:145-196,229-242): per
    chunk, ``steps_per_chunk`` ring-force leapfrog ticks, then a metrics
    Snapshot, PE from the energy ring. Returns (resident padded state,
    Snapshots of numpy arrays stacked over chunks, position frames
    (num_chunks, n_total, D) as numpy), copied to the host once.
    ``uniform_gm`` follows run_steps_sharded."""
    n_total, masses, m_l, ids_l, one_step, carry = _start(
        state, q, cfg, mesh, quantize_forces, schedule, n_total,
        bounds_every, uniform_gm)
    m_full = masses.to(mesh.devices[0])[:n_total]
    snaps, frames = [], []
    for i in range(num_chunks):
        for _ in range(steps_per_chunk):
            carry = one_step(carry)
        p, v = carry[0], carry[1]
        pe = _ring_pe_local(mesh, p, m_l, ids_l, n_total, cfg)
        snap, pg = _chunk_snapshot(mesh, p, v, m_full,
                                   state.tick + (i + 1) * steps_per_chunk,
                                   pe, n_total, cfg, num_bins)
        snaps.append(snap)
        frames.append(pg)
    p, v, a = carry[:3]
    new_state = ParticleState(
        positions=_gather(p, mesh), velocities=_gather(v, mesh),
        masses=masses.to(mesh.devices[0]), accelerations=_gather(a, mesh),
        tick=state.tick + steps_per_chunk * num_chunks)
    return (new_state, *_stacked(snaps, frames))


def ring_potential_energy(positions, masses, cfg: SimConfig,
                          mesh: ParticleMesh, n_total: int | None = None,
                          compensated: bool = False) -> torch.Tensor:
    """Sharded pairwise potential energy (library entry), the multi-device
    ``diagnostics.metrics.potential_energy``: 0-d f64 on the mesh's first
    device. ``n_total`` marks the real count of an already padded resident
    state. ``compensated=True`` takes the plain tile with f64 sums (the
    baseline's precision anchor; see _ring_pe_local)."""
    if n_total is None:
        n_total = positions.shape[0]
    pos, _, m, ids = _padded(positions.to(torch.float32), None,
                             masses.to(torch.float32), mesh)
    return _ring_pe_local(mesh, _shards(pos, mesh), _shards(m, mesh),
                          _shards(ids, mesh), n_total, cfg, compensated)


@hn.guard_uniform_gm(("masses", ("masses", 1)))
def ring_accelerations(positions, masses, q: Quantizer, cfg: SimConfig,
                       mesh: ParticleMesh, quantize_forces: bool = False,
                       tile_impl: str = "auto", schedule: str = "sym",
                       uniform_gm: bool = False) -> torch.Tensor:
    """One sharded force evaluation (library entry for tests and
    benchmarks): (N, D) f32 on the mesh's first device. ``tile_impl='jnp'``
    is the reference tile (see the module's notes). ``schedule='sym'``
    is the half-ring schedule, 'rows' the plain ring. ``uniform_gm``
    follows run_steps_sharded (sym schedule only, off with phantom
    rows)."""
    _check_run_args(schedule, 1)
    n_total = positions.shape[0]
    pos, _, m, ids = _padded(positions.to(torch.float32), None,
                             masses.to(torch.float32), mesh)
    pos_l, ids_l = _shards(pos, mesh), _shards(ids, mesh)
    gm_l = _shards(cfg.G * m, mesh)
    if schedule == "sym":
        acc = _ring_accelerations_sym_local(
            mesh, pos_l, gm_l, ids_l, n_total, q, cfg, quantize_forces,
            tile_impl=tile_impl,
            uniform_gm=uniform_gm and pos.shape[0] == n_total)
    else:
        acc = _ring_accelerations_local(mesh, pos_l, gm_l, ids_l, n_total, q,
                                        cfg, quantize_forces,
                                        tile_impl=tile_impl)
    return _gather(acc, mesh)[:n_total]


# --------------------------------------------------------------------------
# The float64 baseline under the mesh
# --------------------------------------------------------------------------

def _start_baseline(state: BaselineState, cfg: SimConfig,
                    mesh: ParticleMesh, n_total):
    if n_total is None:
        n_total = state.positions.shape[0]
    pos, vel, masses, ids = _padded(state.positions, state.velocities,
                                    state.masses, mesh)
    pos_l, vel_l, m_l, ids_l = (_shards(x, mesh)
                                for x in (pos, vel, masses, ids))
    gm_l = _shards(cfg.G * masses, mesh)

    def force(p):
        return _ring_accelerations_dd_local(mesh, p, gm_l, ids_l, n_total,
                                            cfg)

    half_dt = cfg.dt * 0.5

    def one_step(carry):
        p, v, a = carry
        v = [vs + acs * half_dt for vs, acs in zip(v, a)]
        p = [ps + vs * cfg.dt for ps, vs in zip(p, v)]
        a = force(p)
        v = [vs + acs * half_dt for vs, acs in zip(v, a)]
        return p, v, a

    return n_total, masses, m_l, ids_l, one_step, (pos_l, vel_l,
                                                   force(pos_l))


def _baseline_state(mesh, carry, masses, tick: int, trim) -> BaselineState:
    p, v, a = carry
    return BaselineState(
        positions=trim(_gather(p, mesh)), velocities=trim(_gather(v, mesh)),
        masses=trim(masses.to(mesh.devices[0])),
        accelerations=trim(_gather(a, mesh)), tick=tick)


def run_steps_sharded_baseline(state: BaselineState, cfg: SimConfig,
                               mesh: ParticleMesh, num_steps: int,
                               gather: bool = True,
                               n_total: int | None = None) -> BaselineState:
    """Sharded leapfrog run of the float64 baseline (native f64 state and
    ring force). ``gather=False`` keeps the returned state padded."""
    n_total, masses, _, _, one_step, carry = _start_baseline(state, cfg,
                                                             mesh, n_total)
    for _ in range(num_steps):
        carry = one_step(carry)
    trim = (lambda x: x[:n_total]) if gather else (lambda x: x)
    return _baseline_state(mesh, carry, masses, state.tick + num_steps, trim)


def run_with_snapshots_sharded_baseline(state: BaselineState, cfg: SimConfig,
                                        mesh: ParticleMesh,
                                        steps_per_chunk: int,
                                        num_chunks: int, num_bins: int = 20,
                                        n_total: int | None = None):
    """Sharded history run of the float64 baseline (the float64 arm of
    the precision-ladder compare); metrics see the state rounded to f32,
    and the energy ring is the compensated one. Same contract as
    ``run_with_snapshots_sharded``."""
    n_total, masses, m_l, ids_l, one_step, carry = _start_baseline(
        state, cfg, mesh, n_total)
    m32 = [x.to(torch.float32) for x in m_l]
    m_full = masses.to(mesh.devices[0], torch.float32)[:n_total]
    snaps, frames = [], []
    for i in range(num_chunks):
        for _ in range(steps_per_chunk):
            carry = one_step(carry)
        p32 = [x.to(torch.float32) for x in carry[0]]
        v32 = [x.to(torch.float32) for x in carry[1]]
        pe = _ring_pe_local(mesh, p32, m32, ids_l, n_total, cfg,
                            compensated=True)
        snap, pg = _chunk_snapshot(mesh, p32, v32, m_full,
                                   state.tick + (i + 1) * steps_per_chunk,
                                   pe, n_total, cfg, num_bins)
        snaps.append(snap)
        frames.append(pg)
    new_state = _baseline_state(
        mesh, carry, masses, state.tick + steps_per_chunk * num_chunks,
        lambda x: x)
    return (new_state, *_stacked(snaps, frames))
