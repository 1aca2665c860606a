"""Multi-device particle parallelism: ring-passed all-pairs forces.

PyTorch counterpart of ``nbody_tpu.parallel.ring``. Particles are sharded
over a 1-D mesh of S devices; the O(N^2) interaction is computed by
rotating *source* blocks around the ring while each shard accumulates the
forces on its resident receiver block. The int-sim modes take their
global log-grid bounds first: on one controller from the single
device's pruned pass on the positions gathered onto the home device,
across processes from a max ring pass; snapshots take the potential
energy from an energy ring pass.

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

A shard's tensor is never updated in place inside a tick: on one device
the rotation aliases one tensor between shards. On a single-controller
CUDA mesh with exact bounds every tick the runners capture the entry force
and one tick as CUDA graphs across the cards (``_TickGraphs``: one replay
a tick, so the host no longer enqueues each shard's operations and copies
in turn); the graphs read and write static per-shard buffers, written in
place only at a tick's end, and give the eager ticks' bits
(``graph_ticks(mesh)``: whether a mesh's last run took them).

Why one controller: it is what ``shard_map`` over local devices is, and
JAX's ``--mesh`` takes local devices only; NCCL cannot put two ranks on
one GPU, and ``ParticleMesh.virtual(S, device)`` puts S shards on one
device (the counterpart of the forced host-device count the JAX tests run
the ring on), so a single card runs the tiles between shards, the even
ring's skipped step and the reactions' trip home.

Across processes (``parallel.multihost.make_global_mesh``, JAX's
multi-controller SPMD): each process owns a run of the S shards
(``mesh.local``), every per-shard loop visits those only, and a block list
keeps its global index s with None at the shards of other processes. Every
process holds the same replicated input and runs the same program; the
five collectives then go through ``torch.distributed`` on gloo, with
CUDA tensors staged through host memory (gloo's point-to-point ops take
CPU tensors), so each is a host sync. ``_rotate`` exchanges the blocks
that cross a process boundary in one ``batch_isend_irecv``; ``_reduce``
all-gathers the per-shard values and folds them in shard order 0..S-1 on
the process's home device, never by ``all_reduce``, whose association
order is the backend's, so every process holds the single controller's
bits; ``_gather`` is an all-gather and a ``cat`` in shard order, whose
result every process holds. A single-controller mesh takes none of this
code. The PM runners, ``CosmologicalEngine(mesh=)`` and
``DirectSimulation(mesh=)`` need a single-controller mesh
(``ParticleMesh.require_single_controller``).

Spans and counters (``utils.profiler.span``; recorded only while a
profiler records): the runners' loops carry the single-device loop's
names (``nbody.history``, ``nbody.tick``, ``nbody.force``,
``nbody.bounds`` around the bounds pass with its reduce and replicated
grid, ``nbody.snapshot``, ``nbody.to_host``), each ``_rotate`` is
``nbody.ring.rotate``, each ``_reduce`` and ``_replicate``
``nbody.ring.reduce``, the energy ring pass ``nbody.ring.energy``; a
tick that is a graph replay records ``nbody.tick`` alone. ``TRAFFIC``
counts the collectives, the bytes they move between shards and the
pruned bounds passes, read as ``hopper_nbody.LAUNCHES`` is (a replay adds
its eager tick's counts).

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

import contextlib
import functools
import warnings
from typing import NamedTuple

import torch
import torch.distributed as dist

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
from nbody_tpu_torch.utils.profiler import span

AXIS = "shards"

# Far sentinel of phantom (padding) positions (nbody_tpu.ops.pallas_nbody's
# _PAD_FAR): every phantom pair weight stays finite or zero in all modes.
_PAD_FAR = 2.0e18

SCHEDULES = ("sym", "rows")
TILE_IMPLS = ("auto", "jnp")

# The collectives of this process (reset by whoever reads them, as
# hopper_nbody.LAUNCHES): "rotations" the _rotate calls, "reduces" the
# _reduce calls; "moved_bytes" the bytes that _shards, _rotate, _reduce,
# _replicate and _gather hand from one shard to another, counted at the
# receiving shard whether or not the two shards share a device (a
# virtual mesh counts what a mesh of S cards moves); "moved_bytes_peer"
# the part of them that crosses devices (peer copies between cards, or,
# across processes, host-staged messages); "bounds_passes" the bounds
# passes that took the pruned pass on the home device (``_ring_bounds_max``:
# single-controller meshes), so that hopper_nbody.bounds_fallbacks(home) /
# TRAFFIC["bounds_passes"] is the share whose full-set max_d2 ran.
TRAFFIC = {"rotations": 0, "reduces": 0, "moved_bytes": 0,
           "moved_bytes_peer": 0, "bounds_passes": 0}


class EnergyStream(NamedTuple):
    """Per-chunk energies of a sharded run: KE from per-shard f64 sums, PE
    from the energy ring pass (the reference's headline drift observable,
    simulation.py:170-196). Each a (n_chunks,) f64 tensor."""

    kinetic: torch.Tensor
    potential: torch.Tensor
    total: torch.Tensor


class ParticleMesh:
    """A 1-D mesh of S shards in shard order. A single-controller mesh
    (``ParticleMesh(devices)``) holds every shard in this process:
    ``devices`` lists S devices. A mesh across processes
    (``ParticleMesh.across``) gives each process a run of the shards:
    ``devices[s]`` is set for this process's shards (``local``) and None
    for the others."""

    def __init__(self, devices):
        self.devices = tuple(_normalise(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = None
        self.counts = (len(self.devices),)
        self.rank = 0

    @classmethod
    def virtual(cls, n_shards: int, device) -> "ParticleMesh":
        """S shards on one device: the whole ring, tiles between shards
        included, on one GPU (or the CPU)."""
        if n_shards < 1:
            raise ValueError("a mesh needs at least one shard")
        return cls([device] * n_shards)

    @classmethod
    def across(cls, local: "ParticleMesh", counts, rank: int,
               group) -> "ParticleMesh":
        """The mesh over every process's shards in process order: process
        r owns ``counts[r]`` shards, this process (``rank``) those of the
        single-controller mesh ``local``; ``group`` is the process group
        the collectives go through."""
        counts = tuple(int(c) for c in counts)
        if counts[rank] != local.size or local.processes > 1:
            raise ValueError(f"process {rank} holds a single-controller "
                             f"mesh of {counts[rank]} shard(s), not {local}")
        mesh = cls(local.devices)
        lo = sum(counts[:rank])
        mesh.devices = ((None,) * lo + local.devices
                        + (None,) * (sum(counts) - lo - local.size))
        mesh.group, mesh.counts, mesh.rank = group, counts, rank
        return mesh

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    @property
    def processes(self) -> int:
        return len(self.counts)

    @property
    def local(self) -> range:
        """The shards this process owns: range(S) on a single
        controller."""
        lo = sum(self.counts[:self.rank])
        return range(lo, lo + self.counts[self.rank])

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard, where reductions and
        gathers land."""
        return self.devices[self.local.start]

    def owner(self, s: int) -> int:
        """The process that owns shard s."""
        for r in range(self.processes):
            s -= self.counts[r]
            if s < 0:
                return r
        raise IndexError(f"shard {s} past a mesh of {self.size}")

    def require_single_controller(self, what: str) -> None:
        """Raise unless every shard is in this process: ``what`` runs on
        one controller only."""
        if self.processes > 1:
            raise ValueError(f"{what} needs a single-controller mesh (every "
                             f"shard in this process); this mesh spans "
                             f"{self.processes} processes")

    def __repr__(self) -> str:
        if self.processes == 1:
            return f"ParticleMesh({[str(d) for d in self.devices]})"
        return (f"ParticleMesh({self.size} shards over {self.processes} "
                f"processes; process {self.rank}: shards "
                f"{self.local.start}-{self.local.stop - 1} on "
                f"{[str(self.devices[s]) for s in self.local]})")


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
# Collectives
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


def _per_shard(mesh: ParticleMesh, fn) -> list:
    """A block list: fn(s) at each shard s of this process, None at the
    shards of other processes."""
    out = [None] * mesh.size
    for s in mesh.local:
        out[s] = fn(s)
    return out


def _moved(x: torch.Tensor, mesh: ParticleMesh, src: int,
           dst: int) -> None:
    """Count in TRAFFIC that x goes from shard src to shard dst (blocks
    of their own sizes: a ragged rotation, a rotation across
    processes)."""
    if src == dst:
        return
    n = x.nbytes
    TRAFFIC["moved_bytes"] += n
    if mesh.devices[src] != mesh.devices[dst]:
        TRAFFIC["moved_bytes_peer"] += n


@functools.lru_cache(maxsize=None)
def _hops(devices: tuple, start: int, stop: int, k) -> tuple:
    """(blocks moved, of them across devices) by one collective of a mesh
    on ``devices`` whose shards start..stop-1 are this process's: a
    rotation by k, or (k None) a fold onto or a hand-out from shard
    ``start``."""
    n = len(devices)
    if k is None:
        pairs = [(start, s) for s in range(start + 1, stop)]
    else:
        pairs = [((s - k) % n, s) for s in range(n) if (s - k) % n != s]
    return len(pairs), sum(devices[a] != devices[b] for a, b in pairs)


def _count(mesh: ParticleMesh, nbytes: int, k=None) -> None:
    """Count in TRAFFIC one collective's blocks of nbytes each
    (``_hops``)."""
    moves, peer = _hops(mesh.devices, mesh.local.start, mesh.local.stop, k)
    TRAFFIC["moved_bytes"] += moves * nbytes
    TRAFFIC["moved_bytes_peer"] += peer * nbytes


def _shards(x: torch.Tensor, mesh: ParticleMesh) -> list:
    """x (padded to the shard boundary, the same on every process, on the
    home device) as S equal blocks, block s on device s (views on one
    device)."""
    b = x.shape[0] // mesh.size
    _count(mesh, x[:b].nbytes)
    return _per_shard(mesh, lambda s: x[s * b:(s + 1) * b].to(
        mesh.devices[s], non_blocking=True))


def _gather(blocks: list, mesh: ParticleMesh) -> torch.Tensor:
    """all_gather: the blocks concatenated in shard order on the home
    device."""
    _count(mesh, blocks[mesh.local.start].nbytes)
    if mesh.processes > 1:
        return _all_gather_shards(blocks, mesh).flatten(0, 1).to(mesh.home)
    return torch.cat([x.to(mesh.home) for x in blocks])


def _rotate(blocks: list, k: int, mesh: ParticleMesh,
            ragged: bool = False) -> list:
    """ppermute by k: shard s takes block (s - k) % S. ``ragged``: the
    blocks' leading lengths differ between shards (across processes their
    shapes then travel first)."""
    n = mesh.size
    TRAFFIC["rotations"] += 1
    with span("nbody.ring.rotate"):
        if mesh.processes > 1:
            return _rotate_across(blocks, k, mesh, ragged)
        if ragged:
            for s in range(n):
                _moved(blocks[(s - k) % n], mesh, (s - k) % n, s)
        else:
            _count(mesh, blocks[0].nbytes, k % n)
        return [blocks[(s - k) % n].to(mesh.devices[s], non_blocking=True)
                for s in range(n)]


def _reduce(values: list, op, mesh: ParticleMesh) -> torch.Tensor:
    """psum / pmax / pmin: ``op`` over per-shard values in shard order, on
    the home device."""
    home = mesh.home
    TRAFFIC["reduces"] += 1
    with span("nbody.ring.reduce"):
        _count(mesh, values[mesh.local.start].nbytes)
        if mesh.processes > 1:
            values = _all_gather_shards(values, mesh).to(home)
        out = values[0].to(home)
        for v in values[1:]:
            out = op(out, v.to(home))
        return out


def _replicate(x: torch.Tensor, mesh: ParticleMesh) -> list:
    """One copy of x on every shard's device (across processes, x is a
    value every process holds)."""
    with span("nbody.ring.reduce"):
        _count(mesh, x.nbytes)
        return _per_shard(mesh, lambda s: x.to(mesh.devices[s]))


def _all_gather_shards(values: list, mesh: ParticleMesh) -> torch.Tensor:
    """Every shard's value (one shape and dtype) stacked in shard order on
    the host: one all-gather of each process's values, padded to the
    largest process's shard count (gloo gathers one shape)."""
    host = torch.stack([values[s].to(mesh.home) for s in mesh.local]).cpu()
    width = max(mesh.counts)
    if host.shape[0] < width:
        host = torch.cat([host, host.new_zeros((width - host.shape[0],)
                                               + tuple(host.shape[1:]))])
    out = [torch.empty_like(host) for _ in mesh.counts]
    dist.all_gather(out, host, group=mesh.group)
    return torch.cat([o[:c] for o, c in zip(out, mesh.counts)])


def _exchange(mesh: ParticleMesh, peers: dict, tensors: dict,
              incoming) -> None:
    """One batch of host-memory messages, posted together and waited for:
    for each shard s of ``peers`` (in global shard order on every
    process), tensors[s] goes to process peers[s], or comes from it where
    s is in ``incoming``, tagged s. An empty tensor travels as nothing
    (both ends know its shape)."""
    ops = [dist.P2POp(dist.irecv if s in incoming else dist.isend,
                      tensors[s], peers[s], mesh.group, s)
           for s in peers if tensors[s].numel()]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _rotate_across(blocks: list, k: int, mesh: ParticleMesh,
                   ragged: bool) -> list:
    """_rotate on a mesh across processes: a block that stays in this
    process moves as on one controller, each that crosses is staged
    through host memory. The blocks of other processes take a local
    block's shape and dtype, or, ``ragged``, a shape sent first."""
    n, me = mesh.size, mesh.rank
    out = [None] * n
    peers, tensors, incoming = {}, {}, []
    for s in range(n):
        t = (s - k) % n
        src, dst = mesh.owner(t), mesh.owner(s)
        if src == me and dst == me:
            _moved(blocks[t], mesh, t, s)
            out[s] = blocks[t].to(mesh.devices[s], non_blocking=True)
        elif src == me:
            peers[s], tensors[s] = dst, blocks[t].detach().cpu().contiguous()
        elif dst == me:
            peers[s] = src
            incoming.append(s)
    template = blocks[mesh.local.start]
    shapes = {s: tuple(template.shape) for s in incoming}
    if ragged:
        heads = {s: torch.tensor(x.shape, dtype=torch.int64)
                 for s, x in tensors.items()}
        heads.update({s: torch.empty(template.dim(), dtype=torch.int64)
                      for s in incoming})
        _exchange(mesh, peers, heads, incoming)
        shapes = {s: tuple(heads[s].tolist()) for s in incoming}
    tensors.update({s: torch.empty(shapes[s], dtype=template.dtype)
                    for s in incoming})
    _exchange(mesh, peers, tensors, incoming)
    for s in incoming:
        _moved(tensors[s], mesh, (s - k) % n, s)
        out[s] = tensors[s].to(mesh.devices[s])
    return out


def _valid(mesh: ParticleMesh, ids: list, n_total: int) -> list:
    return _per_shard(mesh, lambda s: ids[s] < n_total)


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
    valid = _valid(mesh, ids, n_total)
    best = [None] * mesh.size
    pos_j, valid_j = pos, valid
    for k in range(mesh.size // 2 + 1):
        if k:
            pos_j, valid_j = _rotate(pos_j, 1, mesh), _rotate(valid_j, 1,
                                                              mesh)
        for s in mesh.local:
            m = hn.pair_max(pos[s], pos_j[s], valid[s], valid_j[s])
            best[s] = m if best[s] is None else torch.maximum(best[s], m)
    return _reduce(best, torch.maximum, mesh) + cfg.softening_sq


def _ring_bounds_max(mesh: ParticleMesh, pos: list, ids: list, n_total: int,
                     cfg: SimConfig) -> torch.Tensor:
    """The exact global max softened pairwise d^2 of the int grid, on the
    home device. On one controller the shards' positions are gathered
    onto the home device, where their real prefix is the single-device
    tensor row for row, and the single device's pruned pass runs on it
    (its full-set max_d2 launch, skipped unless the candidates fall
    short, counts in the home device's BOUNDS_FALLBACKS). Across
    processes, where the gather is a host all-gather of every position,
    the max ring pass. Bitwise the single-device max_d2 of the real
    particles (+ eps^2) either way."""
    if mesh.processes > 1:
        return _ring_max_d2(mesh, pos, ids, n_total, cfg)
    TRAFFIC["bounds_passes"] += 1
    return hn.max_pairwise_dist_sq_pruned(_gather(pos, mesh)[:n_total], cfg)


def _ring_log_bounds(mesh, pos, ids, n_total, q: Quantizer,
                     cfg: SimConfig) -> tuple:
    """Per-shard (log_lo, log_hi) lists of the int-sim grid from the
    ring's exact global max (``_ring_bounds_max``)."""
    with span("nbody.bounds"):
        lo, hi = dist_sq_log_bounds(q, _ring_bounds_max(mesh, pos, ids,
                                                        n_total, cfg),
                                    cfg.softening_sq)
        return _replicate(lo, mesh), _replicate(hi, mesh)


def _real_rows(mesh: ParticleMesh, x: list, n_total: int) -> list:
    """Each shard's real (non-phantom) rows: phantoms are the tail of the
    padded global order, so a prefix of each shard."""
    b = x[mesh.local.start].shape[0]
    return _per_shard(mesh, lambda s: x[s][:min(max(n_total - s * b, 0), b)])


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
    with span("nbody.ring.energy"):
        pos_r, m_r, ids_r = (_real_rows(mesh, x, n_total)
                             for x in (pos, m, ids))
        local = _per_shard(mesh, lambda s: torch.zeros(
            (), dtype=torch.float64, device=mesh.devices[s]))
        pos_j, m_j, ids_j = pos_r, m_r, ids_r
        for k in range(mesh.size):
            if k:
                pos_j, m_j, ids_j = (_rotate(x, 1, mesh, ragged=True)
                                     for x in (pos_j, m_j, ids_j))
            for s in mesh.local:
                if not (pos_r[s].shape[0] and pos_j[s].shape[0]):
                    continue  # a shard of phantoms only (N < S - 1 tiny)
                if compensated:
                    part = metrics_lib.pair_potential_sum(
                        pos_r[s], m_r[s], ids_r[s], pos_j[s], m_j[s],
                        ids_j[s], cfg.softening_sq)
                else:
                    part = hn.pair_pe_rows(
                        pos_r[s], m_r[s], ids_r[s], pos_j[s], m_j[s],
                        ids_j[s], cfg.softening_sq).to(torch.float64).sum()
                local[s] = local[s] + part
        return -0.5 * cfg.G * _reduce(local, torch.add, mesh)


def _finish_ring(mesh, acc: list, ids: list, n_total: int, q: Quantizer,
                 quantize_forces: bool) -> list:
    """Freeze phantom rows (they neither integrate nor enter the
    quantization bounds), then for int8/int4 quantize on the linear grid
    over the GLOBAL acc min/max (reference: quantization.py:74-88 on the
    full (N, D) tensor)."""
    valid = _per_shard(mesh, lambda s: (ids[s] < n_total)[:, None])
    acc = _per_shard(mesh, lambda s: torch.where(valid[s], acc[s], 0.0))
    if quantize_forces and q.is_int:
        inf = float("inf")
        lo = _replicate(_reduce(_per_shard(
            mesh, lambda s: torch.where(valid[s], acc[s], inf).min()),
            torch.minimum, mesh), mesh)
        hi = _replicate(_reduce(_per_shard(
            mesh, lambda s: torch.where(valid[s], acc[s], -inf).max()),
            torch.maximum, mesh), mesh)
        acc = _per_shard(mesh, lambda s: torch.where(
            valid[s], quantize_force(acc[s], q, lo=lo[s], hi=hi[s]), 0.0))
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
        for s in mesh.local:
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

    acc = _per_shard(mesh, lambda s: _diagonal_sym(
        pos[s], gm[s], ids[s], q, cfg, log_lo[s], log_hi[s], impl,
        uniform_gm))
    racc = _per_shard(mesh, lambda s: torch.zeros_like(pos[s]))
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
        for s in mesh.local:
            visit(s)
    if n % 2 == 0 and n > 1:
        pos_j, gm_j, ids_j, racc = (_rotate(x, 1, mesh)
                                    for x in (pos_j, gm_j, ids_j, racc))
        for s in mesh.local:
            if s < half:
                visit(s)
    if half:
        home = _rotate(racc, -half, mesh)
        acc = _per_shard(mesh, lambda s: acc[s] + home[s])
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
        for s in mesh.local:
            a = forces.baseline_pair_accelerations(pos[s], ids[s], pos_j[s],
                                                   gm_j[s], ids_j[s], cfg)
            acc[s] = a if acc[s] is None else acc[s] + a
    return _per_shard(mesh, lambda s: torch.where(
        (ids[s] < n_total)[:, None], acc[s], 0.0))


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


def _make_ring_step(mesh: ParticleMesh, cfg: SimConfig, force, bounds_of,
                    bounds_reuse: bool, bounds_every: int):
    """KDK step over the per-shard carry (p, v, a, bounds, step_idx), the
    single-device leapfrog_step's arithmetic element for element."""
    half_dt = cfg.dt * 0.5

    def one_step(carry):
        p, v, a, b, k = carry
        v = _per_shard(mesh, lambda s: v[s] + a[s] * half_dt)
        p = _per_shard(mesh, lambda s: p[s] + v[s] * cfg.dt)
        with span("nbody.force"):
            if bounds_reuse and k % bounds_every == 0:
                # amortised global-bounds pass: recompute every k-th step
                # on the freshly drifted positions, reuse in between
                b = bounds_of(p)
            a = force(p, b)
        v = _per_shard(mesh, lambda s: v[s] + a[s] * half_dt)
        return p, v, a, b, k + 1

    return one_step


def _start(state, q: Quantizer, cfg: SimConfig, mesh: ParticleMesh,
           quantize_forces: bool, schedule: str, n_total, bounds_every: int,
           uniform_gm: bool):
    """Shard a ParticleState and build its step; returns (n_total, padded
    masses, per-shard masses and ids, ``ticks(carry, n)``, carry with the
    entry force). ``uniform_gm`` is switched off on a layout with phantom
    rows. A single-controller CUDA mesh (``_graphable``) runs its entry
    force and ticks as CUDA graphs (``_TickGraphs``) where the bounds are
    exact every tick; each tick is then a graph replay, the arithmetic
    the same."""
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
    one_step = _make_ring_step(mesh, cfg, force, bounds_of, bounds_reuse,
                               bounds_every)
    if not bounds_reuse and _graphable(mesh):
        key = (mesh.devices, tuple(x.shape for x in pos_l), pos_l[0].dtype,
               gm_l[0].dtype, q, cfg, quantize_forces, schedule, n_total,
               uniform_gm)
        tg = _TickGraphs.get(key, mesh, force, one_step, pos_l, vel_l,
                             gm_l, ids_l)
        if tg is not None:
            with span("nbody.force"):
                carry = tg.enter(pos_l, vel_l, gm_l, ids_l)
            return n_total, masses, m_l, ids_l, tg.ticks, carry
    with span("nbody.force"):
        carry = (pos_l, vel_l, force(pos_l, b0), b0, 0)
    return (n_total, masses, m_l, ids_l, functools.partial(_ticks, one_step),
            carry)


def _ticks(one_step, carry, n: int):
    """n ticks of one_step, each in a ``nbody.tick`` span."""
    for _ in range(n):
        with span("nbody.tick"):
            carry = one_step(carry)
    return carry


def _graphable(mesh: ParticleMesh) -> bool:
    return mesh.processes == 1 and all(d.type == "cuda"
                                       for d in mesh.devices)


def graph_ticks(mesh: ParticleMesh) -> bool:
    """Whether the layout last run on ``mesh`` runs its ticks as CUDA
    graphs: False before a run, on a mesh that is not ``_graphable`` and
    where the capture failed (eager ticks then)."""
    return any(tg is not None and tg.mesh.devices == mesh.devices
               for tg in _TickGraphs._cache.values())


def _capture(mesh: ParticleMesh, fn):
    """fn() captured as one CUDA graph over every card of the mesh: the
    home card's side stream begins the capture, each other card's side
    stream joins it and is that card's current stream (its allocations in
    a pool of its own) until it joins back. fn reads and writes only
    tensors that outlive the graph and returns nothing. Returns (graph,
    pools, the LAUNCHES and TRAFFIC counts that fn's one pass adds), the
    counters left as they were (the capture ran nothing)."""
    devices = list(dict.fromkeys(mesh.devices))
    streams = [torch.cuda.Stream(d) for d in devices]
    pools = []
    for d in devices[1:]:
        with torch.cuda.device(d):
            pools.append(torch.cuda.MemPool())
    counters = (hn.LAUNCHES, TRAFFIC)
    before = [dict(c) for c in counters]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(streams[0]):
            graph.capture_begin(capture_error_mode="relaxed")
            try:
                with contextlib.ExitStack() as joined:
                    for st, pool in zip(streams[1:], pools):
                        st.wait_stream(streams[0])
                        joined.enter_context(torch.cuda.stream(st))
                        joined.enter_context(
                            torch.cuda.use_mem_pool(pool, st.device))
                    fn()
                    for st in streams[1:]:
                        streams[0].wait_stream(st)
            finally:
                graph.capture_end()
        counts = [{k: v - b.get(k, 0) for k, v in c.items()
                   if v != b.get(k, 0)} for c, b in zip(counters, before)]
    finally:
        for c, b in zip(counters, before):
            c.update({k: b.get(k, 0) for k in c})
    return graph, pools, counts


# hopper_nbody's registries of device counters that a tick's kernels
# write (the pruned bounds pass's fallbacks, the int table's, the max
# fold's tickets): a graph holds the tensors it captured.
_GRAPH_COUNTERS = (hn.BOUNDS_FALLBACKS, hn.INT_CHAIN_FALLBACKS, hn.TICKETS)


class _TickGraphs:
    """A CUDA mesh's entry force and one tick as two CUDA graphs over
    static per-shard buffers: the carry's p, v and a, and the G*m and ids
    blocks the force reads. Captured once per layout (the last one is
    kept) after an eager force has built every kernel and cache; a call
    copies its state in, replays the entry force, then one graph a tick.
    Each replay adds the counts of the eager pass it stands for to
    LAUNCHES and TRAFFIC, and records ``nbody.force`` / ``nbody.tick``
    (the spans inside a tick are recorded by the eager runs only). The
    graphs keep the device counters they write alive, and are captured
    anew once a registry no longer holds one (cleared since)."""

    _cache: dict = {}

    @classmethod
    def get(cls, key, mesh, force, one_step, pos, vel, gm, ids):
        """The graphs of this layout, captured now if they are not kept;
        None (with a warning, eager ticks then) where the capture fails."""
        kept = cls._cache.get(key)
        if key not in cls._cache or (kept is not None
                                     and not kept.counters_current()):
            cls._cache.clear()
            try:
                cls._cache[key] = cls(mesh, force, one_step, pos, vel, gm,
                                      ids)
            except RuntimeError as e:
                for d in dict.fromkeys(mesh.devices):
                    torch.cuda.synchronize(d)
                warnings.warn(f"ring ticks run eagerly: CUDA-graph capture "
                              f"failed ({str(e).splitlines()[0]})")
                cls._cache[key] = None
        return cls._cache[key]

    def __init__(self, mesh, force, one_step, pos, vel, gm, ids):
        self.mesh = mesh
        self.p = [x.clone() for x in pos]
        self.v = [x.clone() for x in vel]
        self.gm, self.ids = gm, ids
        # The eager force at this call's state: the call's entry force.
        self.a = [a.clone() for a in force(self.p, None)]
        self.entered = True

        def entry():
            for dst, a in zip(self.a, force(self.p, None)):
                dst.copy_(a)

        def tick():
            p, v, a, _, _ = one_step((self.p, self.v, self.a, None, 0))
            for dst, src in zip(self.p + self.v + self.a, p + v + a):
                dst.copy_(src)

        self.entry = _capture(mesh, entry)
        self.tick = _capture(mesh, tick)
        self.counters = [dict(r) for r in _GRAPH_COUNTERS]

    def counters_current(self) -> bool:
        """Whether every device counter the graphs write is still the one
        its registry holds."""
        return all(r.get(k) is t for r, held in zip(_GRAPH_COUNTERS,
                                                     self.counters)
                   for k, t in held.items())

    def _join(self, into_home: bool) -> None:
        """Order the home card's current stream after every other card's
        (before replays), or theirs after it (after replays)."""
        home = torch.cuda.current_stream(self.mesh.home)
        for d in dict.fromkeys(self.mesh.devices):
            if d != self.mesh.home:
                other = torch.cuda.current_stream(d)
                if into_home:
                    home.wait_stream(other)
                else:
                    other.wait_stream(home)

    @staticmethod
    def _replay(captured) -> None:
        graph, _, counts = captured
        graph.replay()
        for c, add in zip((hn.LAUNCHES, TRAFFIC), counts):
            for k, v in add.items():
                c[k] += v

    def enter(self, pos, vel, gm, ids) -> tuple:
        """The carry of a call at ``pos``, ``vel``: the entry force's (the
        eager one of the capturing call, a replay in every later one)."""
        if self.entered:
            self.entered = False
            return self.p, self.v, self.a, None, 0
        for dst, src in zip(self.p + self.v + self.gm + self.ids,
                            pos + vel + gm + ids):
            if dst is not src:
                dst.copy_(src)
        self._join(True)
        self._replay(self.entry)
        self._join(False)
        return self.p, self.v, self.a, None, 0

    def ticks(self, carry, n: int) -> tuple:
        """n ticks on from the carry ``enter`` or ``ticks`` returned, each
        a replay in a ``nbody.tick`` span."""
        if n:
            self._join(True)
            for _ in range(n):
                with span("nbody.tick"):
                    self._replay(self.tick)
            self._join(False)
        return self.p, self.v, self.a, None, carry[4] + n


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
    n_total, masses, m_l, ids_l, ticks, carry = _start(
        state, q, cfg, mesh, quantize_forces, schedule, n_total,
        bounds_every, uniform_gm)
    kinetic, potential = [], []
    chunk = min(steps_per_chunk, num_steps)
    n_chunks = num_steps // chunk if chunk else 0
    for _ in range(n_chunks):
        carry = ticks(carry, chunk)
        p, v = carry[0], carry[1]
        with span("nbody.snapshot"):
            valid = _valid(mesh, ids_l, n_total)
            kinetic.append(0.5 * _reduce(_per_shard(mesh, lambda s: (
                torch.where(valid[s], m_l[s], 0.0).to(torch.float64)
                * (v[s] * v[s]).sum(dim=-1).to(torch.float64)).sum()),
                torch.add, mesh))
            potential.append(_ring_pe_local(mesh, p, m_l, ids_l, n_total,
                                            cfg))
    carry = ticks(carry, num_steps - n_chunks * chunk)
    if kinetic:
        ke, pe = torch.stack(kinetic), torch.stack(potential)
    else:
        ke = pe = torch.zeros(1, dtype=torch.float64, device=mesh.home)
    p, v, a = carry[:3]
    trim = (lambda x: x[:n_total]) if gather else (lambda x: x)
    new_state = ParticleState(
        positions=trim(_gather(p, mesh)), velocities=trim(_gather(v, mesh)),
        masses=trim(masses.to(mesh.home)),
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
    ``uniform_gm`` follows run_steps_sharded. The history is one
    ``nbody.history`` span, the single-device history's spans inside."""
    with span("nbody.history"):
        n_total, masses, m_l, ids_l, ticks, carry = _start(
            state, q, cfg, mesh, quantize_forces, schedule, n_total,
            bounds_every, uniform_gm)
        m_full = masses.to(mesh.home)[:n_total]
        snaps, frames = [], []
        for i in range(num_chunks):
            carry = ticks(carry, steps_per_chunk)
            p, v = carry[0], carry[1]
            with span("nbody.snapshot"):
                pe = _ring_pe_local(mesh, p, m_l, ids_l, n_total, cfg)
                snap, pg = _chunk_snapshot(
                    mesh, p, v, m_full,
                    state.tick + (i + 1) * steps_per_chunk, pe, n_total,
                    cfg, num_bins)
            snaps.append(snap)
            frames.append(pg)
        p, v, a = carry[:3]
        new_state = ParticleState(
            positions=_gather(p, mesh), velocities=_gather(v, mesh),
            masses=masses.to(mesh.home), accelerations=_gather(a, mesh),
            tick=state.tick + steps_per_chunk * num_chunks)
        with span("nbody.to_host"):
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
        with span("nbody.force"):
            return _ring_accelerations_dd_local(mesh, p, gm_l, ids_l,
                                                n_total, cfg)

    half_dt = cfg.dt * 0.5

    def one_step(carry):
        p, v, a = carry
        v = _per_shard(mesh, lambda s: v[s] + a[s] * half_dt)
        p = _per_shard(mesh, lambda s: p[s] + v[s] * cfg.dt)
        a = force(p)
        v = _per_shard(mesh, lambda s: v[s] + a[s] * half_dt)
        return p, v, a

    return n_total, masses, m_l, ids_l, one_step, (pos_l, vel_l,
                                                   force(pos_l))


def _baseline_state(mesh, carry, masses, tick: int, trim) -> BaselineState:
    p, v, a = carry
    return BaselineState(
        positions=trim(_gather(p, mesh)), velocities=trim(_gather(v, mesh)),
        masses=trim(masses.to(mesh.home)),
        accelerations=trim(_gather(a, mesh)), tick=tick)


def run_steps_sharded_baseline(state: BaselineState, cfg: SimConfig,
                               mesh: ParticleMesh, num_steps: int,
                               gather: bool = True,
                               n_total: int | None = None) -> BaselineState:
    """Sharded leapfrog run of the float64 baseline (native f64 state and
    ring force). ``gather=False`` keeps the returned state padded."""
    n_total, masses, _, _, one_step, carry = _start_baseline(state, cfg,
                                                             mesh, n_total)
    carry = _ticks(one_step, carry, num_steps)
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
    with span("nbody.history"):
        n_total, masses, m_l, ids_l, one_step, carry = _start_baseline(
            state, cfg, mesh, n_total)
        m32 = _per_shard(mesh, lambda s: m_l[s].to(torch.float32))
        m_full = masses.to(mesh.home, torch.float32)[:n_total]
        snaps, frames = [], []
        for i in range(num_chunks):
            carry = _ticks(one_step, carry, steps_per_chunk)
            with span("nbody.snapshot"):
                p32 = _per_shard(mesh,
                                 lambda s: carry[0][s].to(torch.float32))
                v32 = _per_shard(mesh,
                                 lambda s: carry[1][s].to(torch.float32))
                pe = _ring_pe_local(mesh, p32, m32, ids_l, n_total, cfg,
                                    compensated=True)
                snap, pg = _chunk_snapshot(
                    mesh, p32, v32, m_full,
                    state.tick + (i + 1) * steps_per_chunk, pe, n_total,
                    cfg, num_bins)
            snaps.append(snap)
            frames.append(pg)
        new_state = _baseline_state(
            mesh, carry, masses, state.tick + steps_per_chunk * num_chunks,
            lambda x: x)
        with span("nbody.to_host"):
            return (new_state, *_stacked(snaps, frames))
