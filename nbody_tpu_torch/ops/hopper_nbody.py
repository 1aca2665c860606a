"""Hand-written Hopper kernels of the direct engine, with their plain twins.

PyTorch counterpart of ``nbody_tpu.ops.pallas_nbody``. Four CUDA kernels
replace the TPU kernels of the direct engine's paths:

* ``sym_force`` — ``csrc/sym_force.cu``, replacing ``_force_kernel_sym`` /
  ``pallas_accelerations_sym`` (#1): softened all-pairs gravity, each
  unordered pair's weight evaluated once (Newton's third law), with the
  precision hook in the tile.
* ``max_d2`` — ``csrc/max_dist_sq.cu``, replacing ``_max_kernel`` /
  ``pallas_max_dist_sq`` (#2) and its streamed twin
  ``pallas_max_dist_sq_streamed`` (#3): the global max of the raw
  pairwise d^2, the int-sim log grid's upper bound.
* ``row_force`` — ``csrc/row_force.cu``, replacing ``_force_kernel`` /
  ``pallas_accelerations`` (#8) and ``_force_kernel_streamed`` /
  ``pallas_accelerations_streamed`` (#4): every ordered pair, the path of
  zero and run-time softening.
* ``pair_sym_force`` — ``csrc/pair_sym_force.cu``, replacing
  ``_pair_force_sym_kernel`` / ``pallas_pair_force_sym`` (#6): two
  disjoint sets, rows and reactions from one evaluation of each pair.

Each kernel has a plain PyTorch version of the same function and
signature (``*_plain``). A wrapper launches the kernel for a CUDA tensor
(or raises) and takes the plain version only for a CPU tensor; there is
no fallback from a failed launch. Every launch adds one to
``LAUNCHES[name]``, so a run can show that it went through the kernels.
The kernel sources carry the notes on design and numerics.

The public functions are the counterparts of the JAX wrappers:
``sym_accelerations`` (#1), ``accelerations_rows`` (#8),
``accelerations_streamed`` (#4), ``sym_accelerations_chunked`` (#5, a
composition of #1 and #6 past one launch's scratch budget) and
``max_dist_sq``; ``max_pairwise_dist_sq_pruned``, the int modes' bounds
pass around the max_d2 kernel, lives here beside it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops.precision import (
    Precision,
    Quantizer,
    dist_sq_log_bounds,
    quantize_force,
)

# Launches of each kernel in this process (reset by whoever reads them).
LAUNCHES = {"sym_force": 0, "max_d2": 0, "row_force": 0,
            "pair_sym_force": 0}

# Full-set max_d2 launches that ran (were not skipped) inside the pruned
# bounds pass, per device: a device int32 the kernel increments, so the
# count costs no launch and no host sync. Read with bounds_fallbacks().
BOUNDS_FALLBACKS: dict = {}

# Per-block maxima scratch of max_d2: the kernel's grid-stride loop uses
# at most this many blocks.
MAX_D2_BLOCKS = 1024

# BT of csrc/nbody_common.cuh: the tile of the Newton's-third-law kernels.
TILE = 64
# Source tiles one block of pair_sym_force walks (its row partials are
# per segment of this many tiles).
PAIR_SEGMENT_TILES = 32
# Bytes of per-tile partials one force evaluation may hold on the card:
# sym_force alone while its scratch fits (the "auto" routing), else the
# chunked path's diagonal sym_force plus one pair tile together. 16 GB of
# the H100's 80 GB leaves room for the state at any N the card can hold.
SCRATCH_BUDGET = 16_000_000_000

_MODE_CODES = {
    Precision.FLOAT64: 0, Precision.FLOAT32: 0,
    Precision.BFLOAT16: 1, Precision.FLOAT16: 2,
}
_MODE_INT = 3


def _mode_code(q: Quantizer) -> int:
    return _MODE_INT if q.is_int else _MODE_CODES[q.mode]


def _arg_cap(q: Quantizer) -> float:
    """-1.5 * log(min_dist_sq): the exponent cap of the folded int chain."""
    return -1.5 * math.log(q.min_dist_sq)


def _tiles(n: int) -> int:
    return -(-n // TILE)


def sym_force_scratch_bytes(n: int, dim: int) -> int:
    """Per-tile partials of one sym_force launch over n particles:
    (T, T, TILE, dim) f32 with T = ceil(n / TILE)."""
    t = _tiles(n)
    return 4 * dim * t * t * TILE


def pair_sym_force_scratch_bytes(n_a: int, n_b: int, dim: int) -> int:
    """Per-tile partials of one pair_sym_force launch: row partials
    (Ta, nseg, TILE, dim) and reaction partials (Tb, Ta, TILE, dim) f32."""
    ta, tb = _tiles(n_a), _tiles(n_b)
    nseg = -(-tb // PAIR_SEGMENT_TILES)
    return 4 * dim * TILE * (ta * nseg + tb * ta)


def sym_force_fits(n: int, dim: int) -> bool:
    """Whether one sym_force launch over n particles fits SCRATCH_BUDGET
    (the port's counterpart of SYM_RESIDENT_VMEM_BUDGET): up to ~357k
    particles at D=2 and ~292k at D=3."""
    return sym_force_scratch_bytes(n, dim) <= SCRATCH_BUDGET


def sym_chunk_size(n: int, dim: int) -> int:
    """Chunk of the chunked path: the largest multiple of TILE whose
    sym_force and pair_sym_force scratch together fit SCRATCH_BUDGET,
    then the fewest chunks of that size spread evenly over n (so the
    last chunk is not a sliver)."""
    def fits(k):
        c = k * TILE
        return (sym_force_scratch_bytes(c, dim)
                + pair_sym_force_scratch_bytes(c, c, dim)) <= SCRATCH_BUDGET

    lo, hi = 1, _tiles(n)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    n_chunks = -(-n // (lo * TILE))
    return _tiles(-(-n // n_chunks)) * TILE


def _check_f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_positions(pos: torch.Tensor) -> tuple:
    if pos.dim() != 2 or pos.shape[1] not in (2, 3) or pos.shape[0] < 1:
        raise ValueError(f"positions must be (N, 2) or (N, 3) with N >= 1, "
                         f"got {tuple(pos.shape)}")
    _check_f32("positions", pos, tuple(pos.shape), pos.device)
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pos.device}")
    return tuple(pos.shape)


def _check_force_args(pos, gm, bounds) -> tuple:
    n, dim = _check_positions(pos)
    _check_f32("gm", gm, (n,), pos.device)
    _check_f32("bounds", bounds, (3,), pos.device)
    return n, dim


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _library():
    from nbody_tpu_torch import _build
    lib = _build.library()
    if lib.nbody_sym_force_tile() != TILE:
        raise RuntimeError(f"csrc tile {lib.nbody_sym_force_tile()} != "
                           f"hopper_nbody.TILE {TILE}")
    return lib


def _int_args(q: Quantizer) -> tuple:
    return _mode_code(q), q.levels, _arg_cap(q), q.min_dist_sq


# --------------------------------------------------------------------------
# Plain versions of the force kernels
# --------------------------------------------------------------------------

def _int_grid(bounds: torch.Tensor, q: Quantizer) -> tuple:
    """The folded int chain's grid scalars, hoisted as the kernel hoists
    them (every op a single IEEE rounding, tensor by tensor)."""
    log_lo, log_hi = bounds[0], bounds[1]
    lvl = torch.full((), float(q.levels - 1), dtype=torch.float32,
                     device=bounds.device)
    safe_span = torch.clamp(log_hi - log_lo, min=1e-10)
    norm_a = lvl / safe_span
    norm_b = (-log_lo) * norm_a
    arg_k = (safe_span * -1.5) / lvl
    arg_0 = log_lo * -1.5
    arg_cap = torch.full((), _arg_cap(q), dtype=torch.float32,
                         device=bounds.device)
    return norm_a, norm_b, arg_k, arg_0, arg_cap


def _pair_weight(d2: torch.Tensor, q: Quantizer, grid) -> torch.Tensor:
    """w = quantized |r|^-3 of softened d^2, as the kernels compute it."""
    if q.is_int:
        norm_a, norm_b, arg_k, arg_0, arg_cap = grid
        log_d2 = torch.log(torch.clamp(d2, min=q.min_dist_sq))
        k = torch.round(log_d2 * norm_a + norm_b)
        return torch.exp(torch.minimum(k * arg_k + arg_0, arg_cap))
    if q.mode == Precision.BFLOAT16:
        d2 = d2.to(torch.bfloat16).to(torch.float32)
    elif q.mode == Precision.FLOAT16:
        d2 = d2.to(torch.float16).to(torch.float32)
    inv = torch.rsqrt(d2)
    return inv * inv * inv


def _diffs_w(pi: torch.Tensor, pos: torch.Tensor, soft, q: Quantizer, grid):
    """diff_ij = x_j - x_i per component and w_ij for receivers pi."""
    dim = pos.shape[1]
    diffs = [pos[None, :, d] - pi[:, d, None] for d in range(dim)]
    d2 = diffs[0] * diffs[0]
    for d in range(1, dim):
        d2 = d2 + diffs[d] * diffs[d]
    return diffs, _pair_weight(d2 + soft, q, grid)


def _plain_rows(pos, gm, bounds, q: Quantizer, self_masked: bool,
                block: int, term, rows=None) -> torch.Tensor:
    """sum_j term(gm_j w_ij diff_ij) per receiver and component,
    row-blocked; receivers are ``rows`` (indices) or all particles."""
    n, dim = pos.shape
    grid = _int_grid(bounds, q) if q.is_int else None
    ids = torch.arange(n, device=pos.device)
    rows = ids if rows is None else rows
    out = torch.empty((rows.shape[0], dim), dtype=torch.float32,
                      device=pos.device)
    for r0 in range(0, rows.shape[0], block):
        ri = rows[r0:r0 + block]
        diffs, w = _diffs_w(pos[ri], pos, bounds[2], q, grid)
        factor = gm[None, :] * w
        if self_masked:
            factor = torch.where(ri[:, None] == ids[None, :], 0.0, factor)
        out[r0:r0 + block] = torch.stack(
            [term(factor * diffs[d]).sum(dim=1) for d in range(dim)], dim=1)
    return out


def row_force_plain(pos: torch.Tensor, gm: torch.Tensor,
                    bounds: torch.Tensor, q: Quantizer, self_masked: bool,
                    rows: torch.Tensor | None = None,
                    block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the row_force kernel (and of sym_force:
    both compute acc_i = sum_{j != i} gm_j w_ij (x_j - x_i)), row-blocked
    with O(block * N) memory.

    pos (N, D) f32, gm (N,) f32 = G*m, bounds (3,) f32 = [log_lo, log_hi,
    eps^2]; ``rows`` optionally selects receivers by index (all sources
    always act). Returns (len(rows) or N, D) f32, before any int-sim force
    quantization."""
    return _plain_rows(pos, gm, bounds, q, self_masked, block, lambda t: t,
                       rows)


def sym_force_plain(pos: torch.Tensor, gm: torch.Tensor,
                    bounds: torch.Tensor, q: Quantizer, self_masked: bool,
                    block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the sym_force kernel (row_force_plain:
    the same function, in another summation order)."""
    return row_force_plain(pos, gm, bounds, q, self_masked, block=block)


def sym_force_term_scale(pos: torch.Tensor, gm: torch.Tensor,
                         bounds: torch.Tensor, q: Quantizer,
                         self_masked: bool, rows: torch.Tensor | None = None,
                         block: int = 1024) -> torch.Tensor:
    """sum_j |gm_j w_ij (x_j - x_i)| per component: the scale of the
    rounding error that any summation order of a force row makes.
    Where terms cancel (near-coincident pairs at zero softening) |acc| is
    far below it, and a tolerance on |acc| alone would test the order."""
    return _plain_rows(pos, gm, bounds, q, self_masked, block, torch.abs,
                       rows)


def pair_sym_force_plain(pos_a: torch.Tensor, gm_a: torch.Tensor,
                         pos_b: torch.Tensor, gm_b: torch.Tensor,
                         bounds: torch.Tensor, q: Quantizer,
                         block: int = 1024) -> tuple:
    """Plain PyTorch version of the pair_sym_force kernel: receivers A,
    sources B (disjoint sets, eps^2 > 0), row-blocked over A.

    Returns (rows, cols): rows (Na, D) = sum_j gm_b_j w_ij (x_j - x_i),
    cols (Nb, D) = -sum_i gm_a_i w_ij (x_j - x_i), both f32."""
    dim = pos_a.shape[1]
    grid = _int_grid(bounds, q) if q.is_int else None
    rows = torch.empty_like(pos_a)
    cols = torch.zeros_like(pos_b)
    for r0 in range(0, pos_a.shape[0], block):
        diffs, w = _diffs_w(pos_a[r0:r0 + block], pos_b, bounds[2], q, grid)
        fr = gm_b[None, :] * w
        fc = gm_a[r0:r0 + block, None] * w
        rows[r0:r0 + block] = torch.stack(
            [(fr * diffs[d]).sum(dim=1) for d in range(dim)], dim=1)
        cols = cols - torch.stack(
            [(fc * diffs[d]).sum(dim=0) for d in range(dim)], dim=1)
    return rows, cols


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def sym_force(pos: torch.Tensor, gm: torch.Tensor, bounds: torch.Tensor,
              q: Quantizer, self_masked: bool) -> torch.Tensor:
    """Kernel #1 wrapper: CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. Same arguments and result as sym_force_plain."""
    n, dim = _check_force_args(pos, gm, bounds)
    if pos.device.type == "cpu":
        return sym_force_plain(pos, gm, bounds, q, self_masked)
    lib = _library()
    tiles = _tiles(n)
    with torch.cuda.device(pos.device):
        part = torch.empty((tiles, tiles, TILE, dim), dtype=torch.float32,
                           device=pos.device)
        out = torch.empty_like(pos)
        rc = lib.nbody_sym_force(
            _ptr(pos), _ptr(gm), _ptr(bounds), n, dim, *_int_args(q),
            int(self_masked), _ptr(part), _ptr(out), _stream(pos.device))
    _raise_on(rc, "sym_force")
    LAUNCHES["sym_force"] += 1
    return out


def row_force(pos: torch.Tensor, gm: torch.Tensor, bounds: torch.Tensor,
              q: Quantizer, self_masked: bool) -> torch.Tensor:
    """Kernels #4 / #8 wrapper: CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Same arguments and result as
    row_force_plain (all rows)."""
    n, dim = _check_force_args(pos, gm, bounds)
    if pos.device.type == "cpu":
        return row_force_plain(pos, gm, bounds, q, self_masked)
    lib = _library()
    with torch.cuda.device(pos.device):
        out = torch.empty_like(pos)
        rc = lib.nbody_row_force(
            _ptr(pos), _ptr(gm), _ptr(bounds), n, dim, *_int_args(q),
            int(self_masked), _ptr(out), _stream(pos.device))
    _raise_on(rc, "row_force")
    LAUNCHES["row_force"] += 1
    return out


def pair_sym_force(pos_a: torch.Tensor, gm_a: torch.Tensor,
                   pos_b: torch.Tensor, gm_b: torch.Tensor,
                   bounds: torch.Tensor, q: Quantizer) -> tuple:
    """Kernel #6 wrapper: CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Same arguments and result (rows, cols) as
    pair_sym_force_plain."""
    n_a, dim = _check_force_args(pos_a, gm_a, bounds)
    n_b, dim_b = _check_positions(pos_b)
    if dim_b != dim:
        raise ValueError(f"receivers are {dim}-D, sources {dim_b}-D")
    _check_f32("sources", pos_b, (n_b, dim), pos_a.device)
    _check_f32("gm_b", gm_b, (n_b,), pos_a.device)
    if pos_a.device.type == "cpu":
        return pair_sym_force_plain(pos_a, gm_a, pos_b, gm_b, bounds, q)
    lib = _library()
    ta, tb = _tiles(n_a), _tiles(n_b)
    nseg = -(-tb // PAIR_SEGMENT_TILES)
    with torch.cuda.device(pos_a.device):
        rpart = torch.empty((ta, nseg, TILE, dim), dtype=torch.float32,
                            device=pos_a.device)
        cpart = torch.empty((tb, ta, TILE, dim), dtype=torch.float32,
                            device=pos_a.device)
        rows = torch.empty_like(pos_a)
        cols = torch.empty_like(pos_b)
        rc = lib.nbody_pair_sym_force(
            _ptr(pos_a), _ptr(gm_a), n_a, _ptr(pos_b), _ptr(gm_b), n_b,
            _ptr(bounds), dim, *_int_args(q), PAIR_SEGMENT_TILES,
            _ptr(rpart), _ptr(cpart), _ptr(rows), _ptr(cols),
            _stream(pos_a.device))
    _raise_on(rc, "pair_sym_force")
    LAUNCHES["pair_sym_force"] += 1
    return rows, cols


# --------------------------------------------------------------------------
# Kernels #2 / #3: global max of raw pairwise d^2
# --------------------------------------------------------------------------

def max_d2_plain(pos: torch.Tensor, skip: torch.Tensor | None = None,
                 count: torch.Tensor | None = None,
                 block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the max_d2 kernel: max over all pairs of
    the raw subtract-form d^2 (0-d f32); 0 where ``skip`` is nonzero.
    ``count`` (int32) gains 1 unless skipped."""
    n, dim = pos.shape
    best = torch.zeros((), dtype=torch.float32, device=pos.device)
    for r0 in range(0, n, block):
        pi = pos[r0:r0 + block]
        dx = pos[None, :, 0] - pi[:, 0, None]
        d2 = dx * dx
        for d in range(1, dim):
            dx = pos[None, :, d] - pi[:, d, None]
            d2 = d2 + dx * dx
        best = torch.maximum(best, d2.max())
    if count is not None:
        count += 1 if skip is None else (skip == 0).to(torch.int32)
    if skip is not None:
        best = torch.where(skip != 0, 0.0, best)
    return best


def _check_flag(name: str, t: torch.Tensor | None, device) -> None:
    if t is not None and (t.dtype != torch.int32 or t.numel() != 1
                          or t.device != device):
        raise ValueError(f"{name} must be one int32 on the positions' "
                         f"device")


def max_d2(pos: torch.Tensor, skip: torch.Tensor | None = None,
           count: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel #2 / #3 wrapper: CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``skip`` is an optional int32 flag on the
    same device: when nonzero the launch returns at once with 0. ``count``
    is an optional int32 on the same device that gains 1 when the launch
    was not skipped."""
    n, dim = _check_positions(pos)
    _check_flag("skip", skip, pos.device)
    _check_flag("count", count, pos.device)
    if pos.device.type == "cpu":
        return max_d2_plain(pos, skip, count)
    lib = _library()
    with torch.cuda.device(pos.device):
        block_max = torch.empty(MAX_D2_BLOCKS, dtype=torch.float32,
                                device=pos.device)
        out = torch.empty(1, dtype=torch.float32, device=pos.device)
        rc = lib.nbody_max_d2(
            _ptr(pos), n, dim, None if skip is None else _ptr(skip),
            None if count is None else _ptr(count), _ptr(block_max),
            MAX_D2_BLOCKS, _ptr(out), _stream(pos.device))
    _raise_on(rc, "max_d2")
    LAUNCHES["max_d2"] += 1
    return out[0]


def bounds_fallbacks(device) -> int:
    """How often the pruned bounds pass on ``device`` ran its full-set
    max_d2 launch since BOUNDS_FALLBACKS was last cleared (host read)."""
    count = BOUNDS_FALLBACKS.get(str(torch.device(device)))
    return 0 if count is None else int(count)


def _fallback_counter(device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in BOUNDS_FALLBACKS:
        BOUNDS_FALLBACKS[key] = torch.zeros((), dtype=torch.int32,
                                            device=device)
    return BOUNDS_FALLBACKS[key]


# --------------------------------------------------------------------------
# Public functions (counterparts of the pallas_nbody wrappers)
# --------------------------------------------------------------------------

def _softening(cfg: SimConfig, softening_sq):
    return cfg.softening_sq if softening_sq is None else softening_sq


def max_dist_sq(positions: torch.Tensor, cfg: SimConfig,
                softening_sq=None) -> torch.Tensor:
    """Global max softened pairwise d^2 through the max_d2 kernel."""
    return (max_d2(positions.to(torch.float32).contiguous())
            + _softening(cfg, softening_sq))


@functools.lru_cache(maxsize=None)
def _diameter_directions(dim: int, device: torch.device) -> torch.Tensor:
    """Fixed unit directions for the diameter lower bound: 8 in-plane
    angles for 2-D, the 13 cube axes/face-diagonals/corners for 3-D.
    Cached per device, so the step never copies them from the host."""
    if dim == 2:
        ang = torch.arange(8, dtype=torch.float32) * (math.pi / 8.0)
        dirs = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    elif dim == 3:
        vecs = torch.tensor(
            [(1, 0, 0), (0, 1, 0), (0, 0, 1),
             (1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1),
             (0, 1, 1), (0, 1, -1),
             (1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1)],
            dtype=torch.float32)
        dirs = vecs / torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    else:
        raise ValueError(f"unsupported dim {dim}")
    return dirs.to(device)


def max_pairwise_dist_sq_pruned(positions: torch.Tensor, cfg: SimConfig,
                                softening_sq=None,
                                max_candidates: int = 1024) -> torch.Tensor:
    """EXACT global max softened pairwise d^2 in O(N) work
    (counterpart of ``nbody_tpu.ops.forces.max_pairwise_dist_sq_pruned``).

    The max pairwise distance is the point set's diameter; both of its
    endpoints lie at least D_lb - r_max from the centroid (D_lb: the
    largest extent along a fixed direction set, r_max: the largest
    radius). So the ``max_candidates`` largest-radius points hold the
    diameter pair whenever that radius threshold admits at most
    ``max_candidates`` points. Otherwise (near-spherical shells,
    coincident clouds) the full O(N^2/2) pass decides. The ``max_d2``
    kernel runs on the candidates and on the full set; the full-set launch
    reads the admitted-count flag on the device and returns at once when
    the candidates suffice (else it counts itself in BOUNDS_FALLBACKS),
    and ``torch.where`` picks the result, so the step never waits on the
    host. d^2 is formed op for op as in the full pass, so the result is
    BITWISE the full max."""
    soft = _softening(cfg, softening_sq)
    pos = positions.to(torch.float32).contiguous()
    n, dim = pos.shape
    if n <= max_candidates:
        return max_d2(pos) + soft

    u = pos - pos.mean(dim=0)
    r2 = u[:, 0] * u[:, 0]
    for d in range(1, dim):
        r2 = r2 + u[:, d] * u[:, d]
    r = torch.sqrt(r2)
    r_max = r.max()

    # Projections written out elementwise: a matmul could run in TF32.
    dirs = _diameter_directions(dim, pos.device)
    proj = pos[:, 0:1] * dirs[:, 0]
    for d in range(1, dim):
        proj = proj + pos[:, d:d + 1] * dirs[:, d]
    d_lb = (proj.amax(dim=0) - proj.amin(dim=0)).max()
    # Endpoint radius bound with slack for f32 rounding of r / d_lb.
    thresh = (d_lb - r_max) * (1.0 - 1e-5) - 1e-6 * r_max
    admitted = (r >= thresh).sum()
    enough = (admitted <= max_candidates).to(torch.int32)

    idx = torch.topk(r, max_candidates).indices
    cand = pos.index_select(0, idx)
    cand_max = max_d2(cand)
    full_max = max_d2(pos, skip=enough,
                      count=_fallback_counter(pos.device))
    return torch.where(enough != 0, cand_max, full_max) + soft


def _scalar(value, device) -> torch.Tensor:
    """0-d f32 on ``device``; a fill, never a blocking host copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32, device=device)


def kernel_bounds(pos: torch.Tensor, q: Quantizer, cfg: SimConfig,
                  softening_sq=None, log_lo=None, log_hi=None):
    """bounds = [log_lo, log_hi, eps^2] (3,) f32 on pos's device. Int-sim
    modes take their tensor-global grid from the pruned max pass over all
    of pos unless log_lo/log_hi are given; float modes carry zeros."""
    soft_t = _scalar(_softening(cfg, softening_sq), pos.device)
    if not q.is_int:
        zero = torch.zeros((), dtype=torch.float32, device=pos.device)
        return torch.stack([zero, zero, soft_t])
    if log_lo is None or log_hi is None:
        log_lo, log_hi = dist_sq_log_bounds(
            q, max_pairwise_dist_sq_pruned(pos, cfg, softening_sq=soft_t),
            soft_t)
    return torch.stack([_scalar(log_lo, pos.device),
                        _scalar(log_hi, pos.device), soft_t])


def _self_masked(cfg: SimConfig, softening_sq) -> bool:
    """Mask the diagonal at zero softening, and whenever softening is a
    run-time value the host does not read (pallas_nbody.py:586)."""
    return softening_sq is not None or cfg.softening_sq <= 0.0


def _prepare(positions, masses, cfg: SimConfig, gm=None) -> tuple:
    pos = positions.to(torch.float32).contiguous()
    if gm is None:
        gm = cfg.G * masses.to(torch.float32)
    return pos, gm.to(torch.float32).contiguous()


def _finish(acc, q: Quantizer, quantize_forces: bool):
    return quantize_force(acc, q) if quantize_forces and q.is_int else acc


def sym_accelerations(positions: torch.Tensor, masses: torch.Tensor,
                      q: Quantizer, cfg: SimConfig,
                      quantize_forces: bool = True, softening_sq=None,
                      log_lo=None, log_hi=None) -> torch.Tensor:
    """Softened all-pairs accelerations through the sym_force kernel.

    Same semantics as ``nbody_tpu.ops.pallas_nbody.pallas_accelerations_sym``
    on its general path: int-sim modes take their tensor-global grid
    bounds from the candidate-pruned max pass unless ``log_lo``/``log_hi``
    are given, then quantize the (N, D) result with ``quantize_force``.
    ``softening_sq`` optionally replaces cfg's with a run-time (0-d
    tensor) value. The diagonal is masked when softening is zero or given
    at run time. Nothing here waits on the host."""
    pos, gm = _prepare(positions, masses, cfg)
    bounds = kernel_bounds(pos, q, cfg, softening_sq, log_lo, log_hi)
    acc = sym_force(pos, gm, bounds, q, _self_masked(cfg, softening_sq))
    return _finish(acc, q, quantize_forces)


def accelerations_rows(positions: torch.Tensor, masses: torch.Tensor,
                       q: Quantizer, cfg: SimConfig,
                       quantize_forces: bool = True,
                       softening_sq=None) -> torch.Tensor:
    """Row-sweep accelerations through the row_force kernel: the
    counterpart of ``pallas_accelerations`` (#8) and, under the name
    ``accelerations_streamed``, of ``pallas_accelerations_streamed`` (#4);
    the TPU split between the two exists only because of VMEM. Int-sim
    bounds come from the pruned max pass with the run-time softening
    (pallas_nbody.py:808-814); the diagonal is masked when softening is
    zero or given at run time."""
    pos, gm = _prepare(positions, masses, cfg)
    bounds = kernel_bounds(pos, q, cfg, softening_sq)
    acc = row_force(pos, gm, bounds, q, _self_masked(cfg, softening_sq))
    return _finish(acc, q, quantize_forces)


accelerations_streamed = accelerations_rows


def sym_accelerations_chunked(positions: torch.Tensor, masses, q: Quantizer,
                              cfg: SimConfig, quantize_forces: bool = True,
                              chunk: int | None = None, softening_sq=None,
                              log_lo=None, log_hi=None,
                              gm=None) -> torch.Tensor:
    """Newton's-third-law accelerations past one sym_force launch's
    scratch budget: the counterpart of ``pallas_accelerations_sym_chunked``
    (#5).

    Particles are cut into chunks (``sym_chunk_size`` unless given; the
    last may be shorter). Each chunk runs sym_force on itself, each chunk
    pair i < j one pair_sym_force launch giving chunk i's rows and chunk
    j's reactions: C sym_force and C(C-1)/2 pair_sym_force launches,
    ~N^2/2 pair evaluations. Sums follow JAX's order: acc_i = diagonal +
    rows over j ascending, acc[j] += cols. Int-sim bounds are taken once
    over all N. Zero or run-time softening routes to the row sweep
    (pallas_nbody.py:892-895): the pair tile has no self-mask."""
    if _self_masked(cfg, softening_sq):
        return accelerations_streamed(positions, masses, q, cfg,
                                      quantize_forces=quantize_forces,
                                      softening_sq=softening_sq)
    pos, gm = _prepare(positions, masses, cfg, gm)
    n, dim = pos.shape
    bounds = kernel_bounds(pos, q, cfg, None, log_lo, log_hi)
    chunk = min(sym_chunk_size(n, dim) if chunk is None else chunk, n)
    spans = [slice(a, min(a + chunk, n)) for a in range(0, n, chunk)]
    acc = torch.zeros_like(pos)
    for i, si in enumerate(spans):
        acc_i = sym_force(pos[si], gm[si], bounds, q, False)
        for sj in spans[i + 1:]:
            rows, cols = pair_sym_force(pos[si], gm[si], pos[sj], gm[sj],
                                        bounds, q)
            acc_i = acc_i + rows
            acc[sj] += cols
        acc[si] += acc_i
    return _finish(acc, q, quantize_forces)
