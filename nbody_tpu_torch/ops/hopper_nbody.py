"""Hand-written Hopper kernels of the direct engine, with their plain twins.

PyTorch counterpart of ``nbody_tpu.ops.pallas_nbody``, for the two TPU
kernels on the precision-ladder path:

* ``sym_force`` — CUDA kernel ``csrc/sym_force.cu``, replacing
  ``_force_kernel_sym`` / ``pallas_accelerations_sym``: softened
  all-pairs gravity, each unordered pair's weight evaluated once
  (Newton's third law), with the precision hook in the tile.
* ``max_d2`` — CUDA kernel ``csrc/max_dist_sq.cu``, replacing
  ``_max_kernel`` / ``pallas_max_dist_sq``: the global max of the raw
  pairwise d^2, the int-sim log grid's upper bound.

Each kernel has a plain PyTorch version of the same function and
signature (``sym_force_plain``, ``max_d2_plain``). A wrapper launches the
kernel for a CUDA tensor (or raises) and takes the plain version only for
a CPU tensor; there is no fallback from a failed launch. Every launch
adds one to ``LAUNCHES[name]``, so a run can show that it went through
the kernels. The kernel sources carry the notes on design and numerics.

``sym_accelerations`` and ``max_dist_sq`` are the counterparts of the
JAX wrappers' public functions (bounds, G*m, int-sim force quantization);
``max_pairwise_dist_sq_pruned``, the int modes' bounds pass around the
max_d2 kernel, lives here beside it.
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
LAUNCHES = {"sym_force": 0, "max_d2": 0}

# Per-block maxima scratch of max_d2: the kernel's grid-stride loop uses
# at most this many blocks.
MAX_D2_BLOCKS = 1024

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


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# --------------------------------------------------------------------------
# Kernel 1: Newton's-third-law pair forces
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
    """w = quantized |r|^-3 of softened d^2, as the kernel computes it."""
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


def _plain_rows(pos, gm, bounds, q: Quantizer, self_masked: bool,
                block: int, term) -> torch.Tensor:
    """sum_j term(gm_j w_ij diff_ij) per row and component, row-blocked."""
    n, dim = pos.shape
    grid = _int_grid(bounds, q) if q.is_int else None
    soft = bounds[2]
    ids = torch.arange(n, device=pos.device)
    out = torch.empty_like(pos)
    for r0 in range(0, n, block):
        pi = pos[r0:r0 + block]
        diffs = [pos[None, :, d] - pi[:, d, None] for d in range(dim)]
        d2 = diffs[0] * diffs[0]
        for d in range(1, dim):
            d2 = d2 + diffs[d] * diffs[d]
        factor = gm[None, :] * _pair_weight(d2 + soft, q, grid)
        if self_masked:
            factor = torch.where(ids[r0:r0 + block, None] == ids[None, :],
                                 0.0, factor)
        out[r0:r0 + block] = torch.stack(
            [term(factor * diffs[d]).sum(dim=1) for d in range(dim)], dim=1)
    return out


def sym_force_plain(pos: torch.Tensor, gm: torch.Tensor,
                    bounds: torch.Tensor, q: Quantizer, self_masked: bool,
                    block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the sym_force kernel: row-blocked
    acc_i = sum_{j != i} gm_j w_ij (x_j - x_i), O(block * N) memory.

    pos (N, D) f32, gm (N,) f32 = G*m, bounds (3,) f32 = [log_lo, log_hi,
    eps^2]. Returns (N, D) f32, before any int-sim force quantization."""
    return _plain_rows(pos, gm, bounds, q, self_masked, block,
                       lambda t: t)


def sym_force_term_scale(pos: torch.Tensor, gm: torch.Tensor,
                         bounds: torch.Tensor, q: Quantizer,
                         self_masked: bool,
                         block: int = 1024) -> torch.Tensor:
    """sum_j |gm_j w_ij (x_j - x_i)| per component: the scale of the
    rounding error that any summation order of sym_force's rows makes.
    Where terms cancel (near-coincident pairs at zero softening) |acc| is
    far below it, and a tolerance on |acc| alone would test the order."""
    return _plain_rows(pos, gm, bounds, q, self_masked, block, torch.abs)


def sym_force(pos: torch.Tensor, gm: torch.Tensor, bounds: torch.Tensor,
              q: Quantizer, self_masked: bool) -> torch.Tensor:
    """Kernel 1 wrapper: CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. Same arguments and result as sym_force_plain."""
    n, dim = _check_positions(pos)
    _check_f32("gm", gm, (n,), pos.device)
    _check_f32("bounds", bounds, (3,), pos.device)
    if pos.device.type == "cpu":
        return sym_force_plain(pos, gm, bounds, q, self_masked)
    from nbody_tpu_torch import _build
    lib = _build.library()
    bt = lib.nbody_sym_force_tile()
    tiles = -(-n // bt)
    with torch.cuda.device(pos.device):
        part = torch.empty((tiles, tiles, bt, dim), dtype=torch.float32,
                           device=pos.device)
        out = torch.empty_like(pos)
        rc = lib.nbody_sym_force(
            _ptr(pos), _ptr(gm), _ptr(bounds), n, dim, _mode_code(q),
            q.levels, _arg_cap(q), q.min_dist_sq, int(self_masked),
            _ptr(part), _ptr(out), _stream(pos.device))
    _raise_on(rc, "sym_force")
    LAUNCHES["sym_force"] += 1
    return out


# --------------------------------------------------------------------------
# Kernel 2: global max of raw pairwise d^2
# --------------------------------------------------------------------------

def max_d2_plain(pos: torch.Tensor, skip: torch.Tensor | None = None,
                 block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the max_d2 kernel: max over all pairs of
    the raw subtract-form d^2 (0-d f32); 0 where ``skip`` is nonzero."""
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
    if skip is not None:
        best = torch.where(skip != 0, 0.0, best)
    return best


def max_d2(pos: torch.Tensor, skip: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Kernel 2 wrapper: CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. ``skip`` is an optional int32 flag on the same
    device: when nonzero the launch returns at once with 0."""
    n, dim = _check_positions(pos)
    if skip is not None:
        if skip.dtype != torch.int32 or skip.numel() != 1 \
                or skip.device != pos.device:
            raise ValueError("skip must be one int32 on the positions' "
                             "device")
    if pos.device.type == "cpu":
        return max_d2_plain(pos, skip)
    from nbody_tpu_torch import _build
    lib = _build.library()
    with torch.cuda.device(pos.device):
        block_max = torch.empty(MAX_D2_BLOCKS, dtype=torch.float32,
                                device=pos.device)
        out = torch.empty(1, dtype=torch.float32, device=pos.device)
        rc = lib.nbody_max_d2(
            _ptr(pos), n, dim, None if skip is None else _ptr(skip),
            _ptr(block_max), MAX_D2_BLOCKS, _ptr(out), _stream(pos.device))
    _raise_on(rc, "max_d2")
    LAUNCHES["max_d2"] += 1
    return out[0]


# --------------------------------------------------------------------------
# Public functions (counterparts of pallas_accelerations_sym and
# pallas_max_dist_sq)
# --------------------------------------------------------------------------

def max_dist_sq(positions: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Global max softened pairwise d^2 through the max_d2 kernel."""
    return max_d2(positions.to(torch.float32).contiguous()) + cfg.softening_sq


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
    the candidates suffice, and ``torch.where`` picks the result, so the
    step never waits on the host. d^2 is formed op for op as in the full
    pass, so the result is BITWISE the full max."""
    pos = positions.to(torch.float32).contiguous()
    n, dim = pos.shape
    if n <= max_candidates:
        return max_d2(pos) + cfg.softening_sq

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
    full_max = max_d2(pos, skip=enough)
    return torch.where(enough != 0, cand_max, full_max) + cfg.softening_sq


def _scalar(value, device) -> torch.Tensor:
    """0-d f32 on ``device``; a fill, never a blocking host copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32, device=device)


def sym_accelerations(positions: torch.Tensor, masses: torch.Tensor,
                      q: Quantizer, cfg: SimConfig,
                      quantize_forces: bool = True,
                      log_lo=None, log_hi=None) -> torch.Tensor:
    """Softened all-pairs accelerations through the sym_force kernel.

    Same semantics as ``nbody_tpu.ops.pallas_nbody.pallas_accelerations_sym``
    on its general path: int-sim modes take their tensor-global grid
    bounds from the candidate-pruned max pass unless ``log_lo``/``log_hi``
    are given, then quantize the (N, D) result with ``quantize_force``.
    The diagonal is masked when softening is zero. Nothing here waits on
    the host."""
    pos = positions.to(torch.float32).contiguous()
    gm = (cfg.G * masses.to(torch.float32)).contiguous()
    soft_t = _scalar(cfg.softening_sq, pos.device)
    if q.is_int:
        if log_lo is None or log_hi is None:
            log_lo, log_hi = dist_sq_log_bounds(
                q, max_pairwise_dist_sq_pruned(pos, cfg), cfg.softening_sq)
        bounds = torch.stack([_scalar(log_lo, pos.device),
                              _scalar(log_hi, pos.device), soft_t])
    else:
        zero = torch.zeros((), dtype=torch.float32, device=pos.device)
        bounds = torch.stack([zero, zero, soft_t])
    acc = sym_force(pos, gm, bounds, q, cfg.softening_sq <= 0.0)
    if quantize_forces and q.is_int:
        acc = quantize_force(acc, q)
    return acc
