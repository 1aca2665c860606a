"""Softened all-pairs gravity with a precision-degradation hook.

PyTorch counterpart of ``nbody_tpu.ops.forces``. Three implementations
share identical semantics:

* ``dense_accelerations`` — materialises the (N, N) pairwise block; the
  correctness oracle at small N;
* ``tiled_accelerations`` — row blocks, O(block * N) memory;
* the CUDA kernels behind ``ops.hopper_nbody`` (``sym_accelerations``,
  its chunked form past one launch's scratch budget, and the row sweep
  ``accelerations_rows``) — the production paths on the GPU.

The int-sim quantizer needs the global log-bounds of the softened d^2
matrix: the min is analytic (``precision.dist_sq_log_bounds``), the max
comes from a max pass. ``max_pairwise_dist_sq_pruned`` (defined in
``ops.hopper_nbody``) finds it exactly in O(N) work with the ``max_d2``
kernel, and decides on the device whether its candidates suffice.

The float64 baseline is native ``torch.float64`` here
(``baseline_accelerations``). The JAX package emulates it with
double-double arithmetic (``nbody_tpu/ops/doubledouble.py``) because a
TPU has no f64 unit; the GPU has one, and the torch reference ran true
f64, so double-double is not carried over.

Physics (reference: simulation.py:83-117):
    diff[i, j] = x_j - x_i
    d2[i, j]   = |diff|^2 + softening^2
    d2q        = quantize(d2, mode)
    acc[i]     = G * sum_{j != i} m_j * diff[i, j] / d2q^{3/2}
    acc        = quantize_force(acc) for int8/int4 modes
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody
# The pruned bounds pass drives the max_d2 kernel and lives beside it;
# its public name stays here, where the JAX package has it.
from nbody_tpu_torch.ops.hopper_nbody import max_pairwise_dist_sq_pruned
from nbody_tpu_torch.ops.precision import (
    Quantizer,
    dist_sq_log_bounds,
    quantize_distance_squared,
    quantize_force,
)


def _softening(cfg: SimConfig, softening_sq):
    return cfg.softening_sq if softening_sq is None else softening_sq


def _pair_block(pos_i, pos_j, masses_j, self_mask, q: Quantizer,
                cfg: SimConfig, log_lo, log_hi, softening_sq=None):
    """Acceleration of receivers ``pos_i`` (B, D) due to sources ``pos_j``
    (M, D); ``self_mask`` (B, M) marks receiver == source. (B, D) f32.
    ``softening_sq`` optionally replaces cfg's (a run-time value)."""
    diff = pos_j[None, :, :] - pos_i[:, None, :]
    d2 = (diff * diff).sum(dim=-1) + _softening(cfg, softening_sq)
    d2q = quantize_distance_squared(d2, q, log_lo=log_lo, log_hi=log_hi)
    inv_d = torch.rsqrt(d2q.to(torch.float32))
    inv_d3 = inv_d * inv_d * inv_d
    factor = cfg.G * masses_j[None, :] * inv_d3
    factor = torch.where(self_mask, 0.0, factor)
    return (factor[:, :, None] * diff).sum(dim=1)


def max_pairwise_dist_sq(positions: torch.Tensor, cfg: SimConfig,
                         softening_sq=None) -> torch.Tensor:
    """Global max of the softened pairwise d^2 matrix, plain PyTorch,
    O(block * N) memory (the plain version of the max_d2 kernel)."""
    pos = positions.to(torch.float32)
    return hopper_nbody.max_d2_plain(pos) + _softening(cfg, softening_sq)


def _quant_bounds(positions, q: Quantizer, cfg: SimConfig,
                  softening_sq=None):
    """(log_lo, log_hi) for int modes, else (None, None)."""
    if not q.is_int:
        return None, None
    return dist_sq_log_bounds(
        q, max_pairwise_dist_sq(positions, cfg, softening_sq),
        _softening(cfg, softening_sq))


def _maybe_quantize_force(acc, q: Quantizer, quantize_forces: bool):
    if quantize_forces and q.is_int:
        return quantize_force(acc, q)
    return acc


def dense_accelerations(positions, masses, q: Quantizer, cfg: SimConfig,
                        quantize_forces: bool = True, softening_sq=None,
                        log_lo=None, log_hi=None) -> torch.Tensor:
    """Oracle implementation: materialises (N, N). Small N only.

    ``log_lo``/``log_hi`` optionally supply external int-sim grid bounds;
    by default they are recomputed per call. ``softening_sq`` optionally
    replaces cfg's with a run-time value."""
    positions = positions.to(torch.float32)
    masses = masses.to(torch.float32)
    n = positions.shape[0]
    if log_lo is None or log_hi is None:
        log_lo, log_hi = _quant_bounds(positions, q, cfg, softening_sq)
    self_mask = torch.eye(n, dtype=torch.bool, device=positions.device)
    acc = _pair_block(positions, positions, masses, self_mask, q, cfg,
                      log_lo, log_hi, softening_sq)
    return _maybe_quantize_force(acc, q, quantize_forces)


def tiled_accelerations(positions, masses, q: Quantizer, cfg: SimConfig,
                        quantize_forces: bool = True, block: int = 1024,
                        softening_sq=None, log_lo=None,
                        log_hi=None) -> torch.Tensor:
    """O(block * N) memory row-blocked force evaluation."""
    positions = positions.to(torch.float32)
    masses = masses.to(torch.float32)
    n = positions.shape[0]
    if log_lo is None or log_hi is None:
        log_lo, log_hi = _quant_bounds(positions, q, cfg, softening_sq)
    ids = torch.arange(n, device=positions.device)
    blocks = []
    for r0 in range(0, n, block):
        self_mask = ids[r0:r0 + block, None] == ids[None, :]
        blocks.append(_pair_block(positions[r0:r0 + block], positions,
                                  masses, self_mask, q, cfg, log_lo,
                                  log_hi, softening_sq))
    return _maybe_quantize_force(torch.cat(blocks), q, quantize_forces)


def baseline_accelerations(positions, masses, cfg: SimConfig,
                           block: int = 1024) -> torch.Tensor:
    """Native float64 force for the baseline: every pair term and the sum
    in f64, row-blocked so memory stays O(block * N). (N, D) f64."""
    pos = positions.to(torch.float64)
    ids = torch.arange(pos.shape[0], device=pos.device)
    return baseline_pair_accelerations(pos, ids, pos,
                                       cfg.G * masses.to(torch.float64), ids,
                                       cfg, block)


def baseline_pair_accelerations(pos_i, ids_i, pos_j, gm_j, ids_j,
                                cfg: SimConfig,
                                block: int = 1024) -> torch.Tensor:
    """Native float64 accelerations of receivers ``pos_i`` due to sources
    ``pos_j`` (f64, ``gm_j`` = G * m_j), pairs of equal id masked: the
    baseline's tile, one set or two (the multi-device ring's). (n_i, D)
    f64."""
    out = torch.empty_like(pos_i)
    for r0 in range(0, pos_i.shape[0], block):
        diff = pos_j[None, :, :] - pos_i[r0:r0 + block, None, :]
        d2 = (diff * diff).sum(dim=-1) + cfg.softening_sq
        inv_d = torch.rsqrt(d2)
        factor = gm_j[None, :] * (inv_d * inv_d * inv_d)
        factor = torch.where(ids_i[r0:r0 + block, None] == ids_j[None, :],
                             0.0, factor)
        out[r0:r0 + block] = (factor[:, :, None] * diff).sum(dim=1)
    return out
