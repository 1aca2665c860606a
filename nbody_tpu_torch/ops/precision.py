"""Precision ladder: fake-quantization ops that make physics "lossy".

PyTorch counterpart of ``nbody_tpu.ops.precision``. The mode table, the
frozen ``Quantizer`` and the grid quantizers keep their JAX semantics;
what differs:

* ``float64`` is native on the GPU: the baseline engine keeps its state
  and force in ``torch.float64`` (``ops.forces.baseline_accelerations``),
  so in this module FLOAT64 still means "no degradation applied".
* The bf16/f16 round-trips are native casts. PyTorch runs them eagerly
  and never elides them (the JAX package bit-emulates both because XLA
  could elide a native round-trip); bitwise equality with the JAX
  emulations is unit-tested.
* Every quantizer accepts optional precomputed bounds as 0-d tensors,
  so the global bounds can stay on the device (no host sync per step).
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Precision(enum.Enum):
    """Available precision degradation modes (reference: quantization.py:10-18)."""

    FLOAT64 = "float64"     # native float64 baseline on the GPU
    FLOAT32 = "float32"
    BFLOAT16 = "bfloat16"   # f32 range, 7-bit mantissa
    FLOAT16 = "float16"
    INT8_SIM = "int8_sim"   # simulated 8-bit: 256-level log grid
    INT4_SIM = "int4_sim"   # simulated 4-bit: 16-level log grid
    CUSTOM = "custom"       # user-chosen level count


_INT_MODES = (Precision.INT8_SIM, Precision.INT4_SIM, Precision.CUSTOM)

_ALIASES = {
    "float64": Precision.FLOAT64,
    "f64": Precision.FLOAT64,
    "fp64": Precision.FLOAT64,
    "float32": Precision.FLOAT32,
    "f32": Precision.FLOAT32,
    "fp32": Precision.FLOAT32,
    "bfloat16": Precision.BFLOAT16,
    "bf16": Precision.BFLOAT16,
    "float16": Precision.FLOAT16,
    "fp16": Precision.FLOAT16,
    "f16": Precision.FLOAT16,
    "half": Precision.FLOAT16,
    "int8": Precision.INT8_SIM,
    "int8_sim": Precision.INT8_SIM,
    "int4": Precision.INT4_SIM,
    "int4_sim": Precision.INT4_SIM,
    "custom": Precision.CUSTOM,
}

_DESCRIPTIONS = {
    Precision.FLOAT64: "native 64-bit baseline",
    Precision.FLOAT32: "32-bit float",
    Precision.BFLOAT16: "bfloat16 (7-bit mantissa)",
    Precision.FLOAT16: "16-bit float (half precision)",
    Precision.INT8_SIM: "simulated 8-bit (256-level log grid)",
    Precision.INT4_SIM: "simulated 4-bit (16-level log grid)",
    Precision.CUSTOM: "custom quantization level count",
}


def get_mode_from_string(mode_str: str, strict: bool = False) -> Precision:
    """String -> Precision, accepting the reference's aliases
    (reference: quantization.py:160-175). Unknown strings fall back to
    FLOAT64 (reference behavior); strict=True raises instead, for CLI
    surfaces where a typo silently running the baseline would mislead."""
    key = mode_str.strip().lower()
    if strict and key not in _ALIASES:
        raise ValueError(
            f"unknown precision mode {mode_str!r}; valid: "
            f"{sorted(set(_ALIASES))}")
    return _ALIASES.get(key, Precision.FLOAT64)


def describe_mode(mode: Precision) -> str:
    """Human-readable mode description (reference: quantization.py:178-189)."""
    return _DESCRIPTIONS.get(mode, "unknown mode")


@dataclasses.dataclass(frozen=True)
class Quantizer:
    """Static description of a precision mode (frozen, hashable)."""

    mode: Precision = Precision.FLOAT32
    custom_levels: int = 64
    min_dist_sq: float = 0.01  # safety floor (reference: quantization.py:25)

    @classmethod
    def from_string(cls, mode_str: str, custom_levels: int = 64) -> "Quantizer":
        return cls(mode=get_mode_from_string(mode_str), custom_levels=custom_levels)

    @property
    def levels(self) -> int:
        if self.mode == Precision.INT8_SIM:
            return 256
        if self.mode == Precision.INT4_SIM:
            return 16
        if self.mode == Precision.CUSTOM:
            return self.custom_levels or 64
        return 0

    @property
    def is_int(self) -> bool:
        return self.mode in _INT_MODES

    @property
    def is_float_cast(self) -> bool:
        return self.mode in (Precision.BFLOAT16, Precision.FLOAT16)

    @property
    def is_noop(self) -> bool:
        """True when dist^2 passes through numerically unchanged in f32."""
        return self.mode in (Precision.FLOAT64, Precision.FLOAT32)

    def describe(self) -> str:
        return describe_mode(self.mode)


# --------------------------------------------------------------------------
# Native round-trips (IEEE round-to-nearest-even, f16 subnormals and
# overflow to inf at |x| >= 65520 included)
# --------------------------------------------------------------------------

def f16_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """f32 -> f16 -> f32 value round-trip."""
    return x.to(torch.float32).to(torch.float16).to(torch.float32)


def bf16_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 -> f32 value round-trip."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


# --------------------------------------------------------------------------
# Grid quantizers
# --------------------------------------------------------------------------

def grid_quantize(x: torch.Tensor, levels: int, lo=None,
                  hi=None) -> torch.Tensor:
    """Linear min/max grid rounding (reference: quantization.py:74-88).

    Degenerate ranges pass through untouched. ``lo``/``hi`` override the
    tensor-global bounds."""
    lo = x.min() if lo is None else lo
    hi = x.max() if hi is None else hi
    span = torch.as_tensor(hi - lo, dtype=x.dtype, device=x.device)
    degenerate = span < 1e-10
    safe_span = torch.where(degenerate, torch.ones_like(span), span)
    normalized = (x - lo) / safe_span * (levels - 1)
    snapped = torch.round(normalized) / (levels - 1) * safe_span + lo
    return torch.where(degenerate, x, snapped)


def grid_quantize_safe(x: torch.Tensor, levels: int, min_val: float = 0.01,
                       log_lo=None, log_hi=None) -> torch.Tensor:
    """Log-space grid quantization above a safety floor
    (reference: quantization.py:91-127) — THE "broken math" primitive.

    Clamps to ``min_val``, rounds ``log(x)`` onto a ``levels``-point
    uniform grid between the global log-min and log-max, exponentiates."""
    x_safe = torch.clamp(x, min=min_val)
    log_x = torch.log(x_safe)
    log_lo = log_x.min() if log_lo is None else log_lo
    log_hi = log_x.max() if log_hi is None else log_hi
    span = torch.as_tensor(log_hi - log_lo, dtype=x.dtype, device=x.device)
    degenerate = span < 1e-10
    safe_span = torch.where(degenerate, torch.ones_like(span), span)
    normalized = (log_x - log_lo) / safe_span * (levels - 1)
    log_snapped = torch.round(normalized) / (levels - 1) * safe_span + log_lo
    out = torch.where(degenerate, x_safe, torch.exp(log_snapped))
    return torch.clamp(out, min=min_val)


# --------------------------------------------------------------------------
# The two public degradation hooks
# --------------------------------------------------------------------------

def quantize_distance_squared(dist_sq: torch.Tensor, q: Quantizer,
                              log_lo=None, log_hi=None) -> torch.Tensor:
    """Degrade pairwise distance^2 per the precision mode
    (reference: quantization.py:21-71)."""
    if q.mode == Precision.BFLOAT16:
        return bf16_roundtrip(dist_sq)
    if q.mode == Precision.FLOAT16:
        return f16_roundtrip(dist_sq)
    if q.is_int:
        return grid_quantize_safe(dist_sq, q.levels, q.min_dist_sq,
                                  log_lo=log_lo, log_hi=log_hi)
    return dist_sq


def quantize_force(force: torch.Tensor, q: Quantizer, lo=None,
                   hi=None) -> torch.Tensor:
    """Degrade force/acceleration vectors (reference: quantization.py:130-157).

    Int modes use the *linear* grid here (the reference deliberately uses
    the unsafe variant on forces)."""
    if q.mode == Precision.BFLOAT16:
        return bf16_roundtrip(force)
    if q.mode == Precision.FLOAT16:
        return f16_roundtrip(force)
    if q.is_int:
        return grid_quantize(force, q.levels, lo=lo, hi=hi)
    return force


def dist_sq_log_bounds(q: Quantizer, max_dist_sq, softening_sq) -> tuple:
    """Global log bounds for the dist^2 quantizer in the direct engine.

    The raw global minimum of the softened dist^2 matrix is analytically
    softening^2 (its diagonal), so after the safety clamp it is
    max(softening^2, min_dist_sq); only the max needs a pass over all
    pairs. ``softening_sq`` is a float or a 0-d tensor (a run-time
    softening). Returns 0-d f32 tensors on ``max_dist_sq``'s device (a
    float softening becomes a fill there, never a blocking host copy)."""
    max_dist_sq = torch.as_tensor(max_dist_sq, dtype=torch.float32)
    if isinstance(softening_sq, torch.Tensor):
        soft = softening_sq.to(device=max_dist_sq.device,
                               dtype=torch.float32).reshape(())
    else:
        soft = torch.full((), float(softening_sq), dtype=torch.float32,
                          device=max_dist_sq.device)
    lo = torch.clamp(soft, min=q.min_dist_sq)
    log_lo = torch.log(lo)
    log_hi = torch.log(torch.maximum(max_dist_sq, lo))
    return log_lo, log_hi
