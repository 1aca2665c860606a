"""The benchmark's roofline arithmetic: frozen copies of ``chip_smoke.py``'s
peaks and operation counts (commit 41d9088), so that a later change to the
program or to its smoke script cannot move the yardstick.

Each function counts the operations of the *function* a kernel computes,
whatever design computes it, so a share of the roofline read against it
stays comparable across kernel redesigns.
"""

from __future__ import annotations

# chip_smoke.py:374. The H100 SXM's published peaks: FP32 outside the
# tensor cores, HBM3 bandwidth, and dense bf16 on the tensor cores.
PEAK_FP32, PEAK_BYTES, PEAK_BF16 = 67e12, 3.35e12, 989e12


def weight_ops(mode: str) -> int:
    """chip_smoke.py:387-393. fp32 operations of one pair's weight w from
    its softened d^2 (a transcendental counts as one): rsqrt and two
    multiplies; plus the bf16 / f16 round trip; the int chain's max, log,
    mul, add, rint, mul, add, min, exp."""
    return {"bfloat16": 5, "float16": 5}.get(
        mode, 9 if mode in ("int8", "int4", "custom") else 3)


def pair_ops(kind: str, dim: int, mode: str) -> int:
    """chip_smoke.py:396-432. fp32 operations per pair: d^2 is D
    subtracts, D multiplies and D-1 adds, plus the softening add. "sym_t"
    is the equal-mass function's own count, t = w diff (D multiplies) added
    into the rows (D adds) and subtracted from the reactions (D adds);
    "sym_gm" the general function's, fr = G m_j w and fc = G m_i w (2
    multiplies) and D fused multiply-adds of each into the rows and the
    reactions (4 D); a "_max" suffix adds the fused max's one max a pair.
    "rows" an ordered pair (one G m multiply, D fused multiply-adds);
    "max" the bounds pass's d^2 and max; "pe" a potential-energy pair."""
    d2 = 3 * dim
    fused = kind.endswith("_max")
    if kind in ("sym_t", "sym_t_max"):
        return d2 + weight_ops(mode) + 3 * dim + fused
    if kind in ("sym_gm", "sym_gm_max"):
        return d2 + weight_ops(mode) + 2 + 4 * dim + fused
    if kind == "rows":
        return d2 + weight_ops(mode) + 1 + 2 * dim
    if kind == "max":
        return d2
    if kind == "pe":
        return d2 + 4
    raise ValueError(kind)


def bound(pairs: float, ops_per_pair: int, nbytes: float,
          tensor_flops_per_pair: int = 0) -> tuple:
    """chip_smoke.py:447-457. (ms, "operations" or "bytes"): the least
    time the card could take, the largest of the FP32 operations over the
    FP32 peak, the tensor-core flops over the dense bf16 peak, and the
    bytes (each input read once, each output written once) over HBM's
    rate."""
    ops_ms = max(pairs * ops_per_pair / PEAK_FP32,
                 pairs * tensor_flops_per_pair / PEAK_BF16) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def sym_bytes(n: int, dim: int, fused_max: bool = False) -> float:
    """chip_smoke.py:474-476. Positions, G m and bounds in, the forces
    (and the max) out."""
    return 4 * (n * (2 * dim + 1) + 3 + fused_max)


def force_bound_ms(n: int, dim: int, mode: str, equal_masses: bool) -> tuple:
    """The least time of one all-pairs force evaluation: N(N-1)/2
    unordered pairs at the function's own count ("sym_t" with equal
    masses, else "sym_gm"), or its bytes, whichever bounds it."""
    kind = "sym_t" if equal_masses else "sym_gm"
    return bound(n * (n - 1) / 2, pair_ops(kind, dim, mode),
                 sym_bytes(n, dim))
