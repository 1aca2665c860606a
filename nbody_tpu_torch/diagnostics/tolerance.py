"""The tolerance rules of the port's kernel checks, stated once.

``chip_smoke.py`` holds each kernel against its plain version with them,
and the kernel fuzz (``nbody_tpu_torch.fuzz``) holds each case against the
plain versions and the dense oracle with them (PERF.md §2):

* float modes: |got - want| <= ATOL + RTOL max(|want|, s) per component,
  s a scale the caller gives: the row's summed |terms|
  (``hopper_nbody.sym_force_term_scale`` or ``pair_force_term_scale``)
  where terms cancel and |want| is far below the rounding any summation
  order makes, else 0. Non-finite entries (float16 rounding a tiny d^2 to
  0 at zero softening) must be the same in both; against an oracle the
  output must be finite (``Tally.hold(finite=True)``), as the JAX fuzz
  harness requires.
* int8 / int4 / custom after ``quantize_force``: at most
  max(FLIPS_ALLOWED, FLIP_RATE x components) components off by more than
  ATOL + RTOL max|want|, each by at most one grid step: a difference
  inside the float rule that straddles an edge of the tensor-global linear
  grid. It holds where a path quantizes, a whole evaluation's (N, D)
  forces. A partial sum (a pair tile's rows or reactions, a chunk's
  diagonal, a ring's tile) meets the float rule alone: no path quantizes
  it by itself, and its own grid is not the summed forces' grid.
* the max of d^2: bit for bit.
* ``pair_pe_rows``: relative to the row (its terms are positive, so the
  row is its summed |terms|), the bound of the design it runs
  (``pe_bound_rtol``).
"""

from __future__ import annotations

import math

import torch

from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Quantizer, quantize_force

RTOL, ATOL = 5e-5, 2e-6   # the float tolerance of tests/test_pallas_kernel.py
FLIPS_ALLOWED = 4         # per case up to 40,000 components
FLIP_RATE = 1e-4          # per component beyond that


def float_rule(got, want, scale) -> tuple:
    """(ok, max abs err, max err / its bound, non-finite count) of the
    float rule over finite entries; non-finite entries must be the same
    inf / NaN in both."""
    fin = torch.isfinite(want)
    same_nonfinite = torch.equal(torch.isfinite(got), fin) and bool(
        ((got[~fin] == want[~fin])
         | (torch.isnan(got[~fin]) & torch.isnan(want[~fin]))).all())
    err = (got[fin] - want[fin]).abs()
    if not err.numel():
        return same_nonfinite, 0.0, 0.0, int((~fin).sum())
    bound = ATOL + RTOL * torch.maximum(want[fin].abs(), scale[fin])
    ratio = (err / bound).max().item()
    return (same_nonfinite and ratio <= 1.0, err.max().item(), ratio,
            int((~fin).sum()))


def flips_allowed(t: torch.Tensor) -> int:
    """Components a case may hold one grid step apart after the int modes'
    quantize_force: differences inside the tolerance that straddle an
    edge of the linear grid. A roughly symmetric force distribution puts
    an edge of the 16-level grid at 0 (normalised 7.5), where components
    are densest, so the count grows with N (1M, D=3: 34 of 3.1M)."""
    return max(FLIPS_ALLOWED, math.floor(FLIP_RATE * t.numel()))


def flips_rule(got_q, want_q, q: Quantizer) -> tuple:
    """(ok, components off, max abs err) of two forces after
    quantize_force: at most flips_allowed components off, each by at most
    one step of want's grid."""
    step = (want_q.max() - want_q.min()) / (q.levels - 1)
    tol = ATOL + RTOL * want_q.abs().max()
    diff = (got_q - want_q).abs()
    off = diff > tol
    n_off = int(off.sum())
    one_step = bool((diff[off] <= step + tol).all())
    return (n_off <= flips_allowed(want_q) and one_step, n_off,
            diff.max().item() if diff.numel() else 0.0)


def quantized_flips(got, want, q: Quantizer) -> tuple:
    """flips_rule on quantize_force of two raw forces; (True, 0, 0.0) in
    the float modes."""
    if not q.is_int:
        return True, 0, 0.0
    return flips_rule(quantize_force(got, q), quantize_force(want, q), q)


def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits (a NaN equals the same NaN, unlike torch.equal)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a = a.contiguous().view(torch.int32)
        b = b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def pe_rtol(n_sources: int) -> float:
    """pair_pe_rows' one-thread-a-receiver design against its plain
    version, relative to the row: twice the worst-case rounding of its
    two-level order, 128 terms a tile and one add per tile, plus a few ulp
    for the terms."""
    return 2 * (128 + -(-n_sources // 128) + 4) * 2.0 ** -24


def pe_rtol_tiled(n_i: int, n_j: int) -> float:
    """pair_pe_rows' register-tiled design against its plain version,
    relative to the row: twice the worst-case rounding of its order, 128
    terms a tile, seg tile sums a segment and nseg segment sums a row, the
    m_i multiply, and a few ulp for the terms (csrc/pair_pe_rows.cu)."""
    nseg, seg = hn.pe_segments(n_i, n_j)
    return 2 * (128 + seg + nseg + 5) * 2.0 ** -24


def pe_bound_rtol(n_i: int, n_j: int) -> float:
    """The bound of the design a pair_pe_rows launch runs (pe_design)."""
    if hn.pe_design(n_i, n_j) == "tiled":
        return pe_rtol_tiled(n_i, n_j)
    return pe_rtol(n_j)


class Tally:
    """One kernel's (or one oracle comparison's) cases: failures, the
    worst abs error and error over its bound, the cases holding
    non-finite entries (the same in both), and int components one grid
    step apart."""

    def __init__(self):
        self.cases, self.flips, self.nonfinite, self.failures = 0, 0, 0, []
        self.worst_err, self.worst_ratio = (0.0, ""), (0.0, "")

    def note(self, case: str, ok: bool, err: float, ratio: float,
             what: str) -> bool:
        """Count one comparison; ``what`` describes a failure."""
        self.cases += 1
        if err > self.worst_err[0]:
            self.worst_err = (err, case)
        if ratio > self.worst_ratio[0]:
            self.worst_ratio = (ratio, case)
        if not ok:
            self.failures.append(f"{case}: {what}")
        return ok

    def hold(self, case: str, got, want, scale, q: Quantizer | None = None,
             stage: str = "raw", finite: bool = False) -> bool:
        """``stage`` says what the forces are. "raw": a whole evaluation
        before quantize_force, held to the float rule and in the int modes
        also to the flips rule after quantize_force. "out": a path's
        output, quantized in the int modes (the flips rule there, the
        float rule in the others). "tile": a partial sum, the float rule
        alone. ``q`` None: the float rule alone. ``finite``: every entry
        of ``got`` must be finite."""
        ok, err, ratio, what = True, 0.0, 0.0, ""
        is_int = q is not None and q.is_int
        if stage != "out" or not is_int:
            ok, err, ratio, nonfinite = float_rule(got, want, scale)
            self.nonfinite += nonfinite > 0
            what = (f"max err {err:.3e} ({ratio:.3f} of its bound), "
                    f"{nonfinite} non-finite")
        if is_int and stage != "tile":
            gq, wq = ((got, want) if stage == "out" else
                      (quantize_force(got, q), quantize_force(want, q)))
            fok, off, qerr = flips_rule(gq, wq, q)
            self.flips += off
            ok = ok and fok
            err = qerr if stage == "out" else err
            what += (f"; after quantize_force {off} components off (at "
                     f"most {flips_allowed(wq)}, one step each)")
        if finite and not bool(torch.isfinite(got).all()):
            ok = False
            what += (f"; {int((~torch.isfinite(got)).sum())} non-finite "
                     f"outputs")
        return self.note(case, ok, err, ratio, what)

    def hold_bitwise(self, case: str, got, want, what: str) -> bool:
        ok = bitwise(got, want)
        err = (got.double() - want.double()).abs().max().item() \
            if got.shape == want.shape and got.numel() else 0.0
        return self.note(case, ok, err, 0.0 if ok else math.inf,
                         f"not bit for bit {what}")

    def hold_rel(self, case: str, got, want, rtol, what: str,
                 finite: bool = False) -> bool:
        """|got - want| <= rtol |want| entry by entry (rows of positive
        terms, or a scalar); non-finite entries the same in both, or with
        ``finite`` none at all."""
        fin = torch.isfinite(want)
        same = torch.equal(torch.isfinite(got), fin) and bool(
            (got[~fin] == want[~fin]).all())
        if finite:
            same = same and bool(fin.all())
        err = (got[fin] - want[fin]).abs()
        bound = rtol * want[fin].abs()
        ratios = torch.where(bound > 0, err / bound,
                             torch.where(err > 0, math.inf, 0.0))
        ratio = ratios.max().item() if err.numel() else 0.0
        return self.note(case, same and ratio <= 1.0,
                         err.max().item() if err.numel() else 0.0, ratio,
                         f"{what}: {ratio:.3f} of rtol {rtol:.3e}"
                         + ("" if same else "; non-finite entries"))

    def line(self, name: str) -> str:
        return (f"{name}: {self.cases} cases, {len(self.failures)} failures;"
                f" worst abs err {self.worst_err[0]:.4e} "
                f"({self.worst_err[1]}); worst err/bound "
                f"{self.worst_ratio[0]:.4f} ({self.worst_ratio[1]}); int "
                f"components one grid step apart: {self.flips}; cases "
                f"holding non-finite entries (the same in both): "
                f"{self.nonfinite}")


class Tallies(dict):
    """Tally by name, made on first use."""

    def __missing__(self, key):
        self[key] = Tally()
        return self[key]

    def failures(self) -> list:
        return [f for t in self.values() for f in t.failures]
