"""Kernel lab: variants of the equal-mass sym kernel against production.

Counterpart of ``tools/kernel_lab.py`` (the TPU lab of kernel #1's
equal-mass path), with the same variants and protocol, on the card:

  prod              the general sym_force (every pair loads G m_j, G m_i)
  uniform           the production equal-mass variant (sym_force_uniform)
  uniform+seedsoft  softening seeded into the d^2 chain: (dx^2 + eps^2)
                    + dy^2 (tools/kernel_lab.py:94-98)
  uniform u-wide    u = 2, 3, 4 independent row accumulators per thread,
                    joined in order at the end of the tile: the cross-pair
                    instruction-level parallelism that the TPU kernel's
                    u-wide tile interleave buys (tools/kernel_lab.py:311-314)

The lab variants are entries of ``csrc/sym_force.cu``
(``nbody_sym_force_lab``: D = 2, float32 and the int modes, N a multiple
of TILE), each with a plain PyTorch version here. The round-4 lab's
variants (``R4_VARIANTS``, driven by ``lab/kernel_lab_r4.py``) share the
wrapper, the plain versions and the protocol:

  base2             the int chain on log2 / exp2 with ln 2 folded into its
                    constants (tools/kernel_lab_r4.py:108-122; int modes)
  rt2, rt3          register tiling: 2 or 3 receivers a thread on tiles of
                    128 or 192 (csrc/sym_force_lab.cu)
  wideacc           one pass, the reactions kept in registers and reduced
                    once a tile (csrc/sym_force_lab.cu)
  base2_wideacc     both (int modes)

Protocol (``lab_table``): an N=131072 disk, float32 and int4 (forces
quantized), 10 steps with a data dependency (p += f(p) * 1e-6), wall time
after a synchronise, best of 3 after one warm-up. Int grid bounds come
from the pruned max pass in every row (bitwise the full max pass the TPU
lab takes). Each row prints its largest relative difference against prod
before its time.

    python -m nbody_tpu_torch.lab.kernel_lab [--device cuda] [--n 131072]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import NamedTuple

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Precision, Quantizer
from nbody_tpu_torch.utils.profiler import fence


class LabVariant(NamedTuple):
    """How a lab variant launches: its C entry and variant code there, the
    tile side N must be a multiple of, and whether it takes the base-2 int
    chain (int modes only)."""
    entry: str
    code: int
    side: int
    base2: bool = False


# Lab variant -> nbody_sym_force_lab's variant code.
VARIANTS = {"seedsoft": 1, "wide2": 2, "wide3": 3, "wide4": 4}
# The round-4 lab's variants (tools/kernel_lab_r4.py's knobs A, B, D).
R4_VARIANTS = {
    "base2": LabVariant("nbody_sym_force_lab", 5, hn.TILE, base2=True),
    "wideacc": LabVariant("nbody_sym_force_lab_r4", 1, hn.TILE),
    "base2_wideacc": LabVariant("nbody_sym_force_lab_r4", 2, hn.TILE,
                                base2=True),
    "rt2": LabVariant("nbody_sym_force_lab_r4", 3, 2 * hn.TILE),
    "rt3": LabVariant("nbody_sym_force_lab_r4", 4, 3 * hn.TILE),
}
LAB_VARIANTS = {**{v: LabVariant("nbody_sym_force_lab", c, hn.TILE)
                   for v, c in VARIANTS.items()}, **R4_VARIANTS}
# Launches of each lab variant in this process (reset by whoever reads).
LAUNCHES = {f"sym_force_lab_{v}": 0 for v in LAB_VARIANTS}
MODES = (("float32", False), ("int4", True))   # (mode, quantize_forces)
LOG2E = 1.0 / math.log(2.0)


def _uniform_rows_plain(pos, gm, self_masked: bool, weight,
                        block: int = 1024) -> torch.Tensor:
    """G m_0 sum_j w_ij (x_j - x_i), D = 2, with w = weight(dx, dy),
    row-blocked."""
    ids = torch.arange(pos.shape[0], device=pos.device)
    out = torch.empty_like(pos)
    for r0 in range(0, pos.shape[0], block):
        pi = pos[r0:r0 + block]
        dx = pos[None, :, 0] - pi[:, 0, None]
        dy = pos[None, :, 1] - pi[:, 1, None]
        w = weight(dx, dy)
        if self_masked:
            w = torch.where(ids[r0:r0 + block, None] == ids[None, :], 0.0, w)
        out[r0:r0 + block] = torch.stack([(w * dx).sum(dim=1),
                                          (w * dy).sum(dim=1)], dim=1)
    return out * gm[0]


def _seedsoft_plain(pos, gm, bounds, q: Quantizer,
                    self_masked: bool) -> torch.Tensor:
    """G m_0 sum_j w_ij (x_j - x_i) with w of (dx^2 + eps^2) + dy^2."""
    grid = hn._int_grid(bounds, q) if q.is_int else None
    return _uniform_rows_plain(pos, gm, self_masked, lambda dx, dy:
                               hn._pair_weight((dx * dx + bounds[2])
                                               + dy * dy, q, grid))


def base2_grid(bounds: torch.Tensor, q: Quantizer) -> tuple:
    """hn._int_grid with the base-2 folds, as csrc/nbody_common.cuh's
    mode_grid takes them (tools/kernel_lab_r4.py:108-116): norm_a times
    f32(ln 2), arg_k and arg_0 times f32(log2 e), one rounding each; the
    cap folded in double, then rounded once."""
    norm_a, norm_b, arg_k, arg_0, _ = hn._int_grid(bounds, q)
    ln2, log2e = (torch.tensor(c, dtype=torch.float32, device=bounds.device)
                  for c in (math.log(2.0), LOG2E))
    cap = torch.full((), hn._arg_cap(q) * LOG2E, dtype=torch.float32,
                     device=bounds.device)
    return norm_a * ln2, norm_b, arg_k * log2e, arg_0 * log2e, cap


def base2_bins(d2: torch.Tensor, q: Quantizer, grid) -> torch.Tensor:
    """The base-2 chain's bin index k of softened d^2."""
    norm_a2, norm_b = grid[:2]
    return torch.round(torch.log2(torch.clamp(d2, min=q.min_dist_sq))
                       * norm_a2 + norm_b)


def base2_weight(d2: torch.Tensor, q: Quantizer, grid) -> torch.Tensor:
    """w of softened d^2 on the base-2 chain: exp2(min(k arg_k2 + arg_02,
    cap2))."""
    _, _, arg_k2, arg_02, cap2 = grid
    return torch.exp2(torch.minimum(base2_bins(d2, q, grid) * arg_k2
                                    + arg_02, cap2))


def _base2_plain(pos, gm, bounds, q: Quantizer,
                 self_masked: bool) -> torch.Tensor:
    """G m_0 sum_j w_ij (x_j - x_i) with w on the base-2 chain."""
    grid = base2_grid(bounds, q)
    return _uniform_rows_plain(pos, gm, self_masked, lambda dx, dy:
                               base2_weight((dx * dx + dy * dy) + bounds[2],
                                            q, grid))


def sym_force_lab_plain(pos, gm, bounds, q: Quantizer, self_masked: bool,
                        variant: str) -> torch.Tensor:
    """Plain PyTorch version of a lab variant: the seeded d^2 chain, the
    base-2 chain, or for the u-wide, register-tiled and one-pass variants
    sym_force_uniform_plain (the same function in another summation
    order)."""
    if variant == "seedsoft":
        return _seedsoft_plain(pos, gm, bounds, q, self_masked)
    if LAB_VARIANTS[variant].base2:
        return _base2_plain(pos, gm, bounds, q, self_masked)
    return hn.sym_force_uniform_plain(pos, gm, bounds, q, self_masked)


def sym_force_lab(pos, gm, bounds, q: Quantizer, self_masked: bool,
                  variant: str) -> torch.Tensor:
    """A lab variant's wrapper: its C entry (csrc/sym_force.cu's
    nbody_sym_force_lab or csrc/sym_force_lab.cu's nbody_sym_force_lab_r4)
    for a CUDA tensor, sym_force_lab_plain for a CPU tensor. Equal masses
    (scaled by gm[0]), D = 2, N a multiple of the variant's tile side,
    float32 or an int mode (the base-2 variants an int mode); ValueError
    otherwise."""
    n, dim = hn._check_force_args(pos, gm, bounds)
    if variant not in LAB_VARIANTS:
        raise ValueError(f"unknown lab variant {variant}; valid: "
                         f"{tuple(LAB_VARIANTS)}")
    spec = LAB_VARIANTS[variant]
    modes = "an int mode" if spec.base2 else "float32 or an int mode"
    if dim != 2 or n % spec.side or not (
            q.is_int or (q.mode == Precision.FLOAT32 and not spec.base2)):
        raise ValueError(f"the lab variant {variant} takes D=2, N a multiple "
                         f"of {spec.side}, {modes}; got D={dim}, N={n}, "
                         f"{q.mode.value}")
    if pos.device.type == "cpu":
        return sym_force_lab_plain(pos, gm, bounds, q, self_masked, variant)
    lib = hn._library()
    tiles = n // spec.side
    mode, levels, arg_cap, min_d2 = hn._int_args(q)
    if spec.base2:
        arg_cap *= LOG2E   # folded in double, as base2_grid folds it
    with torch.cuda.device(pos.device):
        part = torch.empty((tiles, tiles, spec.side, 2), dtype=torch.float32,
                           device=pos.device)
        out = torch.empty_like(pos)
        rc = getattr(lib, spec.entry)(
            hn._ptr(pos), hn._ptr(gm), hn._ptr(bounds), n, mode, levels,
            arg_cap, min_d2, int(self_masked), spec.code, hn._ptr(part),
            hn._ptr(out), hn._stream(pos.device))
    hn._raise_on(rc, f"sym_force_lab_{variant}")
    LAUNCHES[f"sym_force_lab_{variant}"] += 1
    return out


def lab_accelerations(positions, masses, q: Quantizer, cfg: SimConfig,
                      variant: str, quantize_forces: bool = True):
    """The equal-mass accelerations through a lab variant: the lab's
    counterpart of sym_accelerations(..., uniform_gm=True)."""
    pos, gm = hn._prepare(positions, masses, cfg)
    bounds = hn.kernel_bounds(pos, q, cfg)
    acc = sym_force_lab(pos, gm, bounds, q, hn._self_masked(cfg, None),
                        variant)
    return hn._finish(acc, q, quantize_forces)


def measure(fn, pos0: torch.Tensor, steps: int) -> float:
    """ms per step of ``steps`` steps p += fn(p) * 1e-6, wall time after a
    synchronise, best of 3 after one warm-up."""
    def scan(p):
        for _ in range(steps):
            p = p + fn(p) * 1e-6
        return fence(p)

    scan(pos0)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        scan(pos0)
        best = min(best, time.perf_counter() - t0)
    return best / steps * 1e3


def lab_table(device, n: int, steps: int, seed: int, rows_of,
              tag: str = "lab") -> list:
    """The lab protocol on an N=n disk: for float32 and int4, prod (the
    general sym_force), uniform (sym_force_uniform) and the rows
    ``rows_of(q)`` gives ({label: lab variant}); each row prints its
    largest relative difference against prod, then its ms a step and
    pairs/s. Returns one dict a row: {"mode", "variant", "rel_vs_prod",
    "ms", "pairs_per_s"}."""
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy
    cfg = SimConfig()
    pos, _, m = create_disk_galaxy(torch.Generator().manual_seed(seed),
                                   num_stars=n, device=device)
    print(f"{tag}: N={n} disk, {steps} steps with p += f(p) * 1e-6, best of "
          f"3, on {device}")
    # The masses are checked once here, so no timed row reads them on the
    # host (the lab variants never do).
    hn.check_uniform_gm(m)
    sym = hn.prevalidated(hn.sym_accelerations)
    rows = []
    for mode, qf in MODES:
        q = Quantizer.from_string(mode)
        fns = {
            "prod": lambda p: sym(p, m, q, cfg, quantize_forces=qf),
            "uniform": lambda p: sym(p, m, q, cfg, quantize_forces=qf,
                                     uniform_gm=True)}
        for label, v in rows_of(q).items():
            fns[label] = (lambda p, v=v: lab_accelerations(
                p, m, q, cfg, v, quantize_forces=qf))
        prod = fns["prod"](pos)
        scale = prod.abs().max()
        for label, fn in fns.items():
            rel = float((fn(pos) - prod).abs().max() / scale)
            print(f"{tag}: [{mode}] {label}-vs-prod max rel delta: {rel:.3e}")
            ms = measure(fn, pos, steps)
            rows.append({"mode": mode, "variant": label, "rel_vs_prod": rel,
                         "ms": ms, "pairs_per_s": n * n / (ms * 1e-3)})
            print(f"{tag}: {mode} {label}: {ms:.3f} ms/step  "
                  f"{rows[-1]['pairs_per_s']:.4e} pairs/s")
    return rows


def run(device, n: int = 131072, steps: int = 10, seed: int = 42) -> list:
    """The lab's table (lab_table): prod, uniform, seed-soft and the u-wide
    variants."""
    labels = {("uniform+seedsoft" if v == "seedsoft"
               else f"uniform {v[-1]}-wide"): v for v in VARIANTS}
    return lab_table(device, n, steps, seed, lambda q: labels)


def main(argv=None) -> list:
    from nbody_tpu_torch.cli import _resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=131072,
                    help="stars (a multiple of 64; default 131072)")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps per timed run (default 10)")
    ap.add_argument("--seed", type=int, default=42, help="torch RNG seed")
    args = ap.parse_args(argv)
    return run(_resolve_device(args.device), args.n, args.steps, args.seed)


if __name__ == "__main__":
    main()
