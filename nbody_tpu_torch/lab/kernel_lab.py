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
of TILE), each with a plain PyTorch version here. Protocol: an N=131072
disk, float32 and int4 (forces quantized), 10 steps with a data dependency
(p += f(p) * 1e-6), wall time after a synchronise, best of 3 after one
warm-up. Int grid bounds come from the pruned max pass in every row
(bitwise the full max pass the TPU lab takes). The largest relative
difference of each variant against prod is printed first.

    python -m nbody_tpu_torch.lab.kernel_lab [--device cuda] [--n 131072]
"""

from __future__ import annotations

import argparse
import time

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Precision, Quantizer
from nbody_tpu_torch.utils.profiler import fence

# Lab variant -> nbody_sym_force_lab's variant code.
VARIANTS = {"seedsoft": 1, "wide2": 2, "wide3": 3, "wide4": 4}
# Launches of each lab variant in this process (reset by whoever reads).
LAUNCHES = {f"sym_force_lab_{v}": 0 for v in VARIANTS}
MODES = (("float32", False), ("int4", True))   # (mode, quantize_forces)


def _seedsoft_plain(pos, gm, bounds, q: Quantizer, self_masked: bool,
                    block: int = 1024) -> torch.Tensor:
    """G m_0 sum_j w_ij (x_j - x_i) with w of (dx^2 + eps^2) + dy^2."""
    grid = hn._int_grid(bounds, q) if q.is_int else None
    ids = torch.arange(pos.shape[0], device=pos.device)
    out = torch.empty_like(pos)
    for r0 in range(0, pos.shape[0], block):
        pi = pos[r0:r0 + block]
        dx = pos[None, :, 0] - pi[:, 0, None]
        dy = pos[None, :, 1] - pi[:, 1, None]
        w = hn._pair_weight((dx * dx + bounds[2]) + dy * dy, q, grid)
        if self_masked:
            w = torch.where(ids[r0:r0 + block, None] == ids[None, :], 0.0, w)
        out[r0:r0 + block] = torch.stack([(w * dx).sum(dim=1),
                                          (w * dy).sum(dim=1)], dim=1)
    return out * gm[0]


def sym_force_lab_plain(pos, gm, bounds, q: Quantizer, self_masked: bool,
                        variant: str) -> torch.Tensor:
    """Plain PyTorch version of a lab variant: the seeded d^2 chain, or
    for the u-wide variants sym_force_uniform_plain (the same function in
    another summation order)."""
    if variant == "seedsoft":
        return _seedsoft_plain(pos, gm, bounds, q, self_masked)
    return hn.sym_force_uniform_plain(pos, gm, bounds, q, self_masked)


def sym_force_lab(pos, gm, bounds, q: Quantizer, self_masked: bool,
                  variant: str) -> torch.Tensor:
    """A lab variant's wrapper: csrc/sym_force.cu's nbody_sym_force_lab for
    a CUDA tensor, sym_force_lab_plain for a CPU tensor. Equal masses
    (scaled by gm[0]), D = 2, N a multiple of TILE, float32 or an int
    mode; ValueError otherwise."""
    n, dim = hn._check_force_args(pos, gm, bounds)
    if variant not in VARIANTS:
        raise ValueError(f"unknown lab variant {variant}; valid: "
                         f"{tuple(VARIANTS)}")
    if dim != 2 or n % hn.TILE or not (q.is_int
                                       or q.mode == Precision.FLOAT32):
        raise ValueError(f"the lab variants take D=2, N a multiple of "
                         f"{hn.TILE}, float32 or an int mode; got D={dim}, "
                         f"N={n}, {q.mode.value}")
    if pos.device.type == "cpu":
        return sym_force_lab_plain(pos, gm, bounds, q, self_masked, variant)
    lib = hn._library()
    tiles = n // hn.TILE
    with torch.cuda.device(pos.device):
        part = torch.empty((tiles, tiles, hn.TILE, 2), dtype=torch.float32,
                           device=pos.device)
        out = torch.empty_like(pos)
        rc = lib.nbody_sym_force_lab(
            hn._ptr(pos), hn._ptr(gm), hn._ptr(bounds), n,
            *hn._int_args(q), int(self_masked), VARIANTS[variant],
            hn._ptr(part), hn._ptr(out), hn._stream(pos.device))
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


def run(device, n: int = 131072, steps: int = 10, seed: int = 42) -> list:
    """The lab's table: one row per (mode, variant), printed as it goes;
    each row {"mode", "variant", "rel_vs_prod", "ms", "pairs_per_s"}."""
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy
    cfg = SimConfig()
    pos, _, m = create_disk_galaxy(torch.Generator().manual_seed(seed),
                                   num_stars=n, device=device)
    print(f"lab: N={n} disk, {steps} steps with p += f(p) * 1e-6, best of "
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
        for v in VARIANTS:
            label = "uniform+seedsoft" if v == "seedsoft" else \
                f"uniform {v[-1]}-wide"
            fns[label] = (lambda p, v=v: lab_accelerations(
                p, m, q, cfg, v, quantize_forces=qf))
        prod = fns["prod"](pos)
        scale = prod.abs().max()
        for label, fn in fns.items():
            rel = float((fn(pos) - prod).abs().max() / scale)
            print(f"lab: [{mode}] {label}-vs-prod max rel delta: {rel:.3e}")
            rows.append({"mode": mode, "variant": label, "rel_vs_prod": rel})
        for row in rows[-len(fns):]:
            ms = measure(fns[row["variant"]], pos, steps)
            row.update(ms=ms, pairs_per_s=n * n / (ms * 1e-3))
            print(f"lab: {mode} {row['variant']}: {ms:.3f} ms/step  "
                  f"{row['pairs_per_s']:.4e} pairs/s")
    return rows


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
