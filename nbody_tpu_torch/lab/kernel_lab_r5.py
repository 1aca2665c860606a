"""Kernel lab round 5: the sym kernel's sums on tensor cores, and d^2 forms.

Counterpart of ``tools/kernel_lab_r5.py`` (the TPU lab that asked whether
the matrix units can take a share of the sym kernel), with its two
measured parts:

A. The accuracy study (``accuracy_study``, plain torch on any device):
   subtract-form d^2, the naive dot-form |x_i|^2 + |x_j|^2 - 2 x_i.x_j,
   and the Dekker-compensated dot-form, each against a float64 oracle on
   the production disk and on a tight cluster at offset 200, where the
   dot forms cancel. Each form mirrors its JAX twin's operation order.

C. The accumulation offload (``sym_force_mxu``, ``csrc/sym_force_mxu.cu``):
   subtract-form d^2 and w = rsqrt(d^2 + eps^2)^3 on the FP32 cores, the
   sums Sigma_j w_ij [x_j | 1] (rows) and Sigma_i w_ij [x_i | 1] (columns)
   as bf16 tensor-core products, then acc = row_d - x_d row_D. The three
   ``precision`` values are XLA's dot precisions, as bf16 passes over the
   operands' planes a = a0 + a1 + a2 (a_k = bf16_rn of what is left):
   ``default`` a0 b0; ``high`` adds a0 b1 + a1 b0; ``highest`` adds
   a0 b2 + a1 b1 + a2 b0. f32, equal masses (one G m scalar), D in {2, 3},
   N a multiple of ``TILE``, softening > 0.

The function cancels: every pair enters as w x_j - x_i w, the self-pair
(w_ii = eps^-3) included. Its rounding scales with the summed |terms|
s_i = G m sum_j w_ij (|x_j| + |x_i|) per coordinate (``mxu_term_scale``),
not with |a|; every tolerance on it uses s.

Lab table (``run``, the protocol of ``kernel_lab.measure``): an N=129024
disk (seed 42) in float32, 10 steps with p += f(p) * 1e-6, wall time after
a synchronise, best of 3 after one warm-up. Rows in tools/kernel_lab_r5.py
main()'s order: prod (the general sym_force), uniform (sym_force_uniform),
then ``C: mxu-accum dot=HIGHEST``, ``HIGH`` and ``DEFAULT``; each prints
its largest relative difference against prod, then its ms a step and
pairs/s.

    python -m nbody_tpu_torch.lab.kernel_lab_r5 [--device cuda] [--n 129024]
        [--steps 10]
"""

from __future__ import annotations

import argparse

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.lab import kernel_lab
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Quantizer

N = 129024
TILE = hn.TILE   # TS of csrc/sym_force_mxu.cu: N must be a multiple of it
# bf16 passes (plane of w, plane of [x | 1]) of each dot precision, in the
# order the kernel accumulates them.
PASSES = {
    "default": ((0, 0),),
    "high": ((0, 0), (0, 1), (1, 0)),
    "highest": ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)),
}
PRECISION_CODES = {p: k for k, p in enumerate(PASSES)}
# Receivers a block of the plain versions: w of a block is BLOCK x N f32,
# 0.53 GB a plane at N=129024.
BLOCK = 1024
# Launches of each precision's kernel in this process (reset by whoever
# reads them).
LAUNCHES = {f"sym_force_mxu_{p}": 0 for p in PASSES}
F32 = Quantizer.from_string("float32")


# --------------------------------------------------------------------------
# A. The d^2 forms and the accuracy study
# --------------------------------------------------------------------------

def _dekker_split(x):
    """x = hi + lo with hi carrying the top 12 significand bits, so
    products of two hi parts are exact in f32 (24-bit significand)."""
    c = torch.tensor((1 << 12) + 1, dtype=torch.float32, device=x.device) * x
    hi = c - (c - x)
    return hi, x - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def d2_subtract(p):
    diff = p[None, :, :] - p[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def _mm(a, b):
    """True-f32 matmul: the compensated scheme's split products are only
    exact if the product itself is f32. On the card a TF32 product would
    round the 12-bit heads to 10 bits and void the compensation, so
    accuracy_study sets ``torch.backends.cuda.matmul.allow_tf32 = False``
    and this checks it."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the d^2 study needs true-f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    return torch.matmul(a, b)


def d2_dot_naive(p):
    s = torch.sum(p * p, dim=1)
    return s[:, None] + s[None, :] - 2.0 * _mm(p, p.T)


def d2_dot_compensated(p):
    """f32x2 dot-form: exact split products, TwoSum-combined."""
    hi, lo = _dekker_split(p)
    hh = _mm(hi, hi.T)      # exact per-element products (12+12 bits)
    hl = _mm(hi, lo.T) + _mm(lo, hi.T)
    ll = _mm(lo, lo.T)
    # |x|^2 per particle in f32x2
    sh, sl = _two_sum(torch.sum(hi * hi, dim=1),
                      2.0 * torch.sum(hi * lo, dim=1))
    sl = sl + torch.sum(lo * lo, dim=1)
    # d^2 = (s_i + s_j) - 2(hh + hl + ll), combined hi/lo-first
    a, ae = _two_sum(sh[:, None], sh[None, :])
    b, be = _two_sum(a, -2.0 * hh)
    corr = ae + be + sl[:, None] + sl[None, :] - 2.0 * (hl + ll)
    return b + corr


GEOMETRIES = (("production disk", 10.0, 0.0),
              ("adversarial: tight cluster at 200", 0.5, 200.0))
FORMS = (("subtract-form", d2_subtract), ("dot-form naive", d2_dot_naive),
         ("dot-form compensated", d2_dot_compensated))


def accuracy_study(device="cpu",
                   generator: torch.Generator | None = None) -> dict:
    """Max abs error of each d^2 form against a float64 oracle (diagonal
    excluded) on both geometries: 2048 x 2 normals drawn once on the CPU from
    ``generator`` (seeded 0 when None), scaled and offset per geometry in
    f32, then moved to ``device``. Prints one line a form and returns
    {geometry: {form: max abs err}}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    z = torch.randn((2048, 2), generator=gen, dtype=torch.float32)
    results = {}
    for name, scale, offset in GEOMETRIES:
        p = (z * scale + offset).to(torch.float32).to(device)
        p64 = p.to(torch.float64)
        diff = p64[None] - p64[:, None]
        oracle = (diff ** 2).sum(-1)
        oracle.fill_diagonal_(float("inf"))   # self-pairs: not meaningful
        finite = torch.isfinite(oracle)
        errs = {}
        for label, fn in FORMS:
            got = fn(p).to(torch.float64)
            got.fill_diagonal_(float("inf"))
            abs_err = float((got[finite] - oracle[finite]).abs().max())
            errs[label] = abs_err
            print(f"A [{name}] {label}: max abs err {abs_err:.3e} "
                  f"(softening floor 1e-2; int4 bin edges move at "
                  f"~1e-7·d²)", flush=True)
        results[name] = errs
    return results


# --------------------------------------------------------------------------
# C. The accumulation offload: plain version, wrapper, entry point
# --------------------------------------------------------------------------

def bf16_planes(a: torch.Tensor, k: int) -> list:
    """a's first k bf16 planes, each as f32: a0 = bf16_rn(a), a1 =
    bf16_rn(a - a0), a2 = bf16_rn(a - a0 - a1). The subtracts are exact
    in f32, so a0 + a1 + a2 == a for normal f32 values."""
    planes, rest = [], a
    for _ in range(k):
        planes.append(rest.to(torch.bfloat16).to(torch.float32))
        rest = rest - planes[-1]
    return planes


def _planes_of(precision: str) -> int:
    return 1 + max(max(p) for p in PASSES[precision])


def _weights(pi: torch.Tensor, pos: torch.Tensor, softening_sq: float):
    """w_ij = rsqrt(d^2 + eps^2)^3 of receivers pi against every source,
    subtract-form d^2, as the production plain version computes it."""
    return hn._diffs_w(pi, pos, hn._scalar(softening_sq, pos.device), F32,
                       None)[1]


def sym_force_mxu_plain(pos: torch.Tensor, gm: torch.Tensor,
                        softening_sq: float, precision: str) -> torch.Tensor:
    """Plain PyTorch version of the sym_force_mxu kernel: for blocks of
    BLOCK receivers against all N sources, w in f32, its bf16 planes
    and those of [x | 1], row = the precision's passes as f32 products of
    the planes, acc = row_d - x_d row_D; then times gm. Every pair goes
    through the row product, both directions and the self-pair included:
    the kernel's function (rows and columns) in another rounding order."""
    n, dim = pos.shape
    k = _planes_of(precision)
    ext = torch.cat([pos, torch.ones((n, 1), dtype=pos.dtype,
                                     device=pos.device)], dim=1)
    xp = bf16_planes(ext, k)
    out = torch.empty_like(pos)
    for r0 in range(0, n, BLOCK):
        pi = pos[r0:r0 + BLOCK]
        wp = bf16_planes(_weights(pi, pos, softening_sq), k)
        row = None
        for a, b in PASSES[precision]:
            prod = torch.matmul(wp[a], xp[b])
            row = prod if row is None else row + prod
        out[r0:r0 + BLOCK] = row[:, :dim] - pi * row[:, dim:]
    return out * gm


def mxu_term_scale(pos: torch.Tensor, gm: torch.Tensor,
                   softening_sq: float) -> torch.Tensor:
    """s_i,d = gm sum_j w_ij (|x_j,d| + |x_i,d|), the self-pair included:
    the summed |terms| of sym_force_mxu's function, the scale of any
    rounding of it (row_d and x_d row_D cancel down to |a|)."""
    out = torch.empty_like(pos)
    for r0 in range(0, pos.shape[0], BLOCK):
        pi = pos[r0:r0 + BLOCK]
        w = _weights(pi, pos, softening_sq)
        out[r0:r0 + BLOCK] = (torch.matmul(w, pos.abs())
                              + pi.abs() * w.sum(dim=1, keepdim=True))
    return out * gm


def _check_mxu_args(pos: torch.Tensor, gm: torch.Tensor, softening_sq,
                    precision: str) -> tuple:
    if precision not in PASSES:
        raise ValueError(f"unknown precision {precision!r}; valid: "
                         f"{tuple(PASSES)}")
    if pos.dim() != 2 or pos.shape[1] not in (2, 3):
        raise ValueError(f"sym_force_mxu takes positions (N, 2) or (N, 3), "
                         f"got {tuple(pos.shape)}")
    n = pos.shape[0]
    if pos.dtype != torch.float32 or n < TILE or n % TILE:
        raise ValueError(f"sym_force_mxu takes float32 positions with N a "
                         f"multiple of {TILE}; got {pos.dtype}, N={n}")
    if not pos.is_contiguous() or pos.device.type not in ("cpu", "cuda"):
        raise ValueError("positions must be contiguous, on the CPU or a "
                         "CUDA device")
    if (gm.dtype != torch.float32 or gm.numel() != 1
            or gm.device != pos.device):
        raise ValueError(f"gm must be one float32 value on {pos.device}")
    if not float(softening_sq) > 0.0:
        raise ValueError(f"sym_force_mxu needs softening > 0 (the self-pair "
                         f"is in the sums), got eps^2={softening_sq}")
    return n, pos.shape[1]


def sym_force_mxu(pos: torch.Tensor, gm: torch.Tensor, softening_sq: float,
                  precision: str) -> torch.Tensor:
    """The accumulation-offload kernel's wrapper: csrc/sym_force_mxu.cu's
    ``nbody_sym_force_mxu`` for a CUDA tensor, sym_force_mxu_plain for a
    CPU tensor. pos (N, D) f32, gm one f32 value (G m, read on the device),
    eps^2 > 0 on the host; ValueError on anything else. Returns (N, D) f32
    accelerations."""
    n, dim = _check_mxu_args(pos, gm, softening_sq, precision)
    gm = gm.reshape(())
    if pos.device.type == "cpu":
        return sym_force_mxu_plain(pos, gm, softening_sq, precision)
    lib = hn._library()
    tiles = n // TILE
    with torch.cuda.device(pos.device):
        part = torch.empty((tiles, tiles, TILE, dim), dtype=torch.float32,
                           device=pos.device)
        out = torch.empty_like(pos)
        rc = lib.nbody_sym_force_mxu(
            hn._ptr(pos), hn._ptr(gm), n, dim, float(softening_sq),
            PRECISION_CODES[precision], hn._ptr(part), hn._ptr(out),
            hn._stream(pos.device))
    hn._raise_on(rc, f"sym_force_mxu_{precision}")
    LAUNCHES[f"sym_force_mxu_{precision}"] += 1
    return out


def accelerations_mxu(positions: torch.Tensor, gm, cfg: SimConfig,
                      precision: str = "highest") -> torch.Tensor:
    """Counterpart of tools/kernel_lab_r5.py's ``accelerations_mxu``:
    f32 accelerations with one G m (a float or a one-value tensor) and
    cfg's softening, through sym_force_mxu."""
    pos = positions.to(torch.float32).contiguous()
    gm = hn._scalar(gm, pos.device)
    return sym_force_mxu(pos, gm, cfg.softening_sq, precision)


# (label, precision) after prod and uniform, in tools/kernel_lab_r5.py
# main()'s order.
ROWS = tuple((f"C: mxu-accum dot={p.upper()}", p)
             for p in ("highest", "high", "default"))


def run(device, n: int = N, steps: int = 10, seed: int = 42) -> dict:
    """The round-5 lab: the accuracy study, then the table on an N=n disk
    in float32. Returns {"study": accuracy_study's result, "rows": one dict
    a row, {"mode", "variant", "rel_vs_prod", "ms", "pairs_per_s"}}."""
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy
    print(f"lab_r5: device={device} N={n}", flush=True)
    study = accuracy_study(device)
    cfg, q = SimConfig(), F32
    pos, _, m = create_disk_galaxy(torch.Generator().manual_seed(seed),
                                   num_stars=n, device=device)
    print(f"lab_r5: N={n} disk, {steps} steps with p += f(p) * 1e-6, best "
          f"of 3, on {device}")
    hn.check_uniform_gm(m)
    sym = hn.prevalidated(hn.sym_accelerations)
    gm = (cfg.G * m[:1]).reshape(())
    fns = {"prod": lambda p: sym(p, m, q, cfg, quantize_forces=False),
           "uniform": lambda p: sym(p, m, q, cfg, quantize_forces=False,
                                    uniform_gm=True)}
    for label, prec in ROWS:
        fns[label] = (lambda p, prec=prec:
                      accelerations_mxu(p, gm, cfg, precision=prec))
    prod = fns["prod"](pos)
    scale = prod.abs().max()
    rows = []
    for label, fn in fns.items():
        rel = float((fn(pos) - prod).abs().max() / scale)
        print(f"lab_r5: [float32] {label}-vs-prod max rel delta: {rel:.3e}")
        ms = kernel_lab.measure(fn, pos, steps)
        rows.append({"mode": "float32", "variant": label, "rel_vs_prod": rel,
                     "ms": ms, "pairs_per_s": n * n / (ms * 1e-3)})
        print(f"lab_r5: float32 {label}: {ms:.3f} ms/step  "
              f"{rows[-1]['pairs_per_s']:.4e} pairs/s")
    return {"study": study, "rows": rows}


def main(argv=None) -> dict:
    from nbody_tpu_torch.cli import _resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=N,
                    help=f"stars (a multiple of {TILE}; default {N})")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps per timed run (default 10)")
    ap.add_argument("--seed", type=int, default=42, help="torch RNG seed")
    args = ap.parse_args(argv)
    return run(_resolve_device(args.device), args.n, args.steps, args.seed)


if __name__ == "__main__":
    main()
