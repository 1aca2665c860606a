"""The plain reference of the direct N-body step: softened all-pairs
gravity with the precision ladder's int-sim log grid, kick-drift-kick
leapfrog, and the energies, in plain PyTorch.

It imports nothing of the program and takes nothing the program derived:
it works out the grid bounds, the forces and the energies again from the
positions, velocities and masses it is handed. Every pass is blocked over
receivers and sources so that it fits beside the card's other memory.

Semantics (the upstream project's simulation.py and quantization.py):
    d2[i, j] = |x_j - x_i|^2 + eps^2
    int modes: d2 -> exp(round((log max(d2, min_d2) - lo) / span (L-1))
               / (L-1) span + lo), at least min_d2, with lo = log
               max(eps^2, min_d2), hi = log max(max d2, that), span = hi - lo
    acc[i]   = G sum_j m_j (x_j - x_i) d2q^(-3/2)
    int4 / int8: acc -> linear L-level grid over the global min and max of
               every component
    U        = -G sum_{i<j} m_i m_j / sqrt(|x_i - x_j|^2 + eps^2)
    K        = 1/2 sum_i m_i |v_i|^2
"""

from __future__ import annotations

import math

import torch

# Elements of one (receivers x sources) temporary.
BLOCK_ELEMENTS = 1 << 27

LEVELS = {"int8": 256, "int4": 16}


def _blocks(n_rows: int, n_src: int) -> tuple:
    """(receivers, sources) a block, so that one temporary stays within
    BLOCK_ELEMENTS."""
    src = min(n_src, BLOCK_ELEMENTS // 64)
    rows = max(1, min(n_rows, BLOCK_ELEMENTS // src))
    return rows, src


def _d2_f64(xi: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """|x_i - x_j|^2 in float64 by |x_i|^2 + |x_j|^2 - 2 x_i.x_j (one
    float64 matrix product, no TF32 in float64): for |x| up to 1e3 its
    rounding is ~1e-10 absolute, far under float32's own."""
    a = (xi * xi).sum(dim=1)
    b = (xs * xs).sum(dim=1)
    return torch.addmm(b[None, :], xi, xs.T, alpha=-2.0).add_(a[:, None])


def max_pair_d2(pos: torch.Tensor) -> float:
    """The max of |x_i - x_j|^2 over all pairs, in float64."""
    x = pos.to(torch.float64)
    n = x.shape[0]
    rows, src = _blocks(n, n)
    best = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, n, rows):
        for s0 in range(r0, n, src):
            best = torch.maximum(
                best, _d2_f64(x[r0:r0 + rows], x[s0:s0 + src]).max())
    return float(best)


def log_grid(pos: torch.Tensor, eps2: float, min_d2: float) -> tuple:
    """(lo, hi) of the int-sim log grid over these positions."""
    floor = max(eps2, min_d2)
    lo = math.log(floor)
    hi = math.log(max(max_pair_d2(pos) + eps2, floor))
    return lo, hi


def _weight(d2: torch.Tensor, grid) -> torch.Tensor:
    """d2q^(-3/2), d2q the int-sim grid's value of d2 (grid = (levels,
    min_d2, lo, hi)), or d2 itself (grid None)."""
    if grid is not None:
        levels, min_d2, lo, hi = grid
        span = hi - lo
        x = torch.clamp(d2, min=min_d2)
        if span >= 1e-10:
            k = torch.round((torch.log(x) - lo) * ((levels - 1) / span))
            x = torch.clamp(torch.exp(k * (span / (levels - 1)) + lo),
                            min=min_d2)
        d2 = x
    inv = torch.rsqrt(d2)
    return inv * inv * inv


def accelerations(pos: torch.Tensor, gm: torch.Tensor, rows: torch.Tensor,
                  eps2: float, grid=None, dtype=torch.float64,
                  want_scale: bool = False) -> tuple:
    """Accelerations of receivers ``rows`` due to every source, before any
    force quantization, and (``want_scale``) each component's sum of
    absolute terms sum_j |G m_j (x_j - x_i) w_ij|: (acc, scale or None),
    (len(rows), D) in ``dtype``. ``gm`` is G m a source."""
    x = pos.to(dtype)
    g = gm.to(dtype)
    recv = x.index_select(0, rows)
    n, dim = x.shape
    r_blk, s_blk = _blocks(recv.shape[0], n)
    acc = torch.zeros_like(recv)
    scale = torch.zeros_like(recv) if want_scale else None
    for r0 in range(0, recv.shape[0], r_blk):
        xi = recv[r0:r0 + r_blk]
        for s0 in range(0, n, s_blk):
            xs, gs = x[s0:s0 + s_blk], g[s0:s0 + s_blk]
            diffs = [xs[None, :, d] - xi[:, d, None] for d in range(dim)]
            d2 = torch.full_like(diffs[0], eps2)
            for t in diffs:
                d2.addcmul_(t, t)
            w = _weight(d2, grid).mul_(gs[None, :])
            for d, t in enumerate(diffs):
                term = t.mul_(w)
                acc[r0:r0 + r_blk, d] += term.sum(dim=1)
                if want_scale:
                    scale[r0:r0 + r_blk, d] += term.abs_().sum(dim=1)
    return acc, scale


def quantize_force(acc: torch.Tensor, levels: int) -> tuple:
    """The linear ``levels``-point grid over acc's global min and max:
    (snapped acc, the grid's step)."""
    lo, hi = acc.min(), acc.max()
    span = hi - lo
    if float(span) < 1e-10:
        return acc, 0.0
    k = torch.round((acc - lo) / span * (levels - 1))
    return k / (levels - 1) * span + lo, float(span) / (levels - 1)


def _pair_inverse(xi: torch.Tensor, xs: torch.Tensor, eps2: float,
                  dtype) -> torch.Tensor:
    """1 / sqrt(|x_i - x_j|^2 + eps^2), (len(xi), len(xs)) in ``dtype``:
    in float64 from _d2_f64, below it op by op in ``dtype``."""
    if dtype == torch.float64:
        return _d2_f64(xi, xs).add_(eps2).rsqrt_()
    d2 = torch.zeros((xi.shape[0], xs.shape[0]), dtype=dtype,
                     device=xi.device)
    for d in range(xi.shape[1]):
        t = xs[None, :, d] - xi[:, d, None]
        d2.addcmul_(t, t)
    return d2.add_(eps2).rsqrt_()


def potential(pos: torch.Tensor, m: torch.Tensor, G: float, eps2: float,
              dtype=torch.float64) -> float:
    """U: pair terms in ``dtype``, each block's sum in float64 (or in
    ``dtype`` where it is below float32), every unordered pair once: a
    receiver block against the sources after it, and its own square's
    upper triangle."""
    x = pos.to(dtype).contiguous()
    mm = m.to(dtype)
    uniform = bool((m == m[0]).all())
    acc_dtype = torch.float64 if dtype in (torch.float32, torch.float64) \
        else dtype
    n = x.shape[0]
    rows, src = _blocks(n, n)
    rows = min(rows, src)
    total = torch.zeros((), dtype=acc_dtype, device=x.device)

    def block(r0, r1, s0, s1, upper):
        w = _pair_inverse(x[r0:r1], x[s0:s1], eps2, dtype)
        if upper:
            w = torch.triu(w, diagonal=1)
        if uniform:
            return w.sum(dtype=acc_dtype)
        return (w * mm[r0:r1, None] * mm[None, s0:s1]).sum(dtype=acc_dtype)

    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        total = total + block(r0, r1, r0, r1, True)
        for s0 in range(r1, n, src):
            total = total + block(r0, r1, s0, min(s0 + src, n), False)
    if uniform:
        total = total * (mm[0].to(acc_dtype) ** 2)
    return -G * float(total)


def kinetic(vel: torch.Tensor, m: torch.Tensor,
            dtype=torch.float64) -> float:
    v = vel.to(dtype)
    return float(0.5 * (m.to(dtype) * (v * v).sum(dim=-1)).sum())


def kdk(pos: torch.Tensor, vel: torch.Tensor, acc0: torch.Tensor,
        acc1: torch.Tensor, dt: float, dtype=torch.float64) -> tuple:
    """One kick-drift-kick step from (pos, vel) with the accelerations at
    its start (acc0) and at its end (acc1): (pos', vel')."""
    p, v = pos.to(dtype), vel.to(dtype)
    a0, a1 = acc0.to(dtype), acc1.to(dtype)
    half = v + a0 * (0.5 * dt)
    return p + half * dt, half + a1 * (0.5 * dt)
