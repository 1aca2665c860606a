"""The int chain's per-launch table: its plain model and its card test.

The one-pass body (``csrc/one_pass.cuh``) takes an int launch's weights
from a table that each block builds from the chain's own operations,
where ``hopper_nbody.int_chain_design`` sends the grid: the chain's
index k = rint(log(x) norm_a + norm_b) of x = max(d^2 + eps^2, min_d2) is a
step function of x in one launch, and its weight a function of k alone.

``table_plain`` is the build in plain PyTorch, step for step: the edges
(the least float at which k reaches each next value, by bisection over
float32 bit patterns with ``hopper_nbody._pair_weight``'s chain), the
weights, the bucket shift and the buckets; ``lookup_plain`` is a pair's
lookup. On the CPU they are held to ``_pair_weight`` on dense sweeps of
floats (tests/test_torch_sym_uniform.py).

``sweep`` is the card's test export, which no path of the program
launches: the kernel's own table against the chain on every float of a
range, counted on the device. ``edges_of`` and ``offsets_on`` give the
kernel fuzz its pairs on the edges (``fuzz.hold_int_table``).
"""

from __future__ import annotations

import dataclasses

import torch

from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Quantizer

_INF_BITS = 0x7F800000


def edges(levels: int) -> int:
    """Edges (and bins) a table holds: the levels and the slack."""
    return levels + hn.INT_TABLE_SLACK


def buckets(levels: int) -> int:
    """Buckets a table may use (one_pass.cuh's op_table_buckets)."""
    return 4 * edges(levels) + 8


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns as int64."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF


def _floats(u: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns (< 2^31) as float32."""
    return u.to(torch.int32).view(torch.float32)


@dataclasses.dataclass
class Table:
    """A launch's table: ``lo`` where it starts, ``k0`` the chain's index
    there, ``edge`` e_1..e_E and ``weight`` w_0..w_{E-1} (f32), the ``m``
    bins it keeps (it covers [lo, ``end`` = e_m)), its bucket ``shift``
    and ``base``, and ``bucket`` (buckets used, 3) f32 rows {edge or +inf,
    w below it, w from it on}."""

    lo: torch.Tensor
    k0: torch.Tensor
    edge: torch.Tensor
    weight: torch.Tensor
    m: int
    shift: int
    base: int
    bucket: torch.Tensor

    @property
    def end(self) -> float:
        return float(self.edge[self.m - 1]) if self.m else float("-inf")


def table_plain(bounds: torch.Tensor, q: Quantizer) -> Table:
    """The table of the grid ``bounds`` = [log_lo, log_hi, eps^2] (3,) f32
    and q's levels, as op_build_table builds it."""
    bounds = bounds.to(torch.float32)
    grid = hn._int_grid(bounds, q)
    n_edges = edges(q.levels)
    lo = torch.fmax(bounds[2], torch.tensor(q.min_dist_sq,
                                            dtype=torch.float32))
    lo_u = int(_bits(lo))
    k0 = hn._chain_k(lo, grid)
    valid = bool(lo > 0) and lo_u < _INF_BITS and bool(k0.abs() < 2 ** 22)
    target = k0 + torch.arange(1, n_edges + 1, dtype=torch.float32)
    weight = hn._chain_w(torch.cat([k0.reshape(1), target[:-1]]), grid)
    edge = torch.full((n_edges,), float("inf"))
    m, shift = 0, 0
    if valid:
        a = torch.full((n_edges,), lo_u, dtype=torch.int64)
        b = torch.full((n_edges,), _INF_BITS, dtype=torch.int64)
        reached = hn._chain_k(torch.full((), float("inf")), grid) >= target
        while bool((b - a > 1).any()):
            mid = a + (b - a) // 2
            hit = hn._chain_k(_floats(mid), grid) >= target
            a, b = torch.where(hit, a, mid), torch.where(hit, mid, b)
        edge = torch.where(reached, _floats(b), edge)
        best = (0, 0)
        eu = _bits(edge).tolist()
        for s in range(32):
            prev, count = -1, 0
            for u in eu:
                r = (u >> s) - (lo_u >> s)
                if r <= prev or r >= buckets(q.levels):
                    break
                prev, count = r, count + 1
            best = max(best, (count, s))
        m, shift = best
    base = lo_u >> shift
    rel = [(u >> shift) - base for u in _bits(edge[:m]).tolist()]
    nan, inf = float("nan"), float("inf")
    rows = [[nan, nan, nan] for _ in range(rel[-1] + 1 if m else 0)]
    w = weight.tolist()
    e = edge.tolist()
    for i in range(m):
        up = w[i + 1] if i + 1 < m else nan
        for bk in range(0 if i == 0 else rel[i - 1] + 1, rel[i]):
            rows[bk] = [inf, w[i], w[i]]
        rows[rel[i]] = [e[i], w[i], up]
    return Table(lo, k0, edge, weight, m, shift, base,
                 torch.tensor(rows, dtype=torch.float32).reshape(-1, 3))


def lookup_plain(d2: torch.Tensor, table: Table, q: Quantizer) -> tuple:
    """(k, w) of softened d^2 by the table, as a pair takes them
    (op_table_w) where x = max(d^2, min_d2) lies in [lo, end); NaN
    elsewhere (there the block runs on the chain). k is k0 plus the count
    of edges at or below x."""
    x = torch.clamp(d2.to(torch.float32), min=q.min_dist_sq)
    inside = (x >= table.lo) & (x < table.end)
    b = torch.where(inside, (_bits(x) >> table.shift) - table.base, 0)
    row = table.bucket[b] if table.m else torch.full(x.shape + (3,),
                                                     float("nan"))
    w = torch.where(x >= row[..., 0], row[..., 2], row[..., 1])
    w = torch.where(inside, w, float("nan"))
    k = table.k0 + torch.searchsorted(table.edge[:table.m].contiguous(),
                                      x.contiguous(),
                                      right=True).to(torch.float32)
    k = torch.where(inside, k, float("nan"))
    return k, w


def edges_of(bounds: torch.Tensor, q: Quantizer) -> torch.Tensor:
    """The kept edges e_1..e_m of the table a launch on ``bounds``' device
    builds (f32 on the host): the card's own, through ``sweep``, or the
    plain model's on the CPU."""
    if bounds.device.type == "cuda":
        meta = sweep(bounds, q, 0, 1)
        return meta["edge"][:meta["m"]]
    table = table_plain(bounds.cpu(), q)
    return table.edge[:table.m]


def offsets_on(targets, soft: float, dim: int) -> tuple:
    """Offsets (k, dim) f32, and which of ``targets`` (f32 values) they
    reach: an offset o from a particle at the origin gives the pair's
    softened d^2 = (o_0^2 + o_1^2 (+ 0^2)) + soft, formed as the kernels
    form it, equal to its target bit for bit. Searched over o_0 within 64
    bit patterns of the root and a few o_1 (small, and fractions of the
    root); targets no offset reaches are left out."""
    import numpy as np

    f32 = np.float32
    found, hit = [], []
    for target in np.asarray(targets, f32):
        root = np.sqrt(max(float(target) - soft, 0.0))
        for o1 in [f32(0.0), f32(0.125), f32(0.25), f32(0.5)] + [
                f32(root * c) for c in (0.3, 0.45, 0.6, 0.7)]:
            rest = f32(target) - f32(soft) - o1 * o1
            if not rest > 0:
                continue
            root = np.sqrt(rest, dtype=f32).view(np.int32)
            o0 = (root + np.arange(-64, 65, dtype=np.int32)).view(f32)
            d2 = o0 * o0 + o1 * o1
            if dim == 3:
                d2 = d2 + f32(0.0) * f32(0.0)
            exact = np.nonzero((d2 + f32(soft)) == f32(target))[0]
            if exact.size:
                row = [o0[exact[0]], o1] + [f32(0.0)] * (dim - 2)
                found.append(np.array(row, f32))
                hit.append(float(target))
                break
    return np.array(found, f32).reshape(-1, dim), hit


def sweep(bounds: torch.Tensor, q: Quantizer, u_lo: int,
          count: int) -> dict:
    """The card's table against the chain on the floats of bit patterns
    u_lo .. u_lo + count - 1, as softened d^2 (csrc/sym_force.cu's
    nbody_int_table_sweep; a test export, which no path of the program
    launches): {"mismatches", "outside" (x outside [lo, e_m), taken by
    the chain), "first" (the least mismatching bit pattern, or None), "m",
    "shift", "base", "buckets" (used), "edge" (f32 on the host)}.
    ``bounds`` lives on the card."""
    if bounds.device.type != "cuda":
        raise ValueError("the table's sweep runs on the card only")
    lib = hn._library()
    dev = bounds.device
    bounds = bounds.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        tally = torch.tensor([0, 0, -1], dtype=torch.int64, device=dev)
        meta = torch.zeros(4, dtype=torch.int32, device=dev)
        edge = torch.empty(edges(q.levels), dtype=torch.float32, device=dev)
        rc = lib.nbody_int_table_sweep(
            hn._ptr(bounds), q.levels, hn._arg_cap(q), q.min_dist_sq,
            u_lo, count, hn._ptr(tally), hn._ptr(meta), hn._ptr(edge),
            hn._stream(dev))
    hn._raise_on(rc, "int_table_sweep")
    bad, outside, first = tally.tolist()
    m, shift, base, used = meta.tolist()
    return {"mismatches": bad, "outside": outside,
            "first": None if first == -1 else first & 0xFFFFFFFF,
            "m": m, "shift": shift, "base": base, "buckets": used,
            "edge": edge.cpu()}
