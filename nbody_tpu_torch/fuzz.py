"""Seeded kernel fuzz: the Hopper kernels against the dense oracle.

The counterpart of the JAX package's ``tools/tpu_fuzz.py``: it replays the
seeded case space of its fuzz harness (``diagnostics/fuzz_cases.py``: sizes
that are primes or one off a block, D=2 and 3, the six non-f64 modes with
custom at 16, 64 or 4096 levels, softening 0, 0.01 and 0.1, equal and
unequal masses, adversarial clouds) against the compiled kernels:

    python -m nbody_tpu_torch.fuzz [num_cases] [seed] [--device D]

Exit code 0 means every case passed. Each force case runs the port's
counterpart of its drawn ``impl``: ``tiled`` -> ``forces.
tiled_accelerations``; ``pallas_rows`` and ``pallas_streamed`` ->
``hopper_nbody.accelerations_rows``; ``pallas_sym`` ->
``sym_accelerations``, with equal masses also under ``uniform_gm``;
``pallas_sym_chunked`` -> ``sym_accelerations_chunked(chunk=512)``. It
runs with cfg's softening and again with it as a run-time value (the
diagonal masked, as the engine's dynamic softening runs it), and holds
each run (a) against ``forces.dense_accelerations`` on the same device,
finite everywhere, (b) launch by launch against the kernel's plain
version on the same inputs, and (c) against itself run again, bit for
bit. Then the max pass on the same cloud (``hold_max``). Each mesh
case runs ``ring_accelerations`` under both schedules on
``ParticleMesh.virtual(S, device)`` against the dense oracle, and
``ring_potential_energy`` within PE_RTOL of ``metrics.potential_energy``
(``hold_ring``).

``run_edge_case`` runs one case of the route-edge tier
(``fuzz_cases.edge_cases``): its kernel in the design its route gives,
against the plain version and run to run
(``chip_smoke.py``'s phase fuzz runs every one on the card); an int
chain's table case (``hold_int_table``) holds the table's route and the
chain's bit for bit.

The rules are ``diagnostics/tolerance.py``'s, the same that
``chip_smoke.py`` holds each kernel to: the float rule with the
summed-|terms| scale; after quantize_force in the int modes (int8, int4,
custom) the flips rule wherever a path quantizes, a partial sum (a
chunk's diagonal, a pair tile's rows or reactions) held to the float rule
alone; the max of d^2 bit for bit; ``pair_pe_rows`` relative to the row.

It runs on ``cuda`` unless the caller names a device, and raises where
there is no card; on the CPU every wrapper takes its plain version, so
the kernels meet themselves (the rehearsal of the harness).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import fuzz_cases, metrics
from nbody_tpu_torch.diagnostics.tolerance import Tallies, pe_bound_rtol
from nbody_tpu_torch.models.direct import _resolve_device
from nbody_tpu_torch.ops import forces, hopper_nbody as hn, int_table
from nbody_tpu_torch.ops.precision import Quantizer
from nbody_tpu_torch.parallel import ring

MAX_RTOL = 1e-6       # the max pass against forces.max_pairwise_dist_sq
PE_RTOL = 2e-5        # ring_potential_energy against the metric
SYM_CHUNK = 512       # the chunked path's chunk, as the JAX harness's
PHANTOMS = 3          # pair_max's edge cases: the last sources invalid

# tools/tpu_fuzz.py's defaults, and the mesh cases of its CPU harness.
NUM_CASES, SEED, MESH_CASES = 40, 20260819, 20


# --------------------------------------------------------------------------
# The force cases
# --------------------------------------------------------------------------

def tensors(pos: np.ndarray, m: np.ndarray, device) -> tuple:
    """f32 tensors on ``device``; the drawn positions are f64 under
    NumPy 2 (an f32 cloud times an f64 scale), rounded to f32 here as
    jnp.asarray rounds them for JAX."""
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                 .contiguous() for x in (pos, m))


def counterpart(impl: str, pos, m, q, cfg, uniform: bool = False,
                softening_sq=None):
    """The port's counterpart of the JAX harness's ``_force``;
    ``softening_sq`` (a 0-d tensor) replaces cfg's as a run-time value."""
    kw = dict(quantize_forces=q.is_int, softening_sq=softening_sq)
    if impl == "tiled":
        return forces.tiled_accelerations(pos, m, q, cfg, **kw)
    if impl in ("pallas_rows", "pallas_streamed"):
        return hn.accelerations_rows(pos, m, q, cfg, **kw)
    if impl == "pallas_sym":
        return hn.sym_accelerations(pos, m, q, cfg, uniform_gm=uniform, **kw)
    if impl == "pallas_sym_chunked":
        return hn.sym_accelerations_chunked(pos, m, q, cfg, chunk=SYM_CHUNK,
                                            uniform_gm=uniform, **kw)
    raise ValueError(f"unknown impl {impl}")


class Launch(NamedTuple):
    """One kernel launch of a case: ``run()`` gives its raw results (a
    tuple), ``plain`` and ``scales`` its plain version's and their summed
    |terms| on the same inputs; ``stage`` "raw" for a whole evaluation,
    "tile" for a partial sum (Tally.hold)."""

    kernel: str
    shape: str
    run: Callable
    plain: tuple
    scales: tuple
    stage: str


def pair_sym_launch(p, g, pj, gj, bounds, q: Quantizer,
                    uniform: bool) -> Launch:
    """One pair_sym_force launch (a tile: rows and reactions)."""
    k, kj = p.shape[0], pj.shape[0]
    uni = uniform and k % hn.TILE == 0 and kj % hn.TILE == 0
    plain = (hn.pair_sym_force_uniform_plain if uni
             else hn.pair_sym_force_plain)
    return Launch(hn._variant("pair_sym_force", uni), f"{k}x{kj}",
                  lambda: hn.pair_sym_force(p, g, pj, gj, bounds, q,
                                            uniform=uniform),
                  plain(p, g, pj, gj, bounds, q),
                  (hn.pair_force_term_scale(p, pj, gj, bounds, q),
                   hn.pair_force_term_scale(pj, p, g, bounds, q)), "tile")


def launches(impl: str, pos, gm, bounds, q, masked: bool, uniform: bool,
             chunk: int = SYM_CHUNK) -> list:
    """The kernel launches ``impl`` makes at these inputs: the row sweep;
    sym_force over all N; or the chunked path's sym_force a chunk and
    pair_sym_force a chunk pair."""
    n = pos.shape[0]
    if impl == "tiled":
        return []
    if impl in ("pallas_rows", "pallas_streamed") or (
            impl == "pallas_sym_chunked" and masked):
        return [Launch("row_force", f"{n}",
                       lambda: (hn.row_force(pos, gm, bounds, q, masked),),
                       (hn.row_force_plain(pos, gm, bounds, q, masked),),
                       (hn.sym_force_term_scale(pos, gm, bounds, q,
                                                masked),), "raw")]
    if impl == "pallas_sym":
        chunk = n
    spans = [slice(a, min(a + chunk, n)) for a in range(0, n, chunk)]
    out = []
    for i, si in enumerate(spans):
        p, g = pos[si].contiguous(), gm[si].contiguous()
        k = p.shape[0]
        uni = uniform and k % hn.TILE == 0
        plain = hn.sym_force_uniform_plain if uni else hn.sym_force_plain
        out.append(Launch(
            hn._variant("sym_force", uni), f"{k}",
            lambda p=p, g=g: (hn.sym_force(p, g, bounds, q, masked,
                                           uniform=uniform),),
            (plain(p, g, bounds, q, masked),),
            (hn.sym_force_term_scale(p, g, bounds, q, masked),),
            "raw" if len(spans) == 1 else "tile"))
        for sj in spans[i + 1:]:
            out.append(pair_sym_launch(p, g, pos[sj].contiguous(),
                                       gm[sj].contiguous(), bounds, q,
                                       uniform))
    return out


def hold_launches(tallies: Tallies, label: str, items: list,
                  q: Quantizer) -> None:
    """Each launch against its plain version and run to run bit for
    bit."""
    for it in items:
        case = f"{label} [{it.kernel} {it.shape}]"
        got, again = it.run(), it.run()
        t = tallies[it.kernel]
        for g, a, w, s in zip(got, again, it.plain, it.scales):
            t.hold(case, g, w, s, q, it.stage)
            t.hold_bitwise(case, g, a, "run to run")


def run_force_case(seed: int, device, tallies: Tallies) -> str:
    """One force case from ``RandomState(seed)``: its impl with cfg's
    softening (with equal masses also under ``uniform_gm`` where the impl
    takes it) and with the same softening as a run-time value (the
    diagonal masked), and the max pass on its cloud; returns its label."""
    case = fuzz_cases.force_case(seed)
    q, cfg = case["q"], SimConfig(softening=case["softening"])
    pos, m = tensors(case["pos"], case["m"], device)
    gm = (cfg.G * m).contiguous()
    label = fuzz_cases.label(case)
    runtime = torch.full((), cfg.softening_sq, dtype=torch.float32,
                         device=pos.device)
    uniform = case["equal_masses"] and case["impl"] in ("pallas_sym",
                                                        "pallas_sym_chunked")
    variants = ([(False, None)] + [(True, None)] * uniform
                + [(False, runtime)])
    for uni, soft in variants:
        what = (label + " uniform_gm" * uni
                + " run-time softening" * (soft is not None))
        masked = hn._self_masked(cfg, soft)
        bounds = hn.kernel_bounds(pos, q, cfg, soft)
        want = forces.dense_accelerations(pos, m, q, cfg,
                                          quantize_forces=q.is_int,
                                          softening_sq=soft)
        scale = hn.sym_force_term_scale(pos, gm, bounds, q, masked)
        got = counterpart(case["impl"], pos, m, q, cfg, uni, soft)
        tallies["dense"].hold(what, got, want, scale, q, "out", finite=True)
        tallies["run to run"].hold_bitwise(
            what, got, counterpart(case["impl"], pos, m, q, cfg, uni, soft),
            "run to run")
        hold_launches(tallies, what, launches(case["impl"], pos, gm, bounds,
                                               q, masked, uni), q)
    hold_max(tallies, label, pos, cfg)
    return label


def hold_max(tallies: Tallies, label: str, pos, cfg: SimConfig) -> None:
    """max_d2 bitwise the plain max and itself run to run; its skip flag
    set (zero, no count) and unset (the max, one count); the pruned pass
    bitwise the full max, run to run, and within MAX_RTOL of
    forces.max_pairwise_dist_sq."""
    t = tallies["max_d2"]
    want = hn.max_d2_plain(pos)
    got = hn.max_d2(pos)
    t.hold_bitwise(label, got, want, "max_d2_plain")
    t.hold_bitwise(label, hn.max_d2(pos), got, "run to run")
    one = torch.ones((), dtype=torch.int32, device=pos.device)
    count = torch.zeros((), dtype=torch.int32, device=pos.device)
    t.hold_bitwise(label + " skipped", hn.max_d2(pos, skip=one, count=count),
                   torch.zeros_like(want), "0")
    t.hold_bitwise(label + " flagged", hn.max_d2(pos, skip=one * 0,
                                                 count=count), want,
                   "max_d2_plain")
    t.note(label, int(count) == 1, 0.0, 0.0, f"count {int(count)}, not 1")
    pruned = hn.max_pairwise_dist_sq_pruned(pos, cfg)
    t.hold_bitwise(label + " pruned", pruned, got + cfg.softening_sq,
                   "the full max")
    t.hold_bitwise(label + " pruned", hn.max_pairwise_dist_sq_pruned(
        pos, cfg), pruned, "run to run")
    t.hold_rel(label + " pruned", pruned.reshape(1),
               forces.max_pairwise_dist_sq(pos, cfg).reshape(1), MAX_RTOL,
               "forces.max_pairwise_dist_sq")


# --------------------------------------------------------------------------
# The mesh cases
# --------------------------------------------------------------------------

def hold_ring(tallies: Tallies, label: str, pos, m, q: Quantizer,
              cfg: SimConfig, shards: int, schedules, want, pe_want) -> None:
    """ring_accelerations on ParticleMesh.virtual(shards) under each of
    ``schedules`` against the oracle's forces ``want`` (finite
    everywhere) and run to run, and ring_potential_energy within PE_RTOL
    of ``pe_want``."""
    mesh = ring.ParticleMesh.virtual(shards, pos.device)
    bounds = hn.kernel_bounds(pos, q, cfg)
    scale = hn.sym_force_term_scale(pos, (cfg.G * m).contiguous(), bounds,
                                    q, hn._self_masked(cfg, None))
    for schedule in schedules:
        what = f"{label} ({schedule})"
        runs = [ring.ring_accelerations(pos, m, q, cfg, mesh,
                                        quantize_forces=q.is_int,
                                        schedule=schedule)
                for _ in range(2)]
        tallies["ring"].hold(what, runs[0], want, scale, q, "out",
                             finite=True)
        tallies["ring"].hold_bitwise(what, runs[0], runs[1], "run to run")
    tallies["ring energy"].hold_rel(
        label, ring.ring_potential_energy(pos, m, cfg, mesh).reshape(1)
        .double(), pe_want.reshape(1).double(), PE_RTOL,
        "metrics.potential_energy", finite=True)


def run_mesh_case(seed: int, device, tallies: Tallies) -> str:
    """One mesh case from ``RandomState(seed)``: the ring under both
    schedules against the dense oracle and run to run, and its potential
    energy against the metric; returns its label."""
    case = fuzz_cases.mesh_case(seed)
    q, cfg = case["q"], SimConfig(softening=case["softening"])
    pos, m = tensors(case["pos"], case["m"], device)
    label = (f"N={case['n']} dim={case['dim']} {case['mode'].value} "
             f"soft={case['softening']} shards={case['shards']} "
             f"sched={case['schedule']}")
    hold_ring(tallies, label, pos, m, q, cfg, case["shards"], ring.SCHEDULES,
              forces.dense_accelerations(pos, m, q, cfg,
                                         quantize_forces=q.is_int),
              metrics.potential_energy(pos, m, cfg))
    return label


# --------------------------------------------------------------------------
# The route-edge tier
# --------------------------------------------------------------------------

def pe_ids(pattern: str, n_i: int, n_j: int, device) -> tuple:
    """Receiver and source ids (int32 on ``device``) of one of
    ``fuzz_cases.PE_ID_PATTERNS``."""
    gen = torch.Generator().manual_seed(n_i + n_j)
    ids = {"own": (torch.arange(n_i), torch.arange(n_j)),
           "permuted": (torch.randperm(n_i, generator=gen),
                        torch.randperm(n_j, generator=gen)),
           "duplicated": (torch.arange(n_i) // 3, torch.arange(n_j) // 7),
           "overlapping": (torch.arange(n_i),
                           torch.arange(n_i - 40, n_i - 40 + n_j)),
           "disjoint": (torch.arange(n_i), torch.arange(n_i, n_i + n_j))
           }[pattern]
    return tuple(x.to(torch.int32).to(device).contiguous() for x in ids)


def hold_sym_flags(case, pos, m, gm, bounds, q: Quantizer, cfg: SimConfig,
                   tallies: Tallies) -> None:
    """The fused max (emit_max, explicit log bounds: forces bitwise the
    launch without it, the max bitwise max_d2_plain's) or the cached
    redo's flagged launch (skip set: zeros and no count; unset: the
    forces, counted), each against the plain version and run to run."""
    masked = hn._self_masked(cfg, None)
    uniform = case.equal_masses
    n = pos.shape[0]
    plain = (hn.sym_force_uniform_plain if uniform and n % hn.TILE == 0
             else hn.sym_force_plain)(pos, gm, bounds, q, masked)
    scale = hn.sym_force_term_scale(pos, gm, bounds, q, masked)
    label = case.name
    if case.kernel == "sym_force_max":
        t = tallies[hn._variant("sym_force", uniform and n % hn.TILE == 0,
                                True)]
        (acc, mx), (acc2, mx2) = [
            hn.sym_accelerations(pos, m, q, cfg, quantize_forces=False,
                                 log_lo=bounds[0], log_hi=bounds[1],
                                 uniform_gm=uniform, emit_max=True)
            for _ in range(2)]
        t.hold(label, acc, plain, scale, q)
        t.hold_bitwise(label, acc, acc2, "run to run")
        t.hold_bitwise(label, mx, mx2, "run to run (max)")
        t.hold_bitwise(label, acc, hn.sym_force(pos, gm, bounds, q, masked,
                                                uniform=uniform),
                       "the forces without the fused max")
        t.hold_bitwise(label, mx, hn.max_d2_plain(pos) + bounds[2],
                       "max_d2_plain + eps^2")
        return
    t = tallies["sym_force"]
    skip = torch.full((), case.opts["skip"], dtype=torch.int32,
                      device=pos.device)
    counts = []
    for _ in range(2):
        count = torch.zeros((), dtype=torch.int32, device=pos.device)
        counts.append((hn.sym_force(pos, gm, bounds, q, masked, skip=skip,
                                    count=count), int(count)))
    (got, ran), (again, _) = counts
    want = torch.zeros_like(plain) if case.opts["skip"] else plain
    t.hold(label, got, want, scale, q)
    t.hold_bitwise(label, got, again, "run to run")
    t.note(label, ran == 1 - case.opts["skip"], 0.0, 0.0,
           f"the count gained {ran}")


def hold_int_table(case, pos, m, cfg: SimConfig, tallies: Tallies) -> None:
    """An int chain's table case: sym_force at the case's pattern, "cloud"
    (the cloud and its exact grid), "on_edge" (the cloud's first particle
    at the origin and the next ones at offsets whose softened d^2 is each
    kept edge of the launch's table, or one float below it, under the
    cloud's exact grid) or "stale" (the grid of the cloud 100 times
    smaller: pairs past the table's last edge), against the plain version,
    run to run, and bit for bit the other route of int_chain_design (the
    table with the chain's weights, or the chain); on the card a stale grid
    counts blocks in INT_CHAIN_FALLBACKS."""
    q, label, pattern = case.q, case.name, case.opts["pattern"]
    masked = hn._self_masked(cfg, None)
    gm = (cfg.G * m).contiguous()
    bounds = hn.kernel_bounds(pos, q, cfg)
    if pattern == "on_edge":
        edges = int_table.edges_of(bounds, q).numpy()
        radius = float(pos.abs().max())
        edges = edges[edges < radius * radius]
        below = (edges.view(np.int32) - 1).view(np.float32)
        offsets, _ = int_table.offsets_on(np.concatenate([edges, below]),
                                          cfg.softening_sq, case.dim)
        k = min(len(offsets), pos.shape[0] - 1)
        pos = pos.clone()
        pos[0] = 0.0
        pos[1:k + 1] = torch.from_numpy(offsets[:k]).to(pos.device)
    elif pattern == "stale":
        bounds = hn.kernel_bounds(pos * 0.01, q, cfg)
    uniform = case.equal_masses
    t = tallies[hn._variant("sym_force", uniform and pos.shape[0] % hn.TILE
                            == 0)]
    hn.INT_CHAIN_FALLBACKS.clear()
    got = hn.sym_force(pos, gm, bounds, q, masked, uniform=uniform)
    fell = hn.int_chain_fallbacks(pos.device)
    saved = hn.INT_TABLE_MAX_LEVELS
    hn.INT_TABLE_MAX_LEVELS = (0 if case.design == "table"
                               else q.levels)
    try:
        other = hn.sym_force(pos, gm, bounds, q, masked, uniform=uniform)
    finally:
        hn.INT_TABLE_MAX_LEVELS = saved
    plain = (hn.sym_force_uniform_plain if uniform
             and pos.shape[0] % hn.TILE == 0 else hn.sym_force_plain)
    t.hold(label, got, plain(pos, gm, bounds, q, masked),
           hn.sym_force_term_scale(pos, gm, bounds, q, masked), q)
    t.hold_bitwise(label, got, hn.sym_force(pos, gm, bounds, q, masked,
                                            uniform=uniform), "run to run")
    t.hold_bitwise(label, got, other, "the other route of int_chain_design")
    if (pattern == "stale" and pos.device.type == "cuda"
            and hn.sym_design(pos.shape[0], case.dim, q) == "one_pass"):
        t.note(label, fell > 0, 0.0, 0.0,
               "no block counted in INT_CHAIN_FALLBACKS")


def hold_pair(case, sets, cfg: SimConfig, tallies: Tallies) -> None:
    """pair_sym_force, pair_force, pair_max or pair_pe_rows at the case's
    two sets (pair_pe_rows: one set where the counts are equal), each
    against its plain version and itself run to run."""
    q, label = case.q, case.name
    (xi, mi), (xj, mj) = sets
    gi, gj = (cfg.G * mi).contiguous(), (cfg.G * mj).contiguous()
    bounds = hn.kernel_bounds(torch.cat([xi, xj]), q, cfg)
    if case.kernel == "pair_sym_force":
        hold_launches(tallies, label, [pair_sym_launch(
            xi, gi, xj, gj, bounds, q, case.equal_masses)], q)
    elif case.kernel == "pair_force":
        lo_hi = (bounds[0], bounds[1]) if q.is_int else (None, None)
        hold_launches(tallies, label, [Launch(
            "pair_force", f"{xi.shape[0]}x{xj.shape[0]}",
            lambda: (hn.pair_force(xi, xj, gj, q, cfg, *lo_hi),),
            (hn.pair_force_plain(xi, xj, gj, q, cfg, *lo_hi),),
            (hn.pair_force_term_scale(xi, xj, gj, bounds, q),), "tile")], q)
    elif case.kernel == "pair_max":
        t = tallies["pair_max"]
        vi = torch.ones(xi.shape[0], dtype=torch.bool, device=xi.device)
        vj = torch.ones(xj.shape[0], dtype=torch.bool, device=xi.device)
        vj[-PHANTOMS:] = False
        want = hn.pair_max_plain(xi, xj, vi, vj)
        got = hn.pair_max(xi, xj, vi, vj)
        t.hold_bitwise(label, got, want, "pair_max_plain")
        t.hold_bitwise(label, hn.pair_max(xi, xj, vi, vj), got, "run to run")
    else:
        if xi.shape[0] == xj.shape[0]:
            xj, mj = xi, mi
        n_i, n_j = xi.shape[0], xj.shape[0]
        ids_i, ids_j = pe_ids(case.opts["pattern"], n_i, n_j, xi.device)
        args = (xi, mi, ids_i, xj, mj, ids_j, cfg.softening_sq)
        t = tallies["pair_pe_rows"]
        want, got = hn.pair_pe_rows_plain(*args), hn.pair_pe_rows(*args)
        t.hold_rel(label, got, want, pe_bound_rtol(n_i, n_j),
                   "pair_pe_rows_plain")
        t.hold_bitwise(label, hn.pair_pe_rows(*args), got, "run to run")


def run_edge_case(case, device, tallies: Tallies) -> str:
    """One case of the route-edge tier (a ``fuzz_cases.EdgeCase``): its
    kernel in the design its route gives, against the plain version and
    run to run; a ring against the
    row-blocked oracle (``forces.tiled_accelerations``: the dense oracle's
    pair block in O(1024 N) memory) and its energy against the compensated
    metric. Returns its name."""
    q, cfg = case.q, SimConfig(softening=case.softening)
    sets = [tensors(p, m, device) for p, m in case.clouds()]
    pos, m = sets[0]
    gm = (cfg.G * m).contiguous()
    masked = hn._self_masked(cfg, None)
    if case.kernel in ("sym_force", "row_force", "chunked", "sym_force_max",
                       "redo"):
        bounds = hn.kernel_bounds(pos, q, cfg)
    if case.kernel in ("sym_force", "row_force", "chunked"):
        impl = {"sym_force": "pallas_sym", "row_force": "pallas_rows",
                "chunked": "pallas_sym_chunked"}[case.kernel]
        hold_launches(tallies, case.name, launches(
            impl, pos, gm, bounds, q, masked, case.equal_masses,
            chunk=case.opts.get("chunk", SYM_CHUNK)), q)
        if case.kernel == "chunked":
            runs = [hn.sym_accelerations_chunked(
                pos, m, q, cfg, quantize_forces=False,
                chunk=case.opts["chunk"], uniform_gm=case.equal_masses)
                for _ in range(2)]
            tallies["chunked"].hold(
                case.name, runs[0], hn.sym_force_plain(pos, gm, bounds, q,
                                                       masked),
                hn.sym_force_term_scale(pos, gm, bounds, q, masked), q)
            tallies["chunked"].hold_bitwise(case.name, runs[0], runs[1],
                                            "run to run")
    elif case.kernel in ("sym_force_max", "redo"):
        hold_sym_flags(case, pos, m, gm, bounds, q, cfg, tallies)
    elif case.kernel in ("max_d2", "pruned"):
        hold_max(tallies, case.name, pos, cfg)
    elif case.kernel == "int_table":
        hold_int_table(case, pos, m, cfg, tallies)
    elif case.kernel == "ring":
        hold_ring(tallies, case.name, pos, m, q, cfg, case.shape[1],
                  (case.opts["schedule"],),
                  forces.tiled_accelerations(pos, m, q, cfg,
                                             quantize_forces=q.is_int),
                  metrics.potential_energy(pos, m, cfg, compensated=True))
    else:
        hold_pair(case, sets, cfg, tallies)
    return case.name


# --------------------------------------------------------------------------
# Running the cases
# --------------------------------------------------------------------------

def run_case(kind: str, fn, tallies: Tallies, failed: list) -> None:
    """One case: ``fn()`` runs it into ``tallies`` and returns its label;
    printed ok, or FAIL with the failures it added (``failed`` gains
    "kind: label")."""
    before = len(tallies.failures())
    label = f"{kind}: {fn()}"
    new = tallies.failures()[before:]
    print(f"  {'FAIL' if new else 'ok  '} {label}", flush=True)
    for f in new:
        print(f"       {f[:400]}")
    if new:
        failed.append(label)


def run(num_cases: int = NUM_CASES, seed: int = SEED,
        mesh_cases: int = MESH_CASES, device="cuda",
        tallies: Tallies | None = None) -> list:
    """The force and max cases ``seed + i`` (i < num_cases) and the mesh
    cases ``13 seed + i`` (i < mesh_cases) on ``device``, each printed;
    returns the labels of the cases that failed. ``tallies`` (optional)
    gathers the comparisons by kernel."""
    device = _resolve_device(device)
    tallies = Tallies() if tallies is None else tallies
    failed = []
    for idx in range(num_cases):
        run_case(f"case {idx}", lambda: run_force_case(seed + idx, device,
                                                       tallies),
                 tallies, failed)
    for idx in range(mesh_cases):
        run_case(f"mesh case {idx}", lambda: run_mesh_case(
            seed * 13 + idx, device, tallies), tallies, failed)
    total = num_cases + mesh_cases
    print(f"\n{total - len(failed)}/{total} fuzz cases pass on {device} "
          f"(seed {seed}: {num_cases} force and max cases, {mesh_cases} "
          f"mesh cases)")
    for name, t in sorted(tallies.items()):
        print(f"  {t.line(name)}")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.fuzz",
        description="Seeded kernel fuzz against the dense oracle.")
    ap.add_argument("num_cases", nargs="?", type=int, default=NUM_CASES)
    ap.add_argument("seed", nargs="?", type=int, default=SEED)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    failed = run(args.num_cases, args.seed, device=args.device)
    if failed:
        for f in failed:
            print(f"  FAILED: {f}")
        return 1
    print("FUZZ: ALL PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
