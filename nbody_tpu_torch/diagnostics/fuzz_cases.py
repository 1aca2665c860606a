"""The kernel fuzz's case space: seeded random cases and the route edges.

``draw_case`` is the port's own copy of the JAX package's fuzz draw
(``tests/test_fuzz_kernels.py``'s ``_draw_case``), numpy only: from one
``np.random.RandomState`` it takes the same values in the same order, the
block shapes that only the TPU kernels read included, so that a seed gives
both packages the same case. The callers' draws follow it on the same
stream: a force case's custom level count (``force_case``), a mesh case's
shard count and schedule (``mesh_case``).

``edge_cases`` is the route-edge tier: shapes on both sides of every edge
of the pure shape functions that pick what a Hopper launch runs
(``hopper_nbody.sym_schedule``, ``uniform_design``, ``sym_design``,
``pair_design``, ``row_segments`` / ``pair_max_segments`` /
``pe_segments``, ``pe_design`` and ``max_d2_design``), meshes with
phantom rows, and the int chain's table (``int_chain_design``: level
counts on both sides of its cut, pairs whose softened d^2 lands exactly on
a bin edge or one float below it, and bounds stale enough that pairs fall
past the table's last edge). Their positions come from the same
adversarial cloud as the drawn cases'; modes, D, softening and masses
rotate through the ladder.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Precision, Quantizer

# Sizes that bite: primes, one off a block, tiny.
SIZES = [3, 17, 97, 127, 128, 129, 250, 255, 256, 257, 300, 511, 512, 513,
         641, 800, 1021]
MODES = [Precision.FLOAT32, Precision.BFLOAT16, Precision.FLOAT16,
         Precision.INT8_SIM, Precision.INT4_SIM, Precision.CUSTOM]
SOFTENINGS = [0.0, 0.01, 0.1]
IMPLS = ["tiled", "pallas_rows", "pallas_sym", "pallas_streamed",
         "pallas_sym_chunked"]
CUSTOM_LEVELS = [16, 64, 4096]
MESH_SHARDS = [2, 5, 8]
MESH_SCHEDULES = ["sym", "rows"]
CLOUD_SCALES = [0.3, 1.0, 30.0]


def cloud(rng: np.random.RandomState, n: int, dim: int, softening: float,
          equal_masses: bool) -> tuple:
    """(positions (n, dim) f32, masses (n,) f32): a normal cloud at a drawn
    scale, sometimes with a particle at the origin and, at softening > 0,
    a coincident pair (at zero softening that pair is a true singularity,
    inf or NaN in the dense oracle too, so never drawn there); equal
    masses or log-normal ones."""
    pos = rng.randn(n, dim).astype(np.float32) * rng.choice(CLOUD_SCALES)
    if rng.randint(2) and n >= 2:
        pos[0] = 0.0
    if rng.randint(2) and n >= 4 and softening > 0.0:
        pos[2] = pos[3]
    if equal_masses:
        m = np.ones(n, np.float32)
    else:
        m = np.exp(rng.randn(n)).astype(np.float32)
    return pos, m


def draw_case(rng: np.random.RandomState) -> dict:
    """One case: n, dim, mode (a Precision), softening, equal_masses,
    impl, pos, m, block, block_j (the last two drawn for the stream's sake:
    no Hopper kernel takes a block shape)."""
    n = int(rng.choice(SIZES))
    dim = int(rng.choice([2, 3]))
    mode = MODES[rng.randint(len(MODES))]
    softening = float(rng.choice(SOFTENINGS))
    equal_masses = bool(rng.randint(2))
    impl = IMPLS[rng.randint(len(IMPLS))]
    pos, m = cloud(rng, n, dim, softening, equal_masses)
    block = int(rng.choice([64, 128, 256]))
    block_j = int(rng.choice([128, 256, 512]))
    return dict(n=n, dim=dim, mode=mode, softening=softening,
                equal_masses=equal_masses, impl=impl, pos=pos, m=m,
                block=block, block_j=block_j)


def force_case(seed: int) -> dict:
    """A force case from ``RandomState(seed)``: draw_case, then the custom
    level count, and its quantizer under ``q``."""
    rng = np.random.RandomState(seed)
    case = draw_case(rng)
    case["custom_levels"] = int(rng.choice(CUSTOM_LEVELS))
    case["q"] = Quantizer(case["mode"], custom_levels=case["custom_levels"])
    return case


def max_case(seed: int) -> dict:
    """A max-pass case from ``RandomState(seed)``: draw_case alone."""
    return draw_case(np.random.RandomState(seed))


def mesh_case(seed: int) -> dict:
    """A mesh case from ``RandomState(seed)``: draw_case, then the shard
    count and the schedule; its quantizer (the default level count) under
    ``q``."""
    rng = np.random.RandomState(seed)
    case = draw_case(rng)
    case["shards"] = int(rng.choice(MESH_SHARDS))
    case["schedule"] = str(rng.choice(MESH_SCHEDULES))
    case["q"] = Quantizer(case["mode"])
    return case


def label(case: dict) -> str:
    """The case's fields as tools/tpu_fuzz.py prints them."""
    return (f"N={case['n']} dim={case['dim']} {case['mode'].value} "
            f"soft={case['softening']} impl={case['impl']} "
            f"eq_m={case['equal_masses']} "
            f"blk={case['block']}/{case['block_j']}")


# --------------------------------------------------------------------------
# The route-edge tier
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeCase:
    """One route edge: ``kernel`` names what a case launches (a wrapper of
    ops.hopper_nbody, or "chunked", "pruned", "redo" or "ring"), ``route``
    the shape function whose edge it stands on, ``shape`` its sizes
    ((n,), (n_a, n_b), or (n, shards)), ``design`` what the route gives
    at ``design_shape`` under ``flags`` (its keyword arguments:
    "fused_max", "flagged"). ``extra`` holds a case's own options:
    "chunk", "pattern", "schedule", "skip"."""

    kernel: str
    route: str
    shape: tuple
    dim: int
    mode: Precision
    softening: float
    equal_masses: bool
    seed: int
    design: str
    flags: tuple = ()
    extra: tuple = ()

    @property
    def q(self) -> Quantizer:
        return Quantizer(self.mode,
                         custom_levels=self.opts.get("levels", 64))

    @property
    def opts(self) -> dict:
        return dict(self.extra)

    @property
    def design_shape(self) -> tuple:
        """The shape the route sees: a ring's shard (b, b), b = ceil(n /
        shards); the chunked path's pair tile (chunk, chunk); else the
        case's shape."""
        if self.kernel == "ring":
            b = -(-self.shape[0] // self.shape[1])
            return (b, b)
        if self.kernel == "chunked":
            return (self.opts["chunk"],) * 2
        return self.shape

    def routed(self) -> str:
        """What the route gives at the case's shape."""
        return route_design(self.route, self.design_shape, self.dim, self.q,
                            **dict(self.flags))

    @property
    def name(self) -> str:
        opts = "".join(f" {k}={v}" for k, v in self.extra)
        return (f"{self.kernel} {'x'.join(map(str, self.shape))} "
                f"D={self.dim} {self.mode.value} soft={self.softening} "
                f"eq_m={self.equal_masses}{opts} [{self.route}: "
                f"{self.design}]")

    def clouds(self) -> list:
        """The case's position and mass sets from its seed: one for a
        one-set kernel, two (receivers, sources) for a pair kernel."""
        rng = np.random.RandomState(self.seed)
        sizes = self.shape[:1] if self.kernel in ONE_SET else self.shape
        return [cloud(rng, n, self.dim, self.softening, self.equal_masses)
                for n in sizes]


ONE_SET = ("sym_force", "sym_force_max", "redo", "max_d2", "pruned",
           "row_force", "chunked", "ring", "int_table")

# Sizes of the sym routes: T = 256 / 257 around the triangle's and the
# one-pass body's edge, T mod 4 = 1, 2, 3, 0 past it (the one-pass body's
# ragged 256-receiver tails), and a prime past it (the T x T grid).
SYM_NS = (16383, 16384, 16385, 16448, 16512, 16576, 16640, 16411)
FUSED_NS = (16384, 16448)
MAX_D2_NS = (hn.MAX_D2_SMALL_N, hn.MAX_D2_SMALL_N + 1, hn.TILED_MIN_N,
             hn.TILED_MIN_N + 1)
PRUNED_NS = (hn.PRUNED_CANDIDATES, hn.PRUNED_CANDIDATES + 1)
# (n, chunk) of the chunked path: 257-tile chunks whose last chunk is not a
# multiple of TILE (one pair tile in the one-pass design, one off it), and
# 256-tile chunks (the two-pass tile).
CHUNKED = ((2 * 16448 + 100, 16448), (2 * 16384 + 37, 16384))
SEGMENTED = 32769   # the S = 4 shard of 131075: 129 segments of 2 tiles
PE_NS = (hn.TILED_MIN_N, hn.TILED_MIN_N + 1)
# pair_pe_rows' id patterns (``fuzz.pe_ids``): each set's own ids (one set:
# its self pairs masked; two sets: ids that meet everywhere), permuted,
# duplicated (runs of 3 and 7), overlapping in 40 ids, disjoint.
PE_ID_PATTERNS = ("own", "permuted", "duplicated", "overlapping", "disjoint")
# (n, shards): phantom rows on 3, 5 and 8 shards, and 2 shards of 16386
# (past TILED_MIN_N).
RING_MESHES = ((20011, 3), (16411, 5), (4099, 8), (32771, 2))
EDGE_SEED = 20260820
# The int chain's table cases: a one-pass sym_force shape (257 tiles); the
# patterns ``fuzz.hold_int_table`` builds.
TABLE_N = 16448
TABLE_PATTERNS = ("cloud", "on_edge", "stale")


def first_split(segments, n_i: int | None = None) -> int:
    """The least n_j at which ``segments(n_i, n_j)`` (``n_i`` None: the
    one set n x n) cuts the sources into more than one segment."""
    n = 1
    while segments(n if n_i is None else n_i, n)[0] == 1:
        n += 1
    return n


def route_design(route: str, shape: tuple, dim: int, q: Quantizer,
                 **flags) -> str:
    """What ``route`` gives at ``shape``: a design name, or for a
    segments function "one segment" / "segments" (the kernel writes its
    rows itself, or reduces a scratch of segment sums)."""
    if route == "sym_schedule":
        return hn.sym_schedule(shape[0])
    if route == "uniform_design":
        return hn.uniform_design(-(-shape[0] // hn.TILE), q, dim)
    if route == "sym_design":
        return hn.sym_design(shape[0], dim, q, **flags)
    if route == "pair_design":
        return hn.pair_design(shape[0], shape[1], dim, q)
    if route == "max_d2_design":
        return hn.max_d2_design(shape[0])
    if route == "pe_design":
        return hn.pe_design(shape[0], shape[1])
    if route == "int_chain_design":
        return hn.int_chain_design(q.levels)
    if route in ("row_segments", "pair_max_segments", "pe_segments"):
        n_i = shape[0]
        n_j = shape[1] if len(shape) > 1 else shape[0]
        nseg = getattr(hn, route)(n_i, n_j)[0]
        return "one segment" if nseg == 1 else "segments"
    raise ValueError(f"unknown route {route}")


# Every design each route function can give.
ROUTE_DESIGNS = {
    "sym_schedule": {"triangle", "square"},
    "uniform_design": {"one_pass", "two_pass"},
    "sym_design": {"one_pass", "triangle", "square"},
    "pair_design": {"one_pass", "two_pass"},
    "max_d2_design": {"single_64", "single_256", "tiled"},
    "pe_design": {"tiled", "per_receiver"},
    "int_chain_design": {"table", "chain"},
    "row_segments": {"one segment", "segments"},
    "pair_max_segments": {"one segment", "segments"},
    "pe_segments": {"one segment", "segments"},
}


class _Ladder:
    """Modes, D, softening and masses in turn, one step a case."""

    def __init__(self):
        self.i = 0

    def next(self, modes=MODES, softenings=SOFTENINGS) -> tuple:
        """(mode, D, softening, seed): D turns every len(modes) cases and
        the softening shifts by one against the modes, so that every
        (mode, D, softening) comes round."""
        i, self.i = self.i, self.i + 1
        k = i // len(modes)
        return (modes[i % len(modes)], 2 + k % 2,
                softenings[(i + k) % len(softenings)], EDGE_SEED + i)


def edge_cases() -> list:
    """[EdgeCase] of the route-edge tier, in a fixed order."""
    ladder, out = _Ladder(), []
    int_modes = [m for m in MODES if Quantizer(m).is_int]
    soft = [s for s in SOFTENINGS if s > 0]

    def add(kernel, route, shape, equal, flags=None, modes=MODES,
            softenings=SOFTENINGS, **extra):
        mode, dim, eps, seed = ladder.next(modes, softenings)
        case = EdgeCase(kernel, route, tuple(shape), dim, mode, eps, equal,
                        seed, "", tuple(sorted((flags or {}).items())),
                        tuple(sorted(extra.items())))
        out.append(dataclasses.replace(case, design=case.routed()))

    for n in SYM_NS:
        for equal in (True, False):
            add("sym_force", "sym_design", (n,), equal)
    for n in SYM_NS[:3]:
        add("sym_force", "sym_schedule", (n,), False)
    for n in (16384, 16448):
        add("sym_force", "uniform_design", (n,), True)
    for n in FUSED_NS:
        for equal in (True, False):
            add("sym_force_max", "sym_design", (n,), equal,
                {"fused_max": True}, modes=int_modes)
    for skip in (1, 0):
        add("redo", "sym_design", (FUSED_NS[0],), False, {"flagged": True},
            modes=int_modes, skip=skip)
    for n in MAX_D2_NS:
        add("max_d2", "max_d2_design", (n,), False)
    # The 64-point tile's edge again, at the ladder's next draw (D=3).
    add("max_d2", "max_d2_design", (MAX_D2_NS[0],), False)
    for n in PRUNED_NS:
        add("pruned", "max_d2_design", (n,), False)
    for n, chunk in CHUNKED:
        for equal in (True, False):
            add("chunked", "pair_design", (n,), equal, softenings=soft,
                chunk=chunk)
    for a, b in ((16448, 16448), (16384, 16384), (16448, 100)):
        add("pair_sym_force", "pair_design", (a, b), False, softenings=soft)
    split_row = first_split(hn.row_segments)
    for n in (split_row - 1, split_row):
        add("row_force", "row_segments", (n,), False)
    split_pair = first_split(hn.row_segments, 300)
    for n in (split_pair - 1, split_pair):
        add("pair_force", "row_segments", (300, n), False, softenings=soft)
    split_max = first_split(hn.pair_max_segments, 300)
    for n in (split_max - 1, split_max):
        add("pair_max", "pair_max_segments", (300, n), False)
    split_pe = first_split(hn.pe_segments, hn.TILED_MIN_N + 1)
    for n in (split_pe - 1, split_pe):
        add("pair_pe_rows", "pe_segments", (hn.TILED_MIN_N + 1, n), False,
            pattern="own")
    add("row_force", "row_segments", (SEGMENTED,), False)
    add("pair_force", "row_segments", (SEGMENTED, SEGMENTED), False,
        softenings=soft)
    add("pair_max", "pair_max_segments", (SEGMENTED, SEGMENTED), False)
    add("pair_pe_rows", "pe_segments", (SEGMENTED, SEGMENTED), False,
        pattern="permuted")
    for n in PE_NS:
        for pattern in PE_ID_PATTERNS:
            add("pair_pe_rows", "pe_design", (n, n), False, pattern=pattern)
    for n, shards in RING_MESHES:
        for schedule in MESH_SCHEDULES:
            add("ring", "pe_design", (n, shards), False,
                schedule=schedule)
    for levels in (hn.INT_TABLE_MAX_LEVELS, hn.INT_TABLE_MAX_LEVELS + 1):
        for equal in (True, False):
            add("int_table", "int_chain_design", (TABLE_N,), equal,
                modes=[Precision.CUSTOM], softenings=soft, levels=levels,
                pattern="cloud")
    for pattern in TABLE_PATTERNS[1:]:
        for equal in (True, False):
            add("int_table", "int_chain_design", (TABLE_N,), equal,
                modes=int_modes, softenings=soft, pattern=pattern)
    return out
