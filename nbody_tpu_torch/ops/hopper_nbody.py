"""Hand-written Hopper kernels of the direct engine, with their plain twins.

PyTorch counterpart of ``nbody_tpu.ops.pallas_nbody``. Five CUDA sources
replace the TPU kernels of the direct engine's paths and of the
multi-device ring (``parallel/ring.py``):

* ``sym_force`` — ``csrc/sym_force.cu``, replacing ``_force_kernel_sym`` /
  ``pallas_accelerations_sym`` (#1): softened all-pairs gravity, each
  unordered pair's weight evaluated once (Newton's third law), with the
  precision hook in the tile; its equal-mass variant (``uniform``), its
  fused max of raw d^2 (``max_out``) and a device skip flag. An unflagged
  launch runs one block per tile pair I <= J (``sym_schedule``); past that
  grid's edge a launch over a multiple of TILE without skip or count, of
  either kind of masses and with or without the fused max, the one-pass
  design (``sym_design``, ``csrc/one_pass.cuh``).
* ``max_d2`` — ``csrc/max_dist_sq.cu``, replacing ``_max_kernel`` /
  ``pallas_max_dist_sq`` (#2) and its streamed twin
  ``pallas_max_dist_sq_streamed`` (#3): the global max of the raw
  pairwise d^2, the int-sim log grid's upper bound; past TILED_MIN_N
  points on pair_max's register-tiled body (``max_d2_design``).
* ``pair_max`` — a second entry of ``csrc/max_dist_sq.cu``, replacing
  ``_pair_max_kernel`` / ``pallas_pair_max`` (#9): the max of raw d^2
  between two sets over valid pairs, the ring's bounds tile; one
  register-tiled launch, its source segments by ``pair_max_segments``.
* ``row_force`` — ``csrc/row_force.cu``, replacing ``_force_kernel`` /
  ``pallas_accelerations`` (#8) and ``_force_kernel_streamed`` /
  ``pallas_accelerations_streamed`` (#4): every ordered pair, the path of
  zero and run-time softening; register-tiled, the sources cut into
  segments by ``row_segments``.
* ``pair_force`` — the same ``csrc/row_force.cu`` kernel on two sets,
  replacing ``_force_kernel`` / ``pallas_pair_force`` (#10): receivers'
  accelerations due to sources, the ring's rows-schedule tile.
* ``pair_sym_force`` — ``csrc/pair_sym_force.cu``, replacing
  ``_pair_force_sym_kernel`` / ``pallas_pair_force_sym`` (#6): two
  disjoint sets, rows and reactions from one evaluation of each pair, with
  unequal masses or its equal-mass variant (``uniform``), either in the
  one-pass design at large N (``pair_design``).
* ``pair_pe_rows`` — ``csrc/pair_pe_rows.cu``, replacing
  ``_pair_pe_kernel`` / ``pallas_pair_pe_rows`` (#7): per-receiver
  potential-energy row sums with an id mask, the ring's energy tile and
  the single-device snapshot's past TILED_MIN_N particles; register-tiled
  past TILED_MIN_N receivers (``pe_design``), the mask only on the tiles
  whose id ranges meet (``id_ranges``).

Each kernel has a plain PyTorch version of the same function and
signature (``*_plain``). A wrapper launches the kernel for a CUDA tensor
(or raises) and takes the plain version only for a CPU tensor; there is
no fallback from a failed launch. Every launch adds one to
``LAUNCHES[name]``, each variant under its own name, so a run can show
that it went through the kernels. The kernel sources carry the notes on
design and numerics.

Equal masses: ``uniform=True`` on the sym kernels' wrappers is the
caller's assertion that every G*m is equal; the variant serves only sizes
that are multiples of ``TILE`` and a wrapper takes the general kernel
otherwise, bit for bit what it gives without the flag (the full-tile
rule, the counterpart of the TPU wrappers' degrade-on-padding). The
public functions that take ``uniform_gm`` check the assertion on the host
first (``check_uniform_gm``); the engine checks once at set-up and calls
their unguarded inner functions (``prevalidated``).

The public functions are the counterparts of the JAX wrappers:
``sym_accelerations`` (#1), ``accelerations_rows`` (#8),
``accelerations_streamed`` (#4), ``sym_accelerations_chunked`` (#5, a
composition of #1 and #6 past one launch's scratch budget),
``max_dist_sq``, and the ring's tiles ``pair_force`` (#10), ``pair_max``
(#9) and ``pair_pe_rows`` (#7), with JAX's signatures;
``max_pairwise_dist_sq_pruned``, the int modes' bounds pass around the
max_d2 kernel, lives here beside it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.ops.precision import (
    Precision,
    Quantizer,
    dist_sq_log_bounds,
    quantize_force,
)
from nbody_tpu_torch.utils.profiler import span

# Launches of each kernel in this process (reset by whoever reads them);
# the sym kernels count each variant apart: "_uniform" the equal-mass one,
# "_max" a launch with the fused max.
LAUNCHES = {"sym_force": 0, "sym_force_uniform": 0, "sym_force_max": 0,
            "sym_force_uniform_max": 0, "max_d2": 0, "row_force": 0,
            "pair_sym_force": 0, "pair_sym_force_uniform": 0,
            "pair_force": 0, "pair_max": 0, "pair_pe_rows": 0}

# Full-set max_d2 launches that ran (were not skipped) inside the pruned
# bounds pass, per device: a device int32 the kernel increments, so the
# count costs no launch and no host sync. Read with bounds_fallbacks().
BOUNDS_FALLBACKS: dict = {}

# sym_force launches given a skip flag that ran (were not skipped), per
# device: the cached-bounds scan's redo launches, counted by the kernel in
# a device int32 like BOUNDS_FALLBACKS. Read with redo_launches().
REDO_LAUNCHES: dict = {}

# Per-block maxima scratch of max_d2: the kernel's grid-stride loop uses
# at most this many blocks.
MAX_D2_BLOCKS = 1024
# max_d2's tile side: 64 points up to this N, so that the pruned pass's
# 1024 candidates spread over 136 tile pairs (blocks) instead of 10; 256
# beyond, the tile of the large-N passes.
MAX_D2_SMALL_N = 4096

# max_d2's integer ticket, per device: zeroed once when allocated, left
# at 0 by every launch (csrc/max_dist_sq.cu). The register-tiled pair_max
# and the one-pass sym_force's fused max fold by the same ticket. Two
# launches that share it must not run at once on different streams; the
# port launches only on the current stream.
TICKETS: dict = {}

# BT of csrc/nbody_common.cuh: the tile of the Newton's-third-law kernels.
TILE = 64
# An unflagged sym_force launch over at most this many tiles (N <= 16384)
# takes the triangular grid; larger ones the T x T grid: at T of 2048 to
# 3277 the triangle was no faster on the H100 (csrc/sym_force.cu's header).
TRIANGLE_MAX_TILES = 256
# Source tiles one block of pair_sym_force walks (its row partials are
# per segment of this many tiles).
PAIR_SEGMENT_TILES = 32
# The one-pass design of the equal-mass variants and of the general pair
# tile (csrc/one_pass.cuh): receivers a block (OP_RW), and source tiles a
# block walks.
ONE_PASS_RECEIVERS = 256
ONE_PASS_SEGMENT_TILES = 16
# (mode family, D) whose sym_force launches without skip or count (either
# kind of masses, with or without the fused max), and whose
# pair_sym_force launches of either kind, over more than ONE_PASS_MIN_TILES
# receiver tiles take the one-pass design (``sym_design``,
# ``pair_design``); the others keep the two-pass tile. The edge is the
# triangle's: sym_force at T <= 256 keeps the triangular grid (the fused
# max there the T x T grid).
ONE_PASS_MIN_TILES = TRIANGLE_MAX_TILES
ONE_PASS_ROUTES = frozenset({("float", 2), ("float", 3), ("int", 2),
                             ("int", 3)})
# The register-tiled row sweep (csrc/row_force.cu's row_tiled): receivers a
# block (4 a thread, 128 threads), sources a staged tile (the inner sum),
# and the blocks that row_segments aims the grid at (receiver blocks x
# source segments: ~12 waves of the H100's 1320 resident blocks at D=2
# float32, so that the last wave's idle share stays small, where 4096
# blocks would leave a tenth-full fourth wave).
ROW_BLOCK_RECEIVERS = 512
ROW_SOURCE_TILE = 128
ROW_TARGET_BLOCKS = 16384
# The register-tiled pair_max (csrc/max_dist_sq.cu's pair_max_tiled): the
# same geometry as the row sweep's, 512 receivers a block and 128-source
# tiles, its segments by pair_max_segments toward this many blocks (7.8
# waves of the 2112 resident 128-thread blocks at 131072^2).
PAIR_MAX_RECEIVERS = 512
PAIR_MAX_SOURCE_TILE = 128
PAIR_MAX_TARGET_BLOCKS = 16384
# Past this many points (receivers) max_d2 and pair_pe_rows take their
# register-tiled designs (``max_d2_design``, ``pe_design``); smaller
# launches keep theirs bit for bit. The one-pass edge of the sym kernels.
TILED_MIN_N = ONE_PASS_MIN_TILES * TILE
# max_d2's register-tiled launch (csrc/max_dist_sq.cu's max_d2_tiled):
# persistent blocks of 128 threads, this many a SM (the card's SM count
# read once a device), walking the triangle's 512-point unit pairs; a
# skipped launch reads its flag in that many blocks: 924 on the H100's
# 132 SMs, fewer than max_d2_single's capped 1024 (8 a SM ran 0.8%
# faster at 131072 but made a skipped launch 0.9% dearer than that one's).
MAX_D2_TILED_PER_SM = 7
# The pruned bounds pass's candidates (max_pairwise_dist_sq_pruned): up to
# this N one max_d2 launch on every point, beyond it two (the candidates,
# and the full set behind the admitted-count flag).
PRUNED_CANDIDATES = 1024
# The register-tiled pair_pe_rows (csrc/pair_pe_rows.cu's pair_pe_tiled):
# the row sweep's geometry, 512 receivers a block and 128-source tiles,
# its segments by pe_segments toward this many blocks.
PE_RECEIVERS = 512
PE_SOURCE_TILE = 128
PE_TARGET_BLOCKS = 16384
# The row sweep's design for every launch that does not pass parent=True:
# "tiled" (row_tiled), or "per_receiver" (the earlier kernel, one thread a
# receiver), which an A/B of a whole path sets for that path's run.
ROW_DESIGN = "tiled"
# Bytes of per-tile partials one force evaluation may hold on the card:
# sym_force alone while its scratch fits (the "auto" routing), else the
# chunked path's diagonal sym_force plus one pair tile together. 16 GB of
# the H100's 80 GB leaves room for the state at any N the card can hold.
SCRATCH_BUDGET = 16_000_000_000

_MODE_CODES = {
    Precision.FLOAT64: 0, Precision.FLOAT32: 0,
    Precision.BFLOAT16: 1, Precision.FLOAT16: 2,
}
_MODE_INT = 3


def _mode_code(q: Quantizer) -> int:
    return _MODE_INT if q.is_int else _MODE_CODES[q.mode]


def _arg_cap(q: Quantizer) -> float:
    """-1.5 * log(min_dist_sq): the exponent cap of the folded int chain."""
    return -1.5 * math.log(q.min_dist_sq)


def _tiles(n: int) -> int:
    return -(-n // TILE)


def sym_schedule(n: int) -> str:
    """The grid of an unflagged sym_force launch over n particles, a fixed
    function of T = ceil(n / TILE): "triangle" (one block per tile pair
    I <= J) up to TRIANGLE_MAX_TILES, else "square" (the T x T grid, the
    earlier design). Both are followed by the same fixed-order reduction
    and give the same bits."""
    return "triangle" if _tiles(n) <= TRIANGLE_MAX_TILES else "square"


def uniform_design(tiles: int, q: Quantizer, dim: int) -> str:
    """The design of an unflagged equal-mass launch (sym_force_uniform over
    ``tiles`` tiles, or pair_sym_force_uniform over ``tiles`` receiver
    tiles), a fixed function of (T, mode, D): "one_pass" (csrc/one_pass.cuh:
    t = w diff formed once, added into the rows and the reactions in the same
    iteration) past ONE_PASS_MIN_TILES for the (mode family, D) in
    ONE_PASS_ROUTES, else "two_pass" (the earlier design: the w tile in
    shared memory, a reaction pass after the row pass)."""
    family = "int" if q.is_int else "float"
    return ("one_pass" if tiles > ONE_PASS_MIN_TILES
            and (family, dim) in ONE_PASS_ROUTES else "two_pass")


def sym_design(n: int, dim: int, q: Quantizer, flagged: bool = False,
               parent: bool = False, fused_max: bool = False) -> str:
    """What a sym_force launch over n particles runs on the card, a fixed
    function of (n, mode family, D) and its flags: "one_pass" (n a multiple
    of TILE that uniform_design routes there, either kind of masses, with
    or without the fused max: csrc/one_pass.cuh's body, with G m per
    particle for unequal masses), "triangle" (any other launch without
    the fused max that sym_schedule routes there), else "square": the
    T x T grid of the two-pass tile, which a ``flagged`` launch (skip or
    count: the cached redo, walking the tile pairs under a skip flag
    without the fused max) and ``parent=True`` always take, and the fused
    max at T <= 256 (csrc/sym_force.cu). Each design serves both kinds of
    masses, so the kind picks no route."""
    if flagged or parent:
        return "square"
    if n % TILE == 0 and uniform_design(_tiles(n), q, dim) == "one_pass":
        return "one_pass"
    return "square" if fused_max else sym_schedule(n)


def pair_design(n_a: int, n_b: int, dim: int, q: Quantizer,
                parent: bool = False) -> str:
    """What a pair_sym_force launch runs on the card, either kind:
    "one_pass" (sets that are multiples of TILE that uniform_design routes
    there by their receiver tiles: the equal-mass variant's one-pass body,
    or with unequal masses the same body with G m per particle), else
    "two_pass", which ``parent=True`` always takes."""
    if (not parent and n_a % TILE == 0 and n_b % TILE == 0
            and uniform_design(_tiles(n_a), q, dim) == "one_pass"):
        return "one_pass"
    return "two_pass"


def _one_pass_tiles(receiver_tiles: int) -> int:
    return -(-receiver_tiles // (ONE_PASS_RECEIVERS // TILE))


def sym_one_pass_scratch(n: int, dim: int) -> tuple:
    """Shapes of the one-pass sym_force's scratch over n particles, either
    kind: row partials (TI, nsegmax, ONE_PASS_RECEIVERS, dim) and reaction
    partials (T, TI, TILE, dim) f32, T = n / TILE, TI = ceil(T / 4),
    nsegmax = ceil(T / ONE_PASS_SEGMENT_TILES); the fused max adds one f32
    a block, TI x nsegmax."""
    t = _tiles(n)
    ti = _one_pass_tiles(t)
    return ((ti, -(-t // ONE_PASS_SEGMENT_TILES), ONE_PASS_RECEIVERS, dim),
            (t, ti, TILE, dim))


def pair_one_pass_scratch(n_a: int, n_b: int, dim: int) -> tuple:
    """Shapes of the one-pass pair_sym_force's scratch, either kind: row
    partials (TI, nseg, ONE_PASS_RECEIVERS, dim) and reaction partials
    (Tb, TI, TILE, dim) f32, TI = ceil(Ta / 4),
    nseg = ceil(Tb / ONE_PASS_SEGMENT_TILES)."""
    ti, tb = _one_pass_tiles(_tiles(n_a)), _tiles(n_b)
    return ((ti, -(-tb // ONE_PASS_SEGMENT_TILES), ONE_PASS_RECEIVERS, dim),
            (tb, ti, TILE, dim))


def _segments(n_i: int, n_j: int, receivers: int, tile: int,
              target: int) -> tuple:
    """(segments, source tiles a segment): the ceil(n_j / tile) source
    tiles cut into as many segments as bring the ceil(n_i / receivers)
    receiver blocks up to ``target`` blocks, at most one a tile."""
    blocks = -(-n_i // receivers)
    tiles = -(-n_j // tile)
    want = min(tiles, max(1, -(-target // blocks)))
    seg = -(-tiles // want)
    return -(-tiles // seg), seg


def row_segments(n_i: int, n_j: int) -> tuple:
    """(segments, source tiles a segment) of a register-tiled row_force /
    pair_force launch over n_i receivers and n_j sources, a fixed function
    of the two (``_segments`` toward ROW_TARGET_BLOCKS blocks of
    ROW_BLOCK_RECEIVERS, tiles of ROW_SOURCE_TILE). 131072^2: 64 segments
    of 16 tiles (16384 blocks); 1M^2: 8 of 1024."""
    return _segments(n_i, n_j, ROW_BLOCK_RECEIVERS, ROW_SOURCE_TILE,
                     ROW_TARGET_BLOCKS)


def pair_max_segments(n_i: int, n_j: int) -> tuple:
    """(segments, source tiles a segment) of the register-tiled pair_max
    over n_i receivers and n_j sources, a fixed function of the two
    (``_segments`` toward PAIR_MAX_TARGET_BLOCKS blocks of
    PAIR_MAX_RECEIVERS, tiles of PAIR_MAX_SOURCE_TILE). 131072^2: 64
    segments of 16 tiles (16384 blocks); the S=4 shard of 131075,
    32769^2: 129 of 2."""
    return _segments(n_i, n_j, PAIR_MAX_RECEIVERS, PAIR_MAX_SOURCE_TILE,
                     PAIR_MAX_TARGET_BLOCKS)


def pe_segments(n_i: int, n_j: int) -> tuple:
    """(segments, source tiles a segment) of the register-tiled
    pair_pe_rows over n_i receivers and n_j sources, a fixed function of
    the two (``_segments`` toward PE_TARGET_BLOCKS blocks of PE_RECEIVERS,
    tiles of PE_SOURCE_TILE). 131072^2: 64 segments of 16 tiles; 1M^2: 8
    of 1024."""
    return _segments(n_i, n_j, PE_RECEIVERS, PE_SOURCE_TILE,
                     PE_TARGET_BLOCKS)


def pe_design(n_i: int, n_j: int, parent: bool = False) -> str:
    """What a pair_pe_rows launch over n_i receivers and n_j sources runs
    on the card: "tiled" (pair_pe_tiled: 4 receivers a thread, the id
    mask only on tiles whose id ranges meet) past TILED_MIN_N receivers,
    else "per_receiver" (the first design, one thread a receiver, the id
    compare on every pair), which ``parent=True`` always takes."""
    return "tiled" if n_i > TILED_MIN_N and not parent else "per_receiver"


def pe_scratch(n_i: int, n_j: int) -> tuple | None:
    """Shape of the register-tiled pair_pe_rows' segment sums,
    (ceil(n_i / PE_RECEIVERS), segments, PE_RECEIVERS) f32, or None for
    one segment (the kernel writes the rows itself)."""
    nseg, _ = pe_segments(n_i, n_j)
    if nseg == 1:
        return None
    return (-(-n_i // PE_RECEIVERS), nseg, PE_RECEIVERS)


def id_ranges(ids: torch.Tensor, width: int) -> torch.Tensor:
    """[min, max] of the ids in each run of ``width`` consecutive entries
    (the last run ragged), (ceil(n / width), 2) int32 on the ids' device:
    PyTorch ops, no host read. The ragged tail repeats the last id, so a
    run's range covers its real entries only."""
    pad = -ids.shape[0] % width
    if pad:
        ids = torch.cat([ids, ids[-1:].expand(pad)])
    runs = ids.view(-1, width)
    return torch.stack([runs.amin(dim=1), runs.amax(dim=1)], 1).contiguous()


def row_scratch(n_i: int, n_j: int, dim: int) -> tuple | None:
    """Shape of the register-tiled row sweep's segment sums,
    (ceil(n_i / ROW_BLOCK_RECEIVERS), segments, ROW_BLOCK_RECEIVERS, dim)
    f32, or None for one segment (the kernel writes the rows itself)."""
    nseg, _ = row_segments(n_i, n_j)
    if nseg == 1:
        return None
    return (-(-n_i // ROW_BLOCK_RECEIVERS), nseg, ROW_BLOCK_RECEIVERS, dim)


def row_scratch_bytes(n_i: int, n_j: int, dim: int) -> int:
    """Bytes of row_scratch: 67.1 MB at 131072^2 (D=2), 100.7 MB at 1M^2
    (D=3), far inside SCRATCH_BUDGET."""
    shape = row_scratch(n_i, n_j, dim)
    return 0 if shape is None else 4 * math.prod(shape)


def max_d2_tile(n: int) -> int:
    """Tile side of max_d2's single launch over n points."""
    return 64 if n <= MAX_D2_SMALL_N else 256


def max_d2_design(n: int, parent: bool = False) -> str:
    """What a max_d2 launch over n points runs on the card, a fixed
    function of n: "single_64" (one launch, 64-point tiles) to
    MAX_D2_SMALL_N, "single_256" (256-point tiles) to TILED_MIN_N, else
    "tiled" (pair_max's register-tiled body over the triangle of 512-point
    units). ``parent=True`` reaches the design each replaced: "two_launch"
    (the T x T grid of 256-point tiles, then the reduction) to
    TILED_MIN_N, "single_256" beyond. Every design gives the same bits."""
    if n <= TILED_MIN_N:
        return ("two_launch" if parent else
                f"single_{max_d2_tile(n)}")
    return "single_256" if parent else "tiled"


@functools.lru_cache(maxsize=None)
def max_d2_tiled_blocks(device: torch.device) -> int:
    """The grid cap of max_d2's register-tiled launch on ``device``:
    MAX_D2_TILED_PER_SM blocks a SM (the SM count read once)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return MAX_D2_TILED_PER_SM * sms


def ticket(device: torch.device) -> torch.Tensor:
    """The device's max_d2 ticket (TICKETS), zeroed when allocated: here,
    at a first call, never inside a launch."""
    return _device_counter(TICKETS, device)


def sym_force_scratch_bytes(n: int, dim: int) -> int:
    """Per-tile partials of one sym_force launch over n particles:
    (T, T, TILE, dim) f32 with T = ceil(n / TILE), the two-pass design's
    and an upper bound of the one-pass design's (sym_one_pass_scratch)."""
    t = _tiles(n)
    return 4 * dim * t * t * TILE


def pair_sym_force_scratch_bytes(n_a: int, n_b: int, dim: int) -> int:
    """Per-tile partials of one pair_sym_force launch: row partials
    (Ta, nseg, TILE, dim) and reaction partials (Tb, Ta, TILE, dim) f32,
    the two-pass design's and an upper bound of the one-pass design's
    wherever uniform_design routes to it (pair_one_pass_scratch)."""
    ta, tb = _tiles(n_a), _tiles(n_b)
    nseg = -(-tb // PAIR_SEGMENT_TILES)
    return 4 * dim * TILE * (ta * nseg + tb * ta)


def sym_force_fits(n: int, dim: int) -> bool:
    """Whether one sym_force launch over n particles fits SCRATCH_BUDGET
    (the port's counterpart of SYM_RESIDENT_VMEM_BUDGET): up to ~357k
    particles at D=2 and ~292k at D=3."""
    return sym_force_scratch_bytes(n, dim) <= SCRATCH_BUDGET


def sym_chunk_size(n: int, dim: int) -> int:
    """Chunk of the chunked path: the largest multiple of TILE whose
    sym_force and pair_sym_force scratch together fit SCRATCH_BUDGET,
    then the fewest chunks of that size spread evenly over n (so the
    last chunk is not a sliver)."""
    def fits(k):
        c = k * TILE
        return (sym_force_scratch_bytes(c, dim)
                + pair_sym_force_scratch_bytes(c, c, dim)) <= SCRATCH_BUDGET

    lo, hi = 1, _tiles(n)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    n_chunks = -(-n // (lo * TILE))
    return _tiles(-(-n // n_chunks)) * TILE


def _check_f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_positions(pos: torch.Tensor) -> tuple:
    if pos.dim() != 2 or pos.shape[1] not in (2, 3) or pos.shape[0] < 1:
        raise ValueError(f"positions must be (N, 2) or (N, 3) with N >= 1, "
                         f"got {tuple(pos.shape)}")
    _check_f32("positions", pos, tuple(pos.shape), pos.device)
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pos.device}")
    return tuple(pos.shape)


def _check_force_args(pos, gm, bounds) -> tuple:
    n, dim = _check_positions(pos)
    _check_f32("gm", gm, (n,), pos.device)
    _check_f32("bounds", bounds, (3,), pos.device)
    return n, dim


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _library():
    from nbody_tpu_torch import _build
    lib = _build.library()
    if lib.nbody_sym_force_tile() != TILE:
        raise RuntimeError(f"csrc tile {lib.nbody_sym_force_tile()} != "
                           f"hopper_nbody.TILE {TILE}")
    if lib.nbody_one_pass_receivers() != ONE_PASS_RECEIVERS:
        raise RuntimeError(f"csrc one-pass receivers "
                           f"{lib.nbody_one_pass_receivers()} != "
                           f"hopper_nbody.ONE_PASS_RECEIVERS "
                           f"{ONE_PASS_RECEIVERS}")
    for what, got, want in (
            ("row_tiled", lib.nbody_row_force_geometry(),
             (ROW_BLOCK_RECEIVERS, ROW_SOURCE_TILE)),
            ("pair_max_tiled", lib.nbody_pair_max_geometry(),
             (PAIR_MAX_RECEIVERS, PAIR_MAX_SOURCE_TILE)),
            ("pair_pe_tiled", lib.nbody_pair_pe_geometry(),
             (PE_RECEIVERS, PE_SOURCE_TILE))):
        if divmod(got, 65536) != want:
            raise RuntimeError(f"csrc {what} (receivers a block, tile) "
                               f"{divmod(got, 65536)} != hopper_nbody's "
                               f"{want}")
    return lib


def _int_args(q: Quantizer) -> tuple:
    return _mode_code(q), q.levels, _arg_cap(q), q.min_dist_sq


def _opt_ptr(t: torch.Tensor | None):
    return None if t is None else _ptr(t)


# --------------------------------------------------------------------------
# The equal-mass assertion
# --------------------------------------------------------------------------

def check_uniform_gm(values, what: str = "masses") -> None:
    """Host-side guard of the equal-mass fast path (the counterpart of
    ``pallas_nbody.check_uniform_gm``): the variants scale every pair by
    the first entry's G*m, so unequal values with ``uniform_gm=True`` would
    be wrong physics, not an error. Raises ValueError when the values
    differ. It reads them on the host (a sync for a CUDA tensor), so the
    engine checks once at set-up and never inside a tick."""
    if values is None:
        return
    m = torch.as_tensor(values).reshape(-1)
    if m.numel() and not bool((m == m[0]).all()):
        raise ValueError(
            f"uniform_gm=True asserts ALL {what} are equal, but the "
            f"concrete {what} differ (min {float(m.min())!r}, max "
            f"{float(m.max())!r}): the fast path would silently scale every "
            f"pair by {what}[0]. Pass uniform_gm=False (the general kernel), "
            f"or let DirectSimulation detect equal masses.")


def guard_uniform_gm(*groups):
    """Decorator of a public surface that takes ``uniform_gm``: when it is
    passed True by keyword, check_uniform_gm runs on each group's value
    before the call. A group is ``(label, lookups)``; the first lookup (a
    keyword name, or a positional index) that is not None gives the value,
    and a state gives its ``.masses``. A resident state padded past
    ``n_total`` is not checked: the ring runners switch the fast path off
    on phantom layouts. The undecorated function is ``prevalidated(fn)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if kwargs.get("uniform_gm"):
                n_total = kwargs.get("n_total")
                for label, lookups in groups:
                    val = None
                    for lk in lookups:
                        v = (kwargs.get(lk) if isinstance(lk, str)
                             else (args[lk] if lk < len(args) else None))
                        if v is not None:
                            val = getattr(v, "masses", v)
                            break
                    if not (n_total is not None and val is not None
                            and val.shape[0] != n_total):
                        check_uniform_gm(val, what=label)
            return fn(*args, **kwargs)
        return wrapper
    return deco


def prevalidated(fn):
    """The unguarded inner function of a guard_uniform_gm surface, for
    callers that checked the masses once already (the engine at set-up,
    a runner at its entry): the guard would read the device masses on the
    host on every call."""
    return getattr(fn, "__wrapped__", fn)


# --------------------------------------------------------------------------
# Plain versions of the force kernels
# --------------------------------------------------------------------------

def _int_grid(bounds: torch.Tensor, q: Quantizer) -> tuple:
    """The folded int chain's grid scalars, hoisted as the kernel hoists
    them (every op a single IEEE rounding, tensor by tensor)."""
    log_lo, log_hi = bounds[0], bounds[1]
    lvl = torch.full((), float(q.levels - 1), dtype=torch.float32,
                     device=bounds.device)
    safe_span = torch.clamp(log_hi - log_lo, min=1e-10)
    norm_a = lvl / safe_span
    norm_b = (-log_lo) * norm_a
    arg_k = (safe_span * -1.5) / lvl
    arg_0 = log_lo * -1.5
    arg_cap = torch.full((), _arg_cap(q), dtype=torch.float32,
                         device=bounds.device)
    return norm_a, norm_b, arg_k, arg_0, arg_cap


def _pair_weight(d2: torch.Tensor, q: Quantizer, grid) -> torch.Tensor:
    """w = quantized |r|^-3 of softened d^2, as the kernels compute it."""
    if q.is_int:
        norm_a, norm_b, arg_k, arg_0, arg_cap = grid
        log_d2 = torch.log(torch.clamp(d2, min=q.min_dist_sq))
        k = torch.round(log_d2 * norm_a + norm_b)
        return torch.exp(torch.minimum(k * arg_k + arg_0, arg_cap))
    if q.mode == Precision.BFLOAT16:
        d2 = d2.to(torch.bfloat16).to(torch.float32)
    elif q.mode == Precision.FLOAT16:
        d2 = d2.to(torch.float16).to(torch.float32)
    inv = torch.rsqrt(d2)
    return inv * inv * inv


def _diffs_w(pi: torch.Tensor, pos: torch.Tensor, soft, q: Quantizer, grid):
    """diff_ij = x_j - x_i per component and w_ij for receivers pi."""
    dim = pos.shape[1]
    diffs = [pos[None, :, d] - pi[:, d, None] for d in range(dim)]
    d2 = diffs[0] * diffs[0]
    for d in range(1, dim):
        d2 = d2 + diffs[d] * diffs[d]
    return diffs, _pair_weight(d2 + soft, q, grid)


def _plain_rows(recv, src, gm, bounds, q: Quantizer, self_ids, block: int,
                term) -> torch.Tensor:
    """sum_j term(gm_j w_ij diff_ij) per receiver and component, row-blocked
    over the receivers ``recv`` against every source of ``src``;
    ``self_ids`` (optional) gives each receiver's index in ``src``, whose
    own term is masked."""
    dim = src.shape[1]
    grid = _int_grid(bounds, q) if q.is_int else None
    src_ids = torch.arange(src.shape[0], device=src.device)
    out = torch.empty((recv.shape[0], dim), dtype=torch.float32,
                      device=src.device)
    for r0 in range(0, recv.shape[0], block):
        diffs, w = _diffs_w(recv[r0:r0 + block], src, bounds[2], q, grid)
        factor = gm[None, :] * w
        if self_ids is not None:
            factor = torch.where(self_ids[r0:r0 + block, None]
                                 == src_ids[None, :], 0.0, factor)
        out[r0:r0 + block] = torch.stack(
            [term(factor * diffs[d]).sum(dim=1) for d in range(dim)], dim=1)
    return out


def _one_set_rows(pos, gm, bounds, q: Quantizer, self_masked: bool,
                  block: int, term, rows=None) -> torch.Tensor:
    """_plain_rows with one set as receivers and sources; receivers are
    ``rows`` (indices) or all particles."""
    if rows is None:
        rows = torch.arange(pos.shape[0], device=pos.device)
    return _plain_rows(pos[rows], pos, gm, bounds, q,
                       rows if self_masked else None, block, term)


def row_force_plain(pos: torch.Tensor, gm: torch.Tensor,
                    bounds: torch.Tensor, q: Quantizer, self_masked: bool,
                    rows: torch.Tensor | None = None,
                    block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the row_force kernel (and of sym_force:
    both compute acc_i = sum_{j != i} gm_j w_ij (x_j - x_i)), row-blocked
    with O(block * N) memory.

    pos (N, D) f32, gm (N,) f32 = G*m, bounds (3,) f32 = [log_lo, log_hi,
    eps^2]; ``rows`` optionally selects receivers by index (all sources
    always act). Returns (len(rows) or N, D) f32, before any int-sim force
    quantization."""
    return _one_set_rows(pos, gm, bounds, q, self_masked, block,
                         lambda t: t, rows)


def sym_force_plain(pos: torch.Tensor, gm: torch.Tensor,
                    bounds: torch.Tensor, q: Quantizer, self_masked: bool,
                    block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the sym_force kernel (row_force_plain:
    the same function, in another summation order)."""
    return row_force_plain(pos, gm, bounds, q, self_masked, block=block)


def sym_force_term_scale(pos: torch.Tensor, gm: torch.Tensor,
                         bounds: torch.Tensor, q: Quantizer,
                         self_masked: bool, rows: torch.Tensor | None = None,
                         block: int = 1024) -> torch.Tensor:
    """sum_j |gm_j w_ij (x_j - x_i)| per component: the scale of the
    rounding error that any summation order of a force row makes.
    Where terms cancel (near-coincident pairs at zero softening) |acc| is
    far below it, and a tolerance on |acc| alone would test the order."""
    return _one_set_rows(pos, gm, bounds, q, self_masked, block, torch.abs,
                         rows)


def pair_sym_force_plain(pos_a: torch.Tensor, gm_a: torch.Tensor,
                         pos_b: torch.Tensor, gm_b: torch.Tensor,
                         bounds: torch.Tensor, q: Quantizer,
                         block: int = 1024) -> tuple:
    """Plain PyTorch version of the pair_sym_force kernel: receivers A,
    sources B (disjoint sets, eps^2 > 0), row-blocked over A.

    Returns (rows, cols): rows (Na, D) = sum_j gm_b_j w_ij (x_j - x_i),
    cols (Nb, D) = -sum_i gm_a_i w_ij (x_j - x_i), both f32."""
    dim = pos_a.shape[1]
    grid = _int_grid(bounds, q) if q.is_int else None
    rows = torch.empty_like(pos_a)
    cols = torch.zeros_like(pos_b)
    for r0 in range(0, pos_a.shape[0], block):
        diffs, w = _diffs_w(pos_a[r0:r0 + block], pos_b, bounds[2], q, grid)
        fr = gm_b[None, :] * w
        fc = gm_a[r0:r0 + block, None] * w
        rows[r0:r0 + block] = torch.stack(
            [(fr * diffs[d]).sum(dim=1) for d in range(dim)], dim=1)
        cols = cols - torch.stack(
            [(fc * diffs[d]).sum(dim=0) for d in range(dim)], dim=1)
    return rows, cols


def sym_force_uniform_plain(pos: torch.Tensor, gm: torch.Tensor,
                            bounds: torch.Tensor, q: Quantizer,
                            self_masked: bool,
                            block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of sym_force's equal-mass variant:
    acc_i = G m_0 sum_j w_ij (x_j - x_i), the sum taken before the single
    scale (pallas_nbody.py:632-634)."""
    return row_force_plain(pos, torch.ones_like(gm), bounds, q, self_masked,
                           block=block) * gm[0]


def pair_sym_force_uniform_plain(pos_a: torch.Tensor, gm_a: torch.Tensor,
                                 pos_b: torch.Tensor, gm_b: torch.Tensor,
                                 bounds: torch.Tensor, q: Quantizer,
                                 block: int = 1024) -> tuple:
    """Plain PyTorch version of pair_sym_force's equal-mass variant: the
    sums of w_ij (x_j - x_i), rows scaled once by G m_b[0] and reactions by
    G m_a[0] (pallas_nbody.py:1160-1161)."""
    rows, cols = pair_sym_force_plain(pos_a, torch.ones_like(gm_a), pos_b,
                                      torch.ones_like(gm_b), bounds, q,
                                      block=block)
    return rows * gm_b[0], cols * gm_a[0]


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _variant(name: str, uniform: bool, fused_max: bool = False) -> str:
    """The LAUNCHES key of one launch of a sym kernel."""
    return name + "_uniform" * uniform + "_max" * fused_max


def _plain_skip(acc: torch.Tensor, skip, count) -> torch.Tensor:
    """A skip flag and a run counter on a plain result, as the kernels
    honour them: zeros when skipped, count + 1 when not."""
    if count is not None:
        count += 1 if skip is None else (skip == 0).to(torch.int32)
    return acc if skip is None else torch.where(skip != 0, 0.0, acc)


def sym_force(pos: torch.Tensor, gm: torch.Tensor, bounds: torch.Tensor,
              q: Quantizer, self_masked: bool, uniform: bool = False,
              max_out: torch.Tensor | None = None,
              skip: torch.Tensor | None = None,
              count: torch.Tensor | None = None,
              parent: bool = False) -> torch.Tensor:
    """Kernel #1 wrapper: CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. Same arguments and result as sym_force_plain.

    ``uniform=True`` asserts that every gm is equal (unchecked here) and
    takes the equal-mass variant (sym_force_uniform_plain) when N is a
    multiple of TILE, else the general kernel. ``max_out``, an optional
    0-d f32 on the device, receives the max of the raw pairwise d^2 from
    the same launch, bitwise max_d2's (the forces are the same bits with or
    without it). ``skip`` and ``count`` are optional int32 flags on the
    device, as max_d2's: when *skip != 0 the launch returns at once with
    zero forces (and a zero max); count gains 1 when it ran. A launch with
    ``skip`` and no ``max_out`` walks the tile pairs with a capped grid,
    so that a skipped launch costs microseconds (csrc/sym_force.cu).

    The design is ``sym_design``'s: past 256 tiles a launch over a
    multiple of TILE without skip or count takes the one-pass design
    (either kind, with or without the fused max: the body and its
    reduction, the fused max folded by max_d2's ticket in the body), else
    ``sym_schedule(N)``'s grid; ``parent=True`` takes the T x T grid of the
    two-pass tile (the earlier designs: the same bits as the triangle,
    another summation order than the one-pass design) to compare them."""
    n, dim = _check_force_args(pos, gm, bounds)
    # The engine's tick calls this with no flag and no fused max: that path
    # pays for none of their checks.
    extras = max_out is not None or skip is not None or count is not None
    if extras:
        _check_flag("skip", skip, pos.device)
        _check_flag("count", count, pos.device)
        if max_out is not None:
            _check_f32("max_out", max_out, (), pos.device)
            if not q.is_int:
                raise ValueError("the fused max serves the int-sim modes "
                                 "only")
    uniform = uniform and n % TILE == 0
    if pos.device.type == "cpu":
        plain = sym_force_uniform_plain if uniform else sym_force_plain
        acc = plain(pos, gm, bounds, q, self_masked)
        if max_out is not None:
            max_out.copy_(max_d2_plain(pos, skip))
        return _plain_skip(acc, skip, count)
    lib = _library()
    tiles = _tiles(n)
    fused = max_out is not None
    design = sym_design(n, dim, q, skip is not None or count is not None,
                        parent, fused)
    if design == "one_pass":
        with torch.cuda.device(pos.device):
            rpart, cpart = (torch.empty(shape, dtype=torch.float32,
                                        device=pos.device)
                            for shape in sym_one_pass_scratch(n, dim))
            out = torch.empty_like(pos)
            block_max = (torch.empty(rpart.shape[0] * rpart.shape[1],
                                     dtype=torch.float32, device=pos.device)
                         if fused else None)
            rc = lib.nbody_sym_force_one_pass(
                _ptr(pos), _ptr(gm), _ptr(bounds), n, dim, *_int_args(q),
                int(self_masked), int(uniform), ONE_PASS_SEGMENT_TILES,
                _ptr(rpart), _ptr(cpart), _opt_ptr(block_max),
                _ptr(ticket(pos.device)) if fused else None,
                _opt_ptr(max_out), _ptr(out), _stream(pos.device))
        _raise_on(rc, "sym_force")
        LAUNCHES[_variant("sym_force", uniform, fused)] += 1
        return out
    with torch.cuda.device(pos.device):
        part = torch.empty((tiles, tiles, TILE, dim), dtype=torch.float32,
                           device=pos.device)
        out = torch.empty_like(pos)
        skip_p = count_p = tile_max_p = block_max_p = max_out_p = None
        triangle = design == "triangle"
        if extras:
            skip_p, count_p = _opt_ptr(skip), _opt_ptr(count)
            if max_out is not None:
                tile_max = torch.empty(tiles * (tiles + 1) // 2,
                                       dtype=torch.float32, device=pos.device)
                block_max = torch.empty(MAX_D2_BLOCKS, dtype=torch.float32,
                                        device=pos.device)
                tile_max_p, block_max_p = _ptr(tile_max), _ptr(block_max)
                max_out_p = _ptr(max_out)
        rc = lib.nbody_sym_force(
            _ptr(pos), _ptr(gm), _ptr(bounds), n, dim, *_int_args(q),
            int(self_masked), int(uniform), skip_p, count_p, _ptr(part),
            tile_max_p, block_max_p, MAX_D2_BLOCKS, max_out_p,
            int(triangle), _ptr(out), _stream(pos.device))
    _raise_on(rc, "sym_force")
    LAUNCHES[_variant("sym_force", uniform, fused)] += 1
    return out


def row_force(pos: torch.Tensor, gm: torch.Tensor, bounds: torch.Tensor,
              q: Quantizer, self_masked: bool,
              parent: bool = False) -> torch.Tensor:
    """Kernels #4 / #8 wrapper: CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Same arguments and result as
    row_force_plain (all rows). The register-tiled design (its segment
    reduction included: one count a call); ``parent=True`` takes the
    earlier kernel, one thread a receiver, to compare them."""
    n, dim = _check_force_args(pos, gm, bounds)
    if pos.device.type == "cpu":
        return row_force_plain(pos, gm, bounds, q, self_masked)
    out = _launch_rows(pos, pos, gm, bounds, q, self_masked, "row_force",
                       parent)
    LAUNCHES["row_force"] += 1
    return out


def _launch_rows(recv, src, gm, bounds, q: Quantizer, self_masked: bool,
                 what: str, parent: bool) -> torch.Tensor:
    """One call of csrc/row_force.cu: recv's accelerations due to src, in
    the register-tiled design (ROW_DESIGN, unless ``parent``) or the
    earlier kernel."""
    lib = _library()
    n_i, n_j, dim = recv.shape[0], src.shape[0], recv.shape[1]
    with torch.cuda.device(recv.device):
        out = torch.empty_like(recv)
        if parent or ROW_DESIGN != "tiled":
            rc = lib.nbody_row_force(
                _ptr(recv), n_i, _ptr(src), _ptr(gm), n_j, _ptr(bounds), dim,
                *_int_args(q), int(self_masked), _ptr(out),
                _stream(recv.device))
        else:
            shape = row_scratch(n_i, n_j, dim)
            rpart = (None if shape is None else
                     torch.empty(shape, dtype=torch.float32,
                                 device=recv.device))
            rc = lib.nbody_row_force_tiled(
                _ptr(recv), n_i, _ptr(src), _ptr(gm), n_j, _ptr(bounds), dim,
                *_int_args(q), int(self_masked), row_segments(n_i, n_j)[1],
                _opt_ptr(rpart), _ptr(out), _stream(recv.device))
    _raise_on(rc, what)
    return out


def _check_two_sets(receivers, sources, n_what: str = "sources") -> tuple:
    """(n_i, n_j, dim) of two f32 position sets on one device."""
    n_i, dim = _check_positions(receivers)
    n_j, dim_j = _check_positions(sources)
    if dim_j != dim:
        raise ValueError(f"receivers are {dim}-D, {n_what} {dim_j}-D")
    _check_f32(n_what, sources, (n_j, dim), receivers.device)
    return n_i, n_j, dim


def pair_sym_force(pos_a: torch.Tensor, gm_a: torch.Tensor,
                   pos_b: torch.Tensor, gm_b: torch.Tensor,
                   bounds: torch.Tensor, q: Quantizer,
                   uniform: bool = False, parent: bool = False) -> tuple:
    """Kernel #6 wrapper: CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Same arguments and result (rows, cols) as
    pair_sym_force_plain. ``uniform=True`` asserts that each set's gm is
    equal (unchecked here) and takes the equal-mass variant
    (pair_sym_force_uniform_plain) when both set sizes are multiples of
    TILE, else the general kernel. Either kind takes ``pair_design``'s
    design (the one-pass body for sets that are multiples of TILE past
    ONE_PASS_MIN_TILES receiver tiles, by ``uniform_design``), and
    ``parent=True`` the two-pass tile (the earlier design) to compare
    them."""
    _check_force_args(pos_a, gm_a, bounds)
    n_a, n_b, dim = _check_two_sets(pos_a, pos_b)
    _check_f32("gm_b", gm_b, (n_b,), pos_a.device)
    uniform = uniform and n_a % TILE == 0 and n_b % TILE == 0
    if pos_a.device.type == "cpu":
        plain = (pair_sym_force_uniform_plain if uniform
                 else pair_sym_force_plain)
        return plain(pos_a, gm_a, pos_b, gm_b, bounds, q)
    lib = _library()
    if pair_design(n_a, n_b, dim, q, parent) == "one_pass":
        with torch.cuda.device(pos_a.device):
            rpart, cpart = (torch.empty(shape, dtype=torch.float32,
                                        device=pos_a.device)
                            for shape in pair_one_pass_scratch(n_a, n_b, dim))
            rows = torch.empty_like(pos_a)
            cols = torch.empty_like(pos_b)
            rc = lib.nbody_pair_sym_force_one_pass(
                _ptr(pos_a), _ptr(gm_a), n_a, _ptr(pos_b), _ptr(gm_b), n_b,
                _ptr(bounds), dim, *_int_args(q), int(uniform),
                ONE_PASS_SEGMENT_TILES, _ptr(rpart), _ptr(cpart), _ptr(rows),
                _ptr(cols), _stream(pos_a.device))
        _raise_on(rc, "pair_sym_force")
        LAUNCHES[_variant("pair_sym_force", uniform)] += 1
        return rows, cols
    ta, tb = _tiles(n_a), _tiles(n_b)
    nseg = -(-tb // PAIR_SEGMENT_TILES)
    with torch.cuda.device(pos_a.device):
        rpart = torch.empty((ta, nseg, TILE, dim), dtype=torch.float32,
                            device=pos_a.device)
        cpart = torch.empty((tb, ta, TILE, dim), dtype=torch.float32,
                            device=pos_a.device)
        rows = torch.empty_like(pos_a)
        cols = torch.empty_like(pos_b)
        rc = lib.nbody_pair_sym_force(
            _ptr(pos_a), _ptr(gm_a), n_a, _ptr(pos_b), _ptr(gm_b), n_b,
            _ptr(bounds), dim, *_int_args(q), int(uniform),
            PAIR_SEGMENT_TILES, _ptr(rpart), _ptr(cpart), _ptr(rows),
            _ptr(cols), _stream(pos_a.device))
    _raise_on(rc, "pair_sym_force")
    LAUNCHES[_variant("pair_sym_force", uniform)] += 1
    return rows, cols


# --------------------------------------------------------------------------
# Kernels #2 / #3: global max of raw pairwise d^2
# --------------------------------------------------------------------------

def max_d2_plain(pos: torch.Tensor, skip: torch.Tensor | None = None,
                 count: torch.Tensor | None = None,
                 block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the max_d2 kernel: max over all pairs of
    the raw subtract-form d^2 (0-d f32); 0 where ``skip`` is nonzero.
    ``count`` (int32) gains 1 unless skipped."""
    n, dim = pos.shape
    best = torch.zeros((), dtype=torch.float32, device=pos.device)
    for r0 in range(0, n, block):
        pi = pos[r0:r0 + block]
        dx = pos[None, :, 0] - pi[:, 0, None]
        d2 = dx * dx
        for d in range(1, dim):
            dx = pos[None, :, d] - pi[:, d, None]
            d2 = d2 + dx * dx
        best = torch.maximum(best, d2.max())
    return _plain_skip(best, skip, count)


def _check_flag(name: str, t: torch.Tensor | None, device) -> None:
    if t is not None and (t.dtype != torch.int32 or t.numel() != 1
                          or t.device != device):
        raise ValueError(f"{name} must be one int32 on the positions' "
                         f"device")


def max_d2(pos: torch.Tensor, skip: torch.Tensor | None = None,
           count: torch.Tensor | None = None,
           parent: bool = False) -> torch.Tensor:
    """Kernel #2 / #3 wrapper: CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``skip`` is an optional int32 flag on the
    same device: when nonzero the launch returns at once with 0. ``count``
    is an optional int32 on the same device that gains 1 when the launch
    was not skipped. One launch in ``max_d2_design(N)``; ``parent=True``
    takes the design that one replaced (the same bits) to compare them."""
    n, dim = _check_positions(pos)
    _check_flag("skip", skip, pos.device)
    _check_flag("count", count, pos.device)
    if pos.device.type == "cpu":
        return max_d2_plain(pos, skip, count)
    lib = _library()
    design = max_d2_design(n, parent)
    dev = pos.device
    with torch.cuda.device(dev):
        out = torch.empty(1, dtype=torch.float32, device=dev)
        if design == "tiled":
            cap = max_d2_tiled_blocks(dev)
            block_max = torch.empty(cap, dtype=torch.float32, device=dev)
            rc = lib.nbody_max_d2_tiled(
                _ptr(pos), n, dim, _opt_ptr(skip), _opt_ptr(count),
                _ptr(block_max), cap, _ptr(ticket(dev)), _ptr(out),
                _stream(dev))
        else:
            block_max = torch.empty(MAX_D2_BLOCKS, dtype=torch.float32,
                                    device=dev)
            rc = lib.nbody_max_d2(
                _ptr(pos), n, dim, _opt_ptr(skip), _opt_ptr(count),
                _ptr(block_max), MAX_D2_BLOCKS,
                None if design == "two_launch" else _ptr(ticket(dev)),
                max_d2_tile(n), _ptr(out), _stream(dev))
    _raise_on(rc, "max_d2")
    LAUNCHES["max_d2"] += 1
    return out[0]


def _read_counter(registry: dict, device) -> int:
    count = registry.get(str(torch.device(device)))
    return 0 if count is None else int(count)


def _device_counter(registry: dict, device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in registry:
        registry[key] = torch.zeros((), dtype=torch.int32, device=device)
    return registry[key]


def bounds_fallbacks(device) -> int:
    """How often the pruned bounds pass on ``device`` ran its full-set
    max_d2 launch since BOUNDS_FALLBACKS was last cleared (host read)."""
    return _read_counter(BOUNDS_FALLBACKS, device)


def redo_counter(device: torch.device) -> torch.Tensor:
    """The device int32 of REDO_LAUNCHES for ``device``: pass it as
    ``count`` with a skip flag."""
    return _device_counter(REDO_LAUNCHES, device)


def redo_launches(device) -> int:
    """How many skip-flagged sym_force launches on ``device`` ran since
    REDO_LAUNCHES was last cleared (host read)."""
    return _read_counter(REDO_LAUNCHES, device)


# --------------------------------------------------------------------------
# Public functions (counterparts of the pallas_nbody wrappers)
# --------------------------------------------------------------------------

def _softening(cfg: SimConfig, softening_sq):
    return cfg.softening_sq if softening_sq is None else softening_sq


def max_dist_sq(positions: torch.Tensor, cfg: SimConfig,
                softening_sq=None) -> torch.Tensor:
    """Global max softened pairwise d^2 through the max_d2 kernel."""
    return (max_d2(positions.to(torch.float32).contiguous())
            + _softening(cfg, softening_sq))


@functools.lru_cache(maxsize=None)
def _diameter_directions(dim: int, device: torch.device) -> torch.Tensor:
    """Fixed unit directions for the diameter lower bound: 8 in-plane
    angles for 2-D, the 13 cube axes/face-diagonals/corners for 3-D.
    Cached per device, so the step never copies them from the host."""
    if dim == 2:
        ang = torch.arange(8, dtype=torch.float32) * (math.pi / 8.0)
        dirs = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    elif dim == 3:
        vecs = torch.tensor(
            [(1, 0, 0), (0, 1, 0), (0, 0, 1),
             (1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1),
             (0, 1, 1), (0, 1, -1),
             (1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1)],
            dtype=torch.float32)
        dirs = vecs / torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    else:
        raise ValueError(f"unsupported dim {dim}")
    return dirs.to(device)


def max_pairwise_dist_sq_pruned(positions: torch.Tensor, cfg: SimConfig,
                                softening_sq=None,
                                max_candidates: int = PRUNED_CANDIDATES
                                ) -> torch.Tensor:
    """EXACT global max softened pairwise d^2 in O(N) work
    (counterpart of ``nbody_tpu.ops.forces.max_pairwise_dist_sq_pruned``).

    The max pairwise distance is the point set's diameter; both of its
    endpoints lie at least D_lb - r_max from the centroid (D_lb: the
    largest extent along a fixed direction set, r_max: the largest
    radius). So the ``max_candidates`` largest-radius points hold the
    diameter pair whenever that radius threshold admits at most
    ``max_candidates`` points. Otherwise (near-spherical shells,
    coincident clouds) the full O(N^2/2) pass decides. The ``max_d2``
    kernel runs on the candidates and on the full set; the full-set launch
    reads the admitted-count flag on the device and returns at once when
    the candidates suffice (else it counts itself in BOUNDS_FALLBACKS),
    and ``torch.where`` picks the result, so the step never waits on the
    host. d^2 is formed op for op as in the full pass, so the result is
    BITWISE the full max."""
    soft = _softening(cfg, softening_sq)
    pos = positions.to(torch.float32).contiguous()
    n, dim = pos.shape
    if n <= max_candidates:
        return max_d2(pos) + soft

    u = pos - pos.mean(dim=0)
    r2 = u[:, 0] * u[:, 0]
    for d in range(1, dim):
        r2 = r2 + u[:, d] * u[:, d]
    r = torch.sqrt(r2)
    r_max = r.max()

    # Projections written out elementwise: a matmul could run in TF32.
    dirs = _diameter_directions(dim, pos.device)
    proj = pos[:, 0:1] * dirs[:, 0]
    for d in range(1, dim):
        proj = proj + pos[:, d:d + 1] * dirs[:, d]
    d_lb = (proj.amax(dim=0) - proj.amin(dim=0)).max()
    # Endpoint radius bound with slack for f32 rounding of r / d_lb.
    thresh = (d_lb - r_max) * (1.0 - 1e-5) - 1e-6 * r_max
    admitted = (r >= thresh).sum()
    enough = (admitted <= max_candidates).to(torch.int32)

    idx = torch.topk(r, max_candidates).indices
    cand = pos.index_select(0, idx)
    cand_max = max_d2(cand)
    full_max = max_d2(pos, skip=enough,
                      count=_device_counter(BOUNDS_FALLBACKS,
                                            pos.device))
    return torch.where(enough != 0, cand_max, full_max) + soft


def _scalar(value, device) -> torch.Tensor:
    """0-d f32 on ``device``; a fill, never a blocking host copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32, device=device)


def kernel_bounds(pos: torch.Tensor, q: Quantizer, cfg: SimConfig,
                  softening_sq=None, log_lo=None, log_hi=None):
    """bounds = [log_lo, log_hi, eps^2] (3,) f32 on pos's device. Int-sim
    modes take their tensor-global grid from the pruned max pass over all
    of pos unless log_lo/log_hi are given; float modes carry zeros."""
    soft_t = _scalar(_softening(cfg, softening_sq), pos.device)
    if not q.is_int:
        zero = torch.zeros((), dtype=torch.float32, device=pos.device)
        return torch.stack([zero, zero, soft_t])
    if log_lo is None or log_hi is None:
        with span("nbody.bounds"):
            log_lo, log_hi = dist_sq_log_bounds(
                q, max_pairwise_dist_sq_pruned(pos, cfg,
                                               softening_sq=soft_t),
                soft_t)
    return torch.stack([_scalar(log_lo, pos.device),
                        _scalar(log_hi, pos.device), soft_t])


# Below this static eps^2 the self pair's weight eps^-3 is not finite in
# every float mode (float16 rounds an eps^2 under 2^-25 to 0, float32's
# cube overflows under ~2.1e-26), and inf * 0 would make the row NaN: such
# runs mask the diagonal by id, as zero softening does. Above it the self
# term is an exact zero and masking changes no bit.
SELF_MASK_SOFTENING_SQ = 2.0 ** -24


def static_self_masked(cfg: SimConfig) -> bool:
    """Whether cfg's static softening needs the diagonal masked."""
    return cfg.softening_sq < SELF_MASK_SOFTENING_SQ


def _self_masked(cfg: SimConfig, softening_sq) -> bool:
    """Mask the diagonal at zero softening, and whenever softening is a
    run-time value the host does not read (pallas_nbody.py:586), or a
    static one too small for the self pair's weight to be finite
    (``static_self_masked``)."""
    return softening_sq is not None or static_self_masked(cfg)


def _prepare(positions, masses, cfg: SimConfig, gm=None) -> tuple:
    pos = positions.to(torch.float32).contiguous()
    if gm is None:
        gm = cfg.G * masses.to(torch.float32)
    return pos, gm.to(torch.float32).contiguous()


def _finish(acc, q: Quantizer, quantize_forces: bool):
    return quantize_force(acc, q) if quantize_forces and q.is_int else acc


@guard_uniform_gm(("masses", ("gm", "masses", 1)))
def sym_accelerations(positions: torch.Tensor, masses, q: Quantizer,
                      cfg: SimConfig, quantize_forces: bool = True,
                      softening_sq=None, log_lo=None, log_hi=None,
                      gm=None, uniform_gm: bool = False,
                      emit_max: bool = False, skip=None, count=None):
    """Softened all-pairs accelerations through the sym_force kernel.

    Same semantics as ``nbody_tpu.ops.pallas_nbody.pallas_accelerations_sym``:
    int-sim modes take their tensor-global grid bounds from the
    candidate-pruned max pass unless ``log_lo``/``log_hi`` are given, then
    quantize the (N, D) result with ``quantize_force``. ``softening_sq``
    optionally replaces cfg's with a run-time (0-d tensor) value. The
    diagonal is masked when softening is zero or given at run time. ``gm``
    (G * m) may replace ``masses``. Nothing here waits on the host.

    ``uniform_gm=True`` asserts equal masses (checked on the host unless
    called through ``prevalidated``) and takes the equal-mass variant when
    N is a multiple of TILE (the full-tile rule). ``emit_max=True`` (int-sim
    modes, explicit log_lo/log_hi: the cached-bounds scan owns them) also
    returns the max softened pairwise d^2 from the same launch:
    ``(acc, max_d2 + eps^2)``. ``skip`` / ``count`` pass sym_force's device
    flags through (the cached-bounds scan's redo launch)."""
    if emit_max:
        if not q.is_int:
            raise ValueError("emit_max is only supported for int-sim modes "
                             "(float modes have no log grid to bound)")
        if log_lo is None or log_hi is None:
            raise ValueError("emit_max requires explicit log_lo/log_hi (the "
                             "cached-bounds scan owns them)")
    pos, gm = _prepare(positions, masses, cfg, gm)
    bounds = kernel_bounds(pos, q, cfg, softening_sq, log_lo, log_hi)
    max_out = (torch.empty((), dtype=torch.float32, device=pos.device)
               if emit_max else None)
    acc = sym_force(pos, gm, bounds, q, _self_masked(cfg, softening_sq),
                    uniform=uniform_gm, max_out=max_out, skip=skip,
                    count=count)
    acc = _finish(acc, q, quantize_forces)
    return (acc, max_out + bounds[2]) if emit_max else acc


def accelerations_rows(positions: torch.Tensor, masses: torch.Tensor,
                       q: Quantizer, cfg: SimConfig,
                       quantize_forces: bool = True,
                       softening_sq=None) -> torch.Tensor:
    """Row-sweep accelerations through the row_force kernel: the
    counterpart of ``pallas_accelerations`` (#8) and, under the name
    ``accelerations_streamed``, of ``pallas_accelerations_streamed`` (#4);
    the TPU split between the two exists only because of VMEM. Int-sim
    bounds come from the pruned max pass with the run-time softening
    (pallas_nbody.py:808-814); the diagonal is masked when softening is
    zero or given at run time."""
    pos, gm = _prepare(positions, masses, cfg)
    bounds = kernel_bounds(pos, q, cfg, softening_sq)
    acc = row_force(pos, gm, bounds, q, _self_masked(cfg, softening_sq))
    return _finish(acc, q, quantize_forces)


accelerations_streamed = accelerations_rows


@guard_uniform_gm(("masses", ("gm", "masses", 1)))
def sym_accelerations_chunked(positions: torch.Tensor, masses, q: Quantizer,
                              cfg: SimConfig, quantize_forces: bool = True,
                              chunk: int | None = None, softening_sq=None,
                              log_lo=None, log_hi=None, gm=None,
                              uniform_gm: bool = False) -> torch.Tensor:
    """Newton's-third-law accelerations past one sym_force launch's
    scratch budget: the counterpart of ``pallas_accelerations_sym_chunked``
    (#5).

    Particles are cut into chunks (``sym_chunk_size`` unless given; the
    last may be shorter). Each chunk runs sym_force on itself, each chunk
    pair i < j one pair_sym_force launch giving chunk i's rows and chunk
    j's reactions: C sym_force and C(C-1)/2 pair_sym_force launches,
    ~N^2/2 pair evaluations. Sums follow JAX's order: acc_i = diagonal +
    rows over j ascending, acc[j] += cols. Int-sim bounds are taken once
    over all N. Zero, run-time or too small a softening
    (``_self_masked``) routes to the row sweep (pallas_nbody.py:892-895):
    the pair tile has no self-mask.
    ``uniform_gm=True`` asserts equal masses and reaches every launch,
    where the full-tile rule decides per chunk (pallas_nbody.py:930-945):
    only a last chunk that is not a multiple of TILE takes the general
    kernels."""
    if _self_masked(cfg, softening_sq):
        return accelerations_streamed(positions, masses, q, cfg,
                                      quantize_forces=quantize_forces,
                                      softening_sq=softening_sq)
    pos, gm = _prepare(positions, masses, cfg, gm)
    n, dim = pos.shape
    bounds = kernel_bounds(pos, q, cfg, None, log_lo, log_hi)
    chunk = min(sym_chunk_size(n, dim) if chunk is None else chunk, n)
    spans = [slice(a, min(a + chunk, n)) for a in range(0, n, chunk)]
    acc = torch.zeros_like(pos)
    for i, si in enumerate(spans):
        acc_i = sym_force(pos[si], gm[si], bounds, q, False,
                          uniform=uniform_gm)
        for sj in spans[i + 1:]:
            rows, cols = pair_sym_force(pos[si], gm[si], pos[sj], gm[sj],
                                        bounds, q, uniform=uniform_gm)
            acc_i = acc_i + rows
            acc[sj] += cols
        acc[si] += acc_i
    return _finish(acc, q, quantize_forces)


# --------------------------------------------------------------------------
# The multi-device ring's tiles: #10 pair_force, #9 pair_max, #7 pair_pe_rows
# --------------------------------------------------------------------------

def _pair_bounds(receivers, q: Quantizer, cfg: SimConfig, log_lo, log_hi):
    if q.is_int and (log_lo is None or log_hi is None):
        raise ValueError("int-sim modes need global log bounds from the "
                         "ring max pass")
    return kernel_bounds(receivers, q, cfg, None, log_lo, log_hi)


def pair_force_plain(receivers: torch.Tensor, sources: torch.Tensor,
                     gm_sources: torch.Tensor, q: Quantizer, cfg: SimConfig,
                     log_lo=None, log_hi=None,
                     block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the pair_force kernel, row-blocked over the
    receivers: acc_i = sum_j gm_j w_ij (x_j - x_i) over every source, no
    mask (receivers may also be sources: at eps^2 > 0 a self-pair is an
    exact zero). (n_i, D) f32, before any force quantization."""
    bounds = _pair_bounds(receivers, q, cfg, log_lo, log_hi)
    return _plain_rows(receivers, sources, gm_sources, bounds, q, None, block,
                       lambda t: t)


def pair_force_term_scale(receivers: torch.Tensor, sources: torch.Tensor,
                          gm_sources: torch.Tensor, bounds: torch.Tensor,
                          q: Quantizer, block: int = 1024) -> torch.Tensor:
    """sum_j |gm_j w_ij (x_j - x_i)| per receiver and component: the scale
    of pair_force's rounding error in any summation order (see
    sym_force_term_scale)."""
    return _plain_rows(receivers, sources, gm_sources, bounds, q, None, block,
                       torch.abs)


def pair_force(receivers: torch.Tensor, sources: torch.Tensor,
               gm_sources: torch.Tensor, q: Quantizer, cfg: SimConfig,
               log_lo=None, log_hi=None,
               parent: bool = False) -> torch.Tensor:
    """Kernel #10 wrapper, the counterpart of ``pallas_pair_force``:
    accelerations of ``receivers`` due to ``sources`` (disjoint or equal
    sets) with ``gm_sources`` = G * m_j, through csrc/row_force.cu for CUDA
    tensors and pair_force_plain for CPU tensors. eps^2 is cfg's; int-sim
    modes need the global ``log_lo``/``log_hi`` (ValueError otherwise).
    Nothing here waits on the host. ``parent=True`` takes the earlier
    kernel, as row_force's."""
    n_i, n_j, dim = _check_two_sets(receivers, sources)
    _check_f32("gm_sources", gm_sources, (n_j,), receivers.device)
    if receivers.device.type == "cpu":
        return pair_force_plain(receivers, sources, gm_sources, q, cfg,
                                log_lo, log_hi)
    bounds = _pair_bounds(receivers, q, cfg, log_lo, log_hi)
    out = _launch_rows(receivers, sources, gm_sources, bounds, q, False,
                       "pair_force", parent)
    LAUNCHES["pair_force"] += 1
    return out


def _check_mask(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.dtype != torch.bool or tuple(t.shape) != (n,) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) bool tensor on "
                         f"{device}")


def pair_max_plain(receivers: torch.Tensor, sources: torch.Tensor,
                   valid_i: torch.Tensor, valid_j: torch.Tensor,
                   block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the pair_max kernel: the max of the raw
    subtract-form d^2 over (receiver, source) pairs whose ends are both
    valid, 0 if none is (0-d f32)."""
    dim = receivers.shape[1]
    best = torch.zeros((), dtype=torch.float32, device=receivers.device)
    for r0 in range(0, receivers.shape[0], block):
        pi = receivers[r0:r0 + block]
        dx = sources[None, :, 0] - pi[:, 0, None]
        d2 = dx * dx
        for d in range(1, dim):
            dx = sources[None, :, d] - pi[:, d, None]
            d2 = d2 + dx * dx
        both = valid_i[r0:r0 + block, None] & valid_j[None, :]
        best = torch.maximum(best, torch.where(both, d2, 0.0).max())
    return best


def pair_max(receivers: torch.Tensor, sources: torch.Tensor,
             valid_i: torch.Tensor, valid_j: torch.Tensor,
             parent: bool = False) -> torch.Tensor:
    """Kernel #9 wrapper, the counterpart of ``pallas_pair_max``: CUDA
    kernel for CUDA tensors, pair_max_plain for CPU tensors. ``valid_i`` /
    ``valid_j`` are bool masks of the receivers and sources. Bitwise the
    plain version's, and for one set against itself, all valid, bitwise
    max_d2's. One register-tiled launch over ``pair_max_segments``' grid,
    folded by max_d2's ticket; ``parent=True`` takes the earlier two
    launches (the same bits) to compare them."""
    n_i, n_j, dim = _check_two_sets(receivers, sources)
    _check_mask("valid_i", valid_i, n_i, receivers.device)
    _check_mask("valid_j", valid_j, n_j, receivers.device)
    if receivers.device.type == "cpu":
        return pair_max_plain(receivers, sources, valid_i, valid_j)
    lib = _library()
    dev = receivers.device
    with torch.cuda.device(dev):
        out = torch.empty(1, dtype=torch.float32, device=dev)
        if parent:
            block_max = torch.empty(MAX_D2_BLOCKS, dtype=torch.float32,
                                    device=dev)
            rc = lib.nbody_pair_max(
                _ptr(receivers), _ptr(valid_i), n_i, _ptr(sources),
                _ptr(valid_j), n_j, dim, _ptr(block_max), MAX_D2_BLOCKS,
                _ptr(out), _stream(dev))
        else:
            nseg, seg = pair_max_segments(n_i, n_j)
            block_max = torch.empty(-(-n_i // PAIR_MAX_RECEIVERS) * nseg,
                                    dtype=torch.float32, device=dev)
            rc = lib.nbody_pair_max_tiled(
                _ptr(receivers), _ptr(valid_i), n_i, _ptr(sources),
                _ptr(valid_j), n_j, dim, seg, _ptr(block_max),
                _ptr(ticket(dev)), _ptr(out), _stream(dev))
    _raise_on(rc, "pair_max")
    LAUNCHES["pair_max"] += 1
    return out[0]


def pair_pe_rows_plain(receivers, m_recv, ids_recv, sources, m_src, ids_src,
                       softening_sq, block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the pair_pe_rows kernel, row-blocked:
    rows_i = sum_j m_i m_j / sqrt(|x_j - x_i|^2 + eps^2) over sources j
    whose id differs from receiver i's. (n_i,) f32."""
    soft = _scalar(softening_sq, receivers.device)
    dim = receivers.shape[1]
    out = torch.empty(receivers.shape[0], dtype=torch.float32,
                      device=receivers.device)
    for r0 in range(0, receivers.shape[0], block):
        pi = receivers[r0:r0 + block]
        dx = sources[None, :, 0] - pi[:, 0, None]
        d2 = dx * dx
        for d in range(1, dim):
            dx = sources[None, :, d] - pi[:, d, None]
            d2 = d2 + dx * dx
        pair = (m_recv[r0:r0 + block, None] * m_src[None, :]) \
            * torch.rsqrt(d2 + soft)
        pair = torch.where(ids_recv[r0:r0 + block, None] == ids_src[None, :],
                           0.0, pair)
        out[r0:r0 + block] = pair.sum(dim=1)
    return out


def _check_ids(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != (n,) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor "
                         f"on {device}")


def pair_pe_rows(receivers, m_recv, ids_recv, sources, m_src, ids_src,
                 softening_sq, parent: bool = False) -> torch.Tensor:
    """Kernel #7 wrapper, the counterpart of ``pallas_pair_pe_rows``: CUDA
    kernel for CUDA tensors, pair_pe_rows_plain for CPU tensors. Masses
    f32, ids int32 (any value: equal ids mask the pair), ``softening_sq``
    a float or a 0-d tensor. (n_i,) f32 row sums in a fixed order; the
    caller sums them in f64. Past TILED_MIN_N receivers the register-tiled
    design (``pe_design``; the id ranges of its receiver blocks and source
    tiles from ``id_ranges``, on the device); ``parent=True`` takes the
    first design at every shape."""
    n_i, n_j, _ = _check_two_sets(receivers, sources)
    _check_f32("m_recv", m_recv, (n_i,), receivers.device)
    _check_f32("m_src", m_src, (n_j,), receivers.device)
    _check_ids("ids_recv", ids_recv, n_i, receivers.device)
    _check_ids("ids_src", ids_src, n_j, receivers.device)
    if receivers.device.type == "cpu":
        return pair_pe_rows_plain(receivers, m_recv, ids_recv, sources, m_src,
                                  ids_src, softening_sq)
    lib = _library()
    dev = receivers.device
    with torch.cuda.device(dev):
        soft = _scalar(softening_sq, dev)
        out = torch.empty(n_i, dtype=torch.float32, device=dev)
        if pe_design(n_i, n_j, parent) == "tiled":
            _, seg = pe_segments(n_i, n_j)
            shape = pe_scratch(n_i, n_j)
            rpart = None if shape is None else torch.empty(
                shape, dtype=torch.float32, device=dev)
            rr = id_ranges(ids_recv, PE_RECEIVERS)
            sr = id_ranges(ids_src, PE_SOURCE_TILE)
            rc = lib.nbody_pair_pe_rows_tiled(
                _ptr(receivers), _ptr(m_recv), _ptr(ids_recv), n_i,
                _ptr(sources), _ptr(m_src), _ptr(ids_src), n_j,
                receivers.shape[1], _ptr(soft), _ptr(rr), _ptr(sr), seg,
                _opt_ptr(rpart), _ptr(out), _stream(dev))
        else:
            rc = lib.nbody_pair_pe_rows(
                _ptr(receivers), _ptr(m_recv), _ptr(ids_recv), n_i,
                _ptr(sources), _ptr(m_src), _ptr(ids_src), n_j,
                receivers.shape[1], _ptr(soft), _ptr(out), _stream(dev))
    _raise_on(rc, "pair_pe_rows")
    LAUNCHES["pair_pe_rows"] += 1
    return out
