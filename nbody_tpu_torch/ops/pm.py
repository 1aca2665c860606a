"""Particle-mesh operators: deposit, FFT Poisson solve, gather, P(k).

PyTorch counterpart of ``nbody_tpu.ops.pm`` (reference: universe_2d.py
:1015-1293). Every function takes and returns tensors on the caller's
device, for D in {2, 3}, with JAX's op order wherever a floor or a bin
depends on it: ``floor(positions / box_size * n_grid)`` (divide, then
multiply), CIC's ``u - i0`` fractions and its corner weights multiplied in
d = 0..D-1 order from the weights, Python-sign ``%`` (a tiny negative
coordinate that wrapped onto ``box`` lands in cell 0), and JAX's own
``linspace`` / ``logspace`` / ``fftfreq`` arithmetic (``jax_linspace`` and
friends below).

The deposit is a segment sum in particle order: ``segment_sum`` wraps the
hand-written kernel ``csrc/pm_deposit.cu`` (a stable sort, then a thread a
run of sorted particles summing it in order, a block a run longer than
``LONG_RUN``; no float atomics) for a CUDA tensor, and its plain version
(``segment_sum_plain``: ``index_add_`` on the CPU, which adds in index
order) for a CPU tensor, bit for bit JAX's sequential scatter.
``deposit_runs_plain`` models the kernel's decomposition on the CPU.
The slab gathers (``ngp_gather_slab`` / ``cic_gather_slab``) are the
sharded PM's partial gathers from one x-slab of the gradient grids. The
P(k) bin sums are fixed-order ``torch.sum``s over a constant bin mask. The FFTs are library calls (``torch.fft``), as JAX leaves them
to XLA. The spectral constants of a grid (wavevectors, the quantized k^2,
the P(k) bins, the dark-matter background) are built once per
(geometry, device) and reused.

The precision hook matches the reference: the Poisson solve divides by a
*quantized* |k|^2 (reference: universe_2d.py:1050-1053).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from nbody_tpu_torch.ops.precision import Quantizer, quantize_distance_squared

# Launches of the deposit's kernels in this process (reset by whoever
# reads them): "pm_deposit" one a deposit (a segment sum);
# "pm_deposit_fill" and "pm_deposit_long" its fill and long-run launches
# (``deposit_launches``).
LAUNCHES = {"pm_deposit": 0, "pm_deposit_fill": 0, "pm_deposit_long": 0}
# The longest run of sorted particles (one cell's) that one thread of the
# deposit kernel sums; a longer run goes to the long pass, a block a run.
LONG_RUN = 32


# --------------------------------------------------------------------------
# JAX's array-creation arithmetic, in float32 on the host
# --------------------------------------------------------------------------
#
# The constant grids (wavevectors, bin masks, the dark-matter background)
# are built once in numpy float32, whose elementwise ops (sqrt included)
# are correctly rounded as XLA's are, and then copied to the device: the
# same bits on every device (torch's CPU sqrt is not always correctly
# rounded).

_F32 = np.float32


def jax_linspace(start, stop, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` (endpoint) as XLA runs it in
    float32: JAX writes start * (1 - step) + stop * step with step =
    iota / (num - 1), and XLA's simplifier turns the division by the
    constant into a product with r = f32(1 / (num - 1)) and folds stop * r
    into one constant: start * (1 - iota r) + iota (r stop), then the stop
    itself as the last point."""
    start, stop = _F32(start), _F32(stop)
    if num == 1:
        return np.array([start], _F32)
    iota = np.arange(num - 1, dtype=_F32)
    r = _F32(1) / _F32(num - 1)
    out = start * (_F32(1) - iota * r) + iota * (r * stop)
    return np.append(out, stop).astype(_F32)


def jax_logspace(start, stop, num: int) -> np.ndarray:
    """``jnp.logspace(start, stop, num)``: 10 ** jax_linspace in float32
    (the power by torch on the CPU, whose powf gives XLA:CPU's bits where
    numpy's does not)."""
    lin = torch.from_numpy(jax_linspace(start, stop, num))
    return torch.pow(10.0, lin).numpy()


def jax_fftfreq(n: int, d: float) -> np.ndarray:
    """``jnp.fft.fftfreq(n, d)``: ((i + n//2) % n - n//2) / f32(d * n)."""
    i = np.arange(n, dtype=_F32)
    k = (i + _F32(n // 2)) % _F32(n) - _F32(n // 2)
    return (k / _F32(d * n)).astype(_F32)


def jax_rfftfreq(n: int, d: float) -> np.ndarray:
    """``jnp.fft.rfftfreq(n, d)``: arange(n//2 + 1) / f32(d * n)."""
    return (np.arange(n // 2 + 1, dtype=_F32) / _F32(d * n)).astype(_F32)


# --------------------------------------------------------------------------
# Deposit: the segment sum and its kernel
# --------------------------------------------------------------------------

def _over_box(positions: torch.Tensor, box_size: float) -> torch.Tensor:
    """positions / box_size, a true division on every device: the divisor
    is a 0-d tensor on the positions' device, because PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal (another
    rounding, which moves cells)."""
    return positions / torch.full((), box_size, dtype=positions.dtype,
                                  device=positions.device)


def cell_index(positions: torch.Tensor, box_size: float, n_grid: int):
    """Nearest-grid-point flat cell index per particle (int32), periodic
    wrap; returns (flat, ij)."""
    ij = (torch.floor(_over_box(positions, box_size) * n_grid)
          .to(torch.int32) % n_grid)
    dim = positions.shape[1]
    flat = ij[:, 0]
    for d in range(1, dim):
        flat = flat * n_grid + ij[:, d]
    return flat, ij


def _check_segment_args(keys, w, num_segments, prev) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"segment_sum takes 1-D int32 keys, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if w.dtype != torch.float32 or w.shape != keys.shape:
        raise ValueError(f"segment_sum takes float32 weights shaped like the "
                         f"keys, got {w.dtype} {tuple(w.shape)}")
    if w.device != keys.device:
        raise ValueError("segment_sum: keys and weights on different devices")
    if num_segments <= 0:
        raise ValueError(f"segment_sum: num_segments {num_segments} <= 0")
    if prev is not None and (prev.dtype != torch.float32
                             or prev.shape != (num_segments,)
                             or prev.device != keys.device):
        raise ValueError("segment_sum: prev must be float32 "
                         f"({num_segments},) on the keys' device")


def segment_sum_plain(keys: torch.Tensor, w: torch.Tensor, num_segments: int,
                      prev: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the deposit kernel: the f32 sum of the weights of
    each key, in particle order (``index_add_`` on the CPU adds in index
    order), plus ``prev`` when given."""
    out = torch.zeros(num_segments, dtype=torch.float32,
                      device=w.device).index_add_(0, keys, w)
    return out if prev is None else prev + out


def sort_keys(keys: torch.Tensor) -> tuple:
    """The deposit's stable sort of the keys: (sorted keys, permutation)."""
    return torch.sort(keys, stable=True)


def long_list_size(n: int, long_run: int = LONG_RUN) -> int:
    """int32 elements of the long pass's scratch for n sorted particles:
    the count of runs longer than ``long_run``, then their first indices
    (at most n // (long_run + 1) of them)."""
    return 1 + -(-n // (long_run + 1))


def deposit_launches(n: int, long_run: int = LONG_RUN) -> dict:
    """The kernel launches of one deposit of n sorted particles, by
    ``LAUNCHES`` key: the fill (always: it also zeroes the long-run count),
    the run pass (counted as "pm_deposit", the deposit's own count) and the
    long pass when a run could exceed ``long_run`` (n > long_run: the host
    cannot see the runs without a read, so the pass launches and finds its
    list empty where no run is that long)."""
    return {"pm_deposit": 1, "pm_deposit_fill": 1,
            "pm_deposit_long": int(n > long_run)}


def deposit_sorted(sorted_keys: torch.Tensor, perm: torch.Tensor,
                   w: torch.Tensor, num_segments: int,
                   prev: torch.Tensor | None = None, *,
                   into: torch.Tensor | None = None,
                   long_run: int = LONG_RUN,
                   long_list: torch.Tensor | None = None) -> torch.Tensor:
    """One deposit by csrc/pm_deposit.cu on keys already sorted by
    ``sort_keys`` (CUDA tensors); counts its launches in ``LAUNCHES``.

    ``prev``: the grid the sums are added to, out of place (every cell
    written, an empty one as prev + 0). ``into``: a grid the sums are added
    to in place, only occupied cells touched (bitwise the out-of-place sum
    for a grid that holds no -0.0, as no deposit grid does); returned.
    ``long_run``: the longest run a thread sums. ``long_list``: int32 of
    ``long_list_size(n, long_run)`` on the card, the long pass's scratch;
    after the call its first element is the number of runs longer than
    ``long_run`` (a scratch of the wrapper's own when None)."""
    from nbody_tpu_torch import _build

    if into is not None and prev is not None:
        raise ValueError("deposit_sorted: into excludes prev")
    if into is not None and (into.dtype != torch.float32
                             or into.shape != (num_segments,)
                             or not into.is_contiguous()
                             or into.device != w.device):
        raise ValueError(f"deposit_sorted: into must be contiguous float32 "
                         f"({num_segments},) on the weights' device")
    if long_run < 1:
        raise ValueError(f"deposit_sorted: long_run {long_run} < 1")
    if w.device.type != "cuda":
        raise ValueError("deposit_sorted launches the CUDA kernel: its "
                         "tensors lie on the card (segment_sum takes a CPU "
                         "tensor to the plain version)")
    n = sorted_keys.shape[0]
    w = w.contiguous()
    prev = None if prev is None else prev.contiguous()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    base = None if prev is None else ptr(prev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(w.device).cuda_stream)
    lib = _build.library()
    out = (torch.empty(num_segments, dtype=torch.float32, device=w.device)
           if into is None else into)
    size = long_list_size(n, long_run)
    if long_list is None:
        long_list = torch.empty(size, dtype=torch.int32, device=w.device)
    elif (long_list.dtype != torch.int32 or long_list.numel() < size
          or long_list.device != w.device):
        raise ValueError(f"deposit_sorted: long_list must be int32 of "
                         f"{size} on the weights' device")
    rc = lib.nbody_pm_deposit_runs(
        ptr(sorted_keys), ptr(perm), ptr(w), base, ptr(out), n, num_segments,
        long_run, int(into is not None), ptr(long_list), stream)
    if rc != 0:
        raise RuntimeError(f"pm_deposit kernel launch failed: CUDA error {rc}")
    for k, v in deposit_launches(n, long_run).items():
        LAUNCHES[k] += v
    return out


def segment_sum(keys: torch.Tensor, w: torch.Tensor, num_segments: int,
                prev: torch.Tensor | None = None) -> torch.Tensor:
    """Deterministic segment sum (``jax.ops.segment_sum`` of ``w`` by
    ``keys``, plus ``prev``): the deposit kernel for a CUDA tensor, its
    plain version for a CPU tensor; bitwise the same function."""
    _check_segment_args(keys, w, num_segments, prev)
    if keys.device.type == "cpu":
        return segment_sum_plain(keys, w, num_segments, prev)
    sorted_keys, perm = sort_keys(keys)
    return deposit_sorted(sorted_keys, perm, w, num_segments, prev)


def sorted_runs(sorted_keys: torch.Tensor, num_segments: int) -> tuple:
    """The runs of equal keys in sorted keys whose key lies in
    [0, num_segments): (first index, length, key), int64 tensors on the
    keys' device, in sorted order."""
    n = sorted_keys.shape[0]
    keys = sorted_keys.long()
    if n == 0:
        return keys, keys, keys
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    starts = torch.nonzero(head).flatten()
    ends = torch.cat([starts[1:], torch.full((1,), n, device=keys.device)])
    run_keys = keys[starts]
    keep = (run_keys >= 0) & (run_keys < num_segments)
    return starts[keep], (ends - starts)[keep], run_keys[keep]


def _ordered_sums(ws: torch.Tensor, starts: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """((0 + ws[s]) + ws[s + 1]) + ... over each run, in float32, one
    position of every run at a time."""
    sums = torch.zeros(starts.shape[0], dtype=torch.float32)
    for j in range(int(lengths.max()) if len(lengths) else 0):
        live = lengths > j
        sums[live] = sums[live] + ws[starts[live] + j]
    return sums


def deposit_runs_plain(sorted_keys: torch.Tensor, perm: torch.Tensor,
                       w: torch.Tensor, num_segments: int,
                       prev: torch.Tensor | None = None, *,
                       into: torch.Tensor | None = None,
                       long_run: int = LONG_RUN) -> tuple:
    """Plain model of the run-centric kernel on CPU tensors, step by step:
    the fill (0, prev + 0, or nothing into ``into``), the runs of at most
    ``long_run`` summed by their owners, the longer ones by the long pass,
    each in particle order, each written to its cell (added to the cell
    where there is a prev or an ``into``). Returns (grid, the first sorted
    index of each run longer than ``long_run``)."""
    if into is not None:
        grid = into
    elif prev is not None:
        grid = prev + 0.0
    else:
        grid = torch.zeros(num_segments, dtype=torch.float32)
    add = into is not None or prev is not None
    starts, lengths, run_keys = sorted_runs(sorted_keys, num_segments)
    ws = w[perm]
    long = lengths > long_run
    for part in (~long, long):
        sums = _ordered_sums(ws, starts[part], lengths[part])
        cells = run_keys[part]
        grid[cells] = grid[cells] + sums if add else sums
    return grid, starts[long]


def _cic_stencil(positions, n_grid: int, box_size: float):
    """Per corner of the 2^D stencil: (the D per-axis cell indices, the D
    per-axis weight factors, multiplied in d order by the caller)."""
    dim = positions.shape[1]
    u = _over_box(positions, box_size) * n_grid - 0.5
    i0 = torch.floor(u).to(torch.int32)
    frac = u - i0
    for corner in range(2 ** dim):
        idx, factors = [], []
        for d in range(dim):
            o = (corner >> d) & 1
            idx.append((i0[:, d] + o) % n_grid)
            factors.append(frac[:, d] if o == 1 else 1.0 - frac[:, d])
        yield idx, factors


def _cic_corners(positions, n_grid: int, box_size: float):
    """Per corner of the 2^D stencil: (flat cell index, the D per-axis
    weight factors, multiplied in d order by the caller)."""
    for idx, factors in _cic_stencil(positions, n_grid, box_size):
        flat = idx[0]
        for i in idx[1:]:
            flat = flat * n_grid + i
        yield flat, factors


def deposit_segments(positions, weights, n_grid: int, box_size: float,
                     deposit: str = "ngp"):
    """The (cell keys, weights) of each segment sum a deposit adds to the
    grid, in order: one for NGP; one a corner for CIC, its weights the
    particle weights times the corner's factors in d order."""
    if deposit == "ngp":
        yield cell_index(positions, box_size, n_grid)[0], weights
        return
    for flat, factors in _cic_corners(positions, n_grid, box_size):
        w = weights
        for f in factors:
            w = w * f
        yield flat, w


def _deposit(positions, weights, n_grid: int, box_size: float,
             deposit: str):
    """The segments' sums chained into one grid: on the card the first
    sum fills the grid and every later one (CIC's corners) adds into it in
    place; on the CPU each is the plain ``prev + sum``. Bitwise the same:
    no deposit grid holds -0.0."""
    dim = positions.shape[1]
    cells = n_grid ** dim
    grid = None
    for keys, w in deposit_segments(positions, weights, n_grid, box_size,
                                    deposit):
        if grid is None or keys.device.type == "cpu":
            grid = segment_sum(keys, w, cells, prev=grid)
        else:
            _check_segment_args(keys, w, cells, grid)
            deposit_sorted(*sort_keys(keys), w, cells, into=grid)
    return grid.reshape((n_grid,) * dim)


def ngp_deposit(positions, weights, n_grid: int, box_size: float):
    """Nearest-grid-point mass deposit, a segment sum in particle order."""
    return _deposit(positions, weights, n_grid, box_size, "ngp")


def cic_deposit(positions, weights, n_grid: int, box_size: float):
    """Cloud-in-cell deposit: each particle spreads to its 2^D neighbour
    cells with trilinear weights; the corners' segment sums are added to
    the grid in corner order."""
    return _deposit(positions, weights, n_grid, box_size, "cic")


# --------------------------------------------------------------------------
# Spectral constants (built once per geometry and device)
# --------------------------------------------------------------------------

def _k_vectors(n_grid: int, box_size: float, dim: int):
    """FFT wavevector component grids (2*pi * fftfreq), shape (n,)*dim,
    numpy float32."""
    k1d = jax_fftfreq(n_grid, box_size / n_grid) * _F32(2.0) * _F32(math.pi)
    return np.meshgrid(*([k1d] * dim), indexing="ij")


def _rk_vectors(n_grid: int, box_size: float, dim: int):
    """Wavevector component grids on the HALF (rfft) spectrum: the last
    axis carries only the n//2+1 non-negative frequencies."""
    full = jax_fftfreq(n_grid, box_size / n_grid) * _F32(2.0) * _F32(math.pi)
    half = jax_rfftfreq(n_grid, box_size / n_grid) * _F32(2.0) * _F32(math.pi)
    return np.meshgrid(*([full] * (dim - 1) + [half]), indexing="ij")


@functools.lru_cache(maxsize=16)
def _poisson_consts(n_grid: int, box_size: float, dim: int, q: Quantizer,
                    device: torch.device):
    """(quantized k^2, k = 0 mask, [-1j * k_d with each Nyquist plane
    zeroed]) of the half spectrum, on ``device``; the quantizer runs there,
    on the tensor-global bounds."""
    ks = _rk_vectors(n_grid, box_size, dim)
    k_sq = sum(k * k for k in ks) + _F32(1e-10)
    k_nyq = _F32(math.pi * n_grid / box_size)
    grads = []
    for d in range(dim):
        kd = np.where(np.abs(ks[d]) >= k_nyq * _F32(1.0 - 1e-6), _F32(0),
                      ks[d])
        grads.append(-1j * torch.from_numpy(kd).to(device))
    k_sq_q = quantize_distance_squared(torch.from_numpy(k_sq).to(device), q)
    return k_sq_q, torch.from_numpy(k_sq <= _F32(1.5e-10)).to(device), grads


def quantized_k_sq(n_grid: int, box_size: float, dim: int, q: Quantizer,
                   device=None) -> torch.Tensor:
    """The half spectrum's |k|^2 (+1e-10) through the precision hook, on
    its tensor-global bounds: the divisor of the Poisson solve."""
    return _poisson_consts(n_grid, box_size, dim, q,
                           torch.device(device or "cpu"))[0]


def poisson_accel_grids(density, box_size: float, n_grid: int,
                        q: Quantizer, G: float, scale, dim: int = 2):
    """Spectral Poisson solve with the quantized-|k|^2 precision hook.

    density -> delta -> rFFT -> phi_k = -4 pi G <rho> delta_k / k^2_q / a
    -> spectral gradient -> D real-space acceleration grids
    (reference: universe_2d.py:1037-1062). On the half spectrum, with the
    k = 0 mode masked and each axis's Nyquist plane zeroed in the gradient
    multiplier, as ``nbody_tpu.ops.pm.poisson_accel_grids`` does.
    ``scale`` is a float or a 0-d tensor on the density's device."""
    k_sq_q, k0, grads = _poisson_consts(n_grid, box_size, dim, q,
                                        density.device)
    mean_rho = torch.mean(density)
    delta = (density - mean_rho) / (mean_rho + 1e-10)
    delta_k = torch.fft.rfftn(delta)
    phi_k = (-4.0 * math.pi * G * mean_rho) * delta_k / k_sq_q / scale
    phi_k = torch.where(k0, torch.zeros_like(phi_k), phi_k)
    return [torch.fft.irfftn(g * phi_k, s=(n_grid,) * dim) for g in grads]


# --------------------------------------------------------------------------
# Gathers
# --------------------------------------------------------------------------

def ngp_gather(grids, positions, n_grid: int, box_size: float):
    """Sample D acceleration grids at particle cells -> (N, D)."""
    flat, _ = cell_index(positions, box_size, n_grid)
    return torch.stack([g.reshape(-1).index_select(0, flat) for g in grids],
                       dim=-1)


def cic_gather(grids, positions, n_grid: int, box_size: float):
    """Trilinear interpolation of D grids at particle positions."""
    n, dim = positions.shape
    out = torch.zeros((n, dim), dtype=torch.float32, device=positions.device)
    for flat, factors in _cic_corners(positions, n_grid, box_size):
        w = torch.ones(n, dtype=torch.float32, device=positions.device)
        for f in factors:
            w = w * f
        vals = torch.stack([g.reshape(-1).index_select(0, flat)
                            for g in grids], dim=-1)
        out = out + w[:, None] * vals
    return out


def _slab_local(row, rest, n_grid: int, slab_start: int, slab: int,
                numel: int) -> tuple:
    """(in_slab, the flat index into a slab of ``slab`` x-rows starting at
    ``slab_start``) of cells whose x-row is ``row`` and whose other
    per-axis indices are ``rest``; the index clamped into the slab, as
    JAX's ``take(..., mode="clip")``."""
    in_slab = (row >= slab_start) & (row < slab_start + slab)
    local = torch.clamp(row - slab_start, 0, slab - 1)
    for i in rest:
        local = local * n_grid + i
    return in_slab, torch.clamp(local, 0, numel - 1)


def ngp_gather_slab(grids_slab, positions, n_grid: int, box_size: float,
                    slab_start: int):
    """Partial NGP gather from a local x-slab of each gradient grid.

    ``grids_slab``: D tensors of shape (slab, n_grid, ...), the rows
    [slab_start, slab_start + slab) of the full grids. Returns the (N, D)
    contributions of the cells inside this slab (zero elsewhere) for all
    particles; the partials summed over the slabs are the full gather.
    Cells come from ``cell_index``, so one slab holding the whole grid
    gives ``ngp_gather``'s bits."""
    dim = positions.shape[1]
    slab = grids_slab[0].shape[0]
    _, ij = cell_index(positions, box_size, n_grid)
    in_slab, local = _slab_local(ij[:, 0], [ij[:, d] for d in range(1, dim)],
                                 n_grid, slab_start, slab,
                                 grids_slab[0].numel())
    out = torch.stack([g.reshape(-1).index_select(0, local)
                       for g in grids_slab], dim=-1)
    return torch.where(in_slab[:, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def cic_gather_slab(grids_slab, positions, n_grid: int, box_size: float,
                    slab_start: int):
    """Partial CIC (trilinear) gather from a local x-slab of each grid:
    ``ngp_gather_slab``'s contract, each of the 2^D stencil corners
    counted iff its x-row lies in this slab, so a stencil that straddles
    two slabs is completed by the sum over slabs. The corners and their
    factors are ``cic_gather``'s (``_cic_stencil``), so one slab holding
    the whole grid gives its bits."""
    n, dim = positions.shape
    slab = grids_slab[0].shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)
    out = torch.zeros((n, dim), dtype=torch.float32, device=positions.device)
    for idx, factors in _cic_stencil(positions, n_grid, box_size):
        in_slab, local = _slab_local(idx[0], idx[1:], n_grid, slab_start,
                                     slab, grids_slab[0].numel())
        w = torch.ones(n, dtype=torch.float32, device=positions.device)
        for f in factors:
            w = w * f
        vals = torch.stack([g.reshape(-1).index_select(0, local)
                            for g in grids_slab], dim=-1)
        out = out + torch.where(in_slab[:, None], w[:, None] * vals, zero)
    return out


# --------------------------------------------------------------------------
# Structure measurements
# --------------------------------------------------------------------------

def power_spectrum(positions, box_size: float, n_grid: int = 64,
                   num_bins: int = 20):
    """Radially-binned density power spectrum P(k): unit weights deposited
    (number density), the contrast FFT'd, |delta_k|^2 binned on a
    log-spaced k grid (reference: universe_2d.py:1221-1255). Returns
    (k_centers (num_bins-1,), P(k) (num_bins-1,))."""
    ones = torch.ones(positions.shape[0], dtype=torch.float32,
                      device=positions.device)
    density = ngp_deposit(positions, ones, n_grid, box_size)
    return pk_from_density(density, box_size, num_bins)


@functools.lru_cache(maxsize=16)
def _pk_bins(n_grid: int, box_size: float, dim: int, num_bins: int,
             device: torch.device):
    """(bin centers, bin mask (num_bins-1, n^dim) of the in-range modes,
    mode counts) of pk_from_density on ``device``: JAX's bin rule op for
    op, in numpy float32."""
    k_mag = np.sqrt(sum(k * k for k in _k_vectors(n_grid, box_size, dim)))

    k_min = 2.0 * math.pi / box_size
    k_max = math.pi * n_grid / box_size
    edges = jax_logspace(
        *(torch.log10(torch.tensor(k, dtype=torch.float32)).item()
          for k in (k_min, k_max)), num_bins)
    centers = _F32(0.5) * (edges[:-1] + edges[1:])

    flat_k = k_mag.reshape(-1)
    log_kmin = np.log(_F32(k_min))
    log_kmax = np.log(_F32(k_max))
    idx = np.floor((np.log(np.maximum(flat_k, _F32(k_min * 0.5))) - log_kmin)
                   / (log_kmax - log_kmin) * _F32(num_bins - 1)
                   ).astype(np.int32)
    in_range = (flat_k >= _F32(k_min)) & (flat_k < _F32(k_max))
    idx = np.clip(idx, 0, num_bins - 2)
    mask = ((idx[None, :] == np.arange(num_bins - 1)[:, None])
            & in_range[None, :])
    counts = mask.sum(axis=1).astype(_F32)
    return (torch.from_numpy(centers).to(device),
            torch.from_numpy(mask).to(device),
            torch.from_numpy(counts).to(device))


def pk_from_density(density, box_size: float, num_bins: int = 20):
    """Spectral half of power_spectrum: contrast -> FFT -> radial bins.
    Each bin's sum is one fixed-order ``torch.sum`` over its mask (no
    atomics)."""
    n_grid, dim = density.shape[0], density.dim()
    centers, mask, counts = _pk_bins(n_grid, box_size, dim, num_bins,
                                     density.device)
    mean = torch.mean(density)
    delta = (density - mean) / (mean + 1e-10)
    flat_p = (torch.abs(torch.fft.fftn(delta)) ** 2).reshape(-1)
    sums = torch.sum(torch.where(mask, flat_p[None, :],
                                 torch.zeros((), device=density.device)),
                     dim=1)
    pk = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                     torch.zeros_like(sums))
    return centers, pk


def bao_scale_from_pk(k, pk, k_lo: float = 0.01, k_hi: float = 0.2):
    """BAO scale estimate: 2*pi / k_peak within the window
    (reference: universe_2d.py:1257-1281). Host-side numpy helper."""
    k = k.cpu().numpy() if isinstance(k, torch.Tensor) else np.asarray(k)
    pk = pk.cpu().numpy() if isinstance(pk, torch.Tensor) else np.asarray(pk)
    valid = (k > k_lo) & (k < k_hi) & (pk > 0)
    if valid.sum() <= 3:
        return 0.0
    k_valid = k[valid]
    k_peak = k_valid[int(np.argmax(pk[valid]))]
    return float(2.0 * np.pi / k_peak) if k_peak > 0 else 0.0


def clustering_metric(positions, box_size: float, n_grid: int = 32):
    """Density-contrast std/mean on a coarse grid
    (reference: universe_2d.py:1283-1293); a 0-d tensor."""
    ones = torch.ones(positions.shape[0], dtype=torch.float32,
                      device=positions.device)
    density = ngp_deposit(positions, ones, n_grid, box_size)
    return torch.std(density, correction=0) / (torch.mean(density) + 1e-10)


@functools.lru_cache(maxsize=16)
def _dm_background(box_size: float, n_grid: int, dm_ratio: float, dim: int,
                   device: torch.device) -> torch.Tensor:
    center = _F32(box_size / 2.0)
    mesh = np.meshgrid(*([jax_linspace(0.0, box_size, n_grid)] * dim),
                       indexing="ij")
    r = np.sqrt(sum((m - center) * (m - center) for m in mesh) + _F32(1e-6))
    r_s = _F32(box_size / 4.0)
    x = r / r_s
    y = _F32(1.0) + r / r_s
    rho = _F32(1.0) / (x * (y * y) + _F32(0.1))
    return torch.from_numpy((rho * _F32(dm_ratio)).astype(_F32)).to(device)


def dm_background_field(box_size: float, n_grid: int, dm_ratio: float,
                        dim: int = 2, device=None) -> torch.Tensor:
    """Smooth centered NFW-like dark-matter density field added to the
    deposited grid (reference: universe_2d.py:298-318). Built once per
    geometry and device; the caller must not write into it."""
    return _dm_background(float(box_size), int(n_grid), float(dm_ratio),
                          int(dim), torch.device(device or "cpu"))
