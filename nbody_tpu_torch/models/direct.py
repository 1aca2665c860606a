"""Direct O(N^2) N-body engine: kick-drift-kick leapfrog.

PyTorch counterpart of ``nbody_tpu.models.direct``. The JAX engine runs a
whole history as one ``lax.scan`` program; here the scan is a Python loop
over ticks whose state never leaves the device. Each tick launches its
kernels without waiting on the host, snapshots stay device tensors, and a
run stacks them and copies them to the host once at its end.

Precision ladder:
* degraded modes (f32/bf16/f16/int8/int4/custom) run on ``ParticleState``
  (f32 state) with the quantization hook inside the force kernel;
* the float64 baseline runs on ``BaselineState`` in native f64.

Force paths (``force_impl``): ``auto`` is the sym_force kernel while its
scratch fits ``hopper_nbody.SCRATCH_BUDGET`` and the chunked
Newton's-third-law path past it (the JAX engine's VMEM-residency routing,
with the card's own thresholds); ``kernel``, ``kernel_rows``,
``kernel_streamed`` and ``kernel_sym_chunked`` name the paths directly
(counterparts of ``pallas``, ``pallas_rows``, ``pallas_streamed`` and
``pallas_sym_chunked``); ``dense`` and ``tiled`` are plain PyTorch.

``dt`` and ``softening_sq`` may be run-time 0-d device tensors
(``DirectSimulation(dynamic_params=True)``): a sweep over them changes
no launch parameter, and nothing reads them on the host inside a tick.

``DirectSimulation(mesh=...)`` runs on the multi-device ring
(``parallel/ring.py``), with the state resident between calls, padded to
the shard boundary.

Equal masses: ``uniform_gm=True`` asserts that every mass is equal and
sends the sym kernels to their equal-mass variant (``_force_fn``);
``DirectSimulation`` detects it once at set-up and passes it to every run.

Int-sim grid bounds (``run_steps`` / ``run_with_snapshots``):
``bounds_mode='exact'`` takes the pruned max pass before every force
evaluation, ``bounds_every=k`` reuses bounds for k steps, and
``bounds_mode='cached'`` speculates with the cached grid and verifies it
with the kernel's fused max (``CachedBoundsStepper``).

Spans (``utils.profiler.span``; recorded only while a profiler records):
a single-device history is ``nbody.history``, each tick ``nbody.tick``,
each force evaluation ``nbody.force`` (two a tick under cached bounds),
the int modes' bounds pass ``nbody.bounds`` (inside the force span), each
snapshot ``nbody.snapshot`` and the history's copy to the host
``nbody.to_host``. The ring's runners (``parallel/ring.py``) record the
same names, and their collectives ``nbody.ring.*``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from nbody_tpu_torch.config import DEFAULT_SIM, SimConfig
from nbody_tpu_torch.diagnostics import metrics as metrics_lib
from nbody_tpu_torch.models.state import (
    BaselineState,
    ParticleState,
    make_baseline_state,
    make_state,
)
from nbody_tpu_torch.ops import forces, hopper_nbody as hn
from nbody_tpu_torch.ops.precision import (
    Precision,
    Quantizer,
    dist_sq_log_bounds,
)
from nbody_tpu_torch.parallel import ring
from nbody_tpu_torch.utils.profiler import span

IMPLS = ("auto", "dense", "tiled", "kernel", "kernel_rows",
         "kernel_streamed", "kernel_sym_chunked")

_FORCE_FNS = {
    "dense": forces.dense_accelerations,
    "tiled": forces.tiled_accelerations,
    "kernel": hn.sym_accelerations,
    "kernel_rows": hn.accelerations_rows,
    "kernel_streamed": hn.accelerations_streamed,
    "kernel_sym_chunked": hn.sym_accelerations_chunked,
}

# Paths that take external int-sim grid bounds (bounds_every > 1).
_BOUNDS_REUSE_IMPLS = ("dense", "tiled", "kernel")


def _check_mesh_args(mesh, schedule: str, bounds_every: int,
                     ticks_per_dispatch, dynamic_params: bool,
                     force_impl: str) -> None:
    """The JAX engine's rules for the ring's options (direct.py:523-563)."""
    if schedule not in ("sym", "rows"):
        raise ValueError(f"unknown schedule: {schedule}; valid: sym, rows")
    if mesh is not None:
        mesh.require_single_controller("DirectSimulation(mesh=)")
    if ticks_per_dispatch is not None and mesh is None:
        raise ValueError("ticks_per_dispatch only applies to mesh runs "
                         "(single-device runs are already host-chunkable "
                         "via step()/run())")
    if ticks_per_dispatch is not None and ticks_per_dispatch < 1:
        raise ValueError("ticks_per_dispatch must be >= 1")
    if ticks_per_dispatch is not None and bounds_every > 1:
        raise ValueError("ticks_per_dispatch cannot be combined with "
                         "bounds_every > 1: the bounds-reuse cadence resets "
                         "at each dispatch boundary, silently changing the "
                         "quantization-bounds semantics")
    if mesh is not None and dynamic_params:
        raise ValueError("dynamic_params is not supported with mesh= (the "
                         "ring runners take static dt/softening)")
    if mesh is not None and force_impl != "auto":
        raise ValueError("force_impl is single-device only; mesh runs use "
                         "the ring tile ladder (pass force_impl='auto' with "
                         "mesh=)")
    if bounds_every > 1 and mesh is not None and schedule != "sym":
        raise ValueError("bounds_every > 1 needs schedule='sym' on a mesh "
                         "(the rows schedule has no external-bounds hook); "
                         "it would otherwise be silently ignored")


def _resolve_impl(impl: str, n: int, dim: int = 2) -> str:
    """'auto' is the single-launch sym_force kernel while its scratch
    fits the budget (``hopper_nbody.sym_force_fits``), else the chunked
    path; on CPU tensors both run their kernels' plain versions."""
    if impl not in IMPLS:
        raise ValueError(f"unknown force impl: {impl}; valid: {IMPLS}")
    if impl == "auto":
        return ("kernel" if hn.sym_force_fits(n, dim)
                else "kernel_sym_chunked")
    return impl


def _force_fn(impl: str, n: int, dim: int = 2,
              uniform_gm: bool = False) -> Callable:
    """The force function of ``impl`` (JAX direct.py:55-98).
    ``uniform_gm=True`` asserts equal masses, checked by the caller once:
    the sym kernel and the chunked path then take their equal-mass
    variants through their unguarded inner functions (no host read in a
    tick); the other paths have none, nor has the single launch at an N
    off the tile (the full-tile rule), which keeps the plain call."""
    resolved = _resolve_impl(impl, n, dim)
    fn = hn.prevalidated(_FORCE_FNS[resolved])
    if (uniform_gm and resolved in ("kernel", "kernel_sym_chunked")
            and not (resolved == "kernel" and n % hn.TILE)):
        return functools.partial(fn, uniform_gm=True)
    return fn


def _resolve_device(device) -> torch.device:
    """``cuda`` unless the caller names a device; with no card it raises
    and names the CPU option instead of running on the CPU quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available "
                           f"here (pass device=\"cpu\" to run on the CPU)")
    return device


# --------------------------------------------------------------------------
# Functional core
# --------------------------------------------------------------------------

def leapfrog_step(state: ParticleState, q: Quantizer, cfg: SimConfig,
                  force: Callable, quantize_forces: bool,
                  dt=None, softening_sq=None) -> ParticleState:
    """One KDK step (reference: simulation.py:120-143). ``dt`` and
    ``softening_sq`` optionally replace cfg's with run-time 0-d tensors."""
    dt = cfg.dt if dt is None else dt
    half_dt = dt * 0.5
    vel = state.velocities + state.accelerations * half_dt
    pos = state.positions + vel * dt
    with span("nbody.force"):
        acc = force(pos, state.masses, q, cfg,
                    quantize_forces=quantize_forces,
                    softening_sq=softening_sq)
    vel = vel + acc * half_dt
    return ParticleState(pos, vel, state.masses, acc, state.tick + 1)


def leapfrog_step_baseline(state: BaselineState,
                           cfg: SimConfig) -> BaselineState:
    """One KDK step of the native float64 baseline."""
    half_dt = cfg.dt * 0.5
    vel = state.velocities + state.accelerations * half_dt
    pos = state.positions + vel * cfg.dt
    with span("nbody.force"):
        acc = forces.baseline_accelerations(pos, state.masses, cfg)
    vel = vel + acc * half_dt
    return BaselineState(pos, vel, state.masses, acc, state.tick + 1)


BOUNDS_MODES = ("exact", "cached")

# Device int32 counters of the cached-bounds runs since last cleared, per
# device: [ticks whose fused max left the cached grid (each ran one redo
# launch), ticks whose final grid still clipped the tick's max (0 by
# construction)]. Read with cached_bounds_stats().
CACHED_BOUNDS_STATS: dict = {}


def cached_bounds_stats(device) -> tuple:
    """(violations, clipped) of the cached-bounds runs on ``device`` since
    CACHED_BOUNDS_STATS was last cleared (host read)."""
    stats = CACHED_BOUNDS_STATS.get(str(torch.device(device)))
    return (0, 0) if stats is None else tuple(int(v) for v in stats)


class CachedBoundsStepper:
    """Speculate-and-verify int-sim bounds, the counterpart of JAX's
    ``_cached_bounds_scan`` (direct.py:214-291): the separate max pass
    leaves the steady state.

    Each tick runs one sym_force launch with the cached grid hi and its
    fused max (``emit_max``). If the observed log max escapes the cached
    hi (the grid would clip) or falls more than 3 x ``headroom`` below it
    (the grid went slack), the tick's forces come from a redo launch with
    hi = log max + headroom, which is re-cached. The redo is launched every
    tick with a device skip flag (= not violated), and ``torch.where``
    picks the result and the new hi, so the host never reads anything in a
    tick. The cache starts at -inf, so the first tick always violates.
    ``hi`` and ``log_max`` hold the last tick's values (0-d f32 on the
    device); CACHED_BOUNDS_STATS and hopper_nbody.REDO_LAUNCHES count what
    happened."""

    def __init__(self, q: Quantizer, cfg: SimConfig, impl: str,
                 quantize_forces: bool, n: int, dim: int, headroom: float,
                 dt=None, softening_sq=None, uniform_gm: bool = False):
        resolved = _resolve_impl(impl, n, dim)
        if resolved != "kernel":
            raise ValueError(f"bounds_mode='cached' requires the resident "
                             f"sym kernel (resolved impl '{resolved}'); use "
                             f"bounds_every or impl='kernel'")
        if not q.is_int:
            raise ValueError("bounds_mode='cached' only applies to int-sim "
                             "modes")
        self.q, self.cfg, self.headroom = q, cfg, headroom
        self.soft = cfg.softening_sq if softening_sq is None else softening_sq
        self.dt = cfg.dt if dt is None else dt
        self.force = functools.partial(
            hn.prevalidated(hn.sym_accelerations), q=q, cfg=cfg,
            quantize_forces=quantize_forces, softening_sq=softening_sq,
            uniform_gm=uniform_gm)
        self.hi = self.log_max = None

    def __call__(self, s: ParticleState) -> ParticleState:
        dev = s.positions.device
        if self.hi is None:
            self.hi = torch.full((), float("-inf"), dtype=torch.float32,
                                 device=dev)
            self._headroom = torch.full((), self.headroom,
                                        dtype=torch.float32, device=dev)
            self._log_lo = dist_sq_log_bounds(self.q, self.hi, self.soft)[0]
            self._stats = CACHED_BOUNDS_STATS.setdefault(
                str(dev), torch.zeros(2, dtype=torch.int32, device=dev))
        half_dt = self.dt * 0.5
        vel = s.velocities + s.accelerations * half_dt
        pos = s.positions + vel * self.dt
        with span("nbody.force"):
            acc, max_d2 = self.force(pos, s.masses, log_lo=self._log_lo,
                                     log_hi=self.hi, emit_max=True)
        log_max = dist_sq_log_bounds(self.q, max_d2, self.soft)[1]
        violated = ((log_max > self.hi)
                    | (log_max < self.hi - 3.0 * self._headroom))
        new_hi = log_max + self._headroom
        with span("nbody.force"):
            redo = self.force(pos, s.masses, log_lo=self._log_lo,
                              log_hi=new_hi,
                              skip=(~violated).to(torch.int32),
                              count=hn.redo_counter(dev))
        acc = torch.where(violated, redo, acc)
        self.hi = torch.where(violated, new_hi, self.hi)
        self.log_max = log_max
        self._stats += torch.stack([violated, log_max > self.hi]).to(
            torch.int32)
        vel = vel + acc * half_dt
        return ParticleState(pos, vel, s.masses, acc, s.tick + 1)


def _stepper(q: Quantizer, cfg: SimConfig, impl: str, quantize_forces: bool,
             n: int, dim: int, bounds_every: int = 1, dt=None,
             softening_sq=None, uniform_gm: bool = False,
             bounds_mode: str = "exact", headroom: float = 0.05) -> Callable:
    """A ``step(state) -> state`` closure for the degraded modes.

    ``bounds_every=k>1`` (int-sim modes): the tensor-global log-grid
    bounds are recomputed on the freshly drifted positions every k-th
    step of this stepper and reused in between (the JAX bounds-reuse
    scan; stale bounds can clip, a documented semantic delta). Only the
    paths that take external bounds allow it (``_BOUNDS_REUSE_IMPLS``, as
    in JAX). The step counter lives in the closure, so it runs on across
    snapshot chunks of one history and restarts with each new stepper.
    ``bounds_mode='cached'`` (int-sim modes) is CachedBoundsStepper."""
    if bounds_every < 1:
        raise ValueError("bounds_every must be >= 1")
    if bounds_mode not in BOUNDS_MODES:
        raise ValueError(f"unknown bounds_mode: {bounds_mode}; valid: "
                         f"{BOUNDS_MODES}")
    if bounds_mode == "cached" and not q.is_int:
        raise ValueError("bounds_mode='cached' only applies to int-sim "
                         "modes (float modes have no log grid)")
    if bounds_mode == "cached":
        return CachedBoundsStepper(q, cfg, impl, quantize_forces, n, dim,
                                   headroom, dt, softening_sq, uniform_gm)
    force = _force_fn(impl, n, dim, uniform_gm)
    if not (q.is_int and bounds_every > 1):
        return lambda s: leapfrog_step(s, q, cfg, force, quantize_forces,
                                       dt, softening_sq)

    resolved = _resolve_impl(impl, n, dim)
    if resolved not in _BOUNDS_REUSE_IMPLS:
        raise ValueError(f"bounds_every > 1 is not supported for force "
                         f"impl '{resolved}' (no external-bounds hook); use "
                         f"one of {_BOUNDS_REUSE_IMPLS}")
    max_pass = (hn.max_pairwise_dist_sq_pruned
                if resolved == "kernel" else forces.max_pairwise_dist_sq)
    soft = cfg.softening_sq if softening_sq is None else softening_sq
    dt = cfg.dt if dt is None else dt
    half_dt = dt * 0.5
    k = 0
    bounds = None

    def step(s: ParticleState) -> ParticleState:
        nonlocal k, bounds
        vel = s.velocities + s.accelerations * half_dt
        pos = s.positions + vel * dt
        with span("nbody.force"):
            if k % bounds_every == 0:
                with span("nbody.bounds"):
                    bounds = dist_sq_log_bounds(
                        q, max_pass(pos, cfg, softening_sq=softening_sq),
                        soft)
            acc = force(pos, s.masses, q, cfg,
                        quantize_forces=quantize_forces,
                        softening_sq=softening_sq, log_lo=bounds[0],
                        log_hi=bounds[1])
        vel = vel + acc * half_dt
        k += 1
        return ParticleState(pos, vel, s.masses, acc, s.tick + 1)

    return step


@hn.guard_uniform_gm(("masses", (0,)))
def run_steps(state: ParticleState, q: Quantizer, cfg: SimConfig, impl: str,
              quantize_forces: bool, num_steps: int, dt=None,
              softening_sq=None, bounds_every: int = 1,
              uniform_gm: bool = False, bounds_mode: str = "exact",
              headroom: float = 0.05) -> ParticleState:
    """num_steps leapfrog steps, state kept on the device. Optional
    run-time dt/softening_sq (0-d tensors) replace cfg's.

    Int-sim grid-bounds policies (JAX direct.py:299-352): ``bounds_mode=
    'exact'`` takes the pruned max pass before every force evaluation;
    ``'cached'`` speculates with the previous grid and verifies it with the
    kernel's fused max (CachedBoundsStepper: no clipping, grid hi within
    ``headroom`` log-units of exact; on the H100 it pays only where the
    pruned max pass falls back to the full pass, a near-spherical shell,
    and costs a few % a tick elsewhere); ``bounds_every=k>1`` reuses bounds
    blindly for k steps. ``uniform_gm=True`` asserts equal masses
    (checked here on the host, once, unless called through
    ``hopper_nbody.prevalidated``)."""
    if bounds_mode == "cached" and q.is_int and bounds_every != 1:
        raise ValueError("bounds_mode='cached' and bounds_every>1 are "
                         "mutually exclusive bounds policies")
    step = _stepper(q, cfg, impl, quantize_forces, *state.positions.shape,
                    bounds_every, dt, softening_sq, uniform_gm, bounds_mode,
                    headroom)
    for _ in range(num_steps):
        with span("nbody.tick"):
            state = step(state)
    return state


def run_steps_baseline(state: BaselineState, cfg: SimConfig,
                       num_steps: int) -> BaselineState:
    for _ in range(num_steps):
        with span("nbody.tick"):
            state = leapfrog_step_baseline(state, cfg)
    return state


def _concat_chunk_parts(parts):
    """Concatenate (snapshots, frames) parts of one history, each stacked
    over its chunks, along the chunk axis."""
    if len(parts) == 1:
        return parts[0]
    snaps = metrics_lib.Snapshot(*(
        np.concatenate([getattr(p[0], f) for p in parts])
        for f in metrics_lib.Snapshot._fields))
    return snaps, np.concatenate([p[1] for p in parts])


def _run_chunks(state, step: Callable, steps_per_chunk: int, num_chunks: int,
                snap_fn: Callable):
    """One history on one device, in spans (``utils.profiler.span``):
    ``nbody.history`` around it, ``nbody.tick`` around each step,
    ``nbody.snapshot`` around each snapshot and ``nbody.to_host`` around
    the history's one copy to the host."""
    with span("nbody.history"):
        snaps, frames = [], []
        for _ in range(num_chunks):
            for _ in range(steps_per_chunk):
                with span("nbody.tick"):
                    state = step(state)
            with span("nbody.snapshot"):
                snap, frame = snap_fn(state)
            snaps.append(snap)
            frames.append(frame)
        with span("nbody.to_host"):
            return (state, metrics_lib.stack_snapshots(snaps),
                    torch.stack(frames).cpu().numpy())


@hn.guard_uniform_gm(("masses", (0,)))
def run_with_snapshots(state: ParticleState, q: Quantizer, cfg: SimConfig,
                       impl: str, quantize_forces: bool,
                       steps_per_chunk: int, num_chunks: int,
                       num_bins: int = 20, dt=None, softening_sq=None,
                       bounds_every: int = 1, uniform_gm: bool = False,
                       bounds_mode: str = "exact", headroom: float = 0.05):
    """Run num_chunks * steps_per_chunk ticks; take a metrics Snapshot and
    a position frame after each chunk on the device. Returns
    (state, snapshots, frames): snapshots as a Snapshot of numpy arrays
    stacked over chunks, frames as a (num_chunks, N, D) numpy array, both
    copied to the host once at the end. Optional run-time dt/softening_sq
    drive the steps; the snapshots' potential energy uses cfg's softening,
    as the JAX engine's fused snapshot does. ``bounds_every``,
    ``uniform_gm``, ``bounds_mode`` and ``headroom`` follow run_steps."""
    step = _stepper(q, cfg, impl, quantize_forces, *state.positions.shape,
                    bounds_every, dt, softening_sq, uniform_gm, bounds_mode,
                    headroom)

    def snap(s: ParticleState):
        return (metrics_lib.snapshot(s.positions, s.velocities, s.masses,
                                     s.tick, cfg, num_bins=num_bins),
                s.positions)

    return _run_chunks(state, step, steps_per_chunk, num_chunks, snap)


def run_with_snapshots_baseline(state: BaselineState, cfg: SimConfig,
                                steps_per_chunk: int, num_chunks: int,
                                num_bins: int = 20):
    """run_with_snapshots for the f64 baseline; metrics see the state
    rounded to f32, as in the JAX package."""
    def snap(s: BaselineState):
        f32 = s.to_f32()
        return (metrics_lib.snapshot(f32.positions, f32.velocities,
                                     f32.masses, f32.tick, cfg,
                                     num_bins=num_bins, compensated=True),
                f32.positions)

    return _run_chunks(state, lambda s: leapfrog_step_baseline(s, cfg),
                       steps_per_chunk, num_chunks, snap)


# --------------------------------------------------------------------------
# Engine wrapper (reference-parity API)
# --------------------------------------------------------------------------

class DirectSimulation:
    """Stateful wrapper mirroring the reference's GalaxySimulation API
    (reference: simulation.py:12-196): step / run / get_state / energies.

    The run is on ``device``: ``cuda`` unless the caller names one (pass
    ``device="cpu"`` for the CPU; with no card the default raises).
    ``force_impl`` is one of ``IMPLS`` (module docstring); auto is the
    sym_force kernel or, past its scratch budget, the chunked path (their
    plain versions on a CPU tensor). Equal masses are detected once, here
    (one host read), and every run takes the sym kernels' equal-mass
    variant (``_uniform_gm``, JAX direct.py:546-548).
    ``dynamic_params=True`` keeps dt and softening^2 as 0-d device
    tensors (``_dyn_dt``, ``_dyn_soft_sq``); the kernels then mask the
    diagonal by id, as the JAX kernels do for a traced softening.

    ``mesh`` (a ``parallel.ring.ParticleMesh``) shards the particles over
    the ring, ``schedule`` picks its force schedule ('sym', the half
    ring, or 'rows'), and the state stays resident on the mesh's first
    device, padded to the shard boundary; every user surface trims it.
    ``ticks_per_dispatch`` caps the ticks of each call into the ring
    runners (whole snapshot chunks), with identical physics: the only
    cost is one more entry force evaluation per call."""

    def __init__(self, positions, velocities, masses,
                 precision: Quantizer | Precision | str = Precision.FLOAT32,
                 cfg: SimConfig = DEFAULT_SIM,
                 G: Optional[float] = None,
                 softening: Optional[float] = None,
                 dt: Optional[float] = None,
                 force_impl: str = "auto",
                 quantize_forces: Optional[bool] = None,
                 custom_levels: int = 64,
                 dynamic_params: bool = False,
                 mesh=None,
                 schedule: str = "sym",
                 bounds_every: int = 1,
                 ticks_per_dispatch: Optional[int] = None,
                 device=None):
        _check_mesh_args(mesh, schedule, bounds_every, ticks_per_dispatch,
                         dynamic_params, force_impl)
        if isinstance(precision, str):
            precision = Quantizer.from_string(precision, custom_levels)
        elif isinstance(precision, Precision):
            precision = Quantizer(mode=precision, custom_levels=custom_levels)
        self.quantizer = precision
        if dynamic_params and precision.mode == Precision.FLOAT64:
            raise ValueError("dynamic_params is not supported for the "
                             "float64 baseline (it uses the static cfg); "
                             "sweep with static configs")
        self.device = (mesh.devices[0] if mesh is not None
                       else _resolve_device(device))
        self._dyn_dt = None
        self._dyn_soft_sq = None
        if dynamic_params:
            # dt and softening^2 become run-time device scalars; G stays
            # static (it scales the G*m the kernels read).
            s = softening if softening is not None else cfg.softening
            self._dyn_dt = torch.full((), dt if dt is not None else cfg.dt,
                                      dtype=torch.float32, device=self.device)
            self._dyn_soft_sq = torch.full((), s * s, dtype=torch.float32,
                                           device=self.device)
            if G is not None:
                cfg = SimConfig(G=G, softening=cfg.softening, dt=cfg.dt)
        elif G is not None or softening is not None or dt is not None:
            cfg = SimConfig(
                G=G if G is not None else cfg.G,
                softening=softening if softening is not None else cfg.softening,
                dt=dt if dt is not None else cfg.dt)
        self.cfg = cfg
        self.force_impl = force_impl
        if quantize_forces is None:
            # Reference applies force quantization only for int8/int4
            # (simulation.py:115-116), not CUSTOM.
            quantize_forces = self.quantizer.mode in (Precision.INT4_SIM,
                                                      Precision.INT8_SIM)
        self.quantize_forces = quantize_forces
        self.bounds_every = bounds_every
        self.is_baseline = self.quantizer.mode == Precision.FLOAT64
        self.mesh = mesh
        self.schedule = schedule
        self.ticks_per_dispatch = ticks_per_dispatch

        if self.is_baseline:
            self.state = make_baseline_state(positions, velocities, masses,
                                             self.device)
            _resolve_impl(force_impl, *self.state.positions.shape)
        else:
            self.state = make_state(positions, velocities, masses,
                                    self.device)
        self._n_total = self.state.positions.shape[0]
        m = self.state.masses
        self._uniform_gm = bool(m.numel() > 0 and (m == m[0]).all())
        # Mesh runs recompute the acceleration from the positions at the
        # entry of every call (a pure function of them), so the stored
        # zeros never reach the integrator.
        if mesh is None:
            if self.is_baseline:
                acc = forces.baseline_accelerations(self.state.positions,
                                                    self.state.masses, cfg)
            else:
                acc = _force_fn(force_impl, *self.state.positions.shape,
                                self._uniform_gm)(
                    self.state.positions, self.state.masses, self.quantizer,
                    cfg, quantize_forces=self.quantize_forces,
                    softening_sq=self._dyn_soft_sq)
            self.state = self.state._replace(accelerations=acc)

    # -- stepping -----------------------------------------------------------

    @property
    def tick(self) -> int:
        return self.state.tick

    def _trim(self, x: torch.Tensor) -> torch.Tensor:
        """Strip the mesh's phantom padding rows (a no-op otherwise)."""
        return x[:self._n_total]

    @property
    def positions(self) -> torch.Tensor:
        return self._trim(self.state.positions.to(torch.float32))

    @property
    def velocities(self) -> torch.Tensor:
        return self._trim(self.state.velocities.to(torch.float32))

    @property
    def masses(self) -> torch.Tensor:
        return self._trim(self.state.masses.to(torch.float32))

    def step(self, num_steps: int = 1):
        tpd = self.ticks_per_dispatch
        done = 0
        while done < num_steps:
            n = num_steps - done if tpd is None else min(tpd,
                                                         num_steps - done)
            self._step_dispatch(n)
            done += n

    def _step_dispatch(self, num_steps: int):
        if self.mesh is not None:
            if self.is_baseline:
                self.state = ring.run_steps_sharded_baseline(
                    self.state, self.cfg, self.mesh, num_steps,
                    gather=False, n_total=self._n_total)
            else:
                self.state, _ = hn.prevalidated(ring.run_steps_sharded)(
                    self.state, self.quantizer, self.cfg, self.mesh,
                    num_steps, quantize_forces=self.quantize_forces,
                    gather=False, schedule=self.schedule,
                    n_total=self._n_total, bounds_every=self.bounds_every,
                    uniform_gm=self._uniform_gm)
        elif self.is_baseline:
            self.state = run_steps_baseline(self.state, self.cfg, num_steps)
        else:
            self.state = hn.prevalidated(run_steps)(
                self.state, self.quantizer, self.cfg, self.force_impl,
                self.quantize_forces, num_steps, dt=self._dyn_dt,
                softening_sq=self._dyn_soft_sq,
                bounds_every=self.bounds_every, uniform_gm=self._uniform_gm)

    def run(self, num_ticks: int, callback: Optional[Callable] = None,
            callback_interval: int = 100):
        """Chunked run with an optional host callback at interval
        boundaries (reference: simulation.py:145-158)."""
        if callback is None:
            self.step(num_ticks)
            return
        done = 0
        while done < num_ticks:
            chunk = min(callback_interval, num_ticks - done)
            self.step(chunk)
            done += chunk
            callback(self, self.tick)

    def run_with_history(self, num_ticks: int, snapshot_interval: int = 100,
                         num_bins: int = 20):
        """Run with on-device snapshots; returns (snapshots, frames) stacked
        over snapshot boundaries, copied to the host once.

        Snapshots land at interval multiples; any remainder ticks are still
        run (reference: simulation.py:154-158)."""
        num_chunks = max(num_ticks // snapshot_interval, 1)
        steps = (snapshot_interval if num_ticks >= snapshot_interval
                 else num_ticks)
        if self.mesh is not None:
            snaps, frames = self._mesh_history(num_chunks, steps, num_bins)
        elif self.is_baseline:
            self.state, snaps, frames = run_with_snapshots_baseline(
                self.state, self.cfg, steps, num_chunks, num_bins)
        else:
            self.state, snaps, frames = hn.prevalidated(run_with_snapshots)(
                self.state, self.quantizer, self.cfg, self.force_impl,
                self.quantize_forces, steps, num_chunks, num_bins,
                dt=self._dyn_dt, softening_sq=self._dyn_soft_sq,
                bounds_every=self.bounds_every, uniform_gm=self._uniform_gm)
        remainder = num_ticks - steps * num_chunks
        if remainder > 0:
            self.step(remainder)
        return snaps, frames

    def _mesh_history(self, num_chunks: int, steps: int, num_bins: int):
        """The mesh's history: one ring-runner call, or, under
        ticks_per_dispatch, whole snapshot chunks per call (as many as fit
        the cap) with the resident state chained between calls; a cap
        below the snapshot interval advances each chunk's leading ticks
        with capped step() calls first."""
        def one_call(n_chunks, chunk_steps):
            if self.is_baseline:
                st, sn, fr = ring.run_with_snapshots_sharded_baseline(
                    self.state, self.cfg, self.mesh, chunk_steps, n_chunks,
                    num_bins=num_bins, n_total=self._n_total)
            else:
                st, sn, fr = hn.prevalidated(ring.run_with_snapshots_sharded)(
                    self.state, self.quantizer, self.cfg, self.mesh,
                    chunk_steps, n_chunks,
                    quantize_forces=self.quantize_forces, num_bins=num_bins,
                    schedule=self.schedule, n_total=self._n_total,
                    bounds_every=self.bounds_every,
                    uniform_gm=self._uniform_gm)
            self.state = st
            return sn, fr

        tpd = self.ticks_per_dispatch
        if tpd is None:
            return one_call(num_chunks, steps)
        parts = []
        if steps <= tpd:
            per = tpd // steps
            done = 0
            while done < num_chunks:
                n = min(per, num_chunks - done)
                parts.append(one_call(n, steps))
                done += n
        else:
            tail = steps % tpd or tpd
            for _ in range(num_chunks):
                self.step(steps - tail)
                parts.append(one_call(1, tail))
        return _concat_chunk_parts(parts)

    # -- diagnostics --------------------------------------------------------

    def get_kinetic_energy(self) -> float:
        return float(metrics_lib.kinetic_energy(self.velocities, self.masses))

    def get_potential_energy(self) -> float:
        if self.mesh is not None:
            # The O(N^2) pair sum stays on the ring; phantom rows of the
            # resident padded state are left out past n_total.
            return float(ring.ring_potential_energy(
                self.state.positions, self.state.masses, self.cfg, self.mesh,
                n_total=self._n_total, compensated=self.is_baseline))
        return float(metrics_lib.potential_energy(
            self.positions, self.masses, self.cfg,
            softening_sq=self._dyn_soft_sq, compensated=self.is_baseline))

    def get_total_energy(self) -> float:
        if self.mesh is not None:
            return self.get_kinetic_energy() + self.get_potential_energy()
        return float(metrics_lib.total_energy(
            self.positions, self.velocities, self.masses, self.cfg,
            softening_sq=self._dyn_soft_sq, compensated=self.is_baseline))

    def get_state(self) -> dict:
        """Reference-parity state export (reference: simulation.py:160-168)."""
        return {
            "positions": self.positions,
            "velocities": self.velocities,
            "masses": self.masses,
            "tick": self.tick,
            "precision_mode": self.quantizer.mode.value,
        }


def run_comparison(positions, velocities, masses, modes,
                   num_ticks: int = 1000, snapshot_interval: int = 100,
                   **sim_kwargs):
    """Same ICs under several precision modes
    (reference: simulation.py:199-250). Returns {mode_value: {...}}.
    ``sim_kwargs`` go to DirectSimulation (``device="cpu"`` for the CPU)."""
    results = {}
    for mode in modes:
        sim = DirectSimulation(positions, velocities, masses,
                               precision=mode, **sim_kwargs)
        e0 = sim.get_total_energy()
        snaps, frames = sim.run_with_history(num_ticks, snapshot_interval)
        results[sim.quantizer.mode.value] = {
            "final_state": sim.get_state(),
            "snapshots": snaps,
            "frames": frames,
            "initial_energy": e0,
            "simulation": sim,
        }
    return results
