"""Unified cosmological particle-mesh engine (2-D and 3-D).

PyTorch counterpart of ``nbody_tpu.engines.cosmo`` (reference:
universe_2d.py:884-1289, universe_3d.py:1087-1351,
universe_genesis.py:217-511, ultimate_reality_engine.py:165-526,
realtime_reality_engine.py:187-345). What differs from the JAX engine:

* the evolution is a host loop of device ops over a precomputed
  (z, dt, H, a) schedule (JAX: one jitted ``lax.scan``); nothing in the
  step reads a device value on the host: the schedule reaches the device
  by a non-blocking copy from pinned memory and the per-step scalars
  (kinetic energy, momentum, subnormal census) stay on the device until
  ``collect_step``;
* ``dispatch_step`` enqueues a chunk and its probe bundle, starts
  non-blocking copies of everything the host half reads into pinned host
  buffers and records a CUDA event; ``collect_step`` waits on that event
  and runs the host detectors, so chunk k's detectors overlap chunk k+1's
  device work (``run_to_completion(pipelined=True)``);
* ``redshift`` and ``tick`` are host values of the state (f32-exact),
  the JAX engine's host shadows made the state itself;
* the ICs draw their phases from a ``torch.Generator`` seeded by ``seed``
  (JAX: ``jax.random``), on the CPU whatever the engine's device, so a
  seed gives the same ICs on every device but not JAX's;
* ``mesh=`` (a ``parallel.ring.ParticleMesh``) runs every step through the
  sharded PM of ``parallel/pm_sharded.py`` under one controller; the
  resident state is padded to the shard boundary and lives on the mesh's
  first device, the engine's device.

The engine runs on ``cuda`` unless given ``device="cpu"``, and raises
when there is no card. The mass deposit is the hand-written kernel of
``ops/pm.py`` (``csrc/pm_deposit.cu``) on the card.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from nbody_tpu_torch.config import PLANCK18, Cosmology
from nbody_tpu_torch.diagnostics import glitch as glitch_lib
from nbody_tpu_torch.engines.epochs import EPOCHS, get_current_epoch
from nbody_tpu_torch.models.direct import _resolve_device
from nbody_tpu_torch.models.state import CosmoState, cosmo_from_jax_numpy
from nbody_tpu_torch.ops import pm
from nbody_tpu_torch.ops.precision import (
    Precision,
    Quantizer,
    describe_mode,
    quantize_force,
)
from nbody_tpu_torch.parallel.ring import (
    _normalise,
    _pad_to_shards,
    _reduce,
    _replicate,
    _shards,
)

logger = logging.getLogger("nbody_tpu_torch.cosmo")

G_NEWTON = 4.302e-6  # (km/s)^2 Mpc / M_sun (reference: universe_2d.py:176)
RHO_CRIT = 2.775e11  # M_sun / (Mpc/h)^3 (reference: universe_2d.py:1009)


@dataclasses.dataclass(frozen=True)
class PMConfig:
    """Static engine geometry/physics knobs (hashable)."""

    dim: int = 2
    n_grid: int = 128
    box_size: float = 200.0
    dm_ratio: float = 5.0
    deposit: str = "ngp"          # "ngp" (reference parity) or "cic"
    G: float = G_NEWTON
    min_redshift: float = 0.01
    hubble_drag: float = 2.0      # drag coefficient (reference: 2*H*v)
    unit_scale: float = 1e-3      # the reference's ad-hoc kpc/km unit fudge


class StepStream(NamedTuple):
    """Per-step scalars of a chunk for the host detectors."""

    kinetic: torch.Tensor      # (steps,)
    momentum: torch.Tensor     # (steps, D)
    subnormals: torch.Tensor   # (steps,) int32
    redshift: torch.Tensor     # (steps,)


class ProbeBundle(NamedTuple):
    """Per-chunk structure + exploit metrics of one probe dispatch
    (reference computes these in separate passes: BAO/clustering
    universe_2d.py:1203-1255, exploit probes :818-877)."""

    k_centers: torch.Tensor    # (num_bins-1,) power-spectrum bin centers
    pk: torch.Tensor           # (num_bins-1,) binned P(k)
    clustering: torch.Tensor   # scalar density contrast std/mean
    exploit: glitch_lib.ExploitDeviceMetrics


def probe_bundle(positions, velocities, prev_positions, obs_pos, obs_dir,
                 box_size: float, c_sim: float, fov_cos: float) -> ProbeBundle:
    """The power spectrum, the clustering metric and the exploit device
    metrics of the state, enqueued together so the pipelined engine makes
    one host copy of them a chunk."""
    k, pk_ = pm.power_spectrum(positions, box_size)
    clus = pm.clustering_metric(positions, box_size)
    dm = glitch_lib.exploit_device_metrics(positions, velocities,
                                           prev_positions, obs_pos, obs_dir,
                                           c_sim, fov_cos)
    return ProbeBundle(k, pk_, clus, dm)


def probe_bundle_sharded(positions, velocities, prev_positions, obs_pos,
                         obs_dir, box_size: float, c_sim: float,
                         fov_cos: float, n_valid: int, mesh) -> ProbeBundle:
    """probe_bundle for the padded resident state of a mesh engine:
    per-shard NGP deposits of the real rows at 64 and 32, each summed in
    shard order (psum), and masked partial sums for the exploit scalars
    (the velocity spread in two passes). Matches probe_bundle on the
    trimmed state up to f32 summation order; on a mesh of one, where
    nothing is padded and every collective is the identity, it is
    probe_bundle itself."""
    if mesh.size == 1 and positions.shape[0] == n_valid:
        return probe_bundle(positions, velocities, prev_positions, obs_pos,
                            obs_dir, box_size, c_sim, fov_cos)
    ids = torch.arange(positions.shape[0], dtype=torch.int32,
                       device=positions.device)
    p_l, v_l, pv_l, ids_l = (_shards(x, mesh) for x in
                             (positions, velocities, prev_positions, ids))
    valid = [i < n_valid for i in ids_l]
    w_l = [ok.to(torch.float32) for ok in valid]

    def psum(values):
        return _reduce(values, torch.add, mesh)

    d64 = psum([pm.ngp_deposit(p, w, 64, box_size)
                for p, w in zip(p_l, w_l)])
    d32 = psum([pm.ngp_deposit(p, w, 32, box_size)
                for p, w in zip(p_l, w_l)])
    k, pk_ = pm.pk_from_density(d64, box_size)
    clus = torch.std(d32, correction=0) / (torch.mean(d32) + 1e-10)

    rows = [glitch_lib.exploit_row_metrics(p, v, pv, op, od, c_sim, fov_cos)
            for p, v, pv, op, od in zip(p_l, v_l, pv_l,
                                        _replicate(obs_pos, mesh),
                                        _replicate(obs_dir, mesh))]
    dim = velocities.shape[1]
    cnt = torch.clamp(psum([torch.sum(w) for w in w_l]), min=1.0)
    mu = psum([torch.sum(v * w[:, None]) for v, w in zip(v_l, w_l)]) \
        / (cnt * dim)
    var = psum([torch.sum(((v - m) ** 2) * w[:, None])
                for v, w, m in zip(v_l, w_l, _replicate(mu, mesh))]) \
        / (cnt * dim)

    def count(pick):
        return psum([torch.sum(pick(r) & ok) for r, ok in zip(rows, valid)]
                    ).to(torch.int32)

    dm = glitch_lib.ExploitDeviceMetrics(
        max_gamma=_reduce([torch.amax(torch.where(ok, r[0], 1.0))
                           for r, ok in zip(rows, valid)], torch.maximum,
                          mesh),
        near_c_09=count(lambda r: r[1] > 0.9),
        near_c_099=count(lambda r: r[1] > 0.99),
        v_mean=psum([torch.sum(r[2] * w) for r, w in zip(rows, w_l)]) / cnt,
        v_std=torch.sqrt(var),
        in_frustum=count(lambda r: r[3]),
        snap_events=count(lambda r: r[4]),
    )
    return ProbeBundle(k, pk_, clus, dm)


class PendingChunk(NamedTuple):
    """Host buffers + metadata of one dispatched-but-uncollected chunk
    (dispatch_step -> collect_step). The tensors are host tensors (pinned
    on a card) whose copies from the device may still be in flight until
    ``event`` completes."""

    num_steps: int
    tick_start: int           # tick BEFORE the chunk
    z_end: float              # f32-exact end-of-chunk redshift
    stream: StepStream
    probes: ProbeBundle
    positions: torch.Tensor   # post-chunk snapshot
    velocities: torch.Tensor
    snap_stride: int = 1      # >1: snapshot already decimated on device
    event: Optional[torch.cuda.Event] = None


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that will hold ``t``: a non-blocking copy into pinned
    memory from a card, ``t`` itself on the CPU."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _tree_to_host(tree):
    if isinstance(tree, torch.Tensor):
        return _to_host(tree)
    leaves = [_tree_to_host(x) for x in tree]
    return type(tree)(*leaves) if hasattr(tree, "_fields") else leaves


# --------------------------------------------------------------------------
# Initial conditions: gridded particles + P(k)-with-BAO Zel'dovich offsets
# --------------------------------------------------------------------------

def zeldovich_from_uniform(uniform, num_side: int, cfg: PMConfig,
                           start_redshift: float,
                           cosmo: Cosmology = PLANCK18):
    """Perturbed-lattice ICs from ``uniform``, the (num_side,)*D draws in
    [0, 1) behind the random phases (reference: universe_2d.py:949-1013):
    uniform grid + FFT-synthesised displacement field from a power
    spectrum with BAO wiggles, Zel'dovich-scaled by the growth factor,
    with velocities proportional to the displacement (a H f psi).
    ``nbody_tpu.engines.cosmo.make_zeldovich_ics`` after its draw, op for
    op, on ``uniform``'s device. Returns (positions, velocities, masses)."""
    uniform = torch.as_tensor(uniform, dtype=torch.float32)
    device = uniform.device
    dim, box = cfg.dim, cfg.box_size
    n = num_side

    spacing = box / n
    axis = pm.jax_linspace(spacing / 2, box - spacing / 2, n)
    mesh = np.meshgrid(*([axis] * dim), indexing="ij")
    positions = torch.from_numpy(
        np.stack([m.reshape(-1) for m in mesh], axis=1)).to(device)

    k1d = pm.jax_fftfreq(n, box / n) * np.float32(2) * np.float32(math.pi)
    kvecs = [torch.from_numpy(k).to(device)
             for k in np.meshgrid(*([k1d] * dim), indexing="ij")]
    k_mag = torch.sqrt(sum(k * k for k in kvecs) + 1e-10)

    # P(k) with BAO wiggles (reference: universe_2d.py:978-982)
    k_bao = 2 * math.pi / cosmo.bao_scale_mpc
    pk_ = (torch.pow(k_mag / 0.1 + 1e-10, cosmo.n_s - 4.0)
           * torch.exp(-((k_mag / 0.5) * (k_mag / 0.5))))
    pk_ = pk_ * (1.0 + 0.15 * torch.cos(k_mag / k_bao * math.pi))

    phases = uniform * 2 * math.pi
    delta_k = torch.sqrt(pk_) * torch.exp(1j * phases)

    psi_k = delta_k / (k_mag * k_mag + 1e-10)
    psi_k[(0,) * dim] = 0.0

    disps = [torch.real(torch.fft.ifftn(-1j * kv * psi_k)).reshape(-1)
             for kv in kvecs]
    displacement = torch.stack(disps, dim=1)

    growth = cosmo.growth_factor(start_redshift)
    amplitude = 5.0 * growth
    positions = (positions + displacement * amplitude) % box

    f_growth = cosmo.omega_m ** 0.55
    H_z = cosmo.hubble_parameter(start_redshift)
    a = 1.0 / (1.0 + start_redshift)
    velocities = a * H_z * f_growth * displacement * amplitude * cfg.unit_scale

    # Masses: effective mean matter density over the box
    # (reference: universe_2d.py:1008-1011)
    if dim == 2:
        total_mass = cosmo.omega_m * RHO_CRIT * box ** 2 * 10.0
    else:
        total_mass = cosmo.omega_m * RHO_CRIT * box ** 3
    masses = torch.full((n ** dim,), total_mass / n ** dim,
                        dtype=torch.float32, device=device)
    return (positions.to(torch.float32), velocities.to(torch.float32),
            masses)


def make_zeldovich_ics(generator: torch.Generator, num_side: int,
                       cfg: PMConfig, start_redshift: float,
                       cosmo: Cosmology = PLANCK18):
    """Perturbed-lattice ICs with their phases drawn from ``generator``
    (a CPU ``torch.Generator``), built on the CPU."""
    uniform = torch.rand((num_side,) * cfg.dim, generator=generator,
                         dtype=torch.float32)
    return zeldovich_from_uniform(uniform, num_side, cfg, start_redshift,
                                  cosmo)


# --------------------------------------------------------------------------
# Functional PM step
# --------------------------------------------------------------------------

def pm_accelerations(positions, masses, q: Quantizer, cfg: PMConfig,
                     scale, quantize_forces: bool):
    """One PM force evaluation (reference: universe_2d.py:1015-1075)."""
    deposit = pm.cic_deposit if cfg.deposit == "cic" else pm.ngp_deposit
    gather = pm.cic_gather if cfg.deposit == "cic" else pm.ngp_gather

    density = deposit(positions, masses, cfg.n_grid, cfg.box_size)
    if cfg.dm_ratio > 0:
        dm = pm.dm_background_field(cfg.box_size, cfg.n_grid, cfg.dm_ratio,
                                    cfg.dim, density.device)
        density = density + dm * torch.mean(density)

    grids = pm.poisson_accel_grids(density, cfg.box_size, cfg.n_grid, q,
                                   cfg.G, scale, cfg.dim)
    acc = gather(grids, positions, cfg.n_grid, cfg.box_size)
    # Reference PM engines apply quantize_force only for INT4/INT8
    # (universe_2d.py:1071-1072), NOT for CUSTOM level counts — gate on
    # the mode, not q.is_int (which includes CUSTOM).
    if quantize_forces and q.mode in (Precision.INT4_SIM, Precision.INT8_SIM):
        acc = quantize_force(acc, q)
    return acc.to(torch.float32)


def run_pm_steps(state: CosmoState, schedule, q: Quantizer, cfg: PMConfig,
                 quantize_forces: bool = True):
    """Advance ``state`` over a host (z_new, dt_gyr, H, a) schedule, one
    float32 array each, as a host loop of device ops with no host read.

    Integration (reference: universe_2d.py:1196-1209):
        v += a_grav * dt - hubble_drag * H * v * dt * unit_scale
        x  = (x + v * dt / a * unit_scale) mod box
    Returns (state, StepStream)."""
    sched_host = np.stack([np.asarray(x, np.float32) for x in schedule])
    steps = sched_host.shape[1]
    sched = glitch_lib.to_device_async(sched_host, state.positions.device)
    pos, vel, masses = state.positions, state.velocities, state.masses
    kes, moms, subs = [], [], []
    for i in range(steps):
        dtn, Hn, an = sched[1, i], sched[2, i], sched[3, i]
        acc = pm_accelerations(pos, masses, q, cfg, an, quantize_forces)
        vel = (vel + acc * dtn
               - cfg.hubble_drag * Hn * vel * dtn * cfg.unit_scale)
        pos = (pos + vel * dtn / an * cfg.unit_scale) % cfg.box_size
        kes.append(0.5 * torch.sum(masses * torch.sum(vel * vel, dim=-1)))
        moms.append(torch.sum(masses[:, None] * vel, dim=0))
        subs.append(glitch_lib.count_subnormals(pos).subnormal_count)
    new = CosmoState(pos, vel, masses, float(sched_host[0, -1]),
                     state.tick + steps)
    return new, StepStream(torch.stack(kes), torch.stack(moms),
                           torch.stack(subs), sched[0])


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

class CosmologicalEngine:
    """Stateful wrapper with the reference's Universe2D/3D API surface:
    step / run_to_completion / power spectrum / BAO / clustering /
    glitch + exploit histories (reference: universe_2d.py:884-1293)."""

    def __init__(self, num_particles: int = 10000, box_size_mpc: float = 200.0,
                 start_redshift: float = 50.0, precision: str = "float32",
                 dm_ratio: float = 5.0, seed: int = 42, dim: int = 2,
                 n_grid: Optional[int] = None, deposit: str = "ngp",
                 cosmo: Cosmology = PLANCK18, min_redshift: float = 0.01,
                 glitch_threshold: float = 0.05, ic_fn=None, mesh=None,
                 snapshot_cap: Optional[int] = None, device=None):
        # Optional 1-D particle mesh: every step runs the sharded PM
        # (replicated grid below 256^dim, slab-decomposed FFT from there,
        # parallel/pm_sharded.py); the engine lives on its first device.
        self.mesh = mesh
        self.device = self._mesh_device(mesh, device)
        self.cosmo = cosmo
        if n_grid is None:
            n_grid = 128 if dim == 2 else 32
        self.cfg = PMConfig(dim=dim, n_grid=n_grid, box_size=box_size_mpc,
                            dm_ratio=dm_ratio, deposit=deposit,
                            # Normalize to the f32-representable value: the
                            # schedule clamps z at min_redshift in f64 but
                            # the state stores f32, so a min_redshift that
                            # rounds UP in f32 (0.1, 0.3, ...) would leave
                            # the redshift strictly above the raw threshold
                            # and run_to_completion would spin forever on
                            # 1-step chunks.
                            min_redshift=float(np.float32(min_redshift)))
        self._G_newton = self.cfg.G
        self.quantizer = Quantizer.from_string(precision)
        self.precision_str = precision
        # Optional cap on the per-chunk diagnostic snapshot: above the cap
        # the post-chunk (positions, velocities) handed to the host
        # detectors are decimated on the device with a uniform stride
        # before the host copy starts; the physics state is untouched.
        self.snapshot_cap = (int(snapshot_cap)
                             if snapshot_cap and snapshot_cap > 0 else None)

        num_side = max(2, round(num_particles ** (1.0 / dim)))
        self.num_particles = num_side ** dim
        self.num_side = num_side
        self.seed = seed

        self.start_redshift = float(start_redshift)
        self.glitch_detector = glitch_lib.GlitchDetector(glitch_threshold)
        self.exploit_engine = glitch_lib.PhysicsExploitEngine()
        self.completed = False
        self.running = True
        self.current_epoch = get_current_epoch(start_redshift)

        generator = torch.Generator().manual_seed(seed)
        ic_fn = ic_fn or make_zeldovich_ics
        pos, vel, masses = (
            torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, dtype=torch.float32).to(self.device)
            for x in ic_fn(generator, num_side, self.cfg,
                           self.start_redshift, cosmo))

        # Normalize masses to O(1) and fold the physical mass unit into G
        # (the JAX engine's rule: the PM force is linear in the mass scale,
        # so trajectories are unchanged; device reductions run in safe
        # normalized units and the host boundary multiplies the unit back,
        # so histories and the detector's absolute momentum threshold see
        # reference units). The unit is the float32 mean of the masses on
        # the engine's device, as JAX's jnp.mean.
        mass_unit = float(torch.mean(masses))
        if mass_unit > 0:
            masses = masses / mass_unit
        else:  # degenerate ICs (massless test fixtures): no normalization
            mass_unit = 1.0
        self._set_mass_unit(mass_unit)
        self.state = CosmoState(pos, vel, masses,
                                float(np.float32(start_redshift)), 0)
        self._warm_constants()

        self.history = {
            "redshift": [self.redshift],
            "time_gyr": [self.time_gyr],
            "bao_scale": [],
            "clustering": [],
            "glitches": [],
            "energy": [],
            "exploits": [],
        }
        logger.info("CosmologicalEngine: %dD, %d particles, grid %d^%d, "
                    "box %.0f Mpc, z=%.1f, %s, %s", dim, self.num_particles,
                    n_grid, dim, box_size_mpc, start_redshift,
                    describe_mode(self.quantizer.mode), self.device)

    @staticmethod
    def _mesh_device(mesh, device) -> torch.device:
        """The engine's device: ``device`` (cuda unless named), or with a
        mesh the mesh's first device, which ``device`` must then name."""
        if mesh is None:
            return _resolve_device(device)
        home = mesh.devices[0]
        if device is not None:
            named = _normalise(_resolve_device(device))
            if named != home:
                raise ValueError(f"device {str(named)!r} is not the mesh's "
                                 f"first device {str(home)!r}")
        return _resolve_device(home)

    def _set_mass_unit(self, mass_unit: float) -> None:
        self.mass_unit_msun = float(mass_unit)
        self.cfg = dataclasses.replace(
            self.cfg, G=self._G_newton * self.mass_unit_msun)

    def _warm_constants(self) -> None:
        """Build the spectral constants of this geometry on the device at
        set-up, so that no step waits on their host-to-device copies."""
        cfg, dev = self.cfg, self.device
        pm.quantized_k_sq(cfg.n_grid, cfg.box_size, cfg.dim, self.quantizer,
                          dev)
        pm._pk_bins(64, cfg.box_size, cfg.dim, 20, dev)
        if cfg.dm_ratio > 0:
            pm.dm_background_field(cfg.box_size, cfg.n_grid, cfg.dm_ratio,
                                   cfg.dim, dev)
        if self.mesh is not None:
            from nbody_tpu_torch.parallel import pm_sharded

            pm_sharded.warm_constants(cfg, self.quantizer, self.mesh)

    def load_jax_state(self, state, mass_unit_msun: float) -> None:
        """Carry a JAX engine's state across: its ``CosmoState`` exported
        as numpy arrays and its ``mass_unit_msun`` (masses normalized by
        it, G scaled by it), so both engines continue from the same bits.
        A mesh engine's padded resident state comes across padded: its
        rows past ``num_particles`` stay phantoms."""
        self._set_mass_unit(mass_unit_msun)
        self.state = cosmo_from_jax_numpy(state, self.device)
        self.current_epoch = get_current_epoch(self.redshift)

    # -- properties ---------------------------------------------------------

    @property
    def state(self) -> CosmoState:
        return self._state

    @state.setter
    def state(self, s: CosmoState):
        self._state = s

    @property
    def redshift(self) -> float:
        return self._state.redshift

    @property
    def scale(self) -> float:
        return 1.0 / (1.0 + self.redshift)

    @property
    def time_gyr(self) -> float:
        return self.cosmo.cosmic_time_gyr(max(self.redshift, 0.0))

    @property
    def tick(self) -> int:
        return self._state.tick

    # A mesh engine keeps its state padded to the shard boundary between
    # chunks; these views expose exactly the real rows (the tensor itself
    # when nothing is padded).

    def _trim_rows(self, x: torch.Tensor) -> torch.Tensor:
        n = self.num_particles
        return x if x.shape[0] == n else x[:n]

    @property
    def positions(self) -> torch.Tensor:
        return self._trim_rows(self._state.positions)

    @property
    def velocities(self) -> torch.Tensor:
        return self._trim_rows(self._state.velocities)

    @property
    def masses(self) -> torch.Tensor:
        return self._trim_rows(self._state.masses)

    def _trimmed_state(self) -> CosmoState:
        """The state without its padding (the checkpoint and export
        form)."""
        st = self._state
        return CosmoState(*(self._trim_rows(x) for x in
                            (st.positions, st.velocities, st.masses)),
                          st.redshift, st.tick)

    @property
    def snapshot_stride(self) -> int:
        """Decimation stride applied to every snapshot shipped to host
        under ``snapshot_cap``."""
        if (self.snapshot_cap is not None
                and self.num_particles > self.snapshot_cap):
            return -(-self.num_particles // self.snapshot_cap)
        return 1

    # -- schedule -----------------------------------------------------------

    def _build_schedule(self, dz: float, num_steps: int):
        """Host-side (z, dt, H, a) table for the next num_steps steps.

        Returns ``(schedule_arrays, z_end)`` where ``z_end`` is the
        f32-exact end-of-chunk redshift the state will hold."""
        z = self.redshift
        zs, dts, Hs, As = [], [], [], []
        for _ in range(num_steps):
            z_new = max(self.cfg.min_redshift, z - dz)
            dt = abs(self.cosmo.cosmic_time_gyr(z_new)
                     - self.cosmo.cosmic_time_gyr(z))
            zs.append(z_new)
            dts.append(dt)
            Hs.append(self.cosmo.hubble_parameter(z))
            As.append(1.0 / (1.0 + z))
            z = z_new
        arrays = tuple(np.asarray(v, np.float32) for v in (zs, dts, Hs, As))
        return arrays, float(np.float32(zs[-1]))

    # -- stepping -----------------------------------------------------------

    def step(self, dz: float = 1.0, num_steps: int = 1):
        """Advance num_steps redshift steps, then run the host-side
        detectors over the streamed diagnostics."""
        pending = self.dispatch_step(dz, num_steps)
        if pending is not None:
            self.collect_step(pending)

    def dispatch_step(self, dz: float = 1.0,
                      num_steps: int = 1) -> Optional[PendingChunk]:
        """Device half of step(): enqueue the chunk and its probe bundle,
        start non-blocking copies of what the host half reads into pinned
        host buffers, and record an event. Returns a handle for
        collect_step(), or None once the run is complete. Nothing here
        waits for the device."""
        if self.completed or self.redshift <= self.cfg.min_redshift:
            self._mark_complete()
            return None

        schedule, z_end = self._build_schedule(dz, num_steps)
        tick_start = self.tick
        if self.mesh is not None:
            from nbody_tpu_torch.parallel import pm_sharded

            runner = (pm_sharded.run_pm_steps_sharded_fft
                      if self.cfg.n_grid >= 256
                      else pm_sharded.run_pm_steps_sharded)
            # Resident loop: gather=False keeps the state padded to the
            # shard boundary between chunks (the runner's padding is a
            # no-op once it is).
            self._state, stream = runner(
                self._state, schedule, self.quantizer, self.cfg, self.mesh,
                quantize_forces=self.quantizer.is_int,
                n_valid=self.num_particles, gather=False)
        else:
            self._state, stream = run_pm_steps(self._state, schedule,
                                               self.quantizer, self.cfg)

        eng = self.exploit_engine
        prev, obs_pos, obs_dir = eng.probe_inputs(self._state.positions)
        if self.mesh is not None:
            probes = probe_bundle_sharded(
                self._state.positions, self._state.velocities, prev,
                obs_pos, obs_dir, self.cfg.box_size, eng.c_sim, eng.fov_cos,
                n_valid=self.num_particles, mesh=self.mesh)
        else:
            probes = probe_bundle(self._state.positions,
                                  self._state.velocities, prev, obs_pos,
                                  obs_dir, self.cfg.box_size, eng.c_sim,
                                  eng.fov_cos)
        # Observer rotates once per chunk, after the probe that used it
        # (reference cadence: universe_2d.py:877).
        eng.rotate_observer(5.0)

        # The snapshot the host reads: the real rows, decimated under
        # snapshot_cap, trimmed and strided on the device before the copy.
        snap_pos, snap_vel = self._state.positions, self._state.velocities
        snap_stride = self.snapshot_stride
        n = self.num_particles
        if snap_stride > 1 or snap_pos.shape[0] != n:
            snap_pos = snap_pos[:n:snap_stride]
            snap_vel = snap_vel[:n:snap_stride]
        host = _tree_to_host((stream, probes, snap_pos, snap_vel))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        pending = PendingChunk(num_steps=num_steps, tick_start=tick_start,
                               z_end=z_end, stream=host[0], probes=host[1],
                               positions=host[2], velocities=host[3],
                               snap_stride=snap_stride, event=event)
        if z_end <= self.cfg.min_redshift:
            self._mark_complete()
        return pending

    def collect_step(self, pending: PendingChunk):
        """Host half of step(): wait for the chunk's copies, then run the
        glitch detectors, entropy probe, structure measurements, and
        exploit probes over it. Returns the chunk's post-state host copies
        ``(positions, velocities)`` as numpy arrays."""
        if pending.event is not None:
            pending.event.synchronize()
        stream = StepStream(*(t.numpy() for t in pending.stream))
        probes = pending.probes
        pos_h = pending.positions.numpy()
        vel_h = pending.velocities.numpy()
        num_steps = pending.num_steps
        tick_end = pending.tick_start + num_steps
        z_end = pending.z_end
        prev_energy = (self.history["energy"][-1]
                       if self.history["energy"] else 0.0)

        for i in range(num_steps):
            tick = pending.tick_start + 1 + i
            z = float(stream.redshift[i])
            # Restore M_sun-weighted units at the host boundary.
            ke = float(stream.kinetic[i]) * self.mass_unit_msun
            mom = tuple(float(x) * self.mass_unit_msun
                        for x in stream.momentum[i])
            self.history["energy"].append(ke)
            for ev in (
                self.glitch_detector.check_energy_conservation(ke, tick, z),
                self.glitch_detector.check_momentum(mom, tick, z),
            ):
                if ev:
                    self.history["glitches"].append(ev)
            # Unconditional per-step call (the reference checks every step,
            # universe_2d.py:1148) so subnormal_history stays dense.
            sub = glitch_lib.SubnormalMetrics(
                subnormal_count=int(stream.subnormals[i]),
                zero_count=0, min_nonzero=float("inf"))
            ev = self.glitch_detector.check_subnormals(sub, tick, z)
            if ev:
                self.history["glitches"].append(ev)
            self.history["redshift"].append(z)
            self.history["time_gyr"].append(
                self.cosmo.cosmic_time_gyr(max(z, 0.0)))

            new_epoch = get_current_epoch(z)
            if new_epoch != self.current_epoch:
                info = EPOCHS[new_epoch]
                logger.info("EPOCH TRANSITION: %s (z=%.2f): %s", info.name,
                            z, info.description)
                self.current_epoch = new_epoch
                self._on_epoch_transition(tick, z, new_epoch)

        # entropy check on the post-chunk state (reference: every 10 ticks);
        # above 20k particles the native single-pass probe replaces zlib
        entropy_fn = (glitch_lib.fast_state_entropy
                      if self.num_particles > 20000
                      else glitch_lib.measure_state_entropy)
        ent = entropy_fn(pos_h, vel_h)
        ev = self.glitch_detector.check_entropy(ent.compression_ratio,
                                                tick_end, z_end)
        if ev:
            self.history["glitches"].append(ev)

        # per-chunk structure measurements (reference logs BAO/clustering
        # every 10 ticks, universe_2d.py:1203-1207)
        self.history["bao_scale"].append(
            pm.bao_scale_from_pk(probes.k_centers, probes.pk))
        self.history["clustering"].append(float(probes.clustering))

        # exploit probes (reference: every 20 ticks)
        ke_now = self.history["energy"][-1]
        results = self.exploit_engine.finish_probes(
            probes.exploit, pos_h, vel_h,
            gpu_power=0.0, energy_delta=ke_now - prev_energy,
            n_total=self.num_particles)
        self.history["exploits"].append(
            {"tick": tick_end, "redshift": z_end, **results})
        return pos_h, vel_h

    def _on_epoch_transition(self, tick: int, z: float, epoch):
        """Hook for engine subclasses (genesis records a timeline)."""

    def _mark_complete(self):
        if not self.completed:
            self.completed = True
            self.running = False
            logger.info("SIMULATION COMPLETE at z=%.4f, t=%.3f Gyr",
                        self.redshift, self.time_gyr)

    def run_to_completion(self, dz: float = 1.0, chunk: int = 10,
                          callback=None, pipelined: bool = False):
        """Evolve to min_redshift in chunks (chunk=10 matches the
        reference's entropy-check cadence).

        pipelined=True overlaps chunk k's host-side detectors with chunk
        k+1's device work (histories are bit-identical to the sequential
        path and fully drained on return); the callback then fires with
        live properties one chunk ahead of the histories."""
        if not pipelined:
            while not self.completed:
                remaining = (self.redshift - self.cfg.min_redshift) / dz
                n = max(1, min(chunk, int(math.ceil(remaining))))
                self.step(dz, num_steps=n)
                if callback:
                    callback(self)
            return

        pending = None
        while not self.completed:
            remaining = (self.redshift - self.cfg.min_redshift) / dz
            n = max(1, min(chunk, int(math.ceil(remaining))))
            nxt = self.dispatch_step(dz, num_steps=n)
            if pending is not None:
                self.collect_step(pending)
                if callback:
                    callback(self)
            pending = nxt
        if pending is not None:
            self.collect_step(pending)
            if callback:
                callback(self)

    # -- diagnostics --------------------------------------------------------

    def get_kinetic_energy(self) -> float:
        v_sq = torch.sum(self.state.velocities ** 2, dim=-1)
        return float(0.5 * torch.sum(self.state.masses * v_sq)) \
            * self.mass_unit_msun

    def get_total_momentum(self):
        mom = torch.sum(self.state.masses[:, None] * self.state.velocities,
                        dim=0)
        return tuple(float(x) * self.mass_unit_msun
                     for x in mom.cpu().numpy())

    def compute_power_spectrum(self, n_grid: int = 64, num_bins: int = 20):
        k, pk_ = pm.power_spectrum(self.positions, self.cfg.box_size,
                                   n_grid, num_bins)
        return k.cpu().numpy(), pk_.cpu().numpy()

    def get_bao_scale(self) -> float:
        k, pk_ = self.compute_power_spectrum()
        return pm.bao_scale_from_pk(k, pk_)

    def get_clustering(self) -> float:
        return float(pm.clustering_metric(self.positions, self.cfg.box_size))

    # -- checkpointing --------------------------------------------------

    # Dataclass types inside history["exploits"] entries and the exploit
    # engine's own per-metric history (json round-trip needs explicit
    # reconstruction: json.dumps(default=str) would silently stringify).
    _EXPLOIT_TYPES = {"relativity": glitch_lib.RelativityMetrics,
                      "fluid": glitch_lib.FluidMetrics,
                      "landauer": glitch_lib.LandauerMetrics,
                      "frustum": glitch_lib.FrustumMetrics}

    @classmethod
    def _exploit_to_json(cls, entry: dict) -> dict:
        return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                    else v) for k, v in entry.items()}

    @classmethod
    def _exploit_from_json(cls, entry: dict) -> dict:
        return {k: (cls._EXPLOIT_TYPES[k](**v)
                    if k in cls._EXPLOIT_TYPES and isinstance(v, dict)
                    else v) for k, v in entry.items()}

    def _history_blob(self) -> dict:
        """JSON form of the run histories + glitch-detector + exploit-
        engine state, saved with every checkpoint so a resumed run
        reproduces the FULL drift curve, glitch log and exploit log
        (the reference's headline observable spans the whole run,
        simulation.py:170-196)."""
        d = self.glitch_detector
        x = self.exploit_engine
        return {
            "history": {
                **{k: v for k, v in self.history.items()
                   if k not in ("glitches", "exploits")},
                "glitches": [dataclasses.asdict(g)
                             for g in self.history["glitches"]],
                "exploits": [self._exploit_to_json(e)
                             for e in self.history["exploits"]],
            },
            "detector": {
                "energy_history": d.energy_history,
                "momentum_history": [list(m) for m in d.momentum_history],
                "subnormal_history": d.subnormal_history,
                "entropy_history": d.entropy_history,
                "events": [dataclasses.asdict(g) for g in d.events],
            },
            "exploit_engine": {
                "initial_bits": x.initial_bits,
                "exploit_events": list(x.exploit_events),
                "gamma_history": list(x.gamma_history),
                "power_vs_gamma": [list(t) for t in x.power_vs_gamma],
                "history": {k: [dataclasses.asdict(m) for m in v]
                            for k, v in x.history.items()},
                # probe frame state: the rotating observer and whether a
                # previous-positions buffer existed (the buffer itself
                # equals the checkpointed state at a chunk boundary)
                "observer_pos": [float(v) for v in x.observer_pos],
                "observer_dir": [float(v) for v in x.observer_dir],
                "has_prev": x.prev_positions is not None,
            },
        }

    def _restore_history_blob(self, blob: dict) -> None:
        h = blob.get("history")
        if h:
            # merge: keys the running engine initializes but an older
            # blob lacks must survive
            for k, v in h.items():
                self.history[k] = list(v)
            self.history["glitches"] = [
                glitch_lib.GlitchEvent(**g) for g in h.get("glitches", [])]
            self.history["exploits"] = [
                self._exploit_from_json(e) for e in h.get("exploits", [])]
        det = blob.get("detector")
        if det:
            d = self.glitch_detector
            d.energy_history = [float(x) for x in det["energy_history"]]
            d.momentum_history = [tuple(m)
                                  for m in det["momentum_history"]]
            d.subnormal_history = [int(x)
                                   for x in det["subnormal_history"]]
            d.entropy_history = [float(x) for x in det["entropy_history"]]
            d.events = [glitch_lib.GlitchEvent(**g)
                        for g in det.get("events", [])]
        eng = blob.get("exploit_engine")
        if eng:
            x = self.exploit_engine
            x.initial_bits = int(eng["initial_bits"])
            x.exploit_events = [str(s) for s in eng["exploit_events"]]
            x.gamma_history = [float(g) for g in eng["gamma_history"]]
            x.power_vs_gamma = [tuple(t) for t in eng["power_vs_gamma"]]
            x.history = {k: [self._EXPLOIT_TYPES[k](**m) for m in v]
                         for k, v in eng["history"].items()}
            if "observer_pos" in eng:
                x.observer_pos = np.asarray(eng["observer_pos"],
                                            np.float32)
                x.observer_dir = np.asarray(eng["observer_dir"],
                                            np.float32)
            if eng.get("has_prev"):
                # prev == post-chunk positions == the checkpointed state;
                # a mesh engine keeps it padded to the shard boundary (the
                # probe bundle masks phantom rows by n_valid)
                prev = self._trimmed_state().positions
                if self.mesh is not None:
                    prev = _pad_to_shards(prev, self.mesh.size)
                x.prev_positions = prev

    def save_checkpoint(self, manager) -> int:
        """Write the CosmoState at the current tick (utils.checkpoint). A
        mesh engine's padding is stripped, so a checkpoint does not depend
        on the mesh's shape. Run histories ride in the metadata so a
        resumed run owns the full pre-crash drift curve."""
        manager.save(self.tick, self._trimmed_state(), {
            "precision": self.precision_str,
            "redshift": self.redshift,
            "num_particles": self.num_particles,
            "mass_unit_msun": self.mass_unit_msun,
            "histories": self._history_blob(),
        })
        return self.tick

    def restore_latest(self, manager) -> Optional[int]:
        """Resume from the newest checkpoint, if any. Returns its tick."""
        step = manager.latest_step()
        if step is None:
            return None
        self.state = manager.restore(step, self._trimmed_state())
        self.completed = self.redshift <= self.cfg.min_redshift
        # re-sync derived run state with the restored redshift so the next
        # step does not log a bogus epoch transition
        self.current_epoch = get_current_epoch(self.redshift)
        meta = manager.load_metadata(step)
        if "mass_unit_msun" in meta:
            self._set_mass_unit(float(meta["mass_unit_msun"]))
        blob = meta.get("histories")
        if blob:
            self._restore_history_blob(blob)
        else:
            # checkpoint without histories: continue from the resume point
            self.history["redshift"].append(self.redshift)
            self.history["time_gyr"].append(self.time_gyr)
        logger.info("resumed from checkpoint at tick %d (z=%.3f)", step,
                    self.redshift)
        return step

    def get_state_dict(self) -> dict:
        """Exportable state (reference: universe_genesis.py:500-511)."""
        st = self._trimmed_state()
        return {
            "positions": st.positions.cpu().numpy(),
            "velocities": st.velocities.cpu().numpy(),
            "masses": st.masses.cpu().numpy(),
            "redshift": self.redshift,
            "time_gyr": self.time_gyr,
            "tick": self.tick,
            "precision": self.precision_str,
            "epoch": self.current_epoch.value,
            "num_particles": self.num_particles,
            "box_size_mpc": self.cfg.box_size,
            "mass_unit_msun": self.mass_unit_msun,
            "glitch_count": self.glitch_detector.get_glitch_count(),
        }
