"""Glitch detection and physics-exploit probes.

PyTorch counterpart of ``nbody_tpu.diagnostics.glitch``
(reference: universe_2d.py:335-877, reality_glitch_tests.py:63-298).
Split into:

* **device metric bundles** — subnormal census, Lorentz/fluid/frustum
  statistics — tensor functions on the state's own device, so the hot loop
  streams a few scalars instead of pulling full state to host. Every
  reduction is a ``torch.sum`` / ``amax`` / ``amin`` (deterministic on
  CUDA: a fixed reduction tree, no atomics);
* **host-side detectors** (`GlitchDetector`, `PhysicsExploitEngine`) that
  consume those streams, apply thresholds, and log events — the JAX
  package's verdict logic, copied;
* **zlib entropy probes** that necessarily run on host (Kolmogorov-proxy
  compression), fed by periodic streamed snapshots; the fast variants go
  through the port's own ``native`` loader.

Subnormals: the TPU flushes them, and so does XLA on the CPU (its
denormals are zero); torch's kernels on the H100 and on the CPU keep them,
as the torch reference does, so ``count_subnormals`` counts the IEEE
float32 subnormals on every device. Nothing here flushes.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("nbody_tpu_torch.glitch")

FP32_MIN_NORMAL = 1.175494e-38  # smallest normal float32
C_SIM_MPC_GYR = 306.6           # speed of light in Mpc/Gyr
KT_EV = 0.0257                  # Boltzmann * 300K, in eV
LANDAUER_LIMIT_EV = KT_EV * 0.693


# --------------------------------------------------------------------------
# Device metric bundles
# --------------------------------------------------------------------------

class SubnormalMetrics(NamedTuple):
    subnormal_count: torch.Tensor   # int32
    zero_count: torch.Tensor        # int32
    min_nonzero: torch.Tensor       # f32


def count_subnormals(x: torch.Tensor) -> SubnormalMetrics:
    """Census of denormal float32 values (reference:
    reality_glitch_tests.py:63-82): 0 < |x| < 1.175e-38."""
    ax = torch.abs(x.reshape(-1))
    nonzero = ax > 0
    sub = torch.logical_and(nonzero, ax < FP32_MIN_NORMAL)
    min_nonzero = torch.amin(torch.where(nonzero, ax,
                                         torch.full_like(ax, math.inf)))
    return SubnormalMetrics(
        subnormal_count=torch.sum(sub).to(torch.int32),
        zero_count=torch.sum(~nonzero).to(torch.int32),
        min_nonzero=min_nonzero,
    )


class ExploitDeviceMetrics(NamedTuple):
    """Scalar bundle for all four exploit probes, computed on the device."""

    max_gamma: torch.Tensor        # Lorentz factor max
    near_c_09: torch.Tensor        # particles above 0.9c
    near_c_099: torch.Tensor
    v_mean: torch.Tensor
    v_std: torch.Tensor
    in_frustum: torch.Tensor       # count in observer's FOV
    snap_events: torch.Tensor      # frustum-entry jumps > threshold


def exploit_row_metrics(positions, velocities, prev_positions,
                        observer_pos, observer_dir,
                        c_sim: float = C_SIM_MPC_GYR,
                        fov_cos: float = 0.866,
                        snap_threshold: float = 0.1):
    """Per-row tensors behind the exploit probes: (gamma, beta, v_mag,
    in_frustum, snapped), JAX's formulas op for op."""
    v_sq = torch.sum(velocities * velocities, dim=-1)
    # a 0-d tensor divisor: a true division on every device (PyTorch's
    # CUDA division by a Python scalar multiplies by its reciprocal)
    c_sq = torch.full((), c_sim * c_sim, dtype=v_sq.dtype,
                      device=v_sq.device)
    beta_sq = torch.clamp(v_sq / c_sq, 0.0, 0.9999)
    gamma = 1.0 / torch.sqrt(1.0 - beta_sq)
    beta = torch.sqrt(beta_sq)
    v_mag = torch.sqrt(v_sq)

    to_p = positions - observer_pos[None, :]
    # jnp.linalg.norm of real rows: the square root of the summed squares
    dist = torch.sqrt(torch.sum(to_p * to_p, dim=1, keepdim=True))
    dot = torch.sum(to_p / (dist + 1e-10) * observer_dir[None, :], dim=1)
    in_frustum = dot > fov_cos

    pos_delta = torch.sum(torch.abs(positions - prev_positions), dim=1)
    snapped = torch.logical_and(in_frustum, pos_delta > snap_threshold)
    return gamma, beta, v_mag, in_frustum, snapped


def exploit_device_metrics(positions, velocities, prev_positions,
                           observer_pos, observer_dir,
                           c_sim: float = C_SIM_MPC_GYR,
                           fov_cos: float = 0.866,
                           snap_threshold: float = 0.1
                           ) -> ExploitDeviceMetrics:
    """Device half of the exploit probes
    (reference: universe_2d.py:517-786, fused)."""
    gamma, beta, v_mag, in_frustum, snapped = exploit_row_metrics(
        positions, velocities, prev_positions, observer_pos, observer_dir,
        c_sim, fov_cos, snap_threshold)
    return ExploitDeviceMetrics(
        max_gamma=torch.amax(gamma),
        near_c_09=torch.sum(beta > 0.9).to(torch.int32),
        near_c_099=torch.sum(beta > 0.99).to(torch.int32),
        v_mean=torch.mean(v_mag),
        v_std=torch.std(velocities, correction=0),
        in_frustum=torch.sum(in_frustum).to(torch.int32),
        snap_events=torch.sum(snapped).to(torch.int32),
    )


# --------------------------------------------------------------------------
# Host-side entropy / information probes (zlib = host by nature)
# --------------------------------------------------------------------------

class EntropyMetrics(NamedTuple):
    raw_bytes: int
    compressed_bytes: int
    compression_ratio: float
    bits_per_float: float


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def measure_state_entropy(positions, velocities,
                          level: int = 6) -> EntropyMetrics:
    """zlib compressibility of the state — the 'entropy horizon' probe
    (reference: reality_glitch_tests.py:273-298)."""
    pos = _host_f32(positions)
    vel = _host_f32(velocities)
    raw = pos.tobytes() + vel.tobytes()
    comp = zlib.compress(raw, level)
    n_floats = pos.size + vel.size
    return EntropyMetrics(
        raw_bytes=len(raw),
        compressed_bytes=len(comp),
        compression_ratio=len(raw) / max(len(comp), 1),
        bits_per_float=len(comp) * 8.0 / max(n_floats, 1),
    )


def fast_state_entropy(positions, velocities) -> EntropyMetrics:
    """Native single-pass entropy probe (C extension, ~90x faster than the
    zlib proxy): Shannon bits/byte of the raw state bytes. The zlib variant
    remains the reference-parity metric."""
    from nbody_tpu_torch import native

    pos = _host_f32(positions)
    vel = _host_f32(velocities)
    raw = pos.tobytes() + vel.tobytes()
    bits_per_byte, _ = native.byte_entropy(raw)
    n_floats = pos.size + vel.size
    est_compressed = int(len(raw) * bits_per_byte / 8.0)
    return EntropyMetrics(
        raw_bytes=len(raw),
        compressed_bytes=est_compressed,
        compression_ratio=8.0 / max(bits_per_byte, 1e-9),
        bits_per_float=bits_per_byte * 4.0,
    )


def information_bits(positions, velocities, level: int = 9,
                     fast_threshold_floats: int = 50_000) -> int:
    """Compressed size in bits — Landauer probe's Kolmogorov proxy
    (reference: universe_2d.py:689-702).

    Above ``fast_threshold_floats`` state elements the native single-pass
    entropy estimate replaces zlib level 9; the Landauer verdict only
    consumes *differences* in bits, which both proxies track."""
    pos = _host_f32(positions)
    vel = _host_f32(velocities)
    raw = pos.tobytes() + vel.tobytes()
    if pos.size + vel.size > fast_threshold_floats:
        from nbody_tpu_torch import native

        bits_per_byte, _ = native.byte_entropy(raw)
        return int(len(raw) * bits_per_byte)
    return len(zlib.compress(raw, level)) * 8


# --------------------------------------------------------------------------
# Glitch detector (host state machine over streamed series)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GlitchEvent:
    tick: int
    redshift: float
    glitch_type: str
    magnitude: float
    description: str


class GlitchDetector:
    """Threshold state machine over streamed diagnostics
    (reference: universe_2d.py:335-466). Checks: sudden energy jumps,
    momentum drift, subnormal flood, entropy spikes."""

    def __init__(self, threshold: float = 0.1):
        self.threshold = threshold
        self.events: List[GlitchEvent] = []
        self.energy_history: List[float] = []
        self.momentum_history: List[Tuple[float, ...]] = []
        self.subnormal_history: List[int] = []
        self.entropy_history: List[float] = []

    def _emit(self, tick, redshift, gtype, magnitude, desc) -> GlitchEvent:
        event = GlitchEvent(tick, redshift, gtype, magnitude, desc)
        self.events.append(event)
        logger.warning("GLITCH DETECTED: %s at z=%.2f, tick=%d",
                       desc, redshift, tick)
        return event

    def check_energy_conservation(self, energy: float, tick: int,
                                  redshift: float) -> Optional[GlitchEvent]:
        self.energy_history.append(energy)
        if len(self.energy_history) < 3:
            return None
        prev, cur = self.energy_history[-2], self.energy_history[-1]
        if prev != 0:
            delta = abs(cur - prev) / abs(prev + 1e-10)
            if delta > self.threshold:
                return self._emit(tick, redshift, "energy_jump", delta,
                                  f"Sudden energy change: {delta*100:.1f}%")
        return None

    def check_momentum(self, momentum, tick: int,
                       redshift: float) -> Optional[GlitchEvent]:
        self.momentum_history.append(tuple(momentum))
        if len(self.momentum_history) < 2:
            return None
        total = math.sqrt(sum(p * p for p in momentum))
        if total > self.threshold * 1000:
            comps = ", ".join(f"{p:.2f}" for p in momentum)
            return self._emit(tick, redshift, "momentum_drift", total,
                              f"Net momentum: ({comps})")
        return None

    def check_subnormals(self, metrics: SubnormalMetrics, tick: int,
                         redshift: float) -> Optional[GlitchEvent]:
        count = int(metrics.subnormal_count)
        self.subnormal_history.append(count)
        if count > 0:
            return self._emit(
                tick, redshift, "subnormal_flood", float(count),
                f"Denormal values detected: {count}, "
                f"min={float(metrics.min_nonzero):.2e}")
        return None

    def check_entropy(self, compression_ratio: float, tick: int,
                      redshift: float) -> Optional[GlitchEvent]:
        self.entropy_history.append(compression_ratio)
        if len(self.entropy_history) < 3:
            return None
        prev, cur = self.entropy_history[-2], self.entropy_history[-1]
        if prev > 0:
            delta = abs(cur - prev) / prev
            if delta > 0.10:
                return self._emit(
                    tick, redshift, "entropy_spike", delta,
                    f"Compression ratio changed: {prev:.2f} -> {cur:.2f} "
                    f"({delta*100:.1f}%)")
        return None

    def get_glitch_count(self) -> int:
        return len(self.events)

    def get_glitch_summary(self) -> dict:
        summary: dict = {}
        for e in self.events:
            summary[e.glitch_type] = summary.get(e.glitch_type, 0) + 1
        return summary


# --------------------------------------------------------------------------
# Physics exploit engine (host orchestrator over the device bundle)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RelativityMetrics:
    max_gamma: float = 1.0
    near_c_particles: int = 0
    power_at_09c: float = 0.0
    power_at_099c: float = 0.0
    bandwidth_limited: bool = False


@dataclasses.dataclass
class FluidMetrics:
    reynolds_number: float = 0.0
    viscosity_observed: float = 0.0
    viscosity_expected: float = 0.0
    viscosity_ratio: float = 1.0
    turbulence_suppressed: bool = False


@dataclasses.dataclass
class LandauerMetrics:
    total_bits_initial: int = 0
    total_bits_current: int = 0
    bits_erased: int = 0
    energy_per_bit_erased: float = 0.0
    garbage_collection_detected: bool = False


@dataclasses.dataclass
class FrustumMetrics:
    in_frustum_count: int = 0
    out_frustum_count: int = 0
    in_frustum_precision: str = "FP32"
    out_frustum_precision: str = "INT8"
    snap_events: int = 0
    culling_detected: bool = False


def to_device_async(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: through
    pinned memory and a non-blocking copy for a CUDA device (a pageable
    copy would wait for the stream's queued work)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class PhysicsExploitEngine:
    """Runs the four 'seams of reality' probes
    (reference: universe_2d.py:818-877). Device work is one bundle of
    tensor ops per call; zlib and thresholds run on host."""

    def __init__(self, fov_angle: float = 60.0, c_sim: float = C_SIM_MPC_GYR):
        self.c_sim = c_sim
        self.fov_cos = math.cos(math.radians(fov_angle / 2))
        self.observer_pos = np.zeros(2, np.float32)
        self.observer_dir = np.array([1.0, 0.0], np.float32)
        self.prev_positions = None
        self.initial_bits = 0
        self.exploit_events: List[str] = []
        self.history: dict = {"relativity": [], "fluid": [], "landauer": [],
                              "frustum": []}
        self.gamma_history: List[float] = []
        self.power_vs_gamma: List[Tuple[float, float]] = []

    def rotate_observer(self, angle_degrees: float):
        a = math.radians(angle_degrees)
        c, s = math.cos(a), math.sin(a)
        x, y = self.observer_dir[:2]
        self.observer_dir = self.observer_dir.copy()
        self.observer_dir[0] = x * c - y * s
        self.observer_dir[1] = x * s + y * c

    def probe_inputs(self, positions: torch.Tensor):
        """Bookkeeping half of a probe dispatch: returns
        (prev_positions, observer_pos, observer_dir) on the positions'
        device for ``exploit_device_metrics`` and records ``positions`` as
        the new previous state. No host sync: the observer vectors go over
        by a non-blocking copy."""
        dim = int(positions.shape[1])
        if self.observer_pos.shape[0] != dim:
            self.observer_pos = np.zeros(dim, np.float32)
            d = np.zeros(dim, np.float32)
            d[0] = 1.0
            self.observer_dir = d
        prev = (self.prev_positions if self.prev_positions is not None
                else positions)
        self.prev_positions = positions
        return (prev, to_device_async(self.observer_pos, positions.device),
                to_device_async(self.observer_dir, positions.device))

    def run_all_probes(self, positions, velocities, gpu_power: float = 0.0,
                       energy_delta: float = 0.0) -> dict:
        prev, obs_pos, obs_dir = self.probe_inputs(positions)
        dm = exploit_device_metrics(positions, velocities, prev,
                                    obs_pos, obs_dir,
                                    self.c_sim, self.fov_cos)
        dm = ExploitDeviceMetrics(*(t.cpu().numpy() for t in dm))
        return self.finish_probes(dm, positions, velocities, gpu_power,
                                  energy_delta)

    def finish_probes(self, dm, positions, velocities,
                      gpu_power: float = 0.0,
                      energy_delta: float = 0.0,
                      n_total: int = 0) -> dict:
        """Host half: threshold the fetched ExploitDeviceMetrics and run the
        compression-proxy Landauer probe. ``positions``/``velocities`` may be
        host copies (the pipelined engine passes prefetched numpy arrays so
        this never blocks on the device).

        ``n_total`` is the particle count the DEVICE metrics in ``dm`` were
        reduced over. It must be passed whenever ``positions`` is a
        decimated/strided snapshot (engines with ``snapshot_cap``): the
        frustum census and culling threshold are population-level counts.
        Defaults to ``len(positions)`` for the undecimated callers."""
        n = int(n_total) if n_total else int(positions.shape[0])

        max_gamma = float(dm.max_gamma)
        rel = RelativityMetrics(
            max_gamma=max_gamma,
            near_c_particles=int(dm.near_c_09),
            power_at_09c=gpu_power if int(dm.near_c_09) > 0 else 0.0,
            power_at_099c=gpu_power if int(dm.near_c_099) > 0 else 0.0,
            bandwidth_limited=(max_gamma > 10 and gpu_power > 100),
        )
        self.gamma_history.append(max_gamma)
        if gpu_power > 0:
            self.power_vs_gamma.append((max_gamma, gpu_power))

        # Fluid: viscosity from velocity-gradient proxy
        # (reference: universe_2d.py:625-661)
        v_mean = float(dm.v_mean)
        v_std = float(dm.v_std)
        vel_gradient = v_std / max(v_mean, 1e-10)
        visc_obs = 1.0 / max(vel_gradient, 1e-10) * 0.01
        visc_exp = 0.01
        re = 1.0 * v_mean * 10.0 / max(visc_obs, 1e-10)
        ratio = visc_obs / visc_exp
        fluid = FluidMetrics(
            reynolds_number=re,
            viscosity_observed=visc_obs,
            viscosity_expected=visc_exp,
            viscosity_ratio=ratio,
            turbulence_suppressed=(ratio > 2.0 and re < 2300),
        )

        # Landauer: compression-proxy information content
        current_bits = information_bits(positions, velocities)
        if self.initial_bits == 0:
            self.initial_bits = current_bits
        bits_erased = max(0, self.initial_bits - current_bits)
        min_energy = bits_erased * LANDAUER_LIMIT_EV
        landauer = LandauerMetrics(
            total_bits_initial=self.initial_bits,
            total_bits_current=current_bits,
            bits_erased=bits_erased,
            energy_per_bit_erased=abs(energy_delta) / max(bits_erased, 1),
            garbage_collection_detected=(bits_erased > 1000 and
                                         abs(energy_delta) < min_energy * 0.1),
        )

        snap = int(dm.snap_events)
        frustum = FrustumMetrics(
            in_frustum_count=int(dm.in_frustum),
            out_frustum_count=n - int(dm.in_frustum),
            snap_events=snap,
            culling_detected=snap > n * 0.01,
        )
        frustum.out_frustum_precision = ("INT8" if frustum.culling_detected
                                         else "FP32")

        results = {"relativity": rel, "fluid": fluid, "landauer": landauer,
                   "frustum": frustum}
        for k, v in results.items():
            self.history[k].append(v)
        if rel.bandwidth_limited:
            self.exploit_events.append("BANDWIDTH_LIMIT")
        if fluid.turbulence_suppressed:
            self.exploit_events.append("VISCOSITY_CLIPPING")
        if landauer.garbage_collection_detected:
            self.exploit_events.append("GARBAGE_COLLECTION")
        if frustum.culling_detected:
            self.exploit_events.append("FRUSTUM_CULLING")
        return results

    def get_exploit_summary(self) -> dict:
        summary: dict = {}
        for e in self.exploit_events:
            summary[e] = summary.get(e, 0) + 1
        return summary
