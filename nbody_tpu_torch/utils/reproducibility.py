"""Determinism, manifests, state hashing, multi-seed statistics.

PyTorch counterpart of ``nbody_tpu.utils.reproducibility`` (reference:
reproducibility.py:60-507). What differs from the JAX module:

* ``set_all_seeds`` seeds numpy and torch's default generator, the one
  implicit RNG torch adds; ``seed_key`` returns a CPU ``torch.Generator``
  (JAX: a PRNG key). The port draws every initial condition on a CPU
  generator, so a seed gives the same ICs on the card and on the CPU (a
  CUDA generator would give another stream);
* the hardware manifest names the torch device (``cuda`` or ``cpu``, the
  card's name, ``torch.cuda.device_count()``); the software manifest
  records ``torch_version``, ``cuda_version`` and ``backend`` where JAX
  records ``jax_version`` and ``jaxlib_backend``;
* ``DeviceState`` keeps JAX's NVML-shaped schema: memory from the CUDA
  allocator, power / clock / throttle None, as JAX reports them (no NVML
  telemetry is sampled);
* ``hash_state`` is JAX's: SHA-256 over the float32 bytes of positions
  then velocities, 16 hex chars (reference: reproducibility.py:227-232),
  so the same bits give the same hex in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
from datetime import datetime
from typing import Callable, List, Optional

import numpy as np
import torch


# --------------------------------------------------------------------------
# Seeds / generators
# --------------------------------------------------------------------------

def set_all_seeds(seed: int):
    """Seed every *implicit* RNG in play: numpy's for host fixtures and
    torch's default generator (reference analogue:
    reproducibility.py:235-244). The port's ICs take explicit generators
    (``seed_key``)."""
    np.random.seed(seed)
    torch.manual_seed(seed)


def seed_key(seed: int) -> torch.Generator:
    """Root generator of an experiment: a CPU ``torch.Generator``, so the
    draws are the same whatever device the run is on."""
    return torch.Generator().manual_seed(seed)


# --------------------------------------------------------------------------
# Manifests
# --------------------------------------------------------------------------

@dataclasses.dataclass
class HardwareManifest:
    platform: str
    device_kind: str
    num_devices: int
    cpu_model: str
    cpu_cores: int
    ram_gb: float
    hostname: str


@dataclasses.dataclass
class SoftwareManifest:
    python_version: str
    torch_version: str
    cuda_version: Optional[str]
    backend: str
    numpy_version: str
    os_version: str


@dataclasses.dataclass
class ExperimentConfig:
    experiment_name: str
    precision_mode: str
    num_stars: int
    num_ticks: int
    random_seed: int
    dt: float
    softening: float
    G: float
    quantization_levels: Optional[int] = None


@dataclasses.dataclass
class DeviceState:
    """Telemetry snapshot, schema-compatible with the reference's NVML
    GPUState (reference: reproducibility.py:67-77). Fields this package
    does not sample are None, never fabricated."""

    device_kind: str
    memory_used_mb: Optional[float]
    memory_total_mb: Optional[float]
    clock_speed_mhz: Optional[int] = None
    power_draw_watts: Optional[float] = None
    temperature_c: Optional[float] = None
    utilization_percent: Optional[float] = None
    performance_state: Optional[str] = None
    throttle_reasons: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ReproducibilityManifest:
    timestamp: str
    experiment_id: str
    hardware: HardwareManifest
    software: SoftwareManifest
    config: ExperimentConfig
    device_state_before: Optional[DeviceState]
    device_state_after: Optional[DeviceState]
    initial_state_hash: str
    results_hash: str


def _backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def get_hardware_manifest() -> HardwareManifest:
    """The torch device fleet and the host. Without a card the platform is
    ``cpu``: one device, the host."""
    try:
        import psutil
        ram_gb = psutil.virtual_memory().total / 1024 ** 3
    except Exception:
        ram_gb = 0.0
    on_card = torch.cuda.is_available()
    return HardwareManifest(
        platform=_backend(),
        device_kind=torch.cuda.get_device_name(0) if on_card else "cpu",
        num_devices=torch.cuda.device_count() if on_card else 1,
        cpu_model=platform.processor() or platform.machine(),
        cpu_cores=os.cpu_count() or 0,
        ram_gb=round(ram_gb, 2),
        hostname=platform.node(),
    )


def get_software_manifest() -> SoftwareManifest:
    return SoftwareManifest(
        python_version=platform.python_version(),
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        backend=_backend(),
        numpy_version=np.__version__,
        os_version=platform.platform(),
    )


def get_device_state(device=None) -> DeviceState:
    """Counterpart of NVML polling (reference: reproducibility.py:162-224):
    memory from the CUDA caching allocator (``memory_allocated``) and the
    card's total memory; on the CPU both None. Power, clock and throttle
    are not sampled and stay None, as in the JAX package. ``device``
    defaults to the current card, or the CPU without one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return DeviceState(device_kind="cpu", memory_used_mb=None,
                           memory_total_mb=None)
    props = torch.cuda.get_device_properties(device)
    return DeviceState(
        device_kind=props.name,
        memory_used_mb=torch.cuda.memory_allocated(device) / 1024 ** 2,
        memory_total_mb=props.total_memory / 1024 ** 2)


def _f32_bytes(x) -> bytes:
    """The float32 bytes of a tensor (copied to the host first: numpy
    cannot read a card's memory) or of an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(x, np.float32).tobytes()


def hash_state(positions, velocities) -> str:
    """SHA-256 of the state's float32 bytes, positions then velocities, 16
    hex chars (reference: reproducibility.py:227-232); the JAX package's
    hex for the same bits."""
    return hashlib.sha256(_f32_bytes(positions)
                          + _f32_bytes(velocities)).hexdigest()[:16]


# Back-compat alias matching the reference name.
hash_tensor_state = hash_state


def create_manifest(config: ExperimentConfig, initial_positions,
                    initial_velocities, final_positions=None,
                    final_velocities=None,
                    device_state_before: DeviceState = None,
                    device_state_after: DeviceState = None
                    ) -> ReproducibilityManifest:
    """(reference: reproducibility.py:247-278)"""
    initial_hash = hash_state(initial_positions, initial_velocities)
    results_hash = (hash_state(final_positions, final_velocities)
                    if final_positions is not None else "N/A")
    exp_id = (f"{config.precision_mode}_{config.num_stars}_"
              f"{config.random_seed}_{datetime.now().strftime('%H%M%S')}")
    return ReproducibilityManifest(
        timestamp=datetime.now().isoformat(),
        experiment_id=exp_id,
        hardware=get_hardware_manifest(),
        software=get_software_manifest(),
        config=config,
        device_state_before=device_state_before,
        device_state_after=device_state_after,
        initial_state_hash=initial_hash,
        results_hash=results_hash,
    )


def save_manifest(manifest: ReproducibilityManifest, filepath: str):
    with open(filepath, "w") as f:
        json.dump(dataclasses.asdict(manifest), f, indent=2, default=str)


def print_manifest(m: ReproducibilityManifest):
    print("\n" + "=" * 70)
    print("  REPRODUCIBILITY MANIFEST")
    print("=" * 70)
    print(f"  Experiment: {m.experiment_id}")
    print(f"  Timestamp:  {m.timestamp}")
    print(f"  Platform:   {m.hardware.platform} "
          f"({m.hardware.device_kind} x{m.hardware.num_devices})")
    print(f"  Host:       {m.hardware.cpu_model} "
          f"({m.hardware.cpu_cores} cores, {m.hardware.ram_gb} GB)")
    print(f"  Software:   python {m.software.python_version}, "
          f"torch {m.software.torch_version}, "
          f"CUDA {m.software.cuda_version}")
    print(f"  Config:     {m.config.precision_mode}, "
          f"N={m.config.num_stars}, ticks={m.config.num_ticks}, "
          f"seed={m.config.random_seed}")
    print(f"  Initial state hash: {m.initial_state_hash}")
    print(f"  Final state hash:   {m.results_hash}")
    print("=" * 70)


# --------------------------------------------------------------------------
# Multi-seed statistics
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StatisticalResult:
    metric_name: str
    mean: float
    std: float
    ci_95_low: float
    ci_95_high: float
    n_samples: int
    values: List[float]


def run_with_confidence(experiment_fn: Callable[[int], float],
                        n_seeds: int = 10, base_seed: int = 42,
                        metric_name: str = "metric") -> StatisticalResult:
    """Multi-seed runner with t-distribution 95% CI
    (reference: reproducibility.py:362-398)."""
    values = []
    for i in range(n_seeds):
        seed = base_seed + i
        set_all_seeds(seed)
        values.append(float(experiment_fn(seed)))

    arr = np.asarray(values)
    mean = float(arr.mean())
    std = float(arr.std(ddof=1)) if n_seeds > 1 else 0.0
    try:
        from scipy import stats
        t_crit = float(stats.t.ppf(0.975, df=max(n_seeds - 1, 1)))
    except Exception:  # scipy-free fallback: normal approximation
        t_crit = 1.96
    margin = t_crit * std / np.sqrt(max(n_seeds, 1))
    return StatisticalResult(metric_name=metric_name, mean=mean, std=std,
                             ci_95_low=mean - margin,
                             ci_95_high=mean + margin,
                             n_samples=n_seeds, values=values)


METHODOLOGY_NOTES = """
METHODOLOGY NOTES (PyTorch / CUDA build)

1. Determinism: every hand-written kernel of the package sums in a fixed
   order (no float atomics), so a run repeated on the same card from the
   same inputs gives the same bits; chip_smoke.py checks it kernel by
   kernel and on whole runs (state hashes). Initial conditions are drawn
   on CPU torch.Generators, so a seed gives the same ICs on every device.
   The card and the CPU sum some reductions in other orders, so their
   trajectories agree to rounding, not bit for bit.

2. Telemetry: no NVML counter is sampled. Power, clock, temperature and
   throttle fields are None; the step-time jitter is the observable that
   stands in for clock stability. Device memory comes from the CUDA
   caching allocator. Measure instrumentation overhead with
   utils.profiler.measure_instrumentation_overhead.

3. Cross-substrate comparison: export and compare state hashes through
   hash_state and the manifests; the hash is the JAX package's for the
   same float32 bits.
"""
