"""Device profiling: timing fence, sampling thread, step timing, traces,
program spans.

PyTorch counterpart of ``nbody_tpu.utils.profiler`` (reference:
gpu_profiler.py:34-468). The reference samples clocks, power,
temperature, utilization, P-state and throttle bitmasks from NVML; the
JAX package samples none of those, and neither does this module:

* it samples device memory (the CUDA caching allocator), host CPU
  utilization and RSS (psutil, when installed), and wall-clock step
  timings ended by ``fence`` (``torch.cuda.synchronize``);
* it reports the channels it does not sample as None and names them in
  every analysis (``unavailable_channels``);
* ``TraceCapture`` wraps ``torch.profiler`` and writes a Chrome trace;
* ``span`` marks a stretch of the program (``nbody.tick``, ...) on the
  profiler's timeline while a profiler records, and costs one C call
  otherwise.

Channels on the card, read by ``chip_smoke.py`` phase ultimate on an
"NVIDIA H100 80GB HBM3" (700 W):

=====================  ============================================
channel                status on the H100
=====================  ============================================
step wall time          MEASURED (fenced by torch.cuda.synchronize)
device memory           MEASURED (torch.cuda.memory_allocated; the
                        card's total from its properties)
host CPU / RSS          MEASURED (psutil; None where not installed)
torch.profiler trace    MEASURED (kernel events traced; a window can
                        come back without them, so nothing rests on
                        them)
power_watts             not sampled (None)
temperature_c           not sampled (None)
clock_mhz / throttle    not sampled (None; step-time jitter CV is the
                        clock-stability analogue)
=====================  ============================================
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from nbody_tpu_torch.utils.reproducibility import DeviceState, get_device_state

# The channels no sample holds (JAX's list).
UNSAMPLED = ["power_watts", "clock_mhz", "temperature_c", "throttle_reasons"]


# The one context every span returns while no profiler records.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` on the profiler's timeline: a
    ``record_function`` range (a host event, mirrored on the device's
    timeline over the work launched inside it) while a profiler records
    (``torch.profiler.profile``, ``TraceCapture``), else one shared null
    context, so the off path is one C call and no allocation. A span never
    synchronises, launches nothing and reads no device value."""
    return record_function(name) if _profiler_enabled() else _NO_SPAN


def fence(x):
    """Wait until the work behind ``x`` has finished; returns x.

    PyTorch returns before the GPU finishes, so a wall-clock timing must
    end here: ``torch.cuda.synchronize`` on the device of the first CUDA
    tensor found in ``x`` (a tensor or a nested tuple/list/dict of them).
    Host values need no fence."""
    stack = [x]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
                return x
        elif isinstance(leaf, dict):
            stack.extend(leaf.values())
        elif isinstance(leaf, (tuple, list)):
            stack.extend(leaf)
    return x


@dataclasses.dataclass
class DeviceSample:
    """One telemetry sample (reference schema: gpu_profiler.py:34-49,
    NVML-only fields None)."""

    timestamp: float
    memory_used_mb: Optional[float]
    memory_total_mb: Optional[float]
    host_cpu_percent: Optional[float]
    host_rss_mb: Optional[float]
    power_watts: Optional[float] = None
    clock_mhz: Optional[int] = None
    temperature_c: Optional[float] = None
    utilization_percent: Optional[float] = None
    throttle_reasons: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ProfileAnalysis:
    duration_s: float
    num_samples: int
    mean_memory_mb: Optional[float]
    peak_memory_mb: Optional[float]
    mean_host_cpu: Optional[float]
    step_count: int
    mean_step_ms: Optional[float]
    p50_step_ms: Optional[float]
    p99_step_ms: Optional[float]
    std_step_ms: Optional[float]
    step_time_cv: Optional[float]   # jitter: std/mean (clock-stability analogue)
    unavailable_channels: List[str] = dataclasses.field(default_factory=list)


class DeviceProfiler:
    """Background sampling + step-timing profiler
    (reference: gpu_profiler.py:80-331). ``device`` is the device sampled:
    the current card, or the CPU without one."""

    def __init__(self, sample_interval_ms: float = 100.0,
                 experiment_name: str = "experiment", device=None):
        self.sample_interval_s = sample_interval_ms / 1000.0
        self.experiment_name = experiment_name
        self.device = device
        self.samples: List[DeviceSample] = []
        self.step_times_ms: List[float] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._t_start = 0.0
        self._t_stop = 0.0
        try:
            import psutil
            self._proc = psutil.Process()
        except Exception:
            self._proc = None

    # -- sampling thread ----------------------------------------------------

    def _sample_once(self) -> DeviceSample:
        state: DeviceState = get_device_state(self.device)
        cpu = rss = None
        if self._proc is not None:
            try:
                cpu = self._proc.cpu_percent(interval=None)
                rss = self._proc.memory_info().rss / 1024 ** 2
            except Exception:
                pass
        return DeviceSample(
            timestamp=time.time(),
            memory_used_mb=state.memory_used_mb,
            memory_total_mb=state.memory_total_mb,
            host_cpu_percent=cpu,
            host_rss_mb=rss,
        )

    def _run(self):
        while not self._stop.is_set():
            try:
                self.samples.append(self._sample_once())
            except Exception:
                pass
            self._stop.wait(self.sample_interval_s)

    def start(self):
        self._t_start = time.time()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-profiler")
        self._thread.start()

    def stop(self):
        self._t_stop = time.time()
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- step timing --------------------------------------------------------

    def time_step(self, fn: Callable, *args, **kwargs):
        """Run fn, fence its result and record the wall time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        fence(out)
        self.step_times_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    # -- analysis -----------------------------------------------------------

    def analyze(self) -> ProfileAnalysis:
        mems = [s.memory_used_mb for s in self.samples
                if s.memory_used_mb is not None]
        cpus = [s.host_cpu_percent for s in self.samples
                if s.host_cpu_percent is not None]
        st = self.step_times_ms
        dur = (self._t_stop or time.time()) - (self._t_start or time.time())

        def pct(data, p):
            if not data:
                return None
            data = sorted(data)
            return data[min(int(len(data) * p), len(data) - 1)]

        mean_step = statistics.fmean(st) if st else None
        std_step = statistics.pstdev(st) if len(st) > 1 else None
        unavailable = list(UNSAMPLED)
        if self.samples and not mems:
            # a CPU run has no device allocator to read
            unavailable.append("device_memory")
        return ProfileAnalysis(
            duration_s=dur,
            num_samples=len(self.samples),
            mean_memory_mb=statistics.fmean(mems) if mems else None,
            peak_memory_mb=max(mems) if mems else None,
            mean_host_cpu=statistics.fmean(cpus) if cpus else None,
            step_count=len(st),
            mean_step_ms=mean_step,
            p50_step_ms=pct(st, 0.50),
            p99_step_ms=pct(st, 0.99),
            std_step_ms=std_step,
            step_time_cv=(std_step / mean_step
                          if st and mean_step and std_step is not None
                          else None),
            unavailable_channels=unavailable,
        )

    def print_report(self):
        """(reference: gpu_profiler.py:279-331, with the unsampled
        channels named instead of NVML's)."""
        a = self.analyze()
        print("\n" + "=" * 64)
        print(f"  DEVICE PROFILE: {self.experiment_name}")
        print("=" * 64)
        print(f"  Duration: {a.duration_s:.2f}s, samples: {a.num_samples}")
        if a.mean_memory_mb is not None:
            print(f"  Device memory: mean {a.mean_memory_mb:.0f} MB, "
                  f"peak {a.peak_memory_mb:.0f} MB")
        if a.mean_host_cpu is not None:
            print(f"  Host CPU: mean {a.mean_host_cpu:.0f}%")
        if a.step_count:
            print(f"  Steps: {a.step_count}  mean {a.mean_step_ms:.2f} ms  "
                  f"p50 {a.p50_step_ms:.2f}  p99 {a.p99_step_ms:.2f}")
            if a.step_time_cv is not None:
                locked = a.step_time_cv < 0.05
                print(f"  Step-time jitter (CV): {a.step_time_cv:.3f} "
                      f"({'stable' if locked else 'UNSTABLE'}) "
                      "[clock-stability analogue]")
        print(f"  Not sampled: {', '.join(a.unavailable_channels)}")
        print("  Methodology: timings end with torch.cuda.synchronize; "
              "first call per shape excluded only if warmed up by caller.")
        print("=" * 64)

    def save_samples(self, filepath: str):
        """(reference: gpu_profiler.py:373-400)"""
        payload = {
            "experiment": self.experiment_name,
            "analysis": dataclasses.asdict(self.analyze()),
            "samples": [dataclasses.asdict(s) for s in self.samples],
            "step_times_ms": self.step_times_ms,
        }
        with open(filepath, "w") as f:
            json.dump(payload, f, indent=2)


def compare_experiments(profilers: Dict[str, DeviceProfiler]):
    """Cross-run comparison table (reference: gpu_profiler.py:333-371);
    memory and step-time stats in place of the power table."""
    print("\n" + "=" * 72)
    print("  EXPERIMENT COMPARISON")
    print("=" * 72)
    print(f"  {'experiment':24s} {'steps':>6s} {'mean ms':>9s} "
          f"{'p99 ms':>9s} {'CV':>6s} {'peak MB':>9s}")
    for name, prof in profilers.items():
        a = prof.analyze()
        print(f"  {name:24s} {a.step_count:6d} "
              f"{a.mean_step_ms or float('nan'):9.2f} "
              f"{a.p99_step_ms or float('nan'):9.2f} "
              f"{a.step_time_cv if a.step_time_cv is not None else float('nan'):6.3f} "
              f"{a.peak_memory_mb or float('nan'):9.0f}")
    print("  NOTE: no power channel is sampled; step-time jitter is the "
          "validity signal instead.")
    print("=" * 72)


def measure_instrumentation_overhead(workload_fn: Callable[[], None],
                                     sample_interval_ms: float = 10.0,
                                     repeats: int = 3) -> dict:
    """Same workload with and without sampling; % overhead
    (reference: gpu_profiler.py:415-468). ``workload_fn`` fences its own
    device work."""
    def timed(with_profiler: bool) -> float:
        best = float("inf")
        for _ in range(repeats):
            prof = DeviceProfiler(sample_interval_ms) if with_profiler else None
            if prof:
                prof.start()
            try:
                t0 = time.perf_counter()
                workload_fn()
                dt = time.perf_counter() - t0
            finally:
                if prof:
                    prof.stop()
            best = min(best, dt)
        return best

    base = timed(False)
    instrumented = timed(True)
    overhead_pct = (instrumented - base) / base * 100.0 if base > 0 else 0.0
    result = {
        "baseline_s": base,
        "instrumented_s": instrumented,
        "overhead_percent": overhead_pct,
    }
    print(f"Instrumentation overhead: {overhead_pct:+.1f}% "
          f"({base:.3f}s -> {instrumented:.3f}s)")
    return result


class TraceCapture:
    """``torch.profiler`` context: an op- and kernel-level timeline written
    as a Chrome trace (``path``, under ``log_dir``) on exit, the program's
    spans (``span``) among its events. The card's events are traced where
    CUPTI delivers them; a window can come back without device events, so
    nothing should rest on them."""

    def __init__(self, log_dir: str = "output/torch_trace"):
        self.log_dir = log_dir
        self.path: Optional[Path] = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        out = Path(self.log_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.path = out / f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"
        self._prof.export_chrome_trace(str(self.path))
        return False
