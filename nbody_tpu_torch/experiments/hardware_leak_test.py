"""Hardware leak test: does "broken physics" cost extra energy?

PyTorch counterpart of ``nbody_tpu.experiments.hardware_leak_test``
(reference: hardware_leak_test.py:74-612). The reference drives six
workload patterns while a 10 Hz NVML+psutil monitor thread records power,
then computes "unexplained power" — the power not explained by reported
utilization. ``utils.profiler.DeviceProfiler`` samples no power channel
(as the JAX package's does not), so the same six workloads run under the
documented degraded telemetry mode (SURVEY.md §7 'NVML-shaped features'):
the monitor records host CPU, RSS and device memory, and the "parasitic
energy" observable becomes per-iteration wall-time inflation of the
broken workload relative to the clean one at identical logical work.

Each workload runs for a set time on ``--device`` (default ``cuda``; with
no card it raises and names ``--device cpu``), so its iteration count
depends on the device's speed and is read from the report.

Usage:
    python -m nbody_tpu_torch.experiments.hardware_leak_test --quick
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from pathlib import Path

import torch

from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.profiler import DeviceProfiler, fence
from nbody_tpu_torch.utils.reproducibility import seed_key

SIM_CHUNK = 20          # ticks a simulation workload's iteration runs
FLOAT64_MAX_STARS = 400  # the float64 workload's cap on N
STRESS_SIDE, STRESS_ROUNDS = 512, 8
THRASH_SIDE = 1024


def _workload_idle(duration_s: float):
    time.sleep(duration_s)
    return 0


def _make_sim_workload(precision, num_stars, seed, device=None):
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    sim = DirectSimulation(pos, vel, m, precision=precision, device=device)
    sim.step(SIM_CHUNK)  # warm the launches the loop measures
    fence(sim.state.positions)

    def run(duration_s: float):
        iters = 0
        t_end = time.perf_counter() + duration_s
        while time.perf_counter() < t_end:
            sim.step(SIM_CHUNK)
            fence(sim.state.positions)
            iters += SIM_CHUNK
        return iters

    return run


def recursive_chain(a: torch.Tensor) -> torch.Tensor:
    """STRESS_ROUNDS rounds of log(exp(a @ a * 1e-3) + 1) (reference:
    hardware_leak_test.py:557-560); the product is a plain matmul in
    float32 (TF32 stays off, torch's default)."""
    for _ in range(STRESS_ROUNDS):
        a = torch.log(torch.exp(a @ a * 1e-3) + 1.0)
    return a


def _workload_recursive_stress(duration_s: float, device=None):
    """matmul/log/exp chains (reference: hardware_leak_test.py:557-560)."""
    x = torch.ones((STRESS_SIDE, STRESS_SIDE), device=device) * 1.001
    fence(recursive_chain(x))
    iters = 0
    t_end = time.perf_counter() + duration_s
    while time.perf_counter() < t_end:
        fence(recursive_chain(x))
        iters += 1
    return iters


def _workload_memory_thrash(duration_s: float, device=None):
    """Repeated large alloc/free cycles: a fresh normal draw from a
    generator on the device, and its sum."""
    gen = torch.Generator(device=device).manual_seed(0)
    iters = 0
    t_end = time.perf_counter() + duration_s
    while time.perf_counter() < t_end:
        fence(torch.randn((THRASH_SIDE, THRASH_SIDE), generator=gen,
                          device=device).sum())
        iters += 1
    return iters


def run_leak_test(duration_s: float = 5.0, num_stars: int = 800,
                  seed: int = 42, device=None):
    """(reference: hardware_leak_test.py:184-370)"""
    device = _resolve_device(device)
    workloads = {
        "idle": _workload_idle,
        "float64_clean": _make_sim_workload(
            Precision.FLOAT64, min(num_stars, FLOAT64_MAX_STARS), seed,
            device),
        "float32_standard": _make_sim_workload(Precision.FLOAT32, num_stars,
                                               seed, device),
        "int4_broken": _make_sim_workload(Precision.INT4_SIM, num_stars,
                                          seed, device),
        "recursive_stress": functools.partial(_workload_recursive_stress,
                                              device=device),
        "memory_thrash": functools.partial(_workload_memory_thrash,
                                           device=device),
    }

    results = {}
    for name, fn in workloads.items():
        prof = DeviceProfiler(sample_interval_ms=100, experiment_name=name,
                              device=device)
        prof.start()
        t0 = time.perf_counter()
        iters = fn(duration_s)
        wall = time.perf_counter() - t0
        prof.stop()
        a = prof.analyze()
        results[name] = {
            "iterations": iters,
            "wall_s": wall,
            "iters_per_sec": iters / wall if wall > 0 else 0.0,
            "mean_host_cpu": a.mean_host_cpu,
            "peak_memory_mb": a.peak_memory_mb,
            "power_watts": None,  # not sampled
        }
        print(f"  {name:18s}: {iters:6d} iters in {wall:.1f}s "
              f"({results[name]['iters_per_sec']:8.1f}/s)  "
              f"cpu={a.mean_host_cpu if a.mean_host_cpu is not None else float('nan'):5.1f}%  "
              f"mem={a.peak_memory_mb if a.peak_memory_mb else 0:.0f}MB")
    return results


def analyze_leak(results) -> dict:
    """Degraded-mode 'parasitic energy' analysis
    (reference: hardware_leak_test.py:317-370): per-tick cost inflation of
    broken vs clean at identical logical work replaces the power ratio."""
    clean = results["float32_standard"]["iters_per_sec"]
    broken = results["int4_broken"]["iters_per_sec"]
    overhead = (clean / broken - 1.0) * 100.0 if broken > 0 else float("inf")
    verdict = {
        "clean_ticks_per_sec": clean,
        "broken_ticks_per_sec": broken,
        "broken_overhead_percent": overhead,
        "parasitic_cost_detected": overhead > 10.0,
        "note": ("reference measured ~31.6% power overhead for "
                 "low-precision compute on RTX 5090; the degraded mode "
                 "measures wall-time overhead of the int4 quantization "
                 "path instead (no power channel is sampled)"),
    }
    print(f"\n  int4 'broken math' overhead vs clean float32: "
          f"{overhead:+.1f}% "
          f"({'PARASITIC COST DETECTED' if verdict['parasitic_cost_detected'] else 'within noise'})")
    return verdict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Hardware leak test (degraded "
                                            "telemetry mode)")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--stars", type=int, default=800)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/hardware_leak")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def suite_sizes(argv=None) -> tuple:
    """(duration s, stars) of a main(argv) run."""
    args = build_parser().parse_args(argv)
    return (2.0, 400) if args.quick else (args.duration, args.stars)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)
    duration, stars = suite_sizes(argv)

    print("\n" + "=" * 60)
    print("HARDWARE LEAK TEST (degraded-telemetry mode)")
    print("=" * 60)
    results = run_leak_test(duration, stars, args.seed, device)
    verdict = analyze_leak(results)

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    report = {"workloads": results, "analysis": verdict}
    (out / "hardware_leak_report.json").write_text(json.dumps(report,
                                                              indent=2))
    return report


if __name__ == "__main__":
    main()
