"""Precision-ladder throughput bench: ms a step and pairs/s for each mode.

Counterpart of ``tools/ladder_bench.py``: the PERF.md ladder tables (2-D
disk-galaxy or 3-D Plummer-sphere ICs) on the card. Each mode runs
through ``DirectSimulation`` (the host tick loop, no host sync between
ticks), warmed by one call, then the best wall of k calls by the host
clock, each ended by ``torch.cuda.synchronize()`` (bench.py's protocol).
The float64 row times the plain native-f64 baseline
(``ops/forces.baseline_accelerations``), not a kernel, for
``--f64-steps`` steps, by default max(2, steps // 10).

Prints ONE JSON object, ``{"device", "impl", "rows"}``; each row holds
mode, dim, n, steps, ms_per_step and pairs_per_sec. On the CPU
(``--device cpu``) n is capped at 2048.

    python -m nbody_tpu_torch.ladder_bench --n 131072 --dim 3 --steps 30
    python -m nbody_tpu_torch.ladder_bench --modes float32,int4 --dim 3 \
        --n 1048576 --steps 5
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from nbody_tpu_torch.bench import Arm, best_of, device_info, launch_counts, \
    launches_since, log

DEFAULT_MODES = "float32,bfloat16,float16,int8,int4,custom,float64"
CPU_MAX_N = 2048


def build_parser() -> argparse.ArgumentParser:
    from nbody_tpu_torch.models.direct import IMPLS

    p = argparse.ArgumentParser(description="Precision-ladder throughput "
                                            "bench")
    p.add_argument("--n", type=int, default=131072)
    p.add_argument("--dim", type=int, default=2, choices=(2, 3))
    p.add_argument("--steps", type=int, default=30,
                   help="ticks per timed call")
    p.add_argument("--modes", type=str, default=DEFAULT_MODES)
    p.add_argument("--best-of", type=int, default=3)
    p.add_argument("--impl", type=str, default="auto", choices=IMPLS,
                   help="force impl of the degraded modes")
    p.add_argument("--f64-steps", type=int, default=None,
                   help="steps a timed call of the float64 baseline "
                        "(default max(2, steps // 10))")
    p.add_argument("--output", type=str, default=None,
                   help="also write the JSON report here")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def mode_steps(mode: str, steps: int, f64_steps: int | None) -> int:
    """Steps a timed call of ``mode``: the float64 baseline's are fewer."""
    if mode in ("float64", "f64"):
        return f64_steps or max(2, steps // 10)
    return steps


def main(argv=None, arms: list | None = None) -> dict:
    """Times each mode and prints the report; returns it. Each mode's
    record (bench.Arm, launches from set-up on) is appended to ``arms``
    when one is given."""
    from nbody_tpu_torch.models.direct import DirectSimulation, \
        _resolve_device
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy, \
        create_plummer_sphere

    args = build_parser().parse_args(argv)
    dev = _resolve_device(args.device)
    info = device_info(dev)
    log(f"device={info}")
    n = args.n if dev.type == "cuda" else min(args.n, CPU_MAX_N)
    make_ics = create_disk_galaxy if args.dim == 2 else create_plummer_sphere
    pos, vel, m = make_ics(torch.Generator().manual_seed(42), num_stars=n)

    rows = []
    for mode in args.modes.split(","):
        mode = mode.strip()
        steps = mode_steps(mode, args.steps, args.f64_steps)
        before = launch_counts()
        sim = DirectSimulation(pos, vel, m, precision=mode,
                               force_impl=args.impl, device=dev)
        base = " (the plain native-f64 baseline, no kernel)" \
            if sim.is_baseline else ""

        def one():
            sim.step(steps)
            return sim.state.positions

        wall, _ = best_of(1, one)
        log(f"{mode}: warmup ({steps} steps) {wall:.1f}s{base}")
        wall, _ = best_of(args.best_of, one)
        arm = Arm(mode, n, args.dim, mode, steps, args.best_of, wall,
                  launches_since(before))
        log(f"{mode}: dim={args.dim} N={n}: {arm.ms_per_step:.1f} ms/step  "
            f"{arm.pairs_per_sec:.3e} pairs/s{base}; launches "
            f"{arm.launches}")
        if arms is not None:
            arms.append(arm)
        rows.append({"mode": mode, "dim": args.dim, "n": n, "steps": steps,
                     "ms_per_step": arm.ms_per_step,
                     "pairs_per_sec": arm.pairs_per_sec})
        del sim

    report = {"device": info, "impl": args.impl, "rows": rows}
    print(json.dumps(report), flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
