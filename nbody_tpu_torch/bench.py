"""Headline benchmark of the port: pairwise gravitational interactions a second on one card.

Counterpart of the repository's root ``bench.py`` with its arms,
constants and protocol: the sym force kernel inside the host tick loop
(``models.direct.run_steps``: no host sync between ticks) at N=131072 in
float32 and int4 (its global-bounds max pass and force quantization), 30
steps a timed call, best of 3; int4 with ``bounds_every=4``; N=1,048,576
for 5 steps on the D=2 disk and the D=3 Plummer sphere through the
"auto" routing (the chunked path), best of 2; the D=3 Plummer sphere at
131072; and the PM engine's arm (262144 particles, D=3, a 256^3 grid,
int4, every detector live, 2 warm-up chunks, then 4 pipelined chunks of
10 steps). Equal masses are decided once from the masses on the host,
before timing. Every timed call ends in ``torch.cuda.synchronize()``;
each arm is warmed by one call first and keeps the best wall of k by the
host clock.

Prints ONE JSON line on stdout, with root bench.py's keys against its
1e10 pairs/s baseline, plus ``device`` (the card's name, count and power
limit); diagnostics go to stderr. A failing arm ends the run with its
exception. On the CPU (``--device cpu``, only when asked for) it runs
bench.py's CPU set: N=2048 through the plain tiled force, the first seven
keys.

    python -m nbody_tpu_torch.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import subprocess
import sys
import time

import torch

N = 131072
STEPS = 30          # steps a timed call at N
BEST_OF = 3
CPU_N = 2048        # the CPU set's N (bench.py's fallback)
BIG_N, BIG_STEPS, BIG_BEST_OF = 1_048_576, 5, 2
BOUNDS_EVERY = 4    # the opt-in bounds-reuse arm
SEED, BIG_SEED = 42, 43
BASELINE_PAIRS_PER_SEC = 1e10  # BASELINE.json north-star

# bench.py:207-253's PM arm: 262144 particles, D=3, a 256^3 grid, a 400
# Mpc box, z = 80, seed 1; chunks of 10 steps of dz = 0.1, every detector
# live; two warm-up chunks, then four pipelined (dispatch k+1, collect k).
PM_ARM = dict(num_particles=262144, start_redshift=80.0, dim=3, n_grid=256,
              box_size_mpc=400.0, seed=1)
PM_DZ, PM_CHUNK, PM_WARM, PM_TIMED = 0.1, 10, 2, 4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Arm:
    """One timed arm: the best wall of its timed calls and the kernel
    launches they made (every wrapper's count, summed over the timed
    calls; none on the CPU)."""

    name: str
    n: int
    dim: int
    mode: str
    steps: int          # steps a timed call
    calls: int          # timed calls
    wall: float         # best wall of a call, s
    launches: dict
    bounds_every: int = 1

    @property
    def ms_per_step(self) -> float:
        return self.wall / self.steps * 1e3

    @property
    def pairs_per_sec(self) -> float:
        return self.n * self.n * self.steps / self.wall


def launch_counts() -> dict:
    """Every kernel wrapper's launch count so far."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops import pm
    return {**hn.LAUNCHES, **pm.LAUNCHES}


def launches_since(before: dict) -> dict:
    """The launches each wrapper made since ``before`` (nonzero only)."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()
            if v != before.get(k, 0)}


def best_of(k: int, fn):
    """(best wall in s, last result) of k calls of fn(), each fenced."""
    from nbody_tpu_torch.utils.profiler import fence
    wall, out = None, None
    for _ in range(k):
        t0 = time.perf_counter()
        out = fence(fn())
        w = time.perf_counter() - t0
        wall = w if wall is None else min(wall, w)
    return wall, out


def measure(name: str, state, mode: str, impl: str, steps: int, k: int,
            uniform_gm: bool, bounds_every: int = 1):
    """One run_steps arm from ``state``: a warm-up call, then the best of
    k calls, each from ``state``. Returns (Arm, the last call's final
    state)."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.direct import run_steps
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer
    from nbody_tpu_torch.utils.profiler import fence

    q = Quantizer.from_string(mode)
    cfg = SimConfig()
    n, dim = state.positions.shape

    def one():
        # masses checked once by the caller (uniform_gm), not every call
        return hn.prevalidated(run_steps)(
            state, q, cfg, impl, q.is_int, steps, bounds_every=bounds_every,
            uniform_gm=uniform_gm)

    t0 = time.perf_counter()
    fence(one())
    log(f"{name}: warmup ({steps} steps): {time.perf_counter() - t0:.1f}s")
    before = launch_counts()
    wall, out = best_of(k, one)
    arm = Arm(name, n, dim, mode, steps, k, wall, launches_since(before),
              bounds_every)
    log(f"{name}: N={n} D={dim} {steps} steps: {arm.ms_per_step:.2f} "
        f"ms/step  {arm.pairs_per_sec:.3e} pairs/s; launches {arm.launches}")
    return arm, out


def ics(dim: int, n: int, seed: int, device):
    """bench's ICs on a seeded torch.Generator: the D=2 disk or the D=3
    Plummer sphere, as a state on ``device``, and whether its masses are
    all equal (read once, on the host)."""
    from nbody_tpu_torch.models import galaxy
    from nbody_tpu_torch.models.state import make_state

    make = galaxy.create_disk_galaxy if dim == 2 else \
        galaxy.create_plummer_sphere
    pos, vel, m = make(torch.Generator().manual_seed(seed), num_stars=n)
    uniform = bool((m == m[0]).all())
    return make_state(pos, vel, m, device), uniform


def headline_arms(state, impl: str, uniform_gm: bool) -> list:
    """bench's N arms on the D=2 disk: float32, int4, int4 with
    bounds_every=4 (a documented semantic delta: the bounds of the first
    step of each four reused). Returns [(Arm, final state)]."""
    return [measure("float32", state, "float32", impl, STEPS, BEST_OF,
                    uniform_gm),
            measure("int4", state, "int4", impl, STEPS, BEST_OF, uniform_gm),
            measure(f"int4 bounds_every={BOUNDS_EVERY}", state, "int4", impl,
                    STEPS, BEST_OF, uniform_gm, bounds_every=BOUNDS_EVERY)]


def dim3_arms(state, impl: str, uniform_gm: bool) -> list:
    """float32 and int4 on the D=3 Plummer sphere at bench's N."""
    return [measure(f"{mode} dim3", state, mode, impl, STEPS, BEST_OF,
                    uniform_gm) for mode in ("float32", "int4")]


def large_arms(state, uniform_gm: bool, label: str) -> list:
    """float32 and int4 through "auto", BIG_STEPS a call, best of
    BIG_BEST_OF: at BIG_N past one launch's scratch budget, the chunked
    Newton's-third-law path."""
    n = state.positions.shape[0]
    return [measure(f"{mode}{label} N={n}", state, mode, "auto", BIG_STEPS,
                    BIG_BEST_OF, uniform_gm) for mode in ("float32", "int4")]


def pm_arm(device, precision: str = "int4", mesh=None, timed: int = PM_TIMED,
           guard=contextlib.nullcontext):
    """bench's PM arm: ``CosmologicalEngine`` (through the sharded PM on
    ``mesh``) for PM_WARM chunks, then ``timed`` chunks pipelined (dispatch
    k+1, collect k), each dispatch inside ``guard()``. Returns (the engine,
    an Arm whose wall, steps and launches are the timed chunks')."""
    from nbody_tpu_torch.engines import cosmo
    from nbody_tpu_torch.utils.profiler import fence

    eng = cosmo.CosmologicalEngine(precision=precision, device=device,
                                   mesh=mesh, **PM_ARM)
    for _ in range(PM_WARM):
        eng.step(PM_DZ, PM_CHUNK)
    fence(eng.positions)
    before = launch_counts()
    t0 = time.perf_counter()
    pending = None
    for _ in range(timed):
        with guard():
            nxt = eng.dispatch_step(PM_DZ, PM_CHUNK)
        if pending is not None:
            eng.collect_step(pending)
        pending = nxt
    eng.collect_step(pending)
    fence(eng.positions)
    wall = time.perf_counter() - t0
    arm = Arm(f"pm256 {precision} engine", eng.num_particles, PM_ARM["dim"],
              precision, timed * PM_CHUNK, 1, wall, launches_since(before))
    return eng, arm


def device_info(device) -> dict:
    """The device a result ran on: the card's name, count and power limit
    (nvidia-smi's), or the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[device.index or 0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "power_limit": line.rsplit(",", 1)[1].strip()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Headline throughput bench")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu runs the "
                        "CPU set)")
    return p


def main(argv=None, arms: list | None = None) -> dict:
    """Runs every arm and prints the JSON line; returns its dict. Each
    arm's record (Arm) is appended to ``arms`` when one is given."""
    from nbody_tpu_torch.models.direct import _resolve_device
    from nbody_tpu_torch.parallel import ring

    args = build_parser().parse_args(argv)
    dev = _resolve_device(args.device)
    on_card = dev.type == "cuda"
    info = device_info(dev)
    log(f"device={info}")
    n = N if on_card else CPU_N
    impl = "kernel" if on_card else "tiled"
    records = [] if arms is None else arms

    def pairs(done: list) -> list:
        records.extend(arm for arm, _ in done)
        return [arm.pairs_per_sec for arm, _ in done]

    state, uniform = ics(2, n, SEED, dev)
    f32, int4, int4_b4 = pairs(headline_arms(state, impl, uniform))
    result = {
        "metric": f"pairwise_interactions_per_sec_chip_N{n}_f32",
        "value": f32,
        "unit": "pairs/s",
        "vs_baseline": f32 / BASELINE_PAIRS_PER_SEC,
        "int4_value": int4,
        "int4_vs_baseline": int4 / BASELINE_PAIRS_PER_SEC,
        "int4_bounds4_value": int4_b4,
    }
    del state
    if on_card:
        big, uniform = ics(2, BIG_N, BIG_SEED, dev)
        result["n1m_f32_value"], result["n1m_int4_value"] = pairs(
            large_arms(big, uniform, ""))
        del big
        state3, uniform = ics(3, n, SEED, dev)
        result["dim3_f32_value"], result["dim3_int4_value"] = pairs(
            dim3_arms(state3, impl, uniform))
        del state3
        big3, uniform = ics(3, BIG_N, BIG_SEED, dev)
        result["n1m_dim3_f32_value"], result["n1m_dim3_int4_value"] = pairs(
            large_arms(big3, uniform, " dim3"))
        del big3

        # The int4 PM run fires a momentum-glitch warning every tick (the
        # physics under test): the detector stays live, its per-event
        # lines are silenced and its total reported.
        glitch_log = logging.getLogger("nbody_tpu_torch.glitch")
        level = glitch_log.level
        glitch_log.setLevel(logging.ERROR)
        try:
            eng, arm = pm_arm(dev, mesh=ring.make_particle_mesh(device=dev))
        finally:
            glitch_log.setLevel(level)
        records.append(arm)
        log(f"pm256 int4 engine (pipelined, full detectors): "
            f"{arm.ms_per_step:.1f} ms/step; "
            f"{eng.glitch_detector.get_glitch_count()} glitch events "
            f"recorded (per-event log silenced); launches {arm.launches}")
        result["pm256_int4_engine_ms_per_step"] = arm.ms_per_step
    result["device"] = info
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
