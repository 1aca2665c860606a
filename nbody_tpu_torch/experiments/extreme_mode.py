"""Extreme mode: deliberate fault injection and crash hunting.

PyTorch counterpart of ``nbody_tpu.experiments.extreme_mode``
(reference: extreme_mode.py:40-796): six stress simulations that push the
float32 substrate to its edges, with a NaN/Inf/subnormal census
(reference: :81-104) and a combined crash report:

* SubnormalHell  — softening decays x0.95/tick toward 2^-149 (:111-189)
* InfinityCascade — inf injected into one star at tick 50; contagion (:196-259)
* PrecisionMassacre — f32->bf16->f16->int8 round-trip each step vs a clean
  reference twin (:266-361)
* SingularityHunt — zero softening + forced coincident pairs (:368-454)
* MemoryArmageddon — allocate until OOM, record the ceiling (:461-516)
* QuantumChaos — randomly permuted summation order vs deterministic twin
  (:523-602)

The ticks run on ``--device`` (default ``cuda``; with no card it raises
and names ``--device cpu``). Subnormals are kept (PyTorch's default, on
the CPU and on the card), so the census counts what IEEE float32 gives.

Usage:
    python -m nbody_tpu_torch.experiments.extreme_mode --quick --skip-oom
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics.glitch import count_subnormals
from nbody_tpu_torch.experiments._common import to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops import forces
from nbody_tpu_torch.ops.precision import Precision, Quantizer, f16_roundtrip
from nbody_tpu_torch.utils.profiler import fence
from nbody_tpu_torch.utils.reproducibility import seed_key

HELL_CHUNK = 20       # ticks a subnormal-hell simulation runs
CASCADE_WARM = 50     # ticks before the infinity is injected
CHUNK = 10            # ticks between the other probes' host reads
CHAOS_EVERY = 20      # chaos ticks between divergence samples
LADDER_STEPS = 255.0  # the massacre's int8-style grid


def count_extreme_values(x) -> dict:
    """NaN/Inf/subnormal census (reference: extreme_mode.py:81-104)."""
    arr = to_host(x)
    sub = count_subnormals(torch.as_tensor(arr))
    return {
        "nan": int(np.isnan(arr).sum()),
        "inf": int(np.isinf(arr).sum()),
        "subnormal": int(sub.subnormal_count),
        "zero": int((arr == 0).sum()),  # exact zeros (NaN excluded)
        "min_nonzero": float(sub.min_nonzero)
        if np.isfinite(float(sub.min_nonzero)) else None,
    }


def subnormal_hell(num_stars: int, num_ticks: int, seed: int,
                   device=None) -> dict:
    """(reference: extreme_mode.py:111-189)"""
    print("\n--- SUBNORMAL HELL ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    softening = 0.1
    rows = []
    for chunk in range(num_ticks // HELL_CHUNK):
        softening *= 0.95 ** HELL_CHUNK
        sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                               softening=max(softening, 1e-45),
                               dynamic_params=True, device=device)
        sim.step(HELL_CHUNK)
        pos, vel = sim.positions, sim.velocities
        census = count_extreme_values(vel)
        rows.append({"softening": softening, **census})
        if census["nan"] or census["inf"]:
            print(f"  BROKE at softening={softening:.2e}: {census}")
            break
    survived = not (rows and (rows[-1]["nan"] or rows[-1]["inf"]))
    print(f"  final softening {softening:.2e}, "
          f"{'survived' if survived else 'exploded'}; "
          f"subnormals seen: {max(r['subnormal'] for r in rows)}")
    return {"rows": rows, "survived": bool(survived),
            "min_softening": softening}


def infinity_cascade(num_stars: int, num_ticks: int, seed: int,
                     device=None) -> dict:
    """(reference: extreme_mode.py:196-259)"""
    print("\n--- INFINITY CASCADE ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                           device=device)
    sim.step(CASCADE_WARM)
    # inject inf into one star's velocity
    vel_inj = sim.state.velocities.clone()
    vel_inj[0, 0] = float("inf")
    sim.state = sim.state._replace(velocities=vel_inj)
    contagion = []
    for chunk in range(max((num_ticks - CASCADE_WARM) // CHUNK, 1)):
        sim.step(CHUNK)
        p = to_host(sim.positions)
        bad = int(np.isnan(p).any(axis=1).sum()
                  + np.isinf(p).any(axis=1).sum())
        contagion.append(bad)
        print(f"  tick {sim.tick}: {bad}/{num_stars} particles corrupted")
        if bad >= num_stars:
            break
    full_at = next((i for i, b in enumerate(contagion)
                    if b >= num_stars), None)
    return {"contagion": contagion,
            "full_corruption_chunk": full_at,
            "universal_contagion": bool(contagion and
                                        contagion[-1] >= num_stars)}


def ladder(x: torch.Tensor) -> torch.Tensor:
    """The massacre's round trip of a state tensor through the precision
    ladder: bf16, f16 (``ops.precision.f16_roundtrip``), then a 255-step
    min/max grid rounded half to even (``torch.round``, as ``jnp.round``).
    Eager launches: nothing may fuse the casts away."""
    x = x.to(torch.bfloat16).to(torch.float32)
    x = f16_roundtrip(x)
    lo, hi = torch.min(x), torch.max(x)
    span = torch.where(hi - lo < 1e-10, torch.ones_like(hi), hi - lo)
    return (torch.round((x - lo) / span * LADDER_STEPS) / LADDER_STEPS
            * span + lo)


def precision_massacre(num_stars: int, num_ticks: int, seed: int,
                       device=None) -> dict:
    """(reference: extreme_mode.py:266-361): round-trip the state through
    the whole precision ladder every chunk; divergence vs a clean twin."""
    print("\n--- PRECISION MASSACRE ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    clean = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                             device=device)
    massacre = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                                device=device)
    divergence = []
    for chunk in range(num_ticks // CHUNK):
        clean.step(CHUNK)
        massacre.step(CHUNK)
        massacre.state = massacre.state._replace(
            positions=ladder(massacre.state.positions),
            velocities=ladder(massacre.state.velocities))
        div = float(np.abs(to_host(massacre.positions)
                           - to_host(clean.positions)).mean())
        divergence.append(div)
    print(f"  final mean divergence: {divergence[-1]:.4f}")
    return {"divergence": divergence,
            "diverged": bool(divergence[-1] > 0.1)}


def singularity_hunt(num_stars: int, num_ticks: int, seed: int,
                     device=None) -> dict:
    """(reference: extreme_mode.py:368-454): zero softening + coincident
    pairs."""
    print("\n--- SINGULARITY HUNT ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    pos = pos.clone()
    pos[1] = pos[0]             # forced coincident pair
    pos[3] = pos[2] + 1e-7      # near-coincident pair
    sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                           cfg=SimConfig(softening=0.0), device=device)
    rows = []
    for chunk in range(num_ticks // CHUNK):
        sim.step(CHUNK)
        census = count_extreme_values(sim.positions)
        rows.append(census)
        if census["nan"] or census["inf"]:
            print(f"  SINGULARITY at tick {sim.tick}: {census}")
            break
    hit = bool(rows and (rows[-1]["nan"] or rows[-1]["inf"]))
    if not hit:
        print("  no singularity: coincident pairs produce inf force * 0 "
              "distance -> NaN expected; survived means masking saved it")
    return {"rows": rows[-3:], "singularity": hit}


def memory_armageddon(step_mb: int = 256, max_steps: int = 200,
                      device=None) -> dict:
    """(reference: extreme_mode.py:461-516): allocate blocks of ``step_mb``
    on ``device`` until it runs out of memory or ``max_steps`` blocks are
    held. The blocks are dropped afterwards and, on a card, the caching
    allocator's cache is emptied, so that nothing after this probe runs
    beside the memory it reserved."""
    print("\n--- MEMORY ARMAGEDDON ---")
    device = _resolve_device(device)
    held = []
    allocated_mb = 0
    error = None
    try:
        for _ in range(max_steps):
            n = int(step_mb * 1024 * 1024 / 4)
            held.append(torch.ones((n,), dtype=torch.float32,
                                   device=device) * 1.000001)
            fence(held[-1])
            allocated_mb += step_mb
    except torch.cuda.OutOfMemoryError as e:
        error = f"{type(e).__name__}"
    finally:
        held.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(f"  OOM ceiling: ~{allocated_mb} MB ({error})")
    return {"ceiling_mb": allocated_mb, "error": error}


def chaos_step(pos, vel, acc, m, perm, q: Quantizer, cfg: SimConfig):
    """One KDK step of the chaos universe in the order ``perm`` (changes
    the reduction's rounding), then back to the particles' order
    (reference: extreme_mode.py:541-552); the plain dense force."""
    inv = torch.argsort(perm)
    p, v, a = pos[perm], vel[perm], acc[perm]
    mm = m[perm]
    v = v + a * (cfg.dt / 2)
    p = p + v * cfg.dt
    a = forces.dense_accelerations(p, mm, q, cfg, quantize_forces=False)
    v = v + a * (cfg.dt / 2)
    return p[inv], v[inv], a[inv]


def quantum_chaos(num_stars: int, num_ticks: int, seed: int,
                  device=None) -> dict:
    """(reference: extreme_mode.py:523-602): random summation-order
    permutation per step vs a deterministic twin; the permutations come
    from a generator on the device seeded by seed + 1."""
    print("\n--- QUANTUM CHAOS ---")
    pos, vel, m = create_disk_galaxy(seed_key(seed), num_stars)
    ref = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                           force_impl="dense", device=device)
    dev = ref.device
    cfg = ref.cfg
    q = Quantizer(Precision.FLOAT32)

    cpos, cvel, m = (torch.as_tensor(x).to(device=dev, dtype=torch.float32)
                     for x in (pos, vel, m))
    cacc = forces.dense_accelerations(cpos, m, q, cfg, quantize_forces=False)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    divergence = []
    for t in range(num_ticks):
        perm = torch.randperm(num_stars, generator=gen, device=dev)
        cpos, cvel, cacc = chaos_step(cpos, cvel, cacc, m, perm, q, cfg)
        ref.step(1)
        if (t + 1) % CHAOS_EVERY == 0:
            div = float(np.abs(to_host(cpos)
                               - to_host(ref.positions)).mean())
            divergence.append(div)
    print(f"  divergence after {num_ticks} ticks: {divergence[-1]:.3e}")
    return {"divergence": divergence,
            "chaos_amplified": bool(divergence[-1] > 1e-4)}


def suite_sizes(quick: bool) -> dict:
    """Each probe's (stars, ticks) at --quick or at the full defaults
    (extreme_mode.py:230-241 of the JAX package)."""
    n = 200 if quick else 400
    ticks = 100 if quick else 300
    return {"subnormal_hell": (n, ticks),
            "infinity_cascade": (n, ticks + 100),
            "precision_massacre": (n, ticks),
            "singularity_hunt": (n, ticks),
            "quantum_chaos": (min(n, 200), ticks)}


PROBES = {"subnormal_hell": subnormal_hell,
          "infinity_cascade": infinity_cascade,
          "precision_massacre": precision_massacre,
          "singularity_hunt": singularity_hunt,
          "quantum_chaos": quantum_chaos}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extreme mode fault injection")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/extreme")
    p.add_argument("--skip-oom", action="store_true",
                   help="skip the deliberate OOM probe")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)

    print("\n" + "=" * 60)
    print("EXTREME MODE: deliberate crash hunting")
    print("=" * 60)
    report = {name: PROBES[name](n, ticks, args.seed, device)
              for name, (n, ticks) in suite_sizes(args.quick).items()}
    if not args.skip_oom:
        report["memory_armageddon"] = memory_armageddon(device=device)

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "extreme_mode_report.json").write_text(
        json.dumps(report, indent=2, default=str))
    print(f"\nCrash report written to {out / 'extreme_mode_report.json'}")
    return report


if __name__ == "__main__":
    main()
