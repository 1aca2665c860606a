"""Behavioral gate of the direct engine against the torch reference's cached runs.

Port-owned counterpart of ``tools/reference_parity.py``, which the port
may not import: the canonical workload (the JAX package's disk ICs of
5000 stars, seed 42, 2000 ticks, an energy snapshot every 100) run by
``DirectSimulation`` per precision mode and held to the cached torch
reference trajectory of that mode, widened by the reference's own
summation-order chaos where its permuted twin is cached. The rule
(``gate_row``) is the tool's ``:258-269``: the final energy drift within
max(0.5 x scale, 0.05, 2 x twin spread) percentage points, scale the
larger final drift magnitude (at least 0.05); radius90 within
max(0.1 x r_ref, 2 x twin spread).

The reference runs are read from ``tools/reference_cache/``
(``ref_s{stars}_t{ticks}_i{interval}_seed{seed}_{stem}[_perm].json``).
The torch reference itself is not part of this repository, so a row that
is not cached cannot be made here: ``load_reference`` raises, where the
JAX tool would run the reference and cache it.

    python -m nbody_tpu_torch.diagnostics.reference_gate --modes int4 \
        --perturb [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parents[2] / "tools" / "reference_cache"

# The mode strings the reference's parser knows (the tool's
# REFERENCE_MODE_STRINGS), and each alias's spelling in the cache's file
# stems (its _TO_REFERENCE_MODE): one stem a mode, so "bfloat16" and
# "bf16" read the same file.
REFERENCE_MODES = frozenset({
    "float64", "float32", "bfloat16", "bf16", "float16", "fp16",
    "int8", "int8_sim", "int4", "int4_sim", "custom",
})
CACHE_STEMS = {
    "f64": "float64", "fp64": "float64",
    "f32": "float32", "fp32": "float32",
    "f16": "float16", "half": "float16", "fp16": "float16",
    "bfloat16": "bf16",
    "int4_sim": "int4",
    "int8_sim": "int8",
}


def cache_stem(mode: str) -> str:
    """A mode's stem in the cache's file names. Raises on a mode the
    reference does not know (it would have run float64 silently)."""
    key = CACHE_STEMS.get(mode.lower(), mode.lower())
    if key not in REFERENCE_MODES:
        raise ValueError(f"mode {mode!r} is not recognised by the "
                         f"reference's get_mode_from_string (it would "
                         f"silently run FLOAT64); known: "
                         f"{sorted(REFERENCE_MODES)}")
    return key


def cache_path(stars: int, ticks: int, interval: int, seed: int, mode: str,
               perturbed: bool = False) -> Path:
    tag = "_perm" if perturbed else ""
    return CACHE_DIR / (f"ref_s{stars}_t{ticks}_i{interval}_seed{seed}_"
                        f"{cache_stem(mode)}{tag}.json")


def load_reference(stars: int, ticks: int, interval: int, seed: int,
                   mode: str, perturbed: bool = False):
    """A cached reference run: (drifts in %, final positions (N, D)
    float32, final velocities). Raises FileNotFoundError where the row was
    never cached."""
    path = cache_path(stars, ticks, interval, seed, mode, perturbed)
    if not path.exists():
        raise FileNotFoundError(
            f"no cached reference run {path.name} in {CACHE_DIR}: the torch "
            f"reference is not part of this repository, so the gate runs "
            f"only on cached rows (tools/reference_parity.py makes them)")
    blob = json.loads(path.read_text())
    return (blob["drifts"], np.asarray(blob["final_pos"], np.float32),
            np.asarray(blob["final_vel"], np.float32))


def run_ours(positions, velocities, masses, mode: str, num_ticks: int,
             interval: int, device=None, force_impl: str = "auto"):
    """Our side of the gate (the tool's ``run_ours``): ``DirectSimulation``
    from the given ICs, the total energy read every ``interval`` ticks.
    Returns (drifts in %, final positions, final velocities) as numpy."""
    from nbody_tpu_torch.models.direct import DirectSimulation

    sim = DirectSimulation(positions, velocities, masses, precision=mode,
                           force_impl=force_impl, device=device)
    e0 = sim.get_total_energy()
    drifts = []
    for _ in range(num_ticks // interval):
        sim.step(interval)
        drifts.append((sim.get_total_energy() - e0) / abs(e0) * 100)
    return (drifts, sim.positions.cpu().numpy(),
            sim.velocities.cpu().numpy())


def radius90(pos) -> float:
    """The 90th percentile of |x|, in the positions' own precision (the
    tool's arithmetic)."""
    r = np.sqrt((np.asarray(pos) ** 2).sum(1))
    return float(np.percentile(r, 90))


def gate_row(ref, our_drifts, our_pos, twin=None) -> dict:
    """The gate's row for one mode (the tool's report entry): ``ref`` and
    ``twin`` are load_reference results (``twin`` the permuted run, or
    None), ``our_drifts`` and ``our_pos`` our run's. ``row["agree"]`` is
    the verdict."""
    ref_d, ref_pos = ref[0], ref[1]
    final_ref, final_our = ref_d[-1], our_drifts[-1]
    r_ref, r_our = radius90(ref_pos), radius90(our_pos)
    spread = r_spread = 0.0
    row = {}
    if twin is not None:
        spread = abs(ref_d[-1] - twin[0][-1])
        r_twin = radius90(twin[1])
        r_spread = abs(r_ref - r_twin)
        row.update(final_drift_reference_perturbed=twin[0][-1],
                   reference_chaos_spread=spread,
                   radius90_reference_perturbed=r_twin,
                   radius90_chaos_spread=r_spread)
    scale = max(abs(final_ref), abs(final_our), 0.05)
    tol = max(0.5 * scale, 0.05, 2.0 * spread)
    agree = abs(final_ref - final_our) < tol
    # radius90 widens by the reference's own spread as the drift does (at
    # int4 the reference's radius90 moves ~18% under its own permutation)
    r_tol = max(0.1 * r_ref, 2.0 * r_spread)
    radius_agree = abs(r_ref - r_our) < r_tol
    row.update(final_drift_reference=final_ref, final_drift_ours=final_our,
               drift_envelope_agree=bool(agree), envelope_tolerance=tol,
               radius90_reference=r_ref, radius90_ours=r_our,
               radius_tolerance=r_tol, radius_agree=bool(radius_agree),
               agree=bool(agree and radius_agree))
    return row


def row_text(row: dict) -> str:
    """One line of a gate row: drift and radius90, each with its verdict."""
    return (f"final drift ours {row['final_drift_ours']:+.6f}% vs reference "
            f"{row['final_drift_reference']:+.6f}% (tol "
            f"{row['envelope_tolerance']:.4f}) "
            f"{'AGREE' if row['drift_envelope_agree'] else 'DISAGREE'}; "
            f"radius90 ours {row['radius90_ours']:.4f} vs "
            f"{row['radius90_reference']:.4f} (tol "
            f"{row['radius_tolerance']:.4f}) "
            f"{'AGREE' if row['radius_agree'] else 'DISAGREE'}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Reference gate of the direct "
                                            "engine on cached reference runs")
    p.add_argument("--stars", type=int, default=5000)
    p.add_argument("--ticks", type=int, default=2000)
    p.add_argument("--interval", type=int, default=100)
    p.add_argument("--modes", type=str, default="float32,int8,int4")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--perturb", action="store_true",
                   help="widen each envelope by the cached permuted-order "
                        "reference twin's spread (the reference's own "
                        "reduction-order chaos)")
    p.add_argument("--ours-impl", type=str, default="auto",
                   help="force impl of our side (models.direct.IMPLS)")
    p.add_argument("--output", type=str, default="output/reference_parity")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None) -> int:
    from nbody_tpu_torch.models.direct import _resolve_device
    from nbody_tpu_torch.models.galaxy import load_disk_fixture

    args = build_parser().parse_args(argv)
    device = _resolve_device(args.device)
    # The JAX package's ICs, the ones the cached reference runs start from.
    pos, vel, m = (t.numpy() for t in load_disk_fixture(args.stars,
                                                        args.seed))
    print(f"\n{'=' * 70}")
    print("REFERENCE GATE: cached torch reference vs nbody_tpu_torch, same "
          "ICs")
    print(f"stars={args.stars} ticks={args.ticks} ours={device}/"
          f"{args.ours_impl} perturb={args.perturb}")
    print(f"{'=' * 70}")
    print(f"{'mode':10s} {'tick':>5s} {'reference %':>12s} {'ours %':>12s}")
    report = {}
    ok = True
    for mode in args.modes.split(","):
        mode = cache_stem(mode.strip())
        ref = load_reference(args.stars, args.ticks, args.interval,
                             args.seed, mode)
        twin = (load_reference(args.stars, args.ticks, args.interval,
                               args.seed, mode, perturbed=True)
                if args.perturb else None)
        our_d, our_pos, _ = run_ours(pos, vel, m, mode, args.ticks,
                                     args.interval, device, args.ours_impl)
        for i, (a, b) in enumerate(zip(ref[0], our_d)):
            print(f"{mode:10s} {(i + 1) * args.interval:5d} "
                  f"{a:+12.4f} {b:+12.4f}")
        row = gate_row(ref, our_d, our_pos, twin)
        row.update(drift_reference=ref[0], drift_ours=our_d,
                   ours_device=str(device), ours_impl=args.ours_impl)
        if twin is not None:
            row["drift_reference_perturbed"] = twin[0]
        report[mode] = row
        ok &= row["agree"]
        print(f"{mode:10s} {row_text(row)}")

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "reference_parity.json").write_text(json.dumps(report, indent=2))
    print(f"\nPARITY: {'PASS' if ok else 'FAIL'} "
          f"(report: {out / 'reference_parity.json'})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
