#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``nbody_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases kernels # build + kernel checks only

Phases (any failure exits non-zero before the last line is printed):

1. card: name and power limit from nvidia-smi, torch's CUDA version.
2. build: compiles csrc/*.cu with nvcc, timed, with ptxas's summary.
3. kernels: each kernel against its plain PyTorch version on the card
   (all six degraded modes x D in {2,3} x N in {5, 300, 4099, 5000},
   unequal and equal masses, softening 0.1 and 0); max_d2 bitwise; the
   pruned bounds pass bitwise equal to the full max on a disk and on a
   ring that takes the fallback; sym_force bitwise equal run to run.
4. main: ``nbody_tpu_torch.cli.main`` at 5000 stars x 2000 ticks for
   float64, float32 and int4, with the launch counters read around it.
5. gate: float32, int4 and float64 from the JAX package's committed ICs
   at 5000 x 2000, held to the torch-reference envelopes cached under
   tools/reference_cache/ (the rule of tools/reference_parity.py).
6. perf: throughput at N=131072 and kernel-vs-plain times.

One more phase runs only when asked for (``--phases profile``): the main
path under ``torch.profiler`` at 5000 and 131072 stars, per mode: wall,
device kernel time, busy share and the top kernels, also written as JSON
to ``--profile-out``.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PHASES = ("kernels", "main", "gate", "perf")   # the default run
EXTRA_PHASES = ("profile",)
MODES = ("float32", "bfloat16", "float16", "int8", "int4", "custom")
STARS, TICKS, INTERVAL = 5000, 2000, 100
BIG_N = 131072

KERNELS = {
    "sym_force": {"source": "nbody_tpu_torch/csrc/sym_force.cu",
                  "replaces": "nbody_tpu/ops/pallas_nbody.py:260"},
    "max_d2": {"source": "nbody_tpu_torch/csrc/max_dist_sq.cu",
               "replaces": "nbody_tpu/ops/pallas_nbody.py:1263"},
}


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def make_inputs(n: int, dim: int, equal_masses: bool, seed: int, dev):
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy
    gen = torch.Generator().manual_seed(seed)
    if dim == 2:
        pos, _, m = create_disk_galaxy(gen, num_stars=n)
    else:
        pos = torch.randn((n, 3), generator=gen) * 5.0
        m = torch.ones(n)
    if not equal_masses:
        m = 1.0 + torch.rand(n, generator=gen)
    return pos.to(dev).contiguous(), m.to(torch.float32).to(dev)


def ring_positions(n: int, dev) -> torch.Tensor:
    """A ring whose radius peaks gently at angle 0: every point clears the
    pruned pass's radius threshold, so it must take its full-set fallback,
    and the 1024 largest radii form an arc without the diameter pair."""
    ang = torch.arange(n, dtype=torch.float64) * (2 * np.pi / n)
    r = 10.0 + 0.01 * torch.cos(ang)
    pos = torch.stack([r * torch.cos(ang), r * torch.sin(ang)], 1)
    return pos.to(torch.float32).to(dev).contiguous()


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

RTOL, ATOL = 5e-5, 2e-6   # the float tolerance of tests/test_pallas_kernel.py
FLIPS_ALLOWED = 4         # per case, after the int modes' quantize_force


def agree(got, want, scale):
    """The elementwise rule |got - want| <= ATOL + RTOL * max(|want|, scale)
    over finite entries; non-finite entries (f16 rounding a tiny d^2 to 0
    at zero softening) must be the same inf/NaN in both.
    Returns (ok, max abs err, max err / its bound, non-finite count)."""
    fin = torch.isfinite(want)
    same_nonfinite = torch.equal(torch.isfinite(got), fin) and bool(
        ((got[~fin] == want[~fin])
         | (torch.isnan(got[~fin]) & torch.isnan(want[~fin]))).all())
    err = (got[fin] - want[fin]).abs()
    bound = ATOL + RTOL * torch.maximum(want[fin].abs(), scale[fin])
    if not err.numel():
        return same_nonfinite, 0.0, 0.0, int((~fin).sum())
    ratio = (err / bound).max().item()
    return (same_nonfinite and ratio <= 1.0, err.max().item(), ratio,
            int((~fin).sum()))


def quantized_flips(got, want, q):
    """Components of quantize_force(got) and quantize_force(want) that
    differ beyond the rule's bound at max|a|, and whether each of those is
    at most one grid step apart (a difference inside the tolerance that
    straddles a rounding edge of the tensor-global linear grid)."""
    from nbody_tpu_torch.ops.precision import quantize_force
    gq, wq = quantize_force(got, q), quantize_force(want, q)
    step = (want.max() - want.min()) / (q.levels - 1)
    tol = ATOL + RTOL * want.abs().max()
    diff = (gq - wq).abs()
    off = diff > tol
    return int(off.sum()), bool((diff[off] <= step + tol).all())


def phase_kernels(dev, report: dict) -> None:
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import forces, hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer, dist_sq_log_bounds

    failures, n_cases, n_nonfinite, flips = [], 0, 0, 0
    worst_err, worst_ratio, worst_max = (0.0, ""), (0.0, ""), 0.0
    for dim in (2, 3):
        for n in (5, 300, 4099, 5000):
            for equal in (False, True):
                pos, m = make_inputs(n, dim, equal, seed=n + dim, dev=dev)
                for soft in (0.1, 0.0):
                    cfg = SimConfig(softening=soft)
                    gm = (cfg.G * m).contiguous()
                    max_d2 = hn.max_d2_plain(pos) + cfg.softening_sq
                    masked = soft <= 0.0
                    for mode in MODES:
                        q = Quantizer.from_string(mode)
                        case = f"{mode} D={dim} N={n} eq={equal} soft={soft}"
                        lo_hi = (dist_sq_log_bounds(q, max_d2, soft)
                                 if q.is_int else (max_d2 * 0, max_d2 * 0))
                        soft_t = torch.full((), soft, device=dev)
                        bounds = torch.stack([lo_hi[0], lo_hi[1], soft_t])
                        got = hn.sym_force(pos, gm, bounds, q, masked)
                        want = hn.sym_force_plain(pos, gm, bounds, q, masked)
                        # Zero softening: near-coincident pairs' terms, far
                        # above |a|, cancel, so two summation orders differ
                        # with the summed |terms|, not with |a|.
                        scale = (hn.sym_force_term_scale(pos, gm, bounds, q,
                                                         masked)
                                 if masked else torch.zeros_like(want))
                        ok, err, ratio, nonfinite = agree(got, want, scale)
                        n_nonfinite += nonfinite > 0
                        worst_err = max(worst_err, (err, case))
                        worst_ratio = max(worst_ratio, (ratio, case))
                        if not ok:
                            failures.append(f"{case}: max err {err:.3e} "
                                            f"({ratio:.3f} of its bound), "
                                            f"{nonfinite} non-finite")
                        if mode in ("int8", "int4"):
                            off, one_step = quantized_flips(got, want, q)
                            flips += off
                            if off > FLIPS_ALLOWED or not one_step:
                                failures.append(
                                    f"{case}: after quantize_force {off} "
                                    f"components differ (one step each: "
                                    f"{one_step})")
                        n_cases += 1
                k = hn.max_d2(pos)
                p = hn.max_d2_plain(pos)
                worst_max = max(worst_max, (k - p).abs().item())
                if not torch.equal(k, p):
                    failures.append(f"max_d2 D={dim} N={n}: {k.item()!r} "
                                    f"!= plain {p.item()!r}")
    torch.cuda.synchronize()
    print(f"kernels: sym_force vs plain, {n_cases} cases, every mode held "
          f"elementwise to |err| <= {ATOL} + {RTOL} max(|a|, s), s = summed "
          f"|terms| at zero softening and 0 otherwise; int8/int4 after "
          f"quantize_force: at most {FLIPS_ALLOWED} components a case one "
          f"grid step apart ({flips} in all): {len(failures)} failures")
    print(f"kernels: worst abs err {worst_err[0]:.4e} ({worst_err[1]}); "
          f"worst err/bound {worst_ratio[0]:.4f} ({worst_ratio[1]}); "
          f"{n_nonfinite} float cases hold non-finite forces (f16 at zero "
          f"softening), equal in both; max_d2 bitwise vs plain on 16 inputs")
    check(not failures, "kernel disagreements:\n  " + "\n  ".join(failures))
    report["sym_force"].update(max_abs_err=worst_err[0],
                               err_over_bound=worst_ratio[0], cases=n_cases)
    report["max_d2"].update(cases=16)

    # max_d2: the skip flag, and the pruned pass against the full max.
    cfg = SimConfig()
    pos, _ = make_inputs(STARS, 2, True, seed=1, dev=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    check(hn.max_d2(pos, skip=one).item() == 0.0, "max_d2 ignored skip=1")
    check(torch.equal(hn.max_d2(pos, skip=one * 0), hn.max_d2_plain(pos)),
          "max_d2 with skip=0 differs from plain")
    for name, geom in (("disk", pos), ("ring", ring_positions(STARS, dev)),
                       ("disk-3d", make_inputs(STARS, 3, True, 2, dev)[0])):
        pruned = hn.max_pairwise_dist_sq_pruned(geom, cfg)
        full_k = hn.max_dist_sq(geom, cfg)
        full_p = forces.max_pairwise_dist_sq(geom, cfg)
        print(f"kernels: pruned max on {name}: {pruned.item()!r} "
              f"(full kernel {full_k.item()!r}, full plain "
              f"{full_p.item()!r})")
        check(torch.equal(pruned, full_k) and torch.equal(full_k, full_p),
              f"pruned != full max on {name}")
    ring = ring_positions(STARS, dev)
    r = torch.linalg.vector_norm(ring - ring.mean(0), dim=1)
    cand = ring[torch.topk(r, 1024).indices]
    check(hn.max_d2(cand) < hn.max_d2(ring),
          "ring: the candidates alone hold the max, the fallback is untested")
    report["max_d2"]["max_abs_err"] = worst_max

    # sym_force twice: bitwise equal.
    for mode in ("float32", "int4"):
        q = Quantizer.from_string(mode)
        a = hn.sym_accelerations(pos, torch.ones(STARS, device=dev), q, cfg)
        b = hn.sym_accelerations(pos, torch.ones(STARS, device=dev), q, cfg)
        check(torch.equal(a, b), f"sym_force not deterministic ({mode})")
    print("kernels: sym_force run-to-run bitwise equal (float32, int4); "
          "max_d2 skip flag honoured")


# --------------------------------------------------------------------------
# Phase 4: the main path through the CLI
# --------------------------------------------------------------------------

def phase_main(dev, report: dict) -> None:
    from nbody_tpu_torch import cli
    from nbody_tpu_torch.ops import hopper_nbody as hn

    argv = ["--device", str(dev), "--stars", str(STARS), "--ticks",
            str(TICKS), "--snapshot-interval", str(INTERVAL), "--compare",
            "float64,float32,int4", "--output",
            str(REPO / "output" / "chip_smoke")]
    print(f"main: nbody_tpu_torch.cli.main({argv})")
    for k in hn.LAUNCHES:
        hn.LAUNCHES[k] = 0
    tee = Tee(sys.stdout)
    old, sys.stdout = sys.stdout, tee
    t0 = time.time()
    try:
        histories = cli.main(argv)
    finally:
        sys.stdout = old
    wall = time.time() - t0
    launches = dict(hn.LAUNCHES)
    text = tee.buf.getvalue()

    per_mode = {}
    for block in text.split("Running simulation: ")[1:]:
        mode = block.split()[0]
        launched = json.loads(re.search(r"kernel launches: (\{.*\})",
                                        block).group(1))
        rate = re.search(r"(\d+) ticks in ([\d.]+)s \(([\d.]+) ticks/s, "
                         r"([\d.e+]+) pairwise", block)
        per_mode[mode] = launched
        print(f"main: {mode}: ticks/s {rate.group(3)}, pairwise "
              f"interactions/s {rate.group(4)}, launches {launched}")
    check(set(per_mode) == {"float64", "float32", "int4_sim"},
          f"modes run: {sorted(per_mode)}")
    for mode in ("float32", "int4_sim"):
        check(per_mode[mode]["sym_force"] >= TICKS,
              f"{mode}: sym_force launched {per_mode[mode]['sym_force']} "
              f"times in {TICKS} ticks")
    check(per_mode["int4_sim"]["max_d2"] >= TICKS,
          "int4: max_d2 not launched on every tick")
    for mode, h in histories.items():
        check(len(h.total_energy) == TICKS // INTERVAL + 1
              and np.isfinite(h.total_energy).all(),
              f"{mode}: history not finite / wrong length")
    print(f"main: wall {wall:.1f}s for three modes; launches {launches}")
    for k in KERNELS:
        report[k]["launches"] = launches[k]
        check(launches[k] > 0, f"{k} was never launched on the main path")


# --------------------------------------------------------------------------
# Phase 5: the reference gate
# --------------------------------------------------------------------------

def radius90(pos) -> float:
    r = np.sqrt((np.asarray(pos, np.float64) ** 2).sum(1))
    return float(np.percentile(r, 90))


def phase_gate(dev) -> None:
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.models.galaxy import load_disk_fixture

    pos, vel, m = load_disk_fixture(STARS, 42, device=dev)
    cache = REPO / "tools" / "reference_cache"
    fails = []
    for mode in ("float32", "int4", "float64"):
        stem = f"ref_s{STARS}_t{TICKS}_i{INTERVAL}_seed42_{mode}"
        ref = json.loads((cache / f"{stem}.json").read_text())
        perm_path = cache / f"{stem}_perm.json"
        ref_perm = (json.loads(perm_path.read_text())
                    if perm_path.exists() else None)
        t0 = time.time()
        sim = DirectSimulation(pos, vel, m, precision=mode, device=dev)
        e0 = sim.get_total_energy()
        snaps, _ = sim.run_with_history(TICKS, INTERVAL)
        drifts = (np.asarray(snaps.total) - e0) / abs(e0) * 100.0
        our_pos = sim.positions.cpu().numpy()
        wall = time.time() - t0
        # The rule of tools/reference_parity.py:258-269.
        spread = r_spread = 0.0
        if ref_perm is not None:
            spread = abs(ref["drifts"][-1] - ref_perm["drifts"][-1])
            r_spread = abs(radius90(ref["final_pos"])
                           - radius90(ref_perm["final_pos"]))
        final_ref, final_our = ref["drifts"][-1], float(drifts[-1])
        scale = max(abs(final_ref), abs(final_our), 0.05)
        tol = max(0.5 * scale, 0.05, 2.0 * spread)
        agree = abs(final_ref - final_our) < tol
        r_ref, r_our = radius90(ref["final_pos"]), radius90(our_pos)
        r_tol = max(0.1 * r_ref, 2.0 * r_spread)
        r_agree = abs(r_ref - r_our) < r_tol
        print(f"gate: {mode}: drift per snapshot (%) ours "
              f"{[round(float(d), 6) for d in drifts]}")
        print(f"gate: {mode}: final drift ours {final_our:+.6f}% vs "
              f"reference {final_ref:+.6f}% (tol {tol:.4f}) "
              f"{'AGREE' if agree else 'DISAGREE'}; radius90 ours "
              f"{r_our:.4f} vs {r_ref:.4f} (tol {r_tol:.4f}) "
              f"{'AGREE' if r_agree else 'DISAGREE'}; {wall:.1f}s")
        if not (agree and r_agree):
            fails.append(mode)
    check(not fails, f"reference gate DISAGREE for {fails}")


# --------------------------------------------------------------------------
# Phase 6: throughput and kernel times
# --------------------------------------------------------------------------

def phase_perf(dev, report: dict) -> None:
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer, dist_sq_log_bounds
    from nbody_tpu_torch.utils.profiler import fence

    cfg = SimConfig()
    for n in (STARS, BIG_N):
        pos, m = make_inputs(n, 2, True, seed=7, dev=dev)
        gm = (cfg.G * m).contiguous()
        max_d2 = hn.max_d2(pos) + cfg.softening_sq
        reps = 20 if n == STARS else 3
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            lo, hi = dist_sq_log_bounds(q, max_d2, cfg.softening_sq)
            if not q.is_int:
                lo = hi = max_d2 * 0
            bounds = torch.stack([lo, hi, max_d2 * 0 + cfg.softening_sq])
            plain_ms = cuda_ms(lambda: hn.sym_force_plain(
                pos, gm, bounds, q, False), reps)
            ms = cuda_ms(lambda: hn.sym_force(pos, gm, bounds, q, False),
                         reps)
            plain_ms2 = cuda_ms(lambda: hn.sym_force_plain(
                pos, gm, bounds, q, False), reps)
            print(f"perf: sym_force N={n} D=2 {mode}: kernel {ms:.4f} ms, "
                  f"plain {min(plain_ms, plain_ms2):.4f} ms "
                  f"(plain runs {plain_ms:.4f} / {plain_ms2:.4f})")
            if n == STARS and mode == "float32":
                report["sym_force"]["ms"] = ms
                report["sym_force"]["plain_ms"] = min(plain_ms, plain_ms2)
        plain_ms = cuda_ms(lambda: hn.max_d2_plain(pos), reps)
        ms = cuda_ms(lambda: hn.max_d2(pos), reps)
        print(f"perf: max_d2 N={n} D=2 full set: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if n == STARS:
            report["max_d2"]["ms"] = ms
            report["max_d2"]["plain_ms"] = plain_ms
        del pos, m, gm

    from nbody_tpu_torch.models.galaxy import create_disk_galaxy
    p0, v0, m0 = create_disk_galaxy(torch.Generator().manual_seed(0),
                                    num_stars=BIG_N, device=dev)
    for mode in ("float32", "int4"):
        sim = DirectSimulation(p0, v0, m0, precision=mode, device=dev)
        fence(sim.state.positions)
        t0 = time.time()
        snaps, _ = sim.run_with_history(20, 10)
        fence(sim.state.positions)
        wall = time.time() - t0
        check(np.isfinite(np.asarray(snaps.total)).all(),
              f"N={BIG_N} {mode}: non-finite energy")
        print(f"perf: main path N={BIG_N} {mode}: 20 ticks (snapshots "
              f"every 10) in {wall:.3f}s = {20 / wall:.3f} ticks/s, "
              f"{BIG_N ** 2 * 20 / wall:.4e} pairwise interactions/s")
        del sim


# --------------------------------------------------------------------------
# Extra phase: where the time of the main path goes
# --------------------------------------------------------------------------

# (stars, mode, ticks, snapshot interval)
PROFILE_RUNS = ((STARS, "float32", 200, 100), (STARS, "int4", 200, 100),
                (STARS, "float64", 200, 100), (BIG_N, "float32", 10, 10),
                (BIG_N, "int4", 10, 10))


def phase_profile(dev, out_path: Path) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy
    from nbody_tpu_torch.utils.profiler import fence

    results = {}
    for n, mode, ticks, interval in PROFILE_RUNS:
        p0, v0, m0 = create_disk_galaxy(torch.Generator().manual_seed(0),
                                        num_stars=n, device=dev)
        sim = DirectSimulation(p0, v0, m0, precision=mode, device=dev)
        # Warm the whole path, snapshots included: the first launch of
        # each library kernel loads its module, on the host's clock.
        sim.run_with_history(interval, interval)
        fence(sim.state.positions)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            sim.run_with_history(ticks, interval)
            fence(sim.state.positions)
            wall_ms = (time.time() - t0) * 1e3
        kernels = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA),
            key=lambda k: -k[1])
        device_ms = sum(k[1] for k in kernels)
        check(device_ms > 0, f"profile {n} {mode}: no device time traced")
        results[f"{n}_{mode}"] = {
            "ticks": ticks, "snapshot_interval": interval,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms,
            "top": [[name[:90], ms, count]
                    for name, ms, count in kernels[:15]]}
        print(f"profile: N={n} {mode}, {ticks} ticks, snapshots every "
              f"{interval}: wall {wall_ms:.1f} ms, device {device_ms:.1f} ms,"
              f" busy {device_ms / wall_ms:.1%}")
        for name, ms, count in kernels[:5]:
            print(f"profile:   {ms:9.3f} ms x{count:<5d} {name[:80]}")
        del sim, p0, v0, m0
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=1))
    print(f"profile: written to {out_path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of "
                         f"{PHASES + EXTRA_PHASES}")
    ap.add_argument("--profile-out", type=Path,
                    default=REPO / "output" / "profile.json",
                    help="JSON file of the profile phase")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # Only the package in this checkout, never an installed copy.
    sys.path.insert(0, str(REPO))
    from nbody_tpu_torch import _build

    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    print(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    _build.library()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} in "
          f"{time.time() - t0:.1f}s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"build: {line.strip()}")

    report = {k: {"name": k, "route": "cuda", **v, "launches": 0,
                  "max_abs_err": None, "ms": None, "plain_ms": None}
              for k, v in KERNELS.items()}
    try:
        for phase in phases:
            t = time.time()
            if phase == "kernels":
                phase_kernels(dev, report)
            elif phase == "main":
                phase_main(dev, report)
            elif phase == "gate":
                phase_gate(dev)
            elif phase == "perf":
                phase_perf(dev, report)
            elif phase == "profile":
                phase_profile(dev, args.profile_out)
            torch.cuda.synchronize()
            print(f"phase {phase}: ok in {time.time() - t:.1f}s")
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    print(card_line())
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
