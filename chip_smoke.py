#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``nbody_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases kernels # build + kernel checks only

Phases (any failure exits non-zero before the last line is printed):

1. card: name and power limit from nvidia-smi, torch's CUDA version.
2. build: compiles csrc/*.cu with nvcc (one process per source, all at
   once), timed, with ptxas's summary; the redesigned kernels' resident
   warps a SM (none may spill) and their scratch bytes at the paths'
   shapes.
3. kernels: each kernel against its plain PyTorch version on the card:
   sym_force and row_force over all six degraded modes x D in {2,3} x
   N in {5, 300, 4099, 5000}, unequal and equal masses, softening 0.1, 0
   and a run-time softening; pair_sym_force on disjoint sets of ragged
   sizes, rows and reactions; max_d2 bitwise; the pruned bounds pass
   bitwise equal to the full max on a disk and on a ring that takes the
   fallback; sym_force's triangular grid bitwise the T x T grid of a
   counted launch on every case, and over 100 consecutive launches at
   N=5000 (max_d2 also at 1024), max_d2's skip and count flags;
   sym_force, pair_sym_force and the chunked path bitwise equal run to
   run; the chunked path at N=131072 in 2 and 3 chunks against
   single-launch sym_force. row_force in its register-tiled design on
   every case above and at N=32832 (many segments), bitwise run to run;
   the general pair_sym_force in the one-pass design past the 256-tile
   edge (16448 x 16576, 16576 x 16448) and at odd multiples of 64, every
   mode, D in {2,3}; sym_force's general route on the one-pass body at N
   in {16448, 16576, 131072}, every mode, D in {2,3}, and its fused max
   there (int8, int4, custom; unequal and equal masses: the max bitwise
   max_d2's, the forces bitwise the unflagged launch's); pair_max's
   register-tiled launch bitwise its plain version (131072 all valid, the
   131075-over-S=4 phantoms, scattered invalid rows, none valid); each
   register-tiled or one-pass design bitwise over 100 consecutive
   launches; pair_pe_rows
   on both sides of its route's edge (16384, one thread a receiver;
   16385, 20011, 131075, and two sets 16385 x 300 and 40000 x 16400) with
   each id pattern (own, permuted, duplicated, overlapping, disjoint),
   softening 0.1 and 0, D in {2,3}, within the bound of the design it runs
   and bitwise run to run; max_d2 at its route edges (4096, 4097, 16384,
   16385, 20011, 131072, 131075) and on a 131072 shell, bitwise its plain
   version, with its skip and count flags.
4. main: ``nbody_tpu_torch.cli.main`` at 5000 stars x 2000 ticks for
   float64, float32 and int4, with the launch counters read around it.
5. gate: every mode of the ladder (float32, int4, float64, bfloat16,
   float16, int8, custom) from the JAX package's committed ICs at 5000 x
   2000, held to the torch-reference envelopes cached under
   tools/reference_cache/ (the rule of tools/reference_parity.py) and to
   its recorded row (GATE_ROWS) bit for bit.
6. perf: the main path's two kernels at its own shapes by device time
   (``device_ms``: torch.profiler over 50 warm calls; a CUDA-graph replay
   beside it, and in its place where the trace is empty): sym_force at
   5000 float32 and int4, the general
   sym_force (the one-pass body) at 131072 and at the 1M chunk shapes, the
   fused max's at 131072, max_d2 on the pruned pass's 1024 candidates and
   on 5000 skipped and running (bitwise its plain version); throughput at
   N=131072, kernel-vs-plain times, the equal-mass variants' one-pass
   design at 131072 and at the 1M chunk and pair shapes (209728, 209728^2
   at D=2; 174784, 174784^2 at D=3), float32 and int4, each held to its
   plain version, with the bound by the function's own operations and its
   scratch bytes; the general pair tile at 209728^2 and 174784^2, and
   row_force's register-tiled design at 131072, unmasked and self-masked,
   held to the plain version; the single-device 20-tick run at 131072
   (float32 and int4) with the snapshots' energy on pair_pe_rows (ticks/s,
   launches, the final energy within 1e-5 of the plain sum); and
   ``dynamic_params`` runs at 5000 stars against static ones.
7. large: N=1,048,576 through ``run_steps(..., "auto", ...)`` (D=2 disk
   and D=3 Plummer sphere, seed 43, float32 and int4) with the general
   kernels for 5 steps (phase bench runs the ``uniform_gm`` arms): the
   chunked path's launch counts, one force evaluation chunked (both
   variants) against the row kernel over all rows (timed once) and all
   against the plain version on sampled rows; zero softening routed to
   the row kernel; the pruned bounds pass at D=3 bitwise equal to the full
   max; max_d2 at 131072 (D=2 disk) and at 1M D=3 (Plummer and shell) in
   its register-tiled design, timed running and skipped, bitwise its
   plain version.
8. bench: the port's benchmark entry points on the card:
   ``nbody_tpu_torch.bench.main`` at full width (root bench.py's arms:
   131072 float32, int4 and int4 with bounds_every=4, 30 steps, best of
   3; 1,048,576 on the D=2 disk and the D=3 Plummer sphere, 5 steps, best
   of 2; D=3 at 131072; the PM arm), its 14 keys finite and > 0;
   ``ladder_bench.main`` at its defaults (131072, 30 steps, best of 3, the
   seven modes) at D=2 and D=3; every arm's and mode's launches exactly
   the formulas of PERF.md section 2 (``bench_arm_launches``,
   ``ladder_launches``); and the reference-gate CLI
   (``diagnostics.reference_gate.main``) on int4 at 5000 x 2000, AGREE.
9. ring: the multi-device ring (``--mesh``) and its tiles pair_force
   (#10), pair_max (#9) and pair_pe_rows (#7): each tile against its plain
   version at (5000, 5000) one set, (32768, 32771), (1, 1000) and prime
   sizes, all seven modes, D in {2,3} (pair_max bitwise), and timed and
   held at the --mesh path's 131072^2 (pair_force, pair_max and
   pair_pe_rows; pair_max also at the S=4 shard shape 32769^2,
   pair_pe_rows at the S=3 and S=4 shard shapes 43691^2 and 32769^2);
   ``cli.main`` at 131072 stars x 200 ticks with ``--mesh`` for both
   schedules, float32 and int4, launch counts exact; virtual shards
   (S in {1, 3, 4} on the one card, N in {5000, 131072, 131075}): forces
   against single-device sym_force, max d^2 bitwise, energies against the
   plain metric, launch counts exact; the reference gate through a mesh of
   one (float32, int4, float64); N=1,048,576 through
   ``DirectSimulation(mesh=...)`` on a mesh of one
   (float32 and int4) and on two virtual shards (budget-chunked pair tile).
   Equal masses take the sym tiles' equal-mass variants (timed beside the
   general ones); phantom layouts keep the general tiles bitwise.
10. cached: int4 ``run_with_snapshots(bounds_mode="cached")`` at 5000 x
   2000 (the canonical ICs) and at 131072 x 50 on a disk and on a shell
   that defeats the pruned bounds pass, beside the exact path (at 131072
   the fused max on the one-pass body): no tick's
   grid clipped, the redo launches that ran equal the violations, no
   max_d2 launch; ms a tick, violation rate, the canonical final drift
   against the int4 reference envelope (reported); the redo's walk timed
   skipped and running, bitwise the forces of the launch without it.
11. lab: ``python -m nbody_tpu_torch.lab.kernel_lab``'s table, and each
   lab kernel against its plain version at N=131072.
12. lab_r4: ``python -m nbody_tpu_torch.lab.kernel_lab_r4``'s table (the
   round-4 lab at N=129024), every round-4 variant launched, and each
   against its plain version at N=129024, float32 and int4, timed beside
   sym_force_uniform in the same call.
13. lab_r5: ``python -m nbody_tpu_torch.lab.kernel_lab_r5`` (the round-5
   lab: the d^2 accuracy study on the card, then its table at N=129024),
   each precision of the tensor-core kernel launched, the study's verdict
   checked, and each precision against its plain version at N=129024,
   D=2, timed beside sym_force_uniform in the same call.
14. pm: the particle-mesh engine (``engines/cosmo.py``). The deposit
   kernel pm_deposit (``csrc/pm_deposit.cu``) bitwise its plain version on
   a CPU copy of its inputs, its out-of-place chain and itself run to run,
   NGP and CIC (later corners in place), N in {10000, 262144}, D in {2, 3},
   on a lattice, a clustered state, the box edge and one cell, and on the
   adversarial keys of ``diagnostics/deposit_cases.py`` (runs of R and
   R + 1, long runs straddling blocks, ...); the three gate rows (the
   reference's universe_2d at N=10000 float32 and int4 and N=1024
   float32 from its cached ICs under its clock) held to the cached reference runs by the rule of
   tools/pm_reference_parity.py (``diagnostics/pm_gate.py``'s copy);
   bench.py's PM arm on one card (262144 particles, int4, D=3, a 256^3
   grid, pipelined chunks of 10 with every detector live: two warm-up
   chunks, four timed, each dispatch with host syncs made errors, the
   deposit's launches exact), then in float32; the deposit's device time
   beside the sort's and ``index_add_``'s and its two-term bound (bytes,
   the densest cell's FADD chain) at the gate's z=0.01 state and at the
   arm's shape (lattice, clustered, one cell, the arm's own state), the
   whole CIC deposit, and a profile of one step and of the probe bundle.
15. pm_mesh: the sharded particle mesh (``parallel/pm_sharded.py``).
   pm_deposit bitwise its plain version at the per-shard shapes (the arm's
   262144 particles over 4 and over 3 shards, 256^3, 64^3 and 32^3); the
   three gate rows through a mesh of one (bitwise the single device) and
   through 4 and 3 virtual shards on the card, each held to the cached
   reference runs; bench's PM arm with ``mesh=make_particle_mesh()``, on
   4 virtual shards (the slab-decomposed FFT and the slab gather) and on
   3 (the replicated fallback, phantom rows): ms a step, pm_deposit's
   launches exactly S x (steps + 2) a chunk and no other kernel, no host
   sync in a dispatch, peak memory; one force evaluation at the arm's
   state through every route against the single device (bitwise on a
   mesh of one); a device-time breakdown of one sharded step at S = 1 and
   4; ``universe3d --mesh --probes``, ``genesis --mesh`` and
   ``universe2d --mesh`` at their defaults.
16. ultimate: ``engines/ultimate.py``'s ``main --mode full`` at its
   default size (32768 particles, D=3, 64^3, int4): the five checks, the
   score, each phase's wall, and pm_deposit's launches equal to the count
   the run's chunks (steps + the probe bundle's 2), BAO epochs, structure
   census and CMB spectrum give; the 2-point shell counts of the final
   state on the card against the CPU on the same positions (each within
   2); ``hash_state`` of the card's state against its CPU copy's and the
   run's export; two ``--mode substrate`` runs with one hash; a card and
   a CPU engine from one seed with one tick-0 hash, then the mirror test
   after 10 steps; ``DeviceProfiler``'s overhead at 10 ms sampling over a
   10-step chunk, its device memory and one ``TraceCapture``.
17. realtime: ``realtime.engine.main`` at its default size for 5 s,
   headless, on one card and with ``--mesh`` (a mesh of one): ticks, no
   desync, no monitor left running, pm_deposit 2 launches a tick;
   ``realtime.visual.main`` in compare mode at 2000 stars x 20 frames of
   50 ticks: sym_force and max_d2 one and two launches a tick (and at
   set-up) as derived, no pair_pe_rows; ``MultiverseSim`` at 1024 stars x
   60 ticks: a finite report whose reversed-order divergence grows, the
   reversed force at tick 0 within 1e-5 of max|a| of a float64 CPU sum.
18. experiments: the precision-ladder suites of
   ``nbody_tpu_torch.experiments`` with ``--device cuda``: stability,
   sensitivity, dark matter and SPARC at the JAX package's run_all
   arguments, falsification and jitter with ``--quick``, omniverse at its
   full defaults (the 20001-body cloud) and the orbital audit at its full
   size: each suite's wall, its report's keys and finite numbers, the
   smoke tests' verdicts, and the launches of sym_force,
   sym_force_uniform, max_d2 and pair_pe_rows equal to the counts derived
   from its N, ticks and modes; propagate_rk4's CUDA-graph replay bitwise
   its eager launches (both timed, in turns) and float32 within 1e-4 of
   the orbit's radius of the CPU (int4's bin flips counted);
   ``ultimate.run_all_tests(quick=True)`` on the card with no error.
19. probes: the hardware and glitch probes of
   ``nbody_tpu_torch.experiments``: ``extreme_mode.memory_armageddon`` at
   its defaults (its ceiling, and the reserved memory back where it was);
   ``density_limit_test.main`` at the card's default sweep (D=2 disk,
   1000 to 1,048,576 stars, float32 and int4, no --quick) and one D=3 row
   at 131072: ms a tick, pairs/s, the fitted exponent, peak memory; the
   nine probes through ``run_all.main --only`` at run_all's arguments:
   each status ok, JAX's report keys, finite numbers, the smoke tests'
   verdicts (the aliasing clips through, 128 doublings to inf, 150
   halvings to 0: subnormals kept); every SUITES entry imports with a
   main. The launches of sym_force, sym_force_uniform, pair_sym_force
   (both variants) and max_d2 equal the counts derived from each run's
   N, ticks and modes, from each module's own sizing (``sweep_plan``,
   ``suite_sizes``, its constants); three come from a report because the
   work depends on the run: the hardware leak's iterations and the red
   team's entropy samples (loops that run for a set time, so their
   count depends on the card's speed; the launches of one iteration are
   derived from the code) and the crash sweeps' crash ticks. The first
   launch of each kernel shape is held against its plain version: up to
   131072 points in full, sym_force past it on 4096 sampled rows (the 1M
   sweep's chunk shapes are phase large's, not held again), max_d2 past
   it bitwise its plain version.
20. multihost: the ring across processes (``parallel/multihost.py``):
   two processes of ``python -m nbody_tpu_torch.parallel.multihost_check``
   on the card, 4 virtual shards each on cuda:0, joined over gloo at
   127.0.0.1 into one mesh of S = 8, at 131072 stars, 20 ticks in 2
   chunks (the float32 sym history, an int4 run of 5 steps, a rows run of
   5 steps, the hash agreement and a view perturbed on process 1), and the
   same parts on one controller (``ParticleMesh.virtual(8)``) in this
   process: both processes bitwise each other and the one controller in
   every energy and final hash; their launches summed equal to the one
   controller's and to the ring formulas (``ring_launches``); agreement
   true and the perturbed view's false on both; each part's wall, two
   processes against one, and its time in the collectives staged through
   gloo; the first launch of each tile shape held against its plain
   version. The kernels are built here first: the processes load them.
21. dryrun: ``nbody_tpu_torch.dryrun``: ``entry()``'s tick at 4096
   stars (one sym_force launch) and ``dryrun_multichip(8)`` on the card
   (JAX's seven surfaces on 8 virtual shards), its OK line and its
   launches derived from the surfaces' sizes (``dryrun_launches``), each
   tile shape's first launch held against its plain version.
22. fuzz: ``nbody_tpu_torch.fuzz.run`` on the card at tools/tpu_fuzz.py's
   defaults (40 force and max cases from seed 20260819, 20 mesh cases:
   JAX's seeded case space of primes and sizes one off a block, every
   non-f64 mode, softening 0 to 0.1, equal and unequal masses,
   adversarial clouds, 2 / 5 / 8 virtual shards), each with its static
   softening and as a run-time value, against the dense oracle, each
   launch against its plain version, bitwise run to run; then every case
   of
   ``diagnostics.fuzz_cases.edge_cases()``: both sides of each edge of
   the route functions (sym_schedule, uniform_design, sym_design with
   the fused max and the redo's flags, pair_design through the chunked
   path, the three segments functions, pe_design with each id pattern,
   max_d2_design and the pruned pass) and rings of 3, 5, 8 and 2 shards
   with phantom rows, each kernel in the design its route gives against
   its plain version and bitwise run to run. One tally a kernel and the
   phase's launches; each of the eleven force-path kernels launched.

The kernels phase also holds the equal-mass variants (D in {2,3}, every
mode, N in {4096, 32768}; the one-pass design at odd multiples of 64, N in
{192, 320, 448} and pairs 192 x 320, and at ragged 256-receiver tails,
N in {16448, 16576}), the flag off the tile (N=4100, bitwise the
general kernel), the fused max (bitwise max_d2, forces bitwise without
it), the skip flag and the lab kernels (the round-4 ones at N in
{3072, 12288}, softening 0.1 and 0; the round-5 tensor-core kernel at
each precision, N in {3072, 12288}, D in {2,3}, softening 0.1, and a tile
pair where one source alone carries the columns); perf and large time
each variant beside its general twin at 131072 and at the N=1M chunk and
pair shapes.

Two more phases run only when asked for: ``--phases profile``, the main
path under ``torch.profiler`` at 5000 and 131072 stars, per mode: wall,
device kernel time, busy share and the top kernels, also written as JSON to
``--profile-out``; and ``--phases scale``, each kernel against its plain
version at the N=1,048,576 path's shapes (plain versions take minutes
there).


The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# Only the package in this checkout, never an installed copy.
sys.path.insert(0, str(REPO))
from nbody_tpu_torch import bench  # noqa: E402
from nbody_tpu_torch.diagnostics import tolerance  # noqa: E402
from nbody_tpu_torch.diagnostics.tolerance import (  # noqa: E402
    ATOL, FLIP_RATE, FLIPS_ALLOWED, RTOL, bitwise, flips_allowed, float_rule,
    pe_bound_rtol, pe_rtol, pe_rtol_tiled, quantized_flips)

PHASES = ("kernels", "main", "gate", "perf", "large", "bench", "ring",
          "cached", "lab", "lab_r4", "lab_r5", "pm", "pm_mesh", "ultimate",
          "realtime", "experiments", "probes", "multihost",
          "dryrun", "fuzz")  # default
EXTRA_PHASES = ("profile", "scale")
MODES = ("float32", "bfloat16", "float16", "int8", "int4", "custom")
STARS, TICKS, INTERVAL = 5000, 2000, 100
BIG_N = 131072
LARGE_N, LARGE_STEPS, LARGE_SEED = 1_048_576, 5, 43   # bench.py:129-130
SAMPLED_ROWS = 4096
DYNAMIC_TICKS = 300
RUNTIME_SOFTENING = 0.05   # the kernels phase's run-time softening

_PN = "nbody_tpu/ops/pallas_nbody.py"
_SYM, _PAIR = "nbody_tpu_torch/csrc/sym_force.cu", \
    "nbody_tpu_torch/csrc/pair_sym_force.cu"
_LAB, _R4 = "nbody_tpu_torch/csrc/sym_force_lab.cu", "tools/kernel_lab_r4.py"
_MXU = "nbody_tpu_torch/csrc/sym_force_mxu.cu"
KERNELS = {
    "sym_force": {"source": _SYM, "replaces": f"{_PN}:260"},
    "sym_force_uniform": {"source": _SYM, "replaces": f"{_PN}:368"},
    "sym_force_max": {"source": _SYM, "replaces": f"{_PN}:407"},
    "sym_force_uniform_max": {"source": _SYM, "replaces": f"{_PN}:407"},
    "max_d2": {"source": "nbody_tpu_torch/csrc/max_dist_sq.cu",
               "replaces": f"{_PN}:1263"},
    "row_force": {"source": "nbody_tpu_torch/csrc/row_force.cu",
                  "replaces": f"{_PN}:645"},
    "pair_sym_force": {"source": _PAIR, "replaces": f"{_PN}:956"},
    "pair_sym_force_uniform": {"source": _PAIR, "replaces": f"{_PN}:1022"},
    "pair_force": {"source": "nbody_tpu_torch/csrc/row_force.cu",
                   "replaces": f"{_PN}:1485"},
    "pair_max": {"source": "nbody_tpu_torch/csrc/max_dist_sq.cu",
                 "replaces": f"{_PN}:1416"},
    "pair_pe_rows": {"source": "nbody_tpu_torch/csrc/pair_pe_rows.cu",
                     "replaces": f"{_PN}:1165"},
    "sym_force_lab_seedsoft": {"source": _SYM,
                               "replaces": "tools/kernel_lab.py:94"},
    "sym_force_lab_wide2": {"source": _SYM,
                            "replaces": "tools/kernel_lab.py:125"},
    "sym_force_lab_wide3": {"source": _SYM,
                            "replaces": "tools/kernel_lab.py:125"},
    "sym_force_lab_wide4": {"source": _SYM,
                            "replaces": "tools/kernel_lab.py:125"},
    "sym_force_lab_base2": {"source": _SYM,
                            "replaces": f"{_R4}:108"},
    "sym_force_lab_rt2": {"source": _LAB, "replaces": f"{_R4}:433"},
    "sym_force_lab_rt3": {"source": _LAB, "replaces": f"{_R4}:436"},
    "sym_force_lab_wideacc": {"source": _LAB, "replaces": f"{_R4}:149"},
    "sym_force_lab_base2_wideacc": {"source": _LAB,
                                    "replaces": f"{_R4}:443"},
    **{f"sym_force_mxu_{p}": {"source": _MXU,
                              "replaces": "tools/kernel_lab_r5.py:163"}
       for p in ("default", "high", "highest")},
    # no pl.pallas_call: jax.ops.segment_sum, run by XLA as a sequential
    # scatter (ngp_deposit :41, cic_deposit :65)
    "pm_deposit": {"source": "nbody_tpu_torch/csrc/pm_deposit.cu",
                   "replaces": "nbody_tpu/ops/pm.py:41"},
}

# The H100 SXM's published peaks: FP32 outside the tensor cores, HBM3
# bandwidth, and dense bf16 on the tensor cores.
PEAK_FP32, PEAK_BYTES, PEAK_BF16 = 67e12, 3.35e12, 989e12
# The canonical gate's final drifts (%) on the card: float32, int4 and
# float64 bit for bit the same since the port's first run; the other four
# modes of the ladder from their first gated run on the card.
GATE_ROWS = {"float32": -0.007852, "int4": 32.506357, "float64": -0.007517,
             "bfloat16": -0.006740, "float16": -0.008095, "int8": 0.038130,
             "custom": 0.145221}
# Every mode of the ladder the gate runs, and the mesh-of-one gate's three.
GATE_MODES = ("float32", "int4", "float64", "bfloat16", "float16", "int8",
              "custom")
RING_GATE_MODES = GATE_MODES[:3]


def weight_ops(mode: str) -> int:
    """fp32 operations of one pair's weight w from its softened d^2, counted
    in csrc/nbody_common.cuh's pair_w (a transcendental counts as one):
    rsqrt and two multiplies; plus the bf16 / f16 round trip; the int
    chain's max, log, mul, add, rint, mul, add, min, exp."""
    return {"bfloat16": 5, "float16": 5}.get(
        mode, 9 if mode in ("int8", "int4", "custom") else 3)


def pair_ops(kind: str, dim: int, mode: str) -> int:
    """fp32 operations per pair, counted from the kernel sources: d^2 is D
    subtracts, D multiplies and D-1 adds, plus the softening add. The sym
    kernels' pairs are unordered and take D fused multiply-adds (2 ops)
    into the rows and D subtracts and D fused multiply-adds into the
    reactions, and the general variant one G m multiply on each side; the
    row kernels' pairs are ordered (one G m multiply, D fused
    multiply-adds); the fused max adds one max a pair. The functions' own
    counts, whatever the kernel's design: "sym_t" the equal-mass t-form's,
    t = w diff (D multiplies) added into the rows (D adds) and subtracted
    from the reactions (D adds), as the one-pass design does; "sym_gm" the
    general function's, fr = G m_j w and fc = G m_i w (2 multiplies) and D
    fused multiply-adds of each into the rows and the reactions (4 D), as
    the one-pass body with masses per particle does; a "_max" suffix adds
    the fused max's one max a pair. "mxu" is the accumulation offload's
    FP32 share, d^2 and w alone (its sums are tensor-core flops,
    ``mxu_tensor_flops``)."""
    d2 = 3 * dim
    fused = kind.endswith("_max")
    if kind == "mxu":
        return d2 + weight_ops(mode)
    if kind in ("sym_t", "sym_t_max"):
        return d2 + weight_ops(mode) + 3 * dim + fused
    if kind in ("sym_gm", "sym_gm_max"):
        return d2 + weight_ops(mode) + 2 + 4 * dim + fused
    if kind in ("sym", "sym_uniform", "sym_max", "sym_uniform_max"):
        ops = d2 + weight_ops(mode) + 5 * dim
        ops += 0 if "uniform" in kind else 2
        return ops + fused
    if kind == "rows":
        return d2 + weight_ops(mode) + 1 + 2 * dim
    if kind == "max":
        return d2               # D subtracts, d^2, one max
    if kind == "pe":
        return d2 + 4           # rsqrt, m_i m_j, times, add
    raise ValueError(kind)


# Each sym kernel's function and its own count (pair_ops).
OWN_OPS = {"sym_force": "sym_gm", "sym_force_uniform": "sym_t",
           "sym_force_max": "sym_gm_max", "sym_force_uniform_max": "sym_t_max",
           "pair_sym_force": "sym_gm", "pair_sym_force_uniform": "sym_t"}


def mxu_tensor_flops(dim: int, passes: int) -> int:
    """Tensor-core flops per unordered pair of the accumulation offload:
    two products (rows and columns), one multiply-add (2 flops) per column
    of [x | 1] and bf16 pass (1, 3 or 6)."""
    return 4 * (dim + 1) * passes


def bound(pairs: float, ops_per_pair: int, nbytes: float,
          tensor_flops_per_pair: int = 0) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take,
    the largest of the FP32 operations over the FP32 peak, the tensor-core
    flops over the dense bf16 peak, and the bytes (each input read once,
    each output written once) over HBM's rate."""
    ops_ms = max(pairs * ops_per_pair / PEAK_FP32,
                 pairs * tensor_flops_per_pair / PEAK_BF16) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def set_timing(entry: dict, ms: float, plain_ms: float, timed_at: str,
               pairs: float, ops_per_pair: int, nbytes: float,
               tensor_flops_per_pair: int = 0) -> None:
    """A kernel's time, its plain version's, and its bound at the timed
    shape."""
    bound_ms, bound_by = bound(pairs, ops_per_pair, nbytes,
                               tensor_flops_per_pair)
    entry.update(ms=ms, plain_ms=plain_ms, timed_at=timed_at,
                 bound_ms=bound_ms, bound_by=bound_by,
                 ops=pairs * ops_per_pair, bytes=nbytes)
    if tensor_flops_per_pair:
        entry["tensor_flops"] = pairs * tensor_flops_per_pair


def sym_bytes(n: int, dim: int, fused_max: bool = False) -> float:
    """Positions, G m and bounds in, the forces (and the max) out."""
    return 4 * (n * (2 * dim + 1) + 3 + fused_max)


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


def card_state() -> str:
    """SM clock (now / max), power draw, temperature and the active
    throttle reasons: a card running below its clocks times slower."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


DEVICE_REPS = 50   # calls in device_ms's and graph_ms's warm window


def kernel_name(key: str) -> str:
    """A profiler kernel key without its namespace, return type and
    parameter list: "sym_force_tri<0, 2, true>"."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].strip()


def device_ms(fn, reps: int = DEVICE_REPS, warmup: int = 3) -> tuple:
    """Device time of a call of fn(), where the host could set cuda_ms's
    pace (kernels that finish faster than Python issues their calls):
    torch.profiler over a warm window of ``reps`` calls; each kernel's mean
    self device time times its launches a call (the profiler's count over
    ``reps``, rounded: the trace can drop an event of the window), summed.
    Returns (ms a call, {kernel: (launches a call, ms a call)}); where
    three windows in turn trace no device time (no device event, or too
    few of the window's launches to count one a call), (graph_ms, or
    cuda_ms where the calls cannot be captured, None), the fallback
    printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # A window whose trace came back without device time (seen on the
    # card: once no device event in the ninth window of a run; once a
    # window that kept too few of its events to count one a call) is
    # traced again, twice at most; each retry is printed.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        traced = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count:
                name = kernel_name(e.key)
                count, us = traced.get(name, (0, 0.0))
                traced[name] = (count + e.count,
                                us + e.self_device_time_total)
        kernels = {name: (round(count / reps), us / count / 1e3)
                   for name, (count, us) in traced.items()}
        total = sum(n * ms for n, ms in kernels.values())
        if total > 0:
            return total, {k: (n, round(n * ms, 5))
                           for k, (n, ms) in kernels.items()}
        print(f"perf: the profiler traced no device time in window "
              f"{attempt + 1} of 3 (events {traced})")
    # A process whose profiler has stopped tracing the card (seen on the
    # card: three windows in turn empty) is timed by graph_ms, or where
    # its calls cannot be captured by cuda_ms (the host's issue included);
    # no kernel names.
    ms = graph_ms(fn, reps)
    how = "a CUDA-graph replay"
    if ms is None:
        ms, how = cuda_ms(fn, reps, 0), "CUDA events"
    print(f"perf: device time by {how} instead: {ms:.5f} ms")
    return ms, None


def graph_ms(fn, reps: int = DEVICE_REPS) -> float | None:
    """Device time of a call of fn() by a CUDA graph of ``reps`` calls,
    replayed three times between CUDA events: launch gaps included, the
    host's issue excluded (device_ms's cross-check). None, with the reason
    printed, where the calls cannot be captured."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"perf: CUDA-graph capture failed: {str(e).splitlines()[0]}")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


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


def shell_positions(n: int, dev) -> torch.Tensor:
    """A 3-D shell (Fibonacci lattice) whose radius rises gently toward
    +z: every point clears the pruned pass's radius threshold, so it must
    take its full-set fallback, and the 1024 largest radii form a polar
    cap without the diameter pair."""
    k = torch.arange(n, dtype=torch.float64) + 0.5
    z = 1.0 - 2.0 * k / n
    phi = k * (np.pi * (3.0 - np.sqrt(5.0)))
    s = torch.sqrt(1.0 - z * z)
    r = 10.0 + 0.01 * z
    pos = torch.stack([r * s * torch.cos(phi), r * s * torch.sin(phi),
                       r * z], 1)
    return pos.to(torch.float32).to(dev).contiguous()


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

class Tally(tolerance.Tally):
    """tolerance.Tally with the kernels phase's report: its line, the
    kernel's entry and the check."""

    def report(self, name: str, entry: dict) -> None:
        print(f"kernels: {self.line(name + ' vs plain')}")
        # several tallies may hold one kernel: the entry keeps the worst
        entry.update(
            max_abs_err=max(entry.get("max_abs_err") or 0.0,
                            self.worst_err[0]),
            err_over_bound=max(entry.get("err_over_bound") or 0.0,
                               self.worst_ratio[0]),
            cases=(entry.get("cases") or 0) + self.cases)
        check(not self.failures, f"{name} disagreements:\n  "
              + "\n  ".join(self.failures))


def lazy_scale(pos, gm, bounds, q, masked, got, want, rows=None):
    """The summed-|terms| scale where the |a| rule alone does not hold,
    0 elsewhere: the same rule as a full scale (a row that holds at |a|
    holds at max(|a|, s)), computed in plain PyTorch only for the rows that
    need it. ``rows`` maps got/want's rows to particle indices."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    scale = torch.zeros_like(want)
    bound = ATOL + RTOL * want.abs()
    need = ((got - want).abs() > bound).any(dim=1).nonzero().flatten()
    if need.numel():
        idx = need if rows is None else rows[need]
        scale[need] = hn.sym_force_term_scale(pos, gm, bounds, q, masked,
                                              rows=idx, block=256)
    return scale


def force_bounds(q, pos, soft, dev):
    """[log_lo, log_hi, eps^2] of the kernels, from the plain max pass."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import dist_sq_log_bounds
    soft_t = torch.full((), soft, device=dev)
    max_d2 = hn.max_d2_plain(pos) + soft_t
    lo_hi = (dist_sq_log_bounds(q, max_d2, soft_t) if q.is_int
             else (max_d2 * 0, max_d2 * 0))
    return torch.stack([lo_hi[0], lo_hi[1], soft_t])


def phase_kernels(dev, report: dict) -> None:
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import forces, hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    # (label, eps^2, self-masked): static 0.1, zero, and a run-time value,
    # which the kernels self-mask since the host never reads it.
    softenings = (("0.1", 0.01, False), ("0", 0.0, True),
                  (f"run-time {RUNTIME_SOFTENING}", RUNTIME_SOFTENING ** 2,
                   True))
    sym, row, pair = Tally(), Tally(), Tally()
    worst_max, max_failures, grid_failures = 0.0, [], []
    row_runs = []   # the register-tiled row_force not bitwise run to run
    # A count flag takes sym_force's T x T grid at every N.
    counted = torch.zeros((), dtype=torch.int32, device=dev)
    for dim in (2, 3):
        for n in (5, 300, 4099, 5000):
            for equal in (False, True):
                pos, m = make_inputs(n, dim, equal, seed=n + dim, dev=dev)
                gm = (SimConfig().G * m).contiguous()
                for label, soft, masked in softenings:
                    for mode in MODES:
                        q = Quantizer.from_string(mode)
                        case = f"{mode} D={dim} N={n} eq={equal} soft={label}"
                        bounds = force_bounds(q, pos, soft, dev)
                        want = hn.row_force_plain(pos, gm, bounds, q, masked)
                        # Zero softening: near-coincident pairs' terms, far
                        # above |a|, cancel, so two summation orders differ
                        # with the summed |terms|, not with |a|.
                        scale = (hn.sym_force_term_scale(pos, gm, bounds, q,
                                                         masked)
                                 if soft == 0.0 else torch.zeros_like(want))
                        got = hn.sym_force(pos, gm, bounds, q, masked)
                        sym.hold(case, got, want, scale, q)
                        if not torch.equal(got, hn.sym_force(
                                pos, gm, bounds, q, masked, count=counted)):
                            grid_failures.append(f"sym_force {case}")
                        got = hn.row_force(pos, gm, bounds, q, masked)
                        row.hold(case, got, want, scale, q)
                        if not bitwise(got, hn.row_force(pos, gm, bounds, q,
                                                         masked)):
                            row_runs.append(case)
                k = hn.max_d2(pos)
                p = hn.max_d2_plain(pos)
                worst_max = max(worst_max, (k - p).abs().item())
                if not torch.equal(k, p):
                    max_failures.append(f"max_d2 D={dim} N={n}: "
                                        f"{k.item()!r} != plain {p.item()!r}")
    # pair_sym_force: disjoint sets of ragged sizes (softening > 0).
    for dim in (2, 3):
        for n_a, n_b in ((300, 4099), (5000, 64), (4099, 300), (5, 1)):
            pos, m = make_inputs(n_a + n_b, dim, False, seed=7 * dim + n_a,
                                 dev=dev)
            gm = (SimConfig().G * m).contiguous()
            pa, pb = pos[:n_a], pos[n_a:]
            ga, gb = gm[:n_a], gm[n_a:]
            for mode in MODES:
                q = Quantizer.from_string(mode)
                bounds = force_bounds(q, pos, 0.01, dev)
                rows, cols = hn.pair_sym_force(pa, ga, pb, gb, bounds, q)
                rw, cw = hn.pair_sym_force_plain(pa, ga, pb, gb, bounds, q)
                case = f"{mode} D={dim} {n_a}x{n_b}"
                pair.hold(case + " rows", rows, rw, torch.zeros_like(rw), q,
                          "tile")
                pair.hold(case + " cols", cols, cw, torch.zeros_like(cw), q,
                          "tile")
    row_segmented(dev, row, row_runs)
    general_runs = kernels_general_one_pass(dev, pair)
    kernels_sym_one_pass(dev, report)
    kernels_pair_max(dev, report)
    torch.cuda.synchronize()
    print(f"kernels: elementwise rule |err| <= {ATOL} + {RTOL} max(|a|, s), "
          f"s = summed |terms| at zero softening and 0 otherwise; int8, int4 "
          f"and custom after quantize_force: at most max({FLIPS_ALLOWED}, "
          f"{FLIP_RATE} x components) a case, each one grid step apart, "
          f"where a path quantizes (a pair tile, a partial sum: the float "
          f"rule alone)")
    sym.report("sym_force", report["sym_force"])
    row.report("row_force", report["row_force"])
    print(f"kernels: row_force (register-tiled) held in every case above, "
          f"bitwise run to run: {len(row_runs)} failures")
    check(not row_runs, "row_force not bitwise run to run: "
          + "; ".join(row_runs))
    pair.report("pair_sym_force", report["pair_sym_force"])
    print(f"kernels: general pair_sym_force in the one-pass design at "
          f"{GENERAL_PAIRS} and {ODD_PAIRS} (edge lowered), every mode, D in "
          f"{{2,3}}, held above; bitwise run to run: {len(general_runs)} "
          f"failures")
    check(not general_runs, "general pair_sym_force not bitwise run to "
          "run: " + "; ".join(general_runs))
    print(f"kernels: max_d2 bitwise vs plain on 16 inputs: "
          f"{len(max_failures)} failures")
    check(not max_failures, "\n  ".join(max_failures))
    report["max_d2"].update(cases=16)
    print(f"kernels: sym_force's routed grid ({hn.sym_schedule(STARS)} at "
          f"N={STARS}) bitwise the T x T grid of a counted launch on every "
          f"case above: {len(grid_failures)} failures")
    check(not grid_failures, "the triangle and the T x T grid differ: "
          + "; ".join(grid_failures))

    # max_d2: the skip and count flags at the pruned pass's two shapes
    # (1024 candidates, the full 5000), and the pruned pass against the
    # full max.
    cfg = SimConfig()
    pos, _ = make_inputs(STARS, 2, True, seed=1, dev=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    for x in (pos[:1024].contiguous(), pos):
        what = f"max_d2 N={x.shape[0]}"
        count = torch.zeros((), dtype=torch.int32, device=dev)
        check(hn.max_d2(x, skip=one, count=count).item() == 0.0,
              f"{what} ignored skip=1")
        check(torch.equal(hn.max_d2(x, skip=one * 0, count=count),
                          hn.max_d2_plain(x)),
              f"{what} with skip=0 differs from plain")
        check(count.item() == 1, f"{what} counted {count.item()} runs, "
                                 f"not 1")
    # 100 consecutive launches at the main path's shapes, bitwise: every
    # max_d2 launch found its ticket back at 0.
    for x in (pos[:1024].contiguous(), pos):
        first = hn.max_d2(x)
        check(all(torch.equal(hn.max_d2(x), first) for _ in range(100)),
              f"max_d2 N={x.shape[0]}: not bitwise over 100 launches")
    gm1 = torch.full((STARS,), cfg.G, device=dev)
    for mode in ("float32", "int4"):
        q = Quantizer.from_string(mode)
        bounds = force_bounds(q, pos, cfg.softening_sq, dev)
        first = hn.sym_force(pos, gm1, bounds, q, False)
        check(all(torch.equal(hn.sym_force(pos, gm1, bounds, q, False), first)
                  for _ in range(100)),
              f"sym_force N={STARS} {mode}: not bitwise over 100 launches")
    print("kernels: sym_force and max_d2 bitwise over 100 consecutive "
          "launches at N=5000 (and max_d2 at 1024)")
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

    # Run to run: sym_force, pair_sym_force and the chunked path bitwise.
    m = torch.ones(STARS, device=dev)
    for mode in ("float32", "int4"):
        q = Quantizer.from_string(mode)
        a = hn.sym_accelerations(pos, m, q, cfg)
        b = hn.sym_accelerations(pos, m, q, cfg)
        check(torch.equal(a, b), f"sym_force not deterministic ({mode})")
        bounds = force_bounds(q, pos, cfg.softening_sq, dev)
        ra, ca = hn.pair_sym_force(pos[:1700], m[:1700], pos[1700:],
                                   m[1700:], bounds, q)
        rb, cb = hn.pair_sym_force(pos[:1700], m[:1700], pos[1700:],
                                   m[1700:], bounds, q)
        check(torch.equal(ra, rb) and torch.equal(ca, cb),
              f"pair_sym_force not deterministic ({mode})")
        a = hn.sym_accelerations_chunked(pos, m, q, cfg, chunk=1700)
        b = hn.sym_accelerations_chunked(pos, m, q, cfg, chunk=1700)
        check(torch.equal(a, b), f"chunked path not deterministic ({mode})")
    print("kernels: sym_force, pair_sym_force and the chunked path run to "
          "run bitwise equal (float32, int4); max_d2 skip and count flags "
          "honoured")

    # The chunked path at N=131072 in 2 and 3 chunks (a ragged tail)
    # against single-launch sym_force: another summation order of the same
    # pairs, held with the summed-|terms| scale where |a| alone does not.
    pos, m = make_inputs(BIG_N, 2, False, seed=11, dev=dev)
    gm = (cfg.G * m).contiguous()
    for mode in ("float32", "int4"):
        q = Quantizer.from_string(mode)
        single = hn.sym_accelerations(pos, m, q, cfg, quantize_forces=False)
        bounds = force_bounds(q, pos, cfg.softening_sq, dev)
        for chunk in (BIG_N // 2, -(-BIG_N // 3)):
            got = hn.sym_accelerations_chunked(pos, m, q, cfg,
                                               quantize_forces=False,
                                               chunk=chunk)
            scale = lazy_scale(pos, gm, bounds, q, False, got, single)
            ok, err, ratio, _ = float_rule(got, single, scale)
            fok, off, _ = quantized_flips(got, single, q)
            print(f"kernels: chunked {-(-BIG_N // chunk)} chunks vs "
                  f"single-launch sym_force, N={BIG_N} {mode}: max err "
                  f"{err:.4e}, err/bound {ratio:.4f}, rows needing the "
                  f"|terms| scale {int((scale != 0).any(1).sum())}, "
                  f"quantize_force flips {off}")
            check(ok and fok,
                  f"chunked != sym_force at N={BIG_N} {mode} chunk {chunk}")
    del pos, m, gm
    kernels_equal_mass(dev, report)
    kernels_mxu(dev, report)
    kernels_pe_max_tiled(dev, report)


# (receivers, sources), equal counts one set: the route's edge (16384
# one thread a receiver), just past it, a prime, 131075
# (ragged), and two sets with ragged tiles either way round.
PE_SHAPES = ((16384, 16384), (16385, 16385), (20011, 20011),
             (BIG_N + 3, BIG_N + 3), (16385, 300), (40000, 16400))
# max_d2 at its route edges (64-point tile to 4096, 256 to 16384, the
# register-tiled body beyond), a prime, 131072 and 131075.
MAX_D2_EDGES = (4096, 4097, 16384, 16385, 20011, BIG_N, BIG_N + 3)


def kernels_pe_max_tiled(dev, report: dict) -> None:
    """pair_pe_rows at the route's edges (PE_SHAPES) with every id pattern,
    softening 0.1 and 0, D in {2,3}, against its plain version within the
    bound of the design it runs, bitwise run to run; max_d2 at
    MAX_D2_EDGES and on the shell that defeats the pruned pass, bitwise its
    plain version, its skip and count flags, and 100 consecutive launches
    at 131072."""
    from nbody_tpu_torch.diagnostics.fuzz_cases import PE_ID_PATTERNS
    from nbody_tpu_torch.fuzz import pe_ids
    from nbody_tpu_torch.ops import hopper_nbody as hn

    fails, worst, cases = [], (0.0, ""), 0
    for dim in (2, 3):
        for n_i, n_j in PE_SHAPES:
            pos, m = make_inputs(n_i + n_j, dim, False, seed=n_i + dim,
                                 dev=dev)
            xi, mi = pos[:n_i].contiguous(), m[:n_i].contiguous()
            xj, mj = ((xi, mi) if n_i == n_j else
                      (pos[n_i:].contiguous(), m[n_i:].contiguous()))
            design = hn.pe_design(n_i, n_j)
            rtol = pe_bound_rtol(n_i, n_j)
            for pattern in PE_ID_PATTERNS:
                ids_i, ids_j = pe_ids(pattern, n_i, n_j, dev)
                for soft in (0.01, 0.0):
                    args = (xi, mi, ids_i, xj, mj, ids_j, soft)
                    case = (f"D={dim} {n_i}x{n_j} {pattern} eps^2={soft} "
                            f"({design})")
                    got, want = hn.pair_pe_rows(*args), \
                        hn.pair_pe_rows_plain(*args)
                    cases += 1
                    fin = torch.isfinite(want)
                    err = ((got - want).abs() / want.abs())[fin]
                    ratio = err.max().item() / rtol if err.numel() else 0.0
                    worst = max(worst, (ratio, case))
                    report["pair_pe_rows"]["max_abs_err"] = max(
                        report["pair_pe_rows"]["max_abs_err"] or 0.0,
                        (got - want)[fin].abs().max().item()
                        if err.numel() else 0.0)
                    if (ratio > 1.0
                            or not torch.equal(torch.isfinite(got), fin)
                            or not bitwise(got, hn.pair_pe_rows(*args))):
                        fails.append(f"{case}: err/bound {ratio:.3f}, or "
                                     f"non-finite rows differ, or not "
                                     f"bitwise run to run")
            del pos, m, xi, xj, mi, mj
    print(f"kernels: pair_pe_rows at the route's edges, {cases} cases "
          f"(D in {{2,3}}, {PE_SHAPES}, ids {PE_ID_PATTERNS}, eps^2 0.01 and "
          f"0): {len(fails)} failures; worst err/bound {worst[0]:.4f} "
          f"({worst[1]}); the register-tiled bound 2 (128 + seg + nseg + 5) "
          f"2^-24 |row|, e.g. {pe_rtol_tiled(BIG_N, BIG_N):.3e} at "
          f"{BIG_N}^2 (one thread a receiver: {pe_rtol(BIG_N):.3e})")
    check(not fails, "pair_pe_rows (register-tiled) disagreements:\n  "
          + "\n  ".join(fails))
    report["pair_pe_rows"].update(
        cases=(report["pair_pe_rows"].get("cases") or 0) + cases,
        err_over_bound=max(report["pair_pe_rows"].get("err_over_bound")
                           or 0.0, worst[0]))

    one = torch.ones((), dtype=torch.int32, device=dev)
    max_fails, max_cases = [], 0
    inputs = [(f"D={dim} N={n}", make_inputs(n, dim, False, seed=n,
                                             dev=dev)[0])
              for dim in (2, 3) for n in MAX_D2_EDGES]
    for label, pos in inputs + [(f"D=3 N={BIG_N} shell",
                                 shell_positions(BIG_N, dev))]:
        n = pos.shape[0]
        want = hn.max_d2_plain(pos)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        max_cases += 1
        if not (bitwise(hn.max_d2(pos), want)
                and float(hn.max_d2(pos, skip=one, count=count)) == 0.0
                and bitwise(hn.max_d2(pos, skip=one * 0, count=count), want)
                and int(count) == 1):
            max_fails.append(f"max_d2 {label} ({hn.max_d2_design(n)})")
    del inputs
    pos, _ = make_inputs(BIG_N, 2, False, seed=3, dev=dev)
    same_over_launches(lambda: (hn.max_d2(pos),), f"max_d2 N={BIG_N} tiled")
    print(f"kernels: max_d2 at its route edges {MAX_D2_EDGES} and the "
          f"{BIG_N} shell, D in {{2,3}}: {max_cases} cases bitwise the plain "
          f"version, skip and count flags: "
          f"{len(max_fails)} failures; {LAUNCH_RUNS} consecutive launches at "
          f"{BIG_N} bitwise")
    check(not max_fails, "\n  ".join(max_fails))
    report["max_d2"]["cases"] = (report["max_d2"].get("cases") or 0) \
        + max_cases


ROW_SEGMENTED_N = 32832   # 65 receiver blocks x 129 segments of 2 tiles


def row_segmented(dev, tally, runs: list) -> None:
    """The register-tiled row_force where its grid has many receiver
    blocks and segments of several tiles (N=ROW_SEGMENTED_N, a ragged last
    block and tile), masked (zero softening) and not, every mode, D in
    {2,3}, held to the plain version in ``tally``; bitwise run to run
    (failures appended to ``runs``)."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    n = ROW_SEGMENTED_N
    check(hn.row_segments(n, n)[1] > 1, f"N={n}: one tile a segment")
    for dim in (2, 3):
        pos, m = make_inputs(n, dim, False, seed=n + dim, dev=dev)
        gm = (SimConfig().G * m).contiguous()
        for label, soft, masked in (("0.1", 0.01, False), ("0", 0.0, True)):
            for mode in MODES:
                q = Quantizer.from_string(mode)
                case = f"segmented {mode} D={dim} N={n} soft={label}"
                bounds = force_bounds(q, pos, soft, dev)
                got = hn.row_force(pos, gm, bounds, q, masked)
                want = hn.row_force_plain(pos, gm, bounds, q, masked)
                tally.hold(case, got, want,
                           lazy_scale(pos, gm, bounds, q, masked, got, want),
                           q)
                if not bitwise(got, hn.row_force(pos, gm, bounds, q, masked)):
                    runs.append(case)


GENERAL_PAIRS = ((16448, 16576), (16576, 16448))   # past the 256-tile edge


def kernels_general_one_pass(dev, tally) -> list:
    """The general pair_sym_force (unequal masses) in the one-pass design
    against its plain version past the rule's 256-tile edge (the pairs
    GENERAL_PAIRS: ragged 256-receiver tails) and at odd multiples of 64
    (ODD_PAIRS, the edge lowered to 0 tiles), every mode, D in {2,3},
    softening 0.1: rows and reactions held in ``tally``, one
    pair_sym_force count a call. Returns the cases not bitwise run to
    run."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    fails = []
    saved = hn.ONE_PASS_MIN_TILES
    try:
        for dim in (2, 3):
            pos, m = make_inputs(2 * max(GENERAL_PAIRS[0]), dim, False,
                                 seed=dim + 29, dev=dev)
            gm = (SimConfig().G * m).contiguous()
            for lowered, pairs in ((False, GENERAL_PAIRS), (True, ODD_PAIRS)):
                hn.ONE_PASS_MIN_TILES = 0 if lowered else saved
                for mode in MODES:
                    q = Quantizer.from_string(mode)
                    bounds = force_bounds(q, pos, 0.01, dev)
                    for n_a, n_b in pairs:
                        pa, pb = pos[:n_a], pos[n_a:n_a + n_b]
                        ga, gb = gm[:n_a], gm[n_a:n_a + n_b]
                        check(hn.pair_design(n_a, n_b, dim, q) == "one_pass",
                              f"{n_a}x{n_b}: not routed to the one-pass "
                              f"design")
                        case = f"one-pass {mode} D={dim} {n_a}x{n_b}"
                        before = dict(hn.LAUNCHES)
                        rows, cols = hn.pair_sym_force(pa, ga, pb, gb, bounds,
                                                       q)
                        check(hn.LAUNCHES["pair_sym_force"]
                              == before["pair_sym_force"] + 1
                              and hn.LAUNCHES["pair_sym_force_uniform"]
                              == before["pair_sym_force_uniform"],
                              f"{case}: not one pair_sym_force count")
                        rw, cw = hn.pair_sym_force_plain(pa, ga, pb, gb,
                                                         bounds, q)
                        for part, got, want in (("rows", rows, rw),
                                                ("cols", cols, cw)):
                            tally.hold(f"{case} {part}", got, want,
                                       torch.zeros_like(want), q, "tile")
                        again = hn.pair_sym_force(pa, ga, pb, gb, bounds, q)
                        if not (bitwise(rows, again[0])
                                and bitwise(cols, again[1])):
                            fails.append(case)
            del pos, m, gm
    finally:
        hn.ONE_PASS_MIN_TILES = saved
    return fails


ONE_PASS_NS = (16448, 16576, BIG_N)  # 257, 259 tiles (ragged tails); 131072
FUSED_MODES = ("int8", "int4", "custom")
LAUNCH_RUNS = 100   # consecutive launches of a new design, bitwise


def same_over_launches(fn, what: str) -> None:
    """fn() LAUNCH_RUNS times in a row, every result bitwise the first's
    (fn returns a tuple of tensors)."""
    first = fn()
    for k in range(LAUNCH_RUNS - 1):
        check(all(bitwise(a, b) for a, b in zip(fn(), first)),
              f"{what}: launch {k + 2} of {LAUNCH_RUNS} not bitwise the "
              f"first")


def kernels_sym_one_pass(dev, report: dict) -> None:
    """sym_force's general route and its fused max on the one-pass body
    (one_pass.cuh's GM and EMIT) at ONE_PASS_NS, D in {2,3}: the general
    route in every mode against sym_force_plain (softening 0.1, and 0
    self-masked below 131072), one sym_force count a launch; the fused max
    in FUSED_MODES for unequal and equal masses, its max bitwise max_d2's
    and the plain max's, its forces bitwise the unflagged launch's and held
    to the plain version, one sym_force_max / sym_force_uniform_max count
    a launch; each bitwise run to run, and over LAUNCH_RUNS launches at
    131072 int4."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    cfg = SimConfig()
    tallies = {k: Tally() for k in ("sym_force", "sym_force_max",
                                    "sym_force_uniform_max")}
    fails = []

    def same(what, a, b):
        if not bitwise(a, b):
            fails.append(what)

    def launched(key, fn):
        """fn()'s result, checked to count one launch of ``key`` alone."""
        before = dict(hn.LAUNCHES)
        out = fn()
        delta = {k: v - before[k] for k, v in hn.LAUNCHES.items()
                 if v != before[k]}
        check(delta == {key: 1}, f"not one {key} launch: {delta}")
        return out

    for dim in (2, 3):
        for n in ONE_PASS_NS:
            pos, m = make_inputs(n, dim, False, seed=n + dim + 41, dev=dev)
            gm = (cfg.G * m).contiguous()
            gm1 = torch.full_like(gm, cfg.G)
            want_max = hn.max_d2_plain(pos)
            same(f"max_d2 D={dim} N={n}", hn.max_d2(pos), want_max)
            softenings = (("0.1", 0.01, False),) + (
                (("0", 0.0, True),) if n < BIG_N else ())
            for label, soft, masked in softenings:
                for mode in MODES:
                    q = Quantizer.from_string(mode)
                    case = f"one-pass {mode} D={dim} N={n} soft={label}"
                    check(hn.sym_design(n, dim, q) == "one_pass",
                          f"{case}: not routed to the one-pass body")
                    bounds = force_bounds(q, pos, soft, dev)
                    got = launched("sym_force", lambda: hn.sym_force(
                        pos, gm, bounds, q, masked))
                    want = hn.sym_force_plain(pos, gm, bounds, q, masked)
                    tallies["sym_force"].hold(case, got, want, lazy_scale(
                        pos, gm, bounds, q, masked, got, want), q)
                    same(f"sym_force run to run {case}", got,
                         hn.sym_force(pos, gm, bounds, q, masked))
                    if mode not in FUSED_MODES or masked:
                        continue
                    for uniform, g in ((False, gm), (True, gm1)):
                        key = hn._variant("sym_force", uniform, True)
                        check(hn.sym_design(n, dim, q, fused_max=True)
                              == "one_pass",
                              f"{case}: the fused max not routed one-pass")
                        mx, mx2 = (torch.empty((), device=dev)
                                   for _ in range(2))
                        fused = launched(key, lambda: hn.sym_force(
                            pos, g, bounds, q, False, uniform=uniform,
                            max_out=mx))
                        kind = f"{case} uniform={uniform}"
                        same(f"fused max vs max_d2 {kind}", mx, want_max)
                        unflagged = (got if not uniform else hn.sym_force(
                            pos, g, bounds, q, False, uniform=True))
                        same(f"forces with the fused max {kind}", fused,
                             unflagged)
                        plain = (hn.sym_force_uniform_plain(
                            pos, g, bounds, q, False) if uniform else want)
                        tallies[key].hold(kind, fused, plain, lazy_scale(
                            pos, g, bounds, q, False, fused, plain), q)
                        again = hn.sym_force(pos, g, bounds, q, False,
                                             uniform=uniform, max_out=mx2)
                        same(f"fused run to run {kind}",
                             torch.cat([again.flatten(), mx2[None]]),
                             torch.cat([fused.flatten(), mx[None]]))
            del pos, m, gm, gm1
    pos, m = make_inputs(BIG_N, 2, False, seed=5, dev=dev)
    gm = (cfg.G * m).contiguous()
    q = Quantizer.from_string("int4")
    bounds = force_bounds(q, pos, cfg.softening_sq, dev)
    mx = torch.empty((), device=dev)
    for what, fn in (
            ("sym_force", lambda: (hn.sym_force(pos, gm, bounds, q,
                                                False),)),
            ("sym_force_max", lambda: (hn.sym_force(
                pos, gm, bounds, q, False, max_out=mx), mx.clone())),
            ("sym_force_uniform_max", lambda: (hn.sym_force(
                pos, gm * 0 + cfg.G, bounds, q, False, uniform=True,
                max_out=mx), mx.clone()))):
        same_over_launches(fn, f"{what} N={BIG_N} int4")
    torch.cuda.synchronize()
    for name, tally in tallies.items():
        tally.report(f"{name} (one-pass body)", report[name])
    print(f"kernels: the one-pass general sym_force and fused max at "
          f"{ONE_PASS_NS}, D in {{2,3}}: fused max bitwise max_d2, forces "
          f"bitwise the unflagged launch, run to run: {len(fails)} "
          f"failures; bitwise over {LAUNCH_RUNS} launches at N={BIG_N} int4")
    check(not fails, "not bitwise: " + "; ".join(fails))


PAIR_MAX_SETS = (32768, 32771)   # disjoint sets for the scattered layout


def kernels_pair_max(dev, report: dict) -> None:
    """pair_max's register-tiled launch bitwise its plain version, D in
    {2,3}, on the layouts the ring gives it: one set of 131072, all valid
    (and bitwise max_d2); the 131075-over-S=4 phantom layout (shards of
    32769, the phantom at the last shard's tail), every shard pair that
    touches the last shard;
    disjoint sets with a third of the rows invalid at random; no valid
    receiver, and no valid source (0). Bitwise over LAUNCH_RUNS launches at
    131072^2."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.parallel import ring

    fails, cases = [], 0
    gen = torch.Generator().manual_seed(17)
    for dim in (2, 3):
        pos, _ = make_inputs(BIG_N, dim, False, seed=dim + 51, dev=dev)
        ones = torch.ones(BIG_N, dtype=torch.bool, device=dev)
        runs = [("131072 one set, all valid", pos, pos, ones, ones)]
        n_total, shards = BIG_N + 3, 4
        extra, _ = make_inputs(3, dim, False, seed=dim, dev=dev)
        padded = ring._pad_to_shards(torch.cat([pos, extra]), shards,
                                     fill=ring._PAD_FAR)
        valid = torch.arange(padded.shape[0], device=dev) < n_total
        size = padded.shape[0] // shards
        sh = [(padded[k * size:(k + 1) * size], valid[k * size:(k + 1) * size])
              for k in range(shards)]
        for a, b in ((3, 3), (3, 0), (0, 3), (1, 3)):
            runs.append((f"{n_total} over S={shards}, shards {a}x{b}",
                         sh[a][0], sh[b][0], sh[a][1], sh[b][1]))
        n_i, n_j = PAIR_MAX_SETS
        xi, xj = pos[:n_i], pos[n_i:n_i + n_j]
        vi = (torch.rand(n_i, generator=gen) < 0.67).to(dev)
        vj = (torch.rand(n_j, generator=gen) < 0.67).to(dev)
        none_i = torch.zeros(n_i, dtype=torch.bool, device=dev)
        none_j = torch.zeros(n_j, dtype=torch.bool, device=dev)
        runs += [(f"{n_i}x{n_j} scattered invalid rows", xi, xj, vi, vj),
                 (f"{n_i}x{n_j} no valid receiver", xi, xj, none_i, vj),
                 (f"{n_i}x{n_j} no valid source", xi, xj, vi, none_j)]
        for label, a, b, va, vb in runs:
            case = f"pair_max D={dim} {label}"
            cases += 1
            before = hn.LAUNCHES["pair_max"]
            got = hn.pair_max(a, b, va, vb)
            check(hn.LAUNCHES["pair_max"] == before + 1,
                  f"{case}: not one pair_max count")
            want = hn.pair_max_plain(a, b, va, vb)
            if not bitwise(got, want):
                fails.append(f"{case}: {got.item()!r}, plain "
                             f"{want.item()!r}")
            if "no valid" in label and got.item() != 0.0:
                fails.append(f"{case}: {got.item()!r} != 0")
        if not bitwise(hn.pair_max(pos, pos, ones, ones), hn.max_d2(pos)):
            fails.append(f"pair_max D={dim} 131072 one set vs max_d2")
        del pos, padded, sh, xi, xj
    pos, _ = make_inputs(BIG_N, 2, False, seed=53, dev=dev)
    ones = torch.ones(BIG_N, dtype=torch.bool, device=dev)
    same_over_launches(lambda: (hn.pair_max(pos, pos, ones, ones),),
                       f"pair_max {BIG_N}^2")
    print(f"kernels: pair_max register-tiled bitwise its plain version in "
          f"{cases} cases (all valid, the "
          f"131075-over-S=4 phantoms, scattered invalid rows, none valid; "
          f"D in {{2,3}}): {len(fails)} failures; bitwise over "
          f"{LAUNCH_RUNS} launches at {BIG_N}^2")
    check(not fails, "\n  ".join(fails))
    report["pair_max"].update(max_abs_err=0.0, cases=cases)


EQUAL_NS = (4096, 32768)   # multiples of TILE: the equal-mass variants run
R4_NS = (3072, 12288)      # multiples of 192 and 128: every round-4 variant
RAGGED_N = 4100            # not one: the flag must give the general bits


def kernels_equal_mass(dev, report: dict) -> None:
    """The equal-mass variants of sym_force and pair_sym_force against
    their plain versions (every mode, D in {2,3}, N in EQUAL_NS; zero
    softening at the smaller N), bitwise the general kernel at a size off
    the tile; the fused max bitwise max_d2's with the forces bitwise
    those without it; the skip flag; the lab variants against their plain
    versions; every one bitwise run to run."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.lab import kernel_lab
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    cfg = SimConfig()
    counted = torch.zeros((), dtype=torch.int32, device=dev)
    tallies = {k: Tally() for k in report
               if k.startswith(("sym_force_", "pair_sym_force_"))
               and not k.startswith("sym_force_mxu_")}
    fails = []

    def same(what, a, b):
        if not bitwise(a, b):
            fails.append(what)

    for dim in (2, 3):
        for n in EQUAL_NS:
            pos, m = make_inputs(n, dim, True, seed=n + dim + 1, dev=dev)
            gm = (cfg.G * m).contiguous()
            softenings = (("0.1", 0.01, False),) + (
                (("0", 0.0, True),) if n == EQUAL_NS[0] else ())
            for label, soft, masked in softenings:
                for mode in MODES:
                    q = Quantizer.from_string(mode)
                    case = f"{mode} D={dim} N={n} soft={label}"
                    bounds = force_bounds(q, pos, soft, dev)
                    want = hn.sym_force_uniform_plain(pos, gm, bounds, q,
                                                      masked)
                    scale = (hn.sym_force_term_scale(pos, gm, bounds, q,
                                                     masked)
                             if soft == 0.0 else torch.zeros_like(want))
                    got = hn.sym_force(pos, gm, bounds, q, masked,
                                       uniform=True)
                    tallies["sym_force_uniform"].hold(case, got, want, scale,
                                                      q)
                    same(f"sym_force_uniform run to run {case}", got,
                         hn.sym_force(pos, gm, bounds, q, masked,
                                      uniform=True))
                    if hn.sym_design(n, dim, q) == "triangle":
                        # the triangle and a counted launch's T x T grid
                        same(f"sym_force_uniform grids {case}", got,
                             hn.sym_force(pos, gm, bounds, q, masked,
                                          uniform=True, count=counted))
            half = n // 2
            pa, pb, ga, gb = pos[:half], pos[half:], gm[:half], gm[half:]
            for mode in MODES:
                q = Quantizer.from_string(mode)
                case = f"{mode} D={dim} {half}x{n - half}"
                bounds = force_bounds(q, pos, 0.01, dev)
                rows, cols = hn.pair_sym_force(pa, ga, pb, gb, bounds, q,
                                               uniform=True)
                rw, cw = hn.pair_sym_force_uniform_plain(pa, ga, pb, gb,
                                                         bounds, q)
                tallies["pair_sym_force_uniform"].hold(
                    case + " rows", rows, rw, torch.zeros_like(rw), q, "tile")
                tallies["pair_sym_force_uniform"].hold(
                    case + " cols", cols, cw, torch.zeros_like(cw), q, "tile")
                r2, c2 = hn.pair_sym_force(pa, ga, pb, gb, bounds, q,
                                           uniform=True)
                same(f"pair_sym_force_uniform run to run {case}",
                     torch.cat([rows, cols]), torch.cat([r2, c2]))

    # Off the tile the flag changes no bit (the general kernel runs).
    for dim in (2, 3):
        pos, m = make_inputs(RAGGED_N + 4096, dim, True, seed=dim, dev=dev)
        gm = (cfg.G * m).contiguous()
        p1, g1 = pos[:RAGGED_N], gm[:RAGGED_N]
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            bounds = force_bounds(q, pos, 0.01, dev)
            before = dict(hn.LAUNCHES)
            same(f"sym_force N={RAGGED_N} D={dim} {mode} flag",
                 hn.sym_force(p1, g1, bounds, q, False, uniform=True),
                 hn.sym_force(p1, g1, bounds, q, False))
            same(f"pair_sym_force {RAGGED_N}x4096 D={dim} {mode} flag",
                 torch.cat(hn.pair_sym_force(p1, g1, pos[RAGGED_N:],
                                             gm[RAGGED_N:], bounds, q,
                                             uniform=True)),
                 torch.cat(hn.pair_sym_force(p1, g1, pos[RAGGED_N:],
                                             gm[RAGGED_N:], bounds, q)))
            check(hn.LAUNCHES["sym_force"] - before["sym_force"] == 2
                  and hn.LAUNCHES["pair_sym_force"]
                  - before["pair_sym_force"] == 2,
                  f"N={RAGGED_N}: the flag did not take the general kernels")

    # The fused max and the skip flag (int modes: the cached-bounds scan).
    one = torch.ones((), dtype=torch.int32, device=dev)
    for dim in (2, 3):
        for n in EQUAL_NS + (RAGGED_N,):
            pos, m = make_inputs(n, dim, True, seed=3 * n + dim, dev=dev)
            gm = (cfg.G * m).contiguous()
            want_max = hn.max_d2(pos)
            same(f"max_d2 N={n} D={dim} vs plain", want_max,
                 hn.max_d2_plain(pos))
            for mode in ("int4", "int8"):
                q = Quantizer.from_string(mode)
                bounds = force_bounds(q, pos, 0.01, dev)
                for uniform in (False, True):
                    key = ("sym_force_uniform_max" if uniform
                           and n % hn.TILE == 0 else "sym_force_max")
                    case = f"{mode} D={dim} N={n} uniform={uniform}"
                    mx = torch.empty((), device=dev)
                    got = hn.sym_force(pos, gm, bounds, q, False,
                                       uniform=uniform, max_out=mx)
                    same(f"fused max {case}", mx, want_max)
                    # the unflagged launch of the same design (the
                    # one-pass body past 256 tiles, else the T x T grid's
                    # tile, bitwise the triangle's)
                    unflagged = hn.sym_force(pos, gm, bounds, q, False,
                                             uniform=uniform)
                    same(f"forces with the fused max {case}", got,
                         unflagged)
                    plain = (hn.sym_force_uniform_plain if uniform
                             and n % hn.TILE == 0 else hn.sym_force_plain)
                    tallies[key].hold(case, got, plain(pos, gm, bounds, q,
                                                       False),
                                      torch.zeros_like(got), q)
                    mx2 = torch.empty((), device=dev)
                    same(f"fused max run to run {case}",
                         hn.sym_force(pos, gm, bounds, q, False,
                                      uniform=uniform, max_out=mx2), got)
                    same(f"fused max run to run (max) {case}", mx2, mx)
                    count = torch.zeros((), dtype=torch.int32, device=dev)
                    skipped = hn.sym_force(pos, gm, bounds, q, False,
                                           uniform=uniform, max_out=mx,
                                           skip=one, count=count)
                    check(count.item() == 0 and not skipped.any().item()
                          and mx.item() == 0.0,
                          f"skip=1 did work: {case}")
                    ran = hn.sym_force(pos, gm, bounds, q, False,
                                       uniform=uniform, skip=one * 0,
                                       count=count)
                    check(count.item() == 1, f"skip=0 not counted: {case}")
                    # the walk: the two-pass tile's bits (a counted launch
                    # without skip takes its T x T grid)
                    same(f"skip=0 forces {case}", ran,
                         hn.sym_force(pos, gm, bounds, q, False,
                                      uniform=uniform, count=counted))
            acc, mxs = hn.sym_accelerations(
                pos, m, Quantizer.from_string("int4"), cfg,
                log_lo=bounds[0], log_hi=bounds[1], uniform_gm=True,
                emit_max=True)
            same(f"sym_accelerations emit_max N={n} D={dim}", mxs,
                 want_max + cfg.softening_sq)

    # The lab variants (D=2, float32 and int4, equal masses).
    for n in EQUAL_NS:
        pos, m = make_inputs(n, 2, True, seed=n + 5, dev=dev)
        gm = (cfg.G * m).contiguous()
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            bounds = force_bounds(q, pos, 0.01, dev)
            for v in kernel_lab.VARIANTS:
                case = f"{mode} D=2 N={n}"
                got = kernel_lab.sym_force_lab(pos, gm, bounds, q, False, v)
                want = kernel_lab.sym_force_lab_plain(pos, gm, bounds, q,
                                                      False, v)
                tallies[f"sym_force_lab_{v}"].hold(case, got, want,
                                                   torch.zeros_like(want), q)
                same(f"lab {v} run to run {case}", got,
                     kernel_lab.sym_force_lab(pos, gm, bounds, q, False, v))
    # The round-4 lab variants (D=2, equal masses, N a multiple of 192 and
    # 128), softening 0.1 and zero (self-masked).
    for n in R4_NS:
        pos, m = make_inputs(n, 2, True, seed=n + 7, dev=dev)
        gm = (cfg.G * m).contiguous()
        for label, soft, masked in (("0.1", 0.01, False), ("0", 0.0, True)):
            for mode in ("float32", "int4"):
                q = Quantizer.from_string(mode)
                bounds = force_bounds(q, pos, soft, dev)
                case = f"{mode} D=2 N={n} soft={label}"
                for v, spec in kernel_lab.R4_VARIANTS.items():
                    if spec.base2 and not q.is_int:
                        continue
                    got = kernel_lab.sym_force_lab(pos, gm, bounds, q,
                                                   masked, v)
                    want = kernel_lab.sym_force_lab_plain(pos, gm, bounds, q,
                                                          masked, v)
                    scale = (lazy_scale(pos, gm, bounds, q, masked, got,
                                        want) if masked
                             else torch.zeros_like(want))
                    tallies[f"sym_force_lab_{v}"].hold(case, got, want,
                                                       scale, q)
                    same(f"lab {v} run to run {case}", got,
                         kernel_lab.sym_force_lab(pos, gm, bounds, q, masked,
                                                  v))
    one_pass_shapes(dev, tallies, same)
    torch.cuda.synchronize()
    for name, tally in tallies.items():
        tally.report(name, report[name])
    print(f"kernels: the flag off the tile (N={RAGGED_N}), the fused max "
          f"(bitwise max_d2, forces bitwise without it), the skip flag and "
          f"every variant run to run: {len(fails)} failures")
    check(not fails, "not bitwise: " + "; ".join(fails))


ODD_NS = (192, 320, 448)      # 3, 5, 7 tiles: ragged 256-receiver tails
ODD_PAIRS = ((192, 320), (320, 192))
RAGGED_TAILS = (16448, 16576)  # 257 and 259 tiles: past the rule's edge
RAGGED_PAIRS = ((16448, 320), (16576, 16448))


def one_pass_shapes(dev, tallies: dict, same) -> None:
    """The one-pass design of sym_force_uniform and pair_sym_force_uniform
    against their plain versions at odd multiples of 64 (N in ODD_NS and
    the pairs 192 x 320, 320 x 192, the rule's edge lowered to 0 tiles so
    that the design serves them) and at ragged 256-receiver tails under
    the rule (N in RAGGED_TAILS, the pairs RAGGED_PAIRS), every
    mode, D in {2,3}, softening 0.1 (and 0 for sym); bitwise run to
    run."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    cfg = SimConfig()
    saved = hn.ONE_PASS_MIN_TILES
    try:
        for dim in (2, 3):
            pos, m = make_inputs(2 * max(RAGGED_TAILS), dim, True,
                                 seed=dim + 23, dev=dev)
            gm = (cfg.G * m).contiguous()
            for lowered, ns, pairs in ((True, ODD_NS, ODD_PAIRS),
                                       (False, RAGGED_TAILS, RAGGED_PAIRS)):
                hn.ONE_PASS_MIN_TILES = 0 if lowered else saved
                for mode in MODES:
                    q = Quantizer.from_string(mode)
                    for n in ns:
                        p1, g1 = pos[:n], gm[:n]
                        check(hn.sym_design(n, dim, q) == "one_pass",
                              f"N={n}: not routed to the one-pass design")
                        for label, soft, masked in (("0.1", 0.01, False),
                                                    ("0", 0.0, True)):
                            case = (f"one-pass {mode} D={dim} N={n} "
                                    f"soft={label}")
                            bounds = force_bounds(q, p1, soft, dev)
                            got = hn.sym_force(p1, g1, bounds, q, masked,
                                               uniform=True)
                            want = hn.sym_force_uniform_plain(p1, g1, bounds,
                                                              q, masked)
                            scale = lazy_scale(p1, g1, bounds, q, masked,
                                               got, want)
                            tallies["sym_force_uniform"].hold(case, got, want,
                                                              scale, q)
                            same(f"sym_force_uniform run to run {case}", got,
                                 hn.sym_force(p1, g1, bounds, q, masked,
                                              uniform=True))
                    bounds = force_bounds(q, pos, 0.01, dev)
                    for n_a, n_b in pairs:
                        pa, pb = pos[:n_a], pos[n_a:n_a + n_b]
                        ga, gb = gm[:n_a], gm[n_a:n_a + n_b]
                        check(hn.pair_design(n_a, n_b, dim, q)
                              == "one_pass", f"{n_a}x{n_b}: not routed to "
                                             f"the one-pass design")
                        case = f"one-pass {mode} D={dim} {n_a}x{n_b}"
                        rows, cols = hn.pair_sym_force(pa, ga, pb, gb, bounds,
                                                       q, uniform=True)
                        rw, cw = hn.pair_sym_force_uniform_plain(
                            pa, ga, pb, gb, bounds, q)
                        tally = tallies["pair_sym_force_uniform"]
                        tally.hold(case + " rows", rows, rw,
                                   torch.zeros_like(rw), q, "tile")
                        tally.hold(case + " cols", cols, cw,
                                   torch.zeros_like(cw), q, "tile")
                        same(f"pair_sym_force_uniform run to run {case}",
                             torch.cat([rows, cols]),
                             torch.cat(hn.pair_sym_force(pa, ga, pb, gb,
                                                         bounds, q,
                                                         uniform=True)))
            del pos, m, gm
    finally:
        hn.ONE_PASS_MIN_TILES = saved
    print(f"kernels: the one-pass design at odd multiples of 64 {ODD_NS} "
          f"(pairs {ODD_PAIRS}) and ragged 256-receiver tails "
          f"{RAGGED_TAILS} (pairs {RAGGED_PAIRS}), every mode, D in {{2,3}}:"
          f" held in the equal-mass tallies")


MXU_NS = (3072, 12288)   # multiples of the tensor-core kernel's tile
MXU_SOFT = 0.01          # eps^2 of softening 0.1


def one_source_positions(dev) -> torch.Tensor:
    """Two tiles: 64 receivers near the origin and 64 sources 1e4 away but
    one (index 101) among the receivers, so the column product of the tile
    pair is that one source's alone (the others' w is ~1e-12 of its): a
    transposed or misplaced column fragment puts its sum on another row."""
    gen = torch.Generator().manual_seed(3)
    pos = torch.empty((128, 2))
    pos[:64] = torch.randn((64, 2), generator=gen) * 0.3
    pos[64:] = 1e4 + torch.arange(64.0)[:, None] * torch.tensor([1.0, 2.0])
    pos[101] = torch.tensor([0.05, -0.02])
    return pos.to(dev).contiguous()


def kernels_mxu(dev, report: dict) -> None:
    """The round-5 tensor-core kernel at each precision against its plain
    version (N in MXU_NS, D in {2,3}, softening 0.1, and the one-source
    tile pair), held by the float rule with s = the function's summed
    |terms|; bitwise run to run."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.lab import kernel_lab_r5 as k5

    cfg = SimConfig()
    tallies = {p: Tally() for p in k5.PASSES}
    fails = []
    inputs = [(f"D={dim} N={n}", *make_inputs(n, dim, True, seed=n + dim + 9,
                                               dev=dev))
              for n in MXU_NS for dim in (2, 3)]
    inputs.append(("one-source D=2 N=128", one_source_positions(dev),
                   torch.ones(128, device=dev)))
    for case, pos, m in inputs:
        gm = (cfg.G * m[:1]).reshape(())
        scale = k5.mxu_term_scale(pos, gm, MXU_SOFT)
        for p, tally in tallies.items():
            got = k5.sym_force_mxu(pos, gm, MXU_SOFT, p)
            want = k5.sym_force_mxu_plain(pos, gm, MXU_SOFT, p)
            tally.hold(case, got, want, scale)
            if not torch.equal(got, k5.sym_force_mxu(pos, gm, MXU_SOFT, p)):
                fails.append(f"sym_force_mxu_{p} run to run {case}")
    torch.cuda.synchronize()
    print("kernels: sym_force_mxu, s = G sum_j w_ij (|x_j| + |x_i|) per "
          "coordinate (the function's summed |terms|, self-pair included)")
    for p, tally in tallies.items():
        tally.report(f"sym_force_mxu_{p}", report[f"sym_force_mxu_{p}"])
    print(f"kernels: sym_force_mxu run to run: {len(fails)} failures")
    check(not fails, "not bitwise: " + "; ".join(fails))


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
        path = re.search(r"force path: (.*)", block).group(1)
        print(f"main: {mode}: ticks/s {rate.group(3)}, pairwise "
              f"interactions/s {rate.group(4)}, launches {launched}, "
              f"force path: {path}")
    check(set(per_mode) == {"float64", "float32", "int4_sim"},
          f"modes run: {sorted(per_mode)}")
    # One force evaluation at set-up and one a tick; two max_d2 launches an
    # int4 evaluation (the candidates, the full set under its flag).
    for mode in ("float32", "int4_sim"):
        check(per_mode[mode]["sym_force"] == TICKS + 1,
              f"{mode}: sym_force launched {per_mode[mode]['sym_force']} "
              f"times in {TICKS} ticks")
    check(per_mode["int4_sim"]["max_d2"] == 2 * (TICKS + 1),
          f"int4: max_d2 launched {per_mode['int4_sim']['max_d2']} times in "
          f"{TICKS} ticks")
    # N=5000 <= hn.TILED_MIN_N: every snapshot keeps the plain energy.
    check(all(v["pair_pe_rows"] == 0 for v in per_mode.values()),
          f"pair_pe_rows launched at N={STARS}: {per_mode}")
    for mode, h in histories.items():
        check(len(h.total_energy) == TICKS // INTERVAL + 1
              and np.isfinite(h.total_energy).all(),
              f"{mode}: history not finite / wrong length")
    print(f"main: wall {wall:.1f}s for three modes; launches {launches}")
    for k in ("sym_force", "max_d2"):
        report[k]["launches"] = launches[k]
        check(launches[k] > 0, f"{k} was never launched on the main path")


# --------------------------------------------------------------------------
# Phase 5: the reference gate
# --------------------------------------------------------------------------

def phase_gate(dev, mesh=None, label: str = "gate",
               modes=GATE_MODES) -> None:
    """The reference gate, single-device or (``mesh``) on the ring, each
    mode held to its cached torch-reference run and to its row in
    GATE_ROWS."""
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.models.galaxy import load_disk_fixture

    pos, vel, m = load_disk_fixture(STARS, 42, device=dev)
    fails = []
    for mode in modes:
        t0 = time.time()
        sim = DirectSimulation(pos, vel, m, precision=mode, device=dev,
                               mesh=mesh)
        e0 = sim.get_total_energy()
        snaps, _ = sim.run_with_history(TICKS, INTERVAL)
        drifts = (np.asarray(snaps.total) - e0) / abs(e0) * 100.0
        our_pos = sim.positions.cpu().numpy()
        wall = time.time() - t0
        print(f"{label}: {mode}: drift per snapshot (%) ours "
              f"{[round(float(d), 6) for d in drifts]}")
        agree, text = gate_rule(mode, drifts, our_pos)
        row = GATE_ROWS.get(mode)
        same = row is not None and f"{drifts[-1]:+.6f}" == f"{row:+.6f}"
        print(f"{label}: {mode}: {text}; {wall:.1f}s; "
              f"{'bit for bit' if same else 'NOT'} its recorded row ("
              f"{'none' if row is None else f'{row:+.6f}%'})")
        if not (agree and same):
            fails.append(mode)
    check(not fails, f"{label}: reference gate DISAGREE or rows moved for "
                     f"{fails}")


def gate_rule(mode: str, drifts, final_pos) -> tuple:
    """The rule of tools/reference_parity.py:258-269
    (``diagnostics.reference_gate``) against the cached torch-reference
    run of ``mode`` at 5000 x 2000 and its permuted twin where cached:
    (agree, summary)."""
    from nbody_tpu_torch.diagnostics import reference_gate as rg
    run = (STARS, TICKS, INTERVAL, 42, mode)
    twin = (rg.load_reference(*run, perturbed=True)
            if rg.cache_path(*run, perturbed=True).exists() else None)
    row = rg.gate_row(rg.load_reference(*run), drifts, final_pos, twin)
    return row["agree"], rg.row_text(row)


# --------------------------------------------------------------------------
# Phase 6: throughput and kernel times
# --------------------------------------------------------------------------

def perf_main_shapes(dev, report: dict) -> None:
    """The main path's two kernels at its own shapes by device time
    (device_ms, a CUDA-graph replay beside it): sym_force over the
    canonical 5000 (the general kernel, off the tile), float32 and int4;
    max_d2 over the pruned pass's 1024 candidates, over the 5000 under
    skip=1 (a tick on the disk) and over the 5000 running (its fallback),
    bitwise its plain version. sym_force makes the triangular grid's tiles
    and the reduction a call, max_d2 one launch."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    cfg = SimConfig()
    pos, m = make_inputs(STARS, 2, True, seed=7, dev=dev)
    gm = (cfg.G * m).contiguous()

    def launches_a_call(what, launched, kernels, fn, key):
        if launched is None:   # untraced: one launch of fn's wrapper
            before = dict(hn.LAUNCHES)
            fn()
            torch.cuda.synchronize()
            made = {k: n - before[k] for k, n in hn.LAUNCHES.items()
                    if n != before[k]}
            check(made == {key: 1}, f"{what}: not one {key} launch a call: "
                                    f"{made}")
            print(f"perf: {what}: one {key} launch a call by its count (the "
                  f"profiler named no kernel)")
            return
        check(sorted(k.split("<")[0] for k in launched) == sorted(kernels)
              and all(n == 1 for n, _ in launched.values()),
              f"{what}: not one launch each of {kernels} a call: {launched}")

    route = hn.sym_schedule(STARS)
    for mode in ("float32", "int4"):
        q = Quantizer.from_string(mode)
        bounds = force_bounds(q, pos, cfg.softening_sq, dev)

        def call():
            return hn.sym_force(pos, gm, bounds, q, False)

        ms, launched = device_ms(call)
        launches_a_call(f"sym_force N={STARS} {mode}", launched,
                        ["sym_force_tri" if route == "triangle"
                         else "sym_force_tiles", "reduce_partials"], call,
                        "sym_force")
        plain_ms = device_ms(
            lambda: hn.sym_force_plain(pos, gm, bounds, q, False), 10)[0]
        g_ms = graph_ms(call)
        work = (STARS * (STARS - 1) / 2, pair_ops("sym_gm", 2, mode),
                sym_bytes(STARS, 2))
        b_ms = bound(*work)[0]
        print(f"perf: sym_force N={STARS} D=2 {mode}, device time "
              f"(profiler, {DEVICE_REPS} calls): {route} {ms:.5f} ms "
              f"({launched or 'untraced'}); CUDA-graph replay "
              f"{ms_text(g_ms)}; plain {plain_ms:.4f} ms; bound "
              f"{b_ms:.5f} ms")
        entry = report["sym_force"]
        if mode == "float32":
            set_timing(entry, ms, plain_ms, f"N={STARS} D=2 float32, device "
                       f"time", *work)
            entry.update(schedule=route, graph_ms=g_ms)
        else:
            entry.update(int4_ms=ms, int4_plain_ms=plain_ms,
                         int4_bound_ms=b_ms)

    r = torch.linalg.vector_norm(pos - pos.mean(0), dim=1)
    cand = pos.index_select(0, torch.topk(r, 1024).indices).contiguous()
    one = torch.ones((), dtype=torch.int32, device=dev)
    tick = {"ms": 0.0, "plain": 0.0}
    for label, x, skip in (("1024 candidates", cand, None),
                           (f"{STARS} under skip=1", pos, one),
                           (f"{STARS} running", pos, None)):

        def call():
            return hn.max_d2(x, skip=skip)

        check(torch.equal(call(), hn.max_d2_plain(x, skip)),
              f"max_d2 {label}: the kernel and the plain version differ")
        ms, launched = device_ms(call)
        launches_a_call(f"max_d2 {label}", launched, ["max_d2_single"],
                        call, "max_d2")
        plain_ms = device_ms(lambda: hn.max_d2_plain(x, skip), 10)[0]
        g_ms = graph_ms(call)
        n = x.shape[0]
        # A skipped launch reads the flag and writes the 0.
        work = ((0, 0, 8) if skip is not None
                else (n * (n - 1) / 2, pair_ops("max", 2, ""), 4 * (2 * n + 1)))
        print(f"perf: max_d2 {label} D=2, device time (profiler, "
              f"{DEVICE_REPS} calls): {ms:.5f} ms ({launched or 'untraced'});"
              f" CUDA-graph replay {ms_text(g_ms)}; plain {plain_ms:.4f} ms; "
              f"bound {bound(*work)[0]:.6f} ms")
        if "running" not in label:
            tick["ms"] += ms
            tick["plain"] += plain_ms
    n = cand.shape[0]
    set_timing(report["max_d2"], tick["ms"], tick["plain"],
               f"a tick of the pruned pass on the disk: {n} candidates + "
               f"{STARS} under skip=1, device time", n * (n - 1) / 2,
               pair_ops("max", 2, ""), 4 * (2 * n + 1) + 8)
    report["max_d2"].update(schedule="single")
    print(f"perf: max_d2 a tick of the pruned pass ({n} candidates + {STARS} "
          f"skipped): {tick['ms']:.5f} ms")


def time_one_pass(report: dict, key: str, shape: str, args: tuple,
                  mode: str, dim: int) -> tuple:
    """A sym kernel in its one-pass design (the equal-mass variants, the
    general sym_force and pair_sym_force) at one timed shape, ``args`` its
    wrapper's positional arguments (sym_force: pos, gm, bounds, q,
    self_masked; pair_sym_force: pos_a, gm_a, pos_b, gm_b, bounds, q):
    timed (CUDA events, 3 calls), held to the plain version (the float
    rule with the summed-|terms| scale where |a| alone does not hold; the
    int modes the flip rule after quantize_force, a pair tile the float
    rule alone), bitwise run to run; the bound by the function's own
    operations (pair_ops: "sym_t" equal masses, "sym_gm" unequal), its
    scratch bytes beside the two-pass reckoning that the chunk rule uses.
    Appends the row to report[key]["designs"]; returns (one-pass ms,
    plain ms, the bound's (pairs, ops a pair, bytes))."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    pair = key.startswith("pair")
    uniform = key.endswith("_uniform")
    fn = hn.pair_sym_force if pair else hn.sym_force
    q = args[5] if pair else args[3]

    def call():
        return fn(*args, uniform=uniform)

    if pair:
        pa, ga, pb, gb, bounds = args[:5]
        n_a, n_b = pa.shape[0], pb.shape[0]
        work = (n_a * n_b, pair_ops(OWN_OPS[key], dim, mode),
                sym_bytes(n_a, dim) + sym_bytes(n_b, dim))
        design = hn.pair_design(n_a, n_b, dim, q)
        scratch = (hn.pair_sym_force_scratch_bytes(n_a, n_b, dim),
                   hn.pair_one_pass_scratch(n_a, n_b, dim))
    else:
        n = args[0].shape[0]
        work = (n * (n - 1) / 2, pair_ops(OWN_OPS[key], dim, mode),
                sym_bytes(n, dim))
        design = hn.sym_design(n, dim, q)
        scratch = (hn.sym_force_scratch_bytes(n, dim),
                   hn.sym_one_pass_scratch(n, dim))
    scratch = (scratch[0], sum(4 * math.prod(s) for s in scratch[1]))
    check(design == "one_pass", f"{key} {shape}: the rule routes {design}")
    t0 = time.time()
    want = {"pair_sym_force": hn.pair_sym_force_plain,
            "pair_sym_force_uniform": hn.pair_sym_force_uniform_plain,
            "sym_force": hn.sym_force_plain,
            "sym_force_uniform": hn.sym_force_uniform_plain}[key](*args)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    tally = Tally()
    first, again = call(), call()
    if pair:
        for part, g, w, xi, xj, gmj in (
                ("rows", first[0], want[0], pa, pb, gb),
                ("cols", first[1], want[1], pb, pa, ga)):
            tally.hold(f"one-pass {part}", g, w,
                       lazy_pair_scale(xi, xj, gmj, bounds, q, g, w), q,
                       "tile")
    else:
        tally.hold("one-pass", first, want,
                   lazy_scale(*args[:4], False, first, want), q)
    check(all(bitwise(x, y) for x, y in
              zip(first if pair else (first,), again if pair else (again,))),
          f"{key} {shape}: the one-pass design not bitwise run to run")
    check(not tally.failures, f"{key} {shape} vs plain:\n  "
          + "\n  ".join(tally.failures))
    ms = cuda_ms(call, 3)
    b_ms = bound(*work)[0]
    print(f"perf: {key} {shape} {mode}: one-pass {ms:.4f} ms; bound "
          f"{b_ms:.4f} ms ({work[1]} ops a pair, pair_ops {OWN_OPS[key]}; "
          f"{b_ms / ms:.1%} of it); plain {plain_ms:.1f} ms (wall); vs "
          f"plain worst err {tally.worst_err[0]:.3e}, err/bound "
          f"{tally.worst_ratio[0]:.4f}, "
          f"quantize_force flips {tally.flips}; scratch two-pass "
          f"{scratch[0]} B, one-pass {scratch[1]} B")
    report[key].setdefault("designs", []).append(
        {"shape": shape, "mode": mode,
         "one_pass_ms": ms, "bound_ms": b_ms, "plain_wall_ms": plain_ms,
         "err_over_bound": tally.worst_ratio[0],
         "scratch_bytes": {"two_pass": scratch[0], "one_pass": scratch[1]}})
    return ms, plain_ms, work


def time_rows(dev, report: dict) -> None:
    """row_force at N=131072 (D=2 disk, unequal masses, softening 0.1),
    float32 and int4, unmasked and self-masked (the run-time softening's
    path): the register-tiled design timed (CUDA events, 3 calls), held to
    the plain version, bitwise run to run; the bound by the function's own
    operations (pair_ops("rows")). Float32 unmasked goes into the kernels
    line; every row into report["row_force"]["designs"]."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    cfg = SimConfig()
    pos, m = make_inputs(BIG_N, 2, False, seed=7, dev=dev)
    gm = (cfg.G * m).contiguous()
    entry = report["row_force"]
    for mode in ("float32", "int4"):
        q = Quantizer.from_string(mode)
        bounds = force_bounds(q, pos, cfg.softening_sq, dev)
        for masked in (False, True):
            def call():
                return hn.row_force(pos, gm, bounds, q, masked)

            t0 = time.time()
            want = hn.row_force_plain(pos, gm, bounds, q, masked)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            tally = Tally()
            first = call()
            tally.hold("tiled", first, want,
                       lazy_scale(pos, gm, bounds, q, masked, first, want), q)
            check(bitwise(first, call()), f"row_force N={BIG_N} {mode}: "
                                         f"the tiled design not bitwise run "
                                         f"to run")
            check(not tally.failures, f"row_force N={BIG_N} {mode} "
                  f"masked={masked} vs plain:\n  " + "\n  ".join(
                      tally.failures))
            ms = cuda_ms(call, 3)
            work = (BIG_N * (BIG_N - 1), pair_ops("rows", 2, mode),
                    sym_bytes(BIG_N, 2))
            b_ms = bound(*work)[0]
            print(f"perf: row_force N={BIG_N} D=2 {mode} self_masked="
                  f"{masked}: tiled {ms:.4f} ms; bound {b_ms:.4f} ms "
                  f"({work[1]} ops a pair; {b_ms / ms:.1%} of it); plain "
                  f"{plain_ms:.1f} ms (wall); "
                  f"vs plain worst err {tally.worst_err[0]:.3e}, err/bound "
                  f"{tally.worst_ratio[0]:.4f}, quantize_force flips "
                  f"{tally.flips}; segments {hn.row_segments(BIG_N, BIG_N)},"
                  f" scratch {hn.row_scratch_bytes(BIG_N, BIG_N, 2)} B")
            entry.setdefault("designs", []).append(
                {"shape": f"N={BIG_N} D=2", "mode": mode,
                 "self_masked": masked, "tiled_ms": ms, "bound_ms": b_ms,
                 "plain_wall_ms": plain_ms,
                 "err_over_bound": tally.worst_ratio[0]})
            if mode == "float32" and not masked:
                set_timing(entry, ms, plain_ms, f"N={BIG_N} D=2 float32 "
                           f"(plain: wall)", *work)
                entry.update(design="tiled",
                             max_abs_err=max(entry["max_abs_err"] or 0.0,
                                             tally.worst_err[0]))
    del pos, m, gm


PERF_TICKS, PERF_INTERVAL = 20, 10   # the single-device run at 131072


def big_energy(dev, report: dict) -> None:
    """The single-device main path at N=131072 (D=2 disk, equal masses):
    20 ticks with a snapshot every 10, float32 and int4, the snapshots'
    potential energy on pair_pe_rows (metrics.energy_route): ticks/s,
    launches exact (21 sym_force_uniform, 2 pair_pe_rows), and the final
    state's energy on pair_pe_rows within 1e-5 relative of the plain
    O(N^2) f64 sum of f32 terms. The float64 baseline's sum (compensated)
    launches nothing at this N."""
    from nbody_tpu_torch.cli import force_path
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.diagnostics import metrics
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.utils.profiler import fence

    cfg = SimConfig()
    p0, v0, m0 = create_disk_galaxy(torch.Generator().manual_seed(0),
                                    num_stars=BIG_N, device=dev)
    passes = PERF_TICKS // PERF_INTERVAL
    for mode in ("float32", "int4"):
        reset_counters(hn)
        sim = DirectSimulation(p0, v0, m0, precision=mode, device=dev)
        fence(sim.state.positions)
        t0 = time.time()
        snaps, _ = sim.run_with_history(PERF_TICKS, PERF_INTERVAL)
        fence(sim.state.positions)
        wall = time.time() - t0
        launched = {k: v for k, v in hn.LAUNCHES.items() if v}
        check(np.isfinite(np.asarray(snaps.total)).all(),
              f"N={BIG_N} {mode}: non-finite energy")
        print(f"perf: main path N={BIG_N} {mode}: {PERF_TICKS} ticks "
              f"(snapshots every {PERF_INTERVAL}) in {wall:.3f}s = "
              f"{PERF_TICKS / wall:.3f} ticks/s, "
              f"{BIG_N ** 2 * PERF_TICKS / wall:.4e} pairwise "
              f"interactions/s; launches {launched}; force path: "
              f"{force_path(launched)}")
        check(launched.get("sym_force_uniform") == PERF_TICKS + 1
              and not launched.get("sym_force"),
              f"N={BIG_N} {mode}: not the equal-mass path: {launched}")
        check(launched.get("pair_pe_rows", 0) == passes,
              f"N={BIG_N} {mode}: pair_pe_rows launched "
              f"{launched.get('pair_pe_rows', 0)} times")
        for k in ("sym_force_uniform", "pair_pe_rows"):
            report[k]["launches"] += hn.LAUNCHES[k]
        pos = sim.state.positions.to(torch.float32).contiguous()
        m = m0.to(torch.float32).contiguous()
        ids = torch.arange(BIG_N, device=dev)
        kernel = float(metrics.pe_rows_energy(pos, m, cfg, cfg.softening_sq))
        plain = float(-0.5 * cfg.G * metrics.pair_potential_sum(
            pos, m, ids, pos, m, ids, cfg.softening_sq))
        rel = abs(kernel / plain - 1)
        print(f"perf: N={BIG_N} {mode} final potential energy on "
              f"pair_pe_rows {kernel!r}, plain sum {plain!r}: {rel:.3e} "
              f"relative")
        check(rel <= 1e-5, f"N={BIG_N} {mode}: the energy on pair_pe_rows "
                           f"differs from the plain sum by {rel:.3e}")
        report["pair_pe_rows"].setdefault("energy", {})[mode] = {
            "ticks_per_s": PERF_TICKS / wall, "energy_rel": rel}
        del sim, pos
    reset_counters(hn)
    e64 = metrics.total_energy(p0, v0, m0, SimConfig(), compensated=True)
    check(bool(torch.isfinite(e64)) and hn.LAUNCHES["pair_pe_rows"] == 0,
          f"N={BIG_N}: the compensated (float64 baseline) energy launched "
          f"pair_pe_rows")
    print(f"perf: N={BIG_N} compensated energy (the float64 baseline's): "
          f"plain sum, no pair_pe_rows launch")


def phase_perf(dev, report: dict) -> None:
    """Phase perf."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy
    from nbody_tpu_torch.ops.precision import Quantizer, dist_sq_log_bounds

    cfg = SimConfig()
    perf_main_shapes(dev, report)
    # (kernel, N, mode) whose times go into the kernels line: 131072 and
    # the cached-bounds scan's shapes (its 5000 by device time).
    timed = {("sym_force_uniform", BIG_N, "float32"),
             ("sym_force_max", STARS, "int4"),
             ("sym_force_uniform_max", BIG_N, "int4")}
    for n in (STARS, BIG_N):
        pos, m = make_inputs(n, 2, True, seed=7, dev=dev)
        gm = (cfg.G * m).contiguous()
        max_d2 = hn.max_d2(pos) + cfg.softening_sq
        mx = torch.empty((), device=dev)
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            lo, hi = dist_sq_log_bounds(q, max_d2, cfg.softening_sq)
            if not q.is_int:
                lo = hi = max_d2 * 0
            bounds = torch.stack([lo, hi, max_d2 * 0 + cfg.softening_sq])
            # Each variant beside its general twin, in one call; the fused
            # max's plain version is the plain force plus max_d2_plain. At
            # 5000 only the fused max (the unflagged kernel is
            # perf_main_shapes's), by device time.
            for uniform, fused in ((False, False), (True, False),
                                   (False, True), (True, True)):
                if (fused and not q.is_int) or (n == STARS and not fused):
                    continue
                key = hn._variant("sym_force", uniform, fused)
                if not fused:   # N=131072
                    ms, plain_ms, work = time_one_pass(
                        report, key, f"N={n} D=2", (pos, gm, bounds, q,
                                                    False), mode, 2)
                    if (key, n, mode) in timed:
                        set_timing(report[key], ms, plain_ms,
                                   f"N={n} D=2 {mode}", *work)
                        report[key].update(design="one_pass")
                    continue
                plain_fn = hn.sym_force_uniform_plain if uniform \
                    else hn.sym_force_plain

                def plain():
                    plain_fn(pos, gm, bounds, q, False)
                    hn.max_d2_plain(pos)

                def kernel():
                    return hn.sym_force(pos, gm, bounds, q, False,
                                        uniform=uniform, max_out=mx)

                work = (n * (n - 1) / 2,
                        pair_ops(OWN_OPS[key], 2, mode),
                        sym_bytes(n, 2, fused))
                b_ms = bound(*work)[0]
                line = ""
                if n == STARS:
                    plain_ms = plain_ms2 = device_ms(plain, 10)[0]
                    ms = device_ms(kernel)[0]
                else:   # the one-pass body's max bitwise max_d2's, its
                    # forces the unflagged's
                    check(bitwise(kernel(), hn.sym_force(
                        pos, gm, bounds, q, False, uniform=uniform))
                          and bitwise(mx, hn.max_d2(pos)),
                          f"{key} N={n}: the fused max or its forces")
                    plain_ms = cuda_ms(plain, 1)
                    ms = cuda_ms(kernel, 3)
                    design = hn.sym_design(n, 2, q, fused_max=True)
                    line = (f"; {design}; share of the bound "
                            f"{b_ms / ms:.1%}")
                    if (key, n, mode) in timed:
                        report[key].update(design=design)
                    report[key].setdefault("designs", []).append(
                        {"shape": f"N={n} D=2", "mode": mode,
                         "one_pass_ms": ms, "bound_ms": b_ms})
                    plain_ms2 = cuda_ms(plain, 1)
                print(f"perf: {key} N={n} D=2 {mode}: kernel {ms:.4f} ms, "
                      f"plain {min(plain_ms, plain_ms2):.4f} ms (plain "
                      f"runs {plain_ms:.4f} / {plain_ms2:.4f}), bound "
                      f"{b_ms:.4f} ms"
                      f"{' (device time)' if n == STARS else ''}{line}")
                if (key, n, mode) in timed:
                    set_timing(report[key], ms, min(plain_ms, plain_ms2),
                               f"N={n} D=2 {mode}", *work)
        if n == BIG_N:
            plain_ms = cuda_ms(lambda: hn.max_d2_plain(pos), 3)
            ms = cuda_ms(lambda: hn.max_d2(pos), 3)
            work = (n * (n - 1) / 2, pair_ops("max", 2, "float32"),
                    4 * (2 * n + 1))
            print(f"perf: max_d2 N={n} D=2 full set: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound(*work)[0]:.4f} ms")
        del pos, m, gm

    big_energy(dev, report)

    # The row sweep at N=131072 (its plain version at the 1M path's shape
    # takes minutes; --phases scale has it), then the N=1M path's chunk
    # shapes: sym_force on one chunk and the pair tile on a chunk pair (D=2
    # chunk 209728 and D=3 174784), the general sym_force, the general
    # pair tile and the equal-mass variants in the one-pass design
    # (time_one_pass: each held to its plain version).
    time_rows(dev, report)
    for dim in (2, 3):
        chunk = hn.sym_chunk_size(LARGE_N, dim)
        pos, m = make_inputs(2 * chunk, dim, True, seed=8, dev=dev)
        gm = (cfg.G * m).contiguous()
        pa, pb, ga, gb = pos[:chunk], pos[chunk:], gm[:chunk], gm[chunk:]
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            bounds = force_bounds(q, pos, cfg.softening_sq, dev)
            with_plain = dim == 2 and mode == "float32"
            # The general kernels with unequal masses (the chunk pair's
            # own G m), then the equal-mass variants.
            gu = (cfg.G * (1.0 + torch.rand(
                2 * chunk, generator=torch.Generator().manual_seed(dim)))
                  ).to(dev).contiguous()
            for key, shape, args in (
                    ("sym_force", f"N={chunk} D={dim}",
                     (pa, gu[:chunk], bounds, q, False)),
                    ("pair_sym_force", f"{chunk}x{chunk} D={dim}",
                     (pa, gu[:chunk], pb, gu[chunk:], bounds, q)),
                    ("sym_force_uniform", f"N={chunk} D={dim}",
                     (pa, ga, bounds, q, False)),
                    ("pair_sym_force_uniform", f"{chunk}x{chunk} D={dim}",
                     (pa, ga, pb, gb, bounds, q))):
                ms, plain_ms, work = time_one_pass(report, key, shape, args,
                                                   mode, dim)
                if key.startswith("pair") and with_plain:
                    set_timing(report[key], ms, plain_ms,
                               f"{shape} float32 (plain: wall)", *work)
                    report[key].update(design="one_pass")
            del gu
        del pos, m, gm, pa, pb, ga, gb

    # dt and softening as run-time device scalars against the same run
    # with static parameters: the same launches on the same values, so
    # the drifts must agree to rounding.
    p0, v0, m0 = create_disk_galaxy(torch.Generator().manual_seed(0),
                                    num_stars=STARS, device=dev)
    for mode in ("float32", "int4"):
        drifts = []
        for dynamic in (False, True):
            sim = DirectSimulation(p0, v0, m0, precision=mode, device=dev,
                                   dynamic_params=dynamic)
            e0 = sim.get_total_energy()
            snaps, _ = sim.run_with_history(DYNAMIC_TICKS, INTERVAL)
            drifts.append((np.asarray(snaps.total) - e0) / abs(e0))
        gap = float(np.abs(drifts[1] - drifts[0]).max())
        print(f"perf: dynamic_params {mode} N={STARS} {DYNAMIC_TICKS} ticks:"
              f" drift static {drifts[0][-1]:+.9e}, run-time "
              f"{drifts[1][-1]:+.9e}, max gap {gap:.3e} "
              f"({'bitwise equal' if gap == 0 else 'not bitwise equal'})")
        check(np.isfinite(drifts[1]).all() and gap <= 1e-7,
              f"dynamic_params {mode}: drift gap {gap} beyond rounding")


# --------------------------------------------------------------------------
# Phase 7: N = 1,048,576 through the "auto" routing
# --------------------------------------------------------------------------

def large_ics(dim: int, dev):
    """bench.py's large-N arms: a D=2 disk or a D=3 Plummer sphere of
    LARGE_N stars from LARGE_SEED (torch's generator, not JAX's)."""
    from nbody_tpu_torch.models import galaxy
    gen = torch.Generator().manual_seed(LARGE_SEED)
    make = (galaxy.create_disk_galaxy if dim == 2
            else galaxy.create_plummer_sphere)
    return make(gen, num_stars=LARGE_N, device=dev)


def reset_counters(hn) -> None:
    """Every launch count, the labs' and the PM deposit's too, and the
    device counters to 0."""
    from nbody_tpu_torch.lab import kernel_lab, kernel_lab_r5
    from nbody_tpu_torch.models import direct
    from nbody_tpu_torch.ops import pm
    for counts in (hn.LAUNCHES, kernel_lab.LAUNCHES, kernel_lab_r5.LAUNCHES,
                   pm.LAUNCHES):
        for k in counts:
            counts[k] = 0
    for registry in (hn.BOUNDS_FALLBACKS, hn.REDO_LAUNCHES,
                     direct.CACHED_BOUNDS_STATS):
        registry.clear()


def hold_large(name, got, want, pos, gm, bounds, q, rows=None,
               label: str = "large"):
    """Two summation orders of the same ~1M terms per row: the elementwise
    rule with the summed-|terms| scale where |a| alone does not hold, and
    for the int modes the quantize_force flip rule. Returns a summary."""
    scale = lazy_scale(pos, gm, bounds, q, False, got, want, rows)
    ok, err, ratio, nonfinite = float_rule(got, want, scale)
    fok, off, _ = quantized_flips(got, want, q)
    allowed = flips_allowed(want)
    scaled = (scale != 0).any(1)
    scaled_ratio = (float_rule(got[scaled], want[scaled], scale[scaled])[2]
                    if scaled.any() else 0.0)
    print(f"{label}:   {name}: max err {err:.4e}, err/bound {ratio:.4f}; rows "
          f"beyond the |a| rule {int(scaled.sum())}, held to the summed "
          f"|terms|: worst err/bound {scaled_ratio:.4f}; non-finite "
          f"{nonfinite}; quantize_force flips {off} (allowed {allowed})")
    check(ok and fok, f"{name}: kernels disagree at N={pos.shape[0]}")
    return err


def phase_large(dev, report: dict) -> None:
    """Phase large."""
    from nbody_tpu_torch.cli import force_path
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.direct import _resolve_impl, run_steps
    from nbody_tpu_torch.models.state import make_state
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer
    from nbody_tpu_torch.utils.profiler import fence

    cfg = SimConfig()
    pos, _ = make_inputs(BIG_N, 2, True, seed=7, dev=dev)
    time_max_d2(hn, f"N={BIG_N} D=2 disk", pos, report, 5)
    del pos
    gen = torch.Generator().manual_seed(LARGE_SEED)
    rows = torch.randperm(LARGE_N, generator=gen)[:SAMPLED_ROWS].to(dev)
    for dim in (2, 3):
        pos0, vel0, m0 = large_ics(dim, dev)
        chunk = hn.sym_chunk_size(LARGE_N, dim)
        n_chunks = -(-LARGE_N // chunk)
        impl = _resolve_impl("auto", LARGE_N, dim)
        print(f"large: D={dim}: auto -> {impl}; sym_force alone would need "
              f"{hn.sym_force_scratch_bytes(LARGE_N, dim) / 1e9:.1f} GB of "
              f"scratch (budget {hn.SCRATCH_BUDGET / 1e9:.0f} GB); "
              f"{n_chunks} chunks of {chunk}")
        check(impl == "kernel_sym_chunked", f"D={dim}: auto picked {impl}")
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            # The general kernels for LARGE_STEPS steps (phase bench runs
            # the equal-mass 1M arms, bench.py's). Every chunk is a
            # multiple of TILE (209728 / 209664 at D=2, 174784 / 174656
            # at D=3), so the one-pass rule takes every launch.
            state = make_state(pos0, vel0, m0, dev)
            torch.cuda.reset_peak_memory_stats(dev)
            fence(state.positions)
            reset_counters(hn)
            t0 = time.time()
            state = run_steps(state, q, cfg, "auto", q.is_int, LARGE_STEPS)
            fence(state.positions)
            wall = time.time() - t0
            step_ms = wall / LARGE_STEPS * 1e3
            launched = dict(hn.LAUNCHES)
            fallbacks = hn.bounds_fallbacks(dev)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            print(f"large: D={dim} {mode} general: {LARGE_STEPS} steps in "
                  f"{wall:.3f}s = {step_ms:.1f} ms/step, "
                  f"{LARGE_N ** 2 * LARGE_STEPS / wall:.4e} pairs/s; "
                  f"launches {launched}; peak {peak:.2f} GB")
            want = {**dict.fromkeys(hn.LAUNCHES, 0),
                    "sym_force": LARGE_STEPS * n_chunks,
                    "pair_sym_force":
                        LARGE_STEPS * n_chunks * (n_chunks - 1) // 2,
                    "max_d2": 2 * LARGE_STEPS if q.is_int else 0}
            check(launched == want, f"D={dim} {mode}: launches {launched}, "
                                    f"expected {want}")
            print(f"large: D={dim} {mode}: force path "
                  f"{force_path(launched)}")
            for k in ("sym_force", "pair_sym_force"):
                report[k]["launches"] += launched[k]
            if q.is_int:
                print(f"large: D={dim} {mode}: the pruned bounds pass took "
                      f"its full-set fallback in {fallbacks} of "
                      f"{LARGE_STEPS} evaluations")
            check(bool(torch.isfinite(state.positions).all()
                       and torch.isfinite(state.velocities).all()),
                  f"D={dim} {mode}: non-finite state")
            report["sym_force"].setdefault("step_ms_1M", []).append(
                {"dim": dim, "mode": mode, "one_pass_ms": step_ms})

            # One evaluation on the general run's final positions: the
            # chunked path, general and equal-mass, and the row kernel over
            # all rows, each against the plain version on sampled receivers.
            pos = state.positions
            gm = (cfg.G * state.masses).contiguous()
            bounds = hn.kernel_bounds(pos, q, cfg)
            fence(bounds)
            chunked = {}
            for uniform in (False, True):
                t0 = time.time()
                chunked[uniform] = hn.sym_accelerations_chunked(
                    pos, state.masses, q, cfg, quantize_forces=False,
                    uniform_gm=uniform)
                fence(chunked[uniform])
                t_chunked = time.time() - t0
                b_sym = bound(LARGE_N * (LARGE_N - 1) / 2,
                              pair_ops("sym_t" if uniform else "sym_gm",
                                       dim, mode), sym_bytes(LARGE_N, dim))[0]
                label = "equal-mass" if uniform else "general"
                print(f"large: D={dim} {mode}: one evaluation, chunked "
                      f"{label}: {t_chunked * 1e3:.1f} ms (bound {b_sym:.1f};"
                      f" wall, with its bounds pass)")
                if dim == 2 and mode == "float32":
                    report[hn._variant("pair_sym_force", uniform)][
                        "chunked_eval_ms_1M_D2"] = t_chunked * 1e3
            # The row sweep over all rows.
            t0 = time.time()
            rowsweep = hn.accelerations_rows(pos, state.masses, q, cfg,
                                             quantize_forces=False)
            fence(rowsweep)
            t_rows = (time.time() - t0) * 1e3
            b_rows = bound(LARGE_N * (LARGE_N - 1),
                           pair_ops("rows", dim, mode),
                           sym_bytes(LARGE_N, dim))[0]
            print(f"large: D={dim} {mode}: one evaluation, row sweep, "
                  f"register-tiled {t_rows:.1f} ms (bound {b_rows:.1f}; "
                  f"wall, with its bounds pass)")
            report["row_force"].setdefault("eval_ms_1M", []).append(
                {"dim": dim, "mode": mode, "tiled_ms": t_rows,
                 "bound_ms": b_rows})
            plain = hn.row_force_plain(pos, gm, bounds, q, False, rows=rows,
                                       block=512)
            for uniform, acc in chunked.items():
                label = "equal-mass" if uniform else "general"
                hold_large(f"chunked {label} vs row_force, all rows", acc,
                           rowsweep, pos, gm, bounds, q)
                hold_large(f"chunked {label} vs plain, {SAMPLED_ROWS} rows",
                           acc[rows], plain, pos, gm, bounds, q, rows)
            hold_large(f"row_force vs plain, {SAMPLED_ROWS} rows",
                       rowsweep[rows], plain, pos, gm, bounds, q, rows)
            del state, pos, gm, chunked, rowsweep, plain
        if dim == 3:
            bounds_pass_checks(hn, cfg, pos0, dev, report)
        del pos0, vel0, m0

    # Zero softening routes the chunked path to the row sweep. The D=3
    # Plummer sphere, since the disk's radius clamp at 0.1 puts exactly
    # coincident stars among 1M torch draws (24-bit angles), and at zero
    # softening a coincident pair is 0 * inf = NaN, in JAX as here.
    pos0, vel0, m0 = large_ics(3, dev)
    n_unique = torch.unique(pos0, dim=0).shape[0]
    check(n_unique == LARGE_N, f"Plummer ICs hold {LARGE_N - n_unique} "
                               f"coincident stars")
    cfg0 = SimConfig(softening=0.0)
    q = Quantizer.from_string("float32")
    state = make_state(pos0, vel0, m0, dev)
    fence(state.positions)
    reset_counters(hn)
    t0 = time.time()
    state = run_steps(state, q, cfg0, "auto", False, 2, uniform_gm=True)
    fence(state.positions)
    wall = time.time() - t0
    launched = dict(hn.LAUNCHES)
    print(f"large: D=3 float32 zero softening: 2 steps in {wall:.3f}s = "
          f"{wall / 2 * 1e3:.1f} ms/step, {LARGE_N ** 2 * 2 / wall:.4e} "
          f"pairs/s; launches {launched}")
    check(launched == {**dict.fromkeys(hn.LAUNCHES, 0), "row_force": 2},
          f"zero softening did not route to row_force: {launched}")
    check(bool(torch.isfinite(state.positions).all()),
          "zero softening: non-finite positions")
    report["row_force"]["launches"] = launched["row_force"]
    report["row_force"]["step_ms_1M_D3_zero_softening"] = wall / 2 * 1e3


def time_max_d2(hn, name: str, pos, report: dict, reps: int) -> None:
    """max_d2 over ``pos`` in the design it routes to, bitwise its plain
    version, timed running (CUDA events, ``reps`` calls) and skipped
    (device time, device_ms); the bound by the pairs."""
    n, dim = pos.shape
    one = torch.ones((), dtype=torch.int32, device=pos.device)
    ms = cuda_ms(lambda: hn.max_d2(pos), reps)
    skip_ms = device_ms(lambda: hn.max_d2(pos, skip=one))[0]
    b_ms = bound(n * (n - 1) / 2, pair_ops("max", dim, ""),
                 4 * (dim * n + 1))[0]
    check(bitwise(hn.max_d2(pos), hn.max_d2_plain(pos)),
          f"max_d2 {name}: the kernel and the plain version differ")
    design = hn.max_d2_design(n)
    print(f"large: time max_d2 {name}: {design} {ms:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_ms / ms:.1%} of it); skipped (device time) "
          f"{skip_ms:.5f} ms; bitwise the plain version")
    report["max_d2"].setdefault("designs", []).append(
        {"shape": name, design + "_ms": ms, "bound_ms": b_ms,
         "skipped_" + design + "_ms": skip_ms})


def bounds_pass_checks(hn, cfg, plummer, dev, report: dict) -> None:
    """The pruned bounds pass at D=3, N=1M bitwise equal to the full
    max_d2, on the Plummer ICs and on a shell that forces the fallback;
    the full max_d2 there timed and held to its plain version
    (time_max_d2)."""
    for name, geom in (("Plummer", plummer),
                       ("shell", shell_positions(LARGE_N, dev))):
        hn.BOUNDS_FALLBACKS.clear()
        pruned = hn.max_pairwise_dist_sq_pruned(geom, cfg)
        took = hn.bounds_fallbacks(dev)
        time_max_d2(hn, f"N={LARGE_N} D=3 {name}", geom, report, 1)
        full = hn.max_dist_sq(geom, cfg)
        print(f"large: bounds pass D=3 {name}: pruned {pruned.item()!r}, "
              f"full max_d2 {full.item()!r}, fallback taken: {bool(took)}")
        check(torch.equal(pruned, full),
              f"{name}: pruned != full max")
        if name == "shell":
            check(took == 1, "the shell did not take the fallback")
            r = torch.linalg.vector_norm(geom - geom.mean(0), dim=1)
            cand = geom[torch.topk(r, 1024).indices]
            check(hn.max_d2(cand) < hn.max_d2(geom),
                  "shell: the candidates alone hold the max")


# --------------------------------------------------------------------------
# Phase bench: the port's bench, ladder and reference-gate entry points
# --------------------------------------------------------------------------

# Root bench.py's line on the card, in its order (the port adds "device").
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "int4_value",
              "int4_vs_baseline", "int4_bounds4_value", "n1m_f32_value",
              "n1m_int4_value", "dim3_f32_value", "dim3_int4_value",
              "n1m_dim3_f32_value", "n1m_dim3_int4_value",
              "pm256_int4_engine_ms_per_step")
LADDER_DIMS = (2, 3)
BENCH_GATE_MODE = "int4"   # the reference-gate CLI's one mode on the card


def force_launches(n: int, dim: int, mode: str, evals: int,
                   bound_passes: int | None = None) -> dict:
    """PERF.md section 2's launches of ``evals`` force evaluations of equal
    masses at n (D=dim) through "auto": one sym_force_uniform an
    evaluation while one launch fits, else C sym_force_uniform + C(C-1)/2
    pair_sym_force_uniform (C chunks); in the int modes two max_d2 a
    pruned bounds pass (the candidates, the full set under its flag), one
    pass an evaluation unless ``bound_passes`` says how many; nothing for
    the float64 baseline."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer
    if mode in ("float64", "f64"):
        return {}
    if hn.sym_force_fits(n, dim):
        want = {"sym_force_uniform": evals}
    else:
        c = -(-n // hn.sym_chunk_size(n, dim))
        want = {"sym_force_uniform": evals * c,
                "pair_sym_force_uniform": evals * c * (c - 1) // 2}
    if Quantizer.from_string(mode).is_int:
        want["max_d2"] = 2 * (evals if bound_passes is None
                              else bound_passes)
    return want


def bench_arm_launches(arm) -> dict:
    """The launches a bench arm's timed calls make: its steps' force
    evaluations (with bounds_every=4 one bounds pass each fourth step); the
    PM arm one pm_deposit a step and two a chunk's probe bundle, each with
    its fill and its long-run pass, and no other kernel."""
    from nbody_tpu_torch.ops import pm
    if arm.name.startswith("pm256"):
        deposits = arm.steps // bench.PM_CHUNK * (bench.PM_CHUNK + 2)
        return dict.fromkeys(pm.LAUNCHES, deposits)
    passes = arm.calls * -(-arm.steps // arm.bounds_every)
    return force_launches(arm.n, arm.dim, arm.mode, arm.calls * arm.steps,
                          passes)


def ladder_launches(arm) -> dict:
    """A ladder mode's launches from its set-up on: one evaluation at
    DirectSimulation's set-up, then the warm-up call and the timed calls'
    steps."""
    return force_launches(arm.n, arm.dim, arm.mode,
                          1 + arm.steps * (1 + arm.calls))


def hold_arms(label: str, arms: list, want_fn, report: dict,
              card: str) -> None:
    """Each arm's launches exactly want_fn's, added to the kernels line;
    each arm's row printed with the card."""
    for arm in arms:
        want = want_fn(arm)
        check(arm.launches == want, f"{label}: {arm.name}: launches "
                                    f"{arm.launches}, expected {want}")
        for k, v in arm.launches.items():
            if k in report:
                report[k]["launches"] += v
        rate = ("" if arm.name.startswith("pm256")
                else f", {arm.pairs_per_sec:.4e} pairs/s")
        print(f"{label}: {arm.name}: N={arm.n} D={arm.dim}, {arm.steps} "
              f"steps a call, best of {arm.calls}: {arm.ms_per_step:.4f} "
              f"ms/step{rate}; launches {arm.launches} (exact); card {card}")


def phase_bench(dev, report: dict) -> None:
    """The port's benchmark entry points on the card: ``bench.main`` at
    full width (its 14 keys finite and > 0, each arm's launches exact,
    the 1M arms and the PM arm included), ``ladder_bench.main`` at its
    defaults for D=2 and D=3 (seven rows each, the launches exact, none
    for float64), and the reference-gate CLI on one mode at 5000 x 2000
    (AGREE; its launches those of the canonical run)."""
    from nbody_tpu_torch import ladder_bench
    from nbody_tpu_torch.diagnostics import reference_gate as rg
    from nbody_tpu_torch.ops import hopper_nbody as hn

    card = card_line()
    arms = []
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    result = bench.main(["--device", str(dev)], arms=arms)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(tuple(result) == BENCH_KEYS + ("device",),
          f"bench: the line's keys {list(result)}")
    bad = [k for k in BENCH_KEYS if k not in ("metric", "unit")
           and not (math.isfinite(result[k]) and result[k] > 0)]
    check(not bad, f"bench: not finite and > 0: {bad}")
    check(result["metric"] == f"pairwise_interactions_per_sec_chip_N"
                              f"{bench.N}_f32"
          and result["device"]["kind"] == torch.cuda.get_device_name(dev),
          f"bench: metric {result['metric']}, device {result['device']}")
    hold_arms("bench", arms, bench_arm_launches, report, card)
    print(f"bench: bench.main in {wall:.1f}s, peak {peak:.2f} GiB "
          f"allocated; its line {json.dumps(result)}")

    for dim in LADDER_DIMS:
        arms = []
        t0 = time.time()
        rep = ladder_bench.main(["--dim", str(dim), "--device", str(dev)],
                                arms=arms)
        wall = time.time() - t0
        modes = ladder_bench.DEFAULT_MODES.split(",")
        rows = rep["rows"]
        check([r["mode"] for r in rows] == modes
              and all(r["dim"] == dim and r["n"] == BIG_N and r["steps"]
                      == ladder_bench.mode_steps(r["mode"], 30, None)
                      and math.isfinite(r["pairs_per_sec"])
                      and r["pairs_per_sec"] > 0 for r in rows),
              f"ladder D={dim}: rows {rows}")
        hold_arms(f"ladder D={dim}", arms, ladder_launches, report, card)
        print(f"ladder D={dim}: ladder_bench.main in {wall:.1f}s (float64: "
              f"the plain native-f64 baseline, no kernel)")

    out = REPO / "output" / "chip_smoke_reference_gate"
    reset_counters(hn)
    t0 = time.time()
    rc = rg.main(["--modes", BENCH_GATE_MODE, "--perturb", "--device",
                  str(dev), "--output", str(out)])
    wall = time.time() - t0
    launched = {k: v for k, v in hn.LAUNCHES.items() if v}
    row = json.loads((out / "reference_parity.json").read_text())[
        BENCH_GATE_MODE]
    same = f"{row['final_drift_ours']:+.6f}" == \
        f"{GATE_ROWS[BENCH_GATE_MODE]:+.6f}"
    print(f"bench: reference_gate.main {BENCH_GATE_MODE} at {STARS} x "
          f"{TICKS} on the card: {rg.row_text(row)}; {wall:.1f}s; launches "
          f"{launched}; {'bit for bit' if same else 'NOT'} phase gate's "
          f"row ({GATE_ROWS[BENCH_GATE_MODE]:+.6f}%)")
    # N=5000 is off the tile: the general sym_force, an evaluation at
    # set-up and one a tick; the energies' plain sum at N <= 16384.
    check(rc == 0 and row["agree"], f"bench: reference_gate.main "
                                    f"{BENCH_GATE_MODE} DISAGREE (rc {rc})")
    check(launched == {"sym_force": TICKS + 1, "max_d2": 2 * (TICKS + 1)},
          f"bench: reference_gate.main launched {launched}")


# --------------------------------------------------------------------------
# Phase 8: the multi-device ring (--mesh) and its tiles #10, #9, #7
# --------------------------------------------------------------------------

ALL_MODES = ("float64",) + MODES
# (receivers, sources); equal counts are one set used as both.
RING_SHAPES = ((5000, 5000), (32768, 32771), (1, 1000), (4099, 1009))
RING_TICKS, RING_INTERVAL = 200, 100
RING_NS = (STARS, BIG_N, BIG_N + 3)   # the ring's energy/forces checks
VIRTUAL_SHARDS = (3, 4)


def ring_sets(n_i, n_j, dim, seed, dev):
    """Receivers, sources and their G*m; equal counts give one set."""
    from nbody_tpu_torch.config import SimConfig
    g = SimConfig().G
    if n_i == n_j:
        pos, m = make_inputs(n_i, dim, False, seed, dev)
        gm = (g * m).contiguous()
        return pos, pos, m, m, gm, gm
    pos, m = make_inputs(n_i + n_j, dim, False, seed, dev)
    gm = (g * m).contiguous()
    return (pos[:n_i], pos[n_i:], m[:n_i], m[n_i:], gm[:n_i], gm[n_i:])


def lazy_pair_scale(xi, xj, gmj, bounds, q, got, want):
    """lazy_scale for pair_force: the summed |terms| of the rows where the
    |a| rule alone does not hold."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    scale = torch.zeros_like(want)
    need = ((got - want).abs() > ATOL + RTOL * want.abs()).any(
        dim=1).nonzero().flatten()
    if need.numel():
        scale[need] = hn.pair_force_term_scale(xi[need], xj, gmj, bounds, q,
                                               block=256)
    return scale


def ring_tiles(dev, report: dict) -> None:
    """The three tiles against their plain versions at the checked shapes:
    one set, disjoint sets, a single receiver and prime sizes; then their
    times at the mesh-of-one path's shape, 131072^2 one set, with the last
    kernel and plain outputs of the timing held against each other."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    cfg = SimConfig()
    force, pe_worst, max_fail, pe_fail = Tally(), (0.0, ""), [], []
    max_cases = pe_cases = 0
    gen = torch.Generator().manual_seed(5)

    def hold_pe(case, got, want, n_i, n_j):
        nonlocal pe_worst, pe_cases
        pe_cases += 1
        fin = torch.isfinite(want)
        err = ((got - want).abs() / want.abs())[fin]
        rtol = pe_bound_rtol(n_i, n_j)
        ratio = err.max().item() / rtol if err.numel() else 0.0
        pe_worst = max(pe_worst, (ratio, case))
        report["pair_pe_rows"]["max_abs_err"] = max(
            report["pair_pe_rows"]["max_abs_err"] or 0.0,
            (got - want)[fin].abs().max().item() if err.numel() else 0.0)
        if ratio > 1.0 or not torch.equal(torch.isfinite(got), fin):
            pe_fail.append(f"{case}: err/bound {ratio:.3f}")

    def hold_max(case, got, want):
        nonlocal max_cases
        max_cases += 1
        if not torch.equal(got, want):
            max_fail.append(f"{case}: {got.item()!r} != {want.item()!r}")

    for dim in (2, 3):
        for n_i, n_j in RING_SHAPES:
            xi, xj, mi, mj, _, gmj = ring_sets(n_i, n_j, dim, n_i + dim, dev)
            shape = f"D={dim} {n_i}x{n_j}{' one set' if n_i == n_j else ''}"
            for mode in ALL_MODES:
                q = Quantizer.from_string(mode)
                bounds = force_bounds(q, torch.cat([xi, xj]),
                                      cfg.softening_sq, dev)
                lo, hi = (bounds[0], bounds[1]) if q.is_int else (None, None)
                want = hn.pair_force_plain(xi, xj, gmj, q, cfg, lo, hi)
                got = hn.pair_force(xi, xj, gmj, q, cfg, lo, hi)
                force.hold(f"{mode} {shape}", got, want,
                           lazy_pair_scale(xi, xj, gmj, bounds, q, got,
                                           want), q, "tile")
            for label, vi, vj in (
                    ("all valid", torch.ones(n_i, dtype=torch.bool),
                     torch.ones(n_j, dtype=torch.bool)),
                    ("some invalid", torch.rand(n_i, generator=gen) < 0.7,
                     torch.rand(n_j, generator=gen) < 0.7),
                    ("receivers invalid", torch.zeros(n_i, dtype=torch.bool),
                     torch.ones(n_j, dtype=torch.bool))):
                vi, vj = vi.to(dev), vj.to(dev)
                hold_max(f"{shape} {label}", hn.pair_max(xi, xj, vi, vj),
                         hn.pair_max_plain(xi, xj, vi, vj))
            if n_i == n_j:
                ones = torch.ones(n_i, dtype=torch.bool, device=dev)
                hold_max(f"{shape} vs max_d2",
                         hn.pair_max(xi, xi, ones, ones), hn.max_d2(xi))
            ids_i = torch.arange(n_i, dtype=torch.int32, device=dev)
            ids_j = ids_i if n_i == n_j else torch.arange(
                n_i - 1, n_i - 1 + n_j, dtype=torch.int32, device=dev)
            for soft in (cfg.softening_sq, 0.0):
                args = (xi, mi, ids_i, xj, mj, ids_j, soft)
                hold_pe(f"{shape} eps^2={soft}", hn.pair_pe_rows(*args),
                        hn.pair_pe_rows_plain(*args), n_i, n_j)

    # Run to run, one case each.
    xi, xj, mi, mj, _, gmj = ring_sets(32768, 32771, 2, 1, dev)
    q = Quantizer.from_string("int4")
    bounds = force_bounds(q, torch.cat([xi, xj]), cfg.softening_sq, dev)
    ones_i = torch.ones(xi.shape[0], dtype=torch.bool, device=dev)
    ones_j = torch.ones(xj.shape[0], dtype=torch.bool, device=dev)
    ids_i = torch.arange(xi.shape[0], dtype=torch.int32, device=dev)
    ids_j = torch.arange(xi.shape[0], xi.shape[0] + xj.shape[0],
                         dtype=torch.int32, device=dev)
    for name, fn in (
            ("pair_force", lambda: hn.pair_force(xi, xj, gmj, q, cfg,
                                                 bounds[0], bounds[1])),
            ("pair_max", lambda: hn.pair_max(xi, xj, ones_i, ones_j)),
            ("pair_pe_rows", lambda: hn.pair_pe_rows(
                xi, mi, ids_i, xj, mj, ids_j, cfg.softening_sq))):
        check(torch.equal(fn(), fn()), f"{name} not deterministic")
    print("ring: pair_force, pair_max and pair_pe_rows run to run bitwise "
          "equal")

    # Times at the mesh-of-one path's shape, N=131072 (D=2 disk, equal
    # masses): plain, kernel, plain in one call. The last kernel and plain
    # outputs are held against each other: these are the tiles the --mesh
    # run launches (pair_force under --schedule rows in float32 and int4,
    # pair_pe_rows every snapshot, pair_max the int4 bounds pass; pair_max
    # does not depend on the mode, so it is held once).
    pos, m = make_inputs(BIG_N, 2, True, seed=7, dev=dev)
    gm = (cfg.G * m).contiguous()
    ones = torch.ones(BIG_N, dtype=torch.bool, device=dev)
    ids = torch.arange(BIG_N, dtype=torch.int32, device=dev)
    shape = f"D=2 {BIG_N}x{BIG_N} one set (the --mesh path)"
    out = {}

    def keep(fn, slot):
        return lambda: out.__setitem__(slot, fn())

    for mode in ("float32", "int4"):
        q = Quantizer.from_string(mode)
        bounds = force_bounds(q, pos, cfg.softening_sq, dev)
        lo, hi = (bounds[0], bounds[1]) if q.is_int else (None, None)
        runs = [("pair_force", lambda: hn.pair_force(pos, pos, gm, q, cfg,
                                                     lo, hi),
                 lambda: hn.pair_force_plain(pos, pos, gm, q, cfg, lo, hi))]
        if mode == "float32":
            runs += [("pair_max", lambda: hn.pair_max(pos, pos, ones, ones),
                      lambda: hn.pair_max_plain(pos, pos, ones, ones)),
                     ("pair_pe_rows", lambda: hn.pair_pe_rows(
                         pos, m, ids, pos, m, ids, cfg.softening_sq),
                      lambda: hn.pair_pe_rows_plain(pos, m, ids, pos, m, ids,
                                                    cfg.softening_sq))]
        for name, kernel, plain in runs:
            plain_ms = cuda_ms(keep(plain, "plain"), 1)
            ms = cuda_ms(keep(kernel, "kernel"),
                         5 if name == "pair_max" else 3)
            line = ""
            if name == "pair_max":
                b_ms = bound(BIG_N ** 2, pair_ops("max", 2, mode),
                             4 * 4 * BIG_N + 2 * BIG_N + 4)[0]
                line = (f"; register-tiled; bound {b_ms:.4f} ms "
                        f"({b_ms / ms:.1%} of it)")
                report[name].update(design="tiled")
            elif name == "pair_force":
                line = "; register-tiled"
                if mode == "float32":
                    report[name].update(design="tiled")
                else:
                    report[name].update(int4_ms=ms)
            else:
                b_ms = bound(BIG_N ** 2, pair_ops("pe", 2, mode),
                             4 * 9 * BIG_N)[0]
                line = (f"; register-tiled; bound {b_ms:.4f} ms "
                        f"({b_ms / ms:.1%} of it; the MUFU floor "
                        f"{pe_mufu_ms(BIG_N ** 2):.4f} ms)")
                report[name].update(design="tiled")
            plain_ms2 = cuda_ms(keep(plain, "plain"), 1, 0)
            print(f"ring: time {name} {BIG_N}x{BIG_N} D=2 {mode}: kernel "
                  f"{ms:.4f} ms, plain {min(plain_ms, plain_ms2):.4f} ms "
                  f"(plain runs {plain_ms:.4f} / {plain_ms2:.4f}){line}")
            if mode == "float32":
                kind, nbytes = {
                    "pair_force": ("rows", 4 * 7 * BIG_N),
                    "pair_max": ("max", 4 * 4 * BIG_N + 2 * BIG_N + 4),
                    "pair_pe_rows": ("pe", 4 * 9 * BIG_N)}[name]
                set_timing(report[name], ms, min(plain_ms, plain_ms2),
                           f"{BIG_N}x{BIG_N} D=2 float32", BIG_N ** 2,
                           pair_ops(kind, 2, mode), nbytes)
            got, want = out["kernel"], out["plain"]
            if name == "pair_force":
                force.hold(f"{mode} {shape}", got, want,
                           lazy_pair_scale(pos, pos, gm, bounds, q, got,
                                           want), q)
            elif name == "pair_max":
                hold_max(f"{shape} vs plain", got, want)
                hold_max(f"{shape} vs max_d2", got, hn.max_d2(pos))
            else:
                hold_pe(f"{shape} eps^2={cfg.softening_sq}", got, want,
                        BIG_N, BIG_N)
            out.clear()
            del got, want
    del pos, m, gm, ones, ids
    pair_max_shard(dev, report)
    pe_shard(dev, report, hold_pe)

    torch.cuda.synchronize()
    force.report("pair_force", report["pair_force"])
    print(f"ring: pair_max bitwise vs plain (and vs max_d2 on one set) in "
          f"{max_cases} cases: {len(max_fail)} failures")
    check(not max_fail, "\n  ".join(max_fail))
    report["pair_max"].update(
        max_abs_err=0.0,
        cases=(report["pair_max"].get("cases") or 0) + max_cases)
    print(f"ring: pair_pe_rows vs plain in {pe_cases} cases, |err| <= "
          f"2 (128 + tiles + 4) 2^-24 |row| (one thread a receiver), 2 "
          f"(128 + seg + "
          f"nseg + 5) 2^-24 |row| (register-tiled): {len(pe_fail)} failures;"
          f" worst err/bound {pe_worst[0]:.4f} ({pe_worst[1]})")
    check(not pe_fail, "pair_pe_rows disagreements:\n  "
          + "\n  ".join(pe_fail))
    report["pair_pe_rows"].update(
        err_over_bound=max(report["pair_pe_rows"].get("err_over_bound")
                           or 0.0, pe_worst[0]),
        cases=(report["pair_pe_rows"].get("cases") or 0) + pe_cases)


def pair_max_shard(dev, report: dict) -> None:
    """pair_max at the shard shape of 131075 over S=4 (32769^2, the
    phantom at the last shard's tail), D=2: timed (CUDA events), bitwise
    the plain version; the bound by the valid pairs."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.parallel import ring

    n_total, shards = BIG_N + 3, 4
    pos, _ = make_inputs(n_total, 2, False, seed=61, dev=dev)
    padded = ring._pad_to_shards(pos, shards, fill=ring._PAD_FAR)
    size = padded.shape[0] // shards
    valid = torch.arange(padded.shape[0], device=dev) < n_total
    a, b = padded[:size], padded[-size:]
    va, vb = valid[:size], valid[-size:]
    check(bitwise(hn.pair_max(a, b, va, vb),
                  hn.pair_max_plain(a, b, va, vb)),
          "pair_max at the S=4 shard shape: not the plain version's bits")
    ms = cuda_ms(lambda: hn.pair_max(a, b, va, vb), 20)
    pairs = int(va.sum()) * int(vb.sum())
    b_ms = bound(pairs, pair_ops("max", 2, ""), 4 * 4 * size + 2 * size + 4)[0]
    print(f"ring: time pair_max {size}x{size} D=2 (shards 0 x {shards - 1} "
          f"of {n_total} over S={shards}): register-tiled {ms:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_ms / ms:.1%} of it); grid "
          f"{hn.pair_max_segments(size, size)}")
    report["pair_max"]["shard"] = {"shape": f"{size}x{size}", "tiled_ms": ms,
                                   "bound_ms": b_ms}


def pe_mufu_ms(pairs: float) -> float:
    """pair_pe_rows' floor by the special-function unit: one rsqrt a pair
    at 16 a clock a SM, 132 SMs at the H100 SXM's 1.98 GHz boost clock."""
    return pairs / (16 * 132 * 1.98e9) * 1e3


def pe_shard(dev, report: dict, hold_pe) -> None:
    """pair_pe_rows at the ring's shard shapes, D=2: shards 0 and 1 of
    131072 over S=3 (43691^2) and of 131075 over S=4 (32769^2), the ids
    the ring gives them (disjoint, contiguous): timed (CUDA events), held
    to the plain version (``hold_pe``); the bound by the pairs."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn

    cfg = SimConfig()
    shapes = {}
    for n_total, shards in ((BIG_N, 3), (BIG_N + 3, 4)):
        size = -(-n_total // shards)
        pos, m = make_inputs(2 * size, 2, False, seed=shards, dev=dev)
        ids = torch.arange(2 * size, dtype=torch.int32, device=dev)
        a, b = (slice(0, size), slice(size, 2 * size))
        args = (pos[a], m[a], ids[a], pos[b], m[b], ids[b], cfg.softening_sq)
        want = hn.pair_pe_rows_plain(*args)
        shape = f"{size}x{size} (shards 0 x 1 of {n_total} over S={shards})"
        hold_pe(f"D=2 {shape}", hn.pair_pe_rows(*args), want, size, size)
        ms = cuda_ms(lambda: hn.pair_pe_rows(*args), 10)
        b_ms = bound(size * size, pair_ops("pe", 2, ""), 4 * 9 * size)[0]
        print(f"ring: time pair_pe_rows D=2 {shape}: register-tiled "
              f"{ms:.4f} ms; bound {b_ms:.4f} ms ({b_ms / ms:.1%} of it); "
              f"grid {hn.pe_segments(size, size)}")
        shapes[f"{size}x{size}"] = {"tiled_ms": ms, "bound_ms": b_ms}
    report["pair_pe_rows"]["shard"] = shapes


def ring_cli(dev, report: dict) -> None:
    """``python -m nbody_tpu_torch --stars 131072 --ticks 200 --compare
    float32,int4 --mesh`` and its ``--schedule rows`` twin through
    cli.main, with the launch counters read around each: a mesh of the one
    card, so per mode 201 force evaluations (the entry force and 200
    ticks) and 2 energy passes, each of one tile; the int4 bounds each
    evaluation, the single device's pruned pass on the card (the
    candidates' max_d2 and the full set's, skipped on the disk)."""
    from nbody_tpu_torch import cli
    from nbody_tpu_torch.ops import hopper_nbody as hn

    evals, passes = RING_TICKS + 1, RING_TICKS // RING_INTERVAL
    totals = {"sym_force_uniform": 0, "pair_force": 0, "max_d2": 0,
              "pair_pe_rows": 0}
    ticks = {}
    for schedule in ("sym", "rows"):
        argv = ["--device", str(dev), "--stars", str(BIG_N), "--ticks",
                str(RING_TICKS), "--snapshot-interval", str(RING_INTERVAL),
                "--mesh", "--schedule", schedule, "--compare",
                "float32,int4", "--output",
                str(REPO / "output" / "chip_smoke_ring")]
        print(f"ring: nbody_tpu_torch.cli.main({argv})")
        reset_counters(hn)
        tee = Tee(sys.stdout)
        old, sys.stdout = sys.stdout, tee
        try:
            histories = cli.main(argv)
        finally:
            sys.stdout = old
        for k in totals:
            totals[k] += hn.LAUNCHES[k]
        text = tee.buf.getvalue()
        check(f"Mesh: 1 device(s), schedule={schedule}" in text,
              f"{schedule}: no mesh line")
        for block in text.split("Running simulation: ")[1:]:
            mode = block.split()[0]
            launched = json.loads(re.search(
                r"kernel launches: (\{.*\})", block).group(1))
            rate = re.search(r"(\d+) ticks in ([\d.]+)s \(([\d.]+) "
                             r"ticks/s", block)
            path = re.search(r"force path: (.*)", block).group(1)
            is_int = mode == "int4_sim"
            want = dict.fromkeys(hn.LAUNCHES, 0)
            # The ring's energy pass a snapshot, and the CLI's first
            # snapshot (single-device, past hn.TILED_MIN_N on #7).
            want["pair_pe_rows"] = passes + 1
            want["max_d2"] = 2 * evals if is_int else 0
            # Equal masses, N % 1 == 0 and 131072 % 64 == 0: the sym
            # schedule's diagonal is the equal-mass variant.
            want["sym_force_uniform" if schedule == "sym"
                 else "pair_force"] = evals
            print(f"ring: --schedule {schedule} {mode}: {rate.group(1)} "
                  f"ticks in {rate.group(2)}s ({rate.group(3)} ticks/s); "
                  f"launches {launched}; force path: {path}")
            if is_int:
                ticks[schedule] = float(rate.group(3))
            check(launched == want, f"{schedule} {mode}: launches "
                                    f"{launched}, expected {want}")
            check(path.startswith(f"ring, {schedule}"),
                  f"{schedule} {mode}: force path {path!r}")
        for mode, h in histories.items():
            check(len(h.total_energy) == passes + 1
                  and np.isfinite(h.total_energy).all(),
                  f"{schedule} {mode}: history not finite / wrong length")
    for k, n in totals.items():
        report[k]["launches"] += n
        check(n > 0, f"{k} was never launched on the mesh path")
    report["max_d2"]["mesh_int4_ticks_per_s"] = ticks


def ring_virtual(dev, report: dict) -> None:
    """Virtual shards on the one card at N in {5000, 131072, 131075
    (phantom rows)}, D=2 disk: for S in {1, 3, 4} the ring's energy
    against metrics.potential_energy (and its wall beside the plain one's)
    and its max d^2 against the single-device max_d2 bitwise; for S in
    {1, 3, 4}, float32 and int4, one evaluation of each schedule against
    single-device sym_force (S=1 rows is pair_force on the whole set, the
    tile of --mesh --schedule rows); every launch count exact."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.diagnostics import metrics
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer
    from nbody_tpu_torch.parallel import ring

    cfg = SimConfig()
    worst = {}
    for n in RING_NS:
        pos, m = make_inputs(n, 2, False, seed=n, dev=dev)
        gm = (cfg.G * m).contiguous()
        torch.cuda.synchronize()
        t0 = time.time()
        pe_plain = float(metrics.potential_energy(pos, m, cfg,
                                                  compensated=True))
        plain_ms = (time.time() - t0) * 1e3
        max_single = hn.max_d2(pos) + cfg.softening_sq
        singles, single_ms = {}, {}
        for mode in ("float32", "int4"):
            torch.cuda.synchronize()
            t0 = time.time()
            singles[mode] = hn.sym_accelerations(
                pos, m, Quantizer.from_string(mode), cfg,
                quantize_forces=False)
            torch.cuda.synchronize()
            single_ms[mode] = (time.time() - t0) * 1e3
        pe_tol = 1e-6 if n <= STARS else 1e-5
        for n_shards in (1,) + VIRTUAL_SHARDS:
            mesh = ring.ParticleMesh.virtual(n_shards, dev)
            reset_counters(hn)
            torch.cuda.synchronize()
            t0 = time.time()
            pe = float(ring.ring_potential_energy(pos, m, cfg, mesh))
            pe_ms = (time.time() - t0) * 1e3
            check(hn.LAUNCHES["pair_pe_rows"] == n_shards ** 2,
                  f"S={n_shards}: {hn.LAUNCHES['pair_pe_rows']} pair_pe_rows "
                  f"launches in one energy pass")
            rel = abs(pe - pe_plain) / abs(pe_plain)
            print(f"ring: S={n_shards} N={n}: energy {pe!r} vs plain "
                  f"{pe_plain!r}, rel err {rel:.3e} (tol {pe_tol}); wall "
                  f"{pe_ms:.1f} ms (plain metrics.potential_energy "
                  f"{plain_ms:.1f} ms)")
            check(rel <= pe_tol, f"S={n_shards} N={n}: ring energy off by "
                                 f"{rel:.3e}")
            worst["energy"] = max(worst.get("energy", 0.0), rel)
            padded, _, _, ids = ring._padded(pos, None, m, mesh)
            reset_counters(hn)
            got_max = ring._ring_max_d2(mesh, ring._shards(padded, mesh),
                                        ring._shards(ids, mesh), n, cfg)
            check(hn.LAUNCHES["pair_max"] == n_shards * (n_shards // 2 + 1),
                  f"S={n_shards}: {hn.LAUNCHES['pair_max']} pair_max "
                  f"launches in one bounds pass")
            check(torch.equal(got_max, max_single),
                  f"S={n_shards} N={n}: ring max {got_max.item()!r} != "
                  f"single-device {max_single.item()!r}")
            reset_counters(hn)
            got_max = ring._ring_bounds_max(mesh, ring._shards(padded, mesh),
                                            ring._shards(ids, mesh), n, cfg)
            check(hn.LAUNCHES["max_d2"] == pruned_launches(n)
                  and hn.LAUNCHES["pair_max"] == 0,
                  f"S={n_shards}: {hn.LAUNCHES['max_d2']} max_d2, "
                  f"{hn.LAUNCHES['pair_max']} pair_max launches in one "
                  f"pruned bounds pass")
            check(torch.equal(got_max, max_single),
                  f"S={n_shards} N={n}: pruned ring max {got_max.item()!r} "
                  f"!= single-device {max_single.item()!r}")
            for mode in ("float32", "int4"):
                q = Quantizer.from_string(mode)
                single = singles[mode]
                bounds = hn.kernel_bounds(pos, q, cfg)
                for schedule in ("sym", "rows"):
                    reset_counters(hn)
                    torch.cuda.synchronize()
                    t0 = time.time()
                    got = ring.ring_accelerations(pos, m, q, cfg, mesh,
                                                  schedule=schedule)
                    torch.cuda.synchronize()
                    if n >= BIG_N:
                        print(f"ring: S={n_shards} N={n} {mode} {schedule}: "
                              f"one evaluation {(time.time() - t0) * 1e3:.1f}"
                              f" ms wall (single-device sym_accelerations "
                              f"{single_ms[mode]:.1f} ms)")
                    launched = {k: v for k, v in hn.LAUNCHES.items() if v}
                    report["pair_sym_force"]["launches"] += hn.LAUNCHES[
                        "pair_sym_force"]
                    s = n_shards
                    want = ({"sym_force": s, "pair_sym_force": s * (s - 1) // 2}
                            if schedule == "sym" else {"pair_force": s * s})
                    if q.is_int:
                        want["max_d2"] = pruned_launches(n)
                    want = {k: v for k, v in want.items() if v}
                    check(launched == want, f"S={s} N={n} {mode} {schedule}: "
                                            f"launches {launched}, expected "
                                            f"{want}")
                    scale = lazy_scale(pos, gm, bounds, q, False, got, single)
                    ok, err, ratio, _ = float_rule(got, single, scale)
                    fok, off, _ = quantized_flips(got, single, q)
                    key = f"{mode} {schedule}"
                    worst[key] = max(worst.get(key, 0.0), ratio)
                    check(ok and fok,
                          f"S={s} N={n} {mode} {schedule}: err/bound "
                          f"{ratio:.3f}, flips {off}")
            print(f"ring: S={n_shards} N={n}: max d^2 bitwise the "
                  f"single-device max_d2; sym and rows, float32 and int4 "
                  f"hold to single-device sym_force; launch counts exact")
        del pos, m, gm, singles
    print(f"ring: virtual shards, worst: energy rel err "
          f"{worst['energy']:.3e}; force err/bound "
          + ", ".join(f"{k} {v:.4f}" for k, v in worst.items()
                      if k != "energy"))


def ring_equal_mass(dev) -> None:
    """The equal-mass tiles on the ring at N=131072 (equal masses, D=2): a
    mesh of one and virtual S=4 (shards of 32768), one evaluation with the
    flag against one without it in the same call (times, launch counts,
    agreement); then the phantom layouts (S=3 at 131072, S=4 at 131075),
    where the flag must change no bit."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer
    from nbody_tpu_torch.parallel import ring

    cfg = SimConfig()
    accel = hn.prevalidated(ring.ring_accelerations)
    pos, m = make_inputs(BIG_N + 3, 2, True, seed=17, dev=dev)
    gm = (cfg.G * m).contiguous()
    p, mm, g = pos[:BIG_N], m[:BIG_N], gm[:BIG_N]
    for s in (1, 4):
        mesh = ring.ParticleMesh.virtual(s, dev)
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            out = {}
            for uniform in (True, False):
                reset_counters(hn)
                out[uniform] = accel(p, mm, q, cfg, mesh, uniform_gm=uniform)
                launched = {k: v for k, v in hn.LAUNCHES.items() if v}
                sym = hn._variant("sym_force", uniform)
                pair = hn._variant("pair_sym_force", uniform)
                want = {sym: s, pair: s * (s - 1) // 2}
                if q.is_int:
                    want["max_d2"] = pruned_launches(BIG_N)
                want = {k: v for k, v in want.items() if v}
                check(launched == want, f"S={s} {mode} uniform={uniform}: "
                                        f"launches {launched}, want {want}")
            ms = {u: cuda_ms(lambda u=u: accel(p, mm, q, cfg, mesh,
                                               uniform_gm=u), 2)
                  for u in (True, False, True)}
            bounds = hn.kernel_bounds(p, q, cfg)
            scale = lazy_scale(p, g, bounds, q, False, out[True], out[False])
            ok, err, ratio, _ = float_rule(out[True], out[False], scale)
            fok, off, _ = quantized_flips(out[True], out[False], q)
            print(f"ring: equal masses S={s} N={BIG_N} {mode}: one "
                  f"evaluation {ms[True]:.3f} ms equal-mass tiles vs "
                  f"{ms[False]:.3f} ms general (device time); err/bound "
                  f"{ratio:.4f}, quantize_force flips {off}")
            check(ok and fok,
                  f"S={s} {mode}: equal-mass ring != general ring")
    for s, n in ((3, BIG_N), (4, BIG_N + 3)):
        mesh = ring.ParticleMesh.virtual(s, dev)
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            reset_counters(hn)
            got = accel(pos[:n], m[:n], q, cfg, mesh, uniform_gm=True)
            check(not (hn.LAUNCHES["sym_force_uniform"]
                       or hn.LAUNCHES["pair_sym_force_uniform"]),
                  f"S={s} N={n}: equal-mass tiles on a phantom layout")
            check(torch.equal(got, accel(pos[:n], m[:n], q, cfg, mesh)),
                  f"S={s} N={n} {mode}: the flag changed bits on a "
                  f"phantom layout")
        print(f"ring: phantom layout S={s} N={n}: the flag keeps the general "
              f"tiles, bitwise (float32, int4)")


def ring_large(dev) -> None:
    """N=1,048,576 (D=2 disk) through DirectSimulation(mesh=...): a mesh of
    the one card (float32 and int4, 5 ticks and one snapshot: the
    diagonal is the chunked path, the energy #7; float32 also with unequal
    masses, the general tiles), and virtual(2) (float32, 2 ticks: the pair
    tile source-chunked past the budget)."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.parallel import ring
    from nbody_tpu_torch.utils.profiler import fence

    cfg = SimConfig()
    p0, v0, m0 = large_ics(2, dev)
    one, two = ring.make_particle_mesh(1, dev), ring.ParticleMesh.virtual(
        2, dev)
    unequal = m0 * (1.0 + torch.rand(LARGE_N, generator=torch.Generator()
                                     .manual_seed(LARGE_SEED)).to(dev))
    for mesh, mode, ticks, masses in ((one, "float32", LARGE_STEPS, m0),
                                      (one, "float32", LARGE_STEPS, unequal),
                                      (one, "int4", LARGE_STEPS, m0),
                                      (two, "float32", 2, m0)):
        s = mesh.size
        b = LARGE_N // s
        c = -(-b // hn.sym_chunk_size(b, 2))          # diagonal chunks
        k = -(-b // ring._src_chunk_size(b, b, 2)) if s > 1 else 0
        evals = ticks + 1
        # Every chunk and source chunk here is a multiple of TILE (209728 /
        # 209664 on one shard, 174784 / 174720 on two): equal masses take
        # the equal-mass tiles, unequal ones the general tiles.
        uniform = masses is m0
        want = {hn._variant("sym_force", uniform): evals * s * c,
                hn._variant("pair_sym_force", uniform):
                    evals * (s * c * (c - 1) // 2 + s * (s - 1) // 2 * k),
                "pair_pe_rows": s * s}
        if mode == "int4":
            want["max_d2"] = evals * pruned_launches(LARGE_N)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counters(hn)
        sim = DirectSimulation(p0, v0, masses, precision=mode, mesh=mesh)
        check(sim._uniform_gm == uniform,
              f"1M {mode} S={s}: equal masses detected {sim._uniform_gm}")
        fence(sim.state.positions)
        t0 = time.time()
        snaps, frames = sim.run_with_history(ticks, ticks)
        wall = time.time() - t0
        launched = {k2: v for k2, v in hn.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"ring: 1M {mode} mesh of {s}, "
              f"{'equal' if uniform else 'unequal'} masses: {ticks} ticks + "
              f"1 snapshot in "
              f"{wall:.3f}s ({evals} evaluations: {c} diagonal chunks, "
              f"pair tiles in {k} source chunks); launches {launched}; peak "
              f"{peak:.2f} GB; energy {float(snaps.total[0])!r}")
        check(launched == want, f"1M {mode} S={s}: launches {launched}, "
                                f"expected {want}")
        check(np.isfinite(np.asarray(snaps.total)).all()
              and bool(torch.isfinite(sim.positions).all())
              and frames.shape == (1, LARGE_N, 2),
              f"1M {mode} S={s}: non-finite or misshapen output")
        del sim, snaps, frames
    # The energy pass at 1M, one tile of 1M^2 against four of 524288^2.
    t0 = time.time()
    e1 = ring.ring_potential_energy(p0, m0, cfg, one)
    fence(e1)
    t1 = time.time()
    e2 = ring.ring_potential_energy(p0, m0, cfg, two)
    fence(e2)
    t2 = time.time()
    rel = abs(float(e1) - float(e2)) / abs(float(e1))
    print(f"ring: 1M energy, mesh of 1 {float(e1)!r} ({(t1 - t0) * 1e3:.1f} "
          f"ms) vs virtual(2) {float(e2)!r} ({(t2 - t1) * 1e3:.1f} ms): rel "
          f"{rel:.3e}")
    check(rel <= 1e-5, f"1M energy: meshes of 1 and 2 differ by {rel:.3e}")


def phase_ring(dev, report: dict) -> None:
    from nbody_tpu_torch.parallel import ring
    for name, part in (("tiles", lambda: ring_tiles(dev, report)),
                       ("cli", lambda: ring_cli(dev, report)),
                       ("virtual", lambda: ring_virtual(dev, report)),
                       ("equal masses", lambda: ring_equal_mass(dev)),
                       ("gate", lambda: phase_gate(
                           dev, ring.make_particle_mesh(1, dev),
                           "ring: gate, mesh of 1", RING_GATE_MODES)),
                       ("large", lambda: ring_large(dev))):
        t = time.time()
        part()
        torch.cuda.synchronize()
        print(f"ring: {name} ok in {time.time() - t:.1f}s")


# --------------------------------------------------------------------------
# Phase 9: the speculate-and-verify int bounds (bounds_mode='cached')
# --------------------------------------------------------------------------

CACHED_TICKS = 50   # at N=131072


def cached_run(state, q, cfg, ticks: int, interval: int, mode: str, dev):
    """int4 run_with_snapshots of ``ticks`` with ``bounds_mode``, the
    equal-mass path, counters reset before; returns (state, snapshots,
    wall s, launches)."""
    from nbody_tpu_torch.models import direct
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.utils.profiler import fence
    reset_counters(hn)
    fence(state.positions)
    t0 = time.time()
    state, snaps, _ = direct.run_with_snapshots(
        state, q, cfg, "kernel", True, interval, ticks // interval,
        uniform_gm=True, bounds_mode=mode)
    fence(state.positions)
    return state, snaps, time.time() - t0, dict(hn.LAUNCHES)


def phase_cached(dev, report: dict) -> None:
    """int4 run_with_snapshots(bounds_mode='cached') on the canonical
    5000 x 2000 ICs, on a 131072-star disk and on a 131072-star shell
    whose pruned bounds pass falls back to the full max_d2 every tick,
    each beside the exact path in the same call. Invariants: no tick's
    grid clipped its max; the redo launches that ran equal the counted
    violations; no max_d2 launch; one fused-max and one redo sym_force a
    tick. Reported: ms a tick, the violation rate, and the canonical final
    drift against the int4 reference envelope."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.diagnostics import metrics
    from nbody_tpu_torch.models import direct
    from nbody_tpu_torch.models.galaxy import (create_disk_galaxy,
                                               load_disk_fixture)
    from nbody_tpu_torch.models.state import make_state
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    cfg, q = SimConfig(), Quantizer.from_string("int4")
    disk = create_disk_galaxy(torch.Generator().manual_seed(0),
                              num_stars=BIG_N, device=dev)
    shell = shell_positions(BIG_N, dev)
    cases = (("canonical", load_disk_fixture(STARS, 42, device=dev), TICKS,
              INTERVAL),
             ("disk", disk, CACHED_TICKS, CACHED_TICKS),
             ("shell", (shell, torch.zeros_like(shell),
                        torch.ones(BIG_N, device=dev)), CACHED_TICKS,
              CACHED_TICKS))
    for name, (pos, vel, m), ticks, interval in cases:
        n = pos.shape[0]
        uniform = n % hn.TILE == 0
        state = make_state(pos, vel, m, dev)
        state = state._replace(accelerations=hn.sym_accelerations(
            state.positions, state.masses, q, cfg, uniform_gm=True))
        e0 = float(metrics.total_energy(state.positions, state.velocities,
                                        state.masses, cfg))
        out = {}
        design = hn.sym_design(n, pos.shape[1], q, fused_max=True)
        for mode in ("exact", "cached", "exact"):
            st, snaps, wall, launched = cached_run(state, q, cfg, ticks,
                                                   interval, mode, dev)
            drift = (float(snaps.total[-1]) - e0) / abs(e0) * 100.0
            out.setdefault(mode, []).append(wall)
            if mode == "exact":
                fallbacks = hn.bounds_fallbacks(dev)
                continue
            viol, clipped = direct.cached_bounds_stats(dev)
            redo = hn.redo_launches(dev)
            fused = hn._variant("sym_force", uniform, True)
            plain = hn._variant("sym_force", uniform)
            print(f"cached: {name} N={n} x {ticks} ({design} fused max): "
                  f"violations {viol} "
                  f"({viol / ticks:.2%} of ticks), redo launches that ran "
                  f"{redo}, ticks whose grid clipped {clipped}; launches "
                  f"{ {k: v for k, v in launched.items() if v} }; final "
                  f"drift {drift:+.6f}%")
            check(clipped == 0, f"cached {name}: {clipped} ticks clipped")
            check(redo == viol, f"cached {name}: {redo} redo launches ran "
                                f"for {viol} violations")
            check(launched["max_d2"] == 0, f"cached {name}: max_d2 launched")
            check(launched[fused] == ticks and launched[plain] == ticks,
                  f"cached {name}: launches {launched}")
            check(np.isfinite(np.asarray(snaps.total)).all()
                  and bool(torch.isfinite(st.positions).all()),
                  f"cached {name}: non-finite output")
            report[fused]["launches"] += launched[fused]
            if name == "canonical":
                _, text = gate_rule("int4", [drift],
                                    st.positions.cpu().numpy())
                print(f"cached: canonical int4 with cached bounds: {text} "
                      f"(reported, not a gate)")
        ex, ca = min(out["exact"]), out["cached"]
        # What a tick without a violation pays for its redo: one walk
        # launch whose every block reads the skip flag and returns; and a
        # redo that runs against the same two-pass tile without the skip
        # flag (a counted launch: one block per tile pair; the unflagged
        # launch's one-pass design sums in another order), bitwise the
        # same forces.
        one = torch.ones((), dtype=torch.int32, device=dev)
        counted = torch.zeros((), dtype=torch.int32, device=dev)
        gm = (cfg.G * state.masses).contiguous()
        bounds = hn.kernel_bounds(state.positions, q, cfg)

        def redo(flag):
            return hn.sym_force(state.positions, gm, bounds, q, False,
                                uniform=uniform, skip=flag,
                                count=counted if flag is None else None)

        skip_ms = cuda_ms(lambda: redo(one), 5)
        run_ms, grid_ms = cuda_ms(lambda: redo(one * 0), 5), cuda_ms(
            lambda: redo(None), 5)
        check(torch.equal(redo(one * 0), redo(None)),
              f"cached {name}: the walk's forces differ from the grid's")
        def per_tick(walls):
            return " / ".join(f"{w / ticks * 1e3:.3f}" for w in walls)

        print(f"cached: {name} N={n}: {per_tick(ca)} ms a tick cached "
              f"(the fused max {design}) vs {ex / ticks * 1e3:.3f} exact "
              f"(best of "
              f"{len(out['exact'])}; the exact path's pruned pass fell back "
              f"to the full max_d2 in {fallbacks} of {ticks} ticks); a "
              f"skipped redo launch {skip_ms:.4f} ms, one that runs "
              f"{run_ms:.4f} ms against {grid_ms:.4f} without the skip "
              f"flag (device time, bitwise the same forces)")
        if name == "shell":
            check(fallbacks == ticks, "the shell did not defeat the pruned "
                                      "bounds pass")


# --------------------------------------------------------------------------
# Phase 10: the kernel lab
# --------------------------------------------------------------------------

def phase_lab(dev, report: dict) -> None:
    """``python -m nbody_tpu_torch.lab.kernel_lab``'s table through its
    entry point, with every launch count read around it."""
    from nbody_tpu_torch.lab import kernel_lab
    from nbody_tpu_torch.ops import hopper_nbody as hn

    reset_counters(hn)
    rows = kernel_lab.main(["--device", str(dev)])
    launched = {**{k: v for k, v in hn.LAUNCHES.items() if v},
                **kernel_lab.LAUNCHES}
    print(f"lab: launches {launched}")
    for v in kernel_lab.VARIANTS:
        name = f"sym_force_lab_{v}"
        report[name]["launches"] = kernel_lab.LAUNCHES[name]
        check(report[name]["launches"] > 0,
              f"{name} was never launched by the lab")
    check(launched.get("sym_force") and launched.get("sym_force_uniform"),
          "the lab did not run prod and uniform")
    for row in rows:
        check(np.isfinite(row["ms"]) and (row["mode"] != "float32"
                                          or row["rel_vs_prod"] <= 1e-4),
              f"lab row {row}")
    # Each lab kernel against its plain version at the lab's shape, beside
    # the production equal-mass kernel, in this call.
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops.precision import Quantizer
    cfg, q = SimConfig(), Quantizer.from_string("float32")
    pos, m = make_inputs(BIG_N, 2, True, seed=42, dev=dev)
    gm = (cfg.G * m).contiguous()
    bounds = force_bounds(q, pos, cfg.softening_sq, dev)
    uni_ms = cuda_ms(lambda: hn.sym_force(pos, gm, bounds, q, False,
                                          uniform=True), 3)
    for v in kernel_lab.VARIANTS:
        def plain():
            kernel_lab.sym_force_lab_plain(pos, gm, bounds, q, False, v)
        plain_ms = cuda_ms(plain, 1)
        ms = cuda_ms(lambda: kernel_lab.sym_force_lab(pos, gm, bounds, q,
                                                      False, v), 3)
        plain_ms = min(plain_ms, cuda_ms(plain, 1))
        print(f"lab: sym_force_lab_{v} N={BIG_N} D=2 float32: kernel "
              f"{ms:.4f} ms (sym_force_uniform {uni_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms")
        set_timing(report[f"sym_force_lab_{v}"], ms, plain_ms,
                   f"N={BIG_N} D=2 float32", BIG_N * (BIG_N - 1) / 2,
                   pair_ops("sym_uniform", 2, "float32"), sym_bytes(BIG_N, 2))


# --------------------------------------------------------------------------
# Phase 11: the round-4 kernel lab
# --------------------------------------------------------------------------

def phase_lab_r4(dev, report: dict) -> None:
    """``python -m nbody_tpu_torch.lab.kernel_lab_r4``'s table through its
    entry point, with every launch count read around it; then each round-4
    kernel against its plain version at the lab's N, float32 and int4,
    timed by CUDA events beside sym_force_uniform in the same call."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.lab import kernel_lab, kernel_lab_r4
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    reset_counters(hn)
    rows = kernel_lab_r4.main(["--device", str(dev)])
    launched = {**{k: v for k, v in hn.LAUNCHES.items() if v},
                **{k: v for k, v in kernel_lab.LAUNCHES.items() if v}}
    print(f"lab_r4: launches {launched}")
    for v in kernel_lab.R4_VARIANTS:
        name = f"sym_force_lab_{v}"
        report[name]["launches"] = kernel_lab.LAUNCHES[name]
        check(report[name]["launches"] > 0,
              f"{name} was never launched by the round-4 lab")
    check(launched.get("sym_force") and launched.get("sym_force_uniform")
          and launched.get("sym_force_lab_wide2"),
          "the round-4 lab did not run prod, uniform and wide2")
    for row in rows:
        check(np.isfinite(row["ms"]) and (row["mode"] != "float32"
                                          or row["rel_vs_prod"] <= 1e-4),
              f"lab_r4 row {row}")

    n, cfg = kernel_lab_r4.N, SimConfig()
    pos, m = make_inputs(n, 2, True, seed=42, dev=dev)
    gm = (cfg.G * m).contiguous()
    for mode in ("float32", "int4"):
        q = Quantizer.from_string(mode)
        bounds = force_bounds(q, pos, cfg.softening_sq, dev)
        # Every variant, and sym_force_uniform beside them, computes one
        # function: bound it by that function's own operations.
        ops = pair_ops("sym_t", 2, mode)
        bound_ms = bound(n * (n - 1) / 2, ops, sym_bytes(n, 2))[0]
        uni_ms = cuda_ms(lambda: hn.sym_force(pos, gm, bounds, q, False,
                                              uniform=True), 3)
        print(f"lab_r4: sym_force_uniform N={n} D=2 {mode}: {uni_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({ops} ops a pair)")
        plains = {}   # plain function -> (its result, its ms)
        for v, spec in kernel_lab.R4_VARIANTS.items():
            if spec.base2 and not q.is_int:
                continue
            name = f"sym_force_lab_{v}"
            key = spec.base2

            def plain():
                return kernel_lab.sym_force_lab_plain(pos, gm, bounds, q,
                                                      False, v)
            if key not in plains:
                want = plain()
                plains[key] = (want, cuda_ms(plain, 1, 0))
            want, plain_ms = plains[key]
            got = kernel_lab.sym_force_lab(pos, gm, bounds, q, False, v)
            ms = cuda_ms(lambda: kernel_lab.sym_force_lab(pos, gm, bounds, q,
                                                          False, v), 3)
            tally = Tally()
            tally.hold(f"{mode} D=2 N={n}", got, want,
                       torch.zeros_like(want), q)
            check(not tally.failures, f"{name} at N={n}: {tally.failures}")
            err = tally.worst_err[0]
            print(f"lab_r4: {name} N={n} D=2 {mode}: kernel {ms:.4f} ms "
                  f"(sym_force_uniform {uni_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, max abs err {err:.4e}")
            # The JSON line keeps float32 where the variant has it.
            if mode == "float32" or spec.base2:
                set_timing(report[name], ms, plain_ms, f"N={n} D=2 {mode}",
                           n * (n - 1) / 2, ops, sym_bytes(n, 2))
                report[name]["max_abs_err"] = err


# --------------------------------------------------------------------------
# Phase 12: the round-5 kernel lab
# --------------------------------------------------------------------------

def phase_lab_r5(dev, report: dict) -> None:
    """``python -m nbody_tpu_torch.lab.kernel_lab_r5`` through its entry
    point, with every launch count read around it: the d^2 study's verdict
    on the card, then each precision of the tensor-core kernel against its
    plain version at the lab's N, D=2, timed by CUDA events beside
    sym_force_uniform in the same call."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.lab import kernel_lab_r5 as k5
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    reset_counters(hn)
    res = k5.main(["--device", str(dev)])
    launched = {**{k: v for k, v in hn.LAUNCHES.items() if v},
                **k5.LAUNCHES}
    print(f"lab_r5: launches {launched}")
    for name, count in k5.LAUNCHES.items():
        report[name]["launches"] = count
        check(count > 0, f"{name} was never launched by the round-5 lab")
    check(launched.get("sym_force") and launched.get("sym_force_uniform"),
          "the round-5 lab did not run prod and uniform")
    for row in res["rows"]:
        check(np.isfinite(row["ms"]) and np.isfinite(row["rel_vs_prod"])
              and (row["variant"] != "uniform" or row["rel_vs_prod"] <= 1e-4),
              f"lab_r5 row {row}")
    print("lab_r5: d^2 accuracy study on the card, max abs err vs float64:")
    for geometry, errs in res["study"].items():
        print(f"lab_r5:   {geometry}: " + ", ".join(
            f"{form} {err:.3e}" for form, err in errs.items()))
    adv = res["study"]["adversarial: tight cluster at 200"]
    check(adv["subtract-form"] < 1e-5 and adv["dot-form compensated"] > 1e-3,
          f"the study's verdict does not hold on the card: {adv}")

    n, dim, cfg = k5.N, 2, SimConfig()
    pos, m = make_inputs(n, dim, True, seed=42, dev=dev)
    gm = (cfg.G * m[:1]).reshape(())
    q = Quantizer.from_string("float32")
    bounds = force_bounds(q, pos, cfg.softening_sq, dev)
    uni_ms = cuda_ms(lambda: hn.sym_force(pos, gm.expand(n).contiguous(),
                                          bounds, q, False, uniform=True), 3)
    scale = k5.mxu_term_scale(pos, gm, cfg.softening_sq)
    pairs, ops = n * (n - 1) / 2, pair_ops("mxu", dim, "float32")
    nbytes = 4 * (2 * n * dim + 1)   # positions and G m in, forces out
    for p in k5.PASSES:
        name = f"sym_force_mxu_{p}"

        def plain():
            return k5.sym_force_mxu_plain(pos, gm, cfg.softening_sq, p)
        want = plain()
        plain_ms = cuda_ms(plain, 1, 0)
        got = k5.sym_force_mxu(pos, gm, cfg.softening_sq, p)
        ms = cuda_ms(lambda: k5.sym_force_mxu(pos, gm, cfg.softening_sq, p),
                     3)
        tally = Tally()
        tally.hold(f"float32 D={dim} N={n}", got, want, scale)
        check(not tally.failures, f"{name} at N={n}: {tally.failures}")
        tflops = mxu_tensor_flops(dim, len(k5.PASSES[p]))
        set_timing(report[name], ms, plain_ms, f"N={n} D={dim} float32",
                   pairs, ops, nbytes, tflops)
        report[name]["max_abs_err"] = tally.worst_err[0]
        print(f"lab_r5: {name} N={n} D={dim}: kernel {ms:.4f} ms "
              f"(sym_force_uniform {uni_ms:.4f} ms), plain {plain_ms:.4f} ms,"
              f" max abs err {tally.worst_err[0]:.4e} (err/bound "
              f"{tally.worst_ratio[0]:.4f}); bound "
              f"{report[name]['bound_ms']:.4f} ms ({ops} FP32 ops and "
              f"{tflops} tensor flops a pair)")


# --------------------------------------------------------------------------
# Phase 13: the particle-mesh cosmology engine
# --------------------------------------------------------------------------

# bench.py:207-253's PM arm (nbody_tpu_torch.bench.pm_arm): 262144
# particles, D=3, a 256^3 grid, a 400 Mpc box, z = 80, seed 1, pipelined
# dispatch/collect in chunks of 10 steps of dz = 0.1 with every detector
# live.
PM_ARM_TIMED = 4
# The gate: the reference's universe_2d rows cached under
# tools/reference_cache/ (N, mode).
PM_GATE_ROWS = ((10000, "float32"), (10000, "int4"), (1024, "float32"))
# The deposit checks: (N, D, n_grid, box).
PM_DEPOSIT_CASES = ((10000, 2, 128, 200.0), (262144, 2, 128, 200.0),
                    (10000, 3, 32, 200.0), (262144, 3, 256, 400.0))
# The adversarial key sets of diagnostics/deposit_cases.py: (N, cells).
PM_KEY_CASES = ((20000, 64 ** 3), (262144, 256 ** 3))
PM_TIMING_REPS = 20
# A timed series of one function spends at most this long.
PM_TIMING_BUDGET_MS = 300.0
# Dependent FP32 add latency on Hopper, in SM cycles: an order-preserving
# sum of L particles takes at least L of them.
FADD_CYCLES = 4


def pm_layouts(n: int, dim: int, n_grid: int, box: float, seed: int) -> dict:
    """CPU positions for the deposit checks: a lattice (a perturbed-lattice
    IC's start; the rest uniform), a clustered state (90% of the particles
    in a cube of 3 cells a side), the box edge (a quarter exactly on
    ``box``, a quarter wrapped from -1e-9 onto it, tiny negatives), and
    every particle in one cell."""
    rng = np.random.default_rng(seed)
    side = int(round(n ** (1.0 / dim)))
    side -= side ** dim > n
    axis = (np.arange(side) + 0.5) * (box / side)
    lattice = np.stack([m.reshape(-1) for m in np.meshgrid(
        *([axis] * dim), indexing="ij")], axis=1)
    lattice = np.concatenate([lattice, rng.uniform(
        0, box, (n - side ** dim, dim))])
    clustered = rng.uniform(0, box, (n, dim))
    k = n - n // 10
    clustered[:k] = box / 2 + rng.uniform(0, 3 * box / n_grid, (k, dim))
    edge = rng.uniform(0, box, (n, dim)).astype(np.float32)
    edge[: n // 4] = np.float32(box)
    edge[n // 4: n // 2] = np.float32(-1e-9) % np.float32(box)
    edge[n // 2: n // 2 + 64] = np.float32(-1e-7)
    cell = box / n_grid
    one_cell = box / 2 + rng.uniform(0.1 * cell, 0.9 * cell, (n, dim))
    return {name: torch.from_numpy(np.asarray(p, np.float32))
            for name, p in (("lattice", lattice), ("clustered", clustered),
                            ("edge", edge), ("one_cell", one_cell))}


def float_bits(t: torch.Tensor) -> torch.Tensor:
    """The float32 bit patterns on the CPU: -0.0 and +0.0 differ."""
    return t.detach().cpu().contiguous().view(torch.int32)


def pm_key_checks(dev) -> tuple:
    """The run-centric deposit on diagnostics/deposit_cases.py's keys
    (runs of R and R + 1, one cell, runs at the first and last index,
    alternating long and short runs, empty cells, ties, long runs that
    straddle the run pass's blocks and the long pass's pieces, cells = 1,
    N = 1) at each PM_KEY_CASES size, R = pm.LONG_RUN and R = 1 (every run
    of two or more on the long pass): bitwise its plain version and itself
    run to run; the long pass's count the runs longer than R. Returns
    (cases, failures)."""
    from nbody_tpu_torch.diagnostics.deposit_cases import (case_weights,
                                                           deposit_key_cases)
    from nbody_tpu_torch.ops import pm

    cases, fails = 0, []
    for n, cells in PM_KEY_CASES:
        for long_run in (pm.LONG_RUN, 1):
            for name, keys, c in deposit_key_cases(n, cells, long_run, n):
                w = torch.from_numpy(case_weights(len(keys), n))
                kc = torch.from_numpy(keys)
                want = float_bits(pm.segment_sum_plain(kc, w, c))
                sorted_keys, perm = pm.sort_keys(kc.to(dev))
                wd = w.to(dev)
                scratch = torch.empty(pm.long_list_size(len(keys), long_run),
                                      dtype=torch.int32, device=dev)
                got = pm.deposit_sorted(sorted_keys, perm, wd, c,
                                        long_run=long_run, long_list=scratch)
                again = pm.deposit_sorted(sorted_keys, perm, wd, c,
                                          long_run=long_run)
                _, lengths, _ = pm.sorted_runs(sorted_keys, c)
                longs = int((lengths > long_run).sum())
                cases += 1
                if not (torch.equal(float_bits(got), want)
                        and torch.equal(float_bits(again), want)
                        and int(scratch[0]) == longs):
                    fails.append(f"keys {name} N={len(keys)} cells={c} "
                                 f"R={long_run} (long runs {longs}, "
                                 f"listed {int(scratch[0])})")
    return cases, fails


def pm_deposit_checks(dev, report: dict) -> None:
    """pm_deposit bitwise (float32 bits) its plain version on a CPU copy
    of its inputs (the keys and weights each deposit makes on the card,
    each sum added to the last), its out-of-place chain on the card, and
    itself run to run through the entry points (CIC's later corners added
    in place): NGP and CIC, every case of PM_DEPOSIT_CASES, each
    layout of pm_layouts; then pm_key_checks."""
    from nbody_tpu_torch.ops import pm

    cases, fails, worst = 0, [], 0.0
    for n, dim, n_grid, box in PM_DEPOSIT_CASES:
        w = torch.from_numpy(np.random.default_rng(n + dim).uniform(
            0.5, 1.5, n).astype(np.float32)).to(dev)
        for layout, pos in pm_layouts(n, dim, n_grid, box, n + dim).items():
            pos = pos.to(dev)
            for kind in ("ngp", "cic"):
                got = want = None
                for keys, ws in pm.deposit_segments(pos, w, n_grid, box,
                                                    kind):
                    want = pm.segment_sum_plain(keys.cpu(), ws.cpu(),
                                                n_grid ** dim, want)
                    got = pm.segment_sum(keys, ws, n_grid ** dim, got)
                deposit = getattr(pm, f"{kind}_deposit")
                again = deposit(pos, w, n_grid, box).reshape(-1)
                worst = max(worst, float((got.cpu() - want).abs().max()))
                cases += 1
                bits = float_bits(want)
                if not (torch.equal(float_bits(got), bits)
                        and torch.equal(float_bits(again), bits)):
                    fails.append(f"{kind} N={n} D={dim} {n_grid}^{dim} "
                                 f"{layout}")
    key_cases, key_fails = pm_key_checks(dev)
    report["pm_deposit"]["max_abs_err"] = worst
    print(f"pm: pm_deposit bitwise its plain version, its out-of-place "
          f"chain and itself run to run in {cases - len(fails)} of {cases} "
          f"cases "
          f"(NGP and CIC in place, N in {{10000, 262144}}, D in {{2, 3}}, "
          f"lattice / clustered / edge / one cell) and in "
          f"{key_cases - len(key_fails)} of {key_cases} key sets (runs of "
          f"R and R + 1, one cell, long runs first and last, alternating, "
          f"empty cells, ties, straddling, cells = 1, N = 1; R = "
          f"{pm.LONG_RUN} and 1; the long pass's count exact); max abs err "
          f"{worst}")
    check(not fails and not key_fails,
          f"pm_deposit not bitwise: {fails + key_fails}")


def sm_clock_max_mhz() -> float:
    """The card's highest SM clock (MHz), by nvidia-smi."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def turns_ms(fns: dict) -> tuple:
    """Each fn of ``fns`` in turns (a b b a: the mean of its two series)
    by CUDA events around a loop of calls (the host's issue included) and
    by graph_ms's replay of a CUDA graph of calls (device time with its
    launch gaps, the host excluded; device_ms where a capture fails);
    PM_TIMING_REPS calls a series or fewer, so that one series stays
    within PM_TIMING_BUDGET_MS (at least 2). Returns ({name: events ms},
    {name: device ms})."""
    once = {k: max(cuda_ms(fn, 1, 1), 1e-3) for k, fn in fns.items()}
    events = {k: 0.0 for k in fns}
    device = {k: 0.0 for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        reps = max(2, min(PM_TIMING_REPS, int(PM_TIMING_BUDGET_MS / once[k])))
        events[k] += cuda_ms(fns[k], reps, 1) / 2
        ms = graph_ms(fns[k], reps)
        device[k] += (device_ms(fns[k], reps)[0] if ms is None else ms) / 2
    return events, device


def kernel_split(fn, reps: int = 10) -> str:
    """The device time of each kernel a call of fn() launches, by
    torch.profiler over ``reps`` warm calls (what it traced; a line of
    the report, no check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = sorted(((e.self_device_time_total / 1e3 / reps, e.count / reps,
                     kernel_name(e.key)) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count),
                   reverse=True)
    return ", ".join(f"{name} {ms:.5f} ms (x{count:g})"
                     for ms, count, name in split) or "nothing traced"


def chain_ms(densest: int, clock_mhz: float) -> float:
    """The longest run's chain of dependent FADDs at the SM clock."""
    return densest * FADD_CYCLES / (clock_mhz * 1e3)


def pm_deposit_times(label: str, pos, n_grid: int, box: float,
                     clock_mhz: float) -> dict:
    """The NGP deposit of unit weights at ``pos`` (on the card): the
    kernel on sorted keys, the sort alone and ``index_add_`` from a zeroed
    grid (the same function, but in no fixed order) in turns, by CUDA
    events and by device time (turns_ms); the plain version on a CPU copy
    by the host clock; the bound of an order-preserving segment sum, the
    larger of bytes (the sorted keys, the int64 permutation and the
    weights read, the grid written) over 3.35 TB/s and the densest cell's
    FADD chain."""
    from nbody_tpu_torch.ops import pm

    n, dim = pos.shape
    cells = n_grid ** dim
    w = torch.ones(n, device=pos.device)
    keys = pm.cell_index(pos, box, n_grid)[0]
    sorted_keys, perm = pm.sort_keys(keys)
    t, dt = turns_ms({
        "kernel": lambda: pm.deposit_sorted(sorted_keys, perm, w, cells),
        "sort": lambda: pm.sort_keys(keys),
        "index_add_": lambda: torch.zeros(cells, device=pos.device)
        .index_add_(0, keys, w)})
    keys_c, w_c = keys.cpu(), w.cpu()
    pm.segment_sum_plain(keys_c, w_c, cells)
    t0 = time.perf_counter()
    pm.segment_sum_plain(keys_c, w_c, cells)
    plain = (time.perf_counter() - t0) * 1e3
    nbytes = 16 * n + 4 * cells
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    dense = int(torch.bincount(keys).max())
    fadd_ms = chain_ms(dense, clock_mhz)
    bound_ms = max(bytes_ms, fadd_ms)
    by = "bytes" if bytes_ms >= fadd_ms else "operations"

    def times(x):
        return (f"kernel {x['kernel']:.5f} ms, sort {x['sort']:.5f} "
                f"ms, sort + kernel {x['sort'] + x['kernel']:.5f} ms, "
                f"index_add_ {x['index_add_']:.5f} ms")

    print(f"pm: deposit {label}: by CUDA events {times(t)}; by device time "
          f"{times(dt)}; plain (CPU) {plain:.3f} ms; bound {bound_ms:.5f} ms "
          f"by {'bytes' if by == 'bytes' else 'the FADD chain'} (bytes "
          f"{bytes_ms:.5f} ms: {nbytes} bytes; FADD chain {fadd_ms:.5f} ms: "
          f"{dense} x {FADD_CYCLES} cycles at {clock_mhz:.0f} MHz), share "
          f"{100 * bound_ms / t['kernel']:.1f}% (events), "
          f"{100 * bound_ms / dt['kernel']:.1f}% (device); densest cell "
          f"{dense} particles")
    print("pm:   the kernel's launches by the profiler: " + kernel_split(
        lambda: pm.deposit_sorted(sorted_keys, perm, w, cells)))
    return dict(ms=t["kernel"], sort_ms=t["sort"],
                library_ms=t["index_add_"], device_ms=dt["kernel"],
                plain_ms=plain,
                bound_ms=bound_ms, bound_by=by, bytes=nbytes, densest=dense)


def pm_cic_times(label: str, pos, n_grid: int, box: float,
                 clock_mhz: float) -> None:
    """The whole CIC deposit of unit weights at ``pos`` (all 2^D corners:
    weights, sorts and kernels, ``cic_deposit``, later corners in place);
    then the corners' kernels alone on keys sorted once, bitwise the
    out-of-place chain (segment sums added to the last), beside the
    in-place chain's bound (each corner's keys, permutation and weights
    read, the fill written once, each occupied cell written at the first
    corner and read and written at the later ones; or the corners'
    densest-cell FADD chains in sequence)."""
    from nbody_tpu_torch.ops import pm

    n, dim = pos.shape
    cells = n_grid ** dim
    w = torch.ones(n, device=pos.device)
    whole, whole_dt = turns_ms({
        "kernel": lambda: pm.cic_deposit(pos, w, n_grid, box)})
    segs = [(pm.sort_keys(keys), ws.contiguous())
            for keys, ws in pm.deposit_segments(pos, w, n_grid, box, "cic")]

    def kernels():
        grid = pm.deposit_sorted(*segs[0][0], segs[0][1], cells)
        for (sorted_keys, perm), ws in segs[1:]:
            pm.deposit_sorted(sorted_keys, perm, ws, cells, into=grid)
        return grid

    def out_of_place():
        grid = None
        for (sorted_keys, perm), ws in segs:
            grid = pm.deposit_sorted(sorted_keys, perm, ws, cells, grid)
        return grid

    check(torch.equal(float_bits(kernels()), float_bits(out_of_place())),
          f"pm: CIC {label}: the in-place chain is not the out-of-place "
          f"one's")
    alone, alone_dt = turns_ms({"kernel": kernels})
    nbytes, fadd_ms = 4 * cells, 0.0
    for i, ((sorted_keys, _), _) in enumerate(segs):
        _, lengths, _ = pm.sorted_runs(sorted_keys, cells)
        nbytes += 16 * n + (4 if i == 0 else 8) * lengths.numel()
        fadd_ms += chain_ms(int(lengths.max()), clock_mhz)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(bytes_ms, fadd_ms)
    print(f"pm: CIC {label} ({2 ** dim} corners): whole deposit by CUDA "
          f"events {whole['kernel']:.5f} ms, by device time "
          f"{whole_dt['kernel']:.5f} ms; the kernels alone, bitwise the "
          f"out-of-place chain, by CUDA events {alone['kernel']:.5f} ms, by "
          f"device time {alone_dt['kernel']:.5f} ms; bound {bound_ms:.5f} ms"
          f" (bytes {bytes_ms:.5f} ms: {nbytes} bytes; FADD chains "
          f"{fadd_ms:.5f} ms), share "
          f"{100 * bound_ms / alone_dt['kernel']:.1f}% (device)")


def pm_gate(dev) -> dict:
    """The three gate rows on the card from the reference's cached ICs
    under its clock, each held to its cached reference run (and its
    permuted twin where cached) by the port's copy of the rule of
    tools/pm_reference_parity.py; returns the 10000 float32 row's final
    positions (the z = 0.01 state)."""
    from nbody_tpu_torch.diagnostics import pm_gate as gate

    fails, late = [], None
    for n, mode in PM_GATE_ROWS:
        t0 = time.time()
        ours, eng = gate.run_engine(gate.load_ics(n), mode, dev)
        wall = time.time() - t0
        ref = gate.load_reference(n, mode)
        twin = gate.load_reference(n, mode, perturbed=True)
        row = gate.compare_mode(ref, ours, twin)
        print(f"pm: {gate.row_text(f'gate N={n} {mode}', row)}; drift at "
              f"z=10 ours {row['drift_at_z10_ours']:+.4f}% vs "
              f"{row['drift_at_z10_reference']:+.4f}%; glitches "
              f"{eng.glitch_detector.get_glitch_summary()}; {wall:.1f}s")
        check(np.isfinite(ours["energies"]).all() and
              np.isfinite(ours["final_pos"]).all(),
              f"gate N={n} {mode}: non-finite output")
        if not row["agree"]:
            fails.append(f"N={n} {mode}")
        if (n, mode) == (10000, "float32"):
            late = eng.positions
    check(not fails, f"pm gate DISAGREE: {fails}")
    return late


@contextlib.contextmanager
def no_host_sync():
    """Any CUDA call that waits for the device raises inside this block."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def pm_arm(dev, precision: str, mesh=None, timed: int = PM_ARM_TIMED):
    """bench's PM arm (``bench.pm_arm``; through the sharded PM on
    ``mesh``): its warm-up chunks, then ``timed`` chunks pipelined
    (dispatch k+1, collect k) by the host clock, every dispatch inside
    no_host_sync; the deposit's launches counted over the timed chunks, S
    of them where one device launches one. Returns (engine, ms a step,
    (deposits, fills, long passes), peak bytes allocated)."""
    from nbody_tpu_torch import native
    from nbody_tpu_torch.ops import pm

    torch.cuda.reset_peak_memory_stats(dev)
    shards = 1 if mesh is None else mesh.size
    eng, arm = bench.pm_arm(dev, precision, mesh, timed, guard=no_host_sync)
    ms = arm.ms_per_step
    peak = torch.cuda.max_memory_allocated(dev)
    launches, fills, longs = (arm.launches.get(k, 0) for k in pm.LAUNCHES)
    others = {k: v for k, v in arm.launches.items() if k not in pm.LAUNCHES}
    pos = eng.positions
    check(bool(torch.isfinite(pos).all()) and float(pos.min()) >= 0
          and float(pos.max()) <= bench.PM_ARM["box_size_mpc"]
          and np.isfinite(eng.history["energy"]).all()
          and np.isfinite(eng.history["clustering"]).all(),
          f"pm arm {precision}: non-finite or out-of-box state")
    where = "" if mesh is None else f" on a mesh of {shards}"
    check(launches == timed * (bench.PM_CHUNK + 2) * shards and not others,
          f"pm arm {precision}{where}: pm_deposit launched {launches} times "
          f"in {timed} chunks of {bench.PM_CHUNK} (other kernels {others})")
    check(fills == launches and longs == launches,
          f"pm arm {precision}{where}: {launches} deposits launched {fills} "
          f"fills and {longs} long passes (one each a deposit of more than "
          f"{pm.LONG_RUN})")
    label = "pm" if mesh is None else "pm_mesh"
    print(f"{label}: arm {precision}{where} N={eng.num_particles} D=3 256^3 "
          f"(pipelined, every detector live): {ms:.3f} ms a step over "
          f"{arm.steps} steps, z={eng.redshift:.2f}; glitches "
          f"{eng.glitch_detector.get_glitch_summary()} over the run; "
          f"entropy route {native.route()}; pm_deposit "
          f"launches {launches} (fills {fills}, long passes {longs}); "
          f"clustering {eng.history['clustering'][-1]:.4f}"
          f", BAO {eng.history['bao_scale'][-1]:.2f} Mpc; peak "
          f"{peak / 2 ** 30:.3f} GiB allocated; card {card_line()}")
    return eng, ms, (launches, fills, longs), peak


PM_PROFILE_STEPS = 3   # steps (probe bundles) in one traced window


def pm_kernel_class(name: str) -> str:
    """A PM step's kernel by class: deposit, sort, FFTs, gather
    (index_select's kernels), cat/copy (a mesh's transposes and
    all-gathers), the rest."""
    low = name.lower()
    if "pm_deposit" in low:
        return "deposit"
    if "sort" in low or "radix" in low:
        return "sort"
    if "fft" in low:
        return "FFTs"
    if "index" in low or "gather" in low:
        return "gather"
    if "cat" in low or "copy" in low:
        return "cat/copy"
    return "the rest"


def pm_breakdown(eng) -> None:
    """torch.profiler over PM_PROFILE_STEPS steps of the arm's engine and
    over as many probe bundles: device time by kernel a step (a bundle),
    in classes (deposit, sort, FFTs, gather, the rest: quantizers,
    integrator, census, grid arithmetic); a window whose trace lacks a
    class the call must launch (seen once: the deposit and the sort
    missing) is traced again, twice at most, and where none traced a
    device event the call is timed by CUDA events, with no breakdown. The
    force quantizer alone by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch.engines import cosmo
    from nbody_tpu_torch.ops.precision import quantize_force

    sched, _ = eng._build_schedule(bench.PM_DZ, 1)
    ex = eng.exploit_engine
    obs = (torch.zeros(3, device=eng.device),
           torch.eye(3, device=eng.device)[0])

    def step():
        return cosmo.run_pm_steps(eng.state, sched, eng.quantizer, eng.cfg)

    def probes():
        return cosmo.probe_bundle(eng.positions, eng.velocities,
                                  eng.positions, *obs, eng.cfg.box_size,
                                  ex.c_sim, ex.fov_cos)

    for label, fn, needed in (
            ("one step", step, {"deposit", "sort", "FFTs", "gather"}),
            ("probe bundle", probes, {"deposit", "sort", "FFTs"})):
        fn()
        torch.cuda.synchronize()
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(PM_PROFILE_STEPS):
                    fn()
                torch.cuda.synchronize()
            classes, kernels = {}, []
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and e.count:
                    ms = e.self_device_time_total / 1e3 / PM_PROFILE_STEPS
                    cls = pm_kernel_class(e.key)
                    classes[cls] = classes.get(cls, 0.0) + ms
                    kernels.append((ms, e.count // PM_PROFILE_STEPS,
                                    kernel_name(e.key)[:60]))
            if needed <= set(classes):
                break
            print(f"pm: the profiler traced no {sorted(needed - set(classes))}"
                  f" kernel of the {label} in window {attempt + 1} of 3")
        total = sum(classes.values())
        if not total:   # device_ms's fallback: no breakdown, CUDA events
            ms = cuda_ms(fn, PM_PROFILE_STEPS, 0)
            print(f"pm: breakdown of {label}: the profiler traced no device "
                  f"event; by CUDA events {ms:.4f} ms a call")
            continue
        print(f"pm: breakdown of {label} ({eng.precision_str}, device time "
              f"{total:.4f} ms, a mean over {PM_PROFILE_STEPS}): " + ", ".join(
                  f"{k} {v:.4f} ms ({100 * v / total:.1f}%)"
                  for k, v in sorted(classes.items(), key=lambda kv: -kv[1])))
        print("pm:   top kernels: " + "; ".join(
            f"{name} x{count} {ms:.4f} ms" for ms, count, name in
            sorted(kernels, reverse=True)[:6]))
    acc = torch.randn((eng.num_particles, 3), device=eng.device)
    q_ms = cuda_ms(lambda: quantize_force(acc, eng.quantizer), 10, 2)
    print(f"pm: breakdown: quantize_force alone {q_ms:.4f} ms (CUDA events)")


def phase_pm(dev, report: dict) -> None:
    """The PM engine on the card: the deposit kernel's checks, the three
    gate rows, bench.py's PM arm in int4 (the main path: its launches are
    the kernel's count) and float32, the deposit's times (both designs in
    turns) and a profile of a step."""
    import logging
    logging.getLogger("nbody_tpu_torch.glitch").setLevel(logging.ERROR)

    pm_deposit_checks(dev, report)
    late = pm_gate(dev)
    clock = sm_clock_max_mhz()
    pm_deposit_times("N=10000 D=2 128^2 at z=0.01 (the gate's float32 "
                     "final state)", late, 128, 200.0, clock)
    eng, ms, (launches, fills, longs), _ = pm_arm(dev, "int4")
    entry = report["pm_deposit"]
    entry.update(launches=launches, fill_launches=fills, long_launches=longs)
    layouts = pm_layouts(262144, 3, 256, 400.0, 3)
    for layout in ("lattice", "clustered", "one_cell"):
        pm_deposit_times(f"N=262144 D=3 256^3 {layout}",
                         layouts[layout].to(dev), 256, 400.0, clock)
    state = f"the int4 arm's state at z={eng.redshift:.2f}"
    t = pm_deposit_times(f"N=262144 D=3 256^3 {state}", eng.positions, 256,
                         400.0, clock)
    entry.update(ms=t["ms"], plain_ms=t["plain_ms"],
                 library_ms=t["library_ms"], bound_ms=t["bound_ms"],
                 bound_by=t["bound_by"], bytes=t["bytes"],
                 sort_ms=t["sort_ms"], device_ms=t["device_ms"],
                 timed_at="N=262144 D=3 256^3 NGP, the int4 arm's state")
    pm_cic_times(f"N=262144 D=3 256^3 {state}", eng.positions, 256, 400.0,
                 clock)
    pm_cic_times("N=262144 D=3 256^3 clustered",
                 layouts["clustered"].to(dev), 256, 400.0, clock)
    pm_breakdown(eng)
    del eng
    pm_arm(dev, "float32")


# --------------------------------------------------------------------------
# Phase pm_mesh: the sharded particle mesh (parallel/pm_sharded.py)
# --------------------------------------------------------------------------

# The arm's meshes: bench's make_particle_mesh() (one card: a mesh of
# one), 4 virtual shards (the slab FFT and the slab gather: 256^3 >
# 2 x 262144) and 3 (256 % 3 takes the replicated fallback; 262144 % 3
# leaves two phantom rows). Timed chunks each.
PM_MESH_VIRTUAL = (4, 3)
PM_MESH_TIMED = PM_ARM_TIMED
# The gate's single-device rows on the card (final drift, %), recorded on
# their first card run and bit for bit since, printed beside the mesh of
# one's.
PM_GATE_DRIFTS = {(10000, "float32"): 557602.3732,
                  (10000, "int4"): 566835.8750,
                  (1024, "float32"): 602590.3300}
# One force evaluation through the mesh against the single device: every
# component within this share of the largest |a| (the port's PM rule,
# tests/test_torch_cosmo.py); a mesh of one bitwise.
PM_FORCE_RTOL = 1e-5
# The presets at their defaults with --mesh: (module, extra argv, report
# file, its tick key, steps).
PM_PRESETS = (("universe3d", ["--probes"], "universe3d_report.json",
               "ticks", 50),
              ("genesis", [], "genesis_report.json", "tick", 200),
              ("universe2d", [], "universe2d_report.json", "ticks", 50))


def pm_mesh_deposit_checks(dev, report: dict) -> None:
    """pm_deposit bitwise its plain version at the mesh's per-shard shapes:
    the arm's 262144 particles padded to S shards (65536 at S = 4, 87382
    at S = 3 with two phantom rows), a lattice and a clustered layout, the
    step's 256^3 grid and the probe bundle's 64^3 and 32^3, unit weights
    times the valid mask (the arm's: equal masses) and random ones."""
    from nbody_tpu_torch.ops import pm
    from nbody_tpu_torch.parallel.ring import _pad_to_shards

    n, box = bench.PM_ARM["num_particles"], bench.PM_ARM["box_size_mpc"]
    layouts = pm_layouts(n, 3, 256, box, 3)
    rand = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 1.5, n).astype(np.float32))
    cases, fails, worst = 0, [], 0.0
    for shards in PM_MESH_VIRTUAL:
        for layout in ("lattice", "clustered"):
            pos = _pad_to_shards(layouts[layout], shards)
            valid = (torch.arange(pos.shape[0]) < n).to(torch.float32)
            b = pos.shape[0] // shards
            for kind, w in (("unit", valid),
                            ("random", _pad_to_shards(rand, shards))):
                for s in range(shards):
                    p_s, w_s = pos[s * b:(s + 1) * b], w[s * b:(s + 1) * b]
                    for n_grid in (256, 64, 32):
                        keys = pm.cell_index(p_s.to(dev), box, n_grid)[0]
                        got = pm.segment_sum(keys, w_s.to(dev), n_grid ** 3)
                        want = pm.segment_sum_plain(keys.cpu(), w_s,
                                                    n_grid ** 3)
                        cases += 1
                        worst = max(worst, float(
                            (got.cpu() - want).abs().max()))
                        if not torch.equal(float_bits(got), float_bits(want)):
                            fails.append(f"S={shards} {layout} {kind} shard "
                                         f"{s} {n_grid}^3")
    entry = report["pm_deposit"]
    entry["max_abs_err"] = max(entry["max_abs_err"] or 0.0, worst)
    print(f"pm_mesh: pm_deposit bitwise its plain version at the per-shard "
          f"shapes in {cases - len(fails)} of {cases} cases (S in "
          f"{PM_MESH_VIRTUAL}: {n // 4} and {-(-n // 3)} particles a shard, "
          f"lattice / clustered, 256^3 / 64^3 / 32^3, unit x valid and "
          f"random weights); max abs err {worst}")
    check(not fails, f"pm_deposit not bitwise at the shard shapes: {fails}")


def pm_mesh_gate(dev) -> None:
    """The three gate rows through a mesh of one and 4 and 3 virtual shards,
    each held to its cached reference run by the gate's rule; the mesh of
    one bitwise the single-device engine (energies, momenta and final
    positions), its drift printed beside the single device's recorded
    row."""
    from nbody_tpu_torch.diagnostics import pm_gate as gate
    from nbody_tpu_torch.parallel import pm_sharded

    meshes = [pm_sharded.make_particle_mesh(1, dev)] + [
        pm_sharded.ParticleMesh.virtual(s, dev) for s in PM_MESH_VIRTUAL]
    fails = []
    for n, mode in PM_GATE_ROWS:
        ics = gate.load_ics(n)
        ref = gate.load_reference(n, mode)
        twin = gate.load_reference(n, mode, perturbed=True)
        single, _ = gate.run_engine(ics, mode, dev)
        for mesh in meshes:
            t0 = time.time()
            ours, eng = gate.run_engine(ics, mode, dev, mesh=mesh)
            wall = time.time() - t0
            row = gate.compare_mode(ref, ours, twin)
            extra = ""
            if mesh.size == 1:
                same = all(ours[k] == single[k]
                           for k in ("energies", "momenta", "final_pos"))
                extra = (f"; bitwise the single device: {same}; its "
                         f"recorded row {PM_GATE_DRIFTS[(n, mode)]:+.4f}%")
                check(same, f"gate N={n} {mode}: a mesh of one is not the "
                      f"single device's run")
            print(f"pm_mesh: {gate.row_text(f'gate N={n} {mode} S={mesh.size}', row)}"
                  f"; glitches {eng.glitch_detector.get_glitch_summary()}; "
                  f"{wall:.1f}s{extra}")
            check(np.isfinite(ours["energies"]).all()
                  and np.isfinite(ours["final_pos"]).all(),
                  f"gate N={n} {mode} S={mesh.size}: non-finite output")
            if not row["agree"]:
                fails.append(f"N={n} {mode} S={mesh.size}")
    check(not fails, f"pm gate through a mesh DISAGREE: {fails}")


def pm_mesh_force(dev, state, q, cfg) -> None:
    """One force evaluation at the arm's state through each route, S in
    {1, 3, 4}, against the single-device pm_accelerations on the same
    positions (unquantized, and int4-quantized on the mesh of one)."""
    from nbody_tpu_torch.engines import cosmo
    from nbody_tpu_torch.parallel import pm_sharded

    pos, masses = state.positions, state.masses
    scale = torch.full((), 1.0 / (1.0 + state.redshift), device=dev)
    single = cosmo.pm_accelerations(pos, masses, q, cfg, scale, False)
    top = float(single.abs().max())
    one = pm_sharded.make_particle_mesh(1, dev)
    for shards, route in ((1, "replicated"), (1, "slab"), (4, "slab"),
                          (4, "replicate"), (3, "replicated")):
        mesh = one if shards == 1 else pm_sharded.ParticleMesh.virtual(
            shards, dev)
        got = pm_sharded.pm_accelerations_sharded(pos, masses, q, cfg, mesh,
                                                  scale, False, route)
        err = float((got - single).abs().max()) / top
        print(f"pm_mesh: one force evaluation at the arm's state "
              f"(z={state.redshift:.2f}), S={shards} {route}: largest error "
              f"{err:.3e} of max|a| {top:.4e} (rule {PM_FORCE_RTOL:g}; "
              f"{'bitwise' if torch.equal(got, single) else 'not bitwise'})")
        if shards == 1:
            check(torch.equal(got, single), f"S=1 {route}: the force is not "
                  f"the single device's")
        else:
            check(err <= PM_FORCE_RTOL, f"S={shards} {route}: force error "
                  f"{err:.3e} > {PM_FORCE_RTOL:g} of max|a|")
    got = pm_sharded.pm_accelerations_sharded(pos, masses, q, cfg, one,
                                              scale, True, "replicated")
    want = cosmo.pm_accelerations(pos, masses, q, cfg, scale, True)
    check(torch.equal(got, want), "S=1: the quantized force is not the "
          "single device's")


def pm_mesh_breakdown(dev, eng) -> None:
    """Device time of one step of the slab-FFT runner at the arm's state on
    a mesh of one and on 4 virtual shards (device_ms: torch.profiler, its
    CUDA-graph / CUDA-event fallback), by ``pm_kernel_class``: deposit,
    sort, FFTs, gather (index_select), cat/copy (the mesh's transposes and
    all-gathers), the rest (the reduce-scatter's and the step's
    arithmetic). The reduce-scatter of the S full grids and the
    spectrum's all-to-all alone by CUDA events."""
    from nbody_tpu_torch.parallel import pm_sharded

    state, q, cfg = eng._trimmed_state(), eng.quantizer, eng.cfg
    sched, _ = eng._build_schedule(bench.PM_DZ, 1)
    n_grid = cfg.n_grid
    for shards in (1, 4):
        mesh = (pm_sharded.make_particle_mesh(1, dev) if shards == 1
                else pm_sharded.ParticleMesh.virtual(shards, dev))

        def step():
            return pm_sharded.run_pm_steps_sharded_fft(
                state, sched, q, cfg, mesh, quantize_forces=True,
                gather=False)

        total, kernels = device_ms(step, reps=5, warmup=2)
        if kernels is None:
            print(f"pm_mesh: breakdown of a step at S={shards}: {total:.4f} "
                  f"ms by the fallback, no classes")
        else:
            classes = {}
            for name, (_, ms) in kernels.items():
                cls = pm_kernel_class(name)
                classes[cls] = classes.get(cls, 0.0) + ms
            print(f"pm_mesh: breakdown of a step at S={shards} (slab-FFT "
                  f"runner, int4, device time {total:.4f} ms): " + ", ".join(
                      f"{k} {v:.4f} ms ({100 * v / total:.1f}%)" for k, v in
                      sorted(classes.items(), key=lambda kv: -kv[1])))
        grids = [torch.rand((n_grid,) * 3, device=dev) for _ in range(shards)]
        spec = [torch.zeros((n_grid // shards, n_grid, n_grid // 2 + 1),
                            dtype=torch.complex64, device=dev)
                for _ in range(shards)]
        rs = cuda_ms(lambda: pm_sharded._reduce_scatter(grids, mesh), 10, 2)
        a2a = cuda_ms(lambda: pm_sharded._all_to_all(spec, mesh, 1, 0), 10, 2)
        print(f"pm_mesh:   alone by CUDA events: the reduce-scatter of "
              f"{shards} {n_grid}^3 grids {rs:.4f} ms, the half spectrum's "
              f"all-to-all {a2a:.4f} ms (one of 1 + D a step)")


def pm_mesh_presets() -> None:
    """universe3d (with --probes), genesis and universe2d through
    ``main(argv)`` with --mesh at their defaults on the card, each report
    written into a temporary directory and read back: finite energies,
    the step count, the glitch summary, the wall time."""
    import importlib
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for name, extra, report_file, tick_key, steps in PM_PRESETS:
            main = importlib.import_module(
                f"nbody_tpu_torch.engines.{name}").main
            out = Path(tmp) / name
            buf = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                main(["--mesh", *extra, "--output", str(out)])
            wall = time.time() - t0
            rep = json.loads((out / report_file).read_text())
            energies = [rep["energy_first"], rep["energy_last"]]
            summary = rep["glitch_summary"]
            check("sharded PM over 1 device(s)" in buf.getvalue(),
                  f"{name} --mesh: no mesh of one")
            check(rep[tick_key] == steps and np.isfinite(energies).all()
                  and isinstance(summary, dict),
                  f"{name} --mesh: {rep[tick_key]} steps (want {steps}), "
                  f"energies {energies}, glitches {summary}")
            probes = ("; probes: variance ratio "
                      f"{rep['interference']['variance_ratio']:.2f}, clip "
                      f"velocity {rep['collision_audit']['clip_velocity']:.1f}"
                      if "interference" in rep else "")
            print(f"pm_mesh: {name} --mesh{' ' + ' '.join(extra) if extra else ''} "
                  f"at its defaults: {steps} steps to z="
                  f"{rep.get('final_redshift', rep.get('redshift')):.2f} in "
                  f"{wall:.1f}s wall; energy {energies[0]:.4e} -> "
                  f"{energies[1]:.4e}; glitches {summary}{probes}")


def phase_pm_mesh(dev, report: dict) -> None:
    """The sharded PM on the card: the deposit at the per-shard shapes, the
    gate rows through meshes of 1, 4 and 3, bench's PM arm through
    make_particle_mesh() and on 4 and 3 virtual shards (ms a step, exact
    launches, peak memory), one force evaluation through every route, a
    breakdown of a step at S = 1 and 4, and the presets' --mesh runs."""
    import logging

    from nbody_tpu_torch.parallel import pm_sharded

    logging.getLogger("nbody_tpu_torch.glitch").setLevel(logging.ERROR)
    pm_mesh_deposit_checks(dev, report)
    pm_mesh_gate(dev)
    entry = report["pm_deposit"]
    arms, base = {}, None
    for mesh in [pm_sharded.make_particle_mesh(device=dev)] + [
            pm_sharded.ParticleMesh.virtual(s, dev) for s in PM_MESH_VIRTUAL]:
        eng, ms, (launches, _, _), peak = pm_arm(dev, "int4", mesh=mesh,
                                                 timed=PM_MESH_TIMED)
        arms[mesh.size] = {"ms": ms, "launches": launches,
                           "peak_gib": round(peak / 2 ** 30, 4)}
        base = base or eng
        del eng
    entry["mesh_arms"] = arms
    if not entry["launches"]:   # phase pm did not run: the mesh of one's
        entry["launches"] = arms[1]["launches"]
    state = base._trimmed_state()
    pm_mesh_force(dev, state, base.quantizer, base.cfg)
    pm_mesh_breakdown(dev, base)
    del base, state
    pm_mesh_presets()


# --------------------------------------------------------------------------
# Phase ultimate: the batch "run everything" test (engines/ultimate.py)
# --------------------------------------------------------------------------

ULTIMATE_N = 32768         # ultimate.main's default size: 32^3, D=3, 64^3
ULTIMATE_BOX = 500.0       # UltimateEngine's box (Mpc)
ULTIMATE_SUBSTRATE_STEPS = 10
SHELL_COUNT_SLACK = 2      # a shell's pair count on the card against the CPU's
PROFILER_SAMPLE_MS = 10.0


@contextlib.contextmanager
def timed_calls(walls: dict, *targets):
    """Wrap each (owner, attribute) so that every call adds its wall to
    ``walls[attribute]``; the originals come back on exit."""
    saved = [(owner, name, getattr(owner, name), name in vars(owner))
             for owner, name in targets]

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return run

    try:
        for owner, name, fn, _ in saved:
            setattr(owner, name, timed(name, fn))
        yield walls
    finally:
        for owner, name, fn, own in saved:
            if own:
                setattr(owner, name, fn)
            else:   # inherited: drop the wrapper, the base's comes back
                delattr(owner, name)


@contextlib.contextmanager
def counted_dispatches(chunks: list):
    """Record the step count of every chunk CosmologicalEngine dispatches
    (the deposits a chunk launches are its steps and its probe bundle's
    two)."""
    from nbody_tpu_torch.engines.cosmo import CosmologicalEngine

    dispatch = CosmologicalEngine.dispatch_step

    @functools.wraps(dispatch)
    def counted(self, dz=1.0, num_steps=1):
        pending = dispatch(self, dz, num_steps)
        if pending is not None:
            chunks.append(pending.num_steps)
        return pending

    CosmologicalEngine.dispatch_step = counted
    try:
        yield chunks
    finally:
        CosmologicalEngine.dispatch_step = dispatch


@contextlib.contextmanager
def clock_skews(skews: list):
    """Record, at every check of the realtime engine's GlobalClock, the
    skew of its stamps in ms and the stalest subsystem."""
    from nbody_tpu_torch.realtime import engine as rt

    check_sync = rt.GlobalClock.check_sync_violation

    @functools.wraps(check_sync)
    def recorded(self):
        with self._lock:
            now = time.monotonic()
            ages = {k: now - t for k, t in self._stamps.items()}
        if len(ages) >= 2:
            skews.append((1e3 * (max(ages.values()) - min(ages.values())),
                          max(ages, key=ages.get)))
        return check_sync(self)

    rt.GlobalClock.check_sync_violation = recorded
    try:
        yield skews
    finally:
        rt.GlobalClock.check_sync_violation = check_sync


def chunk_deposits(chunks: list) -> int:
    """The deposits of the chunks dispatched on one device: one a step and
    the probe bundle's two (P(k) and the clustering grid)."""
    return sum(steps + 2 for steps in chunks)


def ultimate_full(dev, tmp: Path, report: dict) -> Path:
    """ultimate.main --mode full at its default size on the card: the five
    checks, the score, each phase's wall and the deposit's launches
    against the count the run's chunks and probes give."""
    from nbody_tpu_torch.engines import ultimate
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops import pm

    out = tmp / "full"
    argv = ["--mode", "full", "--precision", "int4", "--output", str(out),
            "--device", str(dev)]
    print(f"ultimate: nbody_tpu_torch.engines.ultimate.main({argv})")
    reset_counters(hn)
    chunks, walls = [], {}
    buf = io.StringIO()
    t0 = time.time()
    with counted_dispatches(chunks), timed_calls(
            walls, (ultimate, "run_bao_test"),
            (ultimate.UltimateEngine, "run_to_completion"),
            (ultimate.UltimateEngine, "detect_structures"),
            (ultimate, "compare_to_sdss"), (ultimate, "compare_to_cmb"),
            (ultimate, "export_state_for_comparison")), \
            contextlib.redirect_stdout(buf):
        rep = ultimate.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = pm.LAUNCHES["pm_deposit"]
    others = {k: v for k, v in hn.LAUNCHES.items() if v}
    epochs = len(rep["bao_test"]["rows"])
    # every chunk's deposits, one P(k) an epoch of the BAO test, the
    # structure census's one, the CMB comparison's P(k)
    want = chunk_deposits(chunks) + epochs + 1 + 1
    check(rep["num_particles"] == ULTIMATE_N,
          f"ultimate ran {rep['num_particles']} particles")
    check(launches == want and not others,
          f"ultimate: pm_deposit launched {launches} times, the run's "
          f"{len(chunks)} chunks ({sum(chunks)} steps), {epochs} BAO "
          f"epochs, the census and the CMB spectrum give {want} (other "
          f"kernels {others})")
    check(np.isfinite(rep["sdss"]["xi_sim"]).all()
          and np.isfinite(rep["bao_test"]["final_bao_mpc"])
          and 0.0 <= rep["structures"]["void_fraction"] <= 1.0,
          f"ultimate: non-finite or out-of-range report {rep['sdss']}, "
          f"{rep['structures']}")
    print(f"ultimate: full at N={rep['num_particles']} D=3 64^3 int4 in "
          f"{wall:.2f}s: {len(chunks)} chunks, {sum(chunks)} steps; checks "
          f"{rep['checks']}; reality score {rep['reality_score']:.0f}/100; "
          f"glitches {rep['glitch_summary']}; walls (s): " + ", ".join(
              f"{k} {v:.3f}" for k, v in walls.items())
          + f"; BAO epochs {[round(r['step_time_s'], 4) for r in rep['bao_test']['rows']]}"
          f" s; pm_deposit launches {launches} (derived {want}); state "
          f"hash {rep['state_hash']}")
    report["pm_deposit"]["launches"] += launches
    return out / "substrate_state.json"


def ultimate_estimator(dev, export: Path) -> None:
    """The 2-point estimator on the run's final positions on the card
    against its CPU run on the same positions; the hash of the card's
    state against its CPU copy's and the run's own."""
    from nbody_tpu_torch.engines import ultimate
    from nbody_tpu_torch.utils.reproducibility import hash_state

    state = json.loads(export.read_text())
    pos = torch.tensor(state["positions"], dtype=torch.float32)
    vel = torch.tensor(state["velocities"], dtype=torch.float32)
    card_pos, card_vel = pos.to(dev), vel.to(dev)
    box = ULTIMATE_BOX
    ultimate.shell_counts(card_pos, box)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, card, n_anchor = ultimate.shell_counts(card_pos, box)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, host, _ = ultimate.shell_counts(pos, box)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    diff = np.abs(card - host)
    check(diff.max() <= SHELL_COUNT_SLACK,
          f"ultimate: 2-point shell counts on the card {card.tolist()} "
          f"against the CPU's {host.tolist()}")
    print(f"ultimate: 2-point counts at N={pos.shape[0]} ({n_anchor} "
          f"anchors, bins {r.tolist()}): card {card.tolist()}, CPU "
          f"{host.tolist()}: {int((diff > 0).sum())} of {len(diff)} bins "
          f"differ (most by {int(diff.max())}); card {card_ms:.2f} ms, CPU "
          f"{cpu_ms:.1f} ms (host clock, one call)")
    hashes = {"card": hash_state(card_pos, card_vel),
              "cpu copy": hash_state(card_pos.cpu(), card_vel.cpu()),
              "run": state["simulation"]["state_hash"]}
    check(len(set(hashes.values())) == 1,
          f"ultimate: hash_state differs: {hashes}")
    print(f"ultimate: hash_state of the card's final state "
          f"{hashes['card']} = its CPU copy's = the run's export")


def ultimate_substrate(dev, tmp: Path) -> None:
    """Two --mode substrate runs on the card give one hash; a card engine
    and a CPU engine from one seed export one hash at tick 0, and the
    mirror test compares them after 10 steps."""
    from nbody_tpu_torch.engines import ultimate

    argv = ["--mode", "substrate", "--precision", "int4", "--device",
            str(dev)]
    with contextlib.redirect_stdout(io.StringIO()):
        hashes = [ultimate.main([*argv, "--output", str(tmp / f"sub{i}")])
                  for i in (0, 1)]
    check(hashes[0] == hashes[1],
          f"ultimate: two substrate runs on the card: {hashes}")
    print(f"ultimate: --mode substrate twice on the card ({ULTIMATE_N} "
          f"particles, {ULTIMATE_SUBSTRATE_STEPS} steps, int4): hash "
          f"{hashes[0]} both times")
    engines = {k: ultimate.UltimateEngine(num_particles=ULTIMATE_N,
                                          precision="int4", seed=42,
                                          device=where)
               for k, where in (("card", dev), ("cpu", "cpu"))}
    paths = {k: tmp / f"mirror_{k}.json" for k in engines}
    with contextlib.redirect_stdout(io.StringIO()):
        tick0 = {k: ultimate.export_state_for_comparison(e, str(paths[k]))
                 for k, e in engines.items()}
    check(tick0["card"] == tick0["cpu"],
          f"ultimate: tick-0 hashes differ between the card and the CPU: "
          f"{tick0}")
    walls = {}
    for k, e in engines.items():
        t0 = time.perf_counter()
        e.step(dz=1.0, num_steps=ULTIMATE_SUBSTRATE_STEPS)
        walls[k] = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for k, e in engines.items():
            ultimate.export_state_for_comparison(e, str(paths[k]))
        res = ultimate.compare_substrate_states(str(paths["card"]),
                                                str(paths["cpu"]))
    check(np.isfinite(res["position_correlation"]),
          f"ultimate: mirror test {res}")
    print(f"ultimate: card vs CPU from seed 42: tick-0 hash {tick0['card']} "
          f"on both; after {ULTIMATE_SUBSTRATE_STEPS} steps (card "
          f"{walls['card']:.2f}s, CPU {walls['cpu']:.2f}s) hash_match "
          f"{res['hash_match']}, position correlation "
          f"{res['position_correlation']:.9f}, velocity correlation "
          f"{res['velocity_correlation']:.9f}, max |dx| "
          f"{res['max_position_delta']:.4g} Mpc")


def ultimate_profiler(dev) -> None:
    """DeviceProfiler's overhead at 10 ms sampling over a 10-step chunk,
    its channels on the card, and one TraceCapture of a chunk."""
    from nbody_tpu_torch.engines import ultimate
    from nbody_tpu_torch.utils import profiler
    from nbody_tpu_torch.utils.profiler import fence

    eng = ultimate.UltimateEngine(num_particles=ULTIMATE_N,
                                  precision="int4", device=dev)

    def chunk():
        eng.step(dz=0.1, num_steps=10)
        fence(eng.state.positions)

    chunk()
    with contextlib.redirect_stdout(io.StringIO()):
        res = profiler.measure_instrumentation_overhead(
            chunk, sample_interval_ms=PROFILER_SAMPLE_MS)
    prof = profiler.DeviceProfiler(PROFILER_SAMPLE_MS, "ultimate chunk",
                                   device=dev)
    prof.start()
    try:
        for _ in range(3):
            prof.time_step(chunk)
    finally:
        prof.stop()
    a = prof.analyze()
    check(a.step_count == 3 and a.num_samples > 0
          and a.peak_memory_mb is not None,
          f"ultimate: profiler read no device memory: {a}")
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.TraceCapture(tmp) as tc:
            chunk()
        events = json.loads(tc.path.read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    try:
        import psutil  # noqa: F401
        host = "psutil installed"
    except ImportError:
        host = "psutil not installed: host CPU / RSS None"
    print(f"ultimate: DeviceProfiler at {PROFILER_SAMPLE_MS:.0f} ms over a "
          f"10-step chunk (N={ULTIMATE_N}, int4): baseline "
          f"{res['baseline_s'] * 1e3:.2f} ms, instrumented "
          f"{res['instrumented_s'] * 1e3:.2f} ms, overhead "
          f"{res['overhead_percent']:+.2f}%; 3 chunks p50 "
          f"{a.p50_step_ms:.2f} ms, CV {a.step_time_cv:.3f}, {a.num_samples} "
          f"samples, device memory peak {a.peak_memory_mb:.1f} MB, host CPU "
          f"{a.mean_host_cpu}; {host}; TraceCapture of a chunk: "
          f"{len(events)} events, {kernels} device kernels")


def phase_ultimate(dev, report: dict) -> None:
    """engines/ultimate.py on the card: --mode full at its default size
    (32768 particles, D=3, 64^3, int4) with the deposit's launches derived
    from its chunks; the 2-point counts and the state hash against the
    CPU; substrate runs bitwise from run to run and the card-vs-CPU mirror
    test; the profiler's overhead and channels."""
    import logging

    logging.getLogger("nbody_tpu_torch.glitch").setLevel(logging.ERROR)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        export = ultimate_full(dev, tmp, report)
        ultimate_estimator(dev, export)
        ultimate_substrate(dev, tmp)
    ultimate_profiler(dev)


# --------------------------------------------------------------------------
# Phase realtime: the live loop, the precision viewer, the multiverse
# --------------------------------------------------------------------------

REALTIME_N, REALTIME_SECONDS = 10000, 5       # realtime.engine's default N
REALTIME_STEPS_PER_FRAME = 2                  # CosmicWebEngine's default
VIEWER_STARS, VIEWER_FRAMES, VIEWER_TICKS = 2000, 20, 50
MULTIVERSE_STARS, MULTIVERSE_TICKS, MULTIVERSE_INTERVAL = 1024, 60, 20
REVERSED_RTOL = 1e-5       # the reversed force against float64, of max|a|


def realtime_engine_runs(dev, tmp: Path, report: dict) -> None:
    """realtime.engine.main at its default size for 5 s, headless, on one
    card and through a mesh of one: ticks, no desync (the clock's largest
    skews and their stalest subsystem printed beside), the deposit's
    launches against the ticks (each frame's 2 steps and its probe
    bundle's 2), and where a pump's host time goes (its dispatch and
    collect halves; inside them the schedule's and the histories'
    cosmic-time integrals and the zlib entropy probe)."""
    from nbody_tpu_torch.config import Cosmology
    from nbody_tpu_torch.diagnostics import glitch
    from nbody_tpu_torch.engines.cosmo import CosmologicalEngine
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops import pm
    from nbody_tpu_torch.realtime import engine as rt

    for extra in ([], ["--mesh"]):
        out = tmp / f"rt{len(extra)}"
        argv = ["--particles", str(REALTIME_N), "--seconds",
                str(REALTIME_SECONDS), "--output", str(out), "--device",
                str(dev), *extra]
        reset_counters(hn)
        chunks, walls, skews = [], {}, []
        t0 = time.time()
        with counted_dispatches(chunks), clock_skews(skews), timed_calls(
                walls, (CosmologicalEngine, "dispatch_step"),
                (CosmologicalEngine, "collect_step"),
                (Cosmology, "cosmic_time_gyr"),
                (glitch, "measure_state_entropy")), \
                contextlib.redirect_stdout(io.StringIO()):
            rep = rt.main(argv)
        wall = time.time() - t0
        launches = pm.LAUNCHES["pm_deposit"]
        ticks = rep["final_tick"]
        frames = ticks // REALTIME_STEPS_PER_FRAME
        alive = [t.name for t in threading.enumerate()
                 if t.name in ("bao-solver", "rsi-monitor")]
        label = "--mesh (a mesh of one)" if extra else "one card"
        top = ", ".join(f"{ms:.1f} ms ({who})"
                        for ms, who in sorted(skews, reverse=True)[:3])
        margin = (f"largest clock skews {top} of {len(skews)} checks "
                  f"(limit {1e3 * rt.DESYNC_LIMIT_S:.0f} ms)")
        check(ticks > 0 and rep["desync_count"] == 0 and not alive,
              f"realtime {label}: final tick {ticks}, desyncs "
              f"{rep['desync_count']}, monitors alive {alive}; {margin}")
        check(sum(chunks) == ticks
              and launches == ticks + 2 * frames == chunk_deposits(chunks),
              f"realtime {label}: pm_deposit launched {launches} times in "
              f"{ticks} ticks ({len(chunks)} chunks dispatched)")
        check(rep["mesh_devices"] == (1 if extra else 0),
              f"realtime {label}: mesh_devices {rep['mesh_devices']}")
        print(f"realtime: engine {label} N={REALTIME_N} "
              f"{REALTIME_SECONDS}s headless ({wall:.1f}s with set-up): "
              f"{ticks} ticks to z={rep['final_redshift']:.2f}, fps "
              f"{rep['mean_fps']:.2f}, step_ms_p50 {rep['step_ms_p50']:.3f}, "
              f"jitter CV {rep['step_jitter_cv']:.3f}, RSI "
              f"{rep['final_rsi']:.1f}, glitches {rep['glitch_count']}, "
              f"desyncs {rep['desync_count']}, {margin}; pm_deposit launches "
              f"{launches} (= ticks + 2 x {frames} frames); host ms a "
              f"frame: " + ", ".join(f"{k} {1e3 * v / max(frames, 1):.3f}"
                                     for k, v in walls.items()))
        report["pm_deposit"]["launches"] += launches


def realtime_viewer(dev, tmp: Path, report: dict) -> None:
    """realtime.visual.main in compare mode at 2000 stars for 20 frames of
    50 ticks: one sym_force launch a tick a universe (and one at set-up),
    the custom universe's two max_d2 launches an evaluation, no
    pair_pe_rows."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.realtime import visual

    argv = ["--stars", str(VIEWER_STARS), "--frames", str(VIEWER_FRAMES),
            "--ticks-per-frame", str(VIEWER_TICKS), "--output",
            str(tmp / "visual"), "--device", str(dev)]
    reset_counters(hn)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        view = visual.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(hn.LAUNCHES)
    evals = VIEWER_FRAMES * VIEWER_TICKS + 1
    hist = view.history
    check(view.tick == evals - 1 and len(hist["ghost"]) == VIEWER_FRAMES
          and np.isfinite(hist["drift_clean"] + hist["drift_broken"]).all(),
          f"realtime viewer: tick {view.tick}, history {hist}")
    check(launches["sym_force"] == 2 * evals
          and launches["max_d2"] == 2 * evals
          and launches["pair_pe_rows"] == 0
          and not any(v for k, v in launches.items()
                      if k not in ("sym_force", "max_d2")),
          f"realtime viewer: launches {launches}, want sym_force {2 * evals} "
          f"(both universes), max_d2 {2 * evals} (the custom universe's "
          f"bounds pass), nothing else")
    print(f"realtime: viewer {VIEWER_STARS} stars x {VIEWER_FRAMES} frames "
          f"of {VIEWER_TICKS} ticks in {wall:.2f}s (with set-up): final "
          f"drift clean {hist['drift_clean'][-1]:+.6f}%, broken (custom-16) "
          f"{hist['drift_broken'][-1]:+.6f}%, ghost {hist['ghost'][-1]:+.6f}%"
          f"; launches sym_force {launches['sym_force']}, max_d2 "
          f"{launches['max_d2']}, pair_pe_rows {launches['pair_pe_rows']}")
    for k in ("sym_force", "max_d2"):
        report[k]["launches"] += launches[k]


def realtime_multiverse(dev) -> None:
    """MultiverseSim at 1024 stars for 60 ticks on the card: a finite
    report whose reversed-order divergence grows; the reversed force at
    tick 0 against a float64 CPU evaluation of the same sum."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.diagnostics import multiverse
    from nbody_tpu_torch.models.galaxy import create_disk_galaxy

    pos, vel, m = create_disk_galaxy(torch.Generator().manual_seed(42),
                                     MULTIVERSE_STARS)
    cfg = SimConfig()
    acc = multiverse.reversed_sum_accelerations(pos.to(dev), m.to(dev), cfg)
    ref = multiverse.reversed_sum_accelerations(pos.double(), m.double(),
                                                cfg)
    err = float((acc.cpu().double() - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= REVERSED_RTOL * scale,
          f"multiverse: reversed force off float64 by {err:.3e} "
          f"(max|a| {scale:.3e})")
    t0 = time.time()
    rep = multiverse.MultiverseSim(pos, vel, m, device=dev).run(
        MULTIVERSE_TICKS, MULTIVERSE_INTERVAL)
    wall = time.time() - t0
    div = rep.divergence_reversed
    fields = [*div, *rep.divergence_fp16, rep.lyapunov_reversed,
              rep.lyapunov_fp16, rep.entropy_bits_a, rep.entropy_bits_b,
              rep.heisenberg_product]
    check(np.isfinite(fields).all() and div[-1] > div[0],
          f"multiverse: report {rep}")
    print(f"realtime: multiverse {MULTIVERSE_STARS} stars x "
          f"{MULTIVERSE_TICKS} ticks on the card in {wall:.2f}s: |A-B| "
          f"{[f'{d:.3e}' for d in div]}, |A-C| "
          f"{[f'{d:.3e}' for d in rep.divergence_fp16]}, Lyapunov "
          f"{rep.lyapunov_reversed:.4f} / {rep.lyapunov_fp16:.4f} a tick; "
          f"reversed force at tick 0 off float64 by {err / scale:.3e} of "
          f"max|a|")


def phase_realtime(dev, report: dict) -> None:
    """realtime/engine.py at its default size for 5 s on one card and
    through a mesh of one; realtime/visual.py in compare mode at 2000
    stars; MultiverseSim at 1024 stars."""
    import logging

    logging.getLogger("nbody_tpu_torch.glitch").setLevel(logging.ERROR)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        realtime_engine_runs(dev, tmp, report)
        realtime_viewer(dev, tmp, report)
    realtime_multiverse(dev)


# --------------------------------------------------------------------------
# Phase experiments: the precision-ladder suites on the card
# --------------------------------------------------------------------------

# (module of nbody_tpu_torch.experiments, arguments, report file): run_all's
# arguments of the JAX package for the first six (omniverse at its full
# defaults, so that its 20001-body cloud runs), the orbital audit at its
# full size (each RK4 chunk a CUDA-graph replay).
EXPERIMENT_SUITES = (
    ("stability_test", ["--stars", "600", "--ticks", "400"],
     "stability_results.json"),
    ("sensitivity_test", ["--stars", "600", "--ticks", "200"],
     "sensitivity_results.json"),
    ("falsification_tests", ["--quick"], "falsification_report.json"),
    ("dark_matter_test", ["--stars", "800", "--ticks", "150"],
     "dark_matter_results.json"),
    ("sparc_test", ["--stars", "600", "--ticks", "150"],
     "sparc_results.json"),
    ("jitter_test", ["--quick"], "jitter_report.json"),
    ("omniverse_tests", [], "omniverse_report.json"),
    ("orbital_audit", [], "orbital_audit_report.json"),
)
# The top-level keys of each report, as the JAX package writes them.
EXPERIMENT_KEYS = {
    "stability_test": {"results", "threshold_mode", "num_stars",
                       "max_ticks"},
    "sensitivity_test": {"results", "monotonicity"},
    "falsification_tests": {"convergence", "bullet_cluster",
                            "parameter_sensitivity"},
    "dark_matter_test": {"DM 0x", "DM 2x", "DM 5x", "DM 10x"},
    "sparc_test": {"results", "int4_dm_wins", "float64_dm_wins",
                   "verdict_int4_more_dm_like"},
    "jitter_test": {"frame_rate_sweep", "velocity_sweep"},
    "omniverse_tests": {"recursive_mirror", "fluid_chaos", "neural_bridge",
                        "voxel_grid", "suite_score"},
    "orbital_audit": {"tle_drift", "lense_thirring", "telemetry_glitches",
                      "flop_cost", "tle_source", "notes", "score"},
}
# propagate_rk4 on the card against the CPU, float32: samples within this
# share of the orbit's radius (the transcendentals are other builds).
RK4_CARD_RTOL = 1e-4
RK4_AB = ("ISS", 6.0, 10.0)   # fixture, hours, dt: the drift audit's run


def force_evals(counts: dict, n: int, evals: int, precision,
                equal_masses: bool, dim: int = 2) -> None:
    """Add the launches of ``evals`` force evaluations of DirectSimulation
    (force_impl "auto", a static or run-time softening that is not routed
    to the row sweep) over n particles at ``precision`` (a Quantizer or a
    mode's name) to counts: sym_force an evaluation (its equal-mass
    variant for equal masses at a multiple of TILE) while one launch fits
    (hn.sym_force_fits), else the chunked path's C sym_force and
    C(C-1)/2 pair_sym_force launches over hn.sym_chunk_size chunks, each
    in its equal-mass variant where its sizes are multiples of TILE; and
    for an int or custom rung the pruned bounds pass's max_d2 launches;
    float64 launches none (the native-f64 baseline)."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Precision, Quantizer

    q = (precision if isinstance(precision, Quantizer)
         else Quantizer(Precision(precision)))
    if q.mode == Precision.FLOAT64:
        return
    if hn.sym_force_fits(n, dim):
        uniform = equal_masses and n % hn.TILE == 0
        counts["sym_force_uniform" if uniform else "sym_force"] += evals
    else:
        chunk = hn.sym_chunk_size(n, dim)
        sizes = [min(chunk, n - a) for a in range(0, n, chunk)]
        for i, a in enumerate(sizes):
            counts[hn._variant("sym_force", equal_masses
                               and a % hn.TILE == 0)] += evals
            for b in sizes[i + 1:]:
                counts[hn._variant("pair_sym_force", equal_masses
                                   and a % hn.TILE == 0
                                   and b % hn.TILE == 0)] += evals
    if q.is_int:
        counts["max_d2"] += evals * (1 if n <= hn.PRUNED_CANDIDATES else 2)


def experiment_launches(module: str, argv: list, rep: dict) -> tuple:
    """The kernel launches one suite's run must make, and the derivation
    as text: N, ticks and modes from the suite's own parser for argv, its
    size rules (suite_sizes) and its sweep constants. A disk's masses are
    equal, the nested system's and the cloud's are not. Only the stability
    floor's ticks depend on the run (a mode stops at its first failed
    explosion check): they are read from the report once they fit its
    check interval and max ticks. No suite takes an energy past
    hn.TILED_MIN_N, so pair_pe_rows launches 0 times."""
    import importlib

    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    counts = {k: 0 for k in hn.LAUNCHES}
    if module == "orbital_audit":
        return counts, "RK4 on 3-vectors: no N-body kernel"
    mod = importlib.import_module(f"nbody_tpu_torch.experiments.{module}")
    args = mod.build_parser().parse_args(argv)
    if module == "stability_test":
        n, every = args.stars, mod.CHECK_INTERVAL
        last = -(-args.ticks // every) * every
        check([r["mode"] for r in rep["results"]]
              == [m.value for m in mod.MODES],
              f"stability: modes {[r['mode'] for r in rep['results']]}")
        ran = [r["stable_ticks"] for r in rep["results"]]
        for r in rep["results"]:
            t = r["stable_ticks"]
            check(t % every == 0 and every <= t <= last
                  and (r["exploded"] or t == last),
                  f"stability: {r['mode']} ran {t} ticks (checks every "
                  f"{every}, at most {last}, exploded {r['exploded']})")
            force_evals(counts, n, 1 + t, r["mode"], True)
        text = (f"{n} stars: (1 + ticks run) x sym_force a mode but "
                f"float64, x max_d2 for int8 and int4; ticks run {ran} "
                f"(checks every {every} up to {last})")
    elif module == "sensitivity_test":
        n, ticks = args.stars, args.ticks
        for lv in mod.DEFAULT_LEVELS:
            force_evals(counts, n, 1 + ticks, mod._quantizer_for_levels(lv),
                        True)
        text = (f"{len(mod.DEFAULT_LEVELS)} levels x {1 + ticks} "
                f"evaluations at {n} stars: sym_force each, max_d2 the "
                f"custom rungs")
    elif module == "falsification_tests":
        s = mod.suite_sizes(args.stars, args.ticks, args.quick)
        (nc, tc), (nb, tb), (ns, ts) = (
            s[k] for k in ("convergence", "bullet_cluster",
                           "parameter_sensitivity"))
        for lv in mod.CONVERGENCE_LEVELS:
            force_evals(counts, nc, 1 + tc, mod._quantizer_for_levels(lv),
                        True)
        bodies = len(mod.bullet_initial_conditions(nb, args.seed)[2])
        for _, precision in mod.BULLET_PRECISIONS:
            force_evals(counts, bodies, 1 + tb, precision, True)
        sweeps = len(mod.SOFTENINGS) + len(mod.DTS)
        for _ in range(sweeps):
            force_evals(counts, ns, 1 + ts, "int4_sim", True)
        text = (f"convergence {len(mod.CONVERGENCE_LEVELS)} levels x "
                f"{1 + tc} at {nc}, bullet float64 + custom-16 x {1 + tb} "
                f"at {bodies}, {sweeps} int4 sweeps x {1 + ts} at {ns}")
    elif module == "dark_matter_test":
        n, ticks = args.stars, args.ticks
        for _ in mod.DM_RATIOS:
            force_evals(counts, n, 1 + ticks, "float32", True)
        text = (f"{len(mod.DM_RATIOS)} ratios x {1 + ticks} float32 "
                f"evaluations at {n}")
    elif module == "sparc_test":
        n, ticks = args.stars, args.ticks
        for _ in mod.GALAXY_DATABASE:
            for mode in mod.MODES:
                force_evals(counts, n, 1 + ticks, mode.value, True)
        text = (f"{len(mod.GALAXY_DATABASE)} galaxies x "
                f"{[m.value for m in mod.MODES]} x {1 + ticks} evaluations "
                f"at {n} stars (float64: none)")
    elif module == "jitter_test":
        s = mod.suite_sizes(args.quick)
        nested = mod.NESTED_LEVELS * s["nested_stars"]

        def evals(dt, total):   # set-up, then interval x samples ticks
            return 1 + mod.sample_plan(dt, total)[1] * mod.NUM_SAMPLES

        frame = [evals(dt, mod.FRAME_TIME) for dt in mod.FRAME_DTS]
        speed = [evals(mod.VELOCITY_DT, mod.VELOCITY_TIME)
                 for _ in mod.BETAS]
        for e in frame:
            force_evals(counts, nested, e, "float32", False)
        for e in speed:
            force_evals(counts, s["disk_stars"], e, "float32", True)
        text = (f"nested {mod.NESTED_LEVELS} x {s['nested_stars']} "
                f"(unequal masses) {frame} evaluations over the dts, disk "
                f"{s['disk_stars']} {speed} over the speeds, float32")
    else:
        s = mod.suite_sizes(args.quick)
        n = len(mod.fluid_initial_conditions(s["fluid_particles"],
                                             args.seed)[2])
        force_evals(counts, n, 1 + s["fluid_ticks"], "float32", False)
        text = (f"the cloud's {n} bodies (unequal masses) x "
                f"{1 + s['fluid_ticks']} evaluations, sym_force design "
                f"{hn.sym_design(n, 2, Quantizer())!r} (T = "
                f"{-(-n // hn.TILE)} tiles); the mirror and the voxel grid "
                f"run the plain dense force")
    return counts, text


@contextlib.contextmanager
def first_launches(hn):
    """Record, cloned, the inputs of the first sym_force and max_d2 launch
    of each shape the enclosed run makes (sym_force: N, D, mode, levels,
    variant, self mask; max_d2: N, D). The wrappers run as they are and
    count their launches."""
    seen = {}
    sym, mx = hn.sym_force, hn.max_d2

    def sym_force(pos, gm, bounds, q, self_masked, uniform=False, **kw):
        variant = uniform and pos.shape[0] % hn.TILE == 0
        key = ("sym_force", *pos.shape, q.mode.value, q.levels, variant,
               self_masked)
        if key not in seen:
            seen[key] = (pos.clone(), gm.clone(), bounds.clone(), q,
                         self_masked, uniform)
        return sym(pos, gm, bounds, q, self_masked, uniform=uniform, **kw)

    def max_d2(pos, *a, **kw):
        seen.setdefault(("max_d2", *pos.shape), (pos.clone(),))
        return mx(pos, *a, **kw)

    hn.sym_force, hn.max_d2 = sym_force, max_d2
    try:
        yield seen
    finally:
        hn.sym_force, hn.max_d2 = sym, mx


def hold_first_launches(seen: dict, report: dict,
                        label: str = "experiments") -> None:
    """Each launch first_launches recorded, again, against its plain
    version on the same inputs: sym_force (and its equal-mass variant)
    within the kernels phase's tolerance and quantize_force flips (Tally),
    max_d2 bitwise. At a float32 shape that no int rung reached (the
    omniverse cloud's), the int4 rung too, bounds from the plain max
    pass."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    tallies = {"sym_force": Tally(), "sym_force_uniform": Tally()}
    cases = [(key, inputs) for key, inputs in seen.items()
             if key[0] == "sym_force"]
    int_shapes = {key[1:3] for key, (*_, q, _m, _u) in cases if q.is_int}
    for key, (pos, gm, bounds, q, masked, uniform) in list(cases):
        if q.mode.value == "float32" and key[1:3] not in int_shapes:
            q4 = Quantizer.from_string("int4")
            b4 = force_bounds(q4, pos, float(bounds[2]), pos.device)
            cases.append((("sym_force", *key[1:3], "int4_sim", 16, *key[5:]),
                          (pos, gm, b4, q4, masked, uniform)))
    for key, (pos, gm, bounds, q, masked, uniform) in cases:
        variant = uniform and pos.shape[0] % hn.TILE == 0
        name = "sym_force_uniform" if variant else "sym_force"
        plain = hn.sym_force_uniform_plain if variant else hn.sym_force_plain
        got = hn.sym_force(pos, gm, bounds, q, masked, uniform=uniform)
        want = plain(pos, gm, bounds, q, masked)
        case = (f"N={pos.shape[0]} D={pos.shape[1]} {q.mode.value}"
                + (f"/{q.levels}" if q.levels else "")
                + f" design {hn.sym_design(pos.shape[0], pos.shape[1], q)}")
        tallies[name].hold(case, got, want, lazy_scale(
            pos, gm, bounds, q, masked, got, want), q)
    maxes = [key for key in seen if key[0] == "max_d2"]
    for key in maxes:
        pos, = seen[key]
        got, want = hn.max_d2(pos), hn.max_d2_plain(pos)
        check(bitwise(got, want), f"max_d2 at the suites' N={key[1]} "
              f"D={key[2]}: {got.item()} vs plain {want.item()}")
    for name, tally in tallies.items():
        if tally.cases:
            tally.report(f"{name} at the suites' shapes", report[name])
    print(f"{label}: max_d2 bitwise its plain version at the suites' "
          f"{len(maxes)} shapes {sorted(key[1] for key in maxes)}")


def finite_numbers(x, path: str = "") -> list:
    """Paths of the non-finite numbers in a JSON report; a rotation
    curve's velocities may be NaN (a bin with no star)."""
    if isinstance(x, dict):
        return [p for k, v in x.items()
                for p in finite_numbers(v, f"{path}/{k}")]
    if isinstance(x, list):
        if path.endswith("/velocities"):
            return []
        return [p for i, v in enumerate(x)
                for p in finite_numbers(v, f"{path}[{i}]")]
    if isinstance(x, float) and not math.isfinite(x):
        return [path]
    return []


def experiment_verdicts(module: str, rep: dict) -> str:
    """tests/test_experiments_smoke.py's verdicts on the card's report."""
    if module == "stability_test":
        check(len(rep["results"]) == 6, f"stability: {len(rep['results'])} "
                                         f"results")
        return f"threshold {rep['threshold_mode']}"
    if module == "sensitivity_test":
        by_bits = sorted(rep["results"], key=lambda r: r["bits"])
        coarse, fine = (abs(by_bits[i]["energy_drift_pct"]) for i in (0, -1))
        check(coarse > fine, f"sensitivity: coarsest |drift| {coarse} <= "
                             f"finest {fine}")
        return (f"|drift| 2 bits {coarse:.4f}% > infinite {fine:.6f}%, "
                f"monotone {rep['monotonicity']['monotone']}")
    if module == "falsification_tests":
        check(rep["convergence"]["converges"], "falsification: the "
              "artifact does not converge")
        return (f"converges, bullet separated "
                f"{rep['bullet_cluster']['separated']}, robust "
                f"{rep['parameter_sensitivity']['robust']}")
    if module == "dark_matter_test":
        return ", ".join(f"{k} slope {v['final_outer_slope']:+.4f}"
                         for k, v in rep.items())
    if module == "sparc_test":
        return (f"int4 DM wins {rep['int4_dm_wins']}, float64 "
                f"{rep['float64_dm_wins']}")
    if module == "jitter_test":
        return (f"corr(log dt, log jitter) "
                f"{rep['frame_rate_sweep']['dt_jitter_correlation']:+.3f}")
    if module == "omniverse_tests":
        fluid = rep["fluid_chaos"]
        check(fluid["deleted"] == 0, f"omniverse: {fluid['deleted']} cloud "
                                     f"bodies not finite")
        return (f"cloud deleted 0, escaped {fluid['escaped']}, merged "
                f"{fluid['merged']}; LSTM accuracy "
                f"{rep['neural_bridge']['accuracy']:.2f}; "
                f"{rep['suite_score']['conclusion']}")
    return (f"int4 drift amplification "
            f"x{rep['score']['mean_int4_drift_amplification']:.1f}")


def experiment_suites(dev, tmp: Path, report: dict) -> None:
    """Each suite's main with --device on the card: its wall, its report's
    keys and finite numbers, its verdicts, and its launches against the
    derivation; then the first sym_force and max_d2 launch of each shape
    the suites made, against the plain versions."""
    import importlib

    from nbody_tpu_torch.ops import hopper_nbody as hn

    total = 0.0
    with first_launches(hn) as seen:
        for module, argv, name in EXPERIMENT_SUITES:
            total += experiment_suite(importlib.import_module(
                f"nbody_tpu_torch.experiments.{module}"), module, argv,
                tmp / module, name, dev, report)
    print(f"experiments: the eight suites in {total:.2f}s")
    hold_first_launches(seen, report)


def experiment_suite(mod, module: str, argv: list, out: Path, name: str,
                     dev, report: dict) -> float:
    """One suite's main on the card, checked; returns its wall (s)."""
    from nbody_tpu_torch.ops import hopper_nbody as hn

    reset_counters(hn)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main([*argv, "--device", str(dev), "--output", str(out)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    rep = json.loads((out / name).read_text())
    launches = dict(hn.LAUNCHES)
    check(set(rep) == EXPERIMENT_KEYS[module],
          f"{module}: report keys {sorted(rep)}")
    bad = finite_numbers(rep)
    check(not bad, f"{module}: non-finite numbers at {bad[:5]}")
    verdict = experiment_verdicts(module, rep)
    want, text = experiment_launches(module, argv, rep)
    check(launches == want, f"{module}: launches "
          f"{ {k: v for k, v in launches.items() if v} }, derived "
          f"{ {k: v for k, v in want.items() if v} } ({text})")
    print(f"experiments: {module} {' '.join(argv) or '(defaults)'} in "
          f"{wall:.2f}s; {verdict}; launches "
          f"{ {k: v for k, v in launches.items() if v} } = derived: {text}")
    for k in ("sym_force", "sym_force_uniform", "max_d2", "pair_pe_rows"):
        report[k]["launches"] += launches[k]
    return wall


def rk4_bins(samples: torch.Tensor, levels: int) -> torch.Tensor:
    """Each sample's bin on the orbital audit's log grid of r^2."""
    from nbody_tpu_torch.experiments import orbital_audit as oa
    lo, hi = math.log(oa.R_EARTH ** 2), math.log((20 * oa.R_EARTH) ** 2)
    r2 = torch.clamp((samples.double() ** 2).sum(1), min=oa.R_EARTH ** 2)
    return torch.round((torch.log(r2) - lo) / (hi - lo) * (levels - 1))


def rk4_eager(p0, v0, dt: float, q, steps: int, every: int, dev) -> tuple:
    """propagate_rk4's chunks as eager launches on the card (the loop of
    its CPU branch): (samples, underflows, overflows)."""
    from nbody_tpu_torch.experiments import orbital_audit as oa
    state, consts = oa._rk4_start(p0, v0, q, dev)
    samples = []
    for _ in range(steps // every):
        state = oa._rk4_chunk(state, dt, q, consts, every)
        samples.append(state[0])
    return torch.stack(samples), state[2], state[3]


def experiment_rk4(dev) -> None:
    """propagate_rk4 on the card (its CUDA-graph replay) against the same
    chunks as eager launches (rk4_eager: bitwise, timed in turns) and
    against the CPU: float32 within RK4_CARD_RTOL of the orbit's radius;
    int4's bin flips counted."""
    from nbody_tpu_torch.experiments import orbital_audit as oa
    from nbody_tpu_torch.ops.precision import Precision, Quantizer

    name, hours, dt = RK4_AB
    el = oa.parse_tle(*oa.TLE_FIXTURES[name])
    p0, v0 = oa.elements_to_state(el)
    steps = int(hours * 3600 / dt)
    every = max(steps // 50, 1)
    steps = steps // every * every
    for mode in ("float32", "int4_sim"):
        q = Quantizer(Precision(mode))

        def run(design):
            t0 = time.perf_counter()
            out = (oa.propagate_rk4(p0, v0, dt, q, steps, every, device=dev)
                   if design == "graph"
                   else rk4_eager(p0, v0, dt, q, steps, every, dev))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        run("graph")   # capture once, warm
        walls = {"eager": [], "graph": []}
        outs = {}
        for design in ("eager", "graph", "graph", "eager"):
            outs[design], wall = run(design)
            walls[design].append(wall)
        (ge, ue, oe), (gg, ug, og) = outs["eager"], outs["graph"]
        check(torch.equal(ge, gg) and int(ue) == int(ug)
              and int(oe) == int(og),
              f"orbital: propagate_rk4 {mode}: the graph replay differs "
              f"from the eager launches")
        cpu, under, over = oa.propagate_rk4(p0, v0, dt, q, steps, every,
                                            device="cpu")
        card = gg.cpu()
        scale = float(torch.linalg.vector_norm(cpu, dim=1).max())
        err = float((card - cpu).abs().max())
        flips = (int((rk4_bins(card, q.levels)
                      != rk4_bins(cpu, q.levels)).sum()) if q.is_int else 0)
        if not q.is_int:
            check(err <= RK4_CARD_RTOL * scale,
                  f"orbital: float32 samples on the card off the CPU's by "
                  f"{err:.4g} km (radius {scale:.1f} km)")
        check((int(ug), int(og)) == (int(under), int(over)),
              f"orbital: counters card {(int(ug), int(og))}, CPU "
              f"{(int(under), int(over))}")
        ms = {k: 1e3 * min(v) / steps for k, v in walls.items()}
        print(f"orbital: propagate_rk4 {mode} {name} {steps} steps (dt "
              f"{dt:g} s, chunks of {every}): eager {ms['eager']:.4f} ms a "
              f"step, graph replay {ms['graph']:.4f} ms a step (host clock, "
              f"best of 2 in turns), bitwise equal; card vs CPU max "
              f"{err:.4g} km of {scale:.1f} km ({err / scale:.3g}), "
              f"{flips} int-grid bin flips of {len(card)} samples; "
              f"counters {int(ug)}, {int(og)}")


def experiment_run_all(dev, tmp: Path) -> None:
    """ultimate.run_all_tests(quick=True) on the card: no suite records an
    error."""
    from nbody_tpu_torch.engines import ultimate

    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        res = ultimate.run_all_tests(quick=True, out_dir=str(tmp / "all"),
                                     device=str(dev))
    torch.cuda.synchronize()
    wall = time.time() - t0
    errors = {k: v["error"] for k, v in res.items()
              if isinstance(v, dict) and "error" in v}
    check(not errors and set(res) == {"ultimate", "sensitivity",
                                      "omniverse", "orbital"},
          f"ultimate.run_all_tests: {errors or sorted(res)}")
    print(f"experiments: ultimate.run_all_tests(quick=True) on the card in "
          f"{wall:.2f}s: ultimate score "
          f"{res['ultimate']['reality_score']:.0f}/100, sensitivity "
          f"monotone {res['sensitivity'][1]['monotone']}, omniverse "
          f"{res['omniverse']['suite_score']['conclusion']}, orbital "
          f"x{res['orbital']['score']['mean_int4_drift_amplification']:.1f}"
          f"; no error")


def phase_experiments(dev, report: dict) -> None:
    """nbody_tpu_torch.experiments on the card: the eight suites' main
    with their launches derived and their kernels' first launch of each
    shape against the plain versions, propagate_rk4's graph replay
    against eager launches and the CPU, and ultimate.run_all_tests."""
    import logging

    logging.getLogger("nbody_tpu_torch.glitch").setLevel(logging.ERROR)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        experiment_suites(dev, tmp, report)
        experiment_rk4(dev)
        experiment_run_all(dev, tmp)


# --------------------------------------------------------------------------
# Phase 18: the hardware and glitch probes, and run_all
# --------------------------------------------------------------------------

# The nine probes of nbody_tpu_torch.experiments that run_all runs at its
# own arguments (run_all.SUITES), and the report each writes.
PROBE_REPORTS = {
    "density_limit_test": "density_limit_report.json",
    "hardware_leak_test": "hardware_leak_report.json",
    "crash_point_test": "crash_point_report.json",
    "universe_stress_test": "stress_test_report.json",
    "breakout_tests": "breakout_results.json",
    "extreme_mode": "extreme_mode_report.json",
    "red_team_proof": "rsi_{kind}.json",
    "omega_point_test": "omega_point_report.json",
    "reality_glitch_tests": "reality_glitch_report.json",
}
# The top-level keys of each probe's report, as the JAX package writes them.
PROBE_KEYS = {
    "density_limit_test": {"results", "scaling", "telemetry_note"},
    "hardware_leak_test": {"workloads", "analysis"},
    "crash_point_test": {"velocity", "dt", "quantization", "softening"},
    "universe_stress_test": {"boundaries", "energy_leak",
                             "density_scaling"},
    "breakout_tests": {"precision_wall", "lazy_loading", "lattice_symmetry",
                       "memory_leak", "verdict"},
    "extreme_mode": {"subnormal_hell", "infinity_cascade",
                     "precision_massacre", "singularity_hunt",
                     "quantum_chaos"},
    "red_team_proof": {"platform", "device_kind", "temporal_jitter",
                       "divergence", "entropy_drift", "observer_effect",
                       "rsi", "sha256"},
    "omega_point_test": {"bekenstein", "temporal_aliasing", "entropy_leak",
                         "phase_space", "triple_point",
                         "physical_comparison", "reality_heatmap",
                         "simulation_probability"},
    "reality_glitch_tests": {"subnormal_singularity",
                             "multiverse_divergence", "entropy_horizon",
                             "spatial_aliasing"},
}
# Numbers a report may hold as +/-inf (JAX's reports do too): omega's
# heat death when the ghost energy does not grow, the leak's overhead when
# the int4 workload ran no iteration.
PROBE_INF_OK = ("/entropy_leak/ticks_to_heat_death",
                "/analysis/broken_overhead_percent")
# The D=3 row of the density phase, at its full width.
DENSITY_D3 = ["--dim", "3", "--counts", str(BIG_N)]
# memory_armageddon must hand its blocks back: reserved memory after the
# probe within this much of before.
ARMAGEDDON_SLACK_MB = 256


def crash_sweep_evals(counts: dict, mod, n: int, ticks: int,
                      sweeps: dict) -> int:
    """Add the launches of crash_point_test's four sweeps (as the report
    ``sweeps`` records them: which values ran and at which tick each
    crashed) at n stars and ``ticks`` ticks; returns the runs. A run is
    one set-up evaluation and a tick's each, in chunks of mod.CHECK up to
    its crash's tick or the whole ceil(ticks / CHECK) chunks."""
    full = -(-ticks // mod.CHECK) * mod.CHECK
    runs = 0
    for axis, key in (("velocity", "multiplier"), ("dt", "dt"),
                      ("quantization", "levels"),
                      ("softening", "softening")):
        values = [r[key] for r in sweeps[axis]["sweep"]]
        grid = {"velocity": mod.VELOCITY_MULTIPLIERS, "dt": mod.DTS,
                "quantization": mod.LEVELS, "softening": mod.SOFTENINGS}
        check(values == grid[axis][:len(values)]
              and (axis == "velocity" or len(values) == len(grid[axis])),
              f"crash sweep {axis}: values {values}")
        for r in sweeps[axis]["sweep"]:
            run = r["crash"]["tick"] if r["crash"] else full
            q = (mod.level_quantizer(r["levels"]) if axis == "quantization"
                 else "float32")
            force_evals(counts, n, 1 + run, q, True)
            runs += 1
    return runs


def probe_launches(module: str, argv: list, rep: dict, extra=None) -> tuple:
    """The kernel launches one probe's run must make, and the derivation
    as text: N, ticks and modes from the probe's own parser for argv, its
    size rules (suite_sizes, sweep_plan) and its constants. Three counts
    depend on the device's speed, since their loops run for a set time:
    the hardware leak's workloads and the red team's entropy drift, read
    from the report's iteration and sample counts; and one on where a run
    crashed: the crash sweeps' ticks (from the report's crash ticks; the
    stress test's boundary scan runs the same four sweeps, ``extra``, the
    crash probe's report). The observer-effect loops run a set number of
    ticks. No probe takes an energy past hn.TILED_MIN_N, so pair_pe_rows
    launches 0 times; the dense force (precision wall, quantum chaos,
    the multiverse) and the float64 baseline launch nothing."""
    import importlib
    import inspect

    from nbody_tpu_torch.experiments import _common
    from nbody_tpu_torch.ops import hopper_nbody as hn

    counts = {k: 0 for k in hn.LAUNCHES}
    mod = importlib.import_module(f"nbody_tpu_torch.experiments.{module}")
    observer = inspect.signature(_common.observer_effect_rates).parameters
    chunk, repeats = (observer[k].default for k in ("chunk", "repeats"))

    def observed(n, ticks):   # observer_effect_rates: 2 arms x repeats runs
        for _ in range(2 * repeats):
            force_evals(counts, n, 1 + chunk + ticks // chunk * chunk,
                        "float32", True)

    def density_rows(rows, dim):
        for r in rows:
            force_evals(counts, r["num_stars"], 1 + 2 * r["ticks"],
                        "float32" if r["mode"] == "clean_float32"
                        else "int4_sim", True, dim)

    if module == "density_limit_test":
        plan, ticks, dim, _ = mod.sweep_plan(argv)
        device = torch.device(mod.build_parser().parse_args(argv).device)
        plan = plan or (mod.DEFAULT_COUNTS_CARD if device.type == "cuda"
                        else mod.DEFAULT_COUNTS)
        rows = rep["results"]
        for mode in ("clean_float32", "int4_broken"):
            got = [(r["num_stars"], r["ticks"]) for r in rows
                   if r["mode"] == mode]
            want = [(n, mod._ticks_for(n, ticks, device)) for n in plan]
            check(got == want[:len(got)] and (len(got) == len(want)
                                              or rows[-1]["crashed"]),
                  f"density {mode}: rows {got}, planned {want}")
        density_rows(rows, dim)
        text = (f"D={dim} rows (N, ticks) "
                f"{[(r['num_stars'], r['ticks']) for r in rows[:len(plan)]]}"
                f" x float32 and int4: 1 + 2 x ticks evaluations a row "
                f"(set-up, warm-up, timed)")
    elif module == "crash_point_test":
        n, ticks = mod.suite_sizes(argv)
        runs = crash_sweep_evals(counts, mod, n, ticks, rep)
        text = (f"{runs} runs at {n} stars: 1 + the ticks to each crash (or "
                f"{ticks} rounded up to chunks of {mod.CHECK})")
    elif module == "universe_stress_test":
        from nbody_tpu_torch.experiments import crash_point_test as cpt
        s = mod.suite_sizes("--quick" in argv)
        check([mod.dataclasses.asdict(mod.boundary(*b)) for b in (
            ("velocity_multiplier", extra["velocity"], "multiplier"),
            ("dt", extra["dt"], "dt"),
            ("quantization_levels", extra["quantization"], "levels"),
            ("softening", extra["softening"], "softening"))]
              == rep["boundaries"],
              "stress: the boundary scan differs from the crash probe's "
              "sweeps at the same size")
        runs = crash_sweep_evals(counts, cpt, s["stars"], s["ticks"], extra)
        for mode in ("float32", "int4_sim"):
            force_evals(counts, s["stars"], 1 + s["leak_ticks"], mode, True)
        density_rows(rep["density_scaling"], 2)
        text = (f"the crash probe's {runs} sweep runs at {s['stars']}, the "
                f"leak at {s['stars']} x {1 + s['leak_ticks']} float32 and "
                f"int4, the density rows {s['density_counts']} x "
                f"{mod.DENSITY_TICKS} ticks")
    elif module == "hardware_leak_test":
        duration, n = mod.suite_sizes(argv)
        w = rep["workloads"]
        for name, mode in (("float32_standard", "float32"),
                           ("int4_broken", "int4_sim")):
            force_evals(counts, n, 1 + mod.SIM_CHUNK + w[name]["iterations"],
                        mode, True)
        text = (f"{n} stars, 1 + {mod.SIM_CHUNK} (warm) + the report's "
                f"ticks ({w['float32_standard']['iterations']} float32, "
                f"{w['int4_broken']['iterations']} int4, in {duration}s "
                f"each); float64 and the matmul / alloc loops: none")
    elif module == "breakout_tests":
        s = mod.suite_sizes("--quick" in argv)
        observed(s["lazy_stars"], s["lazy_ticks"])
        for _ in range(2 * s["lattice_trials"]):
            force_evals(counts, mod.LATTICE_STARS, 1 + s["lattice_ticks"],
                        "float32", True)
        text = (f"lazy loading {2 * repeats} x {s['lazy_stars']} stars x "
                f"{1 + chunk + s['lazy_ticks']}, lattice "
                f"{2 * s['lattice_trials']} x {mod.LATTICE_STARS} x "
                f"{1 + s['lattice_ticks']}; the wall runs dense")
    elif module == "extreme_mode":
        s = mod.suite_sizes("--quick" in argv)
        n, _ = s["subnormal_hell"]
        hell = len(rep["subnormal_hell"]["rows"])
        force_evals(counts, n, hell * (1 + mod.HELL_CHUNK), "float32", True)
        n, _ = s["infinity_cascade"]
        chunks = len(rep["infinity_cascade"]["contagion"])
        force_evals(counts, n, 1 + mod.CASCADE_WARM + chunks * mod.CHUNK,
                    "float32", True)
        n, ticks = s["precision_massacre"]
        force_evals(counts, n, 2 * (1 + ticks // mod.CHUNK * mod.CHUNK),
                    "float32", True)
        n, ticks = s["singularity_hunt"]
        sing = rep["singularity_hunt"]
        check(not sing["singularity"] or len(sing["rows"]) < 3,
              f"extreme: the singularity's chunk is past the report's "
              f"last three rows: {sing}")
        found = (len(sing["rows"]) if sing["singularity"]
                 else ticks // mod.CHUNK)
        force_evals(counts, n, 1 + found * mod.CHUNK, "float32", True)
        text = (f"subnormal hell {hell} runs x {1 + mod.HELL_CHUNK}, the "
                f"cascade 1 + {mod.CASCADE_WARM} + {chunks} x {mod.CHUNK}, "
                f"the massacre's two twins, the singularity hunt {found} "
                f"chunks; the chaos runs dense")
    elif module == "red_team_proof":
        s = mod.suite_sizes("--quick" in argv)
        n = s["stars"]
        force_evals(counts, n, 2 + mod.JITTER_WARM + s["jitter_ticks"],
                    "float32", True)
        samples = rep["entropy_drift"]["samples"]
        force_evals(counts, n, 1 + samples * mod.ENTROPY_CHUNK, "int4_sim",
                    True)
        observed(n, s["observer_ticks"])
        text = (f"{n} stars: jitter {2 + mod.JITTER_WARM + s['jitter_ticks']}"
                f", the entropy drift's {samples} samples x "
                f"{mod.ENTROPY_CHUNK} int4 (in {s['entropy_s']}s), observer "
                f"{2 * repeats} x {1 + chunk + s['observer_ticks']}; the "
                f"multiverse runs dense")
    elif module == "omega_point_test":
        s = mod.suite_sizes("--quick" in argv)
        for _ in mod.BEKENSTEIN_RADII:
            force_evals(counts, s["bekenstein_stars"],
                        1 + 2 * mod.PROBE_TICKS, "float32", True)
        for _ in range(s["aliasing_dts"]):
            force_evals(counts, s["aliasing_stars"], 1 + mod.PROBE_TICKS,
                        "float32", True)
        force_evals(counts, s["entropy_stars"], 1 + s["entropy_ticks"],
                    "int4_sim", True)
        for prec in mod.PHASE_PRECISIONS:
            for _ in range(2 * len(s["phase_vel_mults"])
                           * len(mod.PHASE_RADII)):
                force_evals(counts, s["phase_stars"], 1 + mod.PROBE_TICKS,
                            prec.value, True)
        text = (f"Bekenstein {len(mod.BEKENSTEIN_RADII)} x "
                f"{s['bekenstein_stars']}, aliasing {s['aliasing_dts']} x "
                f"{s['aliasing_stars']}, the int4 leak {s['entropy_ticks']}"
                f" ticks at {s['entropy_stars']}, the phase scan "
                f"{2 * len(mod.PHASE_PRECISIONS) * len(s['phase_vel_mults']) * len(mod.PHASE_RADII)}"
                f" runs at {s['phase_stars']}")
    else:
        s = mod.suite_sizes("--quick" in argv)
        n, ticks = s["subnormal_singularity"]
        force_evals(counts, n, 1 + ticks // mod.SUBNORMAL_CHUNK
                    * mod.SUBNORMAL_CHUNK, "float32", True)
        n, ticks = s["entropy_horizon"]
        force_evals(counts, n, 1 + ticks // mod.ENTROPY_CHUNK
                    * mod.ENTROPY_CHUNK, "int4_sim", True)
        wall = inspect.signature(mod.spatial_aliasing_test).parameters
        stars, wall_ticks = (wall[k].default for k in ("wall_stars",
                                                       "num_ticks"))
        force_evals(counts, stars + 1, 1 + wall_ticks, "float32", False)
        text = (f"the subnormal run at {s['subnormal_singularity'][0]}, the "
                f"int4 horizon at {n}, the wall {stars} + 1 (unequal "
                f"masses) x {1 + wall_ticks}; the multiverse runs dense")
    return counts, text


def probe_armageddon(dev) -> None:
    """extreme_mode.memory_armageddon at its defaults: its ceiling and
    error, and the reserved memory back where it was."""
    from nbody_tpu_torch.experiments import extreme_mode

    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(dev)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        res = extreme_mode.memory_armageddon(device=dev)
    wall = time.time() - t0
    after = torch.cuda.memory_reserved(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"probes: memory_armageddon: ceiling {res['ceiling_mb']} MB of "
          f"{total / 2 ** 20:.0f} MB, error {res['error']}, in {wall:.2f}s; "
          f"reserved {before / 2 ** 20:.0f} MB before, "
          f"{after / 2 ** 20:.0f} MB after")
    check(res["ceiling_mb"] > 0, "memory_armageddon allocated nothing")
    check(after <= before + ARMAGEDDON_SLACK_MB * 2 ** 20,
          f"memory_armageddon left {(after - before) / 2 ** 20:.0f} MB "
          f"reserved")


def probe_density(dev, tmp: Path, report: dict) -> None:
    """density_limit_test.main at the card's default sweep (D=2, every
    count, float32 and int4, no --quick) and the D=3 row at BIG_N: the
    report, the launches against their derivation, ms a tick and pairs/s
    a row, the fitted exponents and the peak memory."""
    from nbody_tpu_torch.experiments import density_limit_test as dlt
    from nbody_tpu_torch.ops import hopper_nbody as hn

    for argv in ([], DENSITY_D3):
        argv = [*argv, "--device", str(dev), "--output",
                str(tmp / f"density{len(argv)}")]
        reset_counters(hn)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = dlt.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        launches = dict(hn.LAUNCHES)
        fallbacks = hn.bounds_fallbacks(dev)
        check(set(rep) == PROBE_KEYS["density_limit_test"],
              f"density: report keys {sorted(rep)}")
        rows = rep["results"]
        check(not any(r["crashed"] for r in rows),
              f"density: crashed rows {[r for r in rows if r['crashed']]}")
        bad = [p for p in finite_numbers(rows) if not p.endswith("memory_mb")]
        check(not bad, f"density: non-finite numbers at {bad[:5]}")
        want, text = probe_launches("density_limit_test", argv, rep)
        check(launches == want, f"density {argv[:-4]}: launches "
              f"{ {k: v for k, v in launches.items() if v} }, derived "
              f"{ {k: v for k, v in want.items() if v} } ({text})")
        dim = rows[0]["dim"]
        for r in rows:
            print(f"probes: density D={dim} {r['mode']} N={r['num_stars']}: "
                  f"{r['ticks']} ticks, {r['ms_per_tick']:.4f} ms/tick, "
                  f"{r['pairs_per_sec']:.4e} pairs/s, regime "
                  f"{r.get('regime', '-')}")
        for mode, v in rep["scaling"].items():
            ci = v["exponent_ci95"]
            print(f"probes: density D={dim} {mode}: time ~ N^"
                  f"{v['exponent']:.3f}" + (f" +/- {ci:.3f}" if ci else "")
                  + f" ({v['regime_note']})")
        print(f"probes: density D={dim} sweep in {wall:.2f}s, peak "
              f"{peak:.2f} GiB allocated; pruned-pass fallbacks "
              f"{fallbacks}; launches "
              f"{ {k: v for k, v in launches.items() if v} } = derived: "
              f"{text}")
        for k in ("sym_force", "sym_force_uniform", "max_d2",
                  "pair_sym_force", "pair_sym_force_uniform"):
            report[k]["launches"] += launches[k]


def probe_checks(module: str, rep: dict, dev) -> str:
    """tests/test_experiments_smoke.py's verdicts on the card's report,
    and the port's subnormal census (IEEE float32, nothing flushed)."""
    if module == "crash_point_test":
        check(all(len(rep[k]["sweep"]) >= 1 for k in rep),
              "crash: a sweep returned nothing")
        return (f"first crashes: velocity x"
                f"{rep['velocity']['first_crash_multiplier']}, dt "
                f"{rep['dt']['first_crash_dt']}, levels "
                f"{rep['quantization']['first_crash_levels']}, softening "
                f"{rep['softening']['first_crash_softening']}")
    if module == "breakout_tests":
        leak = rep["memory_leak"]
        check((leak["overflow_inf_iter"], leak["underflow_zero_iter"],
               leak["ftz_detected"]) == (128, 150, False),
              f"breakout: memory leak {leak}")
        return (f"inf after 128 doublings, 0 after 150 halvings (no FTZ); "
                f"{rep['verdict']['conclusion']}")
    if module == "reality_glitch_tests":
        alias = rep["spatial_aliasing"]
        check(alias["clip_through"], f"glitch: no clip-through: {alias}")
        return (f"clip-through at tick {alias['crossed_tick']}; "
                f"{rep['subnormal_singularity']['verdict']}")
    if module == "red_team_proof":
        check(rep["platform"] == dev.type and rep["device_kind"]
              == torch.cuda.get_device_name(0), f"red team: {rep['platform']}"
              f" {rep['device_kind']}")
        return (f"RSI {rep['rsi']:.2f}, entropy samples "
                f"{rep['entropy_drift']['samples']}")
    if module == "omega_point_test":
        crit = rep["temporal_aliasing"]["critical_dt"]
        check(crit is None or crit > 0.01, f"omega: critical dt {crit}")
        return (f"critical dt {crit}, probability "
                f"{rep['simulation_probability']:.2f}")
    if module == "extreme_mode":
        return (f"contagion {rep['infinity_cascade']['contagion'][-1]}, "
                f"singularity {rep['singularity_hunt']['singularity']}, "
                f"chaos amplified {rep['quantum_chaos']['chaos_amplified']}")
    if module == "hardware_leak_test":
        a = rep["analysis"]
        return (f"int4 overhead {a['broken_overhead_percent']:+.1f}% "
                f"({a['clean_ticks_per_sec']:.0f} vs "
                f"{a['broken_ticks_per_sec']:.0f} ticks/s)")
    if module == "universe_stress_test":
        return (f"ghost rate "
                f"{rep['energy_leak']['ghost_rate_pct_per_tick']:+.6f}%/tick")
    return f"{len(rep['results'])} rows"


def probe_suites(dev, tmp: Path, report: dict) -> None:
    """The nine probes through the port's run_all.main with --only, one at
    a time at run_all's arguments: each status ok, the report's keys and
    finite numbers, the smoke tests' verdicts, and the launches against
    the derivation; then every SUITES entry imports with a main."""
    from nbody_tpu_torch.experiments import run_all
    from nbody_tpu_torch.ops import hopper_nbody as hn

    args = dict(run_all.SUITES)
    total, crash = 0.0, None
    for module, name in PROBE_REPORTS.items():
        reset_counters(hn)
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = run_all.main(["--device", str(dev), "--only", module,
                                    "--output", str(tmp / "run_all")])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(hn.LAUNCHES)
        check(summary[module]["status"] == "ok",
              f"run_all {module}: {summary[module]['status']}")
        name = name.format(kind=torch.cuda.get_device_name(0).replace(
            " ", "_"))
        rep = json.loads((tmp / "run_all" / module / name).read_text())
        check(set(rep) == PROBE_KEYS[module],
              f"{module}: report keys {sorted(rep)}")
        bad = [p for p in finite_numbers(rep) if p not in PROBE_INF_OK
               and not p.endswith("memory_mb")]
        check(not bad, f"{module}: non-finite numbers at {bad[:5]}")
        verdict = probe_checks(module, rep, dev)
        want, text = probe_launches(module, [*args[module], "--device",
                                             str(dev)], rep, crash)
        check(launches == want, f"{module}: launches "
              f"{ {k: v for k, v in launches.items() if v} }, derived "
              f"{ {k: v for k, v in want.items() if v} } ({text})")
        if module == "crash_point_test":
            crash = rep
        total += wall
        print(f"probes: run_all {module} {' '.join(args[module])}: ok in "
              f"{wall:.2f}s; {verdict}; launches "
              f"{ {k: v for k, v in launches.items() if v} } = derived: "
              f"{text}")
        for k in ("sym_force", "sym_force_uniform", "max_d2"):
            report[k]["launches"] += launches[k]
    print(f"probes: the nine probes through run_all in {total:.2f}s")
    for module, _ in run_all.SUITES:
        check(callable(run_all.suite_module(module).main),
              f"run_all: {module} has no main")
    print(f"probes: all {len(run_all.SUITES)} run_all.SUITES import with a "
          f"main (the eight of phase experiments not run again here)")


def hold_probe_launches(seen: dict, report: dict) -> None:
    """The first launch of each kernel shape the probes made, against its
    plain version: up to BIG_N points by hold_first_launches; sym_force
    past BIG_N (the density sweep's 262144 and 524288's chunks) on
    SAMPLED_ROWS receivers by hold_large's rule, except the 1M sweep's
    chunk shapes, which phase large holds on a 1M D=2 disk; max_d2 past
    BIG_N bitwise its plain version."""
    from nbody_tpu_torch.ops import hopper_nbody as hn

    chunk = hn.sym_chunk_size(LARGE_N, 2)
    large_chunks = {chunk, LARGE_N - (-(-LARGE_N // chunk) - 1) * chunk}
    small = {k: v for k, v in seen.items() if k[1] <= BIG_N}
    hold_first_launches(small, report, "probes")
    gen = torch.Generator().manual_seed(LARGE_SEED)
    for key, inputs in seen.items():
        if key[1] <= BIG_N:
            continue
        if key[0] == "max_d2":
            pos, = inputs
            got, want = hn.max_d2(pos), hn.max_d2_plain(pos)
            check(bitwise(got, want), f"max_d2 at N={key[1]} D={key[2]}: "
                  f"{got.item()} vs its plain version {want.item()}")
            print(f"probes: max_d2 at N={key[1]} D={key[2]} bitwise its "
                  f"plain version ({got.item():.6g})")
            continue
        pos, gm, bounds, q, masked, uniform = inputs
        n = pos.shape[0]
        if key[2] == 2 and n in large_chunks:
            print(f"probes: sym_force at the 1M sweep's chunk N={n} D=2 "
                  f"{q.mode.value}: held in phase large")
            continue
        variant = uniform and n % hn.TILE == 0
        rows = torch.randperm(n, generator=gen)[:SAMPLED_ROWS].to(pos.device)
        got = hn.sym_force(pos, gm, bounds, q, masked, uniform=uniform)
        want = hn.row_force_plain(pos, torch.ones_like(gm) if variant else gm,
                                  bounds, q, masked, rows=rows, block=512)
        if variant:
            want = want * gm[0]
        label = (f"{'sym_force_uniform' if variant else 'sym_force'} N={n} "
                 f"D={key[2]} {q.mode.value} vs plain, {SAMPLED_ROWS} rows")
        err = hold_large(label, got[rows], want, pos, gm, bounds, q, rows,
                         "probes")
        name = "sym_force_uniform" if variant else "sym_force"
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"] or 0.0,
                                          err)


def phase_probes(dev, report: dict) -> None:
    """nbody_tpu_torch.experiments' hardware and glitch probes on the
    card: memory_armageddon at its defaults (its memory released), the
    density sweep at full width, the nine probes through run_all with
    their launches derived, and each kernel shape's first launch against
    its plain version."""
    import logging

    from nbody_tpu_torch.ops import hopper_nbody as hn

    logging.getLogger("nbody_tpu_torch.glitch").setLevel(logging.ERROR)
    probe_armageddon(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with first_launches(hn) as seen:
            t0 = time.time()
            probe_density(dev, tmp, report)
            print(f"probes: the density phase in {time.time() - t0:.2f}s")
            probe_suites(dev, tmp, report)
        hold_probe_launches(seen, report)


# --------------------------------------------------------------------------
# Phase multihost: the ring across processes (parallel/multihost.py)
# --------------------------------------------------------------------------

MULTIHOST_PROCESSES, MULTIHOST_SHARDS = 2, 4   # S = 8 shards of 16384
MULTIHOST_TICKS, MULTIHOST_CHUNKS = 20, 2
MULTIHOST_TIMEOUT = 300   # s, both processes, from their start
MULTIHOST_KEYS = ("energy_total", "drift_pct", "frames_shape", "final_hash",
                  "int4_total", "int4_hash", "rows_total", "rows_hash")
RING_TILES = ("pair_sym_force", "pair_force", "pair_max", "pair_pe_rows")


def ring_launches(counts: dict, n: int, shards: int, evals: int,
                  precision: str, schedule: str = "sym",
                  equal_masses: bool = False, snapshots: int = 0,
                  dim: int = 2, processes: int = 1) -> None:
    """Add the launches of ``evals`` ring force evaluations and
    ``snapshots`` energy passes over n particles on S shards to counts
    (PERF.md section 2's ring formulas): sym, S sym_force and S(S-1)/2
    pair_sym_force an evaluation (k each where the pair tile takes k
    source chunks; the equal-mass variants for equal masses on a layout
    without phantoms at multiples of TILE); rows, S^2 pair_force; an int
    mode, on one controller the single device's pruned pass
    (pruned_launches), across ``processes`` S(S/2+1) pair_max; an energy
    pass, pair_pe_rows for every pair of shards that both hold real rows.
    The float64 baseline's ring launches nothing."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer
    from nbody_tpu_torch.parallel import ring

    b = -(-n // shards)
    real = sum(1 for s in range(shards) if n - s * b > 0)
    counts["pair_pe_rows"] += snapshots * real * real
    if precision == "float64":
        return
    if schedule == "rows":
        counts["pair_force"] += evals * shards * shards
    else:
        check(hn.sym_force_fits(b, dim), f"ring_launches: a shard of {b} "
              f"takes the chunked diagonal")
        uniform = equal_masses and b * shards == n and b % hn.TILE == 0
        k = -(-b // ring._src_chunk_size(b, b, dim))
        counts[hn._variant("sym_force", uniform)] += evals * shards
        counts[hn._variant("pair_sym_force", uniform)] += (
            evals * shards * (shards - 1) // 2 * k)
    if Quantizer.from_string(precision).is_int:
        if processes == 1:
            counts["max_d2"] += evals * pruned_launches(n)
        else:
            counts["pair_max"] += evals * shards * (shards // 2 + 1)


def pruned_launches(n: int) -> int:
    """The max_d2 launches of one pruned bounds pass over n particles:
    the candidates' and the full set's (skipped unless they fall short);
    up to PRUNED_CANDIDATES one, of every particle."""
    from nbody_tpu_torch.ops import hopper_nbody as hn

    return 1 + (n > hn.PRUNED_CANDIDATES)


@contextlib.contextmanager
def first_ring_launches(hn):
    """Record, cloned, the inputs of the first launch of each ring tile
    (pair_sym_force, pair_force, pair_max, pair_pe_rows) at each shape,
    mode and variant the enclosed run makes; the wrappers run as they are
    and count their launches."""
    seen = {}
    wrapped = {name: getattr(hn, name) for name in RING_TILES}

    def recorder(name):
        fn = wrapped[name]

        def record(*args, **kw):
            key = (name, *(tuple(a.shape) if isinstance(a, torch.Tensor)
                           else a for a in args), *sorted(kw.items()))
            if key not in seen:
                seen[key] = (tuple(a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in args), kw)
            return fn(*args, **kw)
        return record

    for name in RING_TILES:
        setattr(hn, name, recorder(name))
    try:
        yield seen
    finally:
        for name, fn in wrapped.items():
            setattr(hn, name, fn)


def hold_ring_launches(seen: dict, report: dict, label: str) -> None:
    """Each launch first_ring_launches recorded, again, against its plain
    version on the same inputs: the force tiles (the rows and the
    reactions of a pair tile each, partial sums) within the kernels
    phase's float rule (Tally), pair_pe_rows within the bound of the
    design it runs, pair_max bitwise."""
    from nbody_tpu_torch.ops import hopper_nbody as hn

    tallies = {k: Tally() for k in ("pair_sym_force",
                                    "pair_sym_force_uniform", "pair_force")}
    pe_worst, shapes = 0.0, set()
    for key, (args, kw) in seen.items():
        name = key[0]
        other = {"pair_sym_force": 2, "pair_pe_rows": 3}.get(name, 1)
        shapes.add((name, args[0].shape[0], args[other].shape[0]))
        if name == "pair_max":
            got, want = hn.pair_max(*args), hn.pair_max_plain(*args)
            check(bitwise(got, want), f"{label}: pair_max at {key[1:3]}: "
                  f"{got.item()!r} vs plain {want.item()!r}")
        elif name == "pair_pe_rows":
            got, want = hn.pair_pe_rows(*args), hn.pair_pe_rows_plain(*args)
            n_i, n_j = args[0].shape[0], args[3].shape[0]
            err = ((got - want).abs() / want.abs()).max().item()
            ratio = err / pe_bound_rtol(n_i, n_j)
            pe_worst = max(pe_worst, ratio)
            entry = report["pair_pe_rows"]
            entry["max_abs_err"] = max(entry["max_abs_err"] or 0.0,
                                       (got - want).abs().max().item())
            check(ratio <= 1.0 and bool(torch.isfinite(got).all()),
                  f"{label}: pair_pe_rows {n_i}x{n_j}: err/bound {ratio:.3f}")
        elif name == "pair_force":
            xi, xj, gmj, q, cfg, lo, hi = args
            got, want = hn.pair_force(*args), hn.pair_force_plain(*args)
            bounds = hn.kernel_bounds(xi, q, cfg, None, lo, hi)
            tallies[name].hold(f"{xi.shape[0]}x{xj.shape[0]} {q.mode.value}",
                               got, want, lazy_pair_scale(
                                   xi, xj, gmj, bounds, q, got, want), q,
                               "tile")
        else:
            pa, ga, pb, gb, bounds, q = args
            uniform = (kw.get("uniform", False) and pa.shape[0] % hn.TILE == 0
                       and pb.shape[0] % hn.TILE == 0)
            plain = (hn.pair_sym_force_uniform_plain if uniform
                     else hn.pair_sym_force_plain)
            rows, cols = hn.pair_sym_force(*args, **kw)
            rw, cw = plain(*args)
            case = f"{pa.shape[0]}x{pb.shape[0]} {q.mode.value}"
            tally = tallies[hn._variant("pair_sym_force", uniform)]
            tally.hold(case + " rows", rows, rw,
                       lazy_pair_scale(pa, pb, gb, bounds, q, rows, rw), q,
                       "tile")
            tally.hold(case + " reactions", cols, cw,
                       lazy_pair_scale(pb, pa, ga, bounds, q, cols, cw), q,
                       "tile")
    for name, tally in tallies.items():
        if tally.cases:
            tally.report(f"{name} at the {label} ring's shapes", report[name])
    print(f"{label}: ring tiles held against their plain versions at "
          f"{len(seen)} first launches ({sorted(shapes)}); pair_max bitwise, "
          f"pair_pe_rows worst err/bound {pe_worst:.4f}")


def multihost_launches(n: int, shards: int, processes: int) -> dict:
    """The kernel launches of multihost_check's parts by part, from their
    sizes, over ``processes`` processes (summed): the float32 history
    (TICKS + 1 evaluations, CHUNKS energy passes, equal masses), the int4
    and rows runs (SHORT_STEPS + 1 evaluations, one energy pass each);
    the agreement launches none."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.parallel.multihost_check import SHORT_STEPS

    want = {}
    for part, evals, mode, schedule, snaps in (
            ("history", MULTIHOST_TICKS + 1, "float32", "sym",
             MULTIHOST_CHUNKS),
            ("int4", SHORT_STEPS + 1, "int4", "sym", 1),
            ("rows", SHORT_STEPS + 1, "float32", "rows", 1)):
        counts = dict.fromkeys(hn.LAUNCHES, 0)
        ring_launches(counts, n, shards, evals, mode, schedule,
                      equal_masses=schedule == "sym", snapshots=snaps,
                      processes=processes)
        want[part] = {k: v for k, v in counts.items() if v}
    want["agreement"] = {}
    return want


def phase_multihost(dev, report: dict) -> None:
    """Two processes of multihost_check on the card (4 virtual shards
    each on cuda:0, gloo over 127.0.0.1: one mesh of S = 8) at 131072
    stars, 20 ticks in 2 chunks, then the same parts on one controller
    (ParticleMesh.virtual(8)) in this process: both processes bitwise
    each other and the one controller in energies and final hashes; their
    launches summed equal to the one controller's and to the ring
    formulas; agreement true and the perturbed view's false on both; each
    tile shape's first launch on the one controller held against its
    plain version; each part's wall, two processes against one, and the
    share in the collectives staged through gloo."""
    from nbody_tpu_torch import _build
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.parallel import multihost_check, ring

    _build.library()   # built here: the processes load it, no second nvcc
    procs, shards = MULTIHOST_PROCESSES, MULTIHOST_PROCESSES * MULTIHOST_SHARDS
    argv = ["--device", str(dev), "--shards-per-process",
            str(MULTIHOST_SHARDS), "--stars", str(BIG_N), "--ticks",
            str(MULTIHOST_TICKS), "--chunks", str(MULTIHOST_CHUNKS)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        results = multihost_check.launch(procs, tmp, argv, MULTIHOST_TIMEOUT)
        spawn_wall = time.time() - t0
    pos, vel, m = multihost_check.make_ics(BIG_N, dev)
    reset_counters(hn)
    with first_launches(hn) as seen, first_ring_launches(hn) as ring_seen:
        one = multihost_check.run_parts(ring.ParticleMesh.virtual(shards, dev),
                                        pos, vel, m, MULTIHOST_TICKS,
                                        MULTIHOST_CHUNKS)
    want = multihost_launches(BIG_N, shards, procs)
    want_one = multihost_launches(BIG_N, shards, 1)
    for pid, r in enumerate(results):
        check(r["multihost_active"] and r["num_processes"] == procs
              and r["global_shards"] == shards
              and r["local_shards"] == MULTIHOST_SHARDS,
              f"multihost: process {pid}'s topology {r}")
        for key in MULTIHOST_KEYS:
            check(r[key] == one[key], f"multihost: process {pid}'s {key} "
                  f"{r[key]} != one controller's {one[key]}")
        check(r["agree"] == {"hash": one["final_hash"], "all_equal": True,
                             "num_processes": procs}
              and r["mismatch"]["all_equal"] is False,
              f"multihost: process {pid}'s agreement {r['agree']}, "
              f"mismatch {r['mismatch']}")
    check(one["int4_finite"] and one["frames_shape"] == [MULTIHOST_CHUNKS,
                                                         BIG_N, 2],
          f"multihost: int4 finite {one['int4_finite']}, frames "
          f"{one['frames_shape']}")
    for part, counts in want.items():
        summed = {}
        for r in results:
            for k, v in r["launches"][part].items():
                summed[k] = summed.get(k, 0) + v
        check(one["launches"][part] == want_one[part] and summed == counts,
              f"multihost: {part} launches, processes {summed}, one "
              f"controller {one['launches'][part]}, the formulas {counts} "
              f"and {want_one[part]} (the one controller's pruned bounds "
              f"pass)")
        for k, v in summed.items():
            report[k]["launches"] += v
    print(f"multihost: {procs} processes x {MULTIHOST_SHARDS} shards on "
          f"{dev} over gloo bitwise the one controller on virtual({shards}) "
          f"at N={BIG_N}, {MULTIHOST_TICKS} ticks in {MULTIHOST_CHUNKS} "
          f"chunks: energies {one['energy_total']}, final hash "
          f"{one['final_hash']}, int4 {one['int4_hash']}, rows "
          f"{one['rows_hash']}; agreement on both, the perturbed view "
          f"refused on both; launches a part {want}, summed over the "
          f"processes and on the one controller")
    for part in one["walls"]:
        two = max(r["walls"][part] for r in results)
        staged = max(r["transport"][part] for r in results)
        print(f"multihost: {part}: {two:.3f}s on 2 processes (of it "
              f"{staged:.3f}s, {staged / two:.1%}, in the collectives "
              f"staged through gloo), {one['walls'][part]:.3f}s on one "
              f"controller")
    print(f"multihost: the two processes' wall, start to exit, "
          f"{spawn_wall:.1f}s (two CUDA contexts share one card: no "
          f"scaling is shown)")
    hold_first_launches(seen, report, "multihost")
    hold_ring_launches(ring_seen, report, "multihost")


# --------------------------------------------------------------------------
# Phase dryrun: nbody_tpu_torch.dryrun (entry and dryrun_multichip)
# --------------------------------------------------------------------------

DRYRUN_SHARDS = 8   # __graft_entry__.dryrun_multichip's default mesh


def dryrun_launches(n_dev: int) -> dict:
    """The kernel launches of dryrun_multichip(n_dev) from its surfaces'
    sizes: the int4 ring tick over 16 n stars (2 evaluations, one energy
    pass, the general tiles: run_steps_sharded's default); the PM
    deposits, one a shard a step in each of the two PM runners, S (steps
    + 2) a chunk in the resident engine, the realtime loop and the
    restored engine (the probe bundle's two); DirectSimulation(mesh=)'s
    int4 history over 16 n + 5 stars (2 ticks in 2 snapshots: 3
    evaluations, 2 energy passes; the float64 arm launches none)."""
    from nbody_tpu_torch.ops import hopper_nbody as hn

    counts = dict.fromkeys(hn.LAUNCHES, 0)
    ring_launches(counts, 16 * n_dev, n_dev, 2, "int4", snapshots=1)
    ring_launches(counts, 16 * n_dev + 5, n_dev, 3, "int4", snapshots=2)
    counts = {k: v for k, v in counts.items() if v}
    counts["pm_deposit"] = (2 * n_dev               # the two PM runners
                            + 2 * n_dev * (2 + 2)   # resident: 2 chunks of 2
                            + 2 * n_dev * (1 + 2)   # realtime: 2 pumps of 1
                            + 2 * (1 + 2))          # restored on 2 shards
    return counts


def phase_dryrun(dev, report: dict) -> None:
    """nbody_tpu_torch.dryrun on the card: entry()'s step at 4096 stars
    (one sym_force launch) and dryrun_multichip(8, "cuda") with JAX's OK
    line, its launches derived from its surfaces' sizes, each tile
    shape's first launch held against its plain version."""
    from nbody_tpu_torch import dryrun
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops import pm

    reset_counters(hn)
    t0 = time.time()
    fn, args = dryrun.entry(str(dev))
    out = fn(*args)
    torch.cuda.synchronize()
    launched = {k: v for k, v in hn.LAUNCHES.items() if v}
    check(launched == {"sym_force": 1} and out.tick == 1
          and bool(torch.isfinite(out.positions).all()),
          f"dryrun: entry's step launched {launched}, tick {out.tick}")
    report["sym_force"]["launches"] += 1
    print(f"dryrun: entry() at {dryrun.ENTRY_STARS} stars: one tick in "
          f"{time.time() - t0:.2f}s (first call), launches {launched}")
    reset_counters(hn)
    tee = Tee(sys.stdout)
    old, sys.stdout = sys.stdout, tee
    t0 = time.time()
    try:
        with first_launches(hn) as seen, first_ring_launches(hn) as ring_seen:
            dryrun.dryrun_multichip(DRYRUN_SHARDS, str(dev))
    finally:
        sys.stdout = old
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(f"dryrun_multichip OK on {DRYRUN_SHARDS} devices" in
          tee.buf.getvalue(), "dryrun: no OK line")
    launched = {k: v for k, v in hn.LAUNCHES.items() if v}
    launched["pm_deposit"] = pm.LAUNCHES["pm_deposit"]
    want = dryrun_launches(DRYRUN_SHARDS)
    check(launched == want, f"dryrun: launches {launched}, expected {want}")
    for k, v in launched.items():
        report[k]["launches"] += v
    print(f"dryrun: dryrun_multichip({DRYRUN_SHARDS}, {str(dev)!r}) in "
          f"{wall:.2f}s; launches {launched}")
    hold_first_launches(seen, report, "dryrun")
    hold_ring_launches(ring_seen, report, "dryrun")


# --------------------------------------------------------------------------
# Phase 21: the kernel fuzz
# --------------------------------------------------------------------------

# The force path's kernels (KERNELS' first eleven), each of which the fuzz
# phase must launch.
FUZZ_KERNELS = tuple(KERNELS)[:11]


def phase_fuzz(dev, report: dict) -> None:
    """nbody_tpu_torch.fuzz on the card at tools/tpu_fuzz.py's defaults
    (40 force and max cases from seed 20260819, 20 mesh cases), then every
    case of fuzz_cases.edge_cases(); one tally a kernel, the phase's
    launches, each force-path kernel launched."""
    from nbody_tpu_torch import fuzz
    from nbody_tpu_torch.diagnostics import fuzz_cases
    from nbody_tpu_torch.ops import hopper_nbody as hn

    reset_counters(hn)
    tallies = tolerance.Tallies()
    t0 = time.time()
    failed = fuzz.run(device=dev, tallies=tallies)
    torch.cuda.synchronize()
    drawn_s = time.time() - t0
    t0 = time.time()
    edges = fuzz_cases.edge_cases()
    for case in edges:
        fuzz.run_case("edge", lambda: fuzz.run_edge_case(case, dev, tallies),
                      tallies, failed)
    torch.cuda.synchronize()
    edge_s = time.time() - t0
    launched = dict(hn.LAUNCHES)
    print(f"fuzz: {fuzz.NUM_CASES} force and max cases and "
          f"{fuzz.MESH_CASES} mesh cases (seed {fuzz.SEED}) in "
          f"{drawn_s:.1f}s; {len(edges)} edge cases in {edge_s:.1f}s; "
          f"{len(failed)} failed")
    for name, t in sorted(tallies.items()):
        print(f"fuzz: {t.line(name)}")
        if name in report:
            e = report[name]
            e.update(max_abs_err=max(e.get("max_abs_err") or 0.0,
                                     t.worst_err[0]),
                     fuzz_cases=t.cases,
                     fuzz_err_over_bound=t.worst_ratio[0],
                     fuzz_launches=launched[name])
    print(f"fuzz: launches {launched}")
    never = [k for k in FUZZ_KERNELS if not launched[k]]
    check(not never, f"fuzz: never launched: {never}")
    check(not failed, "fuzz: failed cases:\n  " + "\n  ".join(failed))


# --------------------------------------------------------------------------
# Extra phase: each kernel against its plain version at the 1M shapes
# --------------------------------------------------------------------------

def phase_scale(dev) -> None:
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops import hopper_nbody as hn
    from nbody_tpu_torch.ops.precision import Quantizer

    cfg = SimConfig()
    for dim in (2, 3):
        pos, _, m = large_ics(dim, dev)
        gm = (cfg.G * m).contiguous()
        for mode in ("float32", "int4"):
            q = Quantizer.from_string(mode)
            bounds = hn.kernel_bounds(pos, q, cfg)
            chunk = hn.sym_chunk_size(LARGE_N, dim)
            pa, pb, ga, gb = (pos[:chunk], pos[chunk:2 * chunk], gm[:chunk],
                              gm[chunk:2 * chunk])
            runs = (
                ("row_force", lambda: hn.row_force(pos, gm, bounds, q,
                                                   False),
                 lambda: hn.row_force_plain(pos, gm, bounds, q, False,
                                            block=512)),
                ("chunked", lambda: hn.sym_accelerations_chunked(
                    pos, m, q, cfg, quantize_forces=False, log_lo=bounds[0],
                    log_hi=bounds[1]), None),
                ("sym_force one chunk", lambda: hn.sym_force(
                    pa, ga, bounds, q, False),
                 lambda: hn.sym_force_plain(pa, ga, bounds, q, False)),
                ("pair_sym_force chunk pair", lambda: hn.pair_sym_force(
                    pa, ga, pb, gb, bounds, q),
                 lambda: hn.pair_sym_force_plain(pa, ga, pb, gb, bounds, q)),
            )
            for name, kernel, plain in runs:
                ms = cuda_ms(kernel, 1)
                # The chunked path's plain version is row_force's.
                plain_ms = (f"{cuda_ms(plain, 1, 0):.3f} ms" if plain
                            else "as row_force")
                print(f"scale: {name} N={LARGE_N} D={dim} {mode} (chunk "
                      f"{chunk}): kernel {ms:.3f} ms, plain {plain_ms}")
        if dim == 3:
            # The self-mask of zero and run-time softening, on the same
            # inputs: its per-pair branch is the only difference.
            q = Quantizer.from_string("float32")
            bounds = hn.kernel_bounds(pos, q, cfg)
            for masked in (False, True):
                ms = cuda_ms(lambda: hn.row_force(pos, gm, bounds, q,
                                                  masked), 1)
                print(f"scale: row_force N={LARGE_N} D=3 float32 "
                      f"self_masked={masked}: kernel {ms:.3f} ms")
        del pos, m, gm
    geom = shell_positions(LARGE_N, dev)
    ms = cuda_ms(lambda: hn.max_d2(geom), 2)
    plain_ms = cuda_ms(lambda: hn.max_d2_plain(geom), 1, 0)
    print(f"scale: max_d2 full set N={LARGE_N} D=3 shell: kernel {ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms")


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


def resident_lines() -> None:
    """The sym kernels' resident warps a SM, D=2, general and equal-mass,
    float32 and int: the T x T grid's tile kernel beside the triangular
    grid's; the one-pass design's, D in {2,3} (every block 64 threads, two
    warps): sym_force's equal-mass and general bodies and, int modes, their
    fused max, the pair tile's general body beside the equal-mass one; the
    register-tiled row_force's and pair_max's (128 threads, four warps);
    then the scratch bytes of the redesigned launches at the paths'
    shapes."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    lib = hn._library()
    for mode, code in (("float32", 0), ("int", hn._MODE_INT)):
        for uniform in (0, 1):
            square, tri = (2 * lib.nbody_sym_force_resident(code, 2, uniform,
                                                            t)
                           for t in (0, 1))
            print(f"build: sym_force {mode} D=2 uniform={uniform}: resident "
                  f"warps a SM: T x T grid {square}, triangular grid {tri}")
        for dim in (2, 3):
            sym, sym_general = (
                2 * lib.nbody_sym_force_one_pass_resident(code, dim, u, 0)
                for u in (1, 0))
            pair, general = (2 * lib.nbody_pair_sym_force_one_pass_resident(
                code, dim, uniform) for uniform in (1, 0))
            rows, masked = (4 * lib.nbody_row_force_tiled_resident(
                code, dim, m) for m in (0, 1))
            fused = ""
            if code == hn._MODE_INT:
                f_uni, f_gen = (
                    2 * lib.nbody_sym_force_one_pass_resident(code, dim, u, 1)
                    for u in (1, 0))
                fused = (f", sym_force_uniform_max {f_uni}, sym_force_max "
                         f"(general) {f_gen}")
                check(f_uni >= 24 and f_gen >= 20,
                      f"one-pass fused max D={dim}: too few resident warps")
            print(f"build: one-pass design {mode} D={dim}: resident warps a "
                  f"SM: sym_force_uniform {sym}, sym_force (general) "
                  f"{sym_general}{fused}, pair_sym_force_uniform "
                  f"{pair}, pair_sym_force (general) {general}")
            print(f"build: row_force register-tiled {mode} D={dim}: resident "
                  f"warps a SM: {rows}, self-masked {masked}")
            check(min(sym, pair) >= 24, f"one-pass {mode} D={dim}: fewer "
                                        f"than 24 resident warps a SM")
            check(min(general, sym_general) >= 20
                  and min(rows, masked) >= 16,
                  f"{mode} D={dim}: a general one-pass body or the "
                  f"register-tiled row_force holds too few warps a SM")
    for dim in (2, 3):
        warps = 4 * lib.nbody_pair_max_tiled_resident(dim)
        grid = hn.pair_max_segments(BIG_N, BIG_N)
        print(f"build: pair_max register-tiled D={dim}: resident warps a SM "
              f"{warps}; grid at {BIG_N}^2 {grid} (segments, tiles a "
              f"segment)")
        check(warps >= 32, f"pair_max D={dim}: fewer than 32 resident warps")
        mx, pe = (4 * lib.nbody_max_d2_tiled_resident(dim),
                  4 * lib.nbody_pair_pe_tiled_resident(dim))
        print(f"build: max_d2 register-tiled D={dim}: resident warps a SM "
              f"{mx} (grid {hn.max_d2_tiled_blocks(torch.device('cuda', 0))}"
              f" blocks); pair_pe_rows register-tiled D={dim}: resident "
              f"warps a SM {pe}; grid at {BIG_N}^2 "
              f"{hn.pe_segments(BIG_N, BIG_N)} (segments, tiles a segment)")
        check(mx >= 32 and pe >= 32, f"max_d2 / pair_pe_rows D={dim}: fewer "
                                     f"than 32 resident warps")
    for dim, n in ((2, hn.sym_chunk_size(LARGE_N, 2)),
                   (3, hn.sym_chunk_size(LARGE_N, 3))):
        one = sum(4 * math.prod(x) for x in hn.pair_one_pass_scratch(n, n,
                                                                     dim))
        print(f"build: pair_sym_force {n}x{n} D={dim} scratch: one-pass "
              f"{one} B, two-pass (the chunk rule's reckoning) "
              f"{hn.pair_sym_force_scratch_bytes(n, n, dim)} B")
    for n in (BIG_N, LARGE_N):
        for dim in (2, 3):
            print(f"build: row_force {n}x{n} D={dim}: {hn.row_segments(n, n)} "
                  f"(segments, tiles a segment), scratch "
                  f"{hn.row_scratch_bytes(n, n, dim)} B (budget "
                  f"{hn.SCRATCH_BUDGET} B)")


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
    from nbody_tpu_torch import _build

    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    print(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    _build.library()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} in "
          f"{time.time() - t0:.1f}s")
    entry, spilled = "", []
    for line in _build.BUILD_LOG.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            print(f"build: {line.strip()}")
        if "Compiling entry function" in line:
            entry = line
        if (("one_pass" in entry or "row_tiled" in entry
             or "pair_max_tiled" in entry or "max_d2_tiled" in entry
             or "pair_pe_tiled" in entry) and "spill" in line
                and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores")):
            spilled.append(f"{entry.strip()}: {line.strip()}")

    report = {k: {"name": k, "route": "cuda", **v, "launches": 0,
                  "max_abs_err": None, "ms": None, "plain_ms": None,
                  "bound_ms": None, "bound_by": None, "library_ms": None}
              for k, v in KERNELS.items()}
    try:
        resident_lines()
        check(not spilled, "the one-pass design or a register-tiled "
              "kernel spills:\n  " + "\n  ".join(spilled))
        for phase in phases:
            # Each phase starts with the allocator's cache handed back: a
            # CUDA-graph capture (the ring's graph ticks) cannot use the
            # blocks that an earlier phase left cached.
            torch.cuda.empty_cache()
            t = time.time()
            if phase == "kernels":
                phase_kernels(dev, report)
            elif phase == "main":
                phase_main(dev, report)
            elif phase == "gate":
                phase_gate(dev)
            elif phase == "perf":
                phase_perf(dev, report)
            elif phase == "large":
                phase_large(dev, report)
            elif phase == "bench":
                phase_bench(dev, report)
            elif phase == "ring":
                phase_ring(dev, report)
            elif phase == "cached":
                phase_cached(dev, report)
            elif phase == "lab":
                phase_lab(dev, report)
            elif phase == "lab_r4":
                phase_lab_r4(dev, report)
            elif phase == "lab_r5":
                phase_lab_r5(dev, report)
            elif phase == "pm":
                phase_pm(dev, report)
            elif phase == "pm_mesh":
                phase_pm_mesh(dev, report)
            elif phase == "ultimate":
                phase_ultimate(dev, report)
            elif phase == "realtime":
                phase_realtime(dev, report)
            elif phase == "experiments":
                phase_experiments(dev, report)
            elif phase == "probes":
                phase_probes(dev, report)
            elif phase == "multihost":
                phase_multihost(dev, report)
            elif phase == "dryrun":
                phase_dryrun(dev, report)
            elif phase == "fuzz":
                phase_fuzz(dev, report)
            elif phase == "profile":
                phase_profile(dev, args.profile_out)
            elif phase == "scale":
                phase_scale(dev)
            torch.cuda.synchronize()
            print(f"phase {phase}: ok in {time.time() - t:.1f}s; card "
                  f"(SM clock, max, power, temperature, throttle): "
                  f"{card_state()}")
        if set(PHASES) <= set(phases):
            never = [k for k, v in report.items() if not v["launches"]]
            check(not never, f"never launched on a path: {never}")
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
