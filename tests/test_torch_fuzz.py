"""The port's kernel fuzz against the JAX package's, on the CPU.

``nbody_tpu_torch.diagnostics.fuzz_cases`` is the port's own copy of the
JAX fuzz harness's draw (``tests/test_fuzz_kernels.py``, imported here by
path as ``tools/tpu_fuzz.py`` imports it). These tests hold that the copy
draws JAX's cases bit for bit, then put the harness's CI cases (its
``SEED`` and ``N_FORCE_CASES``) through the port's counterpart of each
drawn implementation on the CPU, where the wrappers take the kernels'
plain versions, against JAX's own (Pallas in interpret mode, as the
harness runs it) and JAX's dense oracle, under ``nbody_tpu_torch.fuzz``'s
rules (``nbody_tpu_torch.diagnostics.tolerance``):

* float modes: |err| <= 2e-6 + 5e-5 max(|want|, s), s the row's summed
  |terms| (where terms cancel, |want| is far below the rounding of any
  summation order);
* int8 / int4 / custom after quantize_force: at most max(4, 1e-4 x
  components) components off, each by one grid step;
* the max of d^2: bit for bit within the port; against JAX's dense max
  and both its kernels within one ulp (XLA:CPU's FMA contraction);
* against an oracle, every output finite (the JAX harness's rule).

The mesh cases are in tests/test_torch_fuzz_mesh.py. The route-edge tier
(``fuzz_cases.edge_cases``) runs on the card (``chip_smoke.py --phases
fuzz``); here it is held to reach every design of every route function,
and ``fuzz.run_edge_case`` runs each kernel's cases at CPU sizes.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.ops import forces as jforces
from nbody_tpu.ops import pallas_nbody as jpk
from nbody_tpu.ops import precision as jp
from nbody_tpu_torch import fuzz
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import fuzz_cases, tolerance
from nbody_tpu_torch.ops import forces, hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import test_fuzz_kernels as jfz  # noqa: E402  (the JAX harness, by path)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED, N_CASES = jfz.SEED, jfz.N_FORCE_CASES
# (stream, seed) of every case the three JAX tests draw.
STREAMS = ([("force", SEED + i) for i in range(N_CASES)]
           + [("max", SEED * 7 + i) for i in range(N_CASES)]
           + [("mesh", SEED * 13 + i) for i in range(jfz.N_MESH_CASES)])


def _jax_case(seed: int, stream: str) -> tuple:
    """JAX's case and its callers' draws after it, from the same seed."""
    rng = np.random.RandomState(seed)
    case = jfz._draw_case(rng)
    after = {}
    if stream == "force":
        after["custom_levels"] = int(rng.choice([16, 64, 4096]))
    elif stream == "mesh":
        after["shards"] = int(rng.choice([2, 5, 8]))
        after["schedule"] = str(rng.choice(["sym", "rows"]))
    return case, after, rng.random_sample()


@pytest.mark.parametrize("stream,seed", STREAMS,
                         ids=[f"{s}-{k}" for s, k in STREAMS])
def test_draw_case_is_jax_draw_bit_for_bit(stream, seed):
    want, after, next_draw = _jax_case(seed, stream)
    made = {"force": fuzz_cases.force_case, "max": fuzz_cases.max_case,
            "mesh": fuzz_cases.mesh_case}[stream](seed)
    rng = np.random.RandomState(seed)
    got = fuzz_cases.draw_case(rng)
    if stream == "force":
        assert made["custom_levels"] == int(
            rng.choice(fuzz_cases.CUSTOM_LEVELS))
    elif stream == "mesh":
        assert made["shards"] == int(rng.choice(fuzz_cases.MESH_SHARDS))
        assert made["schedule"] == str(
            rng.choice(fuzz_cases.MESH_SCHEDULES))
    assert rng.random_sample() == next_draw
    for case in (got, made):
        for key in ("n", "dim", "softening", "equal_masses", "impl",
                    "block", "block_j"):
            assert case[key] == want[key], key
        assert case["mode"].value == want["mode"].value
        for key in ("pos", "m"):
            assert case[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(case[key], want[key])
    for key, value in after.items():
        assert made[key] == value, key


def _jax_q(case) -> jp.Quantizer:
    return jp.Quantizer(jp.Precision(case["mode"].value),
                        custom_levels=case["custom_levels"])


def _hold(got, want, scale, q, label):
    tally = tolerance.Tally()
    tally.hold(label, torch.as_tensor(np.array(got)),
               torch.as_tensor(np.array(want)), scale, q, "out", finite=True)
    assert not tally.failures, tally.failures


# Past the CI cases, case 30 (pallas_rows, N=300, D=2, float16, softening
# 0) has cancelling terms: JAX's own kernel misses its dense oracle there
# under the harness's raw rtol, and the summed-|terms| rule holds both.
FORCE_CASES = [*range(N_CASES), 30]


@pytest.mark.parametrize("idx", FORCE_CASES)
def test_force_case_matches_jax_and_dense(idx):
    """The port's counterpart of the drawn impl against JAX's impl and
    JAX's dense oracle; the launches against their plain versions as
    fuzz.run holds them (here the wrappers take the plain versions)."""
    case = fuzz_cases.force_case(SEED + idx)
    jcase, _, _ = _jax_case(SEED + idx, "force")
    q, cfg = case["q"], SimConfig(softening=case["softening"])
    jq, jcfg = _jax_q(case), JaxConfig(softening=case["softening"])
    pos, m = fuzz.tensors(case["pos"], case["m"], "cpu")
    gm = cfg.G * m
    bounds = hn.kernel_bounds(pos, q, cfg)
    scale = hn.sym_force_term_scale(pos, gm, bounds, q,
                                    hn._self_masked(cfg, None))
    label = f"case {idx}: {fuzz_cases.label(case)}"
    got = fuzz.counterpart(case["impl"], pos, m, q, cfg)
    jax_got = jfz._force(jcase, jcfg, jq)
    jax_dense = jforces.dense_accelerations(
        jnp.asarray(jcase["pos"]), jnp.asarray(jcase["m"]), jq, jcfg,
        quantize_forces=jq.is_int)
    _hold(got, jax_got, scale, q, label + " vs JAX's impl")
    _hold(got, jax_dense, scale, q, label + " vs JAX's dense")
    tallies = tolerance.Tallies()
    fuzz.run_force_case(SEED + idx, "cpu", tallies)
    assert not tallies.failures(), tallies.failures()


@pytest.mark.parametrize("idx", range(N_CASES))
def test_max_case_matches_jax_bit_for_bit(idx):
    """The port's max_d2 (its plain version here), the pruned pass and
    forces.max_pairwise_dist_sq, bitwise each other (fuzz.hold_max), within
    one ulp of JAX's dense max and both its kernels' (resident and
    streamed) on the same cloud: XLA:CPU contracts d^2 into an FMA in some
    of its programs, so JAX's three differ among themselves by one ulp in
    3 of these 10 cases (ROADMAP Queue 3, "CPU-only")."""
    case = fuzz_cases.max_case(SEED * 7 + idx)
    cfg, jcfg = SimConfig(softening=case["softening"]), \
        JaxConfig(softening=case["softening"])
    pos, _ = fuzz.tensors(case["pos"], case["m"], "cpu")
    jpos = jnp.asarray(case["pos"])
    want = np.float32(jforces.max_pairwise_dist_sq(jpos, jcfg))
    ours = {"max_d2": hn.max_d2(pos) + cfg.softening_sq,
            "pruned": hn.max_pairwise_dist_sq_pruned(pos, cfg),
            "forces": forces.max_pairwise_dist_sq(pos, cfg)}
    theirs = {"dense": want,
              "resident": np.float32(jpk.pallas_max_dist_sq(jpos, jcfg)),
              "streamed": np.float32(
                  jpk.pallas_max_dist_sq_streamed(jpos, jcfg))}
    for name, value in ours.items():
        value = np.float32(value.item())
        for jname, jvalue in theirs.items():
            assert abs(value - jvalue) <= np.spacing(value), (idx, name,
                                                              jname)
            np.testing.assert_allclose(value, jvalue, rtol=fuzz.MAX_RTOL)
    tallies = tolerance.Tallies()
    fuzz.hold_max(tallies, f"max case {idx}", pos, cfg)
    assert not tallies.failures(), tallies.failures()


def _straddling(flips: int) -> tuple:
    """(got, want) of 40 components in [-1, 1]: ``flips`` pairs 2e-5 apart
    across an edge of the int4 grid (steps of 2/15), the rest equal."""
    step = 2.0 / 15
    want = torch.zeros(20, 2)
    want[0, 0], want[0, 1] = -1.0, 1.0
    got = want.clone()
    for k in range(flips):
        edge = -1.0 + (k + 0.5) * step
        want[1 + k, 0], got[1 + k, 0] = edge - 1e-5, edge + 1e-5
    return got, want


@pytest.mark.parametrize("flips,stage,ok", [
    (3, "raw", True), (5, "raw", False), (5, "tile", True),
    (0, "raw", True)])
def test_rules_hold_what_they_state(flips, stage, ok):
    """The float rule admits 2e-5 at a summed-|terms| scale of 1; after
    quantize_force each such pair across a grid edge is one step apart,
    and at most max(4, 1e-4 x 40) may be, except in a tile, which no path
    quantizes by itself."""
    q = tp.Quantizer(tp.Precision.INT4_SIM)
    got, want = _straddling(flips)
    scale = torch.ones_like(want)
    assert tolerance.float_rule(got, want, scale)[0]
    tally = tolerance.Tally()
    assert tally.hold("case", got, want, scale, q, stage) == ok
    assert tally.flips == (0 if stage == "tile" else flips)
    out = tolerance.Tally()
    assert out.hold("case", tp.quantize_force(got, q),
                    tp.quantize_force(want, q), scale, q,
                    "out") == (flips <= 4)


def test_float_rule_scale_and_non_finite_entries():
    """Where terms cancel, the summed |terms| set the bound; inf and NaN
    must be the same in both, and against an oracle (``finite``) not be
    there at all; bitwise treats a NaN as equal to itself."""
    small = torch.tensor([1e-3])
    assert tolerance.float_rule(small + 1e-4, small, torch.tensor([10.0]))[0]
    assert not tolerance.float_rule(small + 1e-4, small, torch.zeros(1))[0]
    want = torch.tensor([1.0, float("inf"), float("nan")])
    scale = torch.zeros(3)
    assert tolerance.float_rule(want.clone(), want, scale)[0]
    assert not tolerance.float_rule(torch.tensor([1.0, 2.0, float("nan")]),
                                    want, scale)[0]
    tally = tolerance.Tally()
    assert tally.hold("plain", want.clone(), want, scale)
    assert not tally.hold("oracle", want.clone(), want, scale, finite=True)
    assert tally.nonfinite == 2 and len(tally.failures) == 1
    assert tolerance.bitwise(want, want.clone())
    assert not tolerance.bitwise(want, torch.tensor([1.0, float("inf"), 0.0]))
    assert tally.hold_rel("pe", torch.tensor([1.0 + 1e-6]),
                          torch.tensor([1.0]), 2e-6, "rows")
    assert not tally.hold_rel("pe", torch.tensor([1e-9]), torch.tensor([0.0]),
                              2e-6, "rows")
    inf = torch.tensor([float("inf")])
    assert tally.hold_rel("pe", inf, inf.clone(), 2e-6, "rows")
    assert not tally.hold_rel("pe", inf, inf.clone(), 2e-6, "energy",
                              finite=True)


@pytest.mark.parametrize("route", sorted(fuzz_cases.ROUTE_DESIGNS))
def test_edge_cases_reach_every_design_of_every_route(route):
    """Each route function's every design is reached by a case, and the
    segments functions' cases stand on both sides of their first split."""
    cases = [c for c in fuzz_cases.edge_cases() if c.route == route]
    assert {c.design for c in cases} == fuzz_cases.ROUTE_DESIGNS[route]
    if route.endswith("segments"):
        fn = getattr(hn, route)
        shapes = {c.shape for c in cases}
        splits = {(s[0], s[-1]) for s in shapes if len(s) == 2} | {
            (s[0], s[0]) for s in shapes if len(s) == 1}
        assert any(fn(a, b)[0] == 1 and fn(a, b + 1)[0] == 2
                   for a, b in splits), splits
        assert fn(fuzz_cases.SEGMENTED, fuzz_cases.SEGMENTED) == (129, 2)


def test_edge_cases_cover_the_kernels_and_the_ladder():
    """Every force-path kernel family, D=2 and 3, every mode, both kinds
    of masses; each case's clouds drawn from its seed, at its shape."""
    cases = fuzz_cases.edge_cases()
    assert {c.kernel for c in cases} == {
        "sym_force", "sym_force_max", "redo", "max_d2", "pruned", "chunked",
        "pair_sym_force", "row_force", "pair_force", "pair_max",
        "pair_pe_rows", "ring", "int_table"}
    assert {c.dim for c in cases} == {2, 3}
    assert {c.mode for c in cases} == set(fuzz_cases.MODES)
    assert {c.equal_masses for c in cases} == {True, False}
    assert len({c.name for c in cases}) == len(cases)
    small = [c for c in cases if c.kernel == "pair_force"][0]
    sets = small.clouds()
    assert [p.shape for p, _ in sets] == [(n, small.dim) for n in small.shape]


def _small(case):
    """An edge case cut to a CPU size (its shape near 300, a chunk of 64,
    a ring of 50-146 points); mode, D, softening, masses and options
    kept."""
    if case.kernel == "ring":
        return dataclasses.replace(case, shape=(case.shape[0] % 97 + 50,
                                                case.shape[1]))
    if case.kernel == "chunked":
        return dataclasses.replace(case, shape=(2 * 64 + 10,),
                                   extra=(("chunk", 64),))
    return dataclasses.replace(
        case, shape=tuple(min(n, 300 + n % 7) for n in case.shape))


@pytest.mark.parametrize("kernel", sorted({c.kernel for c in
                                           fuzz_cases.edge_cases()}))
def test_edge_runner_on_the_cpu(kernel):
    """chip_smoke.py's phase fuzz runs each edge case through
    ``fuzz.run_edge_case``; here at CPU sizes, where every wrapper takes
    its plain version, its every branch holds without a failure."""
    tallies = tolerance.Tallies()
    for case in fuzz_cases.edge_cases():
        if case.kernel == kernel:
            assert fuzz.run_edge_case(_small(case), "cpu",
                                      tallies) == _small(case).name
    assert tallies and not tallies.failures(), tallies.failures()


def test_chip_smoke_holds_kernels_to_the_package_rules():
    """chip_smoke.py states no rule of its own: its float rule, flips
    rule, bitwise, pair_pe_rows bounds and Tally are the tolerance
    module's, and its fuzz phase's kernels are the force path's eleven."""
    import chip_smoke
    for name in ("RTOL", "ATOL", "FLIPS_ALLOWED", "FLIP_RATE", "float_rule",
                 "flips_allowed", "quantized_flips", "bitwise", "pe_rtol",
                 "pe_rtol_tiled", "pe_bound_rtol"):
        assert getattr(chip_smoke, name) is getattr(tolerance, name), name
    assert issubclass(chip_smoke.Tally, tolerance.Tally)
    assert chip_smoke.Tally.hold is tolerance.Tally.hold
    assert chip_smoke.FUZZ_KERNELS == (
        "sym_force", "sym_force_uniform", "sym_force_max",
        "sym_force_uniform_max", "max_d2", "row_force", "pair_sym_force",
        "pair_sym_force_uniform", "pair_force", "pair_max", "pair_pe_rows")


def test_fuzz_cli_on_the_cpu():
    """python -m nbody_tpu_torch.fuzz 4 1 --device cpu exits 0: 4 force
    and max cases and the 20 mesh cases, each printed ok."""
    out = subprocess.run([sys.executable, "-m", "nbody_tpu_torch.fuzz", "4",
                          "1", "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "24/24 fuzz cases pass" in out.stdout
    assert out.stdout.count("  ok   ") == 24
    assert out.stdout.rstrip().endswith("FUZZ: ALL PASS")


def test_fuzz_run_past_the_ci_cases_on_the_cpu():
    """JAX's seed with 60 force and max cases and 20 mesh cases (the CI
    draws 10 and 5): every case holds under the fuzz's rules on the CPU,
    where the harness's raw rtol misses force case 30 and mesh case 18
    on cancelling terms."""
    tallies = tolerance.Tallies()
    assert fuzz.run(60, SEED, 20, "cpu", tallies) == []
    cases = [fuzz_cases.force_case(SEED + i) for i in range(60)]
    uniform = sum(c["equal_masses"] and c["impl"] in (
        "pallas_sym", "pallas_sym_chunked") for c in cases)
    # each case with its static and its run-time softening, and under
    # uniform_gm where it has equal masses and a sym impl
    assert tallies["dense"].cases == 2 * 60 + uniform
    assert tallies["ring"].cases == 20 * 2 * 2   # schedules, run to run


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is here")
def test_fuzz_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fuzz.run(num_cases=1, mesh_cases=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fuzz.main(["1"])
