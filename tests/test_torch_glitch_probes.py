"""nbody_tpu_torch.experiments' glitch probes against nbody_tpu.experiments,
on the CPU: breakout_tests, extreme_mode, red_team_proof,
omega_point_test and reality_glitch_tests.

* Host functions are held exactly: ``count_extreme_values``' NaN / Inf /
  zero counts, ``compute_rsi``, ``compare_rsi_files``' verdict,
  ``triple_point_hunter``, ``generate_physical_comparison``.
* Subnormals, a deliberate difference: XLA on the CPU flushes them (the
  JAX package's halving loop stops at 127, its 1e-40 injection gives
  zeros and its census sees none); PyTorch keeps IEEE float32 subnormals
  (150 halvings, 2 x 10 injected denormals, the census counts them). Each
  test asserts both sides' numbers, not a tolerance between them.
* The probes run on the same numpy ICs on both sides (each module's
  ``create_disk_galaxy`` patched to JAX's disk for the seed asked for);
  N is at most 200 (the 50-star wall) and runs at most 60 ticks.
* Tolerances: the two-body precision wall's separations at rtol 1e-6;
  float32 energy drifts (relative) within 2e-5 (two energies at rtol
  1e-5) where the run is not chaotic (drift < 1%), and the stability
  verdicts equal; the massacre's divergences at rtol 1e-5; one chaos step
  at 1e-5 of max|x|; the multiverse's fp16 divergence within a factor 2
  (it is float16 rounding noise grown over the run; the reversed-sum
  divergence is rounding noise itself, held to be finite). JAX's massacre
  ladder is held bit for bit op by op (jit off); under jit XLA on the CPU
  contracts its last multiply-add into an FMA, within one rounding at the
  grid's span of the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.diagnostics.glitch import count_subnormals as jcount
from nbody_tpu.experiments import breakout_tests as jb
from nbody_tpu.experiments import extreme_mode as jem
from nbody_tpu.experiments import omega_point_test as jo
from nbody_tpu.experiments import reality_glitch_tests as jr
from nbody_tpu.experiments import red_team_proof as jrt
from nbody_tpu.models import galaxy as jg
from nbody_tpu.models.direct import DirectSimulation as JSim
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics.glitch import count_subnormals
from nbody_tpu_torch.experiments import breakout_tests as tb
from nbody_tpu_torch.experiments import extreme_mode as tem
from nbody_tpu_torch.experiments import omega_point_test as to
from nbody_tpu_torch.experiments import reality_glitch_tests as tr
from nbody_tpu_torch.experiments import red_team_proof as trt
from nbody_tpu_torch.models.direct import DirectSimulation as TSim
from nbody_tpu_torch.ops.precision import Precision as TPrecision
from nbody_tpu_torch.ops.precision import Quantizer as TQuantizer

torch.set_num_threads(1)

DRIFT = 2e-5   # relative drift: two float32 energies at rtol 1e-5
CHAOTIC = 1e-2  # a drift past this is a chaotic run: verdicts only
PAIRS = ((jb, tb), (jem, tem), (jo, to), (jr, tr), (jrt, trt))


def disk(seed: int, n: int, **kw):
    return tuple(np.array(a) for a in jg.create_disk_galaxy(
        jax.random.PRNGKey(seed), num_stars=n, **kw))


def key_seed(key) -> int:
    if isinstance(key, torch.Generator):
        return key.initial_seed()
    return int(np.asarray(key)[-1])


@pytest.fixture
def shared_disk(monkeypatch):
    """Patch every probe module's create_disk_galaxy to JAX's disk of the
    seed asked for, at ``n`` stars when the test sets one (else the size
    asked for)."""
    size = {}
    for jmod, tmod in PAIRS:
        for mod, wrap in ((jmod, jnp.asarray), (tmod, torch.from_numpy)):
            def fake(key, num_stars=None, _wrap=wrap, **kw):
                n = size.get("n", kw.pop("num_stars", num_stars))
                kw.pop("num_stars", None)
                return tuple(_wrap(a) for a in disk(key_seed(key), n, **kw))

            monkeypatch.setattr(mod, "create_disk_galaxy", fake)
    return size


class JitRecorder:
    """Stands for ``jax`` in a JAX module: records what the module jits,
    and jits it."""

    def __init__(self):
        self.fns = []
        self.random = jax.random

    def jit(self, fn=None, **kw):
        self.fns.append(fn)
        return jax.jit(fn, **kw)


# --------------------------------------------------------------------------
# breakout_tests
# --------------------------------------------------------------------------

def test_precision_wall_matches_jax():
    want = jb.precision_wall_test(60)
    got = tb.precision_wall_test(60, device="cpu")
    assert got["min_separation"] == pytest.approx(want["min_separation"],
                                                  rel=1e-6)
    assert got["delta_cv"] == pytest.approx(want["delta_cv"], rel=1e-3)
    assert got["rhythmic_jitter"] == want["rhythmic_jitter"]


def test_memory_leak_keeps_subnormals_where_jax_flushes():
    """The deliberate difference: 128 doublings to inf on both sides;
    halvings to 0: 150 in the port (IEEE subnormals kept), 127 in JAX on
    the CPU (flushed)."""
    want = jb.memory_leak_test()
    got = tb.memory_leak_test(device="cpu")
    assert got["overflow_inf_iter"] == want["overflow_inf_iter"] == 128
    assert got["underflow_zero_iter"] == 150
    assert want["underflow_zero_iter"] == 127
    assert (got["ftz_detected"], want["ftz_detected"]) == (False, True)
    assert (got["precision_cascade_drift_iter"]
            == want["precision_cascade_drift_iter"])
    assert (got["precision_cascade_final_drift"]
            == want["precision_cascade_final_drift"])


def test_lattice_symmetry_matches_jax(shared_disk):
    want = jb.lattice_symmetry_test(trials=2, num_ticks=20, seed=42)
    got = tb.lattice_symmetry_test(trials=2, num_ticks=20, seed=42,
                                   device="cpu")
    assert set(got) == set(want)
    for k in ("axis_mean", "diag_mean"):
        assert abs(got[k] - want[k]) <= DRIFT, k


def test_breakout_main_writes_jax_report(tmp_path, monkeypatch):
    monkeypatch.setattr(tb, "suite_sizes", lambda quick: {
        "wall_ticks": 40, "lazy_stars": 64, "lazy_ticks": 20,
        "lattice_trials": 2, "lattice_ticks": 10})
    rep = tb.main(["--device", "cpu", "--quick", "--output",
                   str(tmp_path)])
    disk_rep = json.loads((tmp_path / "breakout_results.json").read_text())
    assert set(disk_rep) == {"precision_wall", "lazy_loading",
                             "lattice_symmetry", "memory_leak", "verdict"}
    assert disk_rep["memory_leak"]["underflow_zero_iter"] == 150
    assert rep["verdict"]["evidence_count"] == sum([
        rep["precision_wall"]["rhythmic_jitter"],
        rep["lazy_loading"]["observer_effect"],
        rep["lattice_symmetry"]["anisotropic"], False])


# --------------------------------------------------------------------------
# extreme_mode
# --------------------------------------------------------------------------

def test_count_extreme_values_counts_ieee_subnormals():
    """tests/test_experiments_smoke.py's census case, and an array with
    subnormals: the NaN / Inf / zero counts equal JAX's; the port counts
    the two subnormals, JAX on the CPU none (flushed)."""
    arr = np.array([1.0, np.inf, -np.inf, np.nan, 0.0, 1e-40, -3e-42,
                    1.2e-38, 2e-38], np.float32)
    want = jem.count_extreme_values(arr)
    got = tem.count_extreme_values(torch.from_numpy(arr))
    for k in ("nan", "inf", "zero"):
        assert got[k] == want[k], k
    assert (got["nan"], got["inf"], got["zero"]) == (1, 2, 1)
    assert got["subnormal"] == 2 and want["subnormal"] == 0
    assert got["min_nonzero"] == float(np.float32(3e-42))
    assert want["min_nonzero"] == float(np.float32(1.2e-38))
    normal = np.array([0.5, -2.0, 0.0, 3e-30], np.float32)
    assert tem.count_extreme_values(normal) == jem.count_extreme_values(
        normal)


def test_massacre_ladder_matches_jax(monkeypatch, shared_disk):
    shared_disk["n"] = 64
    rec = JitRecorder()
    monkeypatch.setattr(jem, "jax", rec)
    want = jem.precision_massacre(64, 30, 1)
    got = tem.precision_massacre(64, 30, 1, device="cpu")
    np.testing.assert_allclose(got["divergence"], want["divergence"],
                               rtol=1e-5)
    assert got["diverged"] == want["diverged"]
    jax_ladder, = rec.fns
    x = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32) * 7
    mine = tem.ladder(torch.from_numpy(x)).numpy()
    with jax.disable_jit():
        theirs = np.asarray(jax_ladder(jnp.asarray(x)))
    assert np.array_equal(mine.view(np.int32), theirs.view(np.int32))
    fused = np.asarray(jax.jit(jax_ladder)(x))
    assert np.abs(mine - fused).max() <= np.spacing(np.ptp(mine))


def test_chaos_step_matches_jax(monkeypatch, shared_disk):
    shared_disk["n"] = 64
    rec = JitRecorder()
    monkeypatch.setattr(jem, "jax", rec)
    want = jem.quantum_chaos(64, 40, 1)
    got = tem.quantum_chaos(64, 40, 1, device="cpu")
    assert len(got["divergence"]) == len(want["divergence"]) == 2
    assert got["chaos_amplified"] == want["chaos_amplified"]
    jax_step, = rec.fns
    pos, vel, m = disk(2, 64)
    sim = TSim(pos, vel, m, force_impl="dense", device="cpu")
    acc = sim.state.accelerations.numpy()
    perm = np.random.default_rng(3).permutation(64)
    theirs = jax.jit(jax_step)(*(jnp.asarray(a)
                                 for a in (pos, vel, acc, m, perm)))
    mine = tem.chaos_step(*(torch.from_numpy(a) for a in (pos, vel, acc, m)),
                          torch.from_numpy(perm),
                          TQuantizer(TPrecision.FLOAT32), SimConfig())
    for g, w in zip(mine, theirs):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("probe,ticks", [("subnormal_hell", 60),
                                         ("infinity_cascade", 80),
                                         ("singularity_hunt", 30)])
def test_census_probes_match_jax(shared_disk, probe, ticks):
    shared_disk["n"] = 64
    want = getattr(jem, probe)(64, ticks, 1)
    got = getattr(tem, probe)(64, ticks, 1, device="cpu")
    assert set(got) == set(want)
    if probe == "subnormal_hell":
        assert len(got["rows"]) == len(want["rows"])
        for g, w in zip(got["rows"], want["rows"]):
            assert g["softening"] == w["softening"]
            assert {k: g[k] for k in ("nan", "inf", "subnormal", "zero")} \
                == {k: w[k] for k in ("nan", "inf", "subnormal", "zero")}
            assert g["min_nonzero"] == pytest.approx(w["min_nonzero"],
                                                     rel=1e-3)
        assert got["survived"] == want["survived"]
    else:
        assert got == want


def test_memory_armageddon_on_the_cpu():
    want = jem.memory_armageddon(step_mb=1, max_steps=3)
    got = tem.memory_armageddon(step_mb=1, max_steps=3, device="cpu")
    assert got == want == {"ceiling_mb": 3, "error": None}


def test_extreme_main_writes_jax_report(tmp_path, monkeypatch):
    assert tem.suite_sizes(True)["infinity_cascade"] == (200, 200)
    assert tem.suite_sizes(False)["quantum_chaos"] == (200, 300)
    monkeypatch.setattr(tem, "suite_sizes", lambda quick: dict.fromkeys(
        tem.PROBES, (64, 60)))
    rep = tem.main(["--device", "cpu", "--quick", "--skip-oom", "--output",
                    str(tmp_path)])
    disk_rep = json.loads((tmp_path / "extreme_mode_report.json")
                          .read_text())
    assert list(disk_rep) == ["subnormal_hell", "infinity_cascade",
                              "precision_massacre", "singularity_hunt",
                              "quantum_chaos"]
    assert rep["infinity_cascade"]["universal_contagion"]


# --------------------------------------------------------------------------
# red_team_proof
# --------------------------------------------------------------------------

RSI_CASES = [({"cv": 0.1}, {"final_divergence": 1e-6}, {"drift": 0.01},
              {"slowdown_percent": 2.0}),
             ({"cv": 1.7}, {"final_divergence": 0.5}, {"drift": -3.0},
              {"slowdown_percent": -12.0}),
             ({"cv": 0.0}, {"final_divergence": 4e-4}, {"drift": 0.4},
              {"slowdown_percent": 250.0})]


@pytest.mark.parametrize("case", range(len(RSI_CASES)))
def test_compute_rsi_equals_jax(case):
    assert trt.compute_rsi(*RSI_CASES[case]) == jrt.compute_rsi(
        *RSI_CASES[case])
    if case == 0:   # tests/test_experiments_smoke.py's case
        assert 80 < trt.compute_rsi(*RSI_CASES[0]) <= 100


@pytest.mark.parametrize("lyap", [(0.031, 0.030), (0.031, 0.05), (0.0, 0.0)])
def test_compare_rsi_files_equals_jax(tmp_path, capsys, lyap):
    paths = []
    for kind, la in zip(("NVIDIA H100 80GB HBM3", "cpu"), lyap):
        p = tmp_path / f"{kind[:3]}.json"
        p.write_text(json.dumps({"device_kind": kind, "rsi": 71.25,
                                 "divergence": {"lyapunov": la}}))
        paths.append(str(p))
    jrt.compare_rsi_files(*paths)
    want = capsys.readouterr().out
    trt.compare_rsi_files(*paths)
    assert capsys.readouterr().out == want


def test_rsi_divergence_matches_jax(shared_disk):
    shared_disk["n"] = 64
    want = jrt.divergence_test(64, 40, 1)
    got = trt.divergence_test(64, 40, 1, device="cpu")
    assert set(got) == set(want)
    assert got["above_hbar"] == want["above_hbar"]
    for k in ("heisenberg_product", "lyapunov", "final_divergence"):
        assert np.isfinite(got[k])


def test_red_team_main_writes_jax_report(tmp_path, monkeypatch,
                                         shared_disk):
    shared_disk["n"] = 64
    monkeypatch.setattr(trt, "suite_sizes", lambda quick: {
        "stars": 64, "jitter_ticks": 10, "divergence_stars": 64,
        "divergence_ticks": 20, "entropy_s": 0.05, "observer_ticks": 20})
    rep = trt.main(["--device", "cpu", "--quick", "--output",
                    str(tmp_path)])
    disk_rep = json.loads((tmp_path / "rsi_cpu.json").read_text())
    assert set(disk_rep) == {"platform", "device_kind", "temporal_jitter",
                             "divergence", "entropy_drift",
                             "observer_effect", "rsi", "sha256"}
    assert (disk_rep["platform"], disk_rep["device_kind"]) == ("cpu", "cpu")
    assert rep["entropy_drift"]["samples"] >= 1
    assert 0.0 <= disk_rep["rsi"] <= 100.0


# --------------------------------------------------------------------------
# omega_point_test
# --------------------------------------------------------------------------

def test_temporal_aliasing_matches_jax(shared_disk):
    """tests/test_experiments_smoke.py's omega case at N = 64 on shared
    ICs: the dt grid, each row's verdict and the critical dt equal; the
    drift within DRIFT where the run is not chaotic."""
    shared_disk["n"] = 64
    want = jo.temporal_aliasing_test(quick=True, seed=0)
    got = to.temporal_aliasing_test(quick=True, seed=0, device="cpu")
    assert [r["dt"] for r in got["rows"]] == [r["dt"] for r in want["rows"]]
    assert [r["stable"] for r in got["rows"]] == [
        r["stable"] for r in want["rows"]]
    assert got["critical_dt"] == want["critical_dt"]
    assert got["critical_dt"] is None or got["critical_dt"] > 0.01
    for g, w in zip(got["rows"], want["rows"]):
        if w["drift"] < CHAOTIC:
            assert abs(g["drift"] - w["drift"]) <= DRIFT, w["dt"]


CELLS = [{"precision": "float32", "vel_mult": 1.0, "radius": 10.0,
          "drift": 0.01, "stable": True},
         {"precision": "int4_sim", "vel_mult": 20.0, "radius": 2.0,
          "drift": 5.0, "stable": False},
         {"precision": "int8_sim", "vel_mult": 5.0, "radius": 10.0,
          "drift": 0.2, "stable": True}]


@pytest.mark.parametrize("found", [True, False])
def test_triple_point_and_constants_equal_jax(found):
    bek = {"collapse_density": 150.0 if found else None}
    temporal = {"critical_dt": 0.5 if found else None}
    entropy = {"rate_per_tick": 1e-5 if found else -2e-7}
    phase = {"cells": CELLS if found else [], "unstable_count": int(found)}
    assert to.triple_point_hunter(bek, temporal, phase) == \
        jo.triple_point_hunter(bek, temporal, phase)
    table = to.generate_physical_comparison(bek, temporal, entropy, phase)
    assert table == jo.generate_physical_comparison(bek, temporal, entropy,
                                                    phase)
    assert "Planck time" in table["Time Step (dt)"]["physical_equivalent"]
    assert (to.PRECISION_BITS, to.C_LIGHT, to.PLANCK_TIME, to.PLANCK_LENGTH,
            to.FP32_MIN_SUBNORMAL) == (jo.PRECISION_BITS, jo.C_LIGHT,
                                       jo.PLANCK_TIME, jo.PLANCK_LENGTH,
                                       jo.FP32_MIN_SUBNORMAL)


def test_omega_main_writes_jax_report(tmp_path, monkeypatch, shared_disk):
    shared_disk["n"] = 64
    sizes = to.suite_sizes(True)
    assert (sizes["entropy_ticks"], to.suite_sizes(False)["entropy_ticks"]) \
        == (2000, 50000)
    monkeypatch.setattr(to, "suite_sizes", lambda quick: {
        **sizes, "aliasing_dts": 3, "entropy_ticks": 20})
    monkeypatch.setattr(to, "PROBE_TICKS", 10)
    rep = to.main(["--device", "cpu", "--quick", "--output",
                   str(tmp_path)])
    disk_rep = json.loads((tmp_path / "omega_point_report.json")
                          .read_text())
    assert set(disk_rep) == {"bekenstein", "temporal_aliasing",
                             "entropy_leak", "phase_space", "triple_point",
                             "physical_comparison", "reality_heatmap",
                             "simulation_probability"}
    assert len(rep["phase_space"]["cells"]) == 3 * 2 * 2
    assert len(rep["bekenstein"]["rows"]) == len(to.BEKENSTEIN_RADII) == 6


# --------------------------------------------------------------------------
# reality_glitch_tests
# --------------------------------------------------------------------------

def test_subnormal_injection_is_kept_where_jax_flushes():
    """The 1e-40 injection: 20 float32 subnormals in the port's state,
    none in JAX's on the CPU (flushed to zeros)."""
    pos, vel, m = disk(4, 48)
    tsim = TSim(pos, vel, m, device="cpu")
    tr.inject_subnormals(tsim)
    assert int(count_subnormals(tsim.state.velocities).subnormal_count) \
        == 2 * tr.INJECTED
    jsim = JSim(pos, vel, m)
    flushed = jsim.state.velocities.at[:10].multiply(1e-40)
    assert int(jcount(flushed).subnormal_count) == 0
    assert int((np.asarray(flushed)[:10] == 0).sum()) == 20


def test_subnormal_singularity_matches_jax(shared_disk):
    shared_disk["n"] = 64
    want = jr.subnormal_singularity_test(64, 60, 1)
    got = tr.subnormal_singularity_test(64, 60, 1, device="cpu")
    assert set(got) == set(want)
    assert got["subnormal_counts"] == want["subnormal_counts"] == [0, 0, 0]
    assert got["ftz_detected"] == want["ftz_detected"]
    assert "TPU" not in got["verdict"]


def test_multiverse_divergence_matches_jax(shared_disk):
    shared_disk["n"] = 64
    want = jr.multiverse_divergence_test(64, 40, 1)
    got = tr.multiverse_divergence_test(64, 40, 1, device="cpu")
    assert set(got) == set(want)
    assert got["ticks"] == want["ticks"] == [10, 20, 30, 40]
    for g, w in zip(got["divergence_fp16"], want["divergence_fp16"]):
        assert 0.5 * w <= g <= 2.0 * w
    assert all(np.isfinite(got["divergence_reversed"]))


def test_spatial_aliasing_on_jax_wall(monkeypatch):
    """tests/test_experiments_smoke.py's aliasing case on JAX's wall."""
    wall = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (50,))
                      * 20.0 - 10.0)
    monkeypatch.setattr(tr, "wall_heights",
                        lambda n: torch.from_numpy(wall[:n].copy()))
    want = jr.spatial_aliasing_test(wall_stars=50, num_ticks=20)
    got = tr.spatial_aliasing_test(wall_stars=50, num_ticks=20,
                                   device="cpu")
    assert got["clip_through"] and want["clip_through"]
    assert got["crossed_tick"] == want["crossed_tick"]
    assert got["sampled_inside_wall"] == want["sampled_inside_wall"]
    assert got["min_approach"] == pytest.approx(want["min_approach"],
                                                rel=1e-5)


def test_entropy_horizon_runs_its_chunks(shared_disk):
    shared_disk["n"] = 64
    want = jr.entropy_horizon_test(64, 100, 1)
    got = tr.entropy_horizon_test(64, 100, 1, device="cpu")
    assert [r["tick"] for r in got["rows"]] == [
        r["tick"] for r in want["rows"]] == [50, 100]
    assert np.isfinite(got["bits_per_float_drift"])


def test_dashboard_without_matplotlib_says_so(monkeypatch, capsys):
    monkeypatch.setattr(tr, "has_matplotlib", lambda: False)
    verdict = tr.run_dashboard(num_stars=48, frames=3, ticks_per_frame=2,
                               device="cpu")
    out = capsys.readouterr().out
    assert out.count("Dashboard skipped: matplotlib is not installed") == 1
    assert verdict["frames"] == 3 and "animation" not in verdict
    assert verdict["max_subnormals"] == 0


def test_glitch_main_writes_jax_report(tmp_path, shared_disk):
    shared_disk["n"] = 48
    rep = tr.main(["--device", "cpu", "--quick", "--output",
                   str(tmp_path)])
    disk_rep = json.loads((tmp_path / "reality_glitch_report.json")
                          .read_text())
    assert set(disk_rep) == {"subnormal_singularity",
                             "multiverse_divergence", "entropy_horizon",
                             "spatial_aliasing"}
    assert rep["spatial_aliasing"]["clip_through"]
    assert tr.suite_sizes(True)["entropy_horizon"] == (350, 200)
