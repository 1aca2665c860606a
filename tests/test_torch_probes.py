"""nbody_tpu_torch.experiments' hardware probes and run_all against
nbody_tpu.experiments, on the CPU: density_limit_test, crash_point_test,
universe_stress_test, hardware_leak_test and run_all.

* Host functions are held exactly: ``_ticks_for`` under both pair
  budgets (JAX's TPU budget by its backend test, the port's card budget
  by its device), ``analyze_scaling``, ``detect_crash`` (all six classes
  and no crash), the boundary rule, ``analyze_leak``.
* The probes run on the same numpy ICs on both sides: each module's IC
  function (``create_disk_galaxy``, ``create_plummer_sphere``) is patched
  to return JAX's disk or sphere for the seed the probe asked for. N is
  at most 128 and runs at most 60 ticks.
* Tolerances: float32 energies at rtol 1e-5 (tests/test_torch_direct.py),
  so a drift rate (percent a tick) within 2e-3 / ticks; a crash's value
  at rtol 1e-4; the recursive matmul chain at rtol 1e-5. The density
  sweep's rows hold every field but the clock's exactly.
* run_all's SUITES equal JAX's, each resolving to a port module with a
  ``main``; ``--device`` reaches each suite it runs.
* Every probe's ``main`` with ``--device cpu`` writes JAX's report keys,
  and raises without a card when no device is given.
"""

import copy
import dataclasses
import importlib
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.experiments import crash_point_test as jcp
from nbody_tpu.experiments import density_limit_test as jdl
from nbody_tpu.experiments import hardware_leak_test as jhl
from nbody_tpu.experiments import run_all as jra
from nbody_tpu.experiments import universe_stress_test as jus
from nbody_tpu.models import galaxy as jg
from nbody_tpu.config import SimConfig as JSimConfig
from nbody_tpu.ops.precision import Precision as JPrecision
from nbody_tpu.ops.precision import Quantizer as JQuantizer
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.experiments import crash_point_test as tcp
from nbody_tpu_torch.experiments import density_limit_test as tdl
from nbody_tpu_torch.experiments import hardware_leak_test as thl
from nbody_tpu_torch.experiments import run_all as tra
from nbody_tpu_torch.experiments import universe_stress_test as tus
from nbody_tpu_torch.ops.precision import Precision as TPrecision
from nbody_tpu_torch.ops.precision import Quantizer as TQuantizer

torch.set_num_threads(1)

F32_DRIFT = 2e-3   # percent: two float32 energies at rtol 1e-5

PROBES = ("density_limit_test", "crash_point_test", "universe_stress_test",
          "hardware_leak_test", "breakout_tests", "extreme_mode",
          "red_team_proof", "omega_point_test", "reality_glitch_tests")


def key_seed(key) -> int:
    """The seed a probe built its generator from (a torch Generator or a
    JAX PRNGKey)."""
    if isinstance(key, torch.Generator):
        return key.initial_seed()
    return int(np.asarray(key)[-1])


def jax_ics(name: str, seed: int, n: int, **kw):
    return tuple(np.array(a) for a in getattr(jg, name)(
        jax.random.PRNGKey(seed), num_stars=n, **kw))


def share_ics(monkeypatch, *pairs, names=("create_disk_galaxy",)):
    """Make each IC function ``names`` of each (JAX, port) module pair
    return JAX's ICs for the seed and size asked for: jnp arrays on the
    JAX side, tensors on the port's."""
    for name in names:
        for jmod, tmod in pairs:
            for mod, wrap in ((jmod, jnp.asarray), (tmod, torch.from_numpy)):
                def fake(key, num_stars=None, _name=name, _wrap=wrap, **kw):
                    n = kw.pop("num_stars", num_stars)
                    return tuple(_wrap(a) for a in jax_ics(
                        _name, key_seed(key), n, **kw))

                monkeypatch.setattr(mod, name, fake)


# --------------------------------------------------------------------------
# density_limit_test
# --------------------------------------------------------------------------

NS = (1, 32, 1000, 4000, 8000, 16384, 32768, 65536, 131072, 262144,
      524288, 1048576)


@pytest.mark.parametrize("budget", ["host", "card"])
def test_ticks_for_equals_jax(monkeypatch, budget):
    device = "cpu" if budget == "host" else "cuda"
    if budget == "card":
        monkeypatch.setattr(jdl.jax, "default_backend", lambda: "tpu")
    for n in NS:
        for ticks in (5, 50, 1000):
            assert tdl._ticks_for(n, ticks, device) == jdl._ticks_for(
                n, ticks), (n, ticks)
    if budget == "card":
        assert [tdl._ticks_for(n, 1000, device)
                for n in tdl.DEFAULT_COUNTS_CARD] == [
            1000, 1000, 1000, 1000, 558, 139, 34, 8, 5, 5]


def test_default_sweeps_equal_jax():
    assert tdl.DEFAULT_COUNTS == jdl.DEFAULT_COUNTS
    assert tdl.DEFAULT_COUNTS_CARD == jdl.DEFAULT_COUNTS_TPU
    assert tdl.sweep_plan(["--quick"]) == ([100, 250, 500, 1000, 2000], 50,
                                           2, 42)
    assert tdl.sweep_plan(["--dim", "3", "--counts", "131072"]) == (
        [131072], 1000, 3, 42)


CLOCK_FIELDS = {"ms_per_tick", "pairs_per_sec", "peak_memory_mb"}


@pytest.mark.parametrize("dim", [2, 3])
def test_density_sweep_rows_equal_jax(monkeypatch, dim):
    share_ics(monkeypatch, (jdl, tdl),
              names=("create_disk_galaxy", "create_plummer_sphere"))
    want = jdl.run_density_sweep([32, 64], ticks_per_size=20, dim=dim)
    got = tdl.run_density_sweep([32, 64], ticks_per_size=20, dim=dim,
                                device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert ({k: v for k, v in g.items() if k not in CLOCK_FIELDS}
                == {k: v for k, v in w.items() if k not in CLOCK_FIELDS})
        assert g["ms_per_tick"] > 0 and g["pairs_per_sec"] > 0
    assert not any(r["crashed"] for r in got)
    tdl.analyze_scaling(got)


def scaling_rows(times: dict) -> list:
    return [{"mode": mode, "dim": 2, "num_stars": n, "ticks": 5,
             "ms_per_tick": t, "pairs_per_sec": 1.0, "peak_memory_mb": None,
             "power_watts": None, "power_per_star": None,
             "crashed": crashed}
            for mode, rows in times.items() for n, t, crashed in rows]


SCALING_CASES = {
    "compute_bound": {
        "clean_float32": [(1000, 0.05, False), (4000, 0.06, False),
                          (16384, 0.3, False), (65536, 4.1, False),
                          (262144, 61.0, False), (1048576, 1003.0, False)],
        "int4_broken": [(1000, 0.2, False), (16384, 1.1, False),
                        (65536, 9.0, False), (262144, 150.0, False),
                        (1048576, 2600.0, False)]},
    "floor": {
        "clean_float32": [(100, 0.3, False), (250, 0.31, False),
                          (500, 0.33, False), (1000, 0.35, False)],
        "int4_broken": [(100, 0.9, False), (250, 1.0, True)]},
    "super_quadratic": {
        "clean_float32": [(1000, 0.01, False), (4000, 0.5, False),
                          (16384, 40.0, False), (65536, 3000.0, False)]},
}


@pytest.mark.parametrize("case", sorted(SCALING_CASES))
def test_analyze_scaling_equals_jax(case):
    rows = scaling_rows(SCALING_CASES[case])
    mine, theirs = copy.deepcopy(rows), copy.deepcopy(rows)
    assert tdl.analyze_scaling(mine) == jdl.analyze_scaling(theirs)
    assert mine == theirs


def test_density_main_writes_jax_report(tmp_path):
    rep = tdl.main(["--device", "cpu", "--counts", "32,64", "--ticks", "10",
                    "--output", str(tmp_path)])
    disk = json.loads((tmp_path / "density_limit_report.json").read_text())
    assert set(disk) == {"results", "scaling", "telemetry_note"}
    assert disk == json.loads(json.dumps(rep))
    assert [r["num_stars"] for r in disk["results"]] == [32, 64, 32, 64]
    assert all(r["power_watts"] is None for r in disk["results"])


# --------------------------------------------------------------------------
# crash_point_test
# --------------------------------------------------------------------------

def crash_case(kind: str):
    """(positions, velocities, prev_positions, energy, prev_energy) that
    trip one class of detect_crash (or none)."""
    rng = np.random.default_rng(len(kind))
    pos = rng.normal(size=(50, 2)).astype(np.float32) * 10
    vel = rng.normal(size=(50, 2)).astype(np.float32)
    prev, e, e0 = pos - vel * 0.1, -1.0, -1.1
    if kind == "nan":
        vel[7, 1] = np.nan
    elif kind == "inf":
        pos[3, 0] = np.inf
    elif kind == "teleport":
        prev = pos.copy()
        prev[5] += 40.0
    elif kind == "velocity":
        vel[9] = [120.0, 5.0]
        prev = pos - vel * 0.1
    elif kind == "energy":
        e = -250.0
    elif kind == "radius":
        pos[11] = [1500.0, 10.0]
        prev = pos.copy()
    return pos, vel, prev, e, e0


@pytest.mark.parametrize("kind", ["nan", "inf", "teleport", "velocity",
                                  "energy", "radius", "none"])
def test_detect_crash_equals_jax(kind):
    pos, vel, prev, e, e0 = crash_case(kind)
    want = jcp.detect_crash(pos, vel, prev, e, e0, 0.01, 30, 10)
    got = tcp.detect_crash(torch.from_numpy(pos), torch.from_numpy(vel),
                           prev, e, e0, 0.01, 30, 10)
    if kind == "none":
        assert got is None and want is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.parameter == kind


RUNS = [  # (velocity multiplier, SimConfig kwargs, dynamic params)
    (1000, {}, False),             # velocity overflow at the first check
    (90, {"dt": 2.0}, True),       # galaxy explosion at tick 50
    (1, {"softening": 1e-4}, True),  # survives 60 ticks
]


@pytest.mark.parametrize("mult,cfg,dynamic", RUNS)
def test_run_until_crash_matches_jax(mult, cfg, dynamic):
    pos, vel, m = jax_ics("create_disk_galaxy", 1, 64)
    want = jcp._run_until_crash(pos, vel * mult, m,
                                JQuantizer(JPrecision.FLOAT32),
                                JSimConfig(**cfg), 60, dynamic=dynamic)
    got = tcp._run_until_crash(torch.from_numpy(pos),
                               torch.from_numpy(vel) * mult,
                               torch.from_numpy(m),
                               TQuantizer(TPrecision.FLOAT32),
                               SimConfig(**cfg), 60, dynamic=dynamic,
                               device="cpu")
    if want is None:
        assert got is None
        return
    assert (got.crash_type, got.tick) == (want.crash_type, want.tick)
    assert got.value == pytest.approx(want.value, rel=1e-4)


def test_sweep_constants_equal_jax():
    # JAX's sweeps (crash_point_test.py:125, :145, :160, :177)
    assert tcp.VELOCITY_MULTIPLIERS == [1, 2, 5, 10, 20, 50, 100, 200, 500,
                                        1000]
    assert tcp.DTS == [0.001, 0.005, 0.01, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0]
    assert tcp.LEVELS == [1000000, 65536, 4096, 256, 64, 16, 8, 4, 3, 2]
    assert tcp.SOFTENINGS == [1.0, 0.5, 0.1, 0.05, 0.01, 0.005, 0.001, 5e-4,
                              1e-4]
    assert tcp.level_quantizer(1000000) == TQuantizer(TPrecision.FLOAT32)
    assert tcp.level_quantizer(16) == TQuantizer(TPrecision.CUSTOM,
                                                 custom_levels=16)
    assert tcp.suite_sizes(["--quick"]) == (300, 100)
    assert tcp.suite_sizes([]) == (800, 300)


def test_velocity_sweep_matches_jax(monkeypatch):
    """tests/test_experiments_smoke.py's crash-point case, on shared ICs:
    the same sweep, crash by crash."""
    share_ics(monkeypatch, (jcp, tcp))
    want = jcp.find_velocity_crash_point(48, 40, 42)
    got = tcp.find_velocity_crash_point(48, 40, 42, device="cpu")
    assert "sweep" in got and len(got["sweep"]) >= 1
    assert got["first_crash_multiplier"] == want["first_crash_multiplier"]
    assert [r["multiplier"] for r in got["sweep"]] == [
        r["multiplier"] for r in want["sweep"]]
    for g, w in zip(got["sweep"], want["sweep"]):
        assert (g["crash"] is None) == (w["crash"] is None)
        if w["crash"]:
            assert ((g["crash"]["crash_type"], g["crash"]["tick"])
                    == (w["crash"]["crash_type"], w["crash"]["tick"]))


def test_crash_main_writes_jax_report(tmp_path, capsys):
    rep = tcp.main(["--device", "cpu", "--stars", "48", "--ticks", "20",
                    "--output", str(tmp_path)])
    disk = json.loads((tmp_path / "crash_point_report.json").read_text())
    assert set(disk) == {"velocity", "dt", "quantization", "softening"}
    assert len(disk["quantization"]["sweep"]) == len(tcp.LEVELS)
    assert disk["dt"] == json.loads(json.dumps(rep["dt"]))
    assert "CRASH-POINT SUMMARY" in capsys.readouterr().out


# --------------------------------------------------------------------------
# universe_stress_test
# --------------------------------------------------------------------------

SWEEPS = {
    "velocity": {"sweep": [{"multiplier": 1, "crash": None},
                           {"multiplier": 2, "crash": None},
                           {"multiplier": 5, "crash": {
                               "crash_type": "VELOCITY_OVERFLOW"}}],
                 "first_crash_multiplier": 5},
    "dt": {"sweep": [{"dt": 0.001, "crash": {"crash_type": "NaN"}},
                     {"dt": 0.1, "crash": None}],
           "first_crash_dt": 0.001},
    "quantization": {"sweep": [{"levels": 64, "crash": None}],
                     "first_crash_levels": None},
    "softening": {"sweep": [{"softening": 1.0, "crash": None},
                            {"softening": 0.5, "crash": None},
                            {"softening": 0.1, "crash": {
                                "crash_type": "ENERGY_SINGULARITY"}},
                            {"softening": 0.05, "crash": None}],
                  "first_crash_softening": 0.1},
}


def test_boundary_scan_rule_equals_jax(monkeypatch):
    for mod in (jcp, tcp):
        for axis, fn in (("velocity", "find_velocity_crash_point"),
                         ("dt", "find_dt_crash_point"),
                         ("quantization", "find_quantization_crash_point"),
                         ("softening", "find_softening_crash_point")):
            monkeypatch.setattr(mod, fn, lambda *a, _s=SWEEPS[axis]: _s)
    want = [dataclasses.asdict(b) for b in jus.quick_boundary_scan(1, 1, 1)]
    got = [dataclasses.asdict(b)
           for b in tus.quick_boundary_scan(1, 1, 1, device="cpu")]
    assert got == want
    assert got[0]["safe_value"] == 2 and got[1]["safe_value"] is None
    assert got[2]["crash_value"] is None


def test_energy_leak_matches_jax(monkeypatch):
    share_ics(monkeypatch, (jus, tus))
    want = jus.measure_energy_leak(64, 40, 3)
    got = tus.measure_energy_leak(64, 40, 3, device="cpu")
    assert set(got["rates_pct_per_tick"]) == {"float32", "int4_sim"}
    assert abs(got["rates_pct_per_tick"]["float32"]
               - want["rates_pct_per_tick"]["float32"]) <= F32_DRIFT / 40
    assert np.isfinite(got["ghost_rate_pct_per_tick"])


def test_stress_main_writes_jax_report(tmp_path, monkeypatch):
    assert tus.suite_sizes(True)["density_counts"] == [100, 400, 1000]
    small = {"stars": 40, "ticks": 20, "leak_ticks": 20,
             "density_counts": [32, 64]}
    monkeypatch.setattr(tus, "suite_sizes", lambda quick: small)
    rep = tus.main(["--device", "cpu", "--quick", "--output",
                    str(tmp_path)])
    disk = json.loads((tmp_path / "stress_test_report.json").read_text())
    assert set(disk) == {"boundaries", "energy_leak", "density_scaling"}
    assert [b["axis"] for b in disk["boundaries"]] == [
        "velocity_multiplier", "dt", "quantization_levels", "softening"]
    assert len(rep["density_scaling"]) == 4


# --------------------------------------------------------------------------
# hardware_leak_test
# --------------------------------------------------------------------------

LEAK_CASES = {"overhead": (1000.0, 700.0), "noise": (1000.0, 960.0),
              "stalled": (1000.0, 0.0)}


@pytest.mark.parametrize("case", sorted(LEAK_CASES))
def test_analyze_leak_equals_jax(case):
    clean, broken = LEAK_CASES[case]
    results = {"float32_standard": {"iters_per_sec": clean},
               "int4_broken": {"iters_per_sec": broken}}
    want, got = jhl.analyze_leak(results), thl.analyze_leak(results)
    assert set(got) == set(want)
    for k in want:
        if k != "note":
            assert got[k] == want[k], k


class JitRecorder:
    """Stands for ``jax`` in a JAX module: records what the module jits,
    and jits it."""

    def __init__(self):
        self.fns = []
        self.random = jax.random

    def jit(self, fn=None, **kw):
        self.fns.append(fn)
        return jax.jit(fn, **kw)


def test_recursive_chain_matches_jax(monkeypatch):
    rec = JitRecorder()
    monkeypatch.setattr(jhl, "jax", rec)
    jhl._workload_recursive_stress(0.0)
    jax_chain, = rec.fns
    x = np.random.default_rng(5).uniform(0.9, 1.1, (64, 64)).astype(
        np.float32)
    want = np.asarray(jax.jit(jax_chain)(jnp.asarray(x)))
    got = thl.recursive_chain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_leak_main_writes_jax_report(tmp_path):
    rep = thl.main(["--device", "cpu", "--duration", "0.05", "--stars",
                    "64", "--output", str(tmp_path)])
    disk = json.loads((tmp_path / "hardware_leak_report.json").read_text())
    assert set(disk) == {"workloads", "analysis"}
    assert list(disk["workloads"]) == ["idle", "float64_clean",
                                       "float32_standard", "int4_broken",
                                       "recursive_stress", "memory_thrash"]
    for name, w in rep["workloads"].items():
        assert w["power_watts"] is None
        assert w["iterations"] % (thl.SIM_CHUNK if name.endswith(
            ("_clean", "_standard", "_broken")) else 1) == 0
    assert disk["workloads"]["idle"]["iterations"] == 0
    assert thl.suite_sizes(["--quick"]) == (2.0, 400)


# --------------------------------------------------------------------------
# run_all
# --------------------------------------------------------------------------

def test_run_all_suites_equal_jax():
    assert tra.SUITES == jra.SUITES
    assert len(tra.SUITES) == 17
    for name, _ in tra.SUITES:
        mod = tra.suite_module(name)
        assert mod.__name__ == f"nbody_tpu_torch.experiments.{name}"
        assert callable(mod.main)
        assert '"--device"' in inspect.getsource(mod)


def test_run_all_passes_device_and_isolates(tmp_path, monkeypatch):
    seen = {}

    def recorder(name):
        def main(argv):
            seen[name] = argv
        return main

    for name in ("jitter_test", "density_limit_test"):
        monkeypatch.setattr(tra.suite_module(name), "main", recorder(name))

    def broken(argv):
        raise ValueError("boom")

    monkeypatch.setattr(tra.suite_module("breakout_tests"), "main", broken)
    summary = tra.main(["--device", "cpu", "--only",
                        "density_limit_test,jitter_test,breakout_tests",
                        "--output", str(tmp_path)])
    args = dict(tra.SUITES)
    for name in ("jitter_test", "density_limit_test"):
        assert seen[name] == args[name] + ["--output", str(tmp_path / name),
                                           "--device", "cpu"]
        assert summary[name]["status"] == "ok"
    assert summary["breakout_tests"]["status"] == "FAILED: ValueError: boom"
    assert list(summary)[:3] == ["jitter_test", "density_limit_test",
                                 "breakout_tests"]
    disk = json.loads((tmp_path / "run_all_summary.json").read_text())
    assert set(disk) == set(summary)


@pytest.mark.parametrize("name", PROBES + ("run_all",))
def test_main_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would start")
    mod = importlib.import_module(f"nbody_tpu_torch.experiments.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--output", "unused"])
