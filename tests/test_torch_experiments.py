"""nbody_tpu_torch.experiments (the precision-ladder suites) against
nbody_tpu.experiments, on the CPU.

* ``_common``: ``outer_slope``, ``radius_percentile`` and
  ``energy_drift_pct`` equal to JAX's on fixed arrays (host numpy on both
  sides); ``detect_explosion`` gives JAX's verdict on a live, a
  non-finite and an unbound state; ``observer_effect_rates`` returns two
  positive rates.
* The suites run on the same numpy ICs on both sides: passed in where a
  function takes arrays, else with the IC function of each module's
  namespace (``create_disk_galaxy``, ``create_galaxy_with_halo``,
  ``nested_galaxies``) patched to return them. N is 48-256 and runs are
  at most 60 ticks (the bullet cluster 100, in its chunks of 50).
* Tolerances (the rules of tests/test_torch_direct.py): float32 energies
  at rtol 1e-5, so a float32 drift (percent) within 2e-3; float64 within
  1e-4; an int or custom rung's drift within max(10% of JAX's, 5e-5)
  where the port and JAX sum the pairs in different orders (the rung
  amplifies a flipped bin into another trajectory), and its verdicts
  equal; rotation-curve slopes within 1e-3 of the curve's scale;
  float32 jitters at rtol 1e-3 (second differences of positions that
  agree at rtol 1e-4 lose digits to cancellation).
* Host functions are held exactly: ``check_monotonicity``, SPARC's
  ``scale_galaxy_to_simulation`` and ``compute_fit_quality``.
* tests/test_experiments_smoke.py's cases for stability, sensitivity,
  falsification, dark matter, SPARC and jitter, on the port with
  ``--device cpu``; every ``main`` raises without a card when no device
  is given.

The suites' ``test_*`` functions keep their JAX names, so this file
imports the modules, never those names (pytest would collect them).
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.experiments import _common as jc
from nbody_tpu.experiments import dark_matter_test as jdm
from nbody_tpu.experiments import falsification_tests as jf
from nbody_tpu.experiments import jitter_test as jj
from nbody_tpu.experiments import sensitivity_test as js
from nbody_tpu.experiments import sparc_test as jsp
from nbody_tpu.experiments import stability_test as jst
from nbody_tpu.models import galaxy as jg
from nbody_tpu.models.direct import DirectSimulation as JSim
from nbody_tpu.ops.precision import Precision as JPrecision
from nbody_tpu_torch.experiments import _common as tc
from nbody_tpu_torch.experiments import dark_matter_test as tdm
from nbody_tpu_torch.experiments import falsification_tests as tf
from nbody_tpu_torch.experiments import jitter_test as tj
from nbody_tpu_torch.experiments import sensitivity_test as ts
from nbody_tpu_torch.experiments import sparc_test as tsp
from nbody_tpu_torch.experiments import stability_test as tst
from nbody_tpu_torch.models.direct import DirectSimulation as TSim
from nbody_tpu_torch.ops.precision import Precision as TPrecision

torch.set_num_threads(1)

F32_DRIFT = 2e-3   # percent: two float32 energies at rtol 1e-5
F64_DRIFT = 1e-4


def int_drift_tol(want: float) -> float:
    return max(0.1 * abs(want), 5e-5)


def disk(seed: int, n: int, **kw):
    """JAX's disk ICs as numpy."""
    return tuple(np.array(a) for a in jg.create_disk_galaxy(
        jax.random.PRNGKey(seed), num_stars=n, **kw))


def halo(seed: int, n: int, ratio: float):
    return tuple(np.array(a) for a in jg.create_galaxy_with_halo(
        jax.random.PRNGKey(seed), num_stars=n, dm_mass_ratio=ratio))


def patch_ics(monkeypatch, name: str, make, *modules):
    """Make ``name`` in each of the (JAX, port) module pairs return
    ``make(call_index, *args, **kw)`` as numpy arrays: jnp arrays on the
    JAX side, tensors on the port's."""
    for jmod, tmod in modules:
        for mod, wrap in ((jmod, jnp.asarray), (tmod, torch.from_numpy)):
            calls = []

            def fake(*args, _calls=calls, _wrap=wrap, **kw):
                ics = make(len(_calls), *args[1:], **kw)
                _calls.append(args)
                return tuple(_wrap(np.array(a)) for a in ics)

            monkeypatch.setattr(mod, name, fake)


# --------------------------------------------------------------------------
# _common
# --------------------------------------------------------------------------

CURVES = {
    "rising": (np.linspace(0.5, 12.0, 12), np.linspace(0.1, 0.4, 12)),
    "with_nan": (np.linspace(0.5, 12.0, 15),
                 np.r_[np.linspace(0.3, 0.2, 10), np.nan, 0.19, np.nan,
                       0.18, 0.17]),
    "too_few": (np.arange(5.0), np.r_[0.1, np.nan, 0.2, np.nan, 0.3]),
    "keplerian": (np.linspace(1.0, 20.0, 20),
                  1.0 / np.sqrt(np.linspace(1.0, 20.0, 20))),
}


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("as_dict", [False, True])
def test_outer_slope_equals_jax(name, as_dict):
    radii, vels = CURVES[name]
    curve = ({"radii": radii, "velocities": vels} if as_dict else
             tm_curve(radii, vels))
    want = jc.outer_slope({"radii": radii, "velocities": vels})
    assert tc.outer_slope(curve) == want


def tm_curve(radii, vels):
    from nbody_tpu_torch.diagnostics.metrics import RotationCurve
    return RotationCurve(torch.tensor(radii, dtype=torch.float64),
                         torch.tensor(vels, dtype=torch.float64),
                         torch.ones(len(radii), dtype=torch.int32))


@pytest.mark.parametrize("pct", [50.0, 90.0, 99.0])
def test_radius_percentile_and_drift_equal_jax(pct):
    pos = np.random.default_rng(3).normal(size=(301, 2)).astype(np.float32)
    assert (tc.radius_percentile(torch.from_numpy(pos), pct)
            == jc.radius_percentile(pos, pct))
    for e0, e1 in ((-1.5, -1.2), (2.0, 2.5), (1e-12, 3.0), (0.0, 0.0)):
        assert tc.energy_drift_pct(e0, e1) == jc.energy_drift_pct(e0, e1)


@pytest.mark.parametrize("case", ["live", "nan", "unbound", "drift"])
def test_detect_explosion_equals_jax(case):
    pos, vel, m = disk(0, 48)
    jsim, tsim = JSim(pos, vel, m), TSim(pos, vel, m, device="cpu")
    e0 = jsim.get_total_energy()
    assert abs(tsim.get_total_energy() - e0) <= 1e-5 * abs(e0)
    if case == "nan":
        bad = pos.copy()
        bad[3, 0] = np.nan
        jsim, tsim = JSim(bad, vel, m), TSim(bad, vel, m, device="cpu")
    elif case == "unbound":
        jsim, tsim = (JSim(pos, vel * 30.0, m),
                      TSim(pos, vel * 30.0, m, device="cpu"))
    elif case == "drift":
        e0 = e0 / 20.0
    want = jc.detect_explosion(jsim, e0)
    assert tc.detect_explosion(tsim, e0) == want
    assert want == (case != "live")


def test_observer_effect_rates_on_the_cpu():
    free, observed = tc.observer_effect_rates(*disk(0, 64), num_ticks=20,
                                              chunk=10, repeats=1,
                                              device="cpu")
    assert free > 0 and observed > 0


# --------------------------------------------------------------------------
# stability_test
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [m.value for m in tst.MODES])
def test_precision_mode_matches_jax(mode):
    ics = disk(1, 64)
    want = jst.test_precision_mode(*ics, JPrecision(mode), max_ticks=60,
                                   check_interval=20)
    got = tst.test_precision_mode(*ics, TPrecision(mode), max_ticks=60,
                                  check_interval=20, device="cpu")
    assert got.mode == want.mode
    assert (got.stable_ticks, got.exploded) == (want.stable_ticks,
                                                 want.exploded)
    assert got.initial_energy == pytest.approx(want.initial_energy,
                                               rel=1e-5)
    d, w = got.energy_drift_percent, want.energy_drift_percent
    tol = (F64_DRIFT if mode == "float64" else
           int_drift_tol(w) if mode.startswith("int") else F32_DRIFT)
    assert abs(d - w) <= tol, (mode, d, w)


def test_stability_suite_shares_the_threshold_rule(monkeypatch):
    patch_ics(monkeypatch, "create_disk_galaxy",
              lambda i, num_stars, **kw: disk(2, num_stars),
              (jst, tst))
    want, want_thr = jst.run_stability_suite(48, 40)
    got, got_thr = tst.run_stability_suite(48, 40, device="cpu")
    assert got_thr == want_thr
    assert [r.mode for r in got] == [r.mode for r in want]
    assert [r.exploded for r in got] == [r.exploded for r in want]


def test_stability_multi_seed_ci(monkeypatch):
    patch_ics(monkeypatch, "create_disk_galaxy",
              lambda i, num_stars, **kw: disk(10 + i % 2, num_stars),
              (jst, tst))
    monkeypatch.setattr(tst, "MODES", [TPrecision.FLOAT32])
    monkeypatch.setattr(jst, "MODES", [JPrecision.FLOAT32])
    want = jst.run_multi_seed(48, 20, 2, 7)["float32"]
    got = tst.run_multi_seed(48, 20, 2, 7, device="cpu")["float32"]
    assert got.n_samples == want.n_samples == 2
    np.testing.assert_allclose(got.values, want.values, rtol=0,
                               atol=F32_DRIFT)
    assert got.ci_95_low <= got.mean <= got.ci_95_high


# --------------------------------------------------------------------------
# sensitivity_test
# --------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [4, 16, 64, 100000])
def test_run_level_matches_jax(levels):
    ics = disk(3, 96)
    want = js.run_level(*ics, levels, num_ticks=40)
    got = ts.run_level(*ics, levels, num_ticks=40, device="cpu")
    assert (got.bits, got.levels, got.label) == (want.bits, want.levels,
                                                 want.label)
    tol = F32_DRIFT if levels >= 10000 else int_drift_tol(
        want.energy_drift_pct)
    assert abs(got.energy_drift_pct - want.energy_drift_pct) <= tol
    scale = max(abs(want.mean_outer_velocity), 1e-6)
    assert abs(got.outer_slope - want.outer_slope) <= 1e-3 * scale
    assert got.final_radius == pytest.approx(want.final_radius, rel=1e-2)


def test_check_monotonicity_equals_jax():
    rng = np.random.default_rng(4)
    for trial in range(20):
        drifts = rng.normal(size=8) * np.geomspace(10, 0.01, 8)
        if trial % 3 == 0:
            drifts = drifts[::-1]
        rows = [dict(bits=float(b), levels=int(2 ** b), label="",
                     energy_drift_pct=float(d), outer_slope=0.0,
                     mean_outer_velocity=0.0, final_radius=0.0)
                for b, d in zip(range(2, 10), drifts)]
        want = js.check_monotonicity([js.SensitivityResult(**r)
                                      for r in rows])
        assert ts.check_monotonicity([ts.SensitivityResult(**r)
                                      for r in rows]) == want


def test_sensitivity_sweep_smoke(tmp_path):
    """tests/test_experiments_smoke.py's sensitivity case on the port."""
    results, mono = ts.run_sensitivity_sweep(
        num_stars=48, num_ticks=60, levels=[4, 64, 100000],
        out_dir=str(tmp_path), device="cpu")
    assert len(results) == 3
    # coarse must drift more than fine
    assert abs(results[0].energy_drift_pct) > abs(
        results[-1].energy_drift_pct)
    rep = json.loads((tmp_path / "sensitivity_results.json").read_text())
    assert set(rep) == {"results", "monotonicity"}
    assert set(rep["monotonicity"]) == set(mono)


# --------------------------------------------------------------------------
# falsification_tests
# --------------------------------------------------------------------------

def test_convergence_matches_jax(monkeypatch):
    patch_ics(monkeypatch, "create_disk_galaxy",
              lambda i, num_stars, **kw: disk(5, num_stars), (jf, tf))
    want = jf.test_convergence(num_stars=48, num_ticks=60)
    got = tf.test_convergence(num_stars=48, num_ticks=60, device="cpu")
    assert got["levels"] == want["levels"]
    assert got["converges"] == want["converges"] is True
    for lv, d, w in zip(got["levels"], got["drifts"], want["drifts"]):
        tol = F32_DRIFT if lv >= 100000 else int_drift_tol(w)
        assert abs(d - w) <= tol, (lv, d, w)


def test_bullet_cluster_matches_jax(monkeypatch):
    patch_ics(monkeypatch, "create_disk_galaxy",
              lambda i, num_stars, **kw: disk(6 + i, num_stars, **kw),
              (jf, tf))
    want = jf.test_bullet_cluster(num_stars=48, num_ticks=100)
    got = tf.test_bullet_cluster(num_stars=48, num_ticks=100, device="cpu")
    assert set(got["separations"]) == {"float64", "int4"}
    assert got["separations"]["float64"] == pytest.approx(
        want["separations"]["float64"], rel=1e-4, abs=1e-6)
    assert got["separations"]["int4"] == pytest.approx(
        want["separations"]["int4"], rel=0.1, abs=1e-4)
    assert got["separated"] == want["separated"]


def test_gravitational_center_matches_jax():
    pos = np.random.default_rng(8).normal(size=(200, 2)).astype(np.float32)
    m = np.random.default_rng(9).uniform(0.5, 2, 200).astype(np.float32)
    want = np.asarray(jf._gravitational_center(pos, m))
    got = tf._gravitational_center(torch.from_numpy(pos),
                                   torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_parameter_sensitivity_matches_jax(monkeypatch):
    patch_ics(monkeypatch, "create_disk_galaxy",
              lambda i, num_stars, **kw: disk(7, num_stars), (jf, tf))
    want = jf.test_parameter_sensitivity(num_stars=48, num_ticks=30)
    got = tf.test_parameter_sensitivity(num_stars=48, num_ticks=30,
                                        device="cpu")
    for sweep in ("softening_sweep", "dt_sweep"):
        assert list(got[sweep]) == list(want[sweep])
        for k, w in want[sweep].items():
            assert abs(got[sweep][k] - w) <= int_drift_tol(w), (sweep, k)
    assert got["robust"] == want["robust"]


def test_falsification_convergence_smoke():
    """tests/test_experiments_smoke.py's falsification case on the port."""
    rep = tf.test_convergence(num_stars=48, num_ticks=60, device="cpu")
    assert rep["converges"]


# --------------------------------------------------------------------------
# dark_matter_test
# --------------------------------------------------------------------------

def test_dm_comparison_matches_jax(monkeypatch):
    patch_ics(monkeypatch, "create_disk_galaxy",
              lambda i, num_stars, **kw: disk(11, num_stars), (jdm, tdm))
    patch_ics(monkeypatch, "create_galaxy_with_halo",
              lambda i, num_stars, dm_mass_ratio, **kw: halo(
                  11, num_stars, dm_mass_ratio), (jdm, tdm))
    want = jdm.run_dm_comparison(num_stars=128, num_ticks=40)
    got = tdm.run_dm_comparison(num_stars=128, num_ticks=40, device="cpu")
    assert list(got) == list(want)
    for label, w in want.items():
        g = got[label]
        assert set(g) == set(w) and g["dm_ratio"] == w["dm_ratio"]
        for which in ("initial_curve", "final_curve"):
            np.testing.assert_allclose(g[which]["radii"],
                                       w[which]["radii"], rtol=1e-4)
            np.testing.assert_allclose(g[which]["velocities"],
                                       w[which]["velocities"], rtol=1e-3,
                                       atol=1e-5)
        scale = max(abs(w["final_mean_outer_v"]), 1e-6)
        for k in ("initial_outer_slope", "final_outer_slope"):
            assert abs(g[k] - w[k]) <= 1e-3 * scale, (label, k)


def test_dark_matter_smoke(tmp_path):
    """tests/test_experiments_smoke.py's dark-matter case on the port,
    and main's report."""
    res = tdm.run_dm_comparison(num_stars=128, num_ticks=40, device="cpu")
    assert set(res) == {"DM 0x", "DM 2x", "DM 5x", "DM 10x"}
    tdm.main(["--stars", "64", "--ticks", "10", "--device", "cpu",
              "--output", str(tmp_path)])
    rep = json.loads((tmp_path / "dark_matter_results.json").read_text())
    assert set(rep) == set(res)


# --------------------------------------------------------------------------
# sparc_test
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jsp.GALAXY_DATABASE))
def test_sparc_scaling_and_fit_equal_jax(name):
    jgal, tgal = jsp.GALAXY_DATABASE[name], tsp.GALAXY_DATABASE[name]
    assert jgal.name == tgal.name
    want = jsp.scale_galaxy_to_simulation(jgal)
    got = tsp.scale_galaxy_to_simulation(tgal)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    rng = np.random.default_rng(len(name))
    radii = np.linspace(0.3, 10.5, 15)
    vels = rng.uniform(0.1, 0.5, 15)
    vels[[2, 9]] = np.nan
    for target in ("v_observed", "v_baryonic"):
        args = (want["radii_sim"], want[target], want["v_error"])
        assert tsp.compute_fit_quality(
            torch.from_numpy(radii), torch.from_numpy(vels), *args) \
            == jsp.compute_fit_quality(radii, vels, *args)
    assert tsp.compute_fit_quality(radii[:2], vels[:2], *args) == float(
        "inf")


def test_sparc_galaxy_matches_jax(monkeypatch):
    patch_ics(monkeypatch, "create_disk_galaxy",
              lambda i, num_stars, **kw: disk(12, num_stars, **kw),
              (jsp, tsp))
    gal = tsp.GALAXY_DATABASE["NGC2403"]
    want = jsp.run_galaxy("NGC2403", jsp.GALAXY_DATABASE["NGC2403"], 128,
                          30, 42)
    got = tsp.run_galaxy("NGC2403", gal, 128, 30, 42, device="cpu")
    assert got["name"] == want["name"]
    for k in ("chi2_observed", "chi2_baryonic"):
        assert got["float64"][k] == pytest.approx(want["float64"][k],
                                                  rel=1e-3)
    assert (got["float64"]["fits_dm_better"]
            == want["float64"]["fits_dm_better"])
    assert set(got["int4_sim"]) == set(want["int4_sim"])


def test_sparc_smoke(tmp_path):
    """tests/test_experiments_smoke.py's SPARC case on the port."""
    tsp.main(["--stars", "64", "--ticks", "40", "--device", "cpu",
              "--output", str(tmp_path)])
    rep = json.loads((tmp_path / "sparc_results.json").read_text())
    assert len(rep["results"]) == 4
    assert set(rep) == {"results", "int4_dm_wins", "float64_dm_wins",
                        "verdict_int4_more_dm_like"}


# --------------------------------------------------------------------------
# jitter_test
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt,total", [(0.05, 1.0), (0.01, 0.5)])
def test_measure_jitter_matches_jax(dt, total):
    ics = disk(13, 64)
    want = jj.measure_jitter(*ics, dt=dt, total_time=total, num_samples=10)
    got = tj.measure_jitter(*ics, dt=dt, total_time=total, num_samples=10,
                            device="cpu")
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-3)
    assert abs(got[2] - want[2]) <= F32_DRIFT


def test_nested_galaxies_layout():
    gen = torch.Generator().manual_seed(0)
    pos, vel, m = tj.nested_galaxies(gen, stars_per_level=50, levels=3)
    assert pos.shape == (150, 2) and vel.shape == (150, 2)
    np.testing.assert_array_equal(m.numpy(), np.repeat([1.0, 2.0, 4.0], 50))
    r = torch.linalg.vector_norm(pos, dim=1).reshape(3, 50)
    assert (r.max(dim=1).values <= torch.tensor([20.0, 10.0, 5.0])).all()


def test_frame_rate_sweep_matches_jax(monkeypatch):
    nested = [disk(14 + k, 32, galaxy_radius=10.0 / 2 ** k)
              for k in range(3)]
    ics = tuple(np.concatenate([p[i] * (2.0 ** k if i == 2 else 1.0)
                                for k, p in enumerate(nested)])
                for i in range(3))
    patch_ics(monkeypatch, "nested_galaxies", lambda i, *a, **kw: ics,
              (jj, tj))
    monkeypatch.setattr(tj, "FRAME_DTS", [0.1, 0.05, 0.02])
    want = jj.frame_rate_sweep(jax.random.PRNGKey(0), total_time=0.6)
    # JAX's dts are inline: hold the port's three rows against its first
    got = tj.frame_rate_sweep(torch.Generator(), total_time=0.6,
                              device="cpu")
    assert set(got) == set(want)
    for g, w in zip(got["rows"], want["rows"][:3]):
        assert g["dt"] == w["dt"]
        np.testing.assert_allclose([g["pos_jitter"], g["vel_jitter"]],
                                   [w["pos_jitter"], w["vel_jitter"]],
                                   rtol=1e-3)
        assert abs(g["energy_drift_pct"] - w["energy_drift_pct"]) \
            <= F32_DRIFT


def test_jitter_measure_smoke():
    """tests/test_experiments_smoke.py's jitter case on the port."""
    pos, vel, m = tj.create_disk_galaxy(torch.Generator().manual_seed(0),
                                        48)
    pj, vj, drift = tj.measure_jitter(pos, vel, m, dt=0.01, total_time=0.5,
                                      num_samples=10, device="cpu")
    assert pj >= 0 and vj >= 0
    assert abs(drift) < 100.0  # f32 short run: bounded energy drift


def test_jitter_main_quick_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tj, "FRAME_DTS", [0.1, 0.05])
    monkeypatch.setattr(tj, "BETAS", [0.1, 0.9])
    rep = tj.main(["--quick", "--device", "cpu", "--output", str(tmp_path)])
    saved = json.loads((tmp_path / "jitter_report.json").read_text())
    assert set(saved) == {"frame_rate_sweep", "velocity_sweep"}
    assert set(saved["frame_rate_sweep"]) == {
        "rows", "dt_jitter_correlation", "lag_creates_jitter",
        "jitter_grows_with_fps"}
    assert set(saved["velocity_sweep"]) == {
        "rows", "beta_jitter_correlation", "speed_creates_jitter",
        "jitter_grows_with_speed"}
    assert rep["velocity_sweep"]["rows"][-1]["beta"] == 0.9


@pytest.mark.parametrize("argv", [[], ["--quick"],
                                  ["--stars", "500", "--ticks", "900"]])
def test_falsification_sizes_are_jax_mains(argv, tmp_path, monkeypatch):
    """suite_sizes gives each hole the (stars, ticks) that JAX's main
    passes it."""
    calls = {}
    for name in ("convergence", "bullet_cluster", "parameter_sensitivity"):
        def record(n, t, seed, _name=name):
            calls[_name] = (n, t)
            return {}
        monkeypatch.setattr(jf, f"test_{name}", record)
    jf.main([*argv, "--output", str(tmp_path)])
    args = tf.build_parser().parse_args(argv)
    assert tf.suite_sizes(args.stars, args.ticks, args.quick) == calls


@pytest.mark.parametrize("quick", [False, True])
def test_jitter_sizes_are_jax_sweeps(quick, monkeypatch):
    """suite_sizes, the nested levels, the samples and the sweeps' times
    are those of JAX's sweeps."""
    defaults = {f: {k: v.default for k, v in inspect.signature(
        getattr(jj, f)).parameters.items()}
        for f in ("nested_galaxies", "measure_jitter")}
    drawn, runs = {}, []
    ics = disk(3, 16)

    def nested(key, stars_per_level=300, levels=3):
        drawn["nested_stars"] = stars_per_level
        return ics

    def galaxy(key, num_stars, **kw):
        drawn["disk_stars"] = num_stars
        return ics

    def measure(pos, vel, m, dt, total_time, num_samples=None):
        runs.append((dt, total_time))
        return 1.0 + len(runs), 2.0 + len(runs), 0.0

    monkeypatch.setattr(jj, "nested_galaxies", nested)
    monkeypatch.setattr(jj, "create_disk_galaxy", galaxy)
    monkeypatch.setattr(jj, "measure_jitter", measure)
    jj.frame_rate_sweep(jax.random.PRNGKey(0), quick=quick)
    jj.velocity_sweep(jax.random.PRNGKey(0), quick=quick)
    assert tj.suite_sizes(quick) == drawn
    assert runs == ([(dt, tj.FRAME_TIME) for dt in tj.FRAME_DTS]
                    + [(tj.VELOCITY_DT, tj.VELOCITY_TIME)] * len(tj.BETAS))
    assert defaults["nested_galaxies"]["levels"] == tj.NESTED_LEVELS
    assert defaults["measure_jitter"]["num_samples"] == tj.NUM_SAMPLES


# --------------------------------------------------------------------------
# The CLIs on the CPU, and without a card
# --------------------------------------------------------------------------

def test_stability_suite_smoke(tmp_path, capsys):
    """tests/test_experiments_smoke.py's stability case on the port."""
    tst.main(["--stars", "48", "--ticks", "100", "--device", "cpu",
              "--output", str(tmp_path)])
    rep = json.loads((tmp_path / "stability_results.json").read_text())
    assert len(rep["results"]) == 6
    assert set(rep) == {"results", "threshold_mode", "num_stars",
                        "max_ticks"}
    out = capsys.readouterr().out
    assert "STABILITY FLOOR RESULTS" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("module", [tst, ts, tf, tdm, tsp, tj])
def test_main_raises_without_a_card(module, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--output", str(tmp_path)])
    assert not any(tmp_path.iterdir())
