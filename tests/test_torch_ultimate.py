"""nbody_tpu_torch.engines.ultimate against nbody_tpu.engines.ultimate, on
the CPU.

* ``compute_2point_correlation``: the port's shell counts against JAX's
  (recovered from its xi as round((xi + 1) * expected)) on the same
  uniform and clustered positions (N = 4096, 3 seeds, JAX's bins and a
  custom set): each count equal or within 2, xi within 2 / expected. On
  this CPU no bin differs (0 of 66: both sum the squared components in
  component order and compare in float32).
* The flatness case of tests/test_diagnostics_utils.py on the port.
* On a state carried across from a JAX ``UltimateEngine``
  (``load_jax_state``): ``detect_structures`` equal to JAX's key for key
  (the grid counts particles exactly), ``get_bao_scale`` and
  ``compare_to_cmb``'s ``k_peak`` equal, and each package's
  ``compare_substrate_states`` reads the other's export with
  ``hash_match`` true.
* ``run_ultimate_reality_test`` at 512 particles on a 16^3 grid gives JAX's
  report keys; ``main`` runs its modes with ``--device cpu``;
  ``run_all_tests(device="cpu")`` runs the sensitivity, omniverse and
  orbital suites of ``nbody_tpu_torch.experiments`` at tiny sizes (each
  runner wrapped to shrink it, the same wrap on JAX's suites): no
  ``error`` entry, JAX's top-level keys, and the device reached each;
  tests/test_experiments_smoke.py's structure case on the port.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.engines import ultimate as ju
from nbody_tpu_torch.engines import ultimate as tu

torch.set_num_threads(1)

N, BOX = 4096, 200.0
CUSTOM_BINS = np.array([3.0, 7.5, 15.0, 33.0])


def _positions(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    centers = rng.uniform(0, BOX, (12, 3))
    idx = rng.integers(0, 12, N)
    return ((centers[idx] + rng.normal(0, 4.0, (N, 3))) % BOX
            ).astype(np.float32)


def _expected(r_bins, n_anchor: int) -> np.ndarray:
    density = N / BOX ** 3
    return np.array([n_anchor * density * 4.0 / 3.0 * np.pi
                     * (hi ** 3 - lo ** 3)
                     for lo, hi in tu._shell_edges(r_bins)])


@pytest.mark.parametrize("bins", ["jax", "custom"])
@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_2point_counts_match_jax(seed, kind, bins):
    pos = _positions(kind, seed)
    r_bins = None if bins == "jax" else CUSTOM_BINS
    jr, jxi = ju.compute_2point_correlation(pos, BOX, r_bins=r_bins)
    r, counts, n_anchor = tu.shell_counts(torch.from_numpy(pos), BOX,
                                          r_bins=r_bins)
    np.testing.assert_array_equal(r, jr)
    expected = _expected(r, n_anchor)
    jax_counts = np.rint((jxi + 1.0) * expected).astype(np.int64)
    assert np.abs(counts - jax_counts).max() <= 2, (counts, jax_counts)
    _, xi = tu.compute_2point_correlation(torch.from_numpy(pos), BOX,
                                          r_bins=r_bins)
    assert np.all(np.abs(xi - jxi) <= 2.0 / expected)


def test_2point_correlation_uniform_is_flat():
    pos = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (4096, 3))
                     ) * 200.0
    r, xi = tu.compute_2point_correlation(torch.from_numpy(pos), 200.0,
                                          r_bins=np.array([5.0, 10.0, 20.0]))
    # uniform points: xi ~ 0 everywhere
    assert np.abs(xi).max() < 0.3


def test_2point_padding_anchors_count_nothing():
    """Anchors padded to a whole chunk sit at -1e9 and count no pair: the
    counts do not depend on the chunk size."""
    pos = torch.from_numpy(_positions("clustered", 3))
    base = tu.shell_counts(pos, BOX, num_anchors=500, anchor_chunk=500)
    for chunk in (64, 333):
        got = tu.shell_counts(pos, BOX, num_anchors=500, anchor_chunk=chunk)
        np.testing.assert_array_equal(got[1], base[1])
        assert got[2] == base[2] == 500


@pytest.fixture(scope="module")
def carried():
    """A JAX UltimateEngine after 6 steps and a port engine carrying its
    state (512 particles, 16^3 grid)."""
    je = ju.UltimateEngine(num_particles=512, start_redshift=10.0,
                           precision="float32", n_grid=16)
    je.step(dz=1.0, num_steps=6)
    te = tu.UltimateEngine(num_particles=512, start_redshift=10.0,
                           precision="float32", n_grid=16, device="cpu")
    te.load_jax_state(jax.tree.map(np.asarray, je.state), je.mass_unit_msun)
    assert torch.equal(te.positions,
                       torch.from_numpy(np.array(je.state.positions)))
    return je, te


@pytest.mark.parametrize("n_grid", [8, 16])
def test_detect_structures_equals_jax(carried, n_grid):
    je, te = carried
    assert te.detect_structures(n_grid) == je.detect_structures(n_grid)


def test_bao_scale_and_cmb_peak_equal_jax(carried):
    je, te = carried
    assert te.get_bao_scale() == je.get_bao_scale()
    got, want = tu.compare_to_cmb(te), ju.compare_to_cmb(je)
    assert got["k_peak"] == want["k_peak"]
    assert got["nearest_planck_peak"] == want["nearest_planck_peak"]


def test_substrate_exports_read_across_packages(carried, tmp_path):
    je, te = carried
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jh = ju.export_state_for_comparison(je, str(jpath))
    th = tu.export_state_for_comparison(te, str(tpath))
    assert th == jh
    port = json.loads(tpath.read_text())
    assert set(port) == set(json.loads(jpath.read_text()))
    assert set(port["platform"]) == {"os", "python", "torch", "cuda",
                                     "backend", "device"}
    assert (port["platform"]["backend"], port["platform"]["device"]) == \
        ("cpu", "cpu")
    for compare in (tu.compare_substrate_states,
                    ju.compare_substrate_states):
        res = compare(str(jpath), str(tpath))
        assert res["hash_match"] is True
        assert res["max_position_delta"] == 0.0
        assert res["position_correlation"] == pytest.approx(1.0)


def _keys(report: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in report.items()}


def test_reality_test_report_has_jax_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(ju, "UltimateEngine",
                        functools.partial(ju.UltimateEngine, n_grid=16))
    monkeypatch.setattr(tu, "UltimateEngine",
                        functools.partial(tu.UltimateEngine, n_grid=16))
    want = ju.run_ultimate_reality_test(num_particles=512,
                                        precision="float32",
                                        out_dir=str(tmp_path / "jax"))
    got = tu.run_ultimate_reality_test(num_particles=512,
                                       precision="float32",
                                       out_dir=str(tmp_path / "torch"),
                                       device="cpu")
    assert _keys(got) == _keys(want)
    assert sorted(got["bao_test"]["rows"][0]) == \
        sorted(want["bao_test"]["rows"][0])
    assert got["num_particles"] == 512
    assert len(got["state_hash"]) == 16
    saved = json.loads((tmp_path / "torch" / "ultimate_report.json")
                       .read_text())
    assert saved["state_hash"] == got["state_hash"]


@pytest.fixture
def small_main(monkeypatch):
    monkeypatch.setattr(tu, "QUICK_PARTICLES", 512)
    monkeypatch.setattr(tu, "UltimateEngine",
                        functools.partial(tu.UltimateEngine, n_grid=16))


def test_main_modes_on_the_cpu(tmp_path, small_main, capsys):
    common = ["--device", "cpu", "--quick", "--precision", "float32"]
    bao = tu.main(["--mode", "bao", *common])
    assert len(bao["rows"]) == 5
    assert all(r["redshift"] < 50 for r in bao["rows"])
    hashes = [tu.main(["--mode", "substrate", *common, "--output",
                       str(tmp_path / d)]) for d in ("a", "b")]
    assert hashes[0] == hashes[1]  # bitwise from run to run
    res = tu.main(["--mode", "compare", "--output", str(tmp_path / "a"),
                   "--other-platform",
                   str(tmp_path / "b" / "substrate_state.json")])
    assert res["hash_match"] and res["max_position_delta"] == 0.0
    assert tu.main(["--mode", "compare", "--output",
                    str(tmp_path / "none")]) is None
    assert "run --mode substrate first" in capsys.readouterr().out


def _tiny_suites(monkeypatch, sens, omni, orbital, seen=None):
    """Shrink the three suites of one package in place: sensitivity to 48
    stars x 20 ticks at levels 4 and 100000, the omniverse probes to a
    few dozen ticks, and every RK4 propagation of the orbital audit to
    three of its chunks. ``seen`` records the device each runner got."""
    def record(name, kw):
        if seen is not None:
            seen[name] = kw.get("device")

    sweep = sens.run_sensitivity_sweep

    def tiny_sweep(num_stars, num_ticks, **kw):
        record("sensitivity", kw)
        return sweep(48, 20, levels=[4, 100000], **kw)

    monkeypatch.setattr(sens, "run_sensitivity_sweep", tiny_sweep)
    for name, shrink in (
            ("recursive_physics_mirror", lambda a, kw: ((15,) + a[1:], kw)),
            ("fluid_dynamics_chaos", lambda a, kw: ((200, 10) + a[2:], kw)),
            ("neural_hardware_bridge",
             lambda a, kw: ((60,) + a[1:], {**kw, "epochs": 3})),
            ("voxel_spacetime_grid", lambda a, kw: ((2, 10) + a[2:], kw))):
        def tiny(*a, _fn=getattr(omni, name), _shrink=shrink, **kw):
            return _fn(*_shrink(a, kw)[0], **_shrink(a, kw)[1])
        monkeypatch.setattr(omni, name, tiny)
    suite = omni.run_omniverse_suite

    def tiny_suite(**kw):
        record("omniverse", kw)
        return suite(**kw)

    monkeypatch.setattr(omni, "run_omniverse_suite", tiny_suite)
    prop = orbital.propagate_rk4

    def tiny_prop(p, v, dt, q, num_steps, sample_every, **kw):
        return prop(p, v, dt, q, min(num_steps, 3 * sample_every),
                    sample_every, **kw)

    monkeypatch.setattr(orbital, "propagate_rk4", tiny_prop)
    audit = orbital.run_full_orbital_audit

    def tiny_audit(**kw):
        record("orbital", kw)
        return audit(**kw)

    monkeypatch.setattr(orbital, "run_full_orbital_audit", tiny_audit)


def _top_keys(result):
    if isinstance(result, dict):
        return sorted(result)
    results, mono = result   # the sensitivity sweep: (results, verdict)
    return (len(results), sorted(vars(results[0])), sorted(mono))


def test_run_all_tests_runs_the_three_suites(tmp_path, monkeypatch):
    from nbody_tpu.experiments import omniverse_tests as jo
    from nbody_tpu.experiments import orbital_audit as joa
    from nbody_tpu.experiments import sensitivity_test as js
    from nbody_tpu_torch.experiments import omniverse_tests as to
    from nbody_tpu_torch.experiments import orbital_audit as toa
    from nbody_tpu_torch.experiments import sensitivity_test as ts

    calls, seen = [], {}
    for mod in (tu, ju):
        monkeypatch.setattr(mod, "run_ultimate_reality_test",
                            lambda **kw: calls.append(kw) or {"stub": True})
    _tiny_suites(monkeypatch, ts, to, toa, seen)
    _tiny_suites(monkeypatch, js, jo, joa)
    res = tu.run_all_tests(quick=True, out_dir=str(tmp_path / "torch"),
                           device="cpu")
    want = ju.run_all_tests(quick=True, out_dir=str(tmp_path / "jax"))
    assert calls[0] == dict(quick=True, seed=42, out_dir=str(tmp_path
                                                             / "torch"),
                            device="cpu")
    assert res["ultimate"] == {"stub": True}
    assert [name for name, _, _ in tu.SUITES] == ["sensitivity",
                                                  "omniverse", "orbital"]
    assert seen == {"sensitivity": "cpu", "omniverse": "cpu",
                    "orbital": "cpu"}
    for name, _, _ in tu.SUITES:
        assert "error" not in res[name], res[name]
        assert "error" not in want[name], want[name]
        assert _top_keys(res[name]) == _top_keys(want[name]), name
    saved = json.loads((tmp_path / "torch" / "comprehensive_report.json")
                       .read_text())
    assert set(saved) == {"ultimate", "sensitivity", "omniverse", "orbital"}


def test_ultimate_structures():
    e = tu.UltimateEngine(num_particles=512, start_redshift=10.0,
                          precision="float32", n_grid=16, device="cpu")
    s = e.detect_structures(n_grid=8)
    assert 0.0 <= s["void_fraction"] <= 1.0
    assert e.cfg.dim == 3 and tu.UltimateEngine(
        num_particles=64, device="cpu").cfg.n_grid == 64
