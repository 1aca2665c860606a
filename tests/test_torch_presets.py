"""The 3-D presets of nbody_tpu_torch (universe3d, dashboard3d, genesis)
against the JAX package's, on the CPU.

* ``genesis_from_uniform`` fed JAX's own ``jax.random.uniform`` draws
  against ``nbody_tpu.engines.genesis.make_genesis_ics`` (D=3): positions
  by periodic distance and velocities within 1e-5 of their largest
  magnitude, masses equal (the Zel'dovich ICs' rule,
  tests/test_torch_cosmo.py).
* The timeline, the collision audit and the IRL logger equal JAX's.
* The engines construct, step and report with and without a virtual mesh;
  the CLIs run with ``--mesh`` at a tiny size; the dashboard renders, and
  without matplotlib says so once and renders nothing.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.config import PLANCK18
from nbody_tpu.engines import cosmo as jc
from nbody_tpu.engines import genesis as jgen
from nbody_tpu.engines import universe3d as ju3
from nbody_tpu_torch.engines import cosmo as tc
from nbody_tpu_torch.engines import dashboard3d
from nbody_tpu_torch.engines import genesis as tgen
from nbody_tpu_torch.engines import universe3d as tu3
from nbody_tpu_torch.parallel.ring import ParticleMesh

torch.set_num_threads(1)


def _periodic(a, b, box):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, box - d)


@pytest.mark.parametrize("side", [6, 8])
def test_genesis_ics_from_jax_phases(side):
    jcfg = jc.PMConfig(dim=3, n_grid=64, box_size=500.0)
    tcfg = tc.PMConfig(dim=3, n_grid=64, box_size=500.0)
    key = jax.random.PRNGKey(42)
    jpos, jvel, jm = (np.asarray(x) for x in jgen.make_genesis_ics(
        key, side, jcfg, 100.0, PLANCK18))
    uniform = np.asarray(jax.random.uniform(key, (side,) * 3))
    tpos, tvel, tm = (x.numpy() for x in tgen.genesis_from_uniform(
        torch.from_numpy(uniform.copy()), side, tcfg, 100.0))
    assert tpos.shape == jpos.shape == (side ** 3, 3)
    assert _periodic(tpos, jpos, 500.0).max() <= 1e-5 * np.abs(jpos).max()
    np.testing.assert_allclose(tvel, jvel, rtol=0,
                               atol=1e-5 * np.abs(jvel).max())
    np.testing.assert_array_equal(tm, jm)


def test_genesis_ics_come_from_a_torch_generator():
    cfg = tc.PMConfig(dim=3, n_grid=16, box_size=500.0)
    a, b, c = (tgen.make_genesis_ics(torch.Generator().manual_seed(s), 6,
                                     cfg, 100.0) for s in (5, 5, 6))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_timeline_auditor_and_logger_equal_jax():
    assert [vars(e) for e in tgen.GENESIS_TIMELINE] == \
        [vars(e) for e in jgen.GENESIS_TIMELINE]
    for thick, dt in ((1.0, 0.01), (0.3, 0.05)):
        got = tu3.CollisionTickAuditor(thick, dt).run()
        want = ju3.CollisionTickAuditor(thick, dt).run()
        assert vars(got) == vars(want)
    assert got.tunneling_confirmed
    summary = {"energy_jump": 2, "momentum_drift": 1}
    fake = SimpleNamespace(
        precision_str="int4",
        glitch_detector=SimpleNamespace(get_glitch_summary=lambda: summary))
    inter = dict(baseline_mean_ms=1.0, baseline_std_ms=0.1,
                 stressed_mean_ms=2.0, stressed_std_ms=0.5,
                 variance_ratio=5.0, lag_contagion=True)
    got = tu3.IRLExperimentLogger().log_from_universe(
        fake, tu3.InterferenceResult(**inter), tu3.CollisionTickAuditor()
        .run())
    want = ju3.IRLExperimentLogger().log_from_universe(
        fake, ju3.InterferenceResult(**inter), ju3.CollisionTickAuditor()
        .run())
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert len(got) == 4


@pytest.mark.parametrize("shards", [None, 3])
def test_presets_construct_step_and_report(shards):
    mesh = None if shards is None else ParticleMesh.virtual(shards, "cpu")
    u = tu3.Universe3D(num_particles=343, start_redshift=4.0, device="cpu",
                       mesh=mesh)
    g = tgen.UniverseGenesis(num_particles=343, start_redshift=4.0,
                             device="cpu", mesh=mesh)
    assert (u.cfg.dim, u.cfg.n_grid, g.cfg.n_grid, g.cfg.dm_ratio) == \
        (3, 32, 64, 0.0)
    for e in (u, g):
        e.step(1.0, 2)
        assert e.tick == 2 and e.positions.shape == (343, 3)
        assert np.isfinite(e.history["energy"]).all()
        assert np.isfinite(e.get_bao_scale())
        if shards:
            assert e._state.positions.shape[0] == 345
    g.run_to_completion(dz=1.0, chunk=2)
    assert [(t["tick"], t["epoch"]) for t in g.epoch_transitions] == \
        [(1, "peak_sf"), (3, "dark_energy"), (4, "now")]
    assert g.get_state_dict()["positions"].shape == (343, 3)


def test_interference_probe_runs_on_the_engine_device():
    u = tu3.Universe3D(num_particles=216, start_redshift=3.0, device="cpu")
    res = tu3.SubstrateInterferenceProbe().run(u, num_steps=3)
    assert res.baseline_mean_ms > 0 and np.isfinite(res.variance_ratio)
    assert u.tick == 6


def test_universe3d_main_with_mesh(tmp_path, capsys):
    report = tu3.main(["--device", "cpu", "--mesh", "--particles", "216",
                       "--start-z", "3", "--frames", "1", "--output",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "sharded PM over 1 device(s)" in out
    saved = json.loads((tmp_path / "universe3d_report.json").read_text())
    assert saved["ticks"] == report["ticks"] == 3
    assert np.isfinite([saved["energy_first"], saved["energy_last"]]).all()
    assert (tmp_path / "final.png").exists()


def test_genesis_main_with_mesh(tmp_path, capsys):
    report = tgen.main(["--device", "cpu", "--mesh", "--particles", "216",
                        "--start-z", "2", "--output", str(tmp_path)])
    assert "sharded PM over 1 device(s)" in capsys.readouterr().out
    saved = json.loads((tmp_path / "genesis_report.json").read_text())
    # chunks of 20 steps, the last ones held at z = 0.01, as in JAX
    assert saved["tick"] == report["tick"] == 20
    assert np.isfinite([saved["energy_first"], saved["energy_last"]]).all()
    with np.load(tmp_path / "genesis_final_state.npz") as st:
        assert st["positions"].shape == (216, 3)


def test_dashboard3d_renders_and_animates(tmp_path):
    u = tu3.Universe3D(num_particles=64, start_redshift=10.0, device="cpu")
    u.step(1.0, 2)
    dash = dashboard3d.Dashboard3D(u, str(tmp_path))
    assert dash.render_frame().stat().st_size > 10_000
    azim0 = dash.azim
    path = dash.animate(dz=1.0, steps_per_frame=1, frames=2, headless=True)
    assert path is not None and path.exists()
    assert dash.azim != azim0 and u.tick >= 4


def test_dashboard3d_without_matplotlib_says_so_once(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.setattr(dashboard3d, "has_matplotlib", lambda: False)
    u = tu3.Universe3D(num_particles=64, start_redshift=10.0, device="cpu")
    dash = dashboard3d.Dashboard3D(u, str(tmp_path))
    assert dash.render_frame() is None and dash.render_frame() is None
    assert dash.animate(frames=1) is None
    assert capsys.readouterr().out.count(dashboard3d.SKIPPED) == 1
    assert not list(tmp_path.iterdir()) and u.tick == 0
