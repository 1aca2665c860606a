"""nbody_tpu_torch.realtime (engine and visual) against nbody_tpu.realtime,
on the CPU.

* The host pieces (``GlobalClock``, ``SharedState``, ``BAOSolver``,
  ``RSIMonitor``) take the JAX cases of tests/test_viz_realtime.py; the
  BAO solver's host estimate equals JAX's on the same positions, and one
  RSI monitor thread over a prepared state gives an RSI in (0, 100].
* The producer (``CosmicWebEngine``) and the engine's ``snapshot_cap``
  take the same file's cases on the port: the lagged publish, frames
  consistent with the histories, the mesh against the single device
  (``ParticleMesh.virtual(S, "cpu")``, S = 1, 3, 4 and 8; positions at
  rtol / atol 2e-3 and the kinetic energy at rtol 1e-3, JAX's tolerances
  there), the decimated snapshot, the padded rows left out, the device
  BAO published.
* ``PrecisionCompareViewer`` on JAX's 256-star disk, 3 frames of 5 ticks,
  against JAX's viewer: the clean drift (percent) within 2e-3 (energies
  at rtol 1e-5, the float32 rule of tests/test_torch_direct.py, move a
  drift by at most 2 x 1e-5 x 100), the broken drift within
  max(10% of JAX's, 5e-5) (that file's rule for the int-sim modes).
* ``MonitorSchedule`` (the port's one change to the monitors): each
  sleep ends on the grid ``origin + offset + k * period``, a late wake-up
  does not shift the grid and missed points are skipped; the RSI grid
  keeps 25 ms off the BAO grid's points.
* Without matplotlib the dashboard and the viewer render nothing and say
  so once; ``realtime.engine.main`` with ``--device cpu``, with and without
  ``--mesh``, writes its report and leaves no monitor thread running.
"""

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.models import galaxy as jg
from nbody_tpu.realtime import engine as je
from nbody_tpu.realtime import visual as jv
from nbody_tpu_torch.engines.cosmo import CosmologicalEngine
from nbody_tpu_torch.parallel.ring import ParticleMesh
from nbody_tpu_torch.realtime import engine as te
from nbody_tpu_torch.realtime import visual as tv

torch.set_num_threads(1)

MONITORS = ("bao-solver", "rsi-monitor")


def _monitors_alive():
    return [t.name for t in threading.enumerate() if t.name in MONITORS]


def _producer(num_particles, precision, seed, steps_per_frame, **kw):
    st = te.SharedState()
    prod = te.CosmicWebEngine(st, num_particles=num_particles,
                              precision=precision, seed=seed,
                              target_fps=1000.0,
                              steps_per_frame=steps_per_frame, device="cpu",
                              **kw)
    prod.start()
    return st, prod


def test_global_clock_desync():
    clock = te.GlobalClock()
    clock.beat("a")
    assert not clock.check_sync_violation()  # one subsystem: no skew
    clock.beat("b")
    assert not clock.check_sync_violation()  # fresh beats
    time.sleep(0.15)
    clock.beat("a")  # b is now >100ms stale relative to a
    assert clock.check_sync_violation()
    assert clock.desync_count == 1


def test_monitor_schedule_keeps_its_grid(monkeypatch):
    sched = te.MonitorSchedule()
    now, slept = [sched.origin], []
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    monkeypatch.setattr(time, "sleep", slept.append)

    def sleep_at(t, period, offset=0.0):
        now[0] = sched.origin + t
        sched.sleep_to_next(period, offset)
        return slept[-1]

    bao, rsi = te.BAO_PERIOD_S, te.RSI_PERIOD_S
    assert sleep_at(0.013, bao) == pytest.approx(0.087)  # 13 ms of work
    assert sleep_at(0.104, bao) == pytest.approx(0.096)  # woke 4 ms late
    assert sleep_at(0.35, bao) == pytest.approx(0.05)    # 2 points missed
    assert sleep_at(0.0, rsi, te.RSI_OFFSET_S) == pytest.approx(0.025)
    assert sleep_at(0.03, rsi, te.RSI_OFFSET_S) == pytest.approx(0.045)
    # every RSI check falls 25 ms off a BAO beat
    assert te.RSI_OFFSET_S == pytest.approx(bao / 4)
    assert bao == pytest.approx(2 * rsi)


def test_shared_state_energy_glitch():
    s = te.SharedState()
    p = np.zeros((10, 2))
    s.publish_snapshot(p, p, 1, 50.0, 100.0)
    s.publish_snapshot(p, p, 2, 49.0, 101.0)   # +1%: fine
    assert s.metrics.glitch_count == 0
    s.publish_snapshot(p, p, 3, 48.0, 150.0)   # +48%: glitch
    assert s.metrics.glitch_count == 1
    assert s.events[0]["type"] == "energy_glitch"


def test_bao_solver_scale_estimate():
    """The BAO solver's host P(k) peak finder recovers a planted scale,
    as JAX's does on the same positions."""
    rng = np.random.default_rng(0)
    n = 20000
    x = rng.uniform(0, 200, n)
    accept = 0.5 * (1 + np.sin(2 * np.pi * x / 80.0))
    keep = rng.random(n) < accept
    pos = np.stack([x[keep], rng.uniform(0, 200, keep.sum())],
                   axis=1).astype(np.float32)
    scale = te.BAOSolver(te.SharedState())._bao_scale(pos)
    assert 50 < scale < 120  # ~80 expected
    assert scale == je.BAOSolver(je.SharedState())._bao_scale(pos)
    for seed in (1, 2):
        p = np.random.default_rng(seed).uniform(0, 200, (4000, 2))
        assert te.BAOSolver(te.SharedState())._bao_scale(p) == \
            je.BAOSolver(je.SharedState())._bao_scale(p)


def test_rsi_monitor_thread_over_a_prepared_state():
    assert te.RSI_WEIGHTS == je.RSI_WEIGHTS
    st = te.SharedState()
    p = np.zeros((8, 2))
    for i, ke in enumerate((100.0, 101.0, 100.5, 102.0)):
        st.publish_snapshot(p, p, i + 1, 50.0 - i, ke)
    st.step_times_ms.extend([20.0, 21.0, 19.5, 20.5, 22.0, 20.0])
    st.metrics.bao_scale = 150.0
    mon = te.RSIMonitor(st)
    mon.start()
    try:
        time.sleep(0.15)
    finally:
        st.running = False
        mon.join(timeout=2.0)
    assert not mon.is_alive()
    m = st.metrics
    assert 0.0 < m.rsi <= 100.0
    assert m.step_ms_p50 == pytest.approx(20.25)
    assert m.fps == pytest.approx(1000.0 / np.mean(st.step_times_ms[-50:]))


def test_realtime_pump_publishes_lagged_snapshot():
    """After two pumps the SharedState holds the first pump's state;
    drain() publishes the last."""
    st, prod = _producer(256, "float32", 1, 1)
    tick0 = st.metrics.tick
    prod.pump()   # publishes nothing new (frame in flight)
    prod.pump()   # publishes pump-1's state
    assert st.metrics.tick == tick0 + 1
    prod.drain()  # publishes pump-2's state
    assert st.metrics.tick == tick0 + 2
    assert st.positions is not None
    assert np.isfinite(st.positions).all()


def test_realtime_pump_frames_are_history_consistent():
    """The published ke is the energy history entry for exactly the
    published tick, and the published state is that tick's post-chunk
    state."""
    st, prod = _producer(256, "int4", 2, 2)
    for _ in range(4):
        prod.pump()
    prod.drain()
    eng = prod.engine
    assert st.metrics.tick == eng.tick == 8
    assert st.metrics.kinetic_energy == eng.history["energy"][-1]
    assert abs(st.metrics.redshift - eng.redshift) < 1e-6
    np.testing.assert_array_equal(st.positions, eng.positions.numpy())


@pytest.fixture(scope="module")
def single_frames():
    st, prod = _producer(225, "float32", 5, 2)
    for _ in range(3):
        prod.pump()
    prod.drain()
    return st.positions.copy(), st.metrics.kinetic_energy


@pytest.mark.parametrize("shards", [1, 3, 4, 8])
def test_realtime_pump_mesh_matches_single_device(shards, single_frames):
    st, prod = _producer(225, "float32", 5, 2,
                         mesh=ParticleMesh.virtual(shards, "cpu"))
    for _ in range(3):
        prod.pump()
    prod.drain()
    assert st.metrics.tick == prod.engine.tick
    assert st.positions.shape == (225, 2)  # 15^2 lattice
    pos, ke = single_frames
    np.testing.assert_allclose(st.positions, pos, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(st.metrics.kinetic_energy, ke, rtol=1e-3)
    if shards == 1:  # a mesh of one is the single device
        np.testing.assert_array_equal(st.positions, pos)


def test_engine_snapshot_cap_decimates_without_changing_physics():
    full = CosmologicalEngine(num_particles=1024, dim=2, n_grid=32, seed=1,
                              device="cpu")
    capped = CosmologicalEngine(num_particles=1024, dim=2, n_grid=32,
                                seed=1, snapshot_cap=100, device="cpu")
    pos_f, vel_f = full.collect_step(full.dispatch_step(0.5, num_steps=4))
    p_cap = capped.dispatch_step(0.5, num_steps=4)
    pos_c, vel_c = capped.collect_step(p_cap)
    stride = p_cap.snap_stride
    assert stride == 11  # ceil(1024 / 100)
    assert pos_c.shape[0] == -(-1024 // stride)
    np.testing.assert_array_equal(pos_f[::stride], pos_c)
    np.testing.assert_array_equal(vel_f[::stride], vel_c)
    for key in ("energy", "bao_scale", "clustering"):
        assert full.history[key] == capped.history[key]


def test_engine_snapshot_cap_mesh_padded_rows_excluded():
    single = CosmologicalEngine(num_particles=225, dim=2, n_grid=32, seed=5,
                                device="cpu")
    capped = CosmologicalEngine(num_particles=225, dim=2, n_grid=32, seed=5,
                                mesh=ParticleMesh.virtual(8, "cpu"),
                                snapshot_cap=50)
    pos_s, _ = single.collect_step(single.dispatch_step(0.5, num_steps=2))
    pc = capped.dispatch_step(0.5, num_steps=2)
    pos_c, _ = capped.collect_step(pc)
    assert capped._state.positions.shape[0] == 232  # padded to 8 shards
    assert pc.snap_stride == 5  # ceil(225 / 50)
    assert pos_c.shape[0] == 45
    np.testing.assert_allclose(pos_s[::5], pos_c, rtol=2e-3, atol=2e-3)


def test_realtime_snapshot_cap_publishes_decimated_and_device_bao():
    st, prod = _producer(1024, "float32", 3, 2, snapshot_cap=128)
    assert st.positions.shape[0] == 128  # 1024 / stride 8
    for _ in range(3):
        prod.pump()
    prod.drain()
    eng = prod.engine
    assert st.positions.shape[0] == 128
    assert st.device_bao is not None
    assert st.device_bao == eng.history["bao_scale"][-1]
    assert st.metrics.clustering == eng.history["clustering"][-1]
    # the monitor thresholds the device value directly
    solver = te.BAOSolver(st)
    st.running = True
    solver.start()
    try:
        time.sleep(0.15)
    finally:
        st.running = False
        solver.join(timeout=2.0)
    assert not solver.is_alive()
    assert st.metrics.bao_scale == st.device_bao


@pytest.fixture
def jax_disk(monkeypatch):
    pos, vel, m = (np.array(a) for a in jg.create_disk_galaxy(
        jax.random.PRNGKey(42), 256))
    monkeypatch.setattr(tv, "create_disk_galaxy", lambda gen, n: tuple(
        torch.from_numpy(a.copy()) for a in (pos, vel, m)))


def test_precision_viewer_drifts_match_jax(jax_disk, tmp_path):
    want = jv.PrecisionCompareViewer(256, 42, steps_per_frame=5,
                                     out_dir=str(tmp_path / "jax"))
    got = tv.PrecisionCompareViewer(256, 42, steps_per_frame=5,
                                    out_dir=str(tmp_path / "torch"),
                                    device="cpu")
    assert got.broken.quantizer.custom_levels == 16
    assert not got.broken.quantize_forces
    for _ in range(3):
        want.step()
        got.step()
    h, w = got.history, want.history
    assert h["ticks"] == w["ticks"] == [5, 10, 15]
    np.testing.assert_allclose(h["drift_clean"], w["drift_clean"], rtol=0,
                               atol=2e-3)
    for t, j in zip(h["drift_broken"], w["drift_broken"]):
        assert abs(t - j) <= max(0.1 * abs(j), 5e-5), (t, j)
    np.testing.assert_allclose(
        h["ghost"], np.subtract(h["drift_broken"], h["drift_clean"]))
    path = got.render_frame()
    assert path is not None and path.stat().st_size > 10_000


@pytest.mark.parametrize("mode", ["clean", "broken"])
def test_precision_viewer_single_mode(mode, tmp_path):
    view = tv.PrecisionCompareViewer(64, 1, steps_per_frame=2,
                                     out_dir=str(tmp_path), mode=mode,
                                     device="cpu")
    assert (view.clean is None) == (mode == "broken")
    view.step()
    assert view.tick == 2 and view.history["ghost"] == [0.0]
    assert view.render_frame().name == f"{mode}_0000.png"


def test_no_matplotlib_renders_nothing_and_says_so_once(monkeypatch,
                                                        tmp_path, capsys):
    monkeypatch.setattr(te, "has_matplotlib", lambda: False)
    monkeypatch.setattr(tv, "has_matplotlib", lambda: False)
    st = te.SharedState()
    p = np.zeros((4, 2))
    st.publish_snapshot(p, p, 1, 10.0, 1.0)
    dash = te.RealtimeDashboard(st, str(tmp_path / "dash"))
    assert dash.render() is None and dash.render() is None
    view = tv.PrecisionCompareViewer(64, 1, steps_per_frame=1,
                                     out_dir=str(tmp_path / "view"),
                                     device="cpu")
    view.step()
    assert view.render_frame() is None
    assert view.animate(frames=2) is None
    assert view.tick == 3  # the frames were stepped all the same
    out = capsys.readouterr().out
    assert out.count(te.SKIPPED) == 2  # once each
    assert not list((tmp_path / "dash").iterdir())
    assert not list((tmp_path / "view").glob("*.png"))


@pytest.mark.parametrize("mesh", [False, True])
def test_main_writes_its_report(mesh, tmp_path, capsys):
    argv = ["--device", "cpu", "--seconds", "1", "--particles", "256",
            "--output", str(tmp_path)] + (["--mesh"] if mesh else [])
    report = te.main(argv)
    assert not _monitors_alive()
    saved = json.loads((tmp_path / "realtime_report.json").read_text())
    assert saved["final_tick"] == report["final_tick"] > 0
    assert saved["mesh_devices"] == (1 if mesh else 0)
    assert saved["desync_count"] == 0
    assert set(saved) == {"num_particles", "precision", "snapshot_cap",
                          "mesh_devices", "duration_s", "final_tick",
                          "final_redshift", "final_rsi", "mean_fps",
                          "step_ms_p50", "step_jitter_cv", "bao_scale_mpc",
                          "glitch_count", "desync_count", "events"}
    assert "FINAL REPORT" in capsys.readouterr().out


def test_visual_main_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tv, "has_matplotlib", lambda: False)
    view = tv.main(["--device", "cpu", "--stars", "64", "--frames", "2",
                    "--ticks-per-frame", "3", "--output", str(tmp_path)])
    hist = json.loads((tmp_path / "ghost_history.json").read_text())
    assert hist["ticks"] == [3, 6] == view.history["ticks"]


def test_precision_viewer_animate_headless(tmp_path):
    view = tv.PrecisionCompareViewer(48, 42, steps_per_frame=1,
                                     out_dir=str(tmp_path), device="cpu")
    path = view.animate(frames=2, save_path=tmp_path / "cmp.gif",
                        headless=True)
    assert path is not None and path.exists()
    assert len(view.history["ghost"]) >= 2


def test_realtime_engine_animate_headless(tmp_path):
    report = te.run_realtime_engine(num_particles=64, precision="float32",
                                    seconds=0.4, out_dir=str(tmp_path),
                                    frame_interval_s=2.0, animate=True,
                                    device="cpu")
    assert (tmp_path / "realtime.gif").exists()
    assert report["final_tick"] > 0
    assert not _monitors_alive()
