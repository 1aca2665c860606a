"""nbody_tpu_torch.engines.cosmo against nbody_tpu.engines.cosmo, on the CPU.

Tolerances and why:

* ICs from JAX's own phases (``jax.random.uniform`` fed to the port's
  ``zeldovich_from_uniform``): positions and velocities at 1e-5 of their
  largest magnitude (positions by periodic distance).
* One ``run_pm_steps`` chunk from a state carried across
  (``CosmologicalEngine.load_jax_state``), float32 / int4, ngp / cic,
  D = 2 / 3, in two regimes. A quasi-static chunk (4 steps of dz = 0.001):
  positions and velocities at atol 1e-5 max|x|. One step of the engine's
  own dz = 1: velocities at atol 1e-5 max|v|; positions there are taken
  modulo the box after a displacement of many box lengths (the reference's
  units), so f32 cannot place them better than the displacement's
  rounding: atol 1e-5 max|x| plus (|dv| + 2^-22 |v|) dt / a * unit_scale.
  The StepStream: kinetic energy rtol 1e-5, momentum within 1e-5 of the
  summed |m v| (its terms cancel), the subnormal counts equal. In int4 at
  most max(4, 1e-4 x components) components may fall outside, each by at
  most the force grid's steps over the chunk.
* The whole N=1024 run from the reference's cached ICs, the port against
  JAX (both on the CPU) and against the cached torch-reference run, must
  AGREE under ``tools/pm_reference_parity.compare_mode``'s rule; the
  port's own copy of the rule gives the same rows.
* Pipelined equals sequential, a seed reproduces itself and
  checkpoint/resume reproduces the full history, all bit for bit.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.config import PLANCK18
from nbody_tpu.engines import cosmo as jc
from nbody_tpu_torch.diagnostics import pm_gate
from nbody_tpu_torch.engines import cosmo as tc
from nbody_tpu_torch.utils.checkpoint import CheckpointManager
from tools import pm_reference_parity as tool

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _kw(mode="float32", deposit="ngp", dim=2, z=50.0):
    return dict(num_particles=1024 if dim == 2 else 512, start_redshift=z,
                precision=mode, dim=dim, n_grid=32 if dim == 2 else 16,
                deposit=deposit, seed=3)


def _periodic(a, b, box):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, box - d)


# --------------------------------------------------------------------------
# Initial conditions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dim, side", [(2, 32), (3, 8)])
def test_ics_from_jax_phases(dim, side):
    jcfg = jc.PMConfig(dim=dim, n_grid=32, box_size=200.0)
    tcfg = tc.PMConfig(dim=dim, n_grid=32, box_size=200.0)
    key = jax.random.PRNGKey(11)
    jpos, jvel, jm = (np.asarray(x) for x in jc.make_zeldovich_ics(
        key, side, jcfg, 50.0, PLANCK18))
    uniform = np.asarray(jax.random.uniform(key, (side,) * dim))
    tpos, tvel, tm = (x.numpy() for x in tc.zeldovich_from_uniform(
        torch.from_numpy(uniform.copy()), side, tcfg, 50.0))
    assert tpos.shape == jpos.shape == (side ** dim, dim)
    assert _periodic(tpos, jpos, 200.0).max() <= 1e-5 * np.abs(jpos).max()
    np.testing.assert_allclose(tvel, jvel, rtol=0,
                               atol=1e-5 * np.abs(jvel).max())
    np.testing.assert_array_equal(tm, jm)


def test_ics_come_from_a_torch_generator():
    a = tc.make_zeldovich_ics(torch.Generator().manual_seed(5), 16,
                              tc.PMConfig(), 50.0)
    b = tc.make_zeldovich_ics(torch.Generator().manual_seed(5), 16,
                              tc.PMConfig(), 50.0)
    c = tc.make_zeldovich_ics(torch.Generator().manual_seed(6), 16,
                              tc.PMConfig(), 50.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


# --------------------------------------------------------------------------
# One chunk from a carried-across state
# --------------------------------------------------------------------------

def _force_grid_steps(je, state, sched):
    """Sum over the chunk's steps of one int4 force-grid step x dt, bounded
    by the chunk's start accelerations (the grid spans min..max of the
    acceleration components, 15 steps)."""
    acc = np.asarray(jc.pm_accelerations(state.positions, state.masses,
                                         je.quantizer, je.cfg, sched[3][0],
                                         False))
    return 2.0 * (acc.max() - acc.min()) / 15.0 * float(np.sum(sched[1]))


@pytest.mark.parametrize("regime", ["quasi_static", "one_step"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("deposit", ["ngp", "cic"])
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_run_pm_steps_chunk_matches_jax(mode, deposit, dim, regime):
    je = jc.CosmologicalEngine(**_kw(mode, deposit, dim))
    te = tc.CosmologicalEngine(device="cpu", **_kw(mode, deposit, dim))
    te.load_jax_state(jax.tree.map(np.asarray, je.state), je.mass_unit_msun)
    assert te.cfg.G == je.cfg.G
    assert torch.equal(te.state.positions,
                       torch.from_numpy(np.asarray(je.state.positions)))
    dz, steps = (0.001, 4) if regime == "quasi_static" else (1.0, 1)
    sched, z_end = je._build_schedule(dz, steps)
    js, jstream = jc.run_pm_steps(je.state, sched, je.quantizer, je.cfg)
    ts, tstream = tc.run_pm_steps(te.state, sched, te.quantizer, te.cfg)
    assert ts.redshift == z_end == float(js.redshift)
    assert ts.tick == int(js.tick) == steps

    jv, tv = np.asarray(js.velocities), ts.velocities.numpy()
    jp, tp = np.asarray(js.positions), ts.positions.numpy()
    dv = np.abs(tv.astype(np.float64) - jv)
    v_bound = np.full(dv.shape, 1e-5 * np.abs(jv).max())
    x_bound = np.full(dv.shape, 1e-5 * np.abs(jp).max())
    if regime == "one_step":
        move = float(sched[1][0] / sched[3][0]) * je.cfg.unit_scale
        x_bound = x_bound + (dv + 2.0 ** -22 * np.abs(jv)) * move
    bad = (dv > v_bound) | (_periodic(tp, jp, je.cfg.box_size) > x_bound)
    if mode == "int4":
        assert bad.sum() <= max(4, 1e-4 * bad.size)
        assert np.all(dv[bad] <= v_bound[bad]
                      + _force_grid_steps(je, je.state, sched))
    else:
        assert not bad.any(), (dv / v_bound).max()

    np.testing.assert_allclose(tstream.kinetic.numpy(),
                               np.asarray(jstream.kinetic), rtol=1e-5)
    m = np.asarray(js.masses, np.float64)
    terms = np.sum(m[:, None] * np.abs(jv), axis=0)
    assert np.all(np.abs(tstream.momentum.numpy()[-1]
                         - np.asarray(jstream.momentum)[-1])
                  <= 1e-5 * terms)
    np.testing.assert_array_equal(tstream.subnormals.numpy(),
                                  np.asarray(jstream.subnormals))
    np.testing.assert_array_equal(tstream.redshift.numpy(),
                                  np.asarray(jstream.redshift))


# --------------------------------------------------------------------------
# The whole N=1024 run from the reference's cached ICs
# --------------------------------------------------------------------------

def test_whole_n1024_run_agrees_with_jax_and_the_reference():
    ics = pm_gate.load_ics(1024)
    ours, _ = pm_gate.run_engine(ics, "float32", "cpu")
    assert len(ours["energies"]) == 50 and ours["redshifts"][-1] == \
        pytest.approx(0.01)
    jax_run = tool.run_ours_pm(ics, 1024, 50.0, "float32")
    jax_run["n"] = 1024
    row = tool.compare_mode(jax_run, ours, None, "float32")
    assert row["agree"], {k: v for k, v in row.items()
                          if not isinstance(v, list)}
    ref = pm_gate.load_reference(1024, "float32")
    row = tool.compare_mode(ref, ours, None, "float32")
    assert row["agree"]
    own = pm_gate.compare_mode(ref, ours, None)
    assert own["agree"]
    for k in own.keys() & row.keys():
        assert row[k] == own[k], k


def test_port_gate_rule_equals_the_tool_with_a_twin():
    ref = pm_gate.load_reference(10000, "int4")
    twin = pm_gate.load_reference(10000, "int4", perturbed=True)
    fake = dict(ref, energies=[e * (1.0 + 0.01 * (i % 3))
                               for i, e in enumerate(ref["energies"])])
    want = tool.compare_mode(ref, fake, twin, "int4")
    got = pm_gate.compare_mode(ref, fake, twin)
    shared = got.keys() & want.keys()
    assert len(shared) >= 16
    for k in shared:
        assert want[k] == got[k], k
    assert pm_gate.ReferenceCosmology().cosmic_time_gyr(7.3) == \
        tool.ReferenceCosmology().cosmic_time_gyr(7.3)


# --------------------------------------------------------------------------
# Engine: determinism, pipelining, checkpoints, surfaces
# --------------------------------------------------------------------------

ENGINE_KW = dict(num_particles=256, start_redshift=10.0, precision="int4",
                 dim=2, n_grid=16, seed=11, device="cpu")


def _same_history(a, b):
    for key in ("energy", "redshift", "time_gyr", "bao_scale",
                "clustering"):
        np.testing.assert_array_equal(np.asarray(a.history[key]),
                                      np.asarray(b.history[key]),
                                      err_msg=key)
    assert [dataclasses.asdict(g) for g in a.history["glitches"]] == \
        [dataclasses.asdict(g) for g in b.history["glitches"]]
    for ea, eb in zip(a.history["exploits"], b.history["exploits"]):
        assert ea.keys() == eb.keys()
        for k in ea:
            va, vb = ea[k], eb[k]
            if dataclasses.is_dataclass(va):
                assert type(va) is type(vb), k
                assert dataclasses.asdict(va) == dataclasses.asdict(vb), k
            else:
                assert va == vb, k
    assert a.glitch_detector.energy_history == \
        b.glitch_detector.energy_history
    assert a.exploit_engine.initial_bits == b.exploit_engine.initial_bits
    assert a.exploit_engine.gamma_history == b.exploit_engine.gamma_history


def test_pipelined_equals_sequential_bitwise():
    a = tc.CosmologicalEngine(**ENGINE_KW)
    b = tc.CosmologicalEngine(**ENGINE_KW)
    a.run_to_completion(dz=1.0, chunk=3)
    b.run_to_completion(dz=1.0, chunk=3, pipelined=True)
    assert a.completed and b.completed and a.tick == b.tick == 10
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.velocities, b.velocities)
    _same_history(a, b)


def test_same_seed_is_bitwise_reproducible():
    a = tc.CosmologicalEngine(**dict(ENGINE_KW, deposit="cic"))
    b = tc.CosmologicalEngine(**dict(ENGINE_KW, deposit="cic"))
    assert torch.equal(a.positions, b.positions)
    a.step(1.0, 4)
    b.step(1.0, 4)
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.velocities, b.velocities)
    _same_history(a, b)
    c = tc.CosmologicalEngine(**dict(ENGINE_KW, seed=12))
    assert not torch.equal(c.positions,
                           tc.CosmologicalEngine(**ENGINE_KW).positions)


def test_checkpoint_resume_reproduces_full_history(tmp_path):
    a = tc.CosmologicalEngine(**ENGINE_KW)
    a.step(1.0, 4)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert a.save_checkpoint(mgr) == 4
    a.step(1.0, 3)

    b = tc.CosmologicalEngine(**ENGINE_KW)  # "crashed" process restarts
    assert b.restore_latest(mgr) == 4
    assert b.tick == 4 and b.redshift == pytest.approx(6.0)
    b.step(1.0, 3)
    assert torch.equal(a.positions, b.positions)
    _same_history(a, b)
    assert len(a.glitch_detector.events) == len(b.glitch_detector.events)


def test_resumable_run_resumes_a_direct_simulation(tmp_path):
    """ResumableRun over the port's DirectSimulation: a run cut at tick 10
    resumes from its checkpoint and ends where an uncut run ends."""
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.utils.checkpoint import ResumableRun

    rng = np.random.default_rng(0)
    pos = rng.standard_normal((64, 2)).astype(np.float32) * 5
    vel = rng.standard_normal((64, 2)).astype(np.float32) * 0.1
    m = np.full(64, 1.0, np.float32)

    def sim():
        return DirectSimulation(pos, vel, m, precision="int4", device="cpu")

    whole = ResumableRun(sim(), CheckpointManager(str(tmp_path / "a")),
                         checkpoint_every=5).run(15)
    mgr = CheckpointManager(str(tmp_path / "b"))
    ResumableRun(sim(), mgr, checkpoint_every=5).run(10)
    resumed = ResumableRun(sim(), mgr, checkpoint_every=5).run(15)
    assert resumed.state.tick == whole.state.tick == 15
    assert torch.equal(resumed.state.positions, whole.state.positions)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    e = tc.CosmologicalEngine(**ENGINE_KW)
    for _ in range(3):
        e.step(1.0, 1)
        e.save_checkpoint(mgr)
    assert mgr.latest_step() == 3
    assert len(list(tmp_path.glob("ckpt_*.npz"))) == 2
    st = mgr.restore(3, e.state)
    assert isinstance(st.tick, int) and isinstance(st.redshift, float)
    assert torch.equal(st.positions, e.positions)
    assert mgr.load_metadata(3)["num_particles"] == 256


def test_engine_surfaces():
    from nbody_tpu_torch.parallel.ring import ParticleMesh

    meshed = tc.CosmologicalEngine(mesh=ParticleMesh.virtual(2, "cpu"),
                                   **ENGINE_KW)
    assert meshed.mesh.size == 2 and meshed.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            tc.CosmologicalEngine(num_particles=64)
    e = tc.CosmologicalEngine(**ENGINE_KW)
    e.step(1.0, 2)
    k, pk = e.compute_power_spectrum()
    assert k.shape == pk.shape == (19,) and np.isfinite(pk).all()
    assert np.isfinite(e.get_clustering()) and e.get_kinetic_energy() > 0
    assert len(e.get_total_momentum()) == 2
    d = e.get_state_dict()
    assert d["tick"] == 2 and d["positions"].shape == (256, 2)
    capped = tc.CosmologicalEngine(**dict(ENGINE_KW, snapshot_cap=100))
    assert capped.snapshot_stride == 3
    pos_h, _ = capped.collect_step(capped.dispatch_step(1.0, 1))
    assert pos_h.shape == (86, 2)


def test_universe2d_cli_runs_on_the_cpu_without_jax(tmp_path):
    """``python -m nbody_tpu_torch.engines.universe2d`` end to end on the
    CPU; the process never imports jax, nbody_tpu or tools."""
    out = tmp_path / "u2d"
    code = (
        "import runpy, sys\n"
        "sys.argv = ['universe2d', '--device', 'cpu', '--particles', "
        f"'1024', '--frames', '1', '--headless', '--output', '{out}']\n"
        "runpy.run_module('nbody_tpu_torch.engines.universe2d', "
        "run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'nbody_tpu', 'tools')]\n"
        "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    report = json.loads((out / "universe2d_report.json").read_text())
    assert report["device"] == "cpu" and report["ticks"] == 50
    assert report["final_redshift"] == pytest.approx(0.01)
    assert "Done in" in run.stdout
    from nbody_tpu_torch.engines import universe2d
    meshed = universe2d.main(["--device", "cpu", "--mesh", "--particles",
                              "256", "--start-z", "3", "--frames", "1",
                              "--headless", "--output",
                              str(tmp_path / "mesh")])
    assert meshed["ticks"] == 3
