"""nbody_tpu_torch.models.direct against nbody_tpu.models.direct.

Both engines start from identical numpy ICs (N=128, 50 ticks, snapshots
every 25 ticks); the JAX side runs its dense oracle force, the port its
default path (the sym_force kernel's plain version on the CPU).

Tolerances: float32 / bf16 / f16 positions rtol 1e-4, atol 1e-5 and
snapshot energies rtol 1e-5; float64 positions and energies rtol 1e-6;
int modes final drift within 10% relative and radius90 within 1% (bin-edge
flips make their trajectories differ pair by pair).
"""

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.models import direct as jd
from nbody_tpu.models import galaxy as jg
from nbody_tpu_torch.models import direct as td
from nbody_tpu_torch.models.state import (BaselineState, ParticleState,
                                          from_jax_numpy)
from nbody_tpu_torch.ops.precision import Precision

torch.set_num_threads(1)

N, TICKS, INTERVAL = 128, 50, 25


@pytest.fixture(scope="module")
def ics():
    pos, vel, m = jg.create_disk_galaxy(jax.random.PRNGKey(3), num_stars=N)
    return tuple(np.asarray(a) for a in (pos, vel, m))


def _run_both(ics, mode, **kwargs):
    jsim = jd.DirectSimulation(*ics, precision=mode, force_impl="dense",
                               **kwargs)
    tsim = td.DirectSimulation(*ics, precision=mode, **kwargs)
    out = []
    for sim in (jsim, tsim):
        e0 = sim.get_total_energy()
        snaps, frames = sim.run_with_history(TICKS, INTERVAL)
        out.append((e0, snaps, np.asarray(sim.positions), np.asarray(frames)))
    return out


def _radius90(pos):
    return float(np.percentile(np.sqrt((pos.astype(np.float64) ** 2
                                        ).sum(1)), 90))


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "float16"])
def test_float_modes_match_jax(ics, mode):
    (_, js, jpos, jfr), (_, ts, tpos, tfr) = _run_both(ics, mode)
    np.testing.assert_allclose(tpos, jpos, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tfr, jfr, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ts.tick, np.asarray(js.tick))
    for field in ("kinetic", "potential", "total"):
        np.testing.assert_allclose(getattr(ts, field),
                                   np.asarray(getattr(js, field)), rtol=1e-5)


def test_float64_baseline_matches_jax(ics):
    (je0, js, jpos, _), (te0, ts, tpos, _) = _run_both(ics, "float64")
    np.testing.assert_allclose(tpos, jpos, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(te0, je0, rtol=1e-6)
    for field in ("kinetic", "potential", "total"):
        np.testing.assert_allclose(getattr(ts, field),
                                   np.asarray(getattr(js, field)), rtol=1e-6)


@pytest.mark.parametrize("mode,kwargs", [("int8", {}), ("int4", {}),
                                         ("custom", {}),
                                         ("int4", {"bounds_every": 4})])
def test_int_modes_match_jax(ics, mode, kwargs):
    (je0, js, jpos, _), (te0, ts, tpos, _) = _run_both(ics, mode, **kwargs)
    j_drift = (float(np.asarray(js.total)[-1]) - je0) / abs(je0)
    t_drift = (float(ts.total[-1]) - te0) / abs(te0)
    # Widened by an absolute floor for int8: its 256-level grid barely
    # perturbs this galaxy in 50 ticks (drift 1.4e-6, float32's own is
    # 1.3e-7), and one bin-edge flip moves that drift by ~3e-7, so 10% of
    # it is below what a different summation order alone can do.
    tol = max(0.1 * abs(j_drift), 5e-7)
    assert abs(t_drift - j_drift) <= tol, (t_drift, j_drift)
    np.testing.assert_allclose(_radius90(tpos), _radius90(jpos), rtol=0.01)
    assert np.isfinite(tpos).all()


def test_bounds_every_changes_int4_trajectory(ics):
    """bounds_every=4 reuses stale bounds: a different (documented)
    trajectory from the exact per-step bounds, on both engines."""
    exact = td.DirectSimulation(*ics, precision="int4")
    reuse = td.DirectSimulation(*ics, precision="int4", bounds_every=4)
    exact.step(TICKS)
    reuse.step(TICKS)
    assert not torch.equal(exact.positions, reuse.positions)


def test_from_jax_numpy_baseline_state(ics):
    jsim = jd.DirectSimulation(*ics, precision="float64")
    jsim.step(7)
    exported = jax.tree.map(np.asarray, jsim.state)
    state = from_jax_numpy(exported)
    assert isinstance(state, BaselineState)
    assert state.tick == 7
    assert state.positions.dtype == torch.float64
    want = (exported.positions.hi.astype(np.float64)
            + exported.positions.lo.astype(np.float64))
    np.testing.assert_array_equal(state.positions.numpy(), want)
    np.testing.assert_array_equal(
        state.velocities.numpy(),
        exported.velocities.hi.astype(np.float64)
        + exported.velocities.lo.astype(np.float64))
    np.testing.assert_array_equal(state.masses.numpy(),
                                  exported.masses.astype(np.float64))
    np.testing.assert_array_equal(state.accelerations.numpy(),
                                  exported.accelerations.astype(np.float64))
    # and the f32 view equals JAX's own f32 view of its state
    np.testing.assert_allclose(state.to_f32().positions.numpy(),
                               np.asarray(jsim.positions), rtol=1e-7)


def test_from_jax_numpy_particle_state(ics):
    jsim = jd.DirectSimulation(*ics, precision="float32", force_impl="dense")
    jsim.step(3)
    exported = jax.tree.map(np.asarray, jsim.state)
    state = from_jax_numpy(exported)
    assert isinstance(state, ParticleState) and state.tick == 3
    for field in ("positions", "velocities", "masses", "accelerations"):
        t = getattr(state, field)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), getattr(exported, field))
    # one more step from the imported state agrees with JAX's next step
    sim = td.DirectSimulation(*ics, precision="float32")
    sim.state = state
    sim.step(1)
    jsim.step(1)
    np.testing.assert_allclose(sim.positions.numpy(),
                               np.asarray(jsim.positions), rtol=1e-6,
                               atol=1e-7)


def test_engine_surface(ics):
    sim = td.DirectSimulation(*ics, precision=Precision.FLOAT32)
    seen = []
    sim.run(30, callback=lambda s, tick: seen.append(tick),
            callback_interval=12)
    assert seen == [12, 24, 30] and sim.tick == 30
    state = sim.get_state()
    assert state["precision_mode"] == "float32" and state["tick"] == 30
    assert state["positions"].shape == (N, 2)
    assert np.isfinite(sim.get_kinetic_energy() + sim.get_potential_energy())
    np.testing.assert_allclose(
        sim.get_total_energy(),
        sim.get_kinetic_energy() + sim.get_potential_energy(), rtol=1e-12)
    snaps, frames = sim.run_with_history(30, snapshot_interval=20)
    assert sim.tick == 60 and frames.shape == (1, N, 2)
    assert list(snaps.tick) == [50]


def test_run_comparison(ics):
    res = td.run_comparison(*ics, modes=["float64", "int4"], num_ticks=20,
                            snapshot_interval=10)
    assert set(res) == {"float64", "int4_sim"}
    for r in res.values():
        assert r["final_state"]["tick"] == 20
        assert len(r["snapshots"].tick) == 2
        assert np.isfinite(r["snapshots"].total).all()


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"schedule": "sym"},
                                    {"ticks_per_dispatch": 10},
                                    {"dynamic_params": True},
                                    {"bounds_mode": "cached"}])
def test_unported_options_raise(ics, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        td.DirectSimulation(*ics, precision="int4", **kwargs)


def test_unknown_force_impl_raises(ics):
    with pytest.raises(ValueError, match="unknown force impl"):
        td.DirectSimulation(*ics, force_impl="pallas")
