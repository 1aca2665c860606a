"""nbody_tpu_torch.models.direct against nbody_tpu.models.direct.

Both engines start from identical numpy ICs (N=128, 50 ticks, snapshots
every 25 ticks); the JAX side runs its dense oracle force, the port its
default path on ``device="cpu"``: the equal masses of the disk and
N = 2 x 64 take the sym_force kernel's equal-mass variant, its plain
version here.

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
    tsim = td.DirectSimulation(*ics, precision=mode, device="cpu",
                               **kwargs)
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
    exact = td.DirectSimulation(*ics, precision="int4", device="cpu")
    reuse = td.DirectSimulation(*ics, precision="int4", bounds_every=4,
                                device="cpu")
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
    sim = td.DirectSimulation(*ics, precision="float32", device="cpu")
    sim.state = state
    sim.step(1)
    jsim.step(1)
    np.testing.assert_allclose(sim.positions.numpy(),
                               np.asarray(jsim.positions), rtol=1e-6,
                               atol=1e-7)


def test_engine_surface(ics):
    sim = td.DirectSimulation(*ics, precision=Precision.FLOAT32,
                              device="cpu")
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
                            snapshot_interval=10, device="cpu")
    assert set(res) == {"float64", "int4_sim"}
    for r in res.values():
        assert r["final_state"]["tick"] == 20
        assert len(r["snapshots"].tick) == 2
        assert np.isfinite(r["snapshots"].total).all()


def _virtual_mesh(n_shards):
    from nbody_tpu_torch.parallel import ring
    return ring.ParticleMesh.virtual(n_shards, "cpu")


# The JAX engine's rules for the ring's options (direct.py:523-563), each
# a ValueError with its message.
MESH_RULES = {
    "mesh with dynamic_params": (dict(mesh=2, dynamic_params=True),
                                 "dynamic_params is not supported with"),
    "mesh with a force_impl": (dict(mesh=2, force_impl="kernel"),
                               "force_impl is single-device only"),
    "bounds_every with rows": (dict(mesh=2, schedule="rows",
                                    bounds_every=2),
                               "bounds_every > 1 needs schedule='sym'"),
    "ticks_per_dispatch without mesh": (dict(ticks_per_dispatch=5),
                                        "only applies to mesh runs"),
    "ticks_per_dispatch below 1": (dict(mesh=2, ticks_per_dispatch=0),
                                   "must be >= 1"),
    "ticks_per_dispatch with bounds_every": (
        dict(mesh=2, ticks_per_dispatch=5, bounds_every=2),
        "cannot be combined with bounds_every > 1"),
}


@pytest.mark.parametrize("rule", list(MESH_RULES))
def test_mesh_rules_raise_value_error(ics, rule):
    kwargs, message = MESH_RULES[rule]
    if "mesh" in kwargs:
        kwargs = {**kwargs, "mesh": _virtual_mesh(kwargs["mesh"])}
    with pytest.raises(ValueError, match=message):
        td.DirectSimulation(*ics, precision="int4", device="cpu", **kwargs)


def test_unknown_force_impl_raises(ics):
    with pytest.raises(ValueError, match="unknown force impl"):
        td.DirectSimulation(*ics, force_impl="pallas", device="cpu")


# --------------------------------------------------------------------------
# Routing by size, run-time parameters and the repairs that came with them
# --------------------------------------------------------------------------

def test_auto_routes_by_scratch_budget():
    """'auto' keeps the single-launch sym_force while its per-tile scratch
    fits the stated budget and takes the chunked path past it."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    assert td._resolve_impl("auto", 5000, 2) == "kernel"
    assert td._resolve_impl("auto", 131072, 3) == "kernel"
    for dim in (2, 3):
        assert td._resolve_impl("auto", 1_048_576, dim) == \
            "kernel_sym_chunked"
        assert hn.sym_force_scratch_bytes(1_048_576, dim) > \
            hn.SCRATCH_BUDGET
        # the largest N that still fits is the routing threshold
        n = 64
        while hn.sym_force_fits(n + 64, dim):
            n += 64
        assert td._resolve_impl("auto", n, dim) == "kernel"
        assert td._resolve_impl("auto", n + 64, dim) == "kernel_sym_chunked"
    assert td._resolve_impl("kernel_rows", 10, 2) == "kernel_rows"


@pytest.mark.parametrize("dim", [2, 3])
def test_chunk_size_fits_the_budget_at_1m(dim):
    from nbody_tpu_torch.ops import hopper_nbody as hn
    n = 1_048_576
    chunk = hn.sym_chunk_size(n, dim)
    n_chunks = -(-n // chunk)
    assert chunk % hn.TILE == 0 and n_chunks == {2: 5, 3: 6}[dim]
    assert (hn.sym_force_scratch_bytes(chunk, dim)
            + hn.pair_sym_force_scratch_bytes(chunk, chunk, dim)
            <= hn.SCRATCH_BUDGET)
    # the last chunk is no sliver: chunks are spread evenly
    assert n - (n_chunks - 1) * chunk > 0.9 * chunk
    assert hn.sym_chunk_size(1000, dim) == 1024  # one chunk, tile-rounded


@pytest.mark.parametrize("impl", ["kernel_rows", "kernel_streamed",
                                  "kernel_sym_chunked"])
def test_named_kernel_paths_match_jax(ics, impl):
    jimpl = {"kernel_rows": "pallas_rows",
             "kernel_streamed": "pallas_streamed",
             "kernel_sym_chunked": "pallas_sym_chunked"}[impl]
    jsim = jd.DirectSimulation(*ics, precision="float32", force_impl=jimpl)
    tsim = td.DirectSimulation(*ics, precision="float32", force_impl=impl,
                               device="cpu")
    jsim.step(10)
    tsim.step(10)
    np.testing.assert_allclose(tsim.positions.numpy(),
                               np.asarray(jsim.positions), rtol=1e-4,
                               atol=1e-5)


def test_bounds_every_rejected_on_paths_without_external_bounds(ics):
    """As in JAX (direct.py:172-176): only dense, tiled and the sym kernel
    take external int-sim bounds."""
    for impl in ("kernel_rows", "kernel_streamed", "kernel_sym_chunked"):
        sim = td.DirectSimulation(*ics, precision="int4", force_impl=impl,
                                  bounds_every=4, device="cpu")
        with pytest.raises(ValueError, match="bounds_every > 1"):
            sim.step(2)


def test_dynamic_params_float64_raises_value_error(ics):
    with pytest.raises(ValueError, match="dynamic_params"):
        td.DirectSimulation(*ics, precision="float64", dynamic_params=True,
                            device="cpu")


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_dynamic_params_drift_matches_jax(ics, mode):
    """dt and softening as run-time scalars, on both engines: the drift
    curve over 4 snapshot chunks (float32 rtol 1e-5 on the energies; int4
    within 10% of JAX's drift, the int rule above). The snapshots' PE uses
    cfg's softening in both, as the JAX engine's fused snapshot does."""
    kw = dict(precision=mode, dynamic_params=True, softening=0.08, dt=0.005)
    jsim = jd.DirectSimulation(*ics, force_impl="dense", **kw)
    tsim = td.DirectSimulation(*ics, device="cpu", **kw)
    assert tsim._dyn_soft_sq.dtype == torch.float32
    assert float(tsim._dyn_soft_sq) == np.float32(0.08 * 0.08)
    je0, te0 = jsim.get_total_energy(), tsim.get_total_energy()
    np.testing.assert_allclose(te0, je0, rtol=1e-6)
    jsn, _ = jsim.run_with_history(40, 10)
    tsn, _ = tsim.run_with_history(40, 10)
    jt, tt = np.asarray(jsn.total, np.float64), np.asarray(tsn.total)
    if mode == "float32":
        np.testing.assert_allclose(tt, jt, rtol=1e-5)
        np.testing.assert_allclose(tsim.positions.numpy(),
                                   np.asarray(jsim.positions), rtol=1e-4,
                                   atol=1e-5)
    else:
        j_drift, t_drift = (jt[-1] - je0) / abs(je0), (tt[-1] - te0) / abs(te0)
        assert abs(t_drift - j_drift) <= max(0.1 * abs(j_drift), 5e-7)


def test_dynamic_params_equal_static_run_bitwise(ics):
    """The same values as run-time scalars or as cfg constants give the
    same bits: the launches see the same numbers."""
    static = td.DirectSimulation(*ics, precision="int4", device="cpu")
    dynamic = td.DirectSimulation(*ics, precision="int4",
                                  dynamic_params=True, device="cpu")
    static.step(20)
    dynamic.step(20)
    assert torch.equal(static.positions, dynamic.positions)


def test_energies_use_the_run_time_softening(ics):
    from nbody_tpu_torch.diagnostics import metrics as tm
    sim = td.DirectSimulation(*ics, precision="float32",
                              dynamic_params=True, softening=0.3,
                              device="cpu")
    want = tm.potential_energy(sim.positions, sim.masses, sim.cfg,
                               softening_sq=torch.tensor(0.09))
    assert sim.get_potential_energy() == pytest.approx(float(want),
                                                       rel=1e-12)
    static_pe = float(tm.potential_energy(sim.positions, sim.masses,
                                          sim.cfg))
    assert abs(sim.get_potential_energy() - static_pe) > 1e-3 * abs(
        static_pe)
    np.testing.assert_allclose(
        sim.get_total_energy(),
        sim.get_kinetic_energy() + sim.get_potential_energy(), rtol=1e-12)
