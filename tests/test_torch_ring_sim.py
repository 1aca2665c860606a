"""DirectSimulation(mesh=...) of nbody_tpu_torch against nbody_tpu's, on the CPU.

The engine's mesh surface: histories on virtual meshes against the JAX
engine on its virtual CPU devices, the resident padded state between
calls, ``ticks_per_dispatch`` as host chunking with identical physics, and
``run_comparison``. Inputs from the JAX package's disk ICs (numpy).

Tolerances as tests/test_torch_direct.py: float32 positions rtol 1e-4,
atol 1e-5, energies rtol 1e-5; float64 positions rtol 1e-6, atol 1e-7,
energies 1e-6; int4 final drift within 10% of JAX's (or 5e-7) and radius90
within 1% (bin-edge flips); mesh energies against the single-device
metrics 1e-6 relative (the energy tile's f32 row sums).
"""

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.models import direct as jd
from nbody_tpu.models import galaxy as jg
from nbody_tpu.parallel import ring as jring
from nbody_tpu_torch.diagnostics import metrics as tm
from nbody_tpu_torch.models import direct as td
from nbody_tpu_torch.parallel import ring

torch.set_num_threads(1)

N, TICKS, INTERVAL = 53, 20, 10


@pytest.fixture(scope="module")
def ics():
    pos, vel, m = jg.create_disk_galaxy(jax.random.PRNGKey(7), num_stars=N)
    return tuple(np.asarray(a) for a in (pos, vel, m))


def _radius90(pos):
    return float(np.percentile(np.sqrt((np.asarray(pos, np.float64) ** 2
                                        ).sum(1)), 90))


@pytest.mark.parametrize("n_shards,mode,schedule",
                         [(2, "float32", "sym"), (3, "int4", "sym"),
                          (4, "float64", "sym"), (2, "int4", "rows")])
def test_mesh_history_matches_jax(ics, n_shards, mode, schedule):
    jsim = jd.DirectSimulation(*ics, precision=mode,
                               mesh=jring.make_particle_mesh(n_shards),
                               schedule=schedule)
    tsim = td.DirectSimulation(*ics, precision=mode,
                               mesh=ring.ParticleMesh.virtual(n_shards,
                                                              "cpu"),
                               schedule=schedule)
    out = []
    for sim in (jsim, tsim):
        e0 = sim.get_total_energy()
        snaps, frames = sim.run_with_history(TICKS, INTERVAL)
        out.append((e0, snaps, np.asarray(sim.positions), np.asarray(frames)))
    (je0, js, jpos, jfr), (te0, ts, tpos, tfr) = out
    assert tpos.shape == (N, 2) and tfr.shape == (2, N, 2)
    assert tsim.state.positions.shape[0] % n_shards == 0  # resident, padded
    np.testing.assert_array_equal(ts.tick, np.asarray(js.tick))
    if mode == "int4":
        j_drift = (float(np.asarray(js.total)[-1]) - je0) / abs(je0)
        t_drift = (float(ts.total[-1]) - te0) / abs(te0)
        assert abs(t_drift - j_drift) <= max(0.1 * abs(j_drift), 5e-7)
        assert _radius90(tpos) == pytest.approx(_radius90(jpos), rel=0.01)
        return
    rtol, ptol = (1e-6, (1e-6, 1e-7)) if mode == "float64" else \
        (1e-5, (1e-4, 1e-5))
    np.testing.assert_allclose(te0, je0, rtol=rtol)
    np.testing.assert_allclose(tpos, jpos, rtol=ptol[0], atol=ptol[1])
    for field in ("kinetic", "potential", "total"):
        np.testing.assert_allclose(getattr(ts, field),
                                   np.asarray(getattr(js, field)), rtol=rtol)


@pytest.mark.parametrize("tpd", [4, 10, 25])
def test_ticks_per_dispatch_is_the_fused_history(ics, tpd, monkeypatch):
    """Caps below, at and above the snapshot interval chunk the history
    into ring calls of at most the cap; every bit of the history stays
    the same."""
    mesh = ring.ParticleMesh.virtual(3, "cpu")
    fused = td.DirectSimulation(*ics, precision="int4", mesh=mesh)
    capped = td.DirectSimulation(*ics, precision="int4", mesh=mesh,
                                 ticks_per_dispatch=tpd)
    fs, ff = fused.run_with_history(TICKS + 3, INTERVAL)
    calls = []
    steps, snaps = ring.run_steps_sharded, ring.run_with_snapshots_sharded

    def spy_steps(state, q, cfg, mesh, num_steps, **kw):
        calls.append(num_steps)
        return steps(state, q, cfg, mesh, num_steps, **kw)

    def spy_snaps(state, q, cfg, mesh, steps_per_chunk, num_chunks, **kw):
        calls.append(steps_per_chunk * num_chunks)
        return snaps(state, q, cfg, mesh, steps_per_chunk, num_chunks, **kw)

    monkeypatch.setattr(ring, "run_steps_sharded", spy_steps)
    monkeypatch.setattr(ring, "run_with_snapshots_sharded", spy_snaps)
    cs, cf = capped.run_with_history(TICKS + 3, INTERVAL)
    assert sum(calls) == TICKS + 3 and max(calls) <= tpd
    for field in fs._fields:
        np.testing.assert_array_equal(getattr(cs, field), getattr(fs, field))
    np.testing.assert_array_equal(cf, ff)
    assert capped.tick == fused.tick == TICKS + 3
    assert torch.equal(capped.positions, fused.positions)


def test_mesh_step_energies_and_resident_state(ics):
    """step() chains the resident padded state; the user surfaces trim it,
    and the mesh energies match the single-device metrics on the trimmed
    state."""
    sim = td.DirectSimulation(*ics, precision="float32",
                              mesh=ring.ParticleMesh.virtual(4, "cpu"),
                              ticks_per_dispatch=3)
    sim.step(7)
    assert sim.tick == 7 and sim.state.positions.shape == (56, 2)
    assert sim.positions.shape == (N, 2) and sim.masses.shape == (N,)
    assert sim.get_state()["positions"].shape == (N, 2)
    pe = tm.potential_energy(sim.positions, sim.masses, sim.cfg)
    assert sim.get_potential_energy() == pytest.approx(float(pe), rel=1e-6)
    np.testing.assert_allclose(
        sim.get_total_energy(),
        sim.get_kinetic_energy() + sim.get_potential_energy(), rtol=1e-12)
    single = td.DirectSimulation(*ics, precision="float32", device="cpu")
    single.step(7)
    np.testing.assert_allclose(sim.positions.numpy(),
                               single.positions.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_run_comparison_on_a_mesh(ics):
    res = td.run_comparison(*ics, modes=["float64", "int4"], num_ticks=10,
                            snapshot_interval=5,
                            mesh=ring.ParticleMesh.virtual(2, "cpu"))
    assert set(res) == {"float64", "int4_sim"}
    for r in res.values():
        assert r["final_state"]["tick"] == 10
        assert r["final_state"]["positions"].shape == (N, 2)
        assert len(r["snapshots"].tick) == 2
        assert np.isfinite(r["snapshots"].total).all()
