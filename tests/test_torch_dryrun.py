"""nbody_tpu_torch.dryrun against the root __graft_entry__.py, on the CPU.

``dryrun_multichip(n, device="cpu")`` runs JAX's seven multi-device
surfaces on ``ParticleMesh.virtual(n, "cpu")`` at n = 6 (odd shard
padding everywhere), 8 (JAX's default) and 16 (past one half-ring wrap,
and more shards than the 16-cell grid's half spectrum has columns), as
tests/test_dryrun_meshes.py runs JAX's. ``entry``'s step and the ring
surface run on JAX's ICs against JAX's own, with the tolerances of
tests/test_torch_direct.py (one float32 tick: positions and velocities
rtol 1e-4, atol 1e-5) and tests/test_torch_ring.py (int4: fewer than 2%
of the force components off by more than 1e-4 max|a|, the energy drift
within 10% of JAX's or 5e-7). The slab Poisson solve with empty spectrum
blocks is held to the single-device solve as
tests/test_torch_pm_sharded.py holds it (atol 1e-5 max|grad|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nbody_tpu.config import DEFAULT_SIM as JAX_SIM
from nbody_tpu.diagnostics import metrics as jm
from nbody_tpu.models import galaxy as jg
from nbody_tpu.models import state as jstate
from nbody_tpu.ops.precision import Precision as JaxPrecision
from nbody_tpu.ops.precision import Quantizer as JaxQuantizer
from nbody_tpu.parallel import ring as jring
from nbody_tpu_torch import dryrun
from nbody_tpu_torch.config import DEFAULT_SIM
from nbody_tpu_torch.diagnostics import metrics as tm
from nbody_tpu_torch.engines import cosmo as tc
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops import pm as tpm
from nbody_tpu_torch.parallel import pm_sharded, ring

torch.set_num_threads(1)


def _jax_disk(seed, n):
    return tuple(np.array(x) for x in jg.create_disk_galaxy(
        jax.random.PRNGKey(seed), num_stars=n))


@pytest.mark.parametrize("n_devices", [6, 8, 16])
def test_dryrun_multichip_mesh_shapes(n_devices, capsys):
    dryrun.dryrun_multichip(n_devices, device="cpu")
    assert f"dryrun_multichip OK on {n_devices} devices" in \
        capsys.readouterr().out


def test_entry_step_matches_jax_entry():
    fn, (state,) = dryrun.entry("cpu")
    assert state.positions.shape == (dryrun.ENTRY_STARS, 2)
    out = fn(state)
    assert out.tick == 1 and bool(torch.isfinite(out.positions).all())
    jfn, (jst,) = graft.entry()
    want = jfn(jst)
    got = fn(make_state(*(np.asarray(x) for x in (
        jst.positions, jst.velocities, jst.masses))))
    for field in ("positions", "velocities"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-4, atol=1e-5)


def test_ring_surface_matches_jax_ring():
    """The dry run's int4 ring tick on JAX's ICs (8 shards, 128 stars)
    against JAX's run_steps_sharded on its 8 CPU devices."""
    pos, vel, m = _jax_disk(0, 16 * 8)
    jout, jes = jring.run_steps_sharded(
        jstate.make_state(jnp.asarray(pos), jnp.asarray(vel),
                          jnp.asarray(m)),
        JaxQuantizer(JaxPrecision.INT4_SIM), JAX_SIM,
        jring.make_particle_mesh(8), num_steps=1, quantize_forces=True,
        steps_per_chunk=1)
    tout, tes = dryrun.ring_surface(make_state(pos, vel, m),
                                    ring.ParticleMesh.virtual(8, "cpu"))
    got, want = tout.accelerations.numpy(), np.asarray(jout.accelerations)
    off = np.abs(got - want) > 1e-4 * np.abs(want).max()
    assert off.mean() < 0.02, f"{off.mean():.3%} components off"
    e0 = float(tm.total_energy(*(torch.from_numpy(x) for x in (pos, vel, m)),
                               DEFAULT_SIM))
    je0 = float(jm.total_energy(jnp.asarray(pos), jnp.asarray(vel),
                                jnp.asarray(m), JAX_SIM))
    j_drift = (float(np.asarray(jes.total)[-1]) - je0) / abs(je0)
    t_drift = (float(tes.total[-1]) - e0) / abs(e0)
    assert abs(t_drift - j_drift) <= max(0.1 * abs(j_drift), 5e-7)


@pytest.mark.parametrize("dim", [2, 3])
def test_slab_solve_with_more_shards_than_spectrum_columns(dim):
    """16 shards over a 16-cell grid: the half spectrum's 9 columns leave
    7 shards none, and the slab solve still gives the single device's
    gradients."""
    n_grid, S = 16, 16
    rng = np.random.default_rng(dim)
    density = torch.from_numpy(rng.uniform(0.5, 1.5, (n_grid,) * dim)
                               .astype(np.float32))
    q = tc.Quantizer.from_string("int4")
    want = tpm.poisson_accel_grids(density, 200.0, n_grid, q, 1.0, 0.5, dim)
    got = pm_sharded.poisson_accel_slabs(
        list(density.tensor_split(S)), 200.0, n_grid, q, 1.0,
        [torch.tensor(0.5)] * S, dim, ring.ParticleMesh.virtual(S, "cpu"))
    for d in range(dim):
        full = torch.cat([g[d] for g in got])
        np.testing.assert_allclose(full.numpy(), want[d].numpy(), rtol=0,
                                   atol=1e-5 * float(want[d].abs().max()))
