"""nbody_tpu_torch.models.galaxy against nbody_tpu.models.galaxy.

The committed fixture must be the JAX package's own disk ICs bit for bit
(the torch-reference trajectories were made from them); the port's
torch-RNG ICs can only match the JAX ones statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import galaxy as jg
from nbody_tpu_torch.models import galaxy as tg

torch.set_num_threads(1)


def test_fixture_is_the_jax_disk_bitwise():
    want = jg.create_disk_galaxy(jax.random.PRNGKey(42), num_stars=5000)
    got = tg.load_disk_fixture(5000, 42)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _stats(pos, vel):
    pos, vel = np.asarray(pos, np.float64), np.asarray(vel, np.float64)
    r = np.sqrt((pos ** 2).sum(1))
    lz = pos[:, 0] * vel[:, 1] - pos[:, 1] * vel[:, 0]
    return r, lz, np.abs(lz) / np.maximum(r, 0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_rng_disk_matches_jax_statistically(seed):
    jpos, jvel, jm = jg.create_disk_galaxy(jax.random.PRNGKey(seed),
                                           num_stars=5000)
    tpos, tvel, tm = tg.create_disk_galaxy(
        torch.Generator().manual_seed(seed), num_stars=5000)
    assert tpos.shape == (5000, 2) and tvel.shape == (5000, 2)
    assert tpos.dtype == tvel.dtype == tm.dtype == torch.float32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jr, _, jvc = _stats(jpos, jvel)
    tr, tlz, tvc = _stats(tpos.numpy(), tvel.numpy())
    # half-mass radius (equal masses: the median radius) and mean v_circ
    np.testing.assert_allclose(np.median(tr), np.median(jr), rtol=0.05)
    np.testing.assert_allclose(tvc.mean(), jvc.mean(), rtol=0.05)
    # the checks of tests/test_forces_direct.py's disk test
    assert tr.min() >= 0.1 - 1e-6 and tr.max() <= 20.0 + 1e-5
    assert (tlz > 0).mean() > 0.9


def test_torch_rng_disk_is_reproducible_per_generator():
    a = tg.create_disk_galaxy(torch.Generator().manual_seed(5), 300)
    b = tg.create_disk_galaxy(torch.Generator().manual_seed(5), 300)
    c = tg.create_disk_galaxy(torch.Generator().manual_seed(6), 300)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


# --------------------------------------------------------------------------
# Plummer sphere, test disk and disk-in-NFW-halo ICs
# --------------------------------------------------------------------------

def _virial_ratio(pos, vel, m, G=0.001):
    """2K / |W| in f64 (numpy, softening 0.1): the same function for both
    packages' ICs."""
    pos, vel, m = (np.asarray(a, np.float64) for a in (pos, vel, m))
    ke = 0.5 * (m * (vel ** 2).sum(1)).sum()
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1) + 0.01
    inv = 1.0 / np.sqrt(d2)
    np.fill_diagonal(inv, 0.0)
    w = -0.5 * G * (m[:, None] * m[None, :] * inv).sum()
    return 2.0 * ke / abs(w)


@pytest.mark.parametrize("seed", [0, 1])
def test_plummer_matches_jax_statistically(seed):
    """Half-mass radius within 5% (a = 10: ~13), virial ratio within 10%,
    masses all 1, radii inside [0.05a, 10a], isotropic directions."""
    jpos, jvel, jm_ = jg.create_plummer_sphere(jax.random.PRNGKey(seed),
                                               num_stars=2000)
    tpos, tvel, tm_ = tg.create_plummer_sphere(
        torch.Generator().manual_seed(seed), num_stars=2000)
    assert tpos.shape == (2000, 3) and tvel.shape == (2000, 3)
    assert tpos.dtype == tvel.dtype == tm_.dtype == torch.float32
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    jr = np.sqrt((np.asarray(jpos, np.float64) ** 2).sum(1))
    tr = np.sqrt((tpos.numpy().astype(np.float64) ** 2).sum(1))
    np.testing.assert_allclose(np.median(tr), np.median(jr), rtol=0.05)
    assert tr.min() >= 0.5 - 1e-5 and tr.max() <= 100.0 + 1e-4
    np.testing.assert_allclose(_virial_ratio(tpos, tvel, tm_),
                               _virial_ratio(jpos, jvel, jm_), rtol=0.1)
    # isotropy: the mean direction is near zero
    assert np.abs((tpos.numpy() / tr[:, None]).mean(0)).max() < 0.1


def test_test_galaxy_matches_jax():
    """Uniform disk in r^2 over [0.5, 10.5] with exact Keplerian speeds."""
    jpos, jvel, jm_ = jg.create_test_galaxy(jax.random.PRNGKey(2), 3000)
    tpos, tvel, tm_ = tg.create_test_galaxy(torch.Generator().manual_seed(2),
                                            3000)
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    tr = np.sqrt((tpos.numpy().astype(np.float64) ** 2).sum(1))
    jr = np.sqrt((np.asarray(jpos, np.float64) ** 2).sum(1))
    assert tr.min() >= 0.5 - 1e-5 and tr.max() <= 10.5 + 1e-5
    np.testing.assert_allclose(np.median(tr), np.median(jr), rtol=0.05)
    speed = np.sqrt((tvel.numpy().astype(np.float64) ** 2).sum(1))
    np.testing.assert_allclose(speed, np.sqrt(0.001 * 3000 * 0.5 / tr),
                               rtol=1e-5)


def test_nfw_enclosed_mass_matches_jax():
    """rtol 5e-6: XLA's and torch's f32 log1p and division differ by an
    ulp, and f(x) = log1p(x) - x/(1+x) cancels ~15x of it at x ~ 1."""
    r = np.linspace(0.01, 60.0, 97).astype(np.float32)
    want = np.asarray(jg.nfw_enclosed_mass(jnp.asarray(r), 5000.0, 30.0))
    got = tg.nfw_enclosed_mass(torch.from_numpy(r), 5000.0, 30.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-6)


def _curve(pos, vel, edges):
    """Mean tangential speed per radial bin (numpy)."""
    pos, vel = np.asarray(pos, np.float64), np.asarray(vel, np.float64)
    r = np.sqrt((pos ** 2).sum(1))
    vt = np.abs(pos[:, 0] * vel[:, 1] - pos[:, 1] * vel[:, 0]) / r
    idx = np.digitize(r, edges)
    return np.array([vt[idx == k].mean() for k in range(1, len(edges))])


@pytest.mark.parametrize("seed", [0, 1])
def test_halo_galaxy_matches_jax_rotation_curve(seed):
    """The halo flattens the rotation curve: per radial bin the mean
    tangential speed agrees with JAX's within 5%, and its outer slope is
    far flatter than the bare disk's."""
    jpos, jvel, _ = jg.create_galaxy_with_halo(jax.random.PRNGKey(seed),
                                               num_stars=5000)
    tpos, tvel, tm_ = tg.create_galaxy_with_halo(
        torch.Generator().manual_seed(seed), num_stars=5000)
    assert tpos.shape == (5000, 2) and float(tm_.sum()) == 5000.0
    edges = np.linspace(1.0, 15.0, 8)
    np.testing.assert_allclose(_curve(tpos, tvel, edges),
                               _curve(jpos, jvel, edges), rtol=0.05)
    dpos, dvel, _ = tg.create_disk_galaxy(
        torch.Generator().manual_seed(seed), num_stars=5000)
    halo, disk = _curve(tpos, tvel, edges), _curve(dpos, dvel, edges)
    assert (halo[-1] / halo[3]) > (disk[-1] / disk[3])


def test_jax_plummer_ics_run_on_the_port():
    """Parity runs take the JAX ICs as numpy through from_jax_numpy: a 3-D
    Plummer sphere stepped by both engines (JAX dense, the port's default
    path) agrees to f32 rounding after 10 steps (rtol 1e-4, atol 1e-5)."""
    from nbody_tpu.config import SimConfig as JaxConfig
    from nbody_tpu.models import direct as jd
    from nbody_tpu.models.state import make_state as jmake_state
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models import direct as td
    from nbody_tpu_torch.models.state import from_jax_numpy
    from nbody_tpu_torch.ops.precision import Quantizer
    pos, vel, m = jg.create_plummer_sphere(jax.random.PRNGKey(43),
                                           num_stars=256)
    jstate = jmake_state(pos, vel, m)
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate))
    assert state.positions.shape == (256, 3)
    q_j = jd.Quantizer.from_string("float32")
    jout = jd.run_steps(jstate, q_j, JaxConfig(), "dense", False, 10)
    tout = td.run_steps(state, Quantizer.from_string("float32"), SimConfig(),
                        "auto", False, 10)
    np.testing.assert_allclose(tout.positions.numpy(),
                               np.asarray(jout.positions), rtol=1e-4,
                               atol=1e-5)
