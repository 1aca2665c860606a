"""nbody_tpu_torch.diagnostics.metrics against nbody_tpu.diagnostics.metrics.

Every Snapshot field at rtol 1e-5 on the same numpy inputs, rotation-curve
star counts exactly. The JAX sums are double-double, the port's float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.diagnostics import metrics as jm
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import metrics as tm

torch.set_num_threads(1)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
    a = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    v = np.sqrt(0.001 * n * (1 - np.exp(-r / 3.0)) / r)
    vel = np.stack([-v * np.sin(a), v * np.cos(a)], 1)
    vel = vel + 0.05 * rng.standard_normal((n, 2))
    m = 1.0 + rng.random(n)
    return tuple(x.astype(np.float32) for x in (pos, vel, m))


@pytest.mark.parametrize("n,num_bins", [(257, 20), (1500, 20), (300, 7)])
def test_snapshot_fields_match_jax(n, num_bins):
    pos, vel, m = _state(n, seed=n)
    want = jm.snapshot(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(m),
                       jnp.asarray(11), JaxConfig(), num_bins=num_bins)
    got = tm.to_host(tm.snapshot(torch.from_numpy(pos), torch.from_numpy(vel),
                                 torch.from_numpy(m), 11, SimConfig(),
                                 num_bins=num_bins))
    assert int(got.tick) == 11
    np.testing.assert_array_equal(got.curve_counts,
                                  np.asarray(want.curve_counts))
    for field in ("kinetic", "potential", "total", "radius_90",
                  "bound_frac", "dispersion", "curve_radii",
                  "curve_velocities"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, field), np.float64),
            np.asarray(getattr(want, field), np.float64), rtol=1e-5,
            equal_nan=True, err_msg=field)


def test_energies_match_jax_with_zero_softening_and_blocks():
    pos, vel, m = _state(700, seed=1)
    cfg_j, cfg_t = JaxConfig(softening=0.0), SimConfig(softening=0.0)
    want = float(jm.potential_energy(jnp.asarray(pos), jnp.asarray(m),
                                     cfg_j, block=256))
    got = tm.potential_energy(torch.from_numpy(pos), torch.from_numpy(m),
                              cfg_t, block=256)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    np.testing.assert_allclose(
        float(tm.kinetic_energy(torch.from_numpy(vel), torch.from_numpy(m))),
        float(jm.kinetic_energy(jnp.asarray(vel), jnp.asarray(m))),
        rtol=1e-6)


def test_rotation_curve_explicit_radius_and_empty_bins():
    pos, vel, _ = _state(200, seed=2)
    want = jm.rotation_curve(jnp.asarray(pos), jnp.asarray(vel), num_bins=30,
                             max_radius=40.0)
    got = tm.rotation_curve(torch.from_numpy(pos), torch.from_numpy(vel),
                            num_bins=30, max_radius=40.0)
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    np.testing.assert_allclose(got.velocities.numpy(),
                               np.asarray(want.velocities), rtol=1e-5,
                               equal_nan=True)
    assert np.isnan(got.velocities.numpy()).any()  # bins past the disk


def test_stack_snapshots_copies_once_to_numpy():
    pos, vel, m = (torch.from_numpy(x) for x in _state(100, seed=3))
    snaps = [tm.snapshot(pos, vel, m, t, SimConfig()) for t in (10, 20, 30)]
    stacked = tm.stack_snapshots(snaps)
    assert list(stacked.tick) == [10, 20, 30]
    assert isinstance(stacked.total, np.ndarray)
    assert stacked.total.shape == (3,) and stacked.curve_counts.shape == (3,
                                                                           20)
    np.testing.assert_array_equal(stacked.kinetic[1],
                                  snaps[1].kinetic.numpy())


def test_compare_rotation_curves_matches_jax():
    pos, vel, _ = _state(500, seed=4)
    c1 = tm.rotation_curve(torch.from_numpy(pos), torch.from_numpy(vel))
    c2 = tm.rotation_curve(torch.from_numpy(pos),
                           torch.from_numpy(vel * np.float32(1.1)))
    j1 = jm.rotation_curve(jnp.asarray(pos), jnp.asarray(vel))
    j2 = jm.rotation_curve(jnp.asarray(pos), jnp.asarray(vel * 1.1))
    got, want = tm.compare_rotation_curves(c1, c2), \
        jm.compare_rotation_curves(j1, j2)
    assert got["num_valid_bins"] == want["num_valid_bins"]
    for k in ("mean_velocity_diff", "outer_slope_baseline",
              "outer_slope_quantized", "flatness_increase"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("softening_sq", [0.0025, 0.0])
def test_energies_with_run_time_softening_match_jax(softening_sq):
    pos, vel, m = _state(600, seed=5)
    want_pe = float(jm.potential_energy(jnp.asarray(pos), jnp.asarray(m),
                                        JaxConfig(), block=256,
                                        softening_sq=jnp.float32(
                                            softening_sq)))
    got_pe = tm.potential_energy(torch.from_numpy(pos), torch.from_numpy(m),
                                 SimConfig(), block=256,
                                 softening_sq=torch.tensor(softening_sq))
    np.testing.assert_allclose(float(got_pe), want_pe, rtol=1e-5)
    want = float(jm.total_energy(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(m), JaxConfig(),
                                 softening_sq=jnp.float32(softening_sq)))
    got = tm.total_energy(torch.from_numpy(pos), torch.from_numpy(vel),
                          torch.from_numpy(m), SimConfig(),
                          softening_sq=torch.tensor(softening_sq))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
