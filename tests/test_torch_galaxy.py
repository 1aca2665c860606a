"""nbody_tpu_torch.models.galaxy against nbody_tpu.models.galaxy.

The committed fixture must be the JAX package's own disk ICs bit for bit
(the torch-reference trajectories were made from them); the port's
torch-RNG ICs can only match the JAX ones statistically.
"""

import jax
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
