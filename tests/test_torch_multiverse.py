"""nbody_tpu_torch.diagnostics.multiverse against
nbody_tpu.diagnostics.multiverse, on the CPU.

* ``reversed_sum_accelerations`` against JAX's on the same inputs, D = 2
  and 3, equal and unequal masses: within 1e-5 of max|a| (both sum the
  same products over the reversed source axis; only the reduction's
  association differs).
* ``MultiverseSim`` on JAX's 128-star disk (its ICs fed as numpy): the
  assertions of tests/test_diagnostics_utils.py's multiverse case, the
  report's fields and lengths equal to JAX's.
* Universe A after one 20-tick step against JAX's A: positions at rtol
  1e-4, atol 1e-5, the float32 tolerance of tests/test_torch_direct.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JSimConfig
from nbody_tpu.diagnostics import multiverse as jm
from nbody_tpu.models import galaxy as jg
from nbody_tpu.ops.precision import Quantizer as JQuantizer
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import multiverse as tm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def disk():
    pos, vel, m = jg.create_disk_galaxy(jax.random.PRNGKey(0), 128)
    return tuple(np.array(a) for a in (pos, vel, m))


@pytest.mark.parametrize("equal", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_reversed_sum_matches_jax(dim, equal):
    rng = np.random.default_rng(dim + 2 * equal)
    pos = rng.normal(size=(200, dim)).astype(np.float32) * 5
    m = (np.ones(200, np.float32) if equal
         else rng.uniform(0.5, 2.0, 200).astype(np.float32))
    want = np.asarray(jm.reversed_sum_accelerations(
        pos, m, JQuantizer(), JSimConfig()))
    got = tm.reversed_sum_accelerations(torch.from_numpy(pos),
                                        torch.from_numpy(m), SimConfig())
    assert got.dtype == torch.float32 and got.shape == (200, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_multiverse_divergence_grows(disk):
    mv = tm.MultiverseSim(*disk, device="cpu")
    rep = mv.run(num_ticks=60, interval=20)
    want = jm.MultiverseSim(*disk).run(num_ticks=60, interval=20)
    assert len(rep.divergence_reversed) == 3
    # the reversed-sum universe must eventually diverge from standard
    assert rep.divergence_reversed[-1] >= 0
    assert np.isfinite(rep.heisenberg_product)
    assert rep.ticks == want.ticks == [20, 40, 60]
    assert {k: np.shape(v) for k, v in dataclasses.asdict(rep).items()} == \
        {k: np.shape(v) for k, v in dataclasses.asdict(want).items()}
    assert all(np.isfinite(v) for v in (rep.lyapunov_reversed,
                                        rep.lyapunov_fp16,
                                        rep.entropy_bits_a,
                                        rep.entropy_bits_b))
    assert rep.divergence_fp16[-1] > 0


def test_universe_a_step_matches_jax(disk):
    mv = tm.MultiverseSim(*disk, device="cpu")
    jmv = jm.MultiverseSim(*disk)
    mv.universe_a.step(20)
    jmv.universe_a.step(20)
    np.testing.assert_allclose(mv.universe_a.positions.numpy(),
                               np.asarray(jmv.universe_a.positions),
                               rtol=1e-4, atol=1e-5)
    assert mv.universe_a.force_impl == "dense"
