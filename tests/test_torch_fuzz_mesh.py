"""The kernel fuzz's mesh cases: the port's ring against JAX's, on the CPU.

The JAX fuzz harness's mesh cases (``tests/test_fuzz_kernels.py``, seeds
``13 SEED + i``: a drawn case, then 2, 5 or 8 shards and a schedule) go
through JAX's ring on the conftest's virtual CPU devices and through the
port's ``ring_accelerations`` on ``ParticleMesh.virtual(S, "cpu")``, under
both schedules; unaligned N leaves phantom rows on the last shards. The
rules are ``nbody_tpu_torch.diagnostics.tolerance``'s: float modes |err| <= 2e-6 + 5e-5
max(|want|, s) with s the row's summed |terms|; int8 / int4 / custom after
quantize_force at most max(4, 1e-4 x components) components off, each by
one grid step; every output finite (JAX's own rule); the ring's potential
energy within 2e-5 of the metric (JAX's own rule) and of JAX's ring.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.ops import forces as jforces
from nbody_tpu.ops import precision as jp
from nbody_tpu.parallel import ring as jring
from nbody_tpu_torch import fuzz
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import fuzz_cases, tolerance
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.parallel import ring

sys.path.insert(0, os.path.dirname(__file__))
import test_fuzz_kernels as jfz  # noqa: E402  (the JAX harness, by path)

torch.set_num_threads(1)

SEED = jfz.SEED


# Past the CI cases, mesh case 18 (N=1021, D=2, bfloat16, 8 shards, rows)
# has cancelling terms: under the harness's raw rtol 2 of its 2042
# components miss the dense oracle; the summed-|terms| rule holds them.
MESH_CASES = [*range(jfz.N_MESH_CASES), 18]


@pytest.mark.parametrize("idx", MESH_CASES)
def test_mesh_case_matches_jax_ring_and_dense(idx):
    case = fuzz_cases.mesh_case(SEED * 13 + idx)
    q, cfg = case["q"], SimConfig(softening=case["softening"])
    jq = jp.Quantizer(jp.Precision(case["mode"].value))
    jcfg = JaxConfig(softening=case["softening"])
    pos, m = fuzz.tensors(case["pos"], case["m"], "cpu")
    jpos, jm = jnp.asarray(case["pos"]), jnp.asarray(case["m"])
    jmesh = jring.make_particle_mesh(case["shards"])
    mesh = ring.ParticleMesh.virtual(case["shards"], "cpu")
    bounds = hn.kernel_bounds(pos, q, cfg)
    scale = hn.sym_force_term_scale(pos, cfg.G * m, bounds, q,
                                    hn._self_masked(cfg, None))
    jax_dense = torch.as_tensor(np.array(jforces.dense_accelerations(
        jpos, jm, jq, jcfg, quantize_forces=jq.is_int)))
    tally = tolerance.Tally()
    for schedule in ring.SCHEDULES:
        label = f"mesh case {idx} ({schedule})"
        got = ring.ring_accelerations(pos, m, q, cfg, mesh,
                                      quantize_forces=q.is_int,
                                      schedule=schedule)
        jax_ring = torch.as_tensor(np.array(jring.ring_accelerations(
            jpos, jm, jq, jcfg, jmesh, quantize_forces=jq.is_int,
            schedule=schedule)))
        tally.hold(label + " vs JAX's ring", got, jax_ring, scale, q, "out",
                   finite=True)
        tally.hold(label + " vs JAX's dense", got, jax_dense, scale, q,
                   "out", finite=True)
    pe = ring.ring_potential_energy(pos, m, cfg, mesh).reshape(1)
    jax_pe = torch.tensor([float(jring.ring_potential_energy(
        jpos, jm, jcfg, jmesh))], dtype=torch.float64)
    tally.hold_rel(f"mesh case {idx}", pe, jax_pe, fuzz.PE_RTOL,
                   "JAX's ring energy", finite=True)
    assert not tally.failures, tally.failures
    tallies = tolerance.Tallies()
    fuzz.run_mesh_case(SEED * 13 + idx, "cpu", tallies)
    assert not tallies.failures(), tallies.failures()
