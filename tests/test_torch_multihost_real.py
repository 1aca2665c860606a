"""The port's ring across REAL processes over gloo (CPU, localhost).

The counterpart of tests/test_multihost_real.py: real OS processes of
``nbody_tpu_torch.parallel.multihost_check`` (``--device cpu``, JAX's
sizes: 200 stars, 20 ticks, 4 chunks) join one mesh with
``multihost.make_global_mesh`` and run the float32 sym history, the int4
run, the rows schedule and the hash agreement, every collective of the
ring crossing a process boundary. Three layouts: 2 processes x 4 shards
(JAX's, an even ring of 8), 3 x 1 (an odd ring of 3, whose last shard
carries a phantom row, so the energy ring's blocks differ in length) and
3 x 2 at 7 stars (shards of 2 rows, the last two phantoms only, so some
of the energy ring's blocks are empty).

The oracle is the port's single process on ``ParticleMesh.virtual(S)``
with the same ICs: every process must give its bits (the collectives fold
in shard order, as the single controller does), so energies and final
hashes are compared for equality. The chain to the reference closes in
the last test: the single-process 8-shard history on JAX's ICs against
JAX's 8-device ``ring.run_with_snapshots_sharded``, at JAX's own rtol
1e-5 (tests/test_multihost_real.py:138).
"""

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.models import galaxy as jg
from nbody_tpu.models.state import make_state as jmake_state
from nbody_tpu.ops.precision import Quantizer as JaxQuantizer
from nbody_tpu.parallel import ring as jring
from nbody_tpu_torch.parallel import multihost_check, ring

STARS, TICKS, CHUNKS = 200, 20, 4
# (processes, shards per process, stars)
LAYOUTS = [(2, 4, STARS), (3, 1, STARS), (3, 2, 7)]
WORKER_TIMEOUT = 300   # s, each launch of the processes
COMPARED = ("energy_total", "drift_pct", "frames_shape", "final_hash",
            "int4_total", "int4_hash", "rows_total", "rows_hash")


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"{n}x{k}-{stars}" for n, k, stars in LAYOUTS])
def layout_results(request, tmp_path_factory):
    """The processes' results and the single process's, once a layout."""
    n, k, stars = request.param
    results = multihost_check.launch(
        n, tmp_path_factory.mktemp(f"mh{n}x{k}"),
        ["--device", "cpu", "--shards-per-process", str(k),
         "--stars", str(stars), "--ticks", str(TICKS),
         "--chunks", str(CHUNKS)], timeout=WORKER_TIMEOUT)
    pos, vel, m = multihost_check.make_ics(stars, "cpu")
    single = multihost_check.run_parts(ring.ParticleMesh.virtual(n * k,
                                                                 "cpu"),
                                       pos, vel, m, TICKS, CHUNKS)
    return n, k, stars, results, single


def test_topology(layout_results):
    n, k, _, results, _ = layout_results
    for pid, r in enumerate(results):
        assert r["process_id"] == pid
        assert r["multihost_active"] is True
        assert r["num_processes"] == n
        assert r["global_shards"] == n * k
        assert r["local_shards"] == k


def test_processes_are_identical(layout_results):
    """Multi-controller SPMD: every process holds the same replicated
    history."""
    _, _, stars, results, _ = layout_results
    for r in results[1:]:
        for key in COMPARED:
            assert r[key] == results[0][key], key
    assert results[0]["frames_shape"] == [CHUNKS, stars, 2]
    assert results[0]["int4_finite"]


def test_processes_match_the_single_process_bit_for_bit(layout_results):
    """The mesh split across processes gives the single controller's bits
    in every part: only the transport differs."""
    _, _, _, results, single = layout_results
    for r in results:
        for key in COMPARED:
            assert r[key] == single[key], key


def test_processes_keep_the_full_bounds_ring_pass(layout_results):
    """Across processes the int4 bounds take the max ring pass, not the
    pruned pass on the home device that one controller takes: no pruned
    pass counted, S//2 rotations of positions and of masks more a pass
    than the one controller makes, the same kernel launches (none on the
    CPU)."""
    n, k, _, results, single = layout_results
    passes = multihost_check.SHORT_STEPS + 1   # the entry force, each tick
    assert single["traffic"]["int4"]["bounds_passes"] == passes
    for r in results:
        assert r["traffic"]["int4"]["bounds_passes"] == 0
        assert (r["traffic"]["int4"]["rotations"]
                == single["traffic"]["int4"]["rotations"]
                + passes * 2 * (n * k // 2))
        assert r["launches"] == single["launches"]


def test_hash_agreement_and_mismatch(layout_results):
    """Agreement on identical state; a perturbation local to process 1 is
    seen by every process."""
    n, _, _, results, single = layout_results
    for pid, r in enumerate(results):
        assert r["agree"] == {"hash": single["final_hash"],
                              "all_equal": True, "num_processes": n}
        assert r["mismatch"]["all_equal"] is False
        assert r["mismatch"]["num_processes"] == n
        # the perturbed process's own digest changed; the others' did not
        changed = r["mismatch"]["hash"] != r["agree"]["hash"]
        assert changed == (pid == 1)


def test_single_process_history_matches_jax_8_devices():
    pos, vel, m = jg.create_disk_galaxy(jax.random.PRNGKey(0),
                                        num_stars=STARS)
    _, snaps, _ = jring.run_with_snapshots_sharded(
        jmake_state(pos, vel, m), JaxQuantizer.from_string("f32"),
        JaxConfig(), jring.make_particle_mesh(8),
        steps_per_chunk=TICKS // CHUNKS, num_chunks=CHUNKS)
    want = np.asarray(snaps.total, np.float64)
    got = multihost_check.run_parts(
        ring.ParticleMesh.virtual(8, "cpu"),
        *(torch.from_numpy(np.array(x)) for x in (pos, vel, m)), TICKS,
        CHUNKS)
    np.testing.assert_allclose(got["energy_total"], want, rtol=1e-5)
