"""Multi-process runs and cross-process determinism checks.

PyTorch counterpart of ``nbody_tpu.parallel.multihost``. JAX stretches one
global mesh across processes with ``jax.distributed``; here each process
owns a run of the ring's shards, and ``parallel.ring``'s collectives go
through ``torch.distributed`` on gloo once the mesh spans processes (see
that module's notes). Every process runs the same program on the same
replicated inputs, as in JAX's multi-controller SPMD.

gloo is the one transport: it is JAX's ``cpu_collectives="gloo"``, and
NCCL cannot put two ranks on one GPU. An NCCL transport, one card per
process, waits for a machine with more than one card.

Two processes on one host, each with 4 virtual shards (the check that
``parallel.multihost_check`` runs):

    python -m nbody_tpu_torch.parallel.multihost_check --device cpu \\
        --process-id 0 --port 29871 --out p0.json &
    python -m nbody_tpu_torch.parallel.multihost_check --device cpu \\
        --process-id 1 --port 29871 --out p1.json
"""

from __future__ import annotations

import datetime
import logging
from typing import Optional

import torch
import torch.distributed as dist

from nbody_tpu_torch.parallel import ring

logger = logging.getLogger("nbody_tpu_torch.multihost")

# A collective that waits longer than this fails the run (JAX's worker sets
# XLA:CPU's collective timeouts to 600 s).
TIMEOUT = datetime.timedelta(seconds=600)


def process_count() -> int:
    """Processes in the default group: 1 unless one was initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "gloo") -> bool:
    """Join ``num_processes`` processes into the default process group.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of a
    port every process can reach; process 0 listens on it. Returns True
    when more than one process is active after the call. With no address,
    or one process, it is a no-op that returns False. A failure to join
    raises: no run falls back to one process. ``backend`` is JAX's
    ``cpu_collectives``; only gloo is written (module notes)."""
    if backend != "gloo":
        raise ValueError(f"backend {backend!r}: only gloo is written (NCCL "
                         f"cannot put two ranks on one GPU)")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None or num_processes in (None, 1):
        logger.info("torch.distributed not initialized; one process")
        return False
    if process_id is None:
        raise ValueError("process_id is needed with num_processes > 1")
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    logger.info("multihost: %d processes over %s", num_processes, backend)
    return num_processes > 1


def make_global_mesh(axis_name: str = ring.AXIS,
                     local: Optional[ring.ParticleMesh] = None
                     ) -> ring.ParticleMesh:
    """1-D mesh over every process's local shards, in process order.

    ``local`` is this process's single-controller mesh (default
    ``ring.make_particle_mesh()``, every local GPU). The shard counts are
    exchanged with one all-gather; on one process the mesh is ``local``
    itself."""
    if axis_name != ring.AXIS:
        raise ValueError(f"the ring's collectives run over the axis "
                         f"{ring.AXIS!r}, not {axis_name!r}")
    if local is None:
        local = ring.make_particle_mesh()
    n = process_count()
    if n == 1:
        return local
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([local.size], dtype=torch.int64))
    return ring.ParticleMesh.across(local, [int(c) for c in counts],
                                    dist.get_rank(), dist.group.WORLD)


def cross_host_state_agreement(positions, velocities) -> dict:
    """Every process hashes its local view of the state; agreement is one
    all-gather of the digests, not a file exchange.

    Returns {"hash": ..., "all_equal": bool, "num_processes": int}."""
    from nbody_tpu_torch.utils.reproducibility import hash_state

    local_hash = hash_state(positions, velocities)
    n = process_count()
    if n == 1:
        return {"hash": local_hash, "all_equal": True, "num_processes": 1}
    # The digest as four exact 16-bit integer limbs: a float gather would
    # round away low-bit differences and report false agreement.
    digest = int(local_hash, 16)
    limbs = torch.tensor([(digest >> s) & 0xFFFF for s in (0, 16, 32, 48)],
                         dtype=torch.int32)
    gathered = [torch.empty_like(limbs) for _ in range(n)]
    dist.all_gather(gathered, limbs)
    all_equal = all(torch.equal(g, gathered[0]) for g in gathered)
    return {"hash": local_hash, "all_equal": bool(all_equal),
            "num_processes": n}


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
