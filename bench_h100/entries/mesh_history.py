"""Entry ``mesh_history``: ``direct_history``'s unit of work on the port's
multi-device ring, ``DirectSimulation(mesh=...)`` as a user builds it
(``python -m nbody_tpu_torch --mesh``): one controller, one shard a card
over the cell's ``chips`` cards (on the CPU, a virtual mesh of as many
shards on the one device), the configuration's schedule, exact global
bounds every tick.

Where the configuration's ``mesh.ticks`` is ``cuda_graph`` the ring runs
each tick as one CUDA graph across the cards: set-up fails at once where
the program's ring has no graph ticks (``ring.graph_ticks``), and after
the warm-up on the cards where the ticks did not take them (a failed
capture), since eager ticks launched from one host thread measure the
host's scheduler more than the ring.

The ring evaluates the force at the state it is handed at the entry of
every call, so set-up takes the state at the ICs with that force from a
call of no ticks (its one snapshot is the ICs'); every unit, the replay
and the check then run as ``direct_history``'s, whose functions this
entry calls. A unit ends with every card of the mesh synchronized (the
harness waits on the current card only), and adds the bytes that the
ring's counters say crossed cards in it (``moved_bytes_peer``, 0 where
the program has no such counter).
"""

from __future__ import annotations

import torch

from bench_h100 import ics
from bench_h100.entries import direct_history as single


def program_factory(run):
    """The system under test: the port's DirectSimulation on a mesh of the
    cell's cards, the configuration's ring schedule, exact bounds every
    tick."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.direct import DirectSimulation
    from nbody_tpu_torch.parallel import ring
    c = run.config
    cfg = SimConfig(G=c["G"], softening=c["softening"], dt=c["dt"])
    if _graph_ticks_needed(run) and not hasattr(ring, "graph_ticks"):
        raise RuntimeError("the configuration runs the ring's ticks as "
                           "CUDA graphs; this program's ring has none")
    shards = run.workload["chips"]
    if run.device.startswith("cuda"):
        mesh = ring.make_particle_mesh(shards, "cuda")
    else:
        mesh = ring.ParticleMesh.virtual(shards, run.device)

    def make(pos, vel, m):
        return DirectSimulation(pos, vel, m, precision=run.traffic["mode"],
                                cfg=cfg, mesh=mesh,
                                schedule=c["mesh"]["schedule"])
    return make


def _graph_ticks_needed(run) -> bool:
    return run.config["mesh"].get("ticks") == "cuda_graph"


def _peer_bytes() -> int:
    """The ring's count of bytes moved between cards so far (0 where the
    program has no such counter)."""
    from nbody_tpu_torch.parallel import ring
    return getattr(ring, "TRAFFIC", {}).get("moved_bytes_peer", 0)


def _sync(st) -> None:
    """Wait for every card of the mesh (none for a program without one)."""
    mesh = getattr(st.sim, "mesh", None)
    for dev in dict.fromkeys(mesh.devices if mesh is not None else ()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def prepare(run, program=None):
    st = single.State()
    make = program or program_factory(run)
    run.mark("program imported")
    st.ics = ics.make(run.config, run.traffic["n"], run.seed, run.device)
    run.mark("ICs made")
    st.sim = make(*st.ics)
    st.sim.run_with_history(0, 1)
    st.s0 = st.sim.state
    run.mark("simulation built")
    snaps, _ = st.sim.run_with_history(1, 1)
    st.s1 = st.sim.state
    _sync(st)
    run.mark("first tick")
    if program is None and run.device.startswith("cuda") \
            and _graph_ticks_needed(run):
        from nbody_tpu_torch.parallel import ring
        if not ring.graph_ticks(st.sim.mesh):
            raise RuntimeError("the ring's ticks ran eagerly: the CUDA-graph "
                               "capture failed (see its warning)")
    st.snaps = snaps
    st.interval = run.traffic["snapshot_interval"]
    st.launches0 = single._launches() if program is None else None
    return st


def unit(run, st) -> dict:
    moved = _peer_bytes()
    work = single.unit(run, st)
    _sync(st)
    work["moved_bytes_peer"] = _peer_bytes() - moved
    return work


counters = single.counters
check = single.check
finish = single.finish
