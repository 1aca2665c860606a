"""Entry points: the single-device step and the multi-shard dry run.

PyTorch counterpart of the repository root's ``__graft_entry__.py``.
``entry`` gives the flagship step as ``(fn, args)``; ``dryrun_multichip``
runs JAX's seven multi-device surfaces once on ``ParticleMesh.virtual(n,
device)``: n shards on one device, the counterpart of JAX's n virtual CPU
devices. Each surface is a function of its state and mesh.

    python -c "from nbody_tpu_torch.dryrun import dryrun_multichip; \\
        dryrun_multichip(8, 'cpu')"
"""

from __future__ import annotations

import functools
import tempfile

import numpy as np
import torch

from nbody_tpu_torch.config import DEFAULT_SIM
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops.precision import Precision, Quantizer
from nbody_tpu_torch.parallel import ring

ENTRY_STARS = 4096


def _finite(x) -> bool:
    return bool(torch.isfinite(torch.as_tensor(x)).all())


def _disk(seed: int, stars: int, device) -> tuple:
    return create_disk_galaxy(torch.Generator().manual_seed(seed),
                              num_stars=stars, device=device)


def entry(device="cuda"):
    """(fn, args) of the flagship forward step: one kick-drift-kick tick of
    the direct engine at 4096 stars on the production force path ('auto':
    the sym_force kernel on a card, its plain version on the CPU)."""
    from nbody_tpu_torch.models.direct import _resolve_device, run_steps

    device = _resolve_device(device)
    state = make_state(*_disk(0, ENTRY_STARS, device))
    fn = functools.partial(run_steps, q=Quantizer(Precision.FLOAT32),
                           cfg=DEFAULT_SIM, impl="auto",
                           quantize_forces=False, num_steps=1)
    return fn, (state,)


def ring_surface(state, mesh: ring.ParticleMesh) -> tuple:
    """One int4 tick of the ring (its bounds ring too), quantized forces;
    returns (state, EnergyStream)."""
    out, energies = ring.run_steps_sharded(
        state, Quantizer(Precision.INT4_SIM), DEFAULT_SIM, mesh,
        num_steps=1, quantize_forces=True, steps_per_chunk=1)
    assert _finite(out.positions)
    for field in ("kinetic", "potential", "total"):
        assert _finite(getattr(energies, field)), field
    return out, energies


def pm_surfaces(n_particles: int, mesh: ring.ParticleMesh) -> tuple:
    """One int4 step of the sharded PM on the replicated grid and one on
    the slab-decomposed FFT; returns ((state, stream), (state, stream))."""
    from nbody_tpu_torch.engines.cosmo import CosmologicalEngine
    from nbody_tpu_torch.parallel import pm_sharded

    eng = CosmologicalEngine(num_particles=n_particles, start_redshift=10.0,
                             precision="int4", dim=2, n_grid=16,
                             device=mesh.home)
    schedule, _ = eng._build_schedule(1.0, 1)
    pm = pm_sharded.run_pm_steps_sharded(eng.state, schedule, eng.quantizer,
                                         eng.cfg, mesh, quantize_forces=True)
    assert _finite(pm[0].positions) and _finite(pm[1].kinetic)
    fft = pm_sharded.run_pm_steps_sharded_fft(
        eng.state, schedule, eng.quantizer, eng.cfg, mesh,
        quantize_forces=True)
    assert _finite(fft[0].positions)
    return pm, fft


def _resident_engine(mesh: ring.ParticleMesh):
    from nbody_tpu_torch.engines.cosmo import CosmologicalEngine

    return CosmologicalEngine(num_particles=121, start_redshift=8.0,
                              precision="int4", dim=2, n_grid=16, mesh=mesh)


def resident_surface(mesh: ring.ParticleMesh):
    """The engine's resident-sharded loop at 121 particles (not a multiple
    of the mesh), two chunks dispatched before either is collected;
    returns the engine."""
    eng = _resident_engine(mesh)
    p1 = eng.dispatch_step(1.0, 2)
    p2 = eng.dispatch_step(1.0, 2)
    eng.collect_step(p1)
    eng.collect_step(p2)
    assert eng._state.positions.shape[0] % mesh.size == 0
    assert _finite(eng.positions)
    assert eng.positions.shape[0] == eng.num_particles
    assert len(eng.history["energy"]) == 4
    return eng


def direct_surface(pos, vel, m, mesh: ring.ParticleMesh) -> dict:
    """DirectSimulation(mesh=) history runs of the int4 arm and the
    float64 baseline; returns each arm's last total energy."""
    from nbody_tpu_torch.models.direct import DirectSimulation

    last = {}
    for mode in ("int4", "float64"):
        sim = DirectSimulation(pos, vel, m, precision=mode, mesh=mesh)
        snaps, frames = sim.run_with_history(2, snapshot_interval=1)
        assert _finite(snaps.total)
        assert frames.shape == (2, pos.shape[0], 2)
        assert _finite(sim.positions)
        last[mode] = float(snaps.total[-1])
    return last


def realtime_surface(n_particles: int, mesh: ring.ParticleMesh) -> int:
    """The realtime engine's mesh loop: two pumps, drained; returns the
    published tick."""
    from nbody_tpu_torch.realtime.engine import CosmicWebEngine, SharedState

    shared = SharedState()
    web = CosmicWebEngine(shared, num_particles=n_particles,
                          precision="float32", seed=0, target_fps=1000.0,
                          steps_per_frame=1, mesh=mesh)
    web.start()
    web.pump()
    web.pump()
    web.drain()
    rt_pos = shared.latest_positions()
    assert rt_pos is not None and np.isfinite(rt_pos).all()
    with shared.lock:
        tick = shared.metrics.tick
    assert tick >= 2, tick
    return tick


def checkpoint_surface(eng, mesh_b: ring.ParticleMesh) -> int:
    """``eng``'s checkpoint restored into an engine on ``mesh_b`` (another
    shard count) and stepped; returns the resumed tick."""
    from nbody_tpu_torch.utils.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as ckdir:
        mgr = CheckpointManager(ckdir)
        saved = eng.save_checkpoint(mgr)
        eng_b = _resident_engine(mesh_b)
        resumed = eng_b.restore_latest(mgr)
        assert resumed == saved == eng.tick, (resumed, saved, eng.tick)
        np.testing.assert_allclose(eng_b.positions.cpu().numpy(),
                                   eng.positions.cpu().numpy())
        eng_b.collect_step(eng_b.dispatch_step(1.0, 1))
        assert _finite(eng_b.positions)
        assert eng_b.tick == saved + 1
    return resumed


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One step of each multi-device surface on n shards of ``device``:
    the int4 ring, the replicated-grid and slab-FFT PM, the
    resident-sharded engine, DirectSimulation(mesh=) (int4 and float64),
    the realtime loop, and a checkpoint carried to a mesh of 2."""
    from nbody_tpu_torch.models.direct import _resolve_device

    device = _resolve_device(device)
    mesh = ring.ParticleMesh.virtual(n_devices, device)
    assert mesh.shape[ring.AXIS] == n_devices, mesh

    n = 16 * n_devices
    out, energies = ring_surface(make_state(*_disk(0, n, device)), mesh)
    (pm_state, pm_stream), (_, fft_stream) = pm_surfaces(n, mesh)
    eng2 = resident_surface(mesh)
    last = direct_surface(*_disk(1, n + 5, device), mesh)
    rt_tick = realtime_surface(n + 3, mesh)
    mesh_b = ring.ParticleMesh.virtual(2 if n_devices >= 2 else 1, device)
    resumed = checkpoint_surface(eng2, mesh_b)

    print(f"dryrun_multichip OK on {n_devices} devices: "
          f"ring tick={int(out.tick)} "
          f"te={float(energies.total[-1]):.6f}; "
          f"pm tick={int(pm_state.tick)} "
          f"ke={float(pm_stream.kinetic[-1]):.3e}; "
          f"fft-pm ke={float(fft_stream.kinetic[-1]):.3e}; "
          f"resident-sharded engine tick={eng2.tick} "
          f"ke={eng2.history['energy'][-1]:.3e}; "
          f"direct-mesh te int4={last['int4']:.3e} "
          f"f64={last['float64']:.3e}; "
          f"realtime-mesh tick={rt_tick}; "
          f"ckpt mesh {n_devices}->{mesh_b.shape[ring.AXIS]} "
          f"resumed tick={resumed}")
