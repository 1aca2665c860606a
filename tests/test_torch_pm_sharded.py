"""nbody_tpu_torch.parallel.pm_sharded against nbody_tpu.parallel.pm_sharded,
on the CPU.

The JAX side runs on the conftest's virtual CPU devices
(``nbody_tpu.parallel.ring.make_particle_mesh(S)``), the port on
``ParticleMesh.virtual(S, "cpu")``, S in {1, 3, 4, 8}; states go across
with ``cosmo_from_jax_numpy`` (``CosmologicalEngine.load_jax_state``).
Every case of ``tests/test_pm_sharded.py`` holds the port against JAX and
against the port's own single device, with JAX's tolerances:

* one force evaluation: rtol 1e-5, atol 1e-6 against the port's single
  device; against JAX's sharded force atol 1e-5 max|a| (the port's PM
  rule, tests/test_torch_cosmo.py);
* a short horizon (3 steps, float32 and int4; 900 particles on 8 shards):
  periodic distance < 1e-2, kinetic energy rtol 1e-3, momentum rtol 1e-3
  atol 1e7, the redshifts equal. Against JAX with G unfolded (O(1)
  dynamics, as JAX's own FFT parity tests run): at the engine's folded G
  a step moves a particle many box lengths, so the FFT libraries'
  rounding-level difference lands it anywhere in the box;
* the slab-FFT runner against the replicated one (D=2 and D=3): periodic
  distance < 1e-3, kinetic energy rtol 1e-4; the slab gather against the
  replicated gather < 1e-4, rtol 1e-5; ``sharded_fft_density`` rtol 1e-4,
  atol 1e-3; the slab partials' sum against the full gather rtol 1e-4,
  atol 1e-5;
* engines: histories of a pipelined run bitwise a sequential one; the
  resident padded loop, checkpoints without the padding, N divisible by
  S; the odd mesh's fallback bitwise the replicated runner. A mesh
  engine against the single-device one over 3 steps of the engine's own
  dz (its folded G moves a particle thousands of box lengths a step) and
  against JAX's over one step: velocities atol 1e-5 max|v|, positions
  the displacement's rounding, atol 1e-5 max|x| + (|dv| + 2^-21 |v|)
  dt / a * unit_scale: p + v dt / a * unit_scale rounds four times on
  each side, each at most half an ulp of the displacement, 2^-24 of it
  (tests/test_torch_cosmo.py holds one step by 2^-22, two roundings'
  worth); the rest of the run its redshifts and ticks, and the
  clustering contrast within the PM gate's 25%.

A mesh of one is bitwise the single-device port: the replicated runner,
the slab-FFT runner and the whole engine's histories.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.engines import cosmo as jc
from nbody_tpu.ops import pm as jpm
from nbody_tpu.parallel import pm_sharded as jps
from nbody_tpu.parallel import ring as jring
from nbody_tpu_torch.engines import cosmo as tc
from nbody_tpu_torch.models.state import cosmo_from_jax_numpy
from nbody_tpu_torch.ops import pm as tpm
from nbody_tpu_torch.parallel import pm_sharded as tps
from nbody_tpu_torch.parallel.ring import (
    ParticleMesh,
    _gather,
    _pad_to_shards,
    _shards,
)
from nbody_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
BOX = 200.0


@functools.lru_cache(maxsize=None)
def jmesh(S):
    return jring.make_particle_mesh(S)


def tmesh(S):
    return ParticleMesh.virtual(S, "cpu")


def _kw(n=1024, precision="float32", dim=2, n_grid=32, z=20.0, seed=3):
    return dict(num_particles=n, start_redshift=z, precision=precision,
                dim=dim, n_grid=n_grid, seed=seed)


def _pair(mesh_s=None, **kw):
    """A JAX engine (on ``jmesh(mesh_s)`` when given) and a port engine
    (on ``tmesh(mesh_s)``) that holds its state, carried across."""
    kw = _kw(**kw)
    je = jc.CosmologicalEngine(
        mesh=None if mesh_s is None else jmesh(mesh_s), **kw)
    te = tc.CosmologicalEngine(
        mesh=None if mesh_s is None else tmesh(mesh_s), device="cpu", **kw)
    te.load_jax_state(_np(je.state), je.mass_unit_msun)
    return je, te


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(state):
    return cosmo_from_jax_numpy(_np(state), "cpu")


def _periodic(a, b, box=BOX):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, box - d)


def _tame(je):
    """JAX's _tame_state: O(1) masses, zero velocities, the engine's
    positions."""
    return je.state._replace(masses=jnp.ones_like(je.state.masses),
                             velocities=je.state.velocities * 0.0)


def _hold_step(got_v, got_p, want_v, want_p, sched, i=-1):
    """Velocities atol 1e-5 max|v|; positions by the rounding of step i's
    displacement on both sides (four roundings each)."""
    gv, wv = np.asarray(got_v, np.float64), np.asarray(want_v, np.float64)
    dv = np.abs(gv - wv)
    v_tol = 1e-5 * np.abs(wv).max()
    assert dv.max() <= v_tol, (dv.max(), v_tol)
    move = float(sched[1][i] / sched[3][i]) * 1e-3
    x_tol = (1e-5 * np.abs(np.asarray(want_p)).max()
             + (dv + 2.0 ** -21 * np.abs(wv)) * move)
    assert np.all(_periodic(got_p, want_p) <= x_tol)


def _same_stream(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _same_state(a, b):
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.velocities, b.velocities)
    assert a.redshift == b.redshift and a.tick == b.tick


# --------------------------------------------------------------------------
# One force evaluation
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _force_pair():
    je, te = _pair()
    single = tc.pm_accelerations(te.state.positions, te.state.masses,
                                 te.quantizer, te.cfg,
                                 torch.tensor(1.0 / 21.0), False).numpy()
    return je, te, single


@pytest.mark.parametrize("S", [1, 3, 4, 8])
def test_single_force_eval_matches_jax_and_single_device(S):
    """The port's sharded force against its single device at every S
    (bitwise at S = 1) and against JAX's ``_local_pm_accel`` under
    shard_map at S in {3, 8} (3: two phantom rows)."""
    je, te, single = _force_pair()
    st, scale = je.state, 1.0 / 21.0
    n = st.positions.shape[0]
    mesh = tmesh(S)
    pos = _pad_to_shards(te.state.positions, S)
    m = _pad_to_shards(te.state.masses, S)
    w = (torch.arange(pos.shape[0]) < n).to(torch.float32)
    got = _gather(tps._local_pm_accel(
        mesh, _shards(pos, mesh), _shards(m, mesh), _shards(w, mesh),
        te.quantizer, te.cfg, torch.tensor(scale)), mesh)[:n].numpy()
    if S == 1:
        np.testing.assert_array_equal(got, single)
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
    if S in (3, 8):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        fn = shard_map(
            lambda p, mm, i: jps._local_pm_accel(
                p, mm, (i < n).astype(jnp.float32), je.quantizer, je.cfg,
                scale),
            mesh=jmesh(S), in_specs=(P(jring.AXIS),) * 3,
            out_specs=P(jring.AXIS), check_vma=False)
        a_jax = np.asarray(fn(jnp.asarray(pos.numpy()),
                              jnp.asarray(m.numpy()),
                              jnp.arange(pos.shape[0], dtype=jnp.int32)))[:n]
        np.testing.assert_allclose(got, a_jax, rtol=0,
                                   atol=1e-5 * np.abs(a_jax).max())


@pytest.mark.parametrize("S, route", [(1, "replicated"), (1, "slab"),
                                      (4, "slab"), (4, "replicate"),
                                      (3, "auto")])
def test_pm_accelerations_sharded_routes(S, route):
    """One force evaluation through each runner's route (3 shards do not
    divide 32: "auto" falls back to the replicated grid), bitwise the
    single device on a mesh of one."""
    _, te, single = _force_pair()
    got = tps.pm_accelerations_sharded(
        te.state.positions, te.state.masses, te.quantizer, te.cfg, tmesh(S),
        torch.tensor(1.0 / 21.0), False, route).numpy()
    if S == 1:
        np.testing.assert_array_equal(got, single)
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# Short horizons of the replicated runner
# --------------------------------------------------------------------------

def _hold_horizon(got, gs, want, ws, box=BOX):
    assert np.max(_periodic(got.positions, want.positions, box)) < 1e-2
    np.testing.assert_allclose(np.asarray(gs.kinetic),
                               np.asarray(ws.kinetic), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gs.momentum),
                               np.asarray(ws.momentum), rtol=1e-3, atol=1e7)
    np.testing.assert_array_equal(np.asarray(gs.redshift),
                                  np.asarray(ws.redshift))


@functools.lru_cache(maxsize=None)
def _jax_horizon(precision, n, steps):
    """JAX's short-horizon setup, and its sharded run at G unfolded."""
    je = jc.CosmologicalEngine(**_kw(n=n, precision=precision))
    st = _tame(je)
    if n == 1024:
        st = st._replace(positions=je.state.positions)
    sched, _ = je._build_schedule(1.0, steps)
    qf = je.quantizer.is_int if n == 1024 else True
    cfg = dataclasses.replace(je.cfg, G=jc.G_NEWTON)
    out = jps.run_pm_steps_sharded(st, sched, je.quantizer, cfg, jmesh(8),
                                   quantize_forces=qf)
    return je, st, sched, qf, _np(out)


def _horizon_pair(precision, n, steps, S=8):
    """(port's sharded run, its single-device run) at the engine's G, and
    (port's sharded run, JAX's) at G unfolded, from JAX's setup."""
    je, st, sched, qf, jax_out = _jax_horizon(precision, n, steps)
    te = tc.CosmologicalEngine(device="cpu", **_kw(n=n, precision=precision))
    te.load_jax_state(_np(st), je.mass_unit_msun)
    got = tps.run_pm_steps_sharded(te.state, sched, te.quantizer, te.cfg,
                                   tmesh(S), quantize_forces=qf)
    single = tc.run_pm_steps(te.state, sched, te.quantizer, te.cfg,
                             quantize_forces=qf)
    cfg = dataclasses.replace(te.cfg, G=tc.G_NEWTON)
    unfolded = tps.run_pm_steps_sharded(te.state, sched, te.quantizer, cfg,
                                        tmesh(S), quantize_forces=qf)
    return te, sched, (got, single), (unfolded, jax_out)


@pytest.mark.parametrize("precision", ["float32", "int4"])
def test_short_horizon_matches_jax_and_single_device(precision):
    _, _, (got, single), (unfolded, jax_out) = _horizon_pair(precision,
                                                             1024, 3)
    _hold_horizon(*got, *single)
    _hold_horizon(*unfolded, *jax_out)
    assert got[0].redshift == float(jax_out[0].redshift)
    assert got[0].tick == int(jax_out[0].tick) == 3
    assert got[0].positions.shape == (1024, 2)


def test_unaligned_particles_match_jax_and_single_device():
    """900 particles over 8 shards: 4 phantom rows."""
    te, sched, (got, single), (unfolded, jax_out) = _horizon_pair(
        "float32", 900, 2)
    for (a, a_s), (b, b_s) in ((got, single), (unfolded, jax_out)):
        assert np.max(_periodic(a.positions, b.positions)) < 1e-2
        np.testing.assert_allclose(np.asarray(a_s.kinetic),
                                   np.asarray(b_s.kinetic), rtol=1e-3,
                                   atol=1e-6)
    got = got[0]
    assert got.positions.shape == (900, 2)
    padded, _ = tps.run_pm_steps_sharded(te.state, sched, te.quantizer,
                                         te.cfg, tmesh(8), gather=False)
    assert padded.positions.shape == (904, 2)
    assert torch.equal(padded.positions[:900], got.positions)
    assert torch.equal(padded.masses[900:], torch.zeros(4))


# --------------------------------------------------------------------------
# The slab-FFT runner
# --------------------------------------------------------------------------

FFT_CASES = {2: dict(n=1024, dim=2, n_grid=32, S=8),
             3: dict(n=512, dim=3, n_grid=16, S=4)}


@functools.lru_cache(maxsize=None)
def _jax_fft(precision, dim, gather_mode):
    c = FFT_CASES[dim]
    je = jc.CosmologicalEngine(**_kw(n=c["n"], precision=precision,
                                     dim=dim, n_grid=c["n_grid"]))
    cfg = dataclasses.replace(je.cfg, G=jc.G_NEWTON)
    st = _tame(je)._replace(positions=je.state.positions)
    sched, _ = je._build_schedule(1.0, 3)
    qf = je.quantizer.is_int
    out = jps.run_pm_steps_sharded_fft(st, sched, je.quantizer, cfg,
                                       jmesh(c["S"]), quantize_forces=qf,
                                       gather_mode=gather_mode)
    return st, sched, qf, _np(out)


def _port_fft(precision, dim):
    c = FFT_CASES[dim]
    te = tc.CosmologicalEngine(device="cpu", **_kw(
        n=c["n"], precision=precision, dim=dim, n_grid=c["n_grid"]))
    return dataclasses.replace(te.cfg, G=tc.G_NEWTON), te.quantizer, c["S"]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("precision", ["float32", "int4"])
def test_fft_runner_matches_replicated_and_jax(precision, dim):
    """The slab path (reduce-scatter deposit, slab-decomposed solve, its
    gather) against the replicated grid at small grids; D=2 cuts the
    half spectrum's 17 columns unevenly over 8 shards."""
    st, sched, qf, (jstate, jstream) = _jax_fft(precision, dim, "auto")
    cfg, q, S = _port_fft(precision, dim)
    state = _port(st)
    fft, fs = tps.run_pm_steps_sharded_fft(state, sched, q, cfg, tmesh(S),
                                           quantize_forces=qf)
    rep, rs = tps.run_pm_steps_sharded(state, sched, q, cfg, tmesh(S),
                                       quantize_forces=qf)
    single, ss = tc.run_pm_steps(state, sched, q, cfg, quantize_forces=qf)
    for want, ws in ((rep, rs), (single, ss), (jstate, jstream)):
        assert np.max(_periodic(fft.positions, want.positions)) < 1e-3
        np.testing.assert_allclose(np.asarray(fs.kinetic),
                                   np.asarray(ws.kinetic), rtol=1e-4,
                                   atol=1e-9)


@pytest.mark.parametrize("dim", [2, 3])
def test_slab_poisson_solve_matches_the_single_device_solve(dim):
    """The slab-decomposed solve itself, grid for grid, against
    pm.poisson_accel_grids on the whole density, S in {3, 4}, int4's
    quantized k^2 (the constants cut after the quantizer)."""
    n_grid = 24
    rng = np.random.default_rng(dim)
    density = torch.from_numpy(rng.uniform(0.5, 1.5, (n_grid,) * dim)
                               .astype(np.float32))
    q = tc.Quantizer.from_string("int4")
    want = tpm.poisson_accel_grids(density, BOX, n_grid, q, 1.0, 0.5, dim)
    for S in (3, 4):
        mesh = tmesh(S)
        slabs = list(density.tensor_split(S))
        got = tps.poisson_accel_slabs(slabs, BOX, n_grid, q, 1.0,
                                      [torch.tensor(0.5)] * S, dim, mesh)
        for d in range(dim):
            full = torch.cat([g[d] for g in got])
            np.testing.assert_allclose(full.numpy(), want[d].numpy(),
                                       rtol=0, atol=1e-5
                                       * float(want[d].abs().max()))


@pytest.mark.parametrize("S", [3, 8])
def test_sharded_fft_density_matches_fftn_and_jax(S):
    rng = np.random.default_rng(5)
    pos = (rng.uniform(size=(2048, 2)) * 100.0).astype(np.float32)
    w = np.ones(2048, np.float32)
    got = tps.sharded_fft_density(torch.from_numpy(pos), torch.from_numpy(w),
                                  64, 100.0, tmesh(S)).numpy()
    dense = torch.fft.fftn(tpm.ngp_deposit(torch.from_numpy(pos),
                                           torch.from_numpy(w), 64,
                                           100.0)).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-3)
    if 64 % S == 0:   # JAX's sharding needs S to divide the grid
        jax_got = np.asarray(jps.sharded_fft_density(
            jnp.asarray(pos), jnp.asarray(w), 64, 100.0, jmesh(S)))
        np.testing.assert_allclose(got, jax_got, rtol=1e-4, atol=1e-3)
    one = tps.sharded_fft_density(torch.from_numpy(pos), torch.from_numpy(w),
                                  64, 100.0, tmesh(1)).numpy()
    np.testing.assert_array_equal(one, dense)


@pytest.mark.parametrize("deposit", ["ngp", "cic"])
def test_slab_gather_partials_reconstruct_full(deposit):
    """The slab partials sum to the full gather, particles pinned on slab
    edges included; each partial against JAX's; one slab holding the
    whole grid is the full gather bit for bit."""
    n_grid, box, dim, n_slabs = 32, 100.0, 2, 8
    rng = np.random.default_rng(7)
    pos = (rng.uniform(size=(512, dim)) * box).astype(np.float32)
    pos[:8, 0] = np.arange(8) * (box / n_slabs)
    grids = [rng.standard_normal((n_grid,) * dim).astype(np.float32)
             for _ in range(dim)]
    tg = [torch.from_numpy(g) for g in grids]
    tp = torch.from_numpy(pos)
    full_fn = getattr(tpm, f"{deposit}_gather")
    slab_fn = getattr(tpm, f"{deposit}_gather_slab")
    jslab_fn = getattr(jpm, f"{deposit}_gather_slab")
    full = full_fn(tg, tp, n_grid, box)
    slab = n_grid // n_slabs
    total = torch.zeros_like(full)
    for s in range(n_slabs):
        part = slab_fn([g[s * slab:(s + 1) * slab] for g in tg], tp, n_grid,
                       box, s * slab)
        jpart = np.asarray(jslab_fn(
            [jnp.asarray(g[s * slab:(s + 1) * slab]) for g in grids],
            jnp.asarray(pos), n_grid, box, s * slab))
        np.testing.assert_allclose(part.numpy(), jpart, rtol=1e-5,
                                   atol=1e-5)
        total = total + part
    np.testing.assert_allclose(total.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(slab_fn(tg, tp, n_grid, box, 0), full)


@pytest.mark.parametrize("precision", ["float32", "int4"])
def test_slab_gather_matches_replicate_gather_and_jax(precision):
    st, sched, qf, (jstate, jstream) = _jax_fft(precision, 2, "slab")
    cfg, q, S = _port_fft(precision, 2)
    state = _port(st)
    slab, ss = tps.run_pm_steps_sharded_fft(state, sched, q, cfg, tmesh(S),
                                            quantize_forces=qf,
                                            gather_mode="slab")
    rep, rs = tps.run_pm_steps_sharded_fft(state, sched, q, cfg, tmesh(S),
                                           quantize_forces=qf,
                                           gather_mode="replicate")
    for want, ws in ((rep, rs), (jstate, jstream)):
        assert np.max(_periodic(slab.positions, want.positions)) < 1e-4
        np.testing.assert_allclose(np.asarray(ss.kinetic),
                                   np.asarray(ws.kinetic), rtol=1e-5,
                                   atol=1e-10)
    with pytest.raises(ValueError, match="gather_mode"):
        tps.run_pm_steps_sharded_fft(state, sched, q, cfg, tmesh(S),
                                     gather_mode="scatter")


def test_fft_pm_odd_mesh_falls_back_to_replicated():
    """n_grid=48 on 5 shards: 'auto' is the replicated runner bit for bit,
    'slab' raises naming "divisible"; the port against JAX's runner."""
    je = jc.CosmologicalEngine(**_kw(n=640, n_grid=48))
    te = tc.CosmologicalEngine(device="cpu", **_kw(n=640, n_grid=48))
    te.load_jax_state(_np(je.state), je.mass_unit_msun)
    sched, _ = je._build_schedule(1.0, 2)
    one, _ = je._build_schedule(1.0, 1)
    mesh = tmesh(5)
    fft, fs = tps.run_pm_steps_sharded_fft(te.state, sched, te.quantizer,
                                           te.cfg, mesh,
                                           quantize_forces=False)
    rep, rs = tps.run_pm_steps_sharded(te.state, sched, te.quantizer,
                                       te.cfg, mesh, quantize_forces=False)
    _same_state(fft, rep)
    _same_stream(fs, rs)
    with pytest.raises(ValueError, match="divisible"):
        tps.run_pm_steps_sharded_fft(te.state, sched, te.quantizer, te.cfg,
                                     mesh, quantize_forces=False,
                                     gather_mode="slab")
    got, gs = tps.run_pm_steps_sharded_fft(te.state, one, te.quantizer,
                                           te.cfg, mesh,
                                           quantize_forces=False)
    jstate, jstream = _np(jps.run_pm_steps_sharded(
        je.state, one, je.quantizer, je.cfg, jmesh(5),
        quantize_forces=False))
    single, _ = tc.run_pm_steps(te.state, one, te.quantizer, te.cfg,
                                quantize_forces=False)
    for want in (jstate, single):
        _hold_step(got.velocities, got.positions, want.velocities,
                   want.positions, one)
    np.testing.assert_allclose(gs.kinetic.numpy(), jstream.kinetic,
                               rtol=1e-5)


# --------------------------------------------------------------------------
# A mesh of one is the single device, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("runner", ["replicated", "slab", "replicate"])
@pytest.mark.parametrize("deposit, dim", [("ngp", 2), ("cic", 2),
                                          ("ngp", 3)])
@pytest.mark.parametrize("precision", ["float32", "int4"])
def test_mesh_of_one_runners_are_bitwise_single_device(precision, deposit,
                                                       dim, runner):
    te = tc.CosmologicalEngine(device="cpu", deposit=deposit, **_kw(
        n=1024 if dim == 2 else 512, precision=precision, dim=dim,
        n_grid=32 if dim == 2 else 16))
    sched, _ = te._build_schedule(1.0, 3)
    qf = te.quantizer.is_int
    single, ss = tc.run_pm_steps(te.state, sched, te.quantizer, te.cfg,
                                 quantize_forces=qf)
    if runner == "replicated":
        got, gs = tps.run_pm_steps_sharded(te.state, sched, te.quantizer,
                                           te.cfg, tmesh(1),
                                           quantize_forces=qf)
    else:
        got, gs = tps.run_pm_steps_sharded_fft(
            te.state, sched, te.quantizer, te.cfg, tmesh(1),
            quantize_forces=qf, gather_mode=runner)
    _same_state(got, single)
    _same_stream(gs, ss)


def _same_history(a, b):
    for key in ("energy", "redshift", "time_gyr", "bao_scale",
                "clustering"):
        np.testing.assert_array_equal(np.asarray(a.history[key]),
                                      np.asarray(b.history[key]),
                                      err_msg=key)
    assert [dataclasses.asdict(g) for g in a.history["glitches"]] == \
        [dataclasses.asdict(g) for g in b.history["glitches"]]
    for ea, eb in zip(a.history["exploits"], b.history["exploits"]):
        for k in ea:
            va, vb = ea[k], eb[k]
            if dataclasses.is_dataclass(va):
                assert dataclasses.asdict(va) == dataclasses.asdict(vb), k
            else:
                assert va == vb, k
    assert a.glitch_detector.subnormal_history == \
        b.glitch_detector.subnormal_history
    assert a.exploit_engine.gamma_history == b.exploit_engine.gamma_history


@pytest.mark.parametrize("n_grid", [16, 256])
def test_engine_through_a_mesh_of_one_is_bitwise_single_device(n_grid):
    """The whole engine, histories and all, on either runner (n_grid 256
    takes the slab-FFT runner's slab gather)."""
    kw = dict(num_particles=256, start_redshift=6.0, precision="int4",
              dim=2, n_grid=n_grid, seed=11, device="cpu")
    a = tc.CosmologicalEngine(**kw)
    b = tc.CosmologicalEngine(mesh=tmesh(1), **kw)
    a.run_to_completion(dz=1.0, chunk=3)
    b.run_to_completion(dz=1.0, chunk=3, pipelined=True)
    assert a.tick == b.tick == 6
    _same_state(a.state, b.state)
    _same_history(a, b)


# --------------------------------------------------------------------------
# The engine on a mesh
# --------------------------------------------------------------------------

def test_engine_runs_sharded_when_mesh_given():
    """CosmologicalEngine(mesh=) against the port's single-device engine
    (3 steps, step by step) and JAX's mesh engine (its first step) from
    the same state."""
    je, te = _pair(mesh_s=8, precision="int4")
    single = tc.CosmologicalEngine(device="cpu", **_kw(precision="int4"))
    single.load_jax_state(_np(je.state), je.mass_unit_msun)
    for step in range(3):
        sched, _ = te._build_schedule(1.0, 1)
        te.step(1.0, num_steps=1)
        single.step(1.0, num_steps=1)
        _hold_step(te.velocities, te.positions, single.velocities,
                   single.positions, sched)
        if step == 0:
            je.step(1.0, num_steps=1)
            _hold_step(te.velocities, te.positions, np.asarray(je.velocities),
                       np.asarray(je.positions), sched)
            np.testing.assert_allclose(te.history["energy"],
                                       je.history["energy"], rtol=1e-5)
    je.step(1.0, num_steps=2)
    assert te.tick == je.tick == 3 and te.mesh.size == 8
    assert te.redshift == single.redshift == je.redshift
    assert len(te.history["energy"]) == 3
    assert len(te.glitch_detector.subnormal_history) == 3
    assert np.isfinite(te.positions.numpy()).all()
    np.testing.assert_allclose(te.history["energy"],
                               single.history["energy"], rtol=1e-3)


def test_mesh_engine_pipelined_matches_sequential():
    """History-identical pipelined and sequential runs on 8 shards; the
    sequential run's redshifts and first chunk's energies are JAX's mesh
    engine's from the same state."""
    kw = dict(precision="int4", z=8.0, seed=5)
    je, seq = _pair(mesh_s=8, **kw)
    pipe = tc.CosmologicalEngine(mesh=tmesh(8), device="cpu", **_kw(**kw))
    pipe.load_jax_state(_np(je.state), je.mass_unit_msun)
    seq.run_to_completion(dz=1.0, chunk=3)
    pipe.run_to_completion(dz=1.0, chunk=3, pipelined=True)
    assert pipe.completed
    assert torch.equal(seq.positions, pipe.positions)
    _same_history(seq, pipe)
    je.run_to_completion(dz=1.0, chunk=3, pipelined=True)
    np.testing.assert_array_equal(seq.history["redshift"],
                                  je.history["redshift"])
    np.testing.assert_allclose(seq.history["energy"][0],
                               je.history["energy"][0], rtol=1e-5)


def test_mesh_engine_resident_sharded_loop():
    """900 particles on 8 shards: the state stays padded to 904 rows
    between chunks while the views expose the 900 real ones; a JAX mesh
    engine's padded state carries across and continues alike."""
    je, e = _pair(mesh_s=8, n=900, precision="int4", z=6.0, seed=7)
    assert e.num_particles == 900
    je.step(1.0, num_steps=2)
    e.step(1.0, num_steps=2)
    assert e._state.positions.shape[0] == 904
    assert e.positions.shape == (900, 2)
    assert np.isfinite(e.positions.numpy()).all()
    assert np.isfinite(e.get_kinetic_energy())
    assert np.isfinite(e.get_bao_scale())
    e.step(1.0, num_steps=2)
    assert e._state.positions.shape[0] == 904
    assert len(e.history["energy"]) == 4
    assert e.get_state_dict()["positions"].shape == (900, 2)

    carried = tc.CosmologicalEngine(mesh=tmesh(8), device="cpu", **_kw(
        n=900, precision="int4", z=6.0, seed=7))
    padded = _np(je.state)
    assert padded.positions.shape[0] == 904
    carried.load_jax_state(padded, je.mass_unit_msun)
    assert carried._state.positions.shape[0] == 904
    np.testing.assert_array_equal(carried.positions.numpy(),
                                  np.asarray(je.positions))
    sched, _ = carried._build_schedule(1.0, 1)
    je.step(1.0, num_steps=1)
    carried.step(1.0, num_steps=1)
    assert carried._state.positions.shape[0] == 904
    _hold_step(carried.velocities, carried.positions,
               np.asarray(je.velocities), np.asarray(je.positions), sched)


def test_mesh_engine_checkpoint_strips_padding(tmp_path):
    """Checkpoints of a padded run hold the 900 real rows (JAX's trimmed
    state's bits, carried across); a resumed engine continues, and
    restore_to_sharding puts the state on a mesh of another shape."""
    kw = dict(n=900, precision="float32", z=6.0, seed=9)
    je, e = _pair(mesh_s=8, **kw)
    je.step(1.0, num_steps=2)
    e.load_jax_state(_np(je.state), je.mass_unit_msun)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    e.save_checkpoint(mgr)
    saved = np.load(tmp_path / "ckpt" / "ckpt_2.npz")
    assert saved["positions"].shape == (900, 2)
    np.testing.assert_array_equal(saved["positions"],
                                  np.asarray(je._trimmed_state().positions))

    r = tc.CosmologicalEngine(mesh=tmesh(8), device="cpu", **_kw(**kw))
    assert r.restore_latest(mgr) == e.tick == 2
    assert torch.equal(r.positions, e.positions)
    assert r.exploit_engine.prev_positions is None or \
        r.exploit_engine.prev_positions.shape[0] % 8 == 0
    r.step(1.0, num_steps=1)
    assert np.isfinite(r.positions.numpy()).all()

    three = tmesh(3)
    st = mgr.restore_to_sharding(2, r._trimmed_state(), three)
    assert st.positions.device == three.devices[0]
    assert st.positions.shape == (900, 2) and st.tick == 2
    sched, _ = e._build_schedule(1.0, 1)
    on3, s3 = tps.run_pm_steps_sharded(st, sched, e.quantizer, e.cfg, three,
                                       gather=False)
    on8, s8 = tps.run_pm_steps_sharded(st, sched, e.quantizer, e.cfg,
                                       tmesh(8))
    assert on3.positions.shape == (900, 2)
    np.testing.assert_allclose(s3.kinetic.numpy(), s8.kinetic.numpy(),
                               rtol=1e-3)


def test_mesh_engine_divisible_n_diagnostics():
    """N divisible by the mesh: no padding; the diagnostics and exports
    work and agree with JAX's mesh engine from the same state."""
    je, e = _pair(mesh_s=8, precision="int4", z=6.0, seed=13)
    e.step(1.0, num_steps=2)
    je.step(1.0, num_steps=2)
    assert e._state.positions.shape[0] == 1024
    k, pk = e.compute_power_spectrum()
    assert np.isfinite(pk).all()
    assert np.isfinite(e.get_bao_scale())
    assert np.isfinite(e.get_clustering())
    assert e.get_state_dict()["positions"].shape == (1024, 2)
    assert e._trimmed_state().positions.shape == (1024, 2)
    # the PM gate's clustering rule (diagnostics/pm_gate.compare_mode)
    assert abs(e.get_clustering() - je.get_clustering()) \
        < 0.25 * je.get_clustering()


def test_probe_bundle_sharded_matches_the_single_device_bundle():
    """On 3 shards with phantom rows (1024 -> 1026): the probe bundle of
    the padded state against probe_bundle on the real rows."""
    e = tc.CosmologicalEngine(device="cpu", **_kw())
    e.step(1.0, 2)
    pos, vel = e.positions, e.velocities
    prev = pos + 0.05
    obs_pos = torch.tensor([50.0, 60.0])
    obs_dir = torch.tensor([0.6, 0.8])
    want = tc.probe_bundle(pos, vel, prev, obs_pos, obs_dir, BOX,
                           e.exploit_engine.c_sim, e.exploit_engine.fov_cos)
    pad = lambda x: torch.cat([x, torch.zeros((2, 2))])  # noqa: E731
    got = tc.probe_bundle_sharded(pad(pos), pad(vel), pad(prev), obs_pos,
                                  obs_dir, BOX, e.exploit_engine.c_sim,
                                  e.exploit_engine.fov_cos, 1024, tmesh(3))
    assert torch.equal(got.k_centers, want.k_centers)
    np.testing.assert_allclose(got.pk.numpy(), want.pk.numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(got.clustering), float(want.clustering),
                               rtol=1e-5)
    for name in ("near_c_09", "near_c_099", "in_frustum", "snap_events"):
        assert int(getattr(got.exploit, name)) == \
            int(getattr(want.exploit, name)), name
    for name in ("max_gamma", "v_mean", "v_std"):
        np.testing.assert_allclose(float(getattr(got.exploit, name)),
                                   float(getattr(want.exploit, name)),
                                   rtol=1e-5, err_msg=name)


def test_engine_mesh_device_rules():
    e = tc.CosmologicalEngine(mesh=tmesh(2), **_kw(n=64))
    assert e.device == torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        tc.CosmologicalEngine(mesh=ParticleMesh(["meta"]), device="cpu",
                              **_kw(n=64))


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import nbody_tpu_torch.parallel.pm_sharded\n"
            "import nbody_tpu_torch.engines.universe3d\n"
            "import nbody_tpu_torch.engines.dashboard3d\n"
            "import nbody_tpu_torch.engines.genesis\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'nbody_tpu', 'tools')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
