"""nbody_tpu_torch.parallel.ring against nbody_tpu.parallel.ring, on the CPU.

JAX runs its ring on ``make_particle_mesh(S)`` over the conftest's virtual
CPU devices; the port runs its ring on ``ParticleMesh.virtual(S, "cpu")``,
whose tiles are the kernels' plain versions here. S in {1, 2, 3, 4} covers
odd and even rings (the even ring's half-distance step), and N = 16 S + 5
is unaligned, so the last shard carries phantom rows. Inputs are made with
numpy from a seed and handed to both packages.

Tolerances, each with its reason:

* forces, float32 / float64: |err| <= 1e-5 x the row's summed |terms|
  (the same terms in another summation order, as
  tests/test_torch_ring_tiles.py);
* forces, the other modes: fewer than 2% of the components off by more
  than 1e-4 max|a| (a bin flip of the log grid, or of the int modes'
  force grid after quantize_force, moves a component by a whole step);
* the ring's max d^2: bitwise, or one ulp where XLA:CPU contracts d^2 into
  an FMA; against the port's single-device max_d2: bitwise;
* potential energies: 1e-6 relative (f32 pair terms; compensated or f64
  sums of per-row f32 sums of <= 69 terms);
* drift curves and trajectories: as tests/test_torch_direct.py (float32
  energies 1e-5, positions 1e-4 / 1e-5; int4 final drift within 10% of
  JAX's or 5e-7, radius90 within 1%);
* the float64 baseline against JAX's double-double ring: atol 1e-5 max|a|
  for the force (JAX's f32 pair terms round with the summed |terms|),
  positions and energies 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.diagnostics import metrics as jm
from nbody_tpu.models import galaxy as jg
from nbody_tpu.models import state as jstate
from nbody_tpu.ops import precision as jp
from nbody_tpu.parallel import ring as jring
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.diagnostics import metrics as tm
from nbody_tpu_torch.models import direct as td
from nbody_tpu_torch.models.state import make_baseline_state, make_state
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp
from nbody_tpu_torch.parallel import ring

torch.set_num_threads(1)

MODES = ["float64", "float32", "bf16", "f16", "int8", "int4", "custom"]
CFG, JCFG = SimConfig(), JaxConfig()
# (S, schedule, mode): every mode at S=3 on the sym schedule; float32 and
# int4 for every other pair of S and schedule.
FORCE_CASES = ([(3, "sym", m) for m in MODES]
               + [(s, sched, m) for s in (1, 2, 3, 4)
                  for sched in ("sym", "rows") for m in ("float32", "int4")
                  if (s, sched) != (3, "sym")])


def _n(n_shards):
    return 16 * n_shards + 5


@functools.lru_cache(maxsize=None)
def _ics(n, seed=0):
    """Disk ICs from the JAX package (numpy), with unequal masses."""
    pos, vel, m = jg.create_disk_galaxy(jax.random.PRNGKey(seed),
                                        num_stars=n)
    rng = np.random.default_rng(seed + n)
    m = np.asarray(m) * (1.0 + rng.random(n)).astype(np.float32)
    return np.asarray(pos), np.asarray(vel), m.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mesh(n_shards):
    return ring.ParticleMesh.virtual(n_shards, "cpu")


def _quantize(mode):
    return mode in ("int8", "int4")


def _hold_forces(got, want, pos, m, mode):
    assert np.isfinite(got).all()
    q = tp.Quantizer.from_string(mode)
    if mode in ("float32", "float64"):
        bounds = hn.kernel_bounds(_t(pos), q, CFG)
        scale = hn.sym_force_term_scale(_t(pos), CFG.G * _t(m), bounds, q,
                                        False).numpy()
        assert (np.abs(got - want) <= 1e-5 * scale + 1e-12).all()
    else:
        off = np.abs(got - want) > 1e-4 * np.abs(want).max()
        assert off.mean() < 0.02, f"{off.mean():.3%} components off"


@pytest.mark.parametrize("n_shards,schedule,mode", FORCE_CASES)
def test_ring_force_matches_jax(n_shards, schedule, mode):
    pos, _, m = _ics(_n(n_shards))
    qf = _quantize(mode)
    want = np.asarray(jring.ring_accelerations(
        jnp.asarray(pos), jnp.asarray(m), jp.Quantizer.from_string(mode),
        JCFG, jring.make_particle_mesh(n_shards), quantize_forces=qf,
        schedule=schedule))
    got = ring.ring_accelerations(_t(pos), _t(m),
                                  tp.Quantizer.from_string(mode), CFG,
                                  _mesh(n_shards), quantize_forces=qf,
                                  schedule=schedule)
    assert got.shape == pos.shape
    _hold_forces(got.numpy(), want, pos, m, mode)


@pytest.mark.parametrize("softening", [CFG.softening, 0.0])
@pytest.mark.parametrize("schedule", ["sym", "rows"])
def test_ring_tile_impls_agree(schedule, softening):
    """The kernel path (plain versions here) against the 'jnp' id-masked
    broadcast tile, its reference, at S=4 with phantoms: at zero softening
    the kernel path masks self-pairs only on the diagonal (row_force) and
    leaves the tiles between shards unmasked."""
    pos, _, m = _ics(_n(4))
    pos = pos.copy()
    pos[0] = 0.0
    cfg = SimConfig(softening=softening)
    q = tp.Quantizer.from_string("float32")
    got, want = (ring.ring_accelerations(_t(pos), _t(m), q, cfg, _mesh(4),
                                         schedule=schedule, tile_impl=impl)
                 for impl in ("auto", "jnp"))
    assert torch.isfinite(got).all()
    scale = hn.sym_force_term_scale(_t(pos), cfg.G * _t(m),
                                    hn.kernel_bounds(_t(pos), q, cfg), q,
                                    softening == 0.0).numpy()
    assert (np.abs(got.numpy() - want.numpy()) <= 1e-5 * scale + 1e-12).all()
    for bad in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="unknown tile impl"):
            ring.ring_accelerations(_t(pos), _t(m), q, cfg, _mesh(2),
                                    tile_impl=bad)


def _jax_ring_max(pos, n_total, n_shards):
    """JAX's per-device _ring_max_d2 body under shard_map."""
    from nbody_tpu.ops.pallas_nbody import _PAD_FAR
    padded = jring._pad_to_shards(jnp.asarray(pos), n_shards, fill=_PAD_FAR)
    ids = jnp.arange(padded.shape[0], dtype=jnp.int32)
    fn = shard_map(functools.partial(jring._ring_max_d2, n_total=n_total,
                                     cfg=JCFG),
                   mesh=jring.make_particle_mesh(n_shards),
                   in_specs=(P(jring.AXIS), P(jring.AXIS)), out_specs=P(),
                   check_vma=False)
    return np.float32(fn(padded, ids))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_ring_max_d2_matches_jax_and_single_device(n_shards):
    n = _n(n_shards)
    pos, _, m = _ics(n)
    mesh = _mesh(n_shards)
    padded, _, _, ids = ring._padded(_t(pos), None, _t(m), mesh)
    got = ring._ring_max_d2(mesh, ring._shards(padded, mesh),
                            ring._shards(ids, mesh), n, CFG)
    assert torch.equal(got, hn.max_d2(_t(pos)) + CFG.softening_sq)
    want = _jax_ring_max(pos, n, n_shards)
    g = np.float32(got)
    assert g == want or g in (np.nextafter(want, np.float32(np.inf)),
                              np.nextafter(want, np.float32(0))), (g, want)


@functools.lru_cache(maxsize=None)
def _bounds_case(state, n_shards):
    """(n, positions, JAX's ring max) past PRUNED_CANDIDATES, with the
    phantoms _n gives (1032 is 0 mod 2, 3 and 4)."""
    n = hn.PRUNED_CANDIDATES + 8 + _n(n_shards)
    pos = _bounds_positions(state, n)
    return n, pos, _jax_ring_max(pos, n, n_shards)


def _bounds_positions(state, n):
    """The disk (JAX's ICs), whose largest radii hold the diameter; a thin
    shell of radius 5 and a coincident cloud, where every point is a
    candidate and the pruned pass must fall back."""
    if state == "disk":
        return _ics(n)[0]
    if state == "shell":
        th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
        return (5.0 * np.stack([np.cos(th), np.sin(th)], 1)).astype(
            np.float32)
    return np.tile(np.float32([1.5, -2.0]), (n, 1))


@pytest.mark.parametrize("state", ["disk", "shell", "cloud"])
@pytest.mark.parametrize("schedule", ["sym", "rows"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_ring_bounds_take_the_pruned_pass_on_the_home_device(
        n_shards, schedule, state, monkeypatch):
    """Past PRUNED_CANDIDATES, with phantoms as _n gives them: the ring's
    bound, the pruned pass on the gathered positions, is bitwise the
    single-device max_d2 of the real particles + eps^2 (and JAX's ring
    pass), its log grid that of the single-device max on every shard, in
    both schedules; every pass counts in TRAFFIC["bounds_passes"], and
    BOUNDS_FALLBACKS counts exactly those whose candidates fell short
    (the shell and the cloud), and no pair_max pass runs."""
    n, pos, jax_max = _bounds_case(state, n_shards)
    mesh, q = _mesh(n_shards), tp.Quantizer.from_string("int4")
    padded, _, _, ids = ring._padded(_t(pos), None, torch.ones(n), mesh)
    pos_l, ids_l = ring._shards(padded, mesh), ring._shards(ids, mesh)
    hn.BOUNDS_FALLBACKS.clear()
    ring.TRAFFIC["bounds_passes"] = 0
    monkeypatch.setattr(hn, "pair_max", lambda *a, **k: pytest.fail(
        "a pair_max pass ran"))
    got = ring._ring_bounds_max(mesh, pos_l, ids_l, n, CFG)
    want = hn.max_d2(_t(pos)) + CFG.softening_sq
    assert torch.equal(got, want)
    g = np.float32(got)
    assert g == jax_max or g in (np.nextafter(jax_max, np.float32(np.inf)),
                                 np.nextafter(jax_max, np.float32(0)))
    lo, hi = ring._ring_log_bounds(mesh, pos_l, ids_l, n, q, CFG)
    want_lo, want_hi = tp.dist_sq_log_bounds(q, want, CFG.softening_sq)
    assert all(torch.equal(x, want_lo) for x in lo)
    assert all(torch.equal(x, want_hi) for x in hi)
    ring.ring_accelerations(_t(pos), torch.full((n,), 1.0 / n), q, CFG,
                            mesh, schedule=schedule)
    assert ring.TRAFFIC["bounds_passes"] == 3
    assert hn.bounds_fallbacks("cpu") == (0 if state == "disk" else 3)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_ring_potential_energy_matches_jax(n_shards, compensated):
    pos, _, m = _ics(_n(n_shards))
    want = float(jring.ring_potential_energy(
        jnp.asarray(pos), jnp.asarray(m), JCFG,
        jring.make_particle_mesh(n_shards), compensated=compensated))
    got = ring.ring_potential_energy(_t(pos), _t(m), CFG, _mesh(n_shards),
                                     compensated=compensated)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert float(got) == pytest.approx(
        float(tm.potential_energy(_t(pos), _t(m), CFG)), rel=1e-6)


@pytest.mark.parametrize("schedule", ["sym", "rows"])
def test_ring_zero_softening_origin_particle_with_phantoms(schedule):
    """Zero softening, phantom rows and a real particle at the origin: the
    far-sentinel phantoms keep the forces and the energy finite, and the
    kernel path (row_force's self-mask on the diagonal, unmasked tiles
    between shards) computes JAX's id-masked tile."""
    pos, _, m = _ics(_n(4))
    pos = pos.copy()
    pos[0] = 0.0
    cfg0, jcfg0 = SimConfig(softening=0.0), JaxConfig(softening=0.0)
    want = np.asarray(jring.ring_accelerations(
        jnp.asarray(pos), jnp.asarray(m), jp.Quantizer.from_string("float32"),
        jcfg0, jring.make_particle_mesh(4), schedule=schedule))
    got = ring.ring_accelerations(_t(pos), _t(m),
                                  tp.Quantizer.from_string("float32"), cfg0,
                                  _mesh(4), schedule=schedule).numpy()
    assert np.isfinite(got).all()
    q = tp.Quantizer.from_string("float32")
    scale = hn.sym_force_term_scale(_t(pos), CFG.G * _t(m),
                                    hn.kernel_bounds(_t(pos), q, cfg0), q,
                                    True).numpy()
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-12).all()
    pe = float(ring.ring_potential_energy(_t(pos), _t(m), cfg0, _mesh(4)))
    assert np.isfinite(pe)
    assert pe == pytest.approx(float(jring.ring_potential_energy(
        jnp.asarray(pos), jnp.asarray(m), jcfg0,
        jring.make_particle_mesh(4))), rel=1e-6)


# (S, schedule, mode) of the history runs: 2 chunks of 5 ticks each.
HISTORY_CASES = [(3, "sym", "float32"), (2, "rows", "float32"),
                 (4, "sym", "int4"), (1, "sym", "int4"),
                 (3, "rows", "int4")]


def _radius90(pos):
    return float(np.percentile(np.sqrt((pos.astype(np.float64) ** 2
                                        ).sum(1)), 90))


@pytest.mark.parametrize("n_shards,schedule,mode", HISTORY_CASES)
def test_run_with_snapshots_sharded_matches_jax(n_shards, schedule, mode):
    n = _n(n_shards)
    pos, vel, m = _ics(n, seed=1)
    qf = _quantize(mode)
    jst, jsn, jfr = jring.run_with_snapshots_sharded(
        jstate.make_state(jnp.asarray(pos), jnp.asarray(vel),
                          jnp.asarray(m)),
        jp.Quantizer.from_string(mode), JCFG,
        jring.make_particle_mesh(n_shards), 5, 2, quantize_forces=qf,
        schedule=schedule)
    tst, tsn, tfr = ring.run_with_snapshots_sharded(
        make_state(pos, vel, m), tp.Quantizer.from_string(mode), CFG,
        _mesh(n_shards), 5, 2, quantize_forces=qf, schedule=schedule)
    assert tst.positions.shape[0] == jst.positions.shape[0]  # padded
    assert tst.tick == 10 and tfr.shape == (2, n, 2)
    np.testing.assert_array_equal(tsn.tick, np.asarray(jsn.tick))
    e0 = float(tm.total_energy(_t(pos), _t(vel), _t(m), CFG))
    je0 = float(jm.total_energy(jnp.asarray(pos), jnp.asarray(vel),
                                jnp.asarray(m), JCFG))
    if mode == "float32":
        np.testing.assert_allclose(tfr, np.asarray(jfr), rtol=1e-4,
                                   atol=1e-5)
        for field in ("kinetic", "potential", "total", "radius_90"):
            np.testing.assert_allclose(getattr(tsn, field),
                                       np.asarray(getattr(jsn, field)),
                                       rtol=1e-5)
    else:
        j_drift = (float(np.asarray(jsn.total)[-1]) - je0) / abs(je0)
        t_drift = (float(tsn.total[-1]) - e0) / abs(e0)
        assert abs(t_drift - j_drift) <= max(0.1 * abs(j_drift), 5e-7)
        assert _radius90(tfr[-1]) == pytest.approx(
            _radius90(np.asarray(jfr)[-1]), rel=0.01)


def test_energy_stream_and_bounds_every_match_jax():
    """run_steps_sharded's per-chunk energies (float32, S=3), and the
    amortised bounds pass (int4, bounds_every=2, S=2) against JAX's."""
    pos, vel, m = _ics(_n(3), seed=2)
    jst = jstate.make_state(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.asarray(m))
    q32j, q32t = jp.Quantizer.from_string("float32"), tp.Quantizer()
    _, jes = jring.run_steps_sharded(jst, q32j, JCFG,
                                     jring.make_particle_mesh(3), 10,
                                     steps_per_chunk=5)
    tout, tes = ring.run_steps_sharded(make_state(pos, vel, m), q32t, CFG,
                                       _mesh(3), 10, steps_per_chunk=5)
    assert tout.positions.shape == pos.shape and tout.tick == 10
    for field in ("kinetic", "potential", "total"):
        np.testing.assert_allclose(getattr(tes, field).numpy(),
                                   np.asarray(getattr(jes, field)),
                                   rtol=1e-5)

    pos, vel, m = _ics(_n(2), seed=3)
    q4j, q4t = jp.Quantizer.from_string("int4"), tp.Quantizer.from_string(
        "int4")
    jout, jes = jring.run_steps_sharded(
        jstate.make_state(jnp.asarray(pos), jnp.asarray(vel),
                          jnp.asarray(m)), q4j, JCFG,
        jring.make_particle_mesh(2), 8, quantize_forces=True,
        steps_per_chunk=8, bounds_every=2)
    tout, tes = ring.run_steps_sharded(make_state(pos, vel, m), q4t, CFG,
                                       _mesh(2), 8, quantize_forces=True,
                                       steps_per_chunk=8, bounds_every=2)
    e0 = float(tm.total_energy(_t(pos), _t(vel), _t(m), CFG))
    j_drift = (float(np.asarray(jes.total)[-1]) - e0) / abs(e0)
    t_drift = (float(tes.total[-1]) - e0) / abs(e0)
    assert abs(t_drift - j_drift) <= max(0.1 * abs(j_drift), 5e-7)
    assert _radius90(tout.positions.numpy()) == pytest.approx(
        _radius90(np.asarray(jout.positions)), rel=0.01)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_baseline_ring_matches_jax_double_double(n_shards):
    """The native-f64 baseline ring against JAX's double-double ring: the
    entry force (a run of 0 steps), then 10 steps and their snapshots."""
    n = _n(n_shards)
    pos, vel, m = _ics(n, seed=4)
    jmesh, tmesh = jring.make_particle_mesh(n_shards), _mesh(n_shards)
    jb = jstate.make_baseline_state(jnp.asarray(pos), jnp.asarray(vel),
                                    jnp.asarray(m))
    tb = make_baseline_state(pos, vel, m)
    ja = np.asarray(jring.run_steps_sharded_baseline(jb, JCFG, jmesh,
                                                     0).accelerations)
    ta = ring.run_steps_sharded_baseline(tb, CFG, tmesh, 0).accelerations
    assert ta.dtype == torch.float64
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0,
                               atol=1e-5 * np.abs(ja).max())
    _, jsn, jfr = jring.run_with_snapshots_sharded_baseline(jb, JCFG, jmesh,
                                                            5, 2)
    tst, tsn, tfr = ring.run_with_snapshots_sharded_baseline(tb, CFG, tmesh,
                                                             5, 2)
    assert tst.positions.dtype == torch.float64
    np.testing.assert_allclose(tfr, np.asarray(jfr), rtol=1e-6, atol=1e-7)
    for field in ("kinetic", "potential", "total"):
        np.testing.assert_allclose(getattr(tsn, field),
                                   np.asarray(getattr(jsn, field)),
                                   rtol=1e-6)


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_mesh_of_one_is_the_single_device_path(mode):
    """At S=1 the sym schedule is sym_force on the whole set with the same
    bounds (the ring's pair_max pass equals the pruned pass bitwise), so
    forces and a 5-step run are bitwise the single-device ones."""
    pos, vel, m = _ics(70, seed=5)
    q = tp.Quantizer.from_string(mode)
    qf = _quantize(mode)
    got = ring.ring_accelerations(_t(pos), _t(m), q, CFG, _mesh(1),
                                  quantize_forces=qf)
    assert torch.equal(got, hn.sym_accelerations(_t(pos), _t(m), q, CFG,
                                                 quantize_forces=qf))
    st = make_state(pos, vel, m)
    out, _ = ring.run_steps_sharded(st, q, CFG, _mesh(1), 5,
                                    quantize_forces=qf)
    st = st._replace(accelerations=hn.sym_accelerations(
        st.positions, st.masses, q, CFG, quantize_forces=qf))
    want = td.run_steps(st, q, CFG, "auto", qf, 5)
    assert torch.equal(out.positions, want.positions)
    assert torch.equal(out.velocities, want.velocities)


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_budget_chunked_ring_matches_unchunked(monkeypatch, mode):
    """A scratch budget shrunk so that the diagonal blocks take the
    chunked path and the pair tiles split their sources: the same pairs
    in another order, against the unchunked ring and against JAX."""
    pos, _, m = _ics(2 * 160, seed=6)
    q = tp.Quantizer.from_string(mode)
    mesh = _mesh(2)
    want = ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh)
    calls = []
    real = hn.pair_sym_force

    def spy(pos_a, gm_a, pos_b, gm_b, bounds, q, **kw):
        calls.append((pos_a.shape[0], pos_b.shape[0]))
        return real(pos_a, gm_a, pos_b, gm_b, bounds, q, **kw)

    monkeypatch.setattr(hn, "SCRATCH_BUDGET", 4000)
    monkeypatch.setattr(hn, "pair_sym_force", spy)
    assert ring._src_chunk_size(160, 160, 2) == 64
    assert not hn.sym_force_fits(160, 2)
    got = ring.ring_accelerations(_t(pos), _t(m), q, CFG, mesh)
    # 2 diagonal blocks of 3 chunks (3 chunk pairs each) and one pair tile
    # in 3 source chunks of 64, 64 and 32
    assert sorted(calls).count((160, 64)) == 2 and (160, 32) in calls
    assert len(calls) == 2 * 3 + 3
    _hold_forces(got.numpy(), want.numpy(), pos, m, mode)
    jwant = np.asarray(jring.ring_accelerations(
        jnp.asarray(pos), jnp.asarray(m), jp.Quantizer.from_string(mode),
        JCFG, jring.make_particle_mesh(2)))
    _hold_forces(got.numpy(), jwant, pos, m, mode)


def test_source_chunks_at_1m_fit_the_budget():
    """N=1,048,576 over two shards: one 524288^2 pair tile would need
    ~35 GB of partials; the chunks fit the 16 GB budget, spread evenly."""
    b = 1_048_576 // 2
    assert hn.pair_sym_force_scratch_bytes(b, b, 2) > 30e9
    chunk = ring._src_chunk_size(b, b, 2)
    n_chunks = -(-b // chunk)
    assert chunk % hn.TILE == 0 and n_chunks == 3
    assert hn.pair_sym_force_scratch_bytes(b, chunk, 2) <= hn.SCRATCH_BUDGET
    assert b - (n_chunks - 1) * chunk > 0.9 * chunk
    assert ring._src_chunk_size(1000, 1000, 3) == 1000


def test_mesh_construction():
    assert ring.make_particle_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="asked for a mesh of 2"):
        ring.make_particle_mesh(2, "cpu")
    mesh = ring.ParticleMesh.virtual(3, "cpu")
    assert mesh.shape == {ring.AXIS: 3}
    with pytest.raises(ValueError, match="unknown schedule"):
        ring.run_steps_sharded(make_state(*_ics(20)), tp.Quantizer(), CFG,
                               mesh, 1, schedule="ring")


def test_ring_module_imports_no_jax():
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys, nbody_tpu_torch.parallel.ring; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'nbody_tpu' or "
            "m.startswith('nbody_tpu.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code],
                   cwd=Path(__file__).resolve().parent.parent, check=True,
                   timeout=120)
