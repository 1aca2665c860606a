"""The fused max (``emit_max``) and the speculate-and-verify int bounds
(``bounds_mode='cached'``) of nbody_tpu_torch against nbody_tpu's, on the CPU.

The port's cached-bounds stepper and its kernel's fused max (their plain
versions here) against JAX's ``_cached_bounds_scan`` and
``pallas_accelerations_sym(emit_max=True)`` in Pallas interpret mode, the
counterparts of tests/test_bounds_opt.py:87-175. Inputs: the JAX package's
disk ICs as numpy, handed to both packages.

Tolerances: the fused max bitwise the plain max pass and JAX's
pallas_max_dist_sq on these inputs; forces with the fused max bitwise those
without it; cached-bounds positions against JAX's within rtol = atol =
5e-3 (tests/test_bounds_opt.py:138-140: int4 bin flips between XLA's and
torch's log move single pairs); the violation count exact; the grid's hi
never below a tick's log max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.models import direct as jd
from nbody_tpu.models import galaxy as jg
from nbody_tpu.models import state as jstate
from nbody_tpu.ops import precision as jp
from nbody_tpu.ops.pallas_nbody import (pallas_accelerations_sym,
                                        pallas_max_dist_sq)
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models import direct as td
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

CFG, JCFG = SimConfig(), JaxConfig()
INT4 = tp.Quantizer.from_string("int4")
STEPS = 10


def _disk(seed, n):
    pos, vel, m = jg.create_disk_galaxy(jax.random.PRNGKey(seed),
                                        num_stars=n)
    return tuple(np.asarray(a) for a in (pos, vel, m))


def _t(a):
    return torch.from_numpy(np.array(a))


def _state(ics):
    return make_state(*(_t(a) for a in ics), "cpu")


def _reset():
    td.CACHED_BOUNDS_STATS.clear()
    hn.REDO_LAUNCHES.clear()


@pytest.mark.parametrize("n,uniform", [(300, False), (320, True)])
def test_emit_max_matches_the_max_pass_and_keeps_the_forces(n, uniform):
    """tests/test_bounds_opt.py:87-106 at N=300 int4 (the general kernel),
    and at N=320 through the equal-mass variant."""
    pos, _, m = _disk(2, n)
    max_d2 = pallas_max_dist_sq(jnp.asarray(pos), JCFG)
    lo, hi = tp.dist_sq_log_bounds(INT4, hn.max_d2_plain(_t(pos))
                                   + CFG.softening_sq, CFG.softening_sq)
    plain = hn.sym_accelerations(_t(pos), _t(m), INT4, CFG, log_lo=lo,
                                 log_hi=hi, uniform_gm=uniform)
    fused, fused_max = hn.sym_accelerations(_t(pos), _t(m), INT4, CFG,
                                            log_lo=lo, log_hi=hi,
                                            uniform_gm=uniform,
                                            emit_max=True)
    assert torch.equal(plain, fused)
    assert torch.equal(fused_max,
                       hn.max_d2_plain(_t(pos)) + CFG.softening_sq)
    assert float(fused_max) == float(max_d2)
    # and JAX's own fused max is the same value
    _, jmax = pallas_accelerations_sym(
        jnp.asarray(pos), jnp.asarray(m), jp.Quantizer.from_string("int4"),
        JCFG, block=128, log_lo=jnp.float32(lo), log_hi=jnp.float32(hi),
        emit_max=True)
    assert float(jmax) == float(max_d2)


def test_emit_max_requires_int_and_bounds():
    pos, _, m = _disk(3, 128)
    with pytest.raises(ValueError, match="int-sim"):
        hn.sym_accelerations(_t(pos), _t(m), tp.Quantizer(), CFG,
                             emit_max=True)
    with pytest.raises(ValueError, match="log_lo/log_hi"):
        hn.sym_accelerations(_t(pos), _t(m), INT4, CFG, emit_max=True)


def test_skip_flag_and_redo_counter_on_the_cpu():
    """A skipped launch gives zeros and a zero max and is not counted; a
    launch that runs is, in the device counter the cached scan reads."""
    pos, _, m = _disk(3, 128)
    p, gm = _t(pos), CFG.G * _t(m)
    bounds = hn.kernel_bounds(p, INT4, CFG)
    one = torch.ones((), dtype=torch.int32)
    _reset()
    mx = torch.empty(())
    out = hn.sym_force(p, gm, bounds, INT4, False, max_out=mx, skip=one,
                       count=hn.redo_counter(p.device))
    assert not out.any() and float(mx) == 0.0
    assert hn.redo_launches("cpu") == 0
    ran = hn.sym_force(p, gm, bounds, INT4, False, skip=one * 0,
                       count=hn.redo_counter(p.device))
    assert hn.redo_launches("cpu") == 1
    assert torch.equal(ran, hn.sym_force(p, gm, bounds, INT4, False))


def _jax_cached(ics, steps=STEPS, headroom=0.05):
    """JAX's cached-bounds scan, with its carry's hi after every step and
    its violation count."""
    st = jstate.make_state(*(jnp.asarray(a) for a in ics))
    q = jp.Quantizer.from_string("int4")
    body, carry0 = jd._cached_bounds_scan(q, JCFG, "pallas", True,
                                          ics[0].shape[0], ics[0].shape[1],
                                          headroom)

    def step(carry, _):
        carry, _ = body(carry, None)
        return carry, carry[1]

    (s, _, nviol), his = jax.lax.scan(step, carry0(st), None, length=steps)
    return np.asarray(s.positions), int(nviol), np.asarray(his)


@pytest.mark.parametrize("uniform", [False, True])
def test_cached_bounds_matches_jax(uniform):
    """tests/test_bounds_opt.py:122-141: N=192, 10 int4 steps. The same
    number of violations, positions within the chaos envelope, and no tick
    whose grid hi falls below its log max. At N=192 JAX pads its
    equal-mass call and takes the general kernel; the port's full tile
    (192 = 3 x 64) takes the variant: the same function."""
    ics = _disk(4, 192)
    jpos, jviol, jhis = _jax_cached(ics)
    _reset()
    stepper = td.CachedBoundsStepper(INT4, CFG, "kernel", True, 192, 2,
                                     0.05, uniform_gm=uniform)
    state, his = _state(ics), []
    for _ in range(STEPS):
        state = stepper(state)
        assert float(stepper.hi) >= float(stepper.log_max)
        his.append(float(stepper.hi))
    violations, clipped = td.cached_bounds_stats("cpu")
    assert violations == jviol and clipped == 0
    assert hn.redo_launches("cpu") == violations
    np.testing.assert_allclose(state.positions.numpy(), jpos, rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(his, jhis, rtol=1e-5)
    # run_steps is the same loop
    again = td.run_steps(_state(ics), INT4, CFG, "kernel", True, STEPS,
                         uniform_gm=uniform, bounds_mode="cached")
    assert torch.equal(again.positions, state.positions)


def test_cached_bounds_tracks_exact_and_skips_the_max_pass(monkeypatch):
    """Against the port's own exact path: within the same envelope, and
    the cached scan never calls the max pass."""
    ics = _disk(4, 192)
    exact = td.run_steps(_state(ics), INT4, CFG, "kernel", True, STEPS)
    calls = []
    real = hn.max_pairwise_dist_sq_pruned
    monkeypatch.setattr(hn, "max_pairwise_dist_sq_pruned",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cached = td.run_steps(_state(ics), INT4, CFG, "kernel", True, STEPS,
                          bounds_mode="cached")
    assert not calls
    np.testing.assert_allclose(cached.positions.numpy(),
                               exact.positions.numpy(), rtol=5e-3,
                               atol=5e-3)


def test_cached_bounds_guards():
    """tests/test_bounds_opt.py:143-158, on both runners."""
    st = _state(_disk(5, 64))
    for run in (lambda **k: td.run_steps(st, k.pop("q"), CFG, k.pop("impl"),
                                         True, 2, **k),
                lambda **k: td.run_with_snapshots(st, k.pop("q"), CFG,
                                                  k.pop("impl"), True, 1, 2,
                                                  **k)):
        with pytest.raises(ValueError, match="int-sim"):
            run(q=tp.Quantizer(), impl="kernel", bounds_mode="cached")
        with pytest.raises(ValueError, match="cached"):
            run(q=INT4, impl="dense", bounds_mode="cached")
        with pytest.raises(ValueError, match="cached"):
            run(q=INT4, impl="kernel_sym_chunked", bounds_mode="cached")
        with pytest.raises(ValueError, match="unknown bounds_mode"):
            run(q=INT4, impl="kernel", bounds_mode="lazy")
    with pytest.raises(ValueError, match="mutually exclusive"):
        td.run_steps(st, INT4, CFG, "kernel", True, 2, bounds_mode="cached",
                     bounds_every=4)


@pytest.mark.parametrize("uniform", [False, True])
def test_cached_bounds_snapshots_path(uniform):
    """tests/test_bounds_opt.py:161-175, against JAX's snapshots run, and
    the cache carried across snapshot chunks: the same bits as run_steps."""
    ics = _disk(6, 192)
    q = jp.Quantizer.from_string("int4")
    _, jsnaps, jframes = jd.run_with_snapshots(
        jstate.make_state(*(jnp.asarray(a) for a in ics)), q, JCFG, "pallas",
        True, steps_per_chunk=3, num_chunks=2, bounds_mode="cached")
    state, snaps, frames = td.run_with_snapshots(
        _state(ics), INT4, CFG, "kernel", True, steps_per_chunk=3,
        num_chunks=2, uniform_gm=uniform, bounds_mode="cached")
    assert frames.shape == (2, 192, 2) and np.isfinite(frames).all()
    np.testing.assert_allclose(frames, np.asarray(jframes), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_array_equal(snaps.tick, np.asarray(jsnaps.tick))
    steps = td.run_steps(_state(ics), INT4, CFG, "kernel", True, 6,
                         uniform_gm=uniform, bounds_mode="cached")
    assert torch.equal(steps.positions, state.positions)
