"""nbody_tpu_torch.diagnostics.glitch and .native against nbody_tpu's, on CPU.

Device metrics: the subnormal census counts planted subnormals and zeros
as IEEE float32 holds them (JAX on the CPU flushes subnormals, so its
count is held only where there are none); the exploit metrics at
rtol 1e-5 (their counts equal). Host
detectors: the same events from the same histories. The native loader:
``byte_entropy`` / ``float_census`` through the port's compiled copy of
fastent.c and through its numpy fallback agree, and with JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import native as jnative
from nbody_tpu.diagnostics import glitch as jg
from nbody_tpu_torch import native as tnative
from nbody_tpu_torch.diagnostics import glitch as tg

torch.set_num_threads(1)


def test_count_subnormals_counts_planted_values():
    """Planted subnormals and zeros: the port counts what IEEE float32
    holds (the native census's count). XLA:CPU runs with denormals flushed
    to zero, so JAX on the CPU counts the planted subnormals as zeros, as
    the TPU does; the port keeps them, on the CPU and on the card (torch's
    CUDA elementwise kernels do not flush). Without subnormals the two
    agree."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((500, 3)).astype(np.float32)
    flat = x.reshape(-1)
    flat[:7] = np.float32(1e-40)           # subnormal
    flat[7:10] = -np.float32(3e-42)        # negative subnormals
    flat[10:15] = 0.0
    flat[15] = -0.0
    flat[16] = np.float32(1.1754944e-38)   # the smallest normal
    got = tg.count_subnormals(torch.from_numpy(x))
    _, _, sub, zero, min_nonzero = tnative.float_census_numpy(x.tobytes())
    assert int(got.subnormal_count) == sub == 10
    assert int(got.zero_count) == zero == 6
    assert got.subnormal_count.dtype == torch.int32
    assert float(got.min_nonzero) == min_nonzero
    flushed = jg.count_subnormals(jnp.asarray(x))
    assert int(flushed.subnormal_count) == 0
    assert int(flushed.zero_count) == sub + zero

    flat[:10] = np.float32(2.5)            # no subnormal left
    want = jg.count_subnormals(jnp.asarray(x))
    got = tg.count_subnormals(torch.from_numpy(x))
    for name in tg.SubnormalMetrics._fields:
        assert float(getattr(got, name)) == float(getattr(want, name)), name
    none = tg.count_subnormals(torch.ones(10))
    assert int(none.subnormal_count) == 0 and int(none.zero_count) == 0


@pytest.mark.parametrize("dim", [2, 3])
def test_exploit_device_metrics_match_jax(dim):
    rng = np.random.default_rng(dim)
    n = 2000
    pos = rng.uniform(0, 200, (n, dim)).astype(np.float32)
    prev = (pos + rng.standard_normal((n, dim)) * 0.1).astype(np.float32)
    vel = (rng.standard_normal((n, dim)) * 150.0).astype(np.float32)
    vel[:20] *= 4.0                        # some near c (306.6)
    obs_pos = np.full(dim, 100.0, np.float32)
    obs_dir = np.zeros(dim, np.float32)
    obs_dir[0] = 1.0
    want = jg.exploit_device_metrics(*map(jnp.asarray, (pos, vel, prev,
                                                        obs_pos, obs_dir)))
    got = tg.exploit_device_metrics(*map(torch.from_numpy,
                                         (pos, vel, prev, obs_pos, obs_dir)))
    for name in tg.ExploitDeviceMetrics._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if w.dtype.kind == "i":
            assert int(g) == int(w), name
            assert g.dtype == torch.int32, name
        else:
            assert float(g) == pytest.approx(float(w), rel=1e-5), name
    assert int(got.near_c_09) > 0 and int(got.snap_events) > 0


def _series(seed):
    rng = np.random.default_rng(seed)
    energy = list(np.cumprod(1 + rng.choice([0.0, 0.01, 0.2], 40)) * 1e30)
    momentum = [tuple(rng.standard_normal(2) * 60) for _ in range(40)]
    subs = [int(x) for x in rng.choice([0, 0, 0, 3], 40)]
    entropy = list(1.5 + rng.choice([0.0, 0.01, 0.5], 12))
    return energy, momentum, subs, entropy


@pytest.mark.parametrize("seed", [0, 1])
def test_glitch_detector_same_events(seed):
    energy, momentum, subs, entropy = _series(seed)
    dets = (jg.GlitchDetector(0.05), tg.GlitchDetector(0.05))
    for det, lib in zip(dets, (jg, tg)):
        for i, (e, p, s) in enumerate(zip(energy, momentum, subs)):
            det.check_energy_conservation(e, i, 50.0 - i)
            det.check_momentum(p, i, 50.0 - i)
            det.check_subnormals(lib.SubnormalMetrics(s, 0, 1e-40), i,
                                 50.0 - i)
        for i, c in enumerate(entropy):
            det.check_entropy(c, 10 * i, 40.0 - i)
    j, t = dets
    assert [dataclasses.asdict(e) for e in t.events] == \
        [dataclasses.asdict(e) for e in j.events]
    assert t.get_glitch_summary() == j.get_glitch_summary()
    assert len(t.events) > 5


def test_exploit_engine_finish_probes_match_jax():
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 200, (3000, 2)).astype(np.float32)
    vel = (rng.standard_normal((3000, 2)) * 50).astype(np.float32)
    engines = (jg.PhysicsExploitEngine(), tg.PhysicsExploitEngine())
    dm = dict(max_gamma=1.2, near_c_09=3, near_c_099=0, v_mean=40.0,
              v_std=80.0, in_frustum=700, snap_events=45)
    out = [e.finish_probes(lib.ExploitDeviceMetrics(**dm), pos, vel, 150.0,
                           1e-3)
           for e, lib in zip(engines, (jg, tg))]
    for k in out[0]:
        assert dataclasses.asdict(out[1][k]) == dataclasses.asdict(out[0][k])
    assert engines[1].exploit_events == engines[0].exploit_events
    # the device half through probe_inputs / run_all_probes, both engines
    res = [e.run_all_probes(p, v) for e, p, v in (
        (jg.PhysicsExploitEngine(), jnp.asarray(pos), jnp.asarray(vel)),
        (tg.PhysicsExploitEngine(), torch.from_numpy(pos),
         torch.from_numpy(vel)))]
    assert res[1]["frustum"].in_frustum_count == \
        res[0]["frustum"].in_frustum_count
    assert res[1]["relativity"].max_gamma == pytest.approx(
        res[0]["relativity"].max_gamma, rel=1e-6)


@pytest.mark.parametrize("n", [0, 11, 300_000])
def test_native_loader_and_numpy_fallback_agree(n):
    rng = np.random.default_rng(n)
    buf = rng.standard_normal(n // 4 + 1).astype(np.float32).tobytes()[:n]
    assert tnative.route() in ("native", "numpy")
    got = tnative.byte_entropy(buf)
    fallback = tnative.byte_entropy_numpy(buf)
    assert got[1] == fallback[1]
    assert got[0] == pytest.approx(fallback[0], rel=1e-12, abs=1e-15)
    assert got[0] == pytest.approx(jnative.byte_entropy(buf)[0], rel=1e-12,
                                   abs=1e-15)
    floats = rng.standard_normal(64).astype(np.float32)
    floats[:3] = [np.float32(1e-40), 0.0, np.inf]
    floats[3] = np.nan
    fb = floats.tobytes()
    assert tnative.float_census(fb) == tnative.float_census_numpy(fb) == \
        jnative.float_census(fb)


def test_host_entropy_probes_match_jax():
    rng = np.random.default_rng(5)
    for n in (500, 30_000):
        pos = rng.uniform(0, 200, (n, 2)).astype(np.float32)
        vel = rng.standard_normal((n, 2)).astype(np.float32)
        assert tg.measure_state_entropy(pos, vel) == \
            jg.measure_state_entropy(pos, vel)
        t = tg.fast_state_entropy(torch.from_numpy(pos), vel)
        j = jg.fast_state_entropy(pos, vel)
        assert t.raw_bytes == j.raw_bytes
        assert t.compression_ratio == pytest.approx(j.compression_ratio,
                                                    rel=1e-12)
        assert tg.information_bits(pos, vel) == pytest.approx(
            jg.information_bits(pos, vel), abs=1)
