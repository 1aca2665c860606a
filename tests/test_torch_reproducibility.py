"""nbody_tpu_torch.utils.reproducibility and utils.profiler against the JAX
package's, on the CPU.

* ``hash_state`` of a port tensor equals JAX's ``hash_state`` of the same
  float32 bits (3 seeds, D = 2 and 3), and a tensor of another dtype is
  hashed through float32 as JAX hashes it.
* The JAX cases of tests/test_diagnostics_utils.py (manifest, hash
  sensitivity, ``run_with_confidence``, the profiler's basics) on the port.
* ``get_device_state()`` on the CPU gives memory None; ``TraceCapture``
  writes a Chrome trace.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import galaxy as jg
from nbody_tpu.utils import reproducibility as JR
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.utils import profiler as TP
from nbody_tpu_torch.utils import reproducibility as TR

torch.set_num_threads(1)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_hash_state_equals_jax_on_the_same_bits(seed, dim):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(257, dim)).astype(np.float32) * 50
    vel = rng.normal(size=(257, dim)).astype(np.float32)
    want = JR.hash_state(jnp.asarray(pos), jnp.asarray(vel))
    got = TR.hash_state(torch.from_numpy(pos), torch.from_numpy(vel))
    assert got == want == TR.hash_tensor_state(pos, vel)
    assert len(got) == 16
    # float64 tensors hash through float32, as JAX's np.asarray(x, f32)
    assert TR.hash_state(torch.from_numpy(pos).double(),
                         torch.from_numpy(vel).double()) == want


def test_reproducibility_manifest(tmp_path):
    pos, vel, m = create_disk_galaxy(TR.seed_key(0), 64)
    cfg = TR.ExperimentConfig("test", "float32", 64, 100, 42, 0.01, 0.1,
                              0.001)
    man = TR.create_manifest(cfg, pos, vel, pos, vel)
    assert len(man.initial_state_hash) == 16
    assert man.initial_state_hash == man.results_hash
    path = tmp_path / "manifest.json"
    TR.save_manifest(man, str(path))
    loaded = json.loads(path.read_text())
    assert loaded["config"]["num_stars"] == 64
    assert loaded["hardware"]["platform"] == "cpu"
    assert loaded["hardware"]["num_devices"] == 1
    assert loaded["software"]["torch_version"] == torch.__version__
    assert loaded["software"]["backend"] == "cpu"
    # the fields the JAX manifest does not rename keep its names
    jax_sw = {f.name for f in dataclasses.fields(JR.SoftwareManifest)}
    ours = {f.name for f in dataclasses.fields(TR.SoftwareManifest)}
    assert jax_sw - ours == {"jax_version", "jaxlib_backend"}
    assert ours - jax_sw == {"torch_version", "cuda_version", "backend"}
    assert [f.name for f in dataclasses.fields(TR.HardwareManifest)] == \
        [f.name for f in dataclasses.fields(JR.HardwareManifest)]
    assert [f.name for f in dataclasses.fields(TR.DeviceState)] == \
        [f.name for f in dataclasses.fields(JR.DeviceState)]
    TR.print_manifest(man)


def test_hash_state_sensitivity():
    pos, vel, _ = create_disk_galaxy(TR.seed_key(0), 64)
    h1 = TR.hash_state(pos, vel)
    assert h1 == TR.hash_state(pos, vel)
    assert h1 != TR.hash_state(pos.numpy() + 1e-6, vel)
    # the JAX disk's bits hash alike in both packages
    jpos, jvel, _ = jg.create_disk_galaxy(jax.random.PRNGKey(0), 64)
    assert TR.hash_state(torch.from_numpy(np.array(jpos)),
                         torch.from_numpy(np.array(jvel))) == \
        JR.hash_state(jpos, jvel)


def test_seed_key_is_a_cpu_generator_and_set_all_seeds_pins_torch():
    a, b = TR.seed_key(5), TR.seed_key(5)
    assert a.device.type == "cpu"
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    TR.set_all_seeds(3)
    x = (np.random.rand(), torch.rand(2))
    TR.set_all_seeds(3)
    assert x[0] == np.random.rand() and torch.equal(x[1], torch.rand(2))


def test_run_with_confidence():
    res = TR.run_with_confidence(lambda seed: float(seed % 3), n_seeds=6,
                                 base_seed=0, metric_name="m")
    want = JR.run_with_confidence(lambda seed: float(seed % 3), n_seeds=6,
                                  base_seed=0, metric_name="m")
    assert res.n_samples == 6
    assert res.ci_95_low <= res.mean <= res.ci_95_high
    assert dataclasses.asdict(res) == dataclasses.asdict(want)


def test_device_state_on_the_cpu():
    s = TR.get_device_state()
    assert (s.device_kind, s.memory_used_mb, s.memory_total_mb) == \
        ("cpu", None, None)
    assert s.power_draw_watts is None and s.clock_speed_mhz is None
    assert TR.get_device_state("cpu") == s


def test_profiler_basics(tmp_path):
    prof = TP.DeviceProfiler(sample_interval_ms=20)
    prof.start()
    try:
        x = torch.ones((256, 256))
        for _ in range(3):
            prof.time_step(lambda: (x @ x).sum())
        time.sleep(0.1)
    finally:
        prof.stop()
    assert prof._thread is None
    a = prof.analyze()
    assert a.step_count == 3
    assert a.mean_step_ms is not None and a.mean_step_ms > 0
    assert "power_watts" in a.unavailable_channels
    assert "device_memory" in a.unavailable_channels  # the CPU has none
    assert a.num_samples >= 1
    prof.print_report()
    prof.save_samples(str(tmp_path / "samples.json"))
    saved = json.loads((tmp_path / "samples.json").read_text())
    assert len(saved["step_times_ms"]) == 3
    TP.compare_experiments({"a": prof})


def test_instrumentation_overhead_runs():
    res = TP.measure_instrumentation_overhead(
        lambda: torch.ones(64, 64).sum(), sample_interval_ms=5, repeats=2)
    assert res["baseline_s"] > 0 and res["instrumented_s"] > 0
    assert set(res) == {"baseline_s", "instrumented_s", "overhead_percent"}


def test_trace_capture_writes_a_trace(tmp_path):
    with TP.TraceCapture(str(tmp_path / "trace")) as tc:
        torch.ones(32, 32).matmul(torch.ones(32, 32)).sum()
    assert tc.path is not None and tc.path.parent == tmp_path / "trace"
    trace = json.loads(tc.path.read_text())
    assert trace["traceEvents"]
