"""nbody_tpu_torch.experiments.omniverse_tests against
nbody_tpu.experiments.omniverse_tests, on the CPU.

* The LSTM on parameters carried across from JAX's ``_lstm_init`` (numpy):
  ``_lstm_apply``'s logits on a batch of sequences, and one SGD step's
  updated parameters against ``jax.grad`` of JAX's loss, at float32 rtol
  1e-5 (atol 1e-6 for the step: the biases start at 0); the whole bridge
  from the carried parameters gives JAX's predictions (accuracy,
  precision, recall and F1 equal).
* The fluid cloud from JAX's Gaussian draw (fed through
  ``cloud_positions``): the same ICs at rtol 1e-6, final positions at
  rtol 1e-4 / atol 1e-5 (tests/test_torch_direct.py's float32 rule) and
  the report equal; the mirror (no random draw) and the voxel grid (JAX's
  disks fed through ``create_disk_galaxy``) against JAX: statuses and
  breakdown depth equal, voxel drifts within 1e-6 (drifts of ~1e-6 from
  float32 energies of rtol 1e-5 relative to each other's scale).
* tests/test_experiments_smoke.py's neural-bridge case on the port, and
  ``main --quick`` on the CPU at a reduced size (``suite_sizes`` patched):
  JAX's report keys; ``run_omniverse_suite`` without a card raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.experiments import omniverse_tests as jo
from nbody_tpu.models import galaxy as jg
from nbody_tpu_torch.experiments import omniverse_tests as to

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def carried():
    """JAX's LSTM parameters (input 1, hidden 16, output 1) as numpy."""
    return {k: np.array(v) for k, v in jo._lstm_init(
        jax.random.PRNGKey(3), 1, 16, 1).items()}


def _batch(n: int, seed: int):
    X, y = to.glitch_sequences(n, 32, seed)
    return X[..., None], y


def test_lstm_init_layout(carried):
    got = to._lstm_init(torch.Generator().manual_seed(3), 1, 16, 1)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in carried.items()}
    assert not got["b"].any() and not got["bo"].any()


def test_lstm_apply_matches_jax(carried):
    X, _ = _batch(24, 1)
    want = np.asarray(jax.vmap(lambda s: jo._lstm_apply(
        {k: jnp.asarray(v) for k, v in carried.items()}, s))(X))
    params = {k: torch.from_numpy(v) for k, v in carried.items()}
    got = to._lstm_apply(params, torch.from_numpy(X)).numpy()
    assert got.shape == (24,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    one = to._lstm_apply(params, torch.from_numpy(X[0])).numpy()
    np.testing.assert_allclose(one, want[0], rtol=1e-5)


def test_sgd_step_matches_jax_grad(carried):
    X, y = _batch(40, 2)
    jp = {k: jnp.asarray(v) for k, v in carried.items()}

    def loss_fn(params, xb, yb):
        logits = jax.vmap(lambda s: jo._lstm_apply(params, s))(xb)
        return jnp.mean(jax.nn.softplus(logits) - yb * logits)

    g = jax.grad(loss_fn)(jp, X, y)
    want = jax.tree.map(lambda p, gg: p - to.LSTM_LR * gg, jp, g)
    got = to._sgd_step({k: torch.from_numpy(v) for k, v in carried.items()},
                       torch.from_numpy(X), torch.from_numpy(y), to.LSTM_LR)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    loss = float(to._lstm_loss({k: torch.from_numpy(v)
                                for k, v in carried.items()},
                               torch.from_numpy(X), torch.from_numpy(y)))
    assert loss == pytest.approx(float(loss_fn(jp, X, y)), rel=1e-5)


def test_neural_bridge_matches_jax(carried, monkeypatch):
    monkeypatch.setattr(jo, "_lstm_init", lambda *a: {
        k: jnp.asarray(v) for k, v in carried.items()})
    monkeypatch.setattr(to, "_lstm_init", lambda *a, **kw: {
        k: torch.from_numpy(v.copy()) for k, v in carried.items()})
    want = jo.neural_hardware_bridge(num_sequences=100, epochs=5, seed=1)
    got = to.neural_hardware_bridge(num_sequences=100, epochs=5, seed=1,
                                    device="cpu")
    assert got == want


def test_omniverse_neural_bridge_smoke():
    """tests/test_experiments_smoke.py's neural-bridge case on the port."""
    rep = to.neural_hardware_bridge(num_sequences=120, epochs=8, seed=0,
                                    device="cpu")
    assert rep["accuracy"] > 0.6  # pattern is learnable even tiny


def _jax_cloud(monkeypatch, n: int, seed: int):
    draw = np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, 2)))
    monkeypatch.setattr(to, "cloud_positions",
                        lambda gen, k: torch.from_numpy(draw[:k] * 5.0))
    return draw


class _Recorder:
    """Record every DirectSimulation a module makes."""

    def __init__(self, monkeypatch, module):
        self.sims = []
        base = module.DirectSimulation
        sims = self.sims

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                sims.append(self)

        monkeypatch.setattr(module, "DirectSimulation", Recorded)


def test_fluid_chaos_matches_jax(monkeypatch):
    n, ticks = 255, 20
    _jax_cloud(monkeypatch, n, 4)
    jrec, trec = _Recorder(monkeypatch, jo), _Recorder(monkeypatch, to)
    want = jo.fluid_dynamics_chaos(n, ticks, seed=4)
    got = to.fluid_dynamics_chaos(n, ticks, seed=4, device="cpu")
    assert got == want
    jsim, tsim = jrec.sims[0], trec.sims[0]
    assert tsim.positions.shape == (n + 1, 2)
    assert tsim.masses[0] == to.CENTRAL_MASS and not tsim._uniform_gm
    np.testing.assert_allclose(tsim.positions.numpy(),
                               np.asarray(jsim.positions), rtol=1e-4,
                               atol=1e-5)


def test_fluid_initial_conditions_equal_jax(monkeypatch):
    n = 100
    _jax_cloud(monkeypatch, n, 5)
    jrec = _Recorder(monkeypatch, jo)
    # JAX's ICs, read off its engine's state at tick 0
    monkeypatch.setattr(jo.DirectSimulation, "step", lambda self, k=1: None)
    jo.fluid_dynamics_chaos(n, 0, seed=5)
    pos, vel, m = to.fluid_initial_conditions(n, 5)
    jsim = jrec.sims[0]
    np.testing.assert_allclose(pos.numpy(), np.asarray(jsim.positions),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jsim.velocities),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jsim.masses))


def test_recursive_mirror_matches_jax():
    want = jo.recursive_physics_mirror(max_depth=30)
    got = to.recursive_physics_mirror(max_depth=30, device="cpu")
    assert got["breakdown_depth"] == want["breakdown_depth"]
    assert ([(r["depth"], r["radius"], r["status"]) for r in got["results"]]
            == [(r["depth"], r["radius"], r["status"])
                for r in want["results"]])


def test_voxel_grid_matches_jax(monkeypatch):
    def jax_disk(key, n, **kw):
        return jg.create_disk_galaxy(key, n, **kw)

    draws = {}

    def port_disk(gen, n, **kw):
        seed = gen.initial_seed()
        if seed not in draws:
            draws[seed] = [np.array(a) for a in jax_disk(
                jax.random.PRNGKey(seed), n, **kw)]
        return tuple(torch.from_numpy(a.copy()) for a in draws[seed])

    monkeypatch.setattr(to, "create_disk_galaxy", port_disk)
    want = jo.voxel_spacetime_grid(grid_side=2, num_ticks=20, seed=9)
    got = to.voxel_spacetime_grid(grid_side=2, num_ticks=20, seed=9,
                                  device="cpu")
    assert sorted(draws) == [9, 10, 11, 12]
    np.testing.assert_allclose(got["drift_map"], want["drift_map"], rtol=0,
                               atol=1e-6)
    assert got["space_is_uniform"] == want["space_is_uniform"]
    assert set(got) == set(want)


SMALL = {"mirror_depth": 15, "fluid_particles": 200, "fluid_ticks": 10,
         "sequences": 60, "epochs": 3, "voxel_side": 2, "voxel_ticks": 10}


def test_main_quick_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(to, "suite_sizes", lambda quick: dict(SMALL))
    rep = to.main(["--quick", "--device", "cpu", "--output", str(tmp_path)])
    saved = json.loads((tmp_path / "omniverse_report.json").read_text())
    assert set(saved) == {"recursive_mirror", "fluid_chaos",
                          "neural_bridge", "voxel_grid", "suite_score"}
    assert set(saved["fluid_chaos"]) == {"deleted", "escaped", "merged",
                                         "lod_cheating_detected"}
    assert saved["fluid_chaos"]["deleted"] == 0
    assert rep["suite_score"]["positive_probes"] in range(5)


def test_suite_sizes_are_jax_defaults():
    assert to.suite_sizes(False) == {
        "mirror_depth": 60, "fluid_particles": 20000, "fluid_ticks": 200,
        "sequences": 400, "epochs": 20, "voxel_side": 4, "voxel_ticks": 100}
    assert to.suite_sizes(True)["fluid_particles"] == 5000


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_suite_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to.main(["--quick", "--output", str(tmp_path)])
    assert not any(tmp_path.iterdir())
