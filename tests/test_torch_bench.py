"""nbody_tpu_torch.bench against the repository's root bench.py and the JAX
package's run_steps, on the CPU.

* Each arm function, given JAX's ICs at n=256 (the disk, and the Plummer
  sphere for the D=3 arms, both from PRNGKey(42)), ends at the state of
  JAX's ``run_steps`` with bench.py's arguments for that arm: float32,
  int4 and int4 with ``bounds_every=4`` at 30 steps through the tiled
  force (bench's CPU impl) and the sym kernel's plain version (its card
  impl, "kernel"), and the large arms' 5 steps through "auto", equal
  masses. Tolerance: positions and velocities within 1e-5 relative +
  1e-6 absolute, accelerations within 1e-4 relative + 1e-6 (two summation
  orders of the same float32 terms; no int4 grid step flips here).
* The timing protocol: a warm-up call and k timed calls, each from the
  same state (the arm's final state is the last call's), the Arm's
  derived numbers, no launches counted on the CPU.
* The PM arm's flow at a small engine size: the warm-up chunks, then
  each timed chunk's dispatch inside the guard, the timed chunks' steps.
* ``main(["--device", "cpu"])`` prints exactly one JSON line on stdout:
  bench.py's CPU keys plus ``device``, every number finite and > 0; the
  default device is the card, and without one it raises.
* chip_smoke.py's phase bench holds the card's line to root bench.py's 14
  keys, read from its source, and each arm's and ladder mode's launches
  to PERF.md section 2's formulas (checked here at the card's shapes);
  phase ab's turns (design_turns) time the parent design only there.
"""

import contextlib
import json
import math

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JSimConfig
from nbody_tpu.models import galaxy as jgalaxy
from nbody_tpu.models.direct import run_steps as jrun_steps
from nbody_tpu.models.state import make_state as jmake_state
from nbody_tpu.ops.precision import Precision as JPrecision
from nbody_tpu.ops.precision import Quantizer as JQuantizer
from nbody_tpu_torch import bench
from nbody_tpu_torch.models.state import make_state

torch.set_num_threads(1)

N = 256
CPU_KEYS = ("metric", "value", "unit", "vs_baseline", "int4_value",
            "int4_vs_baseline", "int4_bounds4_value")


@pytest.fixture(scope="module")
def jax_ics():
    """JAX's disk (D=2) and Plummer sphere (D=3), 256 stars, PRNGKey(42),
    as numpy."""
    out = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for dim, make in ((2, jgalaxy.create_disk_galaxy),
                          (3, jgalaxy.create_plummer_sphere)):
            out[dim] = tuple(np.asarray(x) for x in
                             make(jax.random.PRNGKey(42), num_stars=N))
    return out


def _jax_final(ics, arm, impl):
    """JAX's run_steps with bench.py's arguments for ``arm``."""
    mode = JPrecision.FLOAT32 if arm.mode == "float32" else \
        JPrecision.INT4_SIM
    return jrun_steps(jmake_state(*ics), JQuantizer(mode), JSimConfig(),
                      impl, mode != JPrecision.FLOAT32, arm.steps,
                      bounds_every=arm.bounds_every, uniform_gm=True)


def _assert_same_state(got, want):
    for field, rtol in (("positions", 1e-5), ("velocities", 1e-5),
                        ("accelerations", 1e-4)):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=rtol, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("impl", ("tiled", "kernel"))
@pytest.mark.parametrize("dim", (2, 3))
def test_arms_end_at_jax_run_steps(jax_ics, dim, impl):
    state = make_state(*jax_ics[dim], "cpu")
    arms = (bench.headline_arms if dim == 2 else bench.dim3_arms)(
        state, impl, True)
    assert [(a.name, a.bounds_every) for a, _ in arms] == (
        [("float32", 1), ("int4", 1), ("int4 bounds_every=4", 4)] if dim == 2
        else [("float32 dim3", 1), ("int4 dim3", 1)])
    for arm, final in arms:
        assert (arm.n, arm.dim, arm.steps, arm.calls) == (
            N, dim, bench.STEPS, bench.BEST_OF)
        assert final.tick == bench.STEPS
        _assert_same_state(final, _jax_final(jax_ics[dim], arm, "tiled"))


@pytest.mark.parametrize("dim", (2, 3))
def test_large_arms_end_at_jax_run_steps(jax_ics, dim):
    state = make_state(*jax_ics[dim], "cpu")
    arms = bench.large_arms(state, True, " dim3" if dim == 3 else "")
    assert [a.mode for a, _ in arms] == ["float32", "int4"]
    for arm, final in arms:
        assert (arm.steps, arm.calls) == (bench.BIG_STEPS, bench.BIG_BEST_OF)
        assert arm.name.endswith(f"N={N}")
        _assert_same_state(final, _jax_final(jax_ics[dim], arm, "auto"))


def test_measure_times_k_calls_from_one_state(monkeypatch, jax_ics):
    from nbody_tpu_torch.models import direct

    starts = []
    real = direct.run_steps.__wrapped__

    def spy(state, *a, **k):
        starts.append(state)
        return real(state, *a, **k)

    monkeypatch.setattr(direct.run_steps, "__wrapped__", spy)
    state = make_state(*jax_ics[2], "cpu")
    arm, final = bench.measure("f32", state, "float32", "tiled", 3, 4, True)
    assert len(starts) == 5 and all(s is state for s in starts)
    assert arm.launches == {} and arm.wall > 0 and final.tick == 3
    assert arm.ms_per_step == arm.wall / 3 * 1e3
    assert arm.pairs_per_sec == N * N * 3 / arm.wall


def test_best_of_keeps_the_least_wall(monkeypatch):
    walls = iter((0.03, 0.01, 0.02))
    clock = {"t": 0.0}

    def fn():
        clock["t"] += next(walls)
        return torch.zeros(1)

    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock["t"])
    wall, out = bench.best_of(3, fn)
    assert wall == pytest.approx(0.01) and torch.equal(out, torch.zeros(1))


def test_pm_arm_flow_at_a_small_size(monkeypatch):
    monkeypatch.setattr(bench, "PM_ARM", dict(bench.PM_ARM,
                                              num_particles=512, n_grid=16))
    ticks = []

    @contextlib.contextmanager
    def guard():
        ticks.append(eng_ticks())
        yield

    from nbody_tpu_torch.engines import cosmo
    engines = []
    real = cosmo.CosmologicalEngine.dispatch_step

    def dispatch(self, *a, **k):
        engines.append(self)
        return real(self, *a, **k)

    def eng_ticks():
        return engines[-1].tick if engines else None

    monkeypatch.setattr(cosmo.CosmologicalEngine, "dispatch_step", dispatch)
    eng, arm = bench.pm_arm("cpu", precision="int4", timed=3, guard=guard)
    # PM_WARM chunks by step() (each a dispatch), then 3 guarded ones
    warm = bench.PM_WARM * bench.PM_CHUNK
    assert ticks == [warm, warm + bench.PM_CHUNK, warm + 2 * bench.PM_CHUNK]
    assert eng.tick == (bench.PM_WARM + 3) * bench.PM_CHUNK
    assert (arm.n, arm.dim, arm.mode, arm.steps) == (512, 3, "int4",
                                                     3 * bench.PM_CHUNK)
    assert arm.launches == {} and arm.wall > 0
    assert np.isfinite(eng.positions.numpy()).all()


def test_main_on_the_cpu_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "CPU_N", N)
    arms = []
    result = bench.main(["--device", "cpu"], arms=arms)
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert tuple(result) == CPU_KEYS + ("device",)
    assert result["metric"] == f"pairwise_interactions_per_sec_chip_N{N}_f32"
    assert result["unit"] == "pairs/s"
    for key in CPU_KEYS:
        if key not in ("metric", "unit"):
            assert math.isfinite(result[key]) and result[key] > 0, key
    assert result["vs_baseline"] == result["value"] / 1e10
    assert result["device"] == {"platform": "cpu", "kind": "cpu",
                                "count": 1, "power_limit": None}
    assert [a.name for a in arms] == ["float32", "int4",
                                      "int4 bounds_every=4"]
    assert [a.pairs_per_sec for a in arms] == [
        result["value"], result["int4_value"], result["int4_bounds4_value"]]


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])


def test_ics_are_bench_seeds_and_equal_masses():
    state, uniform = bench.ics(2, 300, bench.SEED, "cpu")
    again, _ = bench.ics(2, 300, bench.SEED, "cpu")
    assert uniform and torch.equal(state.positions, again.positions)
    state3, uniform3 = bench.ics(3, 300, bench.BIG_SEED, "cpu")
    assert uniform3 and state3.positions.shape == (300, 3)
    assert not torch.equal(state3.positions[:, :2], state.positions)


def _root_bench_keys():
    """The keys of root bench.py's line, in its order: its first result
    dict's, then each ``result["..."] =``."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / "bench.py")
                     .read_text())
    keys = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if (isinstance(target, ast.Name) and target.id == "result"
                    and isinstance(node.value, ast.Dict)):
                keys += [(k.lineno, k.value) for k in node.value.keys]
            elif (isinstance(target, ast.Subscript)
                  and getattr(target.value, "id", None) == "result"):
                keys.append((node.lineno, target.slice.value))
    return [k for _, k in sorted(keys)]


def test_the_card_line_has_root_bench_keys():
    """chip_smoke.py's phase bench holds the card's line to root bench.py's
    14 keys; the CPU set is its first seven."""
    import chip_smoke

    keys = _root_bench_keys()
    assert tuple(keys) == chip_smoke.BENCH_KEYS and len(keys) == 14
    assert tuple(keys[:7]) == CPU_KEYS


@pytest.mark.parametrize("name,n,dim,mode,steps,calls,every,want", (
    ("float32", 131072, 2, "float32", 30, 3, 1, {"sym_force_uniform": 90}),
    ("int4", 131072, 2, "int4", 30, 3, 1,
     {"sym_force_uniform": 90, "max_d2": 180}),
    ("int4 bounds_every=4", 131072, 2, "int4", 30, 3, 4,
     {"sym_force_uniform": 90, "max_d2": 48}),
    ("int4 N=1048576", 1048576, 2, "int4", 5, 2, 1,
     {"sym_force_uniform": 50, "pair_sym_force_uniform": 100,
      "max_d2": 20}),
    ("float32 dim3 N=1048576", 1048576, 3, "float32", 5, 2, 1,
     {"sym_force_uniform": 60, "pair_sym_force_uniform": 150}),
    ("pm256 int4 engine", 262144, 3, "int4", 40, 1, 1,
     {"pm_deposit": 48, "pm_deposit_fill": 48, "pm_deposit_long": 48}),
))
def test_bench_launch_formulas_at_the_cards_shapes(name, n, dim, mode, steps,
                                                   calls, every, want):
    """chip_smoke.py's phase bench holds each arm to PERF.md section 2's
    formulas: at 131072 one launch an evaluation, at 1M C + C(C-1)/2 (5
    chunks at D=2, 6 at D=3), two max_d2 a bounds pass, the PM arm's
    deposits (the counts its card run gave)."""
    import chip_smoke

    arm = bench.Arm(name, n, dim, mode, steps, calls, 1.0, {}, every)
    assert chip_smoke.bench_arm_launches(arm) == want


@pytest.mark.parametrize("mode,want", (
    ("float32", {"sym_force_uniform": 121}),
    ("custom", {"sym_force_uniform": 121, "max_d2": 242}),
    ("float64", {}),
))
def test_ladder_launch_formula(mode, want):
    import chip_smoke

    arm = bench.Arm(mode, 131072, 3, mode, 30, 3, 1.0, {})
    assert chip_smoke.ladder_launches(arm) == want


@pytest.mark.parametrize("ab", (False, True))
def test_design_turns_time_the_parent_only_under_phase_ab(ab):
    import chip_smoke

    calls = []
    olds, news = chip_smoke.design_turns(
        lambda f: calls.append(f()) or len(calls), lambda: "old",
        lambda: "new", ab)
    if ab:
        assert calls == ["old", "new", "new", "old"]
        assert (olds, news) == ([1, 4], [2, 3])
        assert chip_smoke.mean_ms(olds) == 2.5
        assert chip_smoke.ab_text(olds, news, "a", "b", ".1f") == \
            "a 1.0 / 4.0 ms, b 2.0 / 3.0 ms (+0.00%)"
    else:
        assert calls == ["new"] and (olds, news) == ([], [1])
        assert chip_smoke.mean_ms(olds) is None
        assert chip_smoke.ab_text(olds, news, "a", "b", ".1f") == \
            "b 1.0 ms"
