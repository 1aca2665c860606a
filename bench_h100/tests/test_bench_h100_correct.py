"""The check that decides ``correct``: sound runs of the program pass;
the control (the reference in bfloat16 in the program's place) and each
planted fault of the timed path fail. On the CPU at a tiny size (the
program's plain versions); the harness's look for a card is skipped,
every other part of a run is driven. The cells run on one card, so the
fault "the exchange between chips left out" does not arise."""

import dataclasses
import functools

import pytest
import torch

from bench_h100 import control, harness
from nbody_tpu_torch.diagnostics import metrics as metrics_lib
from nbody_tpu_torch.models import direct

SMALL = {"disk2d-131k-int4": {"n": 256, "snapshot_interval": 3},
         "disk2d-131k-f32": {"n": 256, "snapshot_interval": 3,
                             "check_rows": 256},
         "plummer3d-1m-f32": {"n": 192, "snapshot_interval": 2,
                              "check_rows": 192}}
SEED = 2 ** 31 + 101


def run(workload):
    line = harness.run_cell(workload, SEED, 0, False, "cpu",
                            traffic_overrides=SMALL[workload])
    line.pop("_run")
    return line


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_runs_are_correct(workload):
    line = run(workload)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct(workload):
    line = control.run_control(workload, SEED, "cpu",
                               traffic_overrides=SMALL[workload])
    line.pop("_run")
    assert not line["correct"], line["checks"]


def _unchanged(state, *args, **kwargs):
    """A step that returns its state unchanged (but for the tick)."""
    return state._replace(tick=state.tick + 1)


def _half_sources(force_fn):
    """The force over half of the sources, the mean taken over them:
    masses of the first half doubled, of the second half dropped."""
    def wrapped(impl, n, dim=2, uniform_gm=False):
        fn = force_fn(impl, n, dim, False)

        def half(pos, masses, *args, **kwargs):
            keep = torch.zeros_like(masses)
            keep[: masses.shape[0] // 2] = 2.0
            return fn(pos, masses * keep, *args, **kwargs)
        return half
    return wrapped


def _position_altered(step):
    """One particle's position altered where a tick produces it."""
    def altered(state, *args, **kwargs):
        out = step(state, *args, **kwargs)
        pos = out.positions.clone()
        pos[pos.shape[0] // 3, 0] += 1.0
        return out._replace(positions=pos)
    return altered


def _later_dt(step):
    """A step whose dt is half again too long on every tick after the
    first of an integration: a fault that tick 1 does not show."""
    def wrong(state, q, cfg, *args, **kwargs):
        if state.tick >= 1:
            cfg = dataclasses.replace(cfg, dt=cfg.dt * 1.5)
        return step(state, q, cfg, *args, **kwargs)
    return wrong


def _handoff(run_chunks):
    """Each call's chunks start from the state with its accelerations
    zeroed: a state handed on wrong between calls."""
    def wrong(state, *args, **kwargs):
        state = state._replace(accelerations=torch.zeros_like(
            state.accelerations))
        return run_chunks(state, *args, **kwargs)
    return wrong


def _energy_altered(snapshot):
    @functools.wraps(snapshot)
    def altered(*args, **kwargs):
        snap = snapshot(*args, **kwargs)
        return snap._replace(potential=snap.potential * 1.001)
    return altered


def _plant_unchanged(mp):
    mp.setattr(direct, "leapfrog_step", _unchanged)


def _plant_half(mp):
    mp.setattr(direct, "_force_fn", _half_sources(direct._force_fn))


FAULTS = {
    "state_unchanged": _plant_unchanged,
    "half_the_sources": _plant_half,
    "position_altered": lambda mp: mp.setattr(
        direct, "leapfrog_step", _position_altered(direct.leapfrog_step)),
    "later_dt": lambda mp: mp.setattr(
        direct, "leapfrog_step", _later_dt(direct.leapfrog_step)),
    "handoff": lambda mp: mp.setattr(
        direct, "_run_chunks", _handoff(direct._run_chunks)),
    "energy_altered": lambda mp: mp.setattr(
        metrics_lib, "snapshot", _energy_altered(metrics_lib.snapshot)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["disk2d-131k-int4", "disk2d-131k-f32"])
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = run(workload)
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.gpu
def test_a_cell_is_correct_on_the_card():
    """A short run of the int4 cell's path at 16384 stars on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line = harness.run_cell("disk2d-131k-int4", SEED, 0, False, "cuda",
                            traffic_overrides={"n": 16384,
                                               "snapshot_interval": 5})
    line.pop("_run")
    assert line["correct"], line["checks"]
