"""nbody_tpu_torch.ladder_bench against tools/ladder_bench.py, on the CPU.

* Both ``main``s at 256 stars (``--steps 2 --best-of 1``, with and
  without ``--f64-steps``, D=2 and D=3, all seven modes and a subset)
  give rows with the same keys, modes, dims, n and steps: float64's steps
  max(2, steps // 10) or ``--f64-steps``.
* Each row's numbers are its best wall's: pairs_per_sec = n^2 x steps /
  wall and ms_per_step = wall / steps x 1e3 (the mode's record through
  ``main(..., arms=)``), finite and > 0; no launch is counted on the CPU.
* The protocol: a set-up, a warm-up call and k timed calls of ``steps``,
  on the impl asked for; n capped at 2048 on the CPU; ``--output``
  writes the printed report; the default device is the card.
"""

import contextlib
import io
import json
import math

import pytest
import torch

from nbody_tpu_torch import ladder_bench
from nbody_tpu_torch.models import direct
from tools import ladder_bench as jladder

torch.set_num_threads(1)

ROW_KEYS = ("mode", "dim", "n", "steps", "ms_per_step", "pairs_per_sec")
SHAPE_KEYS = ("mode", "dim", "n", "steps")


def _jax_rows(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jladder.main(argv)
    return json.loads(out.getvalue().splitlines()[-1])["rows"]


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("extra", ([], ["--f64-steps", "3"],
                                   ["--steps", "30", "--modes",
                                    "float32,f64,int4"]))
def test_rows_match_the_tools(dim, extra, capsys):
    argv = ["--n", "256", "--steps", "2", "--best-of", "1", "--dim",
            str(dim), *extra]
    want = _jax_rows(argv)
    arms = []
    report = ladder_bench.main([*argv, "--device", "cpu"], arms=arms)
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[-1]) == report
    assert set(report) == {"device", "impl", "rows"}
    assert report["impl"] == "auto" and report["device"]["platform"] == "cpu"
    rows = report["rows"]
    assert [tuple(r) for r in rows] == [ROW_KEYS] * len(rows)
    assert [tuple(r[k] for k in SHAPE_KEYS) for r in rows] == \
        [tuple(r[k] for k in SHAPE_KEYS) for r in want]
    for row, arm in zip(rows, arms, strict=True):
        n, steps = row["n"], row["steps"]
        assert (arm.mode, arm.n, arm.dim, arm.steps) == (
            row["mode"], n, dim, steps)
        assert row["pairs_per_sec"] == n * n * steps / arm.wall
        assert row["ms_per_step"] == arm.wall / steps * 1e3
        assert math.isfinite(row["pairs_per_sec"]) and \
            row["pairs_per_sec"] > 0
        assert arm.launches == {}


def test_default_modes_are_the_tools():
    assert ladder_bench.DEFAULT_MODES == jladder.DEFAULT_MODES
    assert ladder_bench.DEFAULT_MODES.split(",") == [
        "float32", "bfloat16", "float16", "int8", "int4", "custom",
        "float64"]


@pytest.mark.parametrize("steps,f64,want", ((30, None, 3), (2, None, 2),
                                            (100, None, 10), (30, 7, 7)))
def test_float64_step_rule(steps, f64, want):
    assert ladder_bench.mode_steps("float64", steps, f64) == want
    assert ladder_bench.mode_steps("f64", steps, f64) == want
    assert ladder_bench.mode_steps("int4", steps, f64) == steps


def test_protocol_calls_and_impl(monkeypatch, tmp_path):
    seen = []
    real = direct.DirectSimulation

    class Spy(real):
        def __init__(self, *a, **k):
            seen.append(("init", k["precision"], k["force_impl"],
                         str(k["device"])))
            super().__init__(*a, **k)

        def step(self, num_steps=1):
            seen.append(("step", num_steps))
            super().step(num_steps)

    monkeypatch.setattr(direct, "DirectSimulation", Spy)
    out = tmp_path / "sub" / "ladder.json"
    report = ladder_bench.main(["--n", "5000", "--steps", "3", "--best-of",
                                "2", "--modes", "int8,float64", "--impl",
                                "tiled", "--device", "cpu", "--output",
                                str(out)])
    assert seen == [("init", "int8", "tiled", "cpu"), ("step", 3),
                    ("step", 3), ("step", 3),
                    ("init", "float64", "tiled", "cpu"), ("step", 2),
                    ("step", 2), ("step", 2)]
    assert [r["n"] for r in report["rows"]] == [2048, 2048]
    assert json.loads(out.read_text()) == report
    assert report["impl"] == "tiled"


def test_unknown_impl_is_refused():
    with pytest.raises(SystemExit):
        ladder_bench.main(["--impl", "pallas", "--device", "cpu"])


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ladder_bench.main(["--n", "64", "--modes", "float32"])
