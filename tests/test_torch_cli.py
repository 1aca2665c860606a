"""The port's CLI end to end on the CPU, and its import hygiene."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nbody_tpu_torch import cli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PNGS = ("galaxy_comparison.png", "rotation_curves.png",
        "energy_evolution.png", "radius_evolution.png")


def test_cli_cpu_run_prints_summary_and_writes_plots(tmp_path, capsys):
    histories = cli.main(["--device", "cpu", "--stars", "64", "--ticks",
                          "20", "--snapshot-interval", "10", "--compare",
                          "float64,int4", "--output", str(tmp_path)])
    out = capsys.readouterr().out
    assert "SIMULATION RESULTS SUMMARY" in out
    assert "Energy drift" in out and "Running simulation: int4_sim" in out
    assert 'kernel launches: {"sym_force": ' in out
    assert set(histories) == {"float64", "int4_sim"}
    assert histories["int4_sim"].ticks == [0, 10, 20]
    for name in PNGS:
        assert (tmp_path / name).stat().st_size > 0


def test_cli_default_device_without_cuda_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would start")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["--stars", "64", "--ticks", "10"])


@pytest.mark.parametrize("flag", [["--mesh"], ["--schedule", "rows"],
                                  ["--ticks-per-dispatch", "5"]])
def test_cli_unported_flags_exit(flag):
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(["--device", "cpu", "--stars", "16", "--ticks", "2", *flag])


def test_cli_rejects_unknown_mode():
    with pytest.raises(SystemExit, match="unknown precision mode"):
        cli.main(["--device", "cpu", "--stars", "16", "--ticks", "2",
                  "--compare", "float32,int2"])


def test_import_never_pulls_in_jax():
    code = ("import sys, nbody_tpu_torch, nbody_tpu_torch.cli, "
            "nbody_tpu_torch.models.direct, nbody_tpu_torch.ops.forces; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'nbody_tpu' or "
            "m.startswith('nbody_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_cli_names_the_force_path_from_the_launch_counts(tmp_path, capsys):
    none = {"sym_force": 0, "max_d2": 0, "row_force": 0, "pair_sym_force": 0}
    assert "chunked" in cli.force_path({**none, "sym_force": 5,
                                        "pair_sym_force": 10})
    assert "row sweep" in cli.force_path({**none, "row_force": 3})
    assert cli.force_path({**none, "sym_force": 3}) == \
        "single-launch sym_force"
    assert "no force kernel" in cli.force_path(none)
    cli.main(["--device", "cpu", "--stars", "32", "--ticks", "4",
              "--snapshot-interval", "2", "--compare", "float32",
              "--output", str(tmp_path)])
    assert "force path: no force kernel launched" in capsys.readouterr().out
