"""The port's CLI end to end on the CPU, and its import hygiene."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_tpu_torch import cli
from nbody_tpu_torch.config import SimConfig

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


@pytest.mark.parametrize("schedule", [[], ["--schedule", "rows"]])
def test_cli_mesh_run_prints_the_mesh_line(tmp_path, capsys, schedule):
    histories = cli.main(["--device", "cpu", "--stars", "37", "--ticks", "4",
                          "--snapshot-interval", "2", "--mesh",
                          "--compare", "float64,int4", "--output",
                          str(tmp_path), *schedule])
    out = capsys.readouterr().out
    name = schedule[1] if schedule else "sym"
    assert f"Mesh: 1 device(s), schedule={name}" in out
    assert histories["int4_sim"].ticks == [0, 2, 4]
    for h in histories.values():
        assert np.isfinite(h.total_energy).all()


@pytest.mark.parametrize("schedule", ["sym", "rows"])
def test_cli_mesh_force_path_names_the_schedule_at_zero_softening(
        tmp_path, capsys, monkeypatch, schedule):
    """The force path names the schedule the run was given, also where the
    launch counts alone could not tell it (zero softening routes the rows
    schedule's diagonal tile to row_force, and on the CPU nothing counts)."""
    made = []

    def zero_softening(**kw):
        made.append(SimConfig(softening=0.0, **kw))
        return made[-1]

    monkeypatch.setattr(cli, "SimConfig", zero_softening)
    histories = cli.main(["--device", "cpu", "--stars", "37", "--ticks", "4",
                          "--snapshot-interval", "2", "--mesh", "--schedule",
                          schedule, "--compare", "float32", "--output",
                          str(tmp_path)])
    out = capsys.readouterr().out
    assert [c.softening_sq for c in made] == [0.0]
    name = "rows" if schedule == "rows" else "sym (half ring)"
    assert f"force path: ring, {name} schedule (no kernel launched" in out
    assert np.isfinite(histories["float32"].total_energy).all()


def test_cli_ticks_per_dispatch_without_mesh_exits():
    with pytest.raises(SystemExit, match="--ticks-per-dispatch requires "
                                         "--mesh"):
        cli.main(["--device", "cpu", "--stars", "16", "--ticks", "2",
                  "--ticks-per-dispatch", "5"])


def test_cli_mesh_of_more_devices_than_present_exits():
    with pytest.raises(SystemExit, match="asked for a mesh of 2"):
        cli.main(["--device", "cpu", "--stars", "16", "--ticks", "2",
                  "--mesh", "2"])


def test_cli_mesh_ticks_per_dispatch_matches_fused(tmp_path):
    """Host chunking of the ring's calls changes no bit of the history."""
    runs = []
    for extra in ([], ["--ticks-per-dispatch", "3"]):
        h = cli.main(["--device", "cpu", "--stars", "37", "--ticks", "6",
                      "--snapshot-interval", "2", "--mesh", "--compare",
                      "int4", "--output", str(tmp_path), *extra])
        runs.append(h["int4_sim"].total_energy)
    np.testing.assert_array_equal(runs[0], runs[1])


def test_cli_rejects_unknown_mode():
    with pytest.raises(SystemExit, match="unknown precision mode"):
        cli.main(["--device", "cpu", "--stars", "16", "--ticks", "2",
                  "--compare", "float32,int2"])


def test_import_never_pulls_in_jax():
    """Every module of the port, and chip_smoke.py, imports neither JAX nor
    the JAX package nor its tools."""
    code = ("import importlib, pkgutil, sys, nbody_tpu_torch, chip_smoke\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "nbody_tpu_torch.__path__, 'nbody_tpu_torch.')]\n"
            "for name in mods: importlib.import_module(name)\n"
            "assert 'nbody_tpu_torch.lab.kernel_lab_r5' in mods, mods\n"
            "new = ['nbody_tpu_torch.parallel.pm_sharded', "
            "'nbody_tpu_torch.engines.universe3d', "
            "'nbody_tpu_torch.engines.dashboard3d', "
            "'nbody_tpu_torch.engines.genesis', "
            "'nbody_tpu_torch.utils.reproducibility', "
            "'nbody_tpu_torch.engines.ultimate', "
            "'nbody_tpu_torch.diagnostics.multiverse', "
            "'nbody_tpu_torch.realtime.engine', "
            "'nbody_tpu_torch.realtime.visual', "
            "'nbody_tpu_torch.parallel.multihost', "
            "'nbody_tpu_torch.parallel.multihost_check', "
            "'nbody_tpu_torch.dryrun', "
            "'nbody_tpu_torch.fuzz', "
            "'nbody_tpu_torch.diagnostics.fuzz_cases', "
            "'nbody_tpu_torch.diagnostics.tolerance', "
            "'nbody_tpu_torch.bench', "
            "'nbody_tpu_torch.ladder_bench', "
            "'nbody_tpu_torch.diagnostics.reference_gate']\n"
            "assert set(new) <= set(mods), mods\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'nbody_tpu', 'tools')]\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_cli_names_the_force_path_from_the_launch_counts(tmp_path, capsys):
    none = {k: 0 for k in ("sym_force", "max_d2", "row_force",
                           "pair_sym_force", "pair_force", "pair_max",
                           "pair_pe_rows")}
    assert "chunked" in cli.force_path({**none, "sym_force": 5,
                                        "pair_sym_force": 10})
    assert cli.force_path({**none, "sym_force": 3, "pair_sym_force": 3,
                           "pair_max": 6, "pair_pe_rows": 9}, "sym") == \
        ("ring, sym (half ring) schedule (sym_force + pair_sym_force + "
         "pair_max + pair_pe_rows)")
    assert cli.force_path({**none, "pair_force": 9, "pair_pe_rows": 9},
                          "rows") == \
        "ring, rows schedule (pair_force + pair_pe_rows)"
    # zero softening on a mesh of one: the rows schedule's only tile is the
    # self-masked diagonal, row_force
    assert cli.force_path({**none, "row_force": 9, "pair_pe_rows": 2},
                          "rows") == \
        "ring, rows schedule (row_force + pair_pe_rows)"
    assert "row sweep" in cli.force_path({**none, "row_force": 3})
    assert cli.force_path({**none, "sym_force": 3}) == \
        "single-launch sym_force"
    assert "no force kernel" in cli.force_path(none)
    cli.main(["--device", "cpu", "--stars", "32", "--ticks", "4",
              "--snapshot-interval", "2", "--compare", "float32",
              "--output", str(tmp_path)])
    assert "force path: no force kernel launched" in capsys.readouterr().out


@pytest.mark.parametrize("launched, schedule, want", [
    ({"sym_force_uniform": 3}, None,
     "single-launch sym_force, equal-mass variant (sym_force_uniform)"),
    ({"sym_force_uniform": 5, "pair_sym_force_uniform": 10}, None,
     "chunked Newton's-third-law (sym_force + pair_sym_force), equal-mass "
     "variant (sym_force_uniform + pair_sym_force_uniform)"),
    ({"sym_force": 1, "sym_force_uniform": 4, "pair_sym_force": 2,
      "pair_sym_force_uniform": 6}, None,
     "chunked Newton's-third-law (sym_force + pair_sym_force), equal-mass "
     "variant (sym_force_uniform + pair_sym_force_uniform)"),
    ({"sym_force": 3, "sym_force_uniform_max": 3}, None,
     "single-launch sym_force, equal-mass variant (sym_force_uniform_max)"),
    ({"sym_force_max": 3}, None,
     "single-launch sym_force with the fused max"),
    ({"sym_force_uniform": 3, "pair_sym_force_uniform": 3, "pair_max": 6,
      "pair_pe_rows": 9}, "sym",
     "ring, sym (half ring) schedule (sym_force_uniform + "
     "pair_sym_force_uniform + pair_max + pair_pe_rows)"),
])
def test_cli_force_path_names_the_equal_mass_variant(launched, schedule,
                                                     want):
    """The equal-mass variants count apart (hopper_nbody.LAUNCHES), and
    the force path names them; the general kernels' names stay as they
    were."""
    from nbody_tpu_torch.ops import hopper_nbody as hn
    counts = {**{k: 0 for k in hn.LAUNCHES}, **launched}
    assert cli.force_path(counts, schedule) == want
