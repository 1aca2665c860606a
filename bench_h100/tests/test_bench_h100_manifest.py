"""BENCHMARK.json against its format rules, and the harness's
discovery by name: a new configuration, traffic mix, cell and per-layer
metric are added by adding files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from bench_h100 import devtrace, harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32
    assert all(one_line(w) for w in bench["command"])
    for word in bench["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_names_units_and_entries(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    assert len({c["file"] for c in bench["configs"]}) == len(
        bench["configs"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == WORKLOAD_KEYS
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    assert len({w["name"] for w in bench["workloads"]}) == len(pairs)
    used = {w["config"] for w in bench["workloads"]}
    assert used == names
    metric_names = set()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.add(m["name"])
    assert "setup_s" in metric_names
    for m in bench["per_layer"]:
        assert set(m) == LAYER_KEYS | {"workloads"}
        assert m["workloads"]
        assert m["moves"] in metric_names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in bench["workloads"]}
    assert len(metric_names | {m["name"] for m in bench["per_layer"]}) == \
        len(bench["end_to_end"]) + len(bench["per_layer"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    man = harness.Manifest()
    for w in man.data["workloads"]:
        e2e = [m["name"] for m in man.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.per_layer(w["name"])


def test_every_name_has_its_files():
    man = harness.Manifest()
    for w in man.data["workloads"]:
        run = harness.Run(man, w["name"], 1, 1, False, "cpu")
        assert run.limits and all(v >= 0 for v in run.limits.values())
        man.entry(run.traffic["entry"])
    for m in man.data["end_to_end"]:
        assert hasattr(man.reader("end_to_end", m["name"]), "read")
    for m in man.data["per_layer"]:
        assert hasattr(man.reader("layer_metrics", m["name"]), "read")


def test_kernel_roles_name_the_port_kernels():
    roles = devtrace.load_roles()
    assert devtrace.role_of("sym_one_pass<3, 2, false, false>",
                            roles) == "force"
    assert devtrace.role_of("pair_one_pass<0, 3, false>", roles) == "force"
    assert devtrace.role_of("max_d2_tiled", roles) == "bounds"
    assert devtrace.role_of("pair_pe_tiled<2>", roles) == "snapshot"
    assert devtrace.role_of("at::native::elementwise_kernel<128, 2>",
                            roles) == "other"


def test_a_new_cell_and_metric_are_added_by_files_alone(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell's
    limits, a per-layer reader and a kernel-roles file as new files, and
    entries in BENCHMARK.json: the harness finds and reads each one, and
    no file that was there changed."""
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench_h100").rglob("*")
              if p.is_file()}
    here = tmp_path / "bench_h100"
    cfg = json.loads((here / "configs" / "plummer3d.json").read_text())
    cfg.update(name="plummer3d_soft", softening=0.05)
    (here / "configs" / "plummer3d_soft.json").write_text(json.dumps(cfg))
    (here / "traffic" / "4k-f32-s5.json").write_text(json.dumps({
        "entry": "direct_history", "n": 4096, "mode": "float32",
        "force_impl": "auto", "snapshot_interval": 5, "check_rows": 64}))
    (here / "limits" / "plummer3d_soft-4k-f32.json").write_text(json.dumps(
        {"force_err": 1e-3, "step_err": 0.1, "replay_diff": 0,
         "ke_err": 1e-3, "pe_err": 1e-3}))
    (here / "layer_metrics" / "ticks_per_unit.py").write_text(
        "def read(run):\n    return run.work['ticks'] / run.work['attempted']\n")
    (here / "kernel_roles" / "force_next.json").write_text(json.dumps(
        {"role": "force", "patterns": ["^sym_next_design"]}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "plummer3d_soft", "source": "x",
                             "file": "bench_h100/configs/plummer3d_soft.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "plummer3d_soft-4k-f32",
                               "config": "plummer3d_soft",
                               "traffic": "4k-f32-s5", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "ticks_per_unit", "unit": "ticks",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "pairs_per_s",
                               "workloads": ["plummer3d_soft-4k-f32"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("plummer3d_soft-4k-f32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    man = harness.Manifest(root=tmp_path, here=here)
    assert [m["name"] for m in man.per_layer("plummer3d_soft-4k-f32")] == \
        ["ticks_per_unit"]
    line = harness.run_cell("plummer3d_soft-4k-f32", 7, 0, True, "cpu", man,
                            traffic_overrides={"n": 128})
    run = line.pop("_run")
    assert run.config["softening"] == 0.05 and run.traffic["n"] == 128
    assert line["metrics"]["ticks_per_unit"]["value"] == 5
    assert line["correct"]
    roles = devtrace.load_roles(here / "kernel_roles")
    assert devtrace.role_of("sym_next_design<2>", roles) == "force"
    after = {p: p.read_bytes() for p in before}
    assert after == before
