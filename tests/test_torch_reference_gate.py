"""nbody_tpu_torch.diagnostics.reference_gate against tools/reference_parity.py,
on the CPU.

* The rule: the committed 5000 x 2000 reference rows (float32, int4 and
  int8, each with its permuted twin) against "ours" drifts and positions
  placed on both sides of the drift and the radius90 tolerances. The
  tool's side is its own ``main`` with ``run_reference_cached`` and
  ``run_ours`` patched to hand it the same arrays; its report and the
  port's ``gate_row`` must hold every shared field equal, verdicts
  included.
* The mode vocabulary: every alias maps to the tool's spelling, and an
  unknown mode raises on both sides.
* ``run_ours`` against the tool's ``run_ours`` on JAX's 300-star disk,
  100 ticks, a reading every 50, float32, int8 and int4: the drifts within
  DRIFT_ATOL percentage points (two float32 total energies, each within
  ~2.5e-7 relative: different summation orders), the final positions
  within POS_ATOL (int8's few grid flips move a star by ~2e-5).
* The CLI: a cached row through ``main`` gives the rule's verdict and
  report; a row that is not cached raises, naming the cache.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.diagnostics import reference_gate as rg
from tools import reference_parity as tool

torch.set_num_threads(1)

DRIFT_ATOL = 5e-5   # percentage points
POS_ATOL = 1e-4
RUN = (5000, 2000, 100, 42)
GATE_MODES = ("float32", "int4", "int8")
# (multiple of the drift tolerance added to the reference's final drift,
# factor on the reference's final positions): both sides of each rule.
CASES = ((0.0, 1.0), (0.5, 1.0), (0.95, 1.0), (1.5, 1.0), (-3.0, 1.0),
         (0.0, 1.05), (0.0, 1.6), (0.0, 0.3))
SHARED = ("final_drift_reference", "final_drift_ours",
          "drift_envelope_agree", "envelope_tolerance",
          "radius90_reference", "radius90_ours", "radius_agree",
          "final_drift_reference_perturbed", "reference_chaos_spread",
          "radius90_reference_perturbed", "radius90_chaos_spread")


def _ours(ref, twin, step, factor):
    """Fake drifts and final positions: the reference's with the final
    drift moved by ``step`` tolerances (the tolerance the rule would set
    for the reference's own drift) and the positions scaled by
    ``factor``."""
    final = ref[0][-1]
    spread = abs(final - twin[0][-1])
    tol = max(0.5 * max(abs(final), 0.05), 0.05, 2.0 * spread)
    drifts = list(ref[0][:-1]) + [final + step * tol]
    return drifts, (ref[1] * np.float32(factor)).astype(np.float32)


@pytest.mark.parametrize("mode", GATE_MODES)
@pytest.mark.parametrize("step,factor", CASES)
def test_gate_row_equals_the_tool(mode, step, factor, monkeypatch, tmp_path):
    ref = rg.load_reference(*RUN, mode)
    twin = rg.load_reference(*RUN, mode, perturbed=True)
    drifts, pos = _ours(ref, twin, step, factor)

    def cached(positions, velocities, masses, mode_str, num_ticks, interval,
               seed, perm=None, refresh=False):
        assert (len(positions), num_ticks, interval, seed) == RUN
        return twin if perm is not None else ref

    monkeypatch.setattr(tool, "run_reference_cached", cached)
    monkeypatch.setattr(tool, "run_ours",
                        lambda *a, **k: (drifts, pos, pos))
    rc = tool.main(["--stars", "5000", "--ticks", "2000", "--interval",
                    "100", "--modes", mode, "--perturb", "--output",
                    str(tmp_path)])
    want = json.loads((tmp_path / "reference_parity.json").read_text())[mode]
    got = rg.gate_row(ref, drifts, pos, twin)
    for key in SHARED:
        assert got[key] == want[key], key
    assert got["agree"] == (want["drift_envelope_agree"]
                            and want["radius_agree"]) == (rc == 0)


def test_cases_reach_both_sides_of_each_rule():
    seen = set()
    for mode in GATE_MODES:
        ref = rg.load_reference(*RUN, mode)
        twin = rg.load_reference(*RUN, mode, perturbed=True)
        for step, factor in CASES:
            row = rg.gate_row(ref, *_ours(ref, twin, step, factor), twin)
            seen.add(("drift", row["drift_envelope_agree"]))
            seen.add(("radius", row["radius_agree"]))
    assert seen == {("drift", True), ("drift", False), ("radius", True),
                    ("radius", False)}


def test_gate_row_without_a_twin_keeps_the_floors():
    ref = rg.load_reference(*RUN, "float64")
    row = rg.gate_row(ref, ref[0], ref[1])
    assert row["agree"] and "reference_chaos_spread" not in row
    assert row["envelope_tolerance"] == max(
        0.5 * max(abs(ref[0][-1]), 0.05), 0.05)
    assert row["radius_tolerance"] == 0.1 * row["radius90_reference"]


@pytest.mark.parametrize("mode", ("float64", "f64", "fp64", "float32",
                                  "fp32", "f32", "bfloat16", "bf16",
                                  "float16", "fp16", "f16", "half", "int8",
                                  "int8_sim", "int4", "INT4_SIM", "custom"))
def test_cache_stem_is_the_tools_spelling(mode):
    assert rg.cache_stem(mode) == tool.canonical_reference_mode(mode)


@pytest.mark.parametrize("mode", ("int2", "float8", ""))
def test_unknown_mode_raises_on_both_sides(mode):
    with pytest.raises(ValueError):
        tool.canonical_reference_mode(mode)
    with pytest.raises(ValueError, match="FLOAT64"):
        rg.cache_stem(mode)


def test_cache_path_is_the_tools():
    for mode in ("bfloat16", "int4_sim", "float64"):
        for perturbed in (False, True):
            want = tool._cache_path(*RUN, tool.canonical_reference_mode(
                mode), perturbed)
            assert rg.cache_path(*RUN, mode, perturbed) == want


def test_load_reference_reads_the_cached_row():
    drifts, pos, vel = rg.load_reference(*RUN, "bf16")
    blob = json.loads(rg.cache_path(*RUN, "bf16").read_text())
    assert drifts == blob["drifts"] and len(drifts) == 20
    assert pos.dtype == vel.dtype == np.float32 and pos.shape == (5000, 2)


def test_uncached_row_raises_naming_the_cache():
    with pytest.raises(FileNotFoundError, match="ref_s300_t300_i50_seed42"):
        rg.load_reference(300, 300, 50, 42, "int4")
    with pytest.raises(FileNotFoundError, match="not part of this"):
        rg.load_reference(*RUN, "float16", perturbed=True)


@pytest.fixture(scope="module")
def jax_ics_300():
    with jax.default_device(jax.devices("cpu")[0]):
        pos, vel, m = create_disk_galaxy(jax.random.PRNGKey(42),
                                         num_stars=300)
    return tuple(np.asarray(x) for x in (pos, vel, m))


@pytest.mark.parametrize("mode", ("float32", "int8", "int4"))
def test_run_ours_matches_the_tools(mode, jax_ics_300):
    jd, jpos, jvel = tool.run_ours(*jax_ics_300, mode, 100, 50)
    td, tpos, tvel = rg.run_ours(*jax_ics_300, mode, 100, 50, device="cpu")
    assert len(td) == len(jd) == 2
    np.testing.assert_allclose(td, jd, rtol=0, atol=DRIFT_ATOL)
    np.testing.assert_allclose(tpos, np.asarray(jpos), rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(tvel, np.asarray(jvel), rtol=0, atol=POS_ATOL)


@pytest.mark.parametrize("step,factor,rc", ((0.0, 1.0, 0), (3.0, 1.0, 1)))
def test_cli_gives_the_rules_verdict(step, factor, rc, monkeypatch,
                                     tmp_path, capsys):
    ref = rg.load_reference(*RUN, "int4")
    twin = rg.load_reference(*RUN, "int4", perturbed=True)
    drifts, pos = _ours(ref, twin, step, factor)
    calls = []

    def fake(positions, velocities, masses, mode, ticks, interval, device,
             impl):
        calls.append((positions.shape, mode, ticks, interval, str(device),
                      impl))
        return drifts, pos, pos

    monkeypatch.setattr(rg, "run_ours", fake)
    assert rg.main(["--modes", "int4_sim", "--perturb", "--device", "cpu",
                    "--output", str(tmp_path)]) == rc
    assert calls == [((5000, 2), "int4", 2000, 100, "cpu", "auto")]
    row = json.loads((tmp_path / "reference_parity.json").read_text())["int4"]
    want = rg.gate_row(ref, drifts, pos, twin)
    for key in want:
        assert row[key] == want[key], key
    assert row["drift_ours"] == drifts
    out = capsys.readouterr().out
    assert ("PARITY: PASS" if rc == 0 else "PARITY: FAIL") in out


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rg.main(["--modes", "int4"])
