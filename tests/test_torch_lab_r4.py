"""The round-4 kernel lab (``nbody_tpu_torch.lab.kernel_lab_r4``) on the CPU.

Each round-4 lab variant's plain version against ``tools/kernel_lab_r4.py``'s
``accelerations_r4`` with the matching knob: the TPU lab kernel itself, run
in Pallas interpret mode. That module hard-codes ``interpret=False`` and TPU
compiler params, so the ``interpret`` fixture replaces ``pallas_call`` on
the module's ``pl`` with a wrapper that sets ``interpret=True`` and drops
``compiler_params``; ``accelerations_r4`` is jitted, so every knob is
traced under the patch. Nothing in ``tools/`` or ``nbody_tpu/`` changes.
Then the base-2 fold's bin moves, the wrappers' guards and the entry
point end to end at a tiny size.

Tolerances: float32 rtol 2e-5, atol 1e-6 (tests/test_pallas_kernel.py:
384-385); int4 after quantize_force the flip rule of PERF.md section 2
(``hold`` of tests/test_torch_lab.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.kernel_lab_r4 as r4
from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.ops import precision as jp
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.lab import kernel_lab, kernel_lab_r4
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp
from test_torch_lab import _inputs, _t, hold

torch.set_num_threads(1)

CFG = SimConfig()
# Port variant -> the TPU lab's knobs (tools/kernel_lab_r4.py:286-292).
KNOBS = {
    "base2": dict(block=128, block_j=256, base2=True),
    "wide2": dict(block=128, block_j=256, join="dual"),
    "wideacc": dict(block=128, block_j=256, join="wide", unroll=1),
    "base2_wideacc": dict(block=128, block_j=256, join="wide", base2=True),
    "rt2": dict(block=384, block_j=768),
    "rt3": dict(block=384, block_j=384, unroll=3),
}
CASES = [(v, mode) for v in KNOBS for mode in ("float32", "int4")
         if mode == "int4" or not kernel_lab.LAB_VARIANTS[v].base2]


@pytest.fixture
def interpret(monkeypatch):
    """tools/kernel_lab_r4.py's pallas_call in interpret mode, without the
    TPU's compiler params."""
    real = r4.pl.pallas_call

    def pallas_call(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(r4.pl, "pallas_call", pallas_call)


@pytest.mark.parametrize("soft", [0.1, 0.0])
@pytest.mark.parametrize("variant,mode", CASES)
def test_plain_matches_the_tpu_lab_kernel(interpret, variant, mode, soft):
    pos, m = _inputs(768, 2, seed=21)
    qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
    jcfg, cfg = JaxConfig(softening=soft), SimConfig(softening=soft)
    want = r4.accelerations_r4(jnp.asarray(pos), jnp.float32(jcfg.G), q=qj,
                               cfg=jcfg, quantize_forces=qj.is_int,
                               **KNOBS[variant])
    got = kernel_lab.lab_accelerations(_t(pos), _t(m), qt, cfg, variant,
                                       quantize_forces=qt.is_int)
    hold(got.numpy(), np.asarray(want), mode)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_base2_fold_moves_few_bins_by_one(mode):
    """The base-2 chain's bin index k against the natural-log chain's over
    every pair of a 512-star disk: equal but for at most max(4, 1e-4 x
    pairs), each one bin off; where k agrees, w agrees to exp2 against
    exp rounding."""
    p = _t(_inputs(512, 2, seed=13)[0])
    q = tp.Quantizer.from_string(mode)
    bounds = hn.kernel_bounds(p, q, CFG)
    i, j = torch.triu_indices(512, 512, 1)
    d = p[j] - p[i]
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + bounds[2]
    grid = hn._int_grid(bounds, q)
    k_ln = torch.round(torch.log(torch.clamp(d2, min=q.min_dist_sq))
                       * grid[0] + grid[1])
    grid2 = kernel_lab.base2_grid(bounds, q)
    k_2 = kernel_lab.base2_bins(d2, q, grid2)
    off = k_2 != k_ln
    assert int(off.sum()) <= max(4, int(1e-4 * d2.numel())), int(off.sum())
    assert bool(((k_2 - k_ln).abs() <= 1).all())
    assert len(torch.unique(k_ln)) > 4   # the pairs span the grid
    w_ln = hn._pair_weight(d2, q, grid)
    w_2 = kernel_lab.base2_weight(d2, q, grid2)
    np.testing.assert_allclose(w_2[~off].numpy(), w_ln[~off].numpy(),
                               rtol=2e-6)


@pytest.mark.parametrize("variant", list(kernel_lab.R4_VARIANTS))
def test_r4_variants_take_what_their_kernels_serve(variant):
    spec = kernel_lab.R4_VARIANTS[variant]
    pos, m = _inputs(384, 3)
    q = tp.Quantizer.from_string("int4")
    p3, gm = _t(pos), CFG.G * _t(m)
    bounds = hn.kernel_bounds(p3, q, CFG)
    with pytest.raises(ValueError, match="D=2"):
        kernel_lab.sym_force_lab(p3, gm, bounds, q, False, variant)
    p2 = p3[:, :2].contiguous()
    bad = {64: 100, 128: 192, 192: 256}[spec.side]
    with pytest.raises(ValueError, match=f"multiple of {spec.side}"):
        kernel_lab.sym_force_lab(p2[:bad], gm[:bad], bounds, q, False,
                                 variant)
    f32 = tp.Quantizer.from_string("float32")
    if spec.base2:
        with pytest.raises(ValueError, match="an int mode"):
            kernel_lab.sym_force_lab(p2, gm, bounds, f32, False, variant)
    else:
        assert kernel_lab.sym_force_lab(p2, gm, bounds, f32, False,
                                        variant).shape == (384, 2)
    with pytest.raises(ValueError, match="float32 or an int mode|an int"):
        kernel_lab.sym_force_lab(p2, gm, bounds,
                                 tp.Quantizer.from_string("bf16"), False,
                                 variant)
    with pytest.raises(ValueError, match="unknown lab variant"):
        kernel_lab.sym_force_lab(p2, gm, bounds, q, False, variant + "x")


def test_lab_r4_end_to_end_on_the_cpu(capsys):
    rows = kernel_lab_r4.main(["--device", "cpu", "--n", "384", "--steps",
                               "1"])
    out = capsys.readouterr().out
    assert "lab_r4: [int4] A: base2 chain-vs-prod max rel delta" in out
    labels = [label for label, _ in kernel_lab_r4.ROWS]
    want = ([("float32", v) for v in ["prod", "uniform"] + labels
             if "base2" not in v]
            + [("int4", v) for v in ["prod", "uniform"] + labels])
    assert [(r["mode"], r["variant"]) for r in rows] == want
    for row in rows:
        assert np.isfinite(row["ms"]) and row["pairs_per_s"] > 0
        assert np.isfinite(row["rel_vs_prod"])
        if row["mode"] == "float32":
            assert row["rel_vs_prod"] < 1e-5
