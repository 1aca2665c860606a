"""The round-5 kernel lab (``nbody_tpu_torch.lab.kernel_lab_r5``) on the CPU.

The accumulation offload's plain version (``sym_force_mxu_plain``, through
``accelerations_mxu``) against ``tools/kernel_lab_r5.py``'s
``accelerations_mxu``: the TPU lab kernel itself, run in Pallas interpret
mode. That module hard-codes ``interpret=False`` and TPU compiler params,
so the ``interpret`` fixture replaces ``pallas_call`` on the module's
``pl`` with a wrapper that sets ``interpret=True`` and drops
``compiler_params``. Nothing in ``tools/`` or ``nbody_tpu/`` changes.

JAX on the CPU computes the kernel's dot_generals in f32 whatever their
precision, so the JAX side is the f32 function for all three precisions:
one JAX call per (N, D), each precision held against it by a tolerance on
the summed |terms| s = G sum_j w_ij (|x_j| + |x_i|) per coordinate (the
function cancels down to |a| from s, so |a| is no scale for its rounding):
highest |err| <= 2e-6 + 5e-5 s, high 1e-4 s, default 1e-2 s (one bf16
pass rounds w and x to 8 bits). Then the study's d^2 forms elementwise
against JAX's, the bf16 split, the wrapper's guards and the entry point.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.kernel_lab_r5 as r5
from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.lab import kernel_lab_r5 as k5

torch.set_num_threads(1)

CFG, JCFG = SimConfig(), JaxConfig()
# (N, the TPU lab's block knobs): its defaults at 1024 (one 1024-wide
# super-chunk: rows only), 128 x 256 blocks at 768 (rows and columns).
SIZES = ((1024, {}), (768, dict(block=128, block_j=256)))
# |err| <= atol + rtol s, by precision, against the f32 function.
TOLS = {"highest": (2e-6, 5e-5), "high": (0.0, 1e-4), "default": (0.0, 1e-2)}
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def interpret(monkeypatch):
    """tools/kernel_lab_r5.py's pallas_call in interpret mode, without the
    TPU's compiler params."""
    real = r5.pl.pallas_call

    def pallas_call(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(r5.pl, "pallas_call", pallas_call)


def _gauss(n, dim, seed=0):
    rng = np.random.default_rng(seed + 31 * n + dim)
    return (rng.standard_normal((n, dim)) * 10.0).astype(np.float32)


def _scale(pos):
    return k5.mxu_term_scale(torch.from_numpy(pos), torch.tensor(CFG.G),
                             CFG.softening_sq).numpy()


def _oracle(pos):
    """The function in float64: G sum_j w_ij (x_j - x_i)."""
    p = pos.astype(np.float64)
    diff = p[None, :, :] - p[:, None, :]
    w = ((diff ** 2).sum(-1) + CFG.softening_sq) ** -1.5
    return (w[..., None] * diff).sum(1) * CFG.G


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n,knobs", SIZES)
def test_plain_matches_the_tpu_lab_kernel(interpret, n, knobs, dim):
    pos = _gauss(n, dim)
    want = np.asarray(r5.accelerations_mxu(jnp.asarray(pos),
                                           jnp.float32(JCFG.G), JCFG,
                                           **knobs))
    s = _scale(pos)
    for precision, (atol, rtol) in TOLS.items():
        got = k5.accelerations_mxu(torch.from_numpy(pos), CFG.G, CFG,
                                   precision=precision).numpy()
        assert np.isfinite(got).all()
        ratio = np.abs(got - want) / (atol + rtol * s)
        assert ratio.max() <= 1.0, (precision, float(ratio.max()))


@pytest.mark.parametrize("dim", [2, 3])
def test_error_against_float64_orders_by_precision(dim):
    """Max |err| / s against the f64 oracle: default > high >= highest."""
    pos = _gauss(1024, dim, seed=1)
    want, s = _oracle(pos), _scale(pos)
    errs = {p: float(np.max(np.abs(k5.accelerations_mxu(
        torch.from_numpy(pos), CFG.G, CFG, precision=p).numpy() - want) / s))
        for p in k5.PASSES}
    assert errs["default"] > 10 * errs["high"], errs
    assert errs["high"] >= errs["highest"], errs
    assert errs["highest"] < 5e-6 and errs["default"] < 1e-2, errs


def test_bf16_three_way_split_is_exact():
    rng = np.random.default_rng(5)
    n = 100_000
    a = (rng.choice([-1.0, 1.0], n) * rng.uniform(1.0, 2.0, n)
         * 2.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    assert np.ptp(np.log2(np.abs(a))) > 11   # 12 binades
    t = torch.from_numpy(a)
    a0, a1, a2 = k5.bf16_planes(t, 3)
    for p in (a0, a1, a2):   # each plane is a bf16 value
        assert torch.equal(p, p.to(torch.bfloat16).to(torch.float32))
    assert torch.equal((a0 + a1) + a2, t)
    assert torch.equal(a0.to(torch.float64) + a1.to(torch.float64)
                       + a2.to(torch.float64), t.to(torch.float64))
    assert int((a1 != 0).sum()) > n // 2 and int((a2 != 0).sum()) > n // 2


@pytest.mark.parametrize("scale,offset", [(10.0, 0.0), (0.5, 200.0)])
def test_d2_forms_match_jax(scale, offset):
    """Each d^2 form against its JAX twin on the same points: subtract
    within 2 ulp of d^2, the dot forms within 8 eps (|x_i|^2 + |x_j|^2)
    (both keep a BLAS change from failing the test)."""
    rng = np.random.default_rng(7)
    p = (rng.standard_normal((512, 2)).astype(np.float32) * np.float32(scale)
         + np.float32(offset)).astype(np.float32)
    pt, pj = torch.from_numpy(p), jnp.asarray(p)
    sq = (p.astype(np.float64) ** 2).sum(1)
    dot_tol = 8 * EPS32 * (sq[:, None] + sq[None, :])
    for port, jax_fn, tol in (
            (k5.d2_subtract, r5.d2_subtract, None),
            (k5.d2_dot_naive, r5.d2_dot_naive, dot_tol),
            (k5.d2_dot_compensated, r5.d2_dot_compensated, dot_tol)):
        got = port(pt).numpy()
        want = np.asarray(jax_fn(pj))
        assert got.dtype == np.float32 and got.shape == want.shape
        if tol is None:
            tol = 2 * np.spacing(np.abs(want))
        assert (np.abs(got.astype(np.float64) - want) <= tol).all(), \
            port.__name__


def test_accuracy_study_adversarial_row(capsys):
    res = k5.accuracy_study("cpu", torch.Generator().manual_seed(0))
    adv = res["adversarial: tight cluster at 200"]
    assert adv["subtract-form"] < 1e-5
    assert adv["dot-form naive"] > 1e-3
    assert adv["dot-form compensated"] > 1e-3
    assert set(res) == {name for name, _, _ in k5.GEOMETRIES}
    out = capsys.readouterr().out
    assert "A [adversarial: tight cluster at 200] dot-form compensated: " \
           "max abs err" in out


GOOD = _gauss(128, 2)


@pytest.mark.parametrize("pos,soft,precision,match", [
    (np.zeros((128, 4), np.float32), 0.01, "high", r"\(N, 2\) or \(N, 3\)"),
    (GOOD[:100], 0.01, "high", "multiple of 64"),
    (GOOD.astype(np.float64), 0.01, "high", "float32"),
    (GOOD, 0.0, "high", "softening > 0"),
    (GOOD, 0.01, "bf16_3x", "unknown precision"),
], ids=["D=4", "ragged", "f64", "zero-softening", "precision"])
def test_sym_force_mxu_takes_what_its_kernel_serves(pos, soft, precision,
                                                    match):
    gm = torch.tensor(CFG.G)
    assert k5.sym_force_mxu(torch.from_numpy(GOOD), gm, 0.01,
                            "high").shape == (128, 2)
    with pytest.raises(ValueError, match=match):
        k5.sym_force_mxu(torch.from_numpy(np.ascontiguousarray(pos)), gm,
                         soft, precision)


def test_lab_r5_end_to_end_on_the_cpu(capsys):
    res = k5.main(["--device", "cpu", "--n", "256", "--steps", "1"])
    out = capsys.readouterr().out
    assert "lab_r5: [float32] C: mxu-accum dot=HIGH-vs-prod max rel delta" \
        in out
    assert [r["variant"] for r in res["rows"]] == \
        ["prod", "uniform"] + [label for label, _ in k5.ROWS]
    for row in res["rows"]:
        assert row["mode"] == "float32"
        assert np.isfinite(row["ms"]) and row["pairs_per_s"] > 0
        assert np.isfinite(row["rel_vs_prod"])
    assert res["rows"][1]["rel_vs_prod"] < 1e-5
    assert res["study"]["adversarial: tight cluster at 200"][
        "subtract-form"] < 1e-5
