"""The kernel lab (``nbody_tpu_torch.lab.kernel_lab``) on the CPU.

The lab's variants of the equal-mass sym kernel (their plain versions
here) against the production equal-mass plain version, and against JAX's
production equal-mass call in Pallas interpret mode. ``tools/kernel_lab.py``
itself compiles for the TPU only (``interpret=False``, ``pltpu``), so the
lab is held to ``pallas_accelerations_sym(uniform_gm=True)``, which computes
the same function. Then the lab's protocol end to end at a tiny size.

Tolerances: float32 rtol 2e-5, atol 1e-6 (tests/test_pallas_kernel.py:
384-385; seed-soft rounds d^2 in another order, an ulp of w); int4 after
quantize_force the flip rule of PERF.md section 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.ops import precision as jp
from nbody_tpu.ops.pallas_nbody import pallas_accelerations_sym
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.lab import kernel_lab
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)

CFG, JCFG = SimConfig(), JaxConfig()


def _inputs(n, dim, seed=0):
    """Disk-like (2-D) or Gaussian (3-D) positions and equal masses."""
    rng = np.random.default_rng(seed + 31 * n + dim)
    if dim == 2:
        r = np.clip(rng.exponential(10.0 / 3.0, n), 0.1, 20.0)
        a = rng.uniform(0, 2 * np.pi, n)
        pos = np.stack([r * np.cos(a), r * np.sin(a)], 1)
    else:
        pos = rng.standard_normal((n, 3)) * 5.0
    return pos.astype(np.float32), np.ones(n, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def hold(got, want, mode, rtol=2e-5, atol=1e-6):
    """The float rule, or for int4 the flip rule on quantized forces."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    q = tp.Quantizer.from_string(mode)
    if not q.is_int:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        return
    step = (want.max() - want.min()) / (q.levels - 1)
    tol = atol + rtol * np.abs(want).max()
    diff = np.abs(got - want)
    off = diff > tol
    assert off.sum() <= max(4, int(1e-4 * want.size)), off.sum()
    assert (diff[off] <= step + tol).all()


@pytest.mark.parametrize("variant", list(kernel_lab.VARIANTS))
@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_lab_plain_matches_the_uniform_plain(mode, variant):
    pos, m = _inputs(512, 2, seed=11)
    q = tp.Quantizer.from_string(mode)
    p, gm = _t(pos), CFG.G * _t(m)
    for soft, masked in ((CFG.softening_sq, False), (0.0, True)):
        bounds = hn.kernel_bounds(p, q, SimConfig(softening=soft ** 0.5))
        got = kernel_lab.sym_force_lab(p, gm, bounds, q, masked, variant)
        want = hn.sym_force_uniform_plain(p, gm, bounds, q, masked)
        if q.is_int:
            got, want = tp.quantize_force(got, q), tp.quantize_force(want, q)
        hold(got.numpy(), want.numpy(), mode)


@pytest.mark.parametrize("mode", ["float32", "int4"])
def test_lab_matches_jax_production_uniform(mode):
    pos, m = _inputs(512, 2, seed=12)
    qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
    want = pallas_accelerations_sym(jnp.asarray(pos), jnp.asarray(m), qj,
                                    JCFG, quantize_forces=qt.is_int,
                                    block=128, block_j=256, uniform_gm=True)
    for variant in kernel_lab.VARIANTS:
        got = kernel_lab.lab_accelerations(_t(pos), _t(m), qt, CFG, variant,
                                           quantize_forces=qt.is_int)
        hold(got.numpy(), np.asarray(want), mode)


def test_lab_variants_take_what_the_kernel_serves():
    pos, m = _inputs(256, 3)
    q = tp.Quantizer()
    p3, gm = _t(pos), CFG.G * _t(m)
    bounds = hn.kernel_bounds(p3, q, CFG)
    with pytest.raises(ValueError, match="D=2"):
        kernel_lab.sym_force_lab(p3, gm, bounds, q, False, "wide2")
    p2 = p3[:, :2].contiguous()
    with pytest.raises(ValueError, match="multiple of 64"):
        kernel_lab.sym_force_lab(p2[:250], gm[:250], bounds, q, False,
                                 "wide2")
    with pytest.raises(ValueError, match="float32 or an int mode"):
        kernel_lab.sym_force_lab(p2, gm, bounds, tp.Quantizer.from_string(
            "bf16"), False, "wide2")
    with pytest.raises(ValueError, match="unknown lab variant"):
        kernel_lab.sym_force_lab(p2, gm, bounds, q, False, "wide8")


def test_lab_protocol_end_to_end_on_the_cpu(capsys):
    rows = kernel_lab.main(["--device", "cpu", "--n", "128", "--steps", "1"])
    out = capsys.readouterr().out
    assert "uniform-vs-prod max rel delta" in out
    assert len(rows) == 2 * (2 + len(kernel_lab.VARIANTS))
    for row in rows:
        assert np.isfinite(row["ms"]) and row["pairs_per_s"] > 0
        if row["mode"] == "float32":
            assert row["rel_vs_prod"] < 1e-5
