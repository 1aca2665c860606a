"""nbody_tpu_torch.ops.precision against nbody_tpu.ops.precision.

Inputs are made with numpy from a seed and handed to both packages. The
port's bf16/f16 round-trips are native casts; they must equal the JAX
package's integer emulations bit for bit, subnormals, the f16 overflow
edge, infinities and NaN included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import precision as jp
from nbody_tpu_torch.ops import precision as tp

torch.set_num_threads(1)


def _edge_values() -> np.ndarray:
    rng = np.random.default_rng(0)
    normals = (rng.standard_normal(4000)
               * 10.0 ** rng.uniform(-6, 6, 4000)).astype(np.float32)
    f16_sub = (rng.uniform(0, 2.0 ** -14, 500)).astype(np.float32)
    f32_sub = (rng.uniform(0, 1.2e-38, 200)).astype(np.float32)
    halfway = (np.arange(1, 200, dtype=np.float32) * 2.0 ** -25)
    edges = np.array([0.0, -0.0, 2.0 ** -24, 2.0 ** -25, 3 * 2.0 ** -26,
                      2.0 ** -14, 65504.0, 65519.9, 65520.0, 65536.0,
                      1e5, -65520.0, 3.38e38, 3.4e38, 1.17549435e-38,
                      np.inf, -np.inf, np.nan], np.float32)
    return np.concatenate([normals, -normals[:500], f16_sub, -f16_sub,
                           f32_sub, halfway, edges]).astype(np.float32)


@pytest.mark.parametrize("name", ["f16_roundtrip", "bf16_roundtrip"])
def test_roundtrips_bitwise_equal_to_jax_emulation(name):
    x = _edge_values()
    want = np.asarray(getattr(jp, name)(jnp.asarray(x)))
    got = getattr(tp, name)(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


@pytest.mark.parametrize("levels", [16, 64, 256])
def test_grid_quantize_matches_jax(levels):
    x = np.random.default_rng(levels).standard_normal((64, 3)).astype(
        np.float32)
    want = np.asarray(jp.grid_quantize(jnp.asarray(x), levels))
    got = tp.grid_quantize(torch.from_numpy(x), levels).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # external bounds, and the degenerate (constant) range passes through
    want = np.asarray(jp.grid_quantize(jnp.asarray(x), levels, lo=-1.0,
                                       hi=2.0))
    got = tp.grid_quantize(torch.from_numpy(x), levels, lo=-1.0,
                           hi=2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    const = np.full(5, 0.25, np.float32)
    assert np.array_equal(tp.grid_quantize(torch.from_numpy(const),
                                           levels).numpy(), const)


@pytest.mark.parametrize("levels", [16, 64, 256])
def test_grid_quantize_safe_matches_jax(levels):
    rng = np.random.default_rng(levels + 1)
    x = (10.0 ** rng.uniform(-4, 3, 500)).astype(np.float32)
    want = np.asarray(jp.grid_quantize_safe(jnp.asarray(x), levels, 0.01))
    got = tp.grid_quantize_safe(torch.from_numpy(x), levels, 0.01).numpy()
    # Widened from 1e-6: XLA:CPU's and torch's CPU logf / expf differ by
    # 1 ulp, and the grid's own bounds (min / max of log x, |log x| ~ 7)
    # carry that 1 ulp (~5e-7 absolute) into every snapped log, which exp
    # turns into ~5e-7 relative, plus exp's own ulp: measured 1.04e-6.
    np.testing.assert_allclose(got, want, rtol=2e-6)
    want = np.asarray(jp.grid_quantize_safe(jnp.asarray(x), levels, 0.01,
                                            log_lo=-4.0, log_hi=5.0))
    got = tp.grid_quantize_safe(torch.from_numpy(x), levels, 0.01,
                                log_lo=-4.0, log_hi=5.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.min() >= np.float32(0.01)


@pytest.mark.parametrize("mode", ["float32", "bf16", "f16", "int8", "int4",
                                  "custom"])
def test_quantize_hooks_match_jax(mode):
    rng = np.random.default_rng(7)
    force = (rng.standard_normal((200, 2)) * 3).astype(np.float32)
    d2 = (10.0 ** rng.uniform(-3, 3, (40, 40))).astype(np.float32)
    qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
    np.testing.assert_allclose(
        tp.quantize_force(torch.from_numpy(force), qt).numpy(),
        np.asarray(jp.quantize_force(jnp.asarray(force), qj)), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        tp.quantize_distance_squared(torch.from_numpy(d2), qt).numpy(),
        np.asarray(jp.quantize_distance_squared(jnp.asarray(d2), qj)),
        rtol=1e-6)


@pytest.mark.parametrize("softening_sq", [0.0, 0.0025, 0.01, 0.25])
@pytest.mark.parametrize("max_d2", [0.5, 1004.71423, 4.0e6])
def test_dist_sq_log_bounds_matches_jax(softening_sq, max_d2):
    for mode in ("int8", "int4", "custom"):
        qj, qt = jp.Quantizer.from_string(mode), tp.Quantizer.from_string(mode)
        want = jp.dist_sq_log_bounds(qj, jnp.float32(max_d2), softening_sq)
        got = tp.dist_sq_log_bounds(qt, torch.tensor(max_d2), softening_sq)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.dim() == 0
            np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


def test_mode_strings_match_jax():
    for alias in sorted(jp._ALIASES):
        assert (tp.get_mode_from_string(alias).value
                == jp.get_mode_from_string(alias).value)
        assert (tp.get_mode_from_string(f"  {alias.upper()} ",
                                        strict=True).value
                == jp.get_mode_from_string(alias).value)
    # reference behaviour: unknown strings fall back to the baseline
    assert tp.get_mode_from_string("nonsense") == tp.Precision.FLOAT64
    for mode in tp.Precision:
        assert tp.describe_mode(mode) != "unknown mode"


@pytest.mark.parametrize("bad", ["nonsense", "int2", "", "float128"])
def test_strict_mode_string_errors(bad):
    with pytest.raises(ValueError, match="unknown precision mode"):
        tp.get_mode_from_string(bad, strict=True)
    with pytest.raises(ValueError):
        jp.get_mode_from_string(bad, strict=True)


@pytest.mark.parametrize("mode", [m.value for m in jp.Precision])
def test_quantizer_properties_match_jax(mode):
    qj = jp.Quantizer(jp.Precision(mode), custom_levels=32)
    qt = tp.Quantizer(tp.Precision(mode), custom_levels=32)
    for prop in ("levels", "is_int", "is_float_cast", "is_noop"):
        assert getattr(qt, prop) == getattr(qj, prop), prop
    assert qt.min_dist_sq == qj.min_dist_sq
    assert hash(qt) == hash(tp.Quantizer(tp.Precision(mode),
                                         custom_levels=32))
