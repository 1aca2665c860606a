"""nbody_tpu_torch.ops.pm against nbody_tpu.ops.pm on the CPU.

The same numpy inputs go through the JAX function and the port's, for
D = 2 and 3. What is bit for bit and what is held to a tolerance, and why:

* the segment sum (the deposit kernel's plain version, ``index_add_`` in
  index order) is bitwise ``jax.ops.segment_sum``; so is ``ngp_deposit``,
  positions on the box edge and every particle in one cell included;
* ``cic_deposit`` and ``cic_gather`` are bitwise a numpy oracle of the
  written op order (u = p / box * n - 0.5, frac = u - i0, corner factors
  in d order from the weights). XLA:CPU does not keep that order: its
  simplifier folds ``/ box * n`` into ``* (n / box)`` and contracts the
  ``- 0.5`` into an FMA, so JAX's fractions differ from the port's by up
  to ~2 n 2^-24 absolute; against JAX the CIC results are held to
  rtol 1e-6 plus that fraction error times the mass (or |grid|) a cell
  gathers;
* the quantized k^2 grid: float modes bitwise, int modes under the rule of
  tests/test_torch_precision.py for grid_quantize_safe (rtol 2e-6);
* poisson_accel_grids: atol 1e-5 max|grid| (pocketfft and torch's FFT
  round differently), float32, int4 and bfloat16;
* P(k) rtol 1e-5, its bin centers rtol 1e-6; the linspace / logspace /
  fftfreq arithmetic and the dark-matter field bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import pm as jpm
from nbody_tpu.ops.precision import Quantizer as JQ
from nbody_tpu.ops.precision import quantize_distance_squared as jquantize
from nbody_tpu_torch.ops import pm as tpm
from nbody_tpu_torch.ops.precision import Quantizer as TQ

torch.set_num_threads(1)

GEOMS = [(2, 32, 100.0), (3, 16, 50.0)]   # (D, n_grid, box)


def _inputs(dim, box, n=3000, seed=0):
    rng = np.random.default_rng(seed + dim)
    pos = rng.uniform(0.0, box, (n, dim)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, w


def _edge_inputs(dim, box, n=400, seed=1):
    """Positions on the box edge, tiny negatives wrapped by Python-sign %,
    and the rest inside."""
    pos, w = _inputs(dim, box, n, seed)
    pos[:50] = np.float32(box)
    pos[50:100, 0] = np.float32(-1e-9) % np.float32(box)   # == box in f32
    pos[100:120] = np.float32(np.nextafter(np.float32(box), np.float32(0)))
    pos[120:140] = 0.0
    return pos, w


def _t(x):
    return torch.from_numpy(np.array(x))


def _cic_oracle(pos, w, n_grid, box, grids=None):
    """numpy float32 CIC deposit (grids=None) or gather in the port's
    written op order, sums in particle order."""
    f = np.float32
    u = pos / f(box) * f(n_grid) - f(0.5)
    i0 = np.floor(u).astype(np.int32)
    frac = u - i0.astype(f)
    dim = pos.shape[1]
    cells = n_grid ** dim
    out = (np.zeros(cells, f) if grids is None
           else np.zeros(pos.shape, f))
    for corner in range(2 ** dim):
        flat = np.zeros(pos.shape[0], np.int64)
        ww = w if grids is None else np.ones(pos.shape[0], f)
        for d in range(dim):
            o = (corner >> d) & 1
            ww = ww * (frac[:, d] if o else f(1) - frac[:, d])
            flat = flat * n_grid + (i0[:, d] + o) % n_grid
        if grids is None:
            s = np.zeros(cells, f)
            for c, x in zip(flat, ww):      # particle order
                s[c] = s[c] + x
            out = out + s
        else:
            vals = np.stack([g.reshape(-1)[flat] for g in grids], -1)
            out = out + ww[:, None] * vals
    return out if grids is not None else out.reshape((n_grid,) * dim)


def _cic_reach(pos, n_grid, box, values):
    """Per cell (deposit) the sum of |values| of the particles whose
    stencil touches it; the CIC fraction error's absolute bound per unit."""
    f = np.float32
    u = (pos / f(box) * f(n_grid) - f(0.5)).astype(np.float64)
    i0 = np.floor(u).astype(np.int64)
    dim = pos.shape[1]
    reach = np.zeros(n_grid ** dim)
    for corner in range(2 ** dim):
        flat = np.zeros(pos.shape[0], np.int64)
        for d in range(dim):
            flat = flat * n_grid + (i0[:, d] + ((corner >> d) & 1)) % n_grid
        np.add.at(reach, flat, np.abs(values))
    return reach.reshape((n_grid,) * dim)


def _frac_err(dim, n_grid):
    """Bound on |frac_JAX - frac_port| times the D factors it enters."""
    return 2.0 * dim * n_grid * 2.0 ** -24


# --------------------------------------------------------------------------
# Deposit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n, segments", [(1, 1), (500, 7), (4000, 4096),
                                         (3000, 64)])
def test_segment_sum_plain_is_jax_segment_sum_bitwise(n, segments):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, segments, n).astype(np.int32)
    w = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
         ).astype(np.float32)
    prev = rng.standard_normal(segments).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(w), jnp.asarray(keys),
                                          num_segments=segments))
    got = tpm.segment_sum(_t(keys), _t(w), segments).numpy()
    np.testing.assert_array_equal(got, want)
    want_prev = np.asarray(jnp.asarray(prev) + want)
    got_prev = tpm.segment_sum(_t(keys), _t(w), segments, _t(prev)).numpy()
    np.testing.assert_array_equal(got_prev, want_prev)


def test_segment_sum_rejects_bad_arguments():
    keys, w = torch.zeros(4, dtype=torch.int32), torch.ones(4)
    with pytest.raises(ValueError):
        tpm.segment_sum(keys.long(), w, 4)
    with pytest.raises(ValueError):
        tpm.segment_sum(keys, w.double(), 4)
    with pytest.raises(ValueError):
        tpm.segment_sum(keys, w, 0)
    with pytest.raises(ValueError):
        tpm.segment_sum(keys, w, 4, prev=torch.zeros(3))


@pytest.mark.parametrize("layout", ["uniform", "edge", "one_cell"])
@pytest.mark.parametrize("dim, n_grid, box", GEOMS)
def test_ngp_deposit_bitwise(dim, n_grid, box, layout):
    if layout == "edge":
        pos, w = _edge_inputs(dim, box)
    else:
        pos, w = _inputs(dim, box)
        if layout == "one_cell":
            pos[:] = np.float32(box * 0.3)
    want = np.asarray(jpm.ngp_deposit(jnp.asarray(pos), jnp.asarray(w),
                                      n_grid, box))
    got = tpm.ngp_deposit(_t(pos), _t(w), n_grid, box).numpy()
    np.testing.assert_array_equal(got, want)
    if layout == "edge":
        flat, ij = tpm.cell_index(_t(pos), box, n_grid)
        # the box edge and the wrapped tiny negatives land in cell 0
        assert (flat[:50] == 0).all() and (ij[50:100, 0] == 0).all()
        assert (flat[100:120] == n_grid ** dim - 1).all()


@pytest.mark.parametrize("layout", ["uniform", "edge", "one_cell"])
@pytest.mark.parametrize("dim, n_grid, box", GEOMS)
def test_cic_deposit_bitwise_oracle_and_jax(dim, n_grid, box, layout):
    if layout == "edge":
        pos, w = _edge_inputs(dim, box)
    else:
        pos, w = _inputs(dim, box, n=800)
        if layout == "one_cell":
            pos[:] = np.float32(box * 0.3)
    got = tpm.cic_deposit(_t(pos), _t(w), n_grid, box).numpy()
    np.testing.assert_array_equal(got, _cic_oracle(pos, w, n_grid, box))
    want = np.asarray(jpm.cic_deposit(jnp.asarray(pos), jnp.asarray(w),
                                      n_grid, box))
    bound = (1e-6 * np.abs(want)
             + _frac_err(dim, n_grid) * _cic_reach(pos, n_grid, box, w))
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


# --------------------------------------------------------------------------
# Array-creation arithmetic and constant fields
# --------------------------------------------------------------------------

@pytest.mark.parametrize("box, n", [(200.0, 128), (100.0, 32), (400.0, 256),
                                    (50.0, 16), (200.0, 64)])
def test_linspace_fftfreq_dm_field_bitwise(box, n):
    np.testing.assert_array_equal(tpm.jax_linspace(0.0, box, n),
                                  np.asarray(jnp.linspace(0.0, box, n)))
    np.testing.assert_array_equal(tpm.jax_fftfreq(n, box / n),
                                  np.asarray(jnp.fft.fftfreq(n, d=box / n)))
    np.testing.assert_array_equal(tpm.jax_rfftfreq(n, box / n),
                                  np.asarray(jnp.fft.rfftfreq(n, d=box / n)))
    for dim in (2, 3) if n <= 64 else (2,):
        np.testing.assert_array_equal(
            tpm.dm_background_field(box, n, 5.0, dim).numpy(),
            np.asarray(jpm.dm_background_field(box, n, 5.0, dim)))


# --------------------------------------------------------------------------
# Poisson solve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["float32", "bfloat16", "float16", "int8",
                                  "int4", "custom"])
@pytest.mark.parametrize("dim, n_grid, box", GEOMS)
def test_quantized_k_sq_matches_jax(dim, n_grid, box, mode):
    ks = jpm._rk_vectors(n_grid, box, dim)
    k_sq = sum(k * k for k in ks) + 1e-10
    want = np.asarray(jquantize(k_sq.astype(jnp.float32),
                                JQ.from_string(mode)))
    got = tpm.quantized_k_sq(n_grid, box, dim, TQ.from_string(mode)).numpy()
    if TQ.from_string(mode).is_int:
        # tests/test_torch_precision.py's grid_quantize_safe rule
        np.testing.assert_allclose(got, want, rtol=2e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["float32", "int4", "bfloat16"])
@pytest.mark.parametrize("dim, n_grid, box", GEOMS)
def test_poisson_accel_grids_matches_jax(dim, n_grid, box, mode):
    pos, w = _inputs(dim, box)
    density = np.asarray(jpm.cic_deposit(jnp.asarray(pos), jnp.asarray(w),
                                         n_grid, box))
    G, scale = 2.5e6, 0.4
    want = jpm.poisson_accel_grids(jnp.asarray(density), box, n_grid,
                                   JQ.from_string(mode), G, scale, dim)
    got = tpm.poisson_accel_grids(_t(density), box, n_grid,
                                  TQ.from_string(mode), G, scale, dim)
    assert len(got) == dim
    for g, wj in zip(got, want):
        wj = np.asarray(wj)
        np.testing.assert_allclose(g.numpy(), wj, rtol=0,
                                   atol=1e-5 * np.abs(wj).max())
    # a 0-d tensor scale (the engine's schedule entry) gives the same bits
    again = tpm.poisson_accel_grids(_t(density), box, n_grid,
                                    TQ.from_string(mode), G,
                                    torch.tensor(scale), dim)
    for a, b in zip(again, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_poisson_point_mass_attracts():
    n_grid, box = 64, 100.0
    density = torch.ones((n_grid, n_grid))
    density[32, 32] += 1000.0
    ax, ay = tpm.poisson_accel_grids(density, box, n_grid, TQ(), G=1.0,
                                     scale=1.0, dim=2)
    assert float(ax[20, 32]) > 0 > float(ax[44, 32])
    assert float(ay[32, 20]) > 0


# --------------------------------------------------------------------------
# Gathers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dim, n_grid, box", GEOMS)
def test_gathers_on_the_same_grids(dim, n_grid, box):
    pos, _ = _edge_inputs(dim, box)
    rng = np.random.default_rng(dim)
    grids = [rng.standard_normal((n_grid,) * dim).astype(np.float32)
             for _ in range(dim)]
    ngp_want = np.asarray(jpm.ngp_gather([jnp.asarray(g) for g in grids],
                                         jnp.asarray(pos), n_grid, box))
    ngp_got = tpm.ngp_gather([_t(g) for g in grids], _t(pos), n_grid,
                             box).numpy()
    np.testing.assert_array_equal(ngp_got, ngp_want)

    cic_got = tpm.cic_gather([_t(g) for g in grids], _t(pos), n_grid,
                             box).numpy()
    np.testing.assert_array_equal(
        cic_got, _cic_oracle(pos, None, n_grid, box, grids=grids))
    cic_want = np.asarray(jpm.cic_gather([jnp.asarray(g) for g in grids],
                                         jnp.asarray(pos), n_grid, box))
    gmax = max(float(np.abs(g).max()) for g in grids)
    bound = (1e-6 * np.abs(cic_want)
             + _frac_err(dim, n_grid) * 2 ** dim * gmax)
    assert np.all(np.abs(cic_got - cic_want) <= bound)


# --------------------------------------------------------------------------
# Structure measurements
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_bins", [20, 12])
@pytest.mark.parametrize("dim, n_grid, box", GEOMS)
def test_power_spectrum_matches_jax(dim, n_grid, box, num_bins):
    pos, _ = _inputs(dim, box)
    kj, pj = jpm.power_spectrum(jnp.asarray(pos), box, n_grid, num_bins)
    kt, pt = tpm.power_spectrum(_t(pos), box, n_grid, num_bins)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5)
    assert (pt.numpy() > 0).any()
    # pk_from_density on the same grid
    density = np.asarray(jpm.ngp_deposit(
        jnp.asarray(pos), jnp.ones(pos.shape[0]), n_grid, box))
    kj2, pj2 = jpm.pk_from_density(jnp.asarray(density), box, num_bins)
    kt2, pt2 = tpm.pk_from_density(_t(density), box, num_bins)
    np.testing.assert_allclose(kt2.numpy(), np.asarray(kj2), rtol=1e-6)
    np.testing.assert_allclose(pt2.numpy(), np.asarray(pj2), rtol=1e-5)
    assert tpm.bao_scale_from_pk(kt, pt) == pytest.approx(
        jpm.bao_scale_from_pk(kj, pj), rel=1e-6)


@pytest.mark.parametrize("dim, n_grid, box", GEOMS)
def test_clustering_metric_matches_jax(dim, n_grid, box):
    pos, _ = _inputs(dim, box)
    pos[:500] = pos[:500] * np.float32(0.1)   # a clump
    want = float(jpm.clustering_metric(jnp.asarray(pos), box, n_grid))
    got = float(tpm.clustering_metric(_t(pos), box, n_grid))
    assert got == pytest.approx(want, rel=1e-6)


def test_bao_scale_from_pk_host_helper():
    k = np.linspace(0.005, 0.3, 30).astype(np.float32)
    pk = np.exp(-((k - 0.06) / 0.02) ** 2).astype(np.float32)
    assert tpm.bao_scale_from_pk(k, pk) == jpm.bao_scale_from_pk(k, pk)
    assert tpm.bao_scale_from_pk(_t(k), _t(pk)) == \
        jpm.bao_scale_from_pk(k, pk)
    assert tpm.bao_scale_from_pk(k[:3], pk[:3]) == 0.0
