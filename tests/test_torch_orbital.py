"""nbody_tpu_torch.experiments.orbital_audit against
nbody_tpu.experiments.orbital_audit, on the CPU.

* Host functions exactly: ``parse_tle``, ``elements_to_state``,
  ``kepler_j2_reference``, ``reference_ephemeris`` (the port's _sgp4 copy,
  with its oracle label) and the flop audit, on every fixture TLE.
* ``propagate_rk4`` on the same float32 state as JAX's jitted double scan:
  float32, bfloat16, float16, int8 and int4, counters equal. The port and
  JAX round different operations (r^3, r^5, the three-term sum of r^2), so
  the samples are held at rtol 2e-5 of the orbit's radius over 720 steps
  (measured: 2.3e-6 in float32, 2.8e-9 in float16); for the int rungs
  the samples' log-grid bins of r^2 are counted against JAX's (bin flips,
  0 here) and held at the same rtol while none flipped.
* The device counters: a start at the origin underflows and overflows on
  every step, as in JAX.
* The audits at their own sizes against JAX: the TLE drift audit over
  30 minutes (drifts within 1e-3 km + rtol 1e-4), the telemetry audit
  (perigee / apogee at rtol 1e-5, correlations within 1e-3), the
  Lense-Thirring rates and its verdict: float32's within 5 mas/yr (a
  fit near 0), the int rungs' ~1e8 mas/yr precession within 10% of
  JAX's (tests/test_torch_direct.py's int-rung rule: over 4320 steps the
  lattice amplifies the rounding differences above; measured 1.5% for
  int8, 0.2% for int4).
* tests/test_experiments_smoke.py's flop-cost and TLE-fallback cases on
  the port (the fetch's ``urlopen`` patched: no case reaches the
  network); ``main --quick`` with ``--device cpu`` at a reduced
  Lense-Thirring / telemetry size; without a card ``main`` raises.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.experiments import orbital_audit as jo
from nbody_tpu.ops.precision import Precision as JP
from nbody_tpu.ops.precision import Quantizer as JQ
from nbody_tpu_torch.experiments import orbital_audit as to
from nbody_tpu_torch.ops.precision import Precision as TP
from nbody_tpu_torch.ops.precision import Quantizer as TQ

torch.set_num_threads(1)

FIXTURES = sorted(to.TLE_FIXTURES)
RK4_RTOL = 2e-5


def test_fixtures_equal_jax():
    assert to.TLE_FIXTURES == jo.TLE_FIXTURES
    for k in ("MU_EARTH", "R_EARTH", "J2_EARTH", "GPB_FRAME_DRAG_MAS_YR",
              "GPB_ERROR_MAS_YR", "CELESTRAK_URL"):
        assert getattr(to, k) == getattr(jo, k)


@pytest.mark.parametrize("name", FIXTURES)
def test_host_functions_equal_jax(name):
    l1, l2 = to.TLE_FIXTURES[name]
    el = to.parse_tle(l1, l2)
    assert el == jo.parse_tle(l1, l2)
    for a, b in zip(to.elements_to_state(el), jo.elements_to_state(el)):
        np.testing.assert_array_equal(a, b)
    times = [600.0 * k for k in range(1, 13)]
    np.testing.assert_array_equal(to.kepler_j2_reference(el, times),
                                  jo.kepler_j2_reference(el, times))
    got, got_oracle = to.reference_ephemeris(el, l1, l2, times)
    want, want_oracle = jo.reference_ephemeris(el, l1, l2, times)
    assert got_oracle == want_oracle
    np.testing.assert_array_equal(got, want)


def test_flop_cost_equals_jax():
    """tests/test_experiments_smoke.py's flop-cost case on the port."""
    rep = to.flop_cost_audit()
    assert rep == jo.flop_cost_audit()
    assert rep["ratio"] > 1


def _r2_bins(samples: np.ndarray, levels: int) -> np.ndarray:
    """Each sample's bin on _accel's log grid of r^2."""
    lo, hi = math.log(to.R_EARTH ** 2), math.log((20 * to.R_EARTH) ** 2)
    r2 = np.maximum((samples.astype(np.float64) ** 2).sum(1),
                    to.R_EARTH ** 2)
    return np.round((np.log(r2) - lo) / (hi - lo) * (levels - 1))


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "float16",
                                  "int8_sim", "int4_sim"])
@pytest.mark.parametrize("name", ["ISS", "GPS-IIR-2"])
def test_propagate_rk4_matches_jax(mode, name):
    el = to.parse_tle(*to.TLE_FIXTURES[name])
    p0, v0 = to.elements_to_state(el)
    want, j_under, j_over = jo.propagate_rk4(
        jnp.asarray(p0, jnp.float32), jnp.asarray(v0, jnp.float32), 10.0,
        JQ(JP(mode)), 720, 14)
    got, t_under, t_over = to.propagate_rk4(p0, v0, 10.0, TQ(TP(mode)),
                                            720, 14, device="cpu")
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape == (51, 3)
    assert (int(t_under), int(t_over)) == (int(j_under), int(j_over)) \
        == (0, 0)
    got = got.numpy()
    q = TQ(TP(mode))
    if q.is_int:
        flips = int((_r2_bins(got, q.levels)
                     != _r2_bins(want, q.levels)).sum())
        assert flips == 0, f"{flips} int-grid bin flips of {len(got)}"
    scale = np.linalg.norm(want, axis=1).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=RK4_RTOL * scale)


def test_propagate_counts_underflow_and_overflow():
    zero = np.zeros(3)
    got, under, over = to.propagate_rk4(zero, zero, 10.0, TQ(), 6, 2,
                                        device="cpu")
    want, j_under, j_over = jo.propagate_rk4(
        jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32), 10.0, JQ(),
        6, 2)
    assert (int(under), int(over)) == (int(j_under), int(j_over))
    assert int(over) == 6
    assert np.isnan(got.numpy()).all() == np.isnan(np.asarray(want)).all()


def test_propagate_rk4_keeps_counters_on_the_device():
    el = to.parse_tle(*to.TLE_FIXTURES["ISS"])
    samples, under, over = to.propagate_rk4(
        *to.elements_to_state(el), 10.0, TQ(TP.INT4_SIM), 40, 10,
        device="cpu")
    for t in (samples, under, over):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert under.dtype == over.dtype == torch.int32 and under.dim() == 0


def test_tle_drift_audit_matches_jax():
    want = jo.tle_drift_audit(duration_hours=0.5)
    got = to.tle_drift_audit(duration_hours=0.5, device="cpu")
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w)
        assert g["elements"] == w["elements"] and g["oracle"] == w["oracle"]
        for mode in ("float32", "float16", "int4_sim"):
            for k in ("final_drift_km", "max_drift_km"):
                assert g[mode][k] == pytest.approx(w[mode][k], rel=1e-4,
                                                   abs=1e-3), (name, mode)
            assert (g[mode]["underflows"], g[mode]["overflows"]) == (
                w[mode]["underflows"], w[mode]["overflows"])
        assert g["int4_signature"] == pytest.approx(w["int4_signature"],
                                                    rel=1e-3)


def test_telemetry_audit_matches_jax():
    want = jo.telemetry_glitch_audit()
    got = to.telemetry_glitch_audit(device="cpu")
    assert list(got) == list(want)
    for mode, w in want.items():
        for k in ("perigee_km", "apogee_km"):
            assert got[mode][k] == pytest.approx(w[k], rel=1e-5)
        assert abs(got[mode]["jerk_perigee_correlation"]
                   - w["jerk_perigee_correlation"]) <= 1e-3


def test_lense_thirring_audit_matches_jax():
    want = jo.lense_thirring_audit()
    got = to.lense_thirring_audit(device="cpu")
    assert set(got) == set(want)
    assert list(got["rates_mas_yr"]) == list(want["rates_mas_yr"])
    for mode, w in want["rates_mas_yr"].items():
        # the int rungs' rule of tests/test_torch_direct.py: 10% of JAX's
        rel = 0.1 if mode.startswith("int") else 1e-2
        assert got["rates_mas_yr"][mode] == pytest.approx(w, rel=rel,
                                                          abs=5.0), mode
    assert got["within_gpb_band"] == want["within_gpb_band"]
    assert got["gpb_reference"] == want["gpb_reference"]


class _FakeResp:
    def __init__(self, payload: bytes):
        self.payload = payload

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def read(self):
        return self.payload


def test_orbital_tle_fetch_fallback(monkeypatch):
    """tests/test_experiments_smoke.py's fetch case on the port: any
    failure of the fetch falls back to the cached fixtures (the failure
    is made here: no case reaches the network); a successful fetch
    replaces the matching fixture only."""
    import urllib.request

    def offline(url, timeout):
        raise OSError("network is unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    tles, src = to.fetch_tles(timeout_s=0.2)
    assert tles == to.TLE_FIXTURES
    assert "cached fixtures" in src and "OSError" in src

    iss_l1 = ("1 25544U 98067A   24180.50000000  .00016717  00000-0  "
              "10270-3 0  9999")
    iss_l2 = ("2 25544  51.6400 100.0000 0006317  69.9862 290.2000 "
              "15.49550000430000")
    payload = f"ISS (ZARYA)\n{iss_l1}\n{iss_l2}\n".encode()
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout: _FakeResp(payload))
    tles, src = to.fetch_tles()
    assert tles["ISS"] == (iss_l1, iss_l2)
    assert tles["LAGEOS-1"] == to.TLE_FIXTURES["LAGEOS-1"]
    assert "live CelesTrak" in src

    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout: _FakeResp(b"NOAA 19\n1 x\n2 y\n"))
    tles, src = to.fetch_tles()
    assert tles == to.TLE_FIXTURES and "no matching sats" in src


def test_main_quick_on_the_cpu(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(to, "lense_thirring_audit",
                        lambda device=None: calls.append(device) or
                        {"rates_mas_yr": {}, "stub": True})
    monkeypatch.setattr(to, "telemetry_glitch_audit",
                        lambda device=None: calls.append(device) or {})
    rep = to.main(["--quick", "--device", "cpu", "--output", str(tmp_path)])
    saved = json.loads((tmp_path / "orbital_audit_report.json").read_text())
    assert set(saved) == {"tle_drift", "lense_thirring",
                          "telemetry_glitches", "flop_cost", "tle_source",
                          "notes", "score"}
    assert [str(d) for d in calls] == ["cpu", "cpu"]
    assert saved["tle_source"] == "cached fixtures (--fetch not set)"
    assert set(rep["tle_drift"]) == set(to.TLE_FIXTURES)
    assert np.isfinite(rep["score"]["mean_int4_drift_amplification"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to.main(["--quick", "--output", str(tmp_path)])
    assert not any(tmp_path.iterdir())
