"""The port's copy of the SGP4/SDP4 core (nbody_tpu_torch/experiments/
_sgp4.py) on the cases of tests/test_sgp4.py, and against the JAX
package's copy: every fixture TLE and the published verification TLEs
propagate to the same states bit for bit (the copy's code is unchanged;
only a header comment names its source).

Two oracle classes, as in tests/test_sgp4.py: the published Spacetrack
Report #3 verification positions (sat 88888 near-Earth, sat 11801
deep-space), and physics (orbit geometry from the TLE itself, J2 analytic
secular rates, Kepler's third law, drag-decay sign, lunisolar-periodic
boundedness, 12h/24h resonance stability).
"""

import math

import numpy as np
import pytest

from nbody_tpu.experiments import _sgp4 as jax_sgp4
from nbody_tpu_torch.experiments import _sgp4
from nbody_tpu_torch.experiments.orbital_audit import (
    TLE_FIXTURES,
    kepler_j2_reference,
    parse_tle,
)

ISS_L1, ISS_L2 = TLE_FIXTURES["ISS"]


@pytest.fixture(scope="module")
def iss():
    return _sgp4.SGP4(_sgp4.elements_from_tle(ISS_L1, ISS_L2))


def test_tle_exp_field_parsing():
    assert _sgp4._parse_exp_field(" 10270-3") == pytest.approx(0.10270e-3)
    assert _sgp4._parse_exp_field("-11606-4") == pytest.approx(-0.11606e-4)
    assert _sgp4._parse_exp_field(" 00000+0") == 0.0
    assert _sgp4._parse_exp_field(" 00000-0") == 0.0


def test_iss_epoch_state_geometry(iss):
    pos, vel = iss.propagate(0.0)
    r = math.sqrt(sum(x * x for x in pos))
    v = math.sqrt(sum(x * x for x in vel))
    # ISS: ~420 km altitude, ~7.66 km/s circular speed
    assert 6700.0 < r < 6850.0, r
    assert 7.5 < v < 7.8, v
    # inclination from the angular momentum vector
    h = np.cross(pos, vel)
    inc = math.degrees(math.acos(h[2] / np.linalg.norm(h)))
    assert abs(inc - 51.64) < 0.2, inc


def test_iss_orbital_period_keplers_third_law(iss):
    """Radial distance returns to its initial value after one period
    implied by the recovered Brouwer mean motion."""
    period_min = iss.period_min
    assert abs(period_min - 1440.0 / 15.4955) < 0.5
    r0 = np.linalg.norm(iss.propagate(0.0)[0])
    r1 = np.linalg.norm(iss.propagate(period_min)[0])
    r_half = np.linalg.norm(iss.propagate(period_min / 2)[0])
    assert abs(r1 - r0) < 5.0  # back to the same radius
    # eccentric orbit: half period is measurably different (apsis swap)
    assert abs(r_half - r0) > abs(r1 - r0)


def test_iss_nodal_regression_matches_j2_analytic(iss):
    """Secular RAAN rate vs the textbook J2 formula (~-5 deg/day for
    the ISS)."""
    el = iss.el
    a = iss.aodp * _sgp4.XKMPER
    n = iss.xnodp / 60.0  # rad/s
    p = a * (1 - el.ecco ** 2)
    analytic = (-1.5 * _sgp4.J2 * (_sgp4.XKMPER / p) ** 2
                * n * math.cos(el.inclo))  # rad/s
    got = iss.nodedot / 60.0  # rad/s
    assert got == pytest.approx(analytic, rel=0.02)
    deg_day = math.degrees(got) * 86400
    assert -5.5 < deg_day < -4.5, deg_day


def test_iss_drag_decays_orbit(iss):
    """Positive B* must shrink the orbit monotonically over days."""
    day = 1440.0
    r_mean = []
    for k in range(3):
        rs = [np.linalg.norm(iss.propagate(k * day + f)[0])
              for f in np.linspace(0, iss.period_min, 32, endpoint=False)]
        r_mean.append(np.mean(rs))
    assert r_mean[0] > r_mean[1] > r_mean[2]
    # ISS-magnitude decay: hundreds of metres to a few km per day
    assert 0.01 < (r_mean[0] - r_mean[2]) / 2 < 5.0


def test_sgp4_tracks_kepler_j2_oracle_iss():
    """Over 3 h the two oracles (SGP4 vs Keplerian+J2-secular) model the
    same dominant physics and must agree to tens of km; a frame or
    Kepler-solve bug would diverge by thousands."""
    times = [600.0 * k for k in range(1, 19)]  # 10 min .. 3 h
    sgp4_pos = _sgp4.sgp4_ephemeris(ISS_L1, ISS_L2, times)
    el = parse_tle(ISS_L1, ISS_L2)
    j2_pos = kepler_j2_reference(el, times)
    sep = np.linalg.norm(sgp4_pos - j2_pos, axis=1)
    assert sep.max() < 100.0, sep.max()


# --------------------------------------------------------------------------
# Deep-space (SDP4) branch: GPS / LAGEOS fixtures + geosync / Molniya
# resonance cases (closes the round-3 scope cut; reference wraps the sgp4
# library for these, reference: orbital_audit.py:75-82, 147-182)
# --------------------------------------------------------------------------

GEO_L1 = ("1 19548U 88091B   24001.50000000 -.00000280  00000-0  "
          "00000+0 0  9997")
GEO_L2 = ("2 19548  13.5000  10.0000 0003000 100.0000 250.0000 "
          " 1.00270000130000")
MOLNIYA_L1 = ("1 08195U 75081A   24001.50000000  .00000099  00000-0  "
              "00000+0 0  9996")
MOLNIYA_L2 = ("2 08195  64.1586 279.0717 6877146 264.7651  20.2257 "
              " 2.00491383225656")


def _mean_vis_viva_sma(prop, t0_min, t1_min, samples=64):
    """Mean semi-major axis from vis-viva over [t0, t1] minutes."""
    mu = _sgp4.XKE ** 2 * _sgp4.XKMPER ** 3 / 3600.0  # km^3/s^2
    vals = []
    for t in np.linspace(t0_min, t1_min, samples):
        pos, vel = prop.propagate(float(t))
        r = np.linalg.norm(pos)
        v = np.linalg.norm(vel)
        vals.append(1.0 / (2.0 / r - v * v / mu))
    return float(np.mean(vals))


def test_spacetrack3_near_earth_verification_case():
    """Published Spacetrack Report #3 near-Earth test (sat 88888,
    WGS-72): positions must match the report's printed values to ~10 m.
    This is the strongest available oracle — the same fixture every
    public SGP4 implementation verifies against."""
    l1 = ("1 88888U          80275.98708465  .00073094  13844-3  "
          "66816-4 0    87")
    l2 = ("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 "
          "16.05824518  105")
    prop = _sgp4.SGP4(_sgp4.elements_from_tle(l1, l2))
    assert not prop.is_deep_space
    expect = {0.0: (2328.97, -5995.22, 1719.97),
              360.0: (2456.11, -6071.94, 1222.90)}
    for t, exp in expect.items():
        pos, _ = prop.propagate(t)
        assert np.linalg.norm(np.asarray(pos) - np.asarray(exp)) < 0.05


def test_spacetrack3_deep_space_verification_case():
    """Published Spacetrack Report #3 deep-space test (sat 11801,
    e=0.73, 10.5 h period): the SDP4 branch (lunisolar secular +
    periodics) must match the report's printed positions to ~50 m over
    18 h. Caught a Kepler-solve sign flip invisible at ISS
    eccentricities (2 km there, 20,000 km here)."""
    l1 = ("1 11801U          80230.29629788  .01431103  00000-0  "
          "14311-1      13")
    l2 = ("2 11801  46.7916 230.4354 7318036  47.4722  10.4117  "
          "2.28537848    13")
    prop = _sgp4.SGP4(_sgp4.elements_from_tle(l1, l2))
    assert prop.is_deep_space
    expect = {0.0: (7473.37, 428.95, 5828.75),
              360.0: (-3305.22, 32410.86, -24697.18),
              720.0: (14271.29, 24110.46, -4725.77),
              1080.0: (-9990.06, 22717.36, -23616.89)}
    for t, exp in expect.items():
        pos, _ = prop.propagate(t)
        assert np.linalg.norm(np.asarray(pos) - np.asarray(exp)) < 0.05, t


def test_deep_space_tles_take_sdp4_branch():
    for name in ("GPS-IIR-2", "LAGEOS-1"):
        l1, l2 = TLE_FIXTURES[name]
        assert _sgp4.is_deep_space(l1, l2)
        pos = _sgp4.sgp4_ephemeris(l1, l2, [0.0, 3600.0, 86400.0])
        assert np.isfinite(pos).all()
    assert not _sgp4.is_deep_space(ISS_L1, ISS_L2)


def test_gps_semi_major_axis_and_period():
    """GPS: 12 h (sidereal-half) orbit at a ~26560 km semi-major axis;
    the SDP4 output must satisfy Kepler III against the TLE mean
    motion."""
    l1, l2 = TLE_FIXTURES["GPS-IIR-2"]
    prop = _sgp4.SGP4(_sgp4.elements_from_tle(l1, l2))
    assert prop.is_deep_space
    assert abs(prop.period_min - 1440.0 / 2.005619) < 1.0
    a = _mean_vis_viva_sma(prop, 0.0, 2.0 * prop.period_min)
    assert abs(a - 26560.0) < 120.0, a
    # radial return after one period (near-circular, e=0.008)
    r0 = np.linalg.norm(prop.propagate(0.0)[0])
    r1 = np.linalg.norm(prop.propagate(prop.period_min)[0])
    assert abs(r1 - r0) < 30.0


def test_lageos_raan_regression_sign_and_rate():
    """LAGEOS-1 is retrograde (i=109.85 deg) so J2 makes RAAN ADVANCE
    (positive rate, ~+0.34 deg/day); checked from the ascending-node
    longitude of the angular-momentum vector over 6 days."""
    l1, l2 = TLE_FIXTURES["LAGEOS-1"]
    prop = _sgp4.SGP4(_sgp4.elements_from_tle(l1, l2))
    assert prop.is_deep_space

    def raan_deg(t_min):
        pos, vel = prop.propagate(t_min)
        h = np.cross(pos, vel)
        # ascending node vector n = z-hat x h
        return math.degrees(math.atan2(h[0], -h[1]))

    d0, d6 = raan_deg(0.0), raan_deg(6.0 * 1440.0)
    drift = (d6 - d0 + 180.0) % 360.0 - 180.0
    rate = drift / 6.0
    assert 0.1 < rate < 0.6, rate  # analytic J2: +0.343 deg/day


def test_geosync_24h_resonance_stable():
    """Geosynchronous TLE exercises the 24 h resonance (del1..del3)
    integrator: over 30 days the semi-major axis must stay within the
    geosync band (no runaway from the Euler-integrated resonance
    terms) and the orbit must remain finite."""
    prop = _sgp4.SGP4(_sgp4.elements_from_tle(GEO_L1, GEO_L2))
    assert prop.is_deep_space and prop.irez == 1
    a_early = _mean_vis_viva_sma(prop, 0.0, 1440.0)
    a_late = _mean_vis_viva_sma(prop, 29.0 * 1440.0, 30.0 * 1440.0)
    assert abs(a_early - 42164.0) < 80.0, a_early
    assert abs(a_late - a_early) < 40.0, (a_early, a_late)


def test_molniya_12h_resonance_stable():
    """Molniya TLE (12 h, e=0.688, i=64.2 deg) exercises the 12 h
    eccentric resonance (d2201..d5433): geometry must hold over 10
    days — perigee/apogee band, critical-inclination argp freeze."""
    prop = _sgp4.SGP4(_sgp4.elements_from_tle(MOLNIYA_L1, MOLNIYA_L2))
    assert prop.is_deep_space and prop.irez == 2
    rs = []
    for t in np.linspace(0.0, 10.0 * 1440.0, 2000):
        pos, _ = prop.propagate(float(t))
        rs.append(np.linalg.norm(pos))
    rs = np.asarray(rs)
    assert np.isfinite(rs).all()
    assert 6900.0 < rs.min() < 11000.0, rs.min()   # perigee band
    assert 43000.0 < rs.max() < 48500.0, rs.max()  # apogee band


def test_sdp4_tracks_kepler_j2_oracle_short_horizon():
    """Over 3 h the SDP4 branch and the Keplerian+J2 oracle model the
    same dominant physics for GPS — agreement to ~tens of km bounds
    frame and resonance-integration bugs (lunisolar perturbations are
    ~km-scale at that horizon)."""
    l1, l2 = TLE_FIXTURES["GPS-IIR-2"]
    times = [600.0 * k for k in range(1, 19)]
    sdp4_pos = _sgp4.sgp4_ephemeris(l1, l2, times)
    el = parse_tle(l1, l2)
    j2_pos = kepler_j2_reference(el, times)
    sep = np.linalg.norm(sdp4_pos - j2_pos, axis=1)
    assert sep.max() < 120.0, sep.max()


def test_lunisolar_periodics_applied_at_output():
    """_dpper periodics must be anchored at epoch (zero correction at
    t=0) and bounded: the inclination wobble over a year stays under a
    degree for GPS."""
    l1, l2 = TLE_FIXTURES["GPS-IIR-2"]
    prop = _sgp4.SGP4(_sgp4.elements_from_tle(l1, l2))
    incs = []
    for t in np.linspace(0.0, 365.0 * 1440.0, 400):
        pos, vel = prop.propagate(float(t))
        h = np.cross(pos, vel)
        incs.append(math.degrees(math.acos(h[2] / np.linalg.norm(h))))
    incs = np.asarray(incs)
    assert abs(incs[0] - 55.0) < 0.1, incs[0]
    assert np.ptp(incs) < 1.5, np.ptp(incs)


def test_low_perigee_simplified_branch():
    """A sub-220 km-perigee TLE exercises the simplified-drag branch."""
    l1 = ("1 99999U 24001A   24001.50000000  .00050000  00000-0  "
          "20000-3 0  9991")
    l2 = ("2 99999  28.5000 100.0000 0012000  50.0000 310.0000 "
          "16.20000000    12")
    prop = _sgp4.SGP4(_sgp4.elements_from_tle(l1, l2))
    assert prop.simple
    pos, vel = prop.propagate(30.0)
    r = np.linalg.norm(pos)
    assert 6500.0 < r < 6800.0
    assert np.isfinite(pos).all() and np.isfinite(vel).all()


def test_reference_ephemeris_falls_back_on_propagator_failure(monkeypatch):
    """A pathological TLE that raises inside SGP4/SDP4 (e.g. perturbed
    eccentricity drifting out of range over the horizon) must not abort
    the audit: reference_ephemeris falls back to the Kepler+J2 oracle
    and labels it honestly (reference behavior: the library wrapper's
    audit always completes a row, orbital_audit.py:147-182)."""
    from nbody_tpu_torch.experiments import _sgp4 as sgp4_mod
    from nbody_tpu_torch.experiments import orbital_audit

    def boom(self, tsince_min):
        raise RuntimeError("SDP4: eccentricity out of range 1.01")

    monkeypatch.setattr(sgp4_mod.SGP4, "propagate", boom)
    el = orbital_audit.parse_tle(ISS_L1, ISS_L2)
    times = np.linspace(0.0, 3600.0, 7)
    pos, oracle = orbital_audit.reference_ephemeris(
        el, ISS_L1, ISS_L2, times)
    assert oracle == "kepler_j2(fallback)"
    assert pos.shape == (7, 3)
    assert np.isfinite(pos).all()


# --------------------------------------------------------------------------
# The port's copy against the JAX package's, bit for bit
# --------------------------------------------------------------------------

SPACETRACK = {
    "88888": ("1 88888U          80275.98708465  .00073094  13844-3  "
              "66816-4 0    87",
              "2 88888  72.8435 115.9689 0086731  52.6988 110.5714 "
              "16.05824518  105"),
    "11801": ("1 11801U          80230.29629788  .01431103  00000-0  "
              "14311-1      13",
              "2 11801  46.7916 230.4354 7318036  47.4722  10.4117  "
              "2.28537848    13"),
    "geo": (GEO_L1, GEO_L2),
    "molniya": (MOLNIYA_L1, MOLNIYA_L2),
}


@pytest.mark.parametrize("name", sorted(TLE_FIXTURES) + sorted(SPACETRACK))
def test_copy_propagates_bit_for_bit(name):
    l1, l2 = {**TLE_FIXTURES, **SPACETRACK}[name]
    mine = _sgp4.SGP4(_sgp4.elements_from_tle(l1, l2))
    theirs = jax_sgp4.SGP4(jax_sgp4.elements_from_tle(l1, l2))
    assert mine.is_deep_space == theirs.is_deep_space
    for t in np.linspace(0.0, 3.0 * 1440.0, 37):
        got, want = mine.propagate(float(t)), theirs.propagate(float(t))
        assert got == want, (name, t)
    times = [600.0 * k for k in range(1, 19)]
    np.testing.assert_array_equal(_sgp4.sgp4_ephemeris(l1, l2, times),
                                  jax_sgp4.sgp4_ephemeris(l1, l2, times))


def test_copy_code_is_the_jax_copy():
    """The port's file is the JAX package's with a header comment."""
    from pathlib import Path
    mine = Path(_sgp4.__file__).read_text().splitlines()
    theirs = Path(jax_sgp4.__file__).read_text().splitlines()
    header = [ln for ln in mine[:len(mine) - len(theirs)]]
    assert header and all(ln.startswith("#") for ln in header)
    assert mine[len(header):] == theirs
