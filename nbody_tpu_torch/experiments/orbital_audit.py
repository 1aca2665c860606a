"""Orbital audit: real-satellite dynamics vs precision-degraded physics.

PyTorch counterpart of ``nbody_tpu.experiments.orbital_audit``
(reference: orbital_audit.py:75-1156):

* TLEs: the in-file fixtures; ``--fetch`` tries CelesTrak and falls back
  to the fixtures on any failure (reference: :89-111, :337-340);
* the ephemeris oracle is the port's own copy of the SGP4/SDP4 core
  (``experiments/_sgp4.py``: Spacetrack Report #3 near-Earth equations,
  and the SDP4 lunisolar + resonance branch for deep-space TLEs, period
  >= 225 min), with the Kepler+J2 oracle as the labelled fallback; each
  row records which branch produced it;
* the device propagator is RK4 two-body + J2 with the precision ladder
  applied to r^2 (the same "broken math" hook as the galaxy engine) and
  underflow/overflow counters kept on the device (reference: :185-301).
  On the card each chunk of ``sample_every`` steps is captured once as a
  CUDA graph and replayed: the same kernels in the same order, so the
  samples keep their bits, without the host issuing ~100 small launches a
  step.

Sections: TLE-vs-device drift per precision mode; Lense-Thirring /
lattice-torsion precession vs Gravity Probe B (37.2 +/- 7.2 mas/yr,
reference: :465-609); eccentric-orbit telemetry glitch correlation
(reference: :626-795); geocentric-vs-heliocentric FLOP cost
(reference: :813-962); combined score. The propagation runs on
``--device`` (default ``cuda``; with no card it raises and names
``--device cpu``).

Usage:
    python -m nbody_tpu_torch.experiments.orbital_audit --quick
    python -m nbody_tpu_torch.experiments.orbital_audit --device cpu --quick
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.experiments._common import to_host
from nbody_tpu_torch.models.direct import _resolve_device
from nbody_tpu_torch.ops.precision import (
    Precision,
    Quantizer,
    bf16_roundtrip,
    f16_roundtrip,
    grid_quantize,
    grid_quantize_safe,
)

MU_EARTH = 398600.4418        # km^3/s^2
R_EARTH = 6378.137            # km
J2_EARTH = 1.08262668e-3
GPB_FRAME_DRAG_MAS_YR = 37.2  # Gravity Probe B measured (reference: :471)
GPB_ERROR_MAS_YR = 7.2

# Cached TLE fixtures (reference fallback pattern, orbital_audit.py:337-340)
TLE_FIXTURES = {
    "ISS": ("1 25544U 98067A   24001.50000000  .00016717  00000-0  "
            "10270-3 0  9000",
            "2 25544  51.6400 208.9163 0006317  69.9862 290.2000 "
            "15.49550000430000"),
    "LAGEOS-1": ("1 08820U 76039A   24001.50000000 -.00000010  00000-0  "
                 "00000+0 0  9990",
                 "2 08820 109.8500 200.0000 0044000 260.0000 100.0000 "
                 "06.38664800000000"),
    "GPS-IIR-2": ("1 24876U 97035A   24001.50000000  .00000020  00000-0  "
                  "00000+0 0  9990",
                  "2 24876  55.0000 150.0000 0080000 200.0000 160.0000 "
                  "02.00561900000000"),
}


CELESTRAK_URL = ("https://celestrak.org/NORAD/elements/gp.php"
                 "?GROUP=stations&FORMAT=tle")


def fetch_tles(url: str = CELESTRAK_URL, timeout_s: float = 5.0) -> dict:
    """Live CelesTrak fetch with the reference's cached-fallback pattern
    (reference: orbital_audit.py:89-111, 337-340).

    Returns ``(tles, source)`` where tles maps satellite name -> (l1, l2).
    Any failure (offline it ALWAYS falls back)
    returns the cached fixtures — the same behavior the reference
    exhibits offline. Fetched satellites matching a fixture name prefix
    replace that fixture; others are ignored (the audit's physics spans
    LEO/MEO/lageos regimes deliberately)."""
    try:
        from urllib.request import urlopen

        with urlopen(url, timeout=timeout_s) as resp:
            text = resp.read().decode("utf-8", "replace")
        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        fetched = {}
        for i in range(0, len(lines) - 2, 3):
            name, l1, l2 = lines[i], lines[i + 1], lines[i + 2]
            if l1.startswith("1 ") and l2.startswith("2 "):
                fetched[name] = (l1, l2)
        updated = dict(TLE_FIXTURES)
        hits = 0
        for name in updated:
            # match on the FULL fixture name (deterministic order): "ISS"
            # matches "ISS (ZARYA)"; "GPS-IIR-2" only a GPS-IIR-2 entry —
            # an unmatched fixture keeps its cached TLE rather than
            # silently adopting a different satellite's elements
            for fname in sorted(fetched):
                if fname.upper().startswith(name.upper()):
                    updated[name] = fetched[fname]
                    hits += 1
                    break
        if not hits:
            return TLE_FIXTURES, "fetch succeeded but no matching sats; " \
                                 "cached fixtures"
        return updated, f"live CelesTrak ({hits} updated)"
    except Exception as e:  # noqa: BLE001 — any network failure degrades
        return TLE_FIXTURES, (f"cached fixtures (fetch failed: "
                              f"{type(e).__name__})")


def parse_tle(line1: str, line2: str) -> dict:
    """Extract mean elements from a TLE pair (subset needed here)."""
    inc = float(line2[8:16])
    raan = float(line2[17:25])
    ecc = float("0." + line2[26:33].strip())
    argp = float(line2[34:42])
    mean_anom = float(line2[43:51])
    mean_motion = float(line2[52:63])  # rev/day
    n_rad_s = mean_motion * 2 * math.pi / 86400.0
    a = (MU_EARTH / n_rad_s ** 2) ** (1.0 / 3.0)
    return {"inclination_deg": inc, "raan_deg": raan, "eccentricity": ecc,
            "argp_deg": argp, "mean_anomaly_deg": mean_anom,
            "mean_motion_rev_day": mean_motion, "semi_major_axis_km": a}


def elements_to_state(el: dict):
    """Mean elements -> osculating position/velocity (km, km/s)."""
    a, e = el["semi_major_axis_km"], el["eccentricity"]
    i = math.radians(el["inclination_deg"])
    raan = math.radians(el["raan_deg"])
    argp = math.radians(el["argp_deg"])
    M = math.radians(el["mean_anomaly_deg"])
    # solve Kepler's equation
    E = M
    for _ in range(20):
        E = E - (E - e * math.sin(E) - M) / (1 - e * math.cos(E))
    nu = 2 * math.atan2(math.sqrt(1 + e) * math.sin(E / 2),
                        math.sqrt(1 - e) * math.cos(E / 2))
    r = a * (1 - e * math.cos(E))
    p = a * (1 - e * e)
    # perifocal
    rp = np.array([r * math.cos(nu), r * math.sin(nu), 0.0])
    vp = np.array([-math.sin(nu), e + math.cos(nu), 0.0]) * math.sqrt(
        MU_EARTH / p)
    # rotation to ECI
    cR, sR = math.cos(raan), math.sin(raan)
    cI, sI = math.cos(i), math.sin(i)
    cw, sw = math.cos(argp), math.sin(argp)
    R = np.array([
        [cR * cw - sR * sw * cI, -cR * sw - sR * cw * cI, sR * sI],
        [sR * cw + cR * sw * cI, -sR * sw + cR * cw * cI, -cR * sI],
        [sw * sI, cw * sI, cI],
    ])
    return R @ rp, R @ vp


def reference_ephemeris(el: dict, line1: str, line2: str, times_s):
    """Oracle positions at the sample times: the vendored SGP4/SDP4 core
    for every TLE (deep-space TLEs take the SDP4 lunisolar + resonance
    branch, matching the reference's library wrapper coverage,
    reference: orbital_audit.py:147-182). Returns (positions (T, 3),
    oracle_name) where oracle_name records which branch ran."""
    from nbody_tpu_torch.experiments import _sgp4

    # One propagator serves both the flag and the samples (the deep-space
    # _dscom/_dsinit setup is the expensive part of construction). A
    # pathological TLE (e.g. a decaying object whose perturbed eccentricity
    # drifts out of [0, 1) over the horizon) raises inside the propagator;
    # the audit must still produce a row for it, so fall back to the
    # Kepler+J2 oracle and label it honestly — mirroring the reference's
    # behavior of always completing the audit table.
    # TLE parsing stays OUTSIDE the try: a malformed/corrupted TLE is a
    # data bug that must surface, not be silently relabeled as a
    # propagation fallback over possibly mis-parsed elements.
    elements = _sgp4.elements_from_tle(line1, line2)
    try:
        prop = _sgp4.SGP4(elements)
        pos = np.asarray([prop.propagate(t / 60.0)[0] for t in times_s])
        return pos, ("sdp4" if prop.is_deep_space else "sgp4")
    except (RuntimeError, ValueError):
        return kepler_j2_reference(el, times_s), "kepler_j2(fallback)"


def kepler_j2_reference(el: dict, times_s):
    """Host reference ephemeris at the given sample times: Keplerian
    motion + J2 secular drift of RAAN/argp (the deep-space fallback
    oracle; dominant terms for LEO/MEO). Taking explicit times keeps the
    comparison aligned with the device propagator's sample instants."""
    a, e = el["semi_major_axis_km"], el["eccentricity"]
    i = math.radians(el["inclination_deg"])
    n = math.sqrt(MU_EARTH / a ** 3)
    p = a * (1 - e * e)
    fac = 1.5 * J2_EARTH * (R_EARTH / p) ** 2 * n
    raan_dot = -fac * math.cos(i)
    argp_dot = fac * (2 - 2.5 * math.sin(i) ** 2)
    out = []
    for t in times_s:
        el_t = dict(el)
        el_t["mean_anomaly_deg"] = (el["mean_anomaly_deg"]
                                    + math.degrees(n * t)) % 360.0
        el_t["raan_deg"] = el["raan_deg"] + math.degrees(raan_dot * t)
        el_t["argp_deg"] = el["argp_deg"] + math.degrees(argp_dot * t)
        pos, _ = elements_to_state(el_t)
        out.append(pos)
    return np.asarray(out)


# --------------------------------------------------------------------------
# Device RK4 + J2 propagator with the precision ladder
# --------------------------------------------------------------------------

_J2_FACTOR = 1.5 * J2_EARTH * MU_EARTH * R_EARTH ** 2
# The J2 terms' offsets, x, y: 5 z^2 / r^2 - 1; z: 5 z^2 / r^2 - 3.
_J2_OFFSETS = (1.0, 1.0, 3.0)


def _accel_constants(q: Quantizer, device) -> dict:
    """The device constants of _accel: the J2 offsets and, int modes, the
    log grid's bounds around Earth-orbit scales (made once a run, outside
    the capture)."""
    consts = {"offsets": torch.tensor(_J2_OFFSETS, dtype=torch.float32,
                                      device=device)}
    if q.is_int:
        for name, value in (("log_lo", R_EARTH ** 2),
                            ("log_hi", (20 * R_EARTH) ** 2)):
            consts[name] = torch.log(torch.tensor(value, dtype=torch.float32,
                                                  device=device))
    return consts


def _accel(pos, q: Quantizer, consts: dict | None = None):
    """Two-body + J2 acceleration with the precision hook on r^2."""
    if consts is None:
        consts = _accel_constants(q, pos.device)
    r_sq = torch.sum(pos * pos)
    if q.mode == Precision.BFLOAT16:
        r_sq = bf16_roundtrip(r_sq)
    elif q.mode == Precision.FLOAT16:
        r_sq = f16_roundtrip(r_sq)
    elif q.is_int:
        # single-value log-grid snap around Earth-orbit scales, between
        # analytic bounds: no host read
        r_sq = grid_quantize_safe(r_sq[None], q.levels, min_val=R_EARTH ** 2,
                                  log_lo=consts["log_lo"],
                                  log_hi=consts["log_hi"])[0]
    r = torch.sqrt(r_sq)
    a_kepler = -MU_EARTH / (r ** 3) * pos
    z = pos[2]
    j2f = _J2_FACTOR / r ** 5
    a_j2 = j2f * pos * (5 * z * z / r_sq - consts["offsets"])
    acc = a_kepler + a_j2
    if q.is_int:
        # Component-wise force quantization (reference semantics,
        # quantization.py:74-88 applied per step): the linear grid acts on
        # Cartesian components, which is NOT rotationally symmetric — this
        # axis-aligned "lattice" bias is the torsion source the
        # Lense-Thirring audit measures.
        acc = grid_quantize(acc, q.levels)
    return acc


def _rk4_step(state: tuple, dt: float, q: Quantizer, consts: dict) -> tuple:
    """One RK4 step of (p, v, underflows, overflows), all on the device
    (reference: orbital_audit.py:185-301)."""
    p, v, under, over = state
    k1p, k1v = v, _accel(p, q, consts)
    k2p, k2v = (v + 0.5 * dt * k1v,
                _accel(p + 0.5 * dt * k1p, q, consts))
    k3p, k3v = (v + 0.5 * dt * k2v,
                _accel(p + 0.5 * dt * k2p, q, consts))
    k4p, k4v = v + dt * k3v, _accel(p + dt * k3p, q, consts)
    p = p + dt / 6.0 * (k1p + 2 * k2p + 2 * k3p + k4p)
    v = v + dt / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)
    r = torch.linalg.vector_norm(p)
    under = under + (r < 1e-10).to(torch.int32)
    over = over + (~torch.isfinite(r)).to(torch.int32)
    return p, v, under, over


def _rk4_start(pos0, vel0, q: Quantizer, device) -> tuple:
    """The run's first state (p, v, underflows, overflows) on ``device``,
    ``pos0`` / ``vel0`` (3,) rounded to float32, and _accel's constants."""
    p = torch.as_tensor(np.asarray(to_host(pos0), np.float32), device=device)
    v = torch.as_tensor(np.asarray(to_host(vel0), np.float32), device=device)
    zeros = (torch.zeros((), dtype=torch.int32, device=device)
             for _ in range(2))
    return (p, v, *zeros), _accel_constants(q, device)


def _rk4_chunk(state: tuple, dt: float, q: Quantizer, consts: dict,
               steps: int) -> tuple:
    for _ in range(steps):
        state = _rk4_step(state, dt, q, consts)
    return state


def _chunk_graph(buffers: tuple, dt: float, q: Quantizer, consts: dict,
                 steps: int):
    """One chunk of ``steps`` RK4 steps captured as a CUDA graph that reads
    the state buffers (p, v, underflows, overflows) on the card and writes
    the chunk's end state back into them."""
    device = buffers[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):   # warm the ops outside the capture
        _rk4_step(tuple(b.clone() for b in buffers), dt, q, consts)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        end = _rk4_chunk(buffers, dt, q, consts, steps)
        for buf, new in zip(buffers, end):
            buf.copy_(new)
    return graph


def propagate_rk4(pos0, vel0, dt: float, q: Quantizer, num_steps: int,
                  sample_every: int, device=None):
    """RK4 in num_steps // sample_every chunks of sample_every steps, with
    underflow/overflow counting (reference: orbital_audit.py:185-301).
    ``pos0`` / ``vel0`` (3,) are rounded to float32 on ``device`` (cuda
    unless given). Returns (samples (chunks, 3) f32, underflows,
    overflows) as device tensors: the position after each chunk and two
    0-d int32 counters, never read on the host inside the run. On the
    card each chunk is a CUDA-graph replay, on the CPU eager ops."""
    device = _resolve_device(device)
    n_chunks = num_steps // sample_every
    samples = torch.empty((n_chunks, 3), dtype=torch.float32, device=device)
    state, consts = _rk4_start(pos0, vel0, q, device)
    if device.type == "cuda" and n_chunks:
        graph = _chunk_graph(state, dt, q, consts, sample_every)
        for j in range(n_chunks):
            graph.replay()
            samples[j].copy_(state[0])
        return samples, state[2], state[3]
    for j in range(n_chunks):
        state = _rk4_chunk(state, dt, q, consts, sample_every)
        samples[j] = state[0]
    return samples, state[2], state[3]


# --------------------------------------------------------------------------
# Audit sections
# --------------------------------------------------------------------------

def tle_drift_audit(duration_hours: float = 6.0, dt: float = 10.0,
                    tles: dict | None = None, device=None) -> dict:
    """Device RK4 vs reference ephemeris per satellite and precision
    (reference: orbital_audit.py:321-448)."""
    print("\n--- AUDIT 1: TLE vs DEVICE-PROPAGATION DRIFT ---")
    duration_s = duration_hours * 3600.0
    results = {}
    for name, (l1, l2) in (tles or TLE_FIXTURES).items():
        el = parse_tle(l1, l2)
        pos0, vel0 = elements_to_state(el)
        num_steps = int(duration_s / dt)
        sample_every = max(num_steps // 50, 1)
        n_samples = num_steps // sample_every
        # device samples land at t = (j+1) * sample_every * dt exactly
        times = [(j + 1) * sample_every * dt for j in range(n_samples)]
        ref, oracle = reference_ephemeris(el, l1, l2, times)
        row = {"elements": el, "oracle": oracle}
        for mode in (Precision.FLOAT32, Precision.FLOAT16,
                     Precision.INT4_SIM):
            q = Quantizer(mode)
            samples, under, over = propagate_rk4(
                pos0, vel0, dt, q,
                num_steps // sample_every * sample_every, sample_every,
                device=device)
            sim = to_host(samples)
            k = min(len(sim), len(ref))
            drift = np.linalg.norm(sim[:k] - ref[:k], axis=1)
            row[mode.value] = {
                "final_drift_km": float(drift[-1]),
                "max_drift_km": float(drift.max()),
                "underflows": int(under),
                "overflows": int(over),
            }
            print(f"  {name:10s} {mode.value:9s}: final drift "
                  f"{drift[-1]:10.2f} km over {duration_hours:.0f}h "
                  f"[oracle: {oracle}]")
        # int4 signature: drift ratio vs float32
        f32 = row["float32"]["final_drift_km"]
        row["int4_signature"] = (row["int4_sim"]["final_drift_km"]
                                 / max(f32, 1e-9))
        results[name] = row
    return results


def lense_thirring_audit(num_years: float = 1.0, device=None) -> dict:
    """Lattice-torsion precession vs Gravity Probe B
    (reference: orbital_audit.py:465-609): measure the spurious nodal
    precession the int4 lattice induces on a polar orbit and compare with
    the real frame-dragging rate."""
    print("\n--- AUDIT 2: LENSE-THIRRING / LATTICE TORSION ---")
    el = {"inclination_deg": 90.0, "raan_deg": 0.0, "eccentricity": 0.001,
          "argp_deg": 0.0, "mean_anomaly_deg": 0.0,
          "mean_motion_rev_day": 14.0,
          "semi_major_axis_km": (MU_EARTH / (14.0 * 2 * math.pi / 86400.0)
                                 ** 2) ** (1 / 3)}
    pos0, vel0 = elements_to_state(el)
    dt, hours = 10.0, 12.0
    num_steps = int(hours * 3600 / dt)
    sample_every = max(num_steps // 100, 1)
    rates = {}
    for mode in (Precision.FLOAT32, Precision.INT8_SIM,
                 Precision.INT4_SIM):
        samples, _, _ = propagate_rk4(
            pos0, vel0, dt, Quantizer(mode),
            num_steps // sample_every * sample_every, sample_every,
            device=device)
        s = to_host(samples)
        # node line: cross product of successive orbit normals
        h = np.cross(s[:-1], np.diff(s, axis=0))
        h = h / (np.linalg.norm(h, axis=1, keepdims=True) + 1e-12)
        raan = np.unwrap(np.arctan2(h[:, 0], -h[:, 1]))
        rate_rad_s = np.polyfit(
            np.arange(len(raan)) * dt * sample_every, raan, 1)[0]
        mas_yr = math.degrees(rate_rad_s) * 3600e3 * 86400 * 365.25
        rates[mode.value] = mas_yr
        print(f"  {mode.value:9s}: nodal precession {mas_yr:+.1f} mas/yr")
    torsion = abs(rates["int4_sim"] - rates["float32"])
    print(f"  lattice torsion (int4 - f32): {torsion:.1f} mas/yr vs "
          f"GP-B frame dragging {GPB_FRAME_DRAG_MAS_YR} +/- "
          f"{GPB_ERROR_MAS_YR}")
    return {"rates_mas_yr": rates, "lattice_torsion_mas_yr": torsion,
            "gpb_reference": GPB_FRAME_DRAG_MAS_YR,
            "within_gpb_band": bool(abs(torsion - GPB_FRAME_DRAG_MAS_YR)
                                    < GPB_ERROR_MAS_YR)}


def telemetry_glitch_audit(device=None) -> dict:
    """Eccentric-orbit glitch correlation (reference: orbital_audit.py:
    626-795): does int4 produce extra jerk near perigee (small r = coarse
    log-grid cells)?"""
    print("\n--- AUDIT 3: ECCENTRIC-ORBIT TELEMETRY GLITCHES ---")
    el = {"inclination_deg": 63.4, "raan_deg": 0.0, "eccentricity": 0.7,
          "argp_deg": 270.0, "mean_anomaly_deg": 0.0,
          "mean_motion_rev_day": 2.0,
          "semi_major_axis_km": (MU_EARTH / (2.0 * 2 * math.pi / 86400.0)
                                 ** 2) ** (1 / 3)}
    pos0, vel0 = elements_to_state(el)
    dt = 20.0
    num_steps = 4000
    sample_every = 10
    out = {}
    for mode in (Precision.FLOAT32, Precision.INT4_SIM):
        samples, _, _ = propagate_rk4(
            pos0, vel0, dt, Quantizer(mode), num_steps, sample_every,
            device=device)
        s = to_host(samples)
        r = np.linalg.norm(s, axis=1)
        jerk = np.abs(np.diff(s, n=2, axis=0)).sum(axis=1)
        # correlate glitchiness with 1/r (perigee proximity)
        corr = float(np.corrcoef(1.0 / r[:-2], jerk)[0, 1])
        out[mode.value] = {"perigee_km": float(r.min()),
                           "apogee_km": float(r.max()),
                           "jerk_perigee_correlation": corr}
        print(f"  {mode.value:9s}: corr(1/r, jerk) = {corr:+.3f}")
    return out


def flop_cost_audit() -> dict:
    """Geocentric vs heliocentric computational cost
    (reference: orbital_audit.py:813-962): epicycles are more expensive
    to simulate than Kepler ellipses — counted analytically."""
    print("\n--- AUDIT 4: GEOCENTRIC vs HELIOCENTRIC FLOP COST ---")
    # per-step flop estimates: Kepler 2-body ~60 flops; epicycle stack of
    # k circles ~ 8k flops for the same fidelity (deferents+epicycles)
    kepler_flops = 60
    epicycle_terms = 84  # Ptolemaic-equivalent term count for Mars-quality
    epicycle_flops = 8 * epicycle_terms
    ratio = epicycle_flops / kepler_flops
    print(f"  heliocentric Kepler: ~{kepler_flops} flops/step; "
          f"geocentric epicycles: ~{epicycle_flops} flops/step "
          f"({ratio:.1f}x)")
    print("  -> a lazy simulator would pick heliocentric physics: "
          "consistency check passed")
    return {"kepler_flops": kepler_flops, "epicycle_flops": epicycle_flops,
            "ratio": ratio, "simulator_prefers_heliocentric": True}


def run_full_orbital_audit(quick: bool = False, fetch: bool = False,
                           device=None) -> dict:
    """(reference: orbital_audit.py:982-1079)"""
    device = _resolve_device(device)
    if fetch:
        tles, tle_source = fetch_tles()
        print(f"  TLE source: {tle_source}")
    else:
        tles, tle_source = TLE_FIXTURES, "cached fixtures (--fetch not set)"
    report = {
        "tle_drift": tle_drift_audit(2.0 if quick else 6.0, tles=tles,
                                     device=device),
        "lense_thirring": lense_thirring_audit(device=device),
        "telemetry_glitches": telemetry_glitch_audit(device=device),
        "flop_cost": flop_cost_audit(),
        "tle_source": tle_source,
        "notes": ("TLE source recorded per run (--fetch tries CelesTrak "
                  "with the reference's cached-fallback pattern, "
                  "orbital_audit.py:89-111, and falls back to the cached "
                  "fixtures offline); oracle = the SGP4/SDP4 core "
                  "(experiments/_sgp4.py) — deep-space TLEs (period >= "
                  "225 min) take the SDP4 lunisolar + resonance branch"),
    }
    sig = np.mean([r["int4_signature"]
                   for r in report["tle_drift"].values()
                   if isinstance(r, dict) and "int4_signature" in r])
    report["score"] = {
        "mean_int4_drift_amplification": float(sig),
        "int4_signature_detected": bool(sig > 2.0),
    }
    print(f"\n  AUDIT SCORE: int4 drift amplification x{sig:.1f} "
          f"({'SIGNATURE DETECTED' if sig > 2.0 else 'weak'})")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="Orbital audit")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--fetch", action="store_true",
                   help="try a live CelesTrak TLE fetch before falling "
                        "back to the cached fixtures (reference pattern)")
    p.add_argument("--output", type=str, default="output/orbital")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    args = p.parse_args(argv)

    print("\n" + "=" * 60)
    print("ORBITAL AUDIT: satellites vs the precision ladder")
    print("=" * 60)
    report = run_full_orbital_audit(args.quick, fetch=args.fetch,
                                    device=args.device)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "orbital_audit_report.json").write_text(
        json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()
