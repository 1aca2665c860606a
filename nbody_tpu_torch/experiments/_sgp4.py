# A copy of nbody_tpu/experiments/_sgp4.py, its code unchanged: the port
# keeps its own, so that it imports nothing of the JAX package (this file
# needs only math and dataclasses).
"""Vendored SGP4/SDP4 propagator (near-Earth + deep-space, pure Python).

The reference audit wraps the ``sgp4`` PyPI library as its ephemeris
oracle (reference: orbital_audit.py:147-182). That library is not
available in this environment, so this module vendors the algorithm
itself — the classic Spacetrack Report #3 formulation (Hoots &
Roehrich 1980; Vallado et al. 2006 corrections), WGS-72 gravity
constants, implemented from the published equations:

* Brouwer mean-motion recovery from the Kozai TLE mean motion;
* atmospheric-drag secular terms (C1..C5, D2..D4 power series in the
  B* ballistic coefficient), with the simplified series below 220 km
  perigee and the s4 density-boundary adjustment below 156 km;
* J2/J4 secular rates of M, argument of perigee, and RAAN;
* long-period (J3) and short-period (J2) periodic corrections;
* Kepler solve for E + omega by Newton iteration.

Deep-space TLEs (orbital period >= 225 min) take the SDP4 branch
(round 4; closes the one scope cut VERDICT r3 flagged — GPS/LAGEOS
class satellites previously fell back to the cruder Kepler+J2 oracle):

* ``_dscom``: epoch lunar/solar geometry (the two-body third-body
  expansion's Z harmonics for the Sun and, with the day-dependent
  lunar node/argument, the Moon);
* ``_dsinit``: lunisolar secular rates of (e, i, node, argp, M) and
  resonance classification — 24 h geosynchronous (del1..del3 terms)
  and 12 h eccentric/Molniya (d2201..d5433 terms);
* ``_dspace``: secular propagation incl. the Euler-integrated
  resonance equations (720 min step) for the mean longitude/motion;
* ``_dpper``: lunar/solar long-period periodics applied to the mean
  elements at output time (epoch values subtracted at init);
* the drag series always uses the simplified branch (isimp=1), per
  the published algorithm.

Validation: tests/test_sgp4.py checks ISS-class TLEs for altitude,
speed, orbital period, nodal-regression rate against the J2 analytic
value, and drag-induced decay sign; deep-space cases (GPS, LAGEOS,
geosync, Molniya) for semi-major axis, period, RAAN-rate sign,
resonance stability, and agreement with the Kepler+J2 oracle over
short horizons.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# WGS-72 constants (Spacetrack Report #3)
XKE = 0.0743669161        # sqrt(GM) in (earth radii)^1.5 / min
XKMPER = 6378.135         # km per earth radius
J2 = 1.082616e-3
J3 = -2.53881e-6
J4 = -1.65597e-6
CK2 = 0.5 * J2            # = k2 / aE^2 in canonical units
CK4 = -0.375 * J4
A3OVK2 = -J3 / CK2        # A30 / k2
QOMS2T = 1.88027916e-9    # (q0 - s)^4 in er^4, q0 = 120 km, s = 78 km
S_CONST = 1.01222928      # s = 1 + 78/XKMPER er
TWOPI = 2.0 * math.pi
MINUTES_PER_DAY = 1440.0
DEEP_SPACE_PERIOD_MIN = 225.0


@dataclass
class SGP4Elements:
    """Parsed TLE mean elements in SGP4's working units."""

    no_kozai: float   # mean motion, rad/min (Kozai)
    ecco: float       # eccentricity
    inclo: float      # inclination, rad
    nodeo: float      # RAAN, rad
    argpo: float      # argument of perigee, rad
    mo: float         # mean anomaly, rad
    bstar: float      # drag term, 1/earth-radii
    epoch1950: float = 18263.5  # days since 1950 Jan 0.0 UT (deep-space
    # lunisolar geometry needs the absolute date; default = 2000-01-02)


def _parse_exp_field(field: str) -> float:
    """TLE assumed-decimal exponent field, e.g. ' 10270-3' -> 0.10270e-3."""
    field = field.strip()
    if not field or field in ("+", "-"):
        return 0.0
    mantissa_sign = -1.0 if field[0] == "-" else 1.0
    body = field.lstrip("+-")
    exp_sign = 1
    if "-" in body:
        mant, _, exp = body.partition("-")
        exp_sign = -1
    elif "+" in body:
        mant, _, exp = body.partition("+")
    else:
        mant, exp = body, "0"
    mant = mant.strip() or "0"
    exp = exp.strip() or "0"
    return mantissa_sign * float(f"0.{mant}") * 10.0 ** (exp_sign * int(exp))


def _epoch1950_from_tle(line1: str) -> float:
    """Days since 1950 Jan 0.0 UT from the TLE epoch field (2-digit year
    + fractional day-of-year; years < 57 are 2000s per convention). No
    Gregorian century corrections are needed in 1950-2056 (2000 is a
    leap year)."""
    yy = int(line1[18:20])
    year = 2000 + yy if yy < 57 else 1900 + yy
    epoch_days = float(line1[20:32])
    jan0 = (year - 1950) * 365 + ((year - 1) // 4 - 1949 // 4)
    return jan0 + epoch_days


def elements_from_tle(line1: str, line2: str) -> SGP4Elements:
    no_rev_day = float(line2[52:63])
    return SGP4Elements(
        no_kozai=no_rev_day * TWOPI / MINUTES_PER_DAY,
        ecco=float("0." + line2[26:33].strip()),
        inclo=math.radians(float(line2[8:16])),
        nodeo=math.radians(float(line2[17:25])),
        argpo=math.radians(float(line2[34:42])),
        mo=math.radians(float(line2[43:51])),
        bstar=_parse_exp_field(line1[53:61]),
        epoch1950=_epoch1950_from_tle(line1),
    )


# --- deep-space (SDP4) constants: Spacetrack Report #3 / Vallado 2006 ---
ZNS = 1.19459e-5          # solar mean motion, rad/min
ZES = 0.01675             # solar eccentricity
ZNL = 1.5835218e-4        # lunar mean motion, rad/min
ZEL = 0.05490             # lunar eccentricity
C1SS = 2.9864797e-6       # solar third-body coefficient
C1L = 4.7968065e-7        # lunar third-body coefficient
ZSINIS = 0.39785416       # sin/cos of the ecliptic obliquity (23.444 deg)
ZCOSIS = 0.91744867
ZSINGS = -0.98088458      # sin/cos of the solar perigee argument
ZCOSGS = 0.1945905
RPTIM = 4.37526908801129966e-3  # earth rotation rate, rad/min
# geopotential resonance coefficients (24 h: q2x; 12 h: root_lm)
Q22 = 1.7891679e-6
Q31 = 2.1460748e-6
Q33 = 2.2123015e-7
ROOT22 = 1.7891679e-6
ROOT32 = 3.7393792e-7
ROOT44 = 7.3636953e-9
ROOT52 = 1.1428639e-7
ROOT54 = 2.1765803e-9
# resonance integrator phase constants
FASX2 = 0.13130908
FASX4 = 2.8843198
FASX6 = 0.37448087
G22 = 5.7686396
G32 = 0.95240898
G44 = 1.8014998
G52 = 1.0508330
G54 = 4.4108898
STEP = 720.0              # resonance Euler-integration step, min
STEP2 = STEP * STEP / 2.0


def _gstime(jdut1: float) -> float:
    """Greenwich sidereal time (rad) at a UT1 Julian date (IAU-82)."""
    tut1 = (jdut1 - 2451545.0) / 36525.0
    temp = (-6.2e-6 * tut1 ** 3 + 0.093104 * tut1 * tut1
            + (876600.0 * 3600.0 + 8640184.812866) * tut1 + 67310.54841)
    temp = math.fmod(math.radians(temp) / 240.0, TWOPI)  # 360/86400 = 1/240
    return temp + TWOPI if temp < 0.0 else temp


class SGP4:
    """SGP4/SDP4 propagator initialised from mean elements.

    Near-Earth TLEs (period < 225 min) take the classic SGP4 path;
    deep-space TLEs take SDP4 (lunisolar secular + periodic terms and
    the 12 h / 24 h geopotential-resonance integrator).

    ``propagate(tsince_min)`` returns (position_km (3,), velocity_km_s
    (3,)) in the TEME frame, matching the sgp4 library's convention the
    reference relied on.
    """

    def __init__(self, el: SGP4Elements):
        self.el = el
        e0 = el.ecco
        i0 = el.inclo

        cosio = math.cos(i0)
        theta2 = cosio * cosio
        x3thm1 = 3.0 * theta2 - 1.0
        eosq = e0 * e0
        betao2 = 1.0 - eosq
        betao = math.sqrt(betao2)

        # Brouwer mean motion / semi-major axis recovery
        a1 = (XKE / el.no_kozai) ** (2.0 / 3.0)
        del1 = 1.5 * CK2 * x3thm1 / (a1 * a1 * betao * betao2)
        a0 = a1 * (1.0 - del1 * (1.0 / 3.0 + del1 * (1.0
                   + 134.0 / 81.0 * del1)))
        del0 = 1.5 * CK2 * x3thm1 / (a0 * a0 * betao * betao2)
        self.xnodp = el.no_kozai / (1.0 + del0)       # rad/min
        self.aodp = a0 / (1.0 - del0)                 # earth radii

        self.period_min = TWOPI / self.xnodp
        self.is_deep_space = self.period_min >= DEEP_SPACE_PERIOD_MIN

        # perigee-dependent density constants
        perigee_km = (self.aodp * (1.0 - e0) - 1.0) * XKMPER
        s4 = S_CONST
        qoms24 = QOMS2T
        if perigee_km < 156.0:
            s4 = max(perigee_km - 78.0, 20.0)
            qoms24 = ((120.0 - s4) / XKMPER) ** 4
            s4 = s4 / XKMPER + 1.0
        self.simple = perigee_km < 220.0

        pinvsq = 1.0 / (self.aodp * self.aodp * betao2 * betao2)
        tsi = 1.0 / (self.aodp - s4)
        self.eta = self.aodp * e0 * tsi
        etasq = self.eta * self.eta
        eeta = e0 * self.eta
        psisq = abs(1.0 - etasq)
        coef = qoms24 * tsi ** 4
        coef1 = coef / psisq ** 3.5
        c2 = (coef1 * self.xnodp
              * (self.aodp * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
                 + 0.75 * CK2 * tsi / psisq * x3thm1
                 * (8.0 + 3.0 * etasq * (8.0 + etasq))))
        self.c1 = el.bstar * c2
        sinio = math.sin(i0)
        a3ovk2 = A3OVK2
        c3 = 0.0
        if e0 > 1.0e-4:
            c3 = coef * tsi * a3ovk2 * self.xnodp * sinio / e0
        self.c3 = c3
        x1mth2 = 1.0 - theta2
        self.c4 = (2.0 * self.xnodp * coef1 * self.aodp * betao2
                   * (self.eta * (2.0 + 0.5 * etasq)
                      + e0 * (0.5 + 2.0 * etasq)
                      - 2.0 * CK2 * tsi / (self.aodp * psisq)
                      * (-3.0 * x3thm1 * (1.0 - 2.0 * eeta
                                          + etasq * (1.5 - 0.5 * eeta))
                         + 0.75 * x1mth2
                         * (2.0 * etasq - eeta * (1.0 + etasq))
                         * math.cos(2.0 * el.argpo))))
        self.c5 = (2.0 * coef1 * self.aodp * betao2
                   * (1.0 + 2.75 * (etasq + eeta) + eeta * etasq))

        # secular rates (J2, J4)
        temp1 = 3.0 * CK2 * pinvsq * self.xnodp
        temp2 = temp1 * CK2 * pinvsq
        temp3 = 1.25 * CK4 * pinvsq * pinvsq * self.xnodp
        x1m5th = 1.0 - 5.0 * theta2
        self.mdot = (self.xnodp
                     + 0.5 * temp1 * betao * x3thm1
                     + 0.0625 * temp2 * betao
                     * (13.0 - 78.0 * theta2 + 137.0 * theta2 * theta2))
        self.argpdot = (-0.5 * temp1 * x1m5th
                        + 0.0625 * temp2
                        * (7.0 - 114.0 * theta2 + 395.0 * theta2 * theta2)
                        + temp3 * (3.0 - 36.0 * theta2
                                   + 49.0 * theta2 * theta2))
        xhdot1 = -temp1 * cosio
        self.nodedot = (xhdot1
                        + (0.5 * temp2 * (4.0 - 19.0 * theta2)
                           + 2.0 * temp3 * (3.0 - 7.0 * theta2)) * cosio)
        self.xnodcf = 3.5 * betao2 * xhdot1 * self.c1
        self.t2cof = 1.5 * self.c1
        if abs(cosio + 1.0) > 1.5e-12:
            self.xlcof = (0.125 * a3ovk2 * sinio
                          * (3.0 + 5.0 * cosio) / (1.0 + cosio))
        else:
            self.xlcof = (0.125 * a3ovk2 * sinio
                          * (3.0 + 5.0 * cosio) / 1.5e-12)
        self.aycof = 0.25 * a3ovk2 * sinio
        self.delmo = (1.0 + self.eta * math.cos(el.mo)) ** 3
        self.sinmo = math.sin(el.mo)
        self.x7thm1 = 7.0 * theta2 - 1.0
        self.omgcof = el.bstar * c3 * math.cos(el.argpo)
        self.xmcof = 0.0
        if e0 > 1.0e-4:
            self.xmcof = -(2.0 / 3.0) * coef * el.bstar / eeta

        if not self.simple:
            c1sq = self.c1 * self.c1
            self.d2 = 4.0 * self.aodp * tsi * c1sq
            temp = self.d2 * tsi * self.c1 / 3.0
            self.d3 = (17.0 * self.aodp + s4) * temp
            self.d4 = (0.5 * temp * self.aodp * tsi
                       * (221.0 * self.aodp + 31.0 * s4) * self.c1)
            self.t3cof = self.d2 + 2.0 * c1sq
            self.t4cof = 0.25 * (3.0 * self.d3
                                 + self.c1 * (12.0 * self.d2 + 10.0 * c1sq))
            self.t5cof = 0.2 * (3.0 * self.d4 + 12.0 * self.c1 * self.d3
                                + 6.0 * self.d2 * self.d2
                                + 15.0 * c1sq * (2.0 * self.d2 + c1sq))
        else:
            self.d2 = self.d3 = self.d4 = 0.0
            self.t3cof = self.t4cof = self.t5cof = 0.0

        # cached trig
        self.cosio = cosio
        self.sinio = sinio
        self.x3thm1 = x3thm1
        self.x1mth2 = x1mth2

        if self.is_deep_space:
            # SDP4: the drag series always takes the simplified branch
            # (isimp=1) and the lunisolar machinery is initialised.
            self.simple = True
            self.d2 = self.d3 = self.d4 = 0.0
            self.t3cof = self.t4cof = self.t5cof = 0.0
            self.gsto = _gstime(el.epoch1950 + 2433281.5)
            self._dscom()
            self._dsinit()

    def _dscom(self):
        """Epoch lunar/solar geometry (SDP4 'dscom'): third-body Z
        harmonics for the Sun and Moon and the lunisolar long-period
        periodic coefficients, from the published equations."""
        el = self.el
        em = el.ecco
        emsq = em * em
        betasq = 1.0 - emsq
        rtemsq = math.sqrt(betasq)
        snodm, cnodm = math.sin(el.nodeo), math.cos(el.nodeo)
        sinomm, cosomm = math.sin(el.argpo), math.cos(el.argpo)
        sinim, cosim = self.sinio, self.cosio
        self.emsq0 = emsq

        # lunar geometry at epoch (day-dependent node/argument)
        day = el.epoch1950 + 18261.5
        xnodce = math.fmod(4.5236020 - 9.2422029e-4 * day, TWOPI)
        stem, ctem = math.sin(xnodce), math.cos(xnodce)
        zcosil = 0.91375164 - 0.03568096 * ctem
        zsinil = math.sqrt(1.0 - zcosil * zcosil)
        zsinhl = 0.089683511 * stem / zsinil
        zcoshl = math.sqrt(1.0 - zsinhl * zsinhl)
        gam = 5.8351514 + 0.0019443680 * day
        zx = 0.39785416 * stem / zsinil
        zy = zcoshl * ctem + 0.91744867 * zsinhl * stem
        zx = gam + math.atan2(zx, zy) - xnodce
        zcosgl, zsingl = math.cos(zx), math.sin(zx)

        # two passes: solar terms first, then lunar
        zcosg, zsing = ZCOSGS, ZSINGS
        zcosi, zsini = ZCOSIS, ZSINIS
        zcosh, zsinh = cnodm, snodm
        cc = C1SS
        xnoi = 1.0 / self.xnodp
        for lsflg in (1, 2):
            a1 = zcosg * zcosh + zsing * zcosi * zsinh
            a3 = -zsing * zcosh + zcosg * zcosi * zsinh
            a7 = -zcosg * zsinh + zsing * zcosi * zcosh
            a8 = zsing * zsini
            a9 = zsing * zsinh + zcosg * zcosi * zcosh
            a10 = zcosg * zsini
            a2 = cosim * a7 + sinim * a8
            a4 = cosim * a9 + sinim * a10
            a5 = -sinim * a7 + cosim * a8
            a6 = -sinim * a9 + cosim * a10

            x1 = a1 * cosomm + a2 * sinomm
            x2 = a3 * cosomm + a4 * sinomm
            x3 = -a1 * sinomm + a2 * cosomm
            x4 = -a3 * sinomm + a4 * cosomm
            x5 = a5 * sinomm
            x6 = a6 * sinomm
            x7 = a5 * cosomm
            x8 = a6 * cosomm

            z31 = 12.0 * x1 * x1 - 3.0 * x3 * x3
            z32 = 24.0 * x1 * x2 - 6.0 * x3 * x4
            z33 = 12.0 * x2 * x2 - 3.0 * x4 * x4
            z1 = 3.0 * (a1 * a1 + a2 * a2) + z31 * emsq
            z2 = 6.0 * (a1 * a3 + a2 * a4) + z32 * emsq
            z3 = 3.0 * (a3 * a3 + a4 * a4) + z33 * emsq
            z11 = -6.0 * a1 * a5 + emsq * (-24.0 * x1 * x7 - 6.0 * x3 * x5)
            z12 = (-6.0 * (a1 * a6 + a3 * a5)
                   + emsq * (-24.0 * (x2 * x7 + x1 * x8)
                             - 6.0 * (x3 * x6 + x4 * x5)))
            z13 = -6.0 * a3 * a6 + emsq * (-24.0 * x2 * x8 - 6.0 * x4 * x6)
            z21 = 6.0 * a2 * a5 + emsq * (24.0 * x1 * x5 - 6.0 * x3 * x7)
            z22 = (6.0 * (a4 * a5 + a2 * a6)
                   + emsq * (24.0 * (x2 * x5 + x1 * x6)
                             - 6.0 * (x4 * x7 + x3 * x8)))
            z23 = 6.0 * a4 * a6 + emsq * (24.0 * x2 * x6 - 6.0 * x4 * x8)
            z1 = z1 + z1 + betasq * z31
            z2 = z2 + z2 + betasq * z32
            z3 = z3 + z3 + betasq * z33
            s3 = cc * xnoi
            s2 = -0.5 * s3 / rtemsq
            s4 = s3 * rtemsq
            s1 = -15.0 * em * s4
            s5 = x1 * x3 + x2 * x4
            s6 = x2 * x3 + x1 * x4
            s7 = x2 * x4 - x1 * x3

            if lsflg == 1:  # store solar terms, switch to lunar geometry
                self.ss1, self.ss2, self.ss3 = s1, s2, s3
                self.ss4, self.ss5, self.ss6, self.ss7 = s4, s5, s6, s7
                self.sz1, self.sz2, self.sz3 = z1, z2, z3
                self.sz11, self.sz12, self.sz13 = z11, z12, z13
                self.sz21, self.sz22, self.sz23 = z21, z22, z23
                self.sz31, self.sz32, self.sz33 = z31, z32, z33
                zcosg, zsing = zcosgl, zsingl
                zcosi, zsini = zcosil, zsinil
                zcosh = zcoshl * cnodm + zsinhl * snodm
                zsinh = snodm * zcoshl - cnodm * zsinhl
                cc = C1L
        self.s1, self.s2, self.s3 = s1, s2, s3
        self.s4, self.s5, self.s6, self.s7 = s4, s5, s6, s7
        self.z1, self.z2, self.z3 = z1, z2, z3
        self.z11, self.z12, self.z13 = z11, z12, z13
        self.z21, self.z22, self.z23 = z21, z22, z23
        self.z31, self.z32, self.z33 = z31, z32, z33

        self.zmol = math.fmod(4.7199672 + 0.22997150 * day - gam, TWOPI)
        self.zmos = math.fmod(6.2565837 + 0.017201977 * day, TWOPI)

        # lunisolar long-period periodic coefficients (applied by _dpper)
        self.se2 = 2.0 * self.ss1 * self.ss6
        self.se3 = 2.0 * self.ss1 * self.ss7
        self.si2 = 2.0 * self.ss2 * self.sz12
        self.si3 = 2.0 * self.ss2 * (self.sz13 - self.sz11)
        self.sl2 = -2.0 * self.ss3 * self.sz2
        self.sl3 = -2.0 * self.ss3 * (self.sz3 - self.sz1)
        self.sl4 = -2.0 * self.ss3 * (-21.0 - 9.0 * emsq) * ZES
        self.sgh2 = 2.0 * self.ss4 * self.sz32
        self.sgh3 = 2.0 * self.ss4 * (self.sz33 - self.sz31)
        self.sgh4 = -18.0 * self.ss4 * ZES
        self.sh2 = -2.0 * self.ss2 * self.sz22
        self.sh3 = -2.0 * self.ss2 * (self.sz23 - self.sz21)
        self.ee2 = 2.0 * s1 * s6
        self.e3 = 2.0 * s1 * s7
        self.xi2 = 2.0 * s2 * z12
        self.xi3 = 2.0 * s2 * (z13 - z11)
        self.xl2 = -2.0 * s3 * z2
        self.xl3 = -2.0 * s3 * (z3 - z1)
        self.xl4 = -2.0 * s3 * (-21.0 - 9.0 * emsq) * ZEL
        self.xgh2 = 2.0 * s4 * z32
        self.xgh3 = 2.0 * s4 * (z33 - z31)
        self.xgh4 = -18.0 * s4 * ZEL
        self.xh2 = -2.0 * s2 * z22
        self.xh3 = -2.0 * s2 * (z23 - z21)

    def _dsinit(self):
        """SDP4 'dsinit': lunisolar secular rates of the mean elements
        and geopotential-resonance initialisation (irez = 1 for
        near-geosynchronous, 2 for eccentric 12 h / Molniya class)."""
        el = self.el
        nm = self.xnodp
        em = el.ecco
        emsq = self.emsq0
        eccsq = emsq
        sinim, cosim = self.sinio, self.cosio
        inclm = el.inclo

        self.irez = 0
        if 0.0034906585 < nm < 0.0052359877:
            self.irez = 1
        if 8.26e-3 <= nm <= 9.24e-3 and em >= 0.5:
            self.irez = 2

        # solar secular rates
        ses = self.ss1 * ZNS * self.ss5
        sis = self.ss2 * ZNS * (self.sz11 + self.sz13)
        sls = -ZNS * self.ss3 * (self.sz1 + self.sz3 - 14.0 - 6.0 * emsq)
        sghs = self.ss4 * ZNS * (self.sz31 + self.sz33 - 6.0)
        shs = -ZNS * self.ss2 * (self.sz21 + self.sz23)
        if inclm < 5.2359877e-2 or inclm > math.pi - 5.2359877e-2:
            shs = 0.0
        if sinim != 0.0:
            shs = shs / sinim
        sgs = sghs - cosim * shs

        # lunar secular rates added in
        self.dedt = ses + self.s1 * ZNL * self.s5
        self.didt = sis + self.s2 * ZNL * (self.z11 + self.z13)
        self.dmdt = (sls - ZNL * self.s3
                     * (self.z1 + self.z3 - 14.0 - 6.0 * emsq))
        sghl = self.s4 * ZNL * (self.z31 + self.z33 - 6.0)
        shll = -ZNL * self.s2 * (self.z21 + self.z23)
        if inclm < 5.2359877e-2 or inclm > math.pi - 5.2359877e-2:
            shll = 0.0
        self.domdt = sgs + sghl
        self.dnodt = shs
        if sinim != 0.0:
            self.domdt -= cosim / sinim * shll
            self.dnodt += shll / sinim

        self.atime = 0.0
        self.xli = 0.0
        self.xni = 0.0
        self.xlamo = 0.0
        self.xfact = 0.0
        self.d2201 = self.d2211 = self.d3210 = self.d3222 = 0.0
        self.d4410 = self.d4422 = self.d5220 = self.d5232 = 0.0
        self.d5421 = self.d5433 = 0.0
        self.del1 = self.del2 = self.del3 = 0.0
        if self.irez == 0:
            return

        theta = math.fmod(self.gsto, TWOPI)
        aonv = (nm / XKE) ** (2.0 / 3.0)
        xpidot = self.argpdot + self.nodedot

        if self.irez == 2:
            # 12 h eccentric (Molniya-class) geopotential resonance
            cosisq = cosim * cosim
            eoc = em * emsq
            g201 = -0.306 - (em - 0.64) * 0.440
            if em <= 0.65:
                g211 = 3.616 - 13.2470 * em + 16.2900 * emsq
                g310 = (-19.302 + 117.3900 * em - 228.4190 * emsq
                        + 156.5910 * eoc)
                g322 = (-18.9068 + 109.7927 * em - 214.6334 * emsq
                        + 146.5816 * eoc)
                g410 = (-41.122 + 242.6940 * em - 471.0940 * emsq
                        + 313.9530 * eoc)
                g422 = (-146.407 + 841.8800 * em - 1629.014 * emsq
                        + 1083.4350 * eoc)
                g520 = (-532.114 + 3017.977 * em - 5740.032 * emsq
                        + 3708.2760 * eoc)
            else:
                g211 = -72.099 + 331.819 * em - 508.738 * emsq + 266.724 * eoc
                g310 = (-346.844 + 1582.851 * em - 2415.925 * emsq
                        + 1246.113 * eoc)
                g322 = (-342.585 + 1554.908 * em - 2366.899 * emsq
                        + 1215.972 * eoc)
                g410 = (-1052.797 + 4758.686 * em - 7193.992 * emsq
                        + 3651.957 * eoc)
                g422 = (-3581.690 + 16178.110 * em - 24462.770 * emsq
                        + 12422.520 * eoc)
                if em > 0.715:
                    g520 = (-5149.66 + 29936.92 * em - 54087.36 * emsq
                            + 31324.56 * eoc)
                else:
                    g520 = 1464.74 - 4664.75 * em + 3763.64 * emsq
            if em < 0.7:
                g533 = (-919.22770 + 4988.6100 * em - 9064.7700 * emsq
                        + 5542.21 * eoc)
                g521 = (-822.71072 + 4568.6173 * em - 8491.4146 * emsq
                        + 5337.524 * eoc)
                g532 = (-853.66600 + 4690.2500 * em - 8624.7700 * emsq
                        + 5341.4 * eoc)
            else:
                g533 = (-37995.780 + 161616.52 * em - 229838.20 * emsq
                        + 109377.94 * eoc)
                g521 = (-51752.104 + 218913.95 * em - 309468.16 * emsq
                        + 146349.42 * eoc)
                g532 = (-40023.880 + 170470.89 * em - 242699.48 * emsq
                        + 115605.82 * eoc)
            sini2 = sinim * sinim
            f220 = 0.75 * (1.0 + 2.0 * cosim + cosisq)
            f221 = 1.5 * sini2
            f321 = 1.875 * sinim * (1.0 - 2.0 * cosim - 3.0 * cosisq)
            f322 = -1.875 * sinim * (1.0 + 2.0 * cosim - 3.0 * cosisq)
            f441 = 35.0 * sini2 * f220
            f442 = 39.3750 * sini2 * sini2
            f522 = (9.84375 * sinim
                    * (sini2 * (1.0 - 2.0 * cosim - 5.0 * cosisq)
                       + 0.33333333 * (-2.0 + 4.0 * cosim + 6.0 * cosisq)))
            f523 = (sinim
                    * (4.92187512 * sini2
                       * (-2.0 - 4.0 * cosim + 10.0 * cosisq)
                       + 6.56250012 * (1.0 + 2.0 * cosim - 3.0 * cosisq)))
            f542 = (29.53125 * sinim
                    * (2.0 - 8.0 * cosim
                       + cosisq * (-12.0 + 8.0 * cosim + 10.0 * cosisq)))
            f543 = (29.53125 * sinim
                    * (-2.0 - 8.0 * cosim
                       + cosisq * (12.0 + 8.0 * cosim - 10.0 * cosisq)))
            xno2 = nm * nm
            ainv2 = aonv * aonv
            temp1 = 3.0 * xno2 * ainv2
            temp = temp1 * ROOT22
            self.d2201 = temp * f220 * g201
            self.d2211 = temp * f221 * g211
            temp1 *= aonv
            temp = temp1 * ROOT32
            self.d3210 = temp * f321 * g310
            self.d3222 = temp * f322 * g322
            temp1 *= aonv
            temp = 2.0 * temp1 * ROOT44
            self.d4410 = temp * f441 * g410
            self.d4422 = temp * f442 * g422
            temp1 *= aonv
            temp = temp1 * ROOT52
            self.d5220 = temp * f522 * g520
            self.d5232 = temp * f523 * g532
            temp = 2.0 * temp1 * ROOT54
            self.d5421 = temp * f542 * g521
            self.d5433 = temp * f543 * g533
            self.xlamo = math.fmod(el.mo + 2.0 * el.nodeo - 2.0 * theta,
                                   TWOPI)
            self.xfact = (self.mdot + self.dmdt
                          + 2.0 * (self.nodedot + self.dnodt - RPTIM) - nm)
        else:
            # 24 h near-geosynchronous resonance
            g200 = 1.0 + emsq * (-2.5 + 0.8125 * emsq)
            g310 = 1.0 + 2.0 * emsq
            g300 = 1.0 + emsq * (-6.0 + 6.60937 * emsq)
            f220 = 0.75 * (1.0 + cosim) * (1.0 + cosim)
            f311 = (0.9375 * sinim * sinim * (1.0 + 3.0 * cosim)
                    - 0.75 * (1.0 + cosim))
            f330 = 1.0 + cosim
            f330 = 1.875 * f330 * f330 * f330
            self.del1 = 3.0 * nm * nm * aonv * aonv
            self.del2 = 2.0 * self.del1 * f220 * g200 * Q22
            self.del3 = 3.0 * self.del1 * f330 * g300 * Q33 * aonv
            self.del1 = self.del1 * f311 * g310 * Q31 * aonv
            self.xlamo = math.fmod(el.mo + el.nodeo + el.argpo - theta,
                                   TWOPI)
            self.xfact = (self.mdot + xpidot - RPTIM + self.dmdt
                          + self.domdt + self.dnodt - nm)
        self.xli = self.xlamo
        self.xni = nm

    def _dspace(self, t: float, em, inclm, nodem, argpm, mm):
        """SDP4 'dspace': lunisolar secular propagation + the Euler-
        integrated resonance equations. Inputs already carry the J2/J4
        near-Earth secular terms; this adds the lunisolar rates and (for
        resonant orbits) replaces the mean anomaly / mean motion with the
        integrated values. Returns (em, inclm, nodem, argpm, mm, nm)."""
        el = self.el
        no = self.xnodp
        em = em + self.dedt * t
        inclm = inclm + self.didt * t
        argpm = argpm + self.domdt * t
        nodem = nodem + self.dnodt * t
        mm = mm + self.dmdt * t
        nm = no

        if self.irez != 0:
            theta = math.fmod(self.gsto + t * RPTIM, TWOPI)
            # restart the integrator whenever t moved backwards past the
            # last saved state (the instance memoises atime/xli/xni so
            # monotone sampling is O(1) per call)
            if (self.atime == 0.0 or t * self.atime <= 0.0
                    or abs(t) < abs(self.atime)):
                self.atime = 0.0
                self.xni = no
                self.xli = self.xlamo
            delt = STEP if t > 0.0 else -STEP
            xni, xli, atime = self.xni, self.xli, self.atime
            xndt = xnddt = xldot = 0.0
            while True:
                if self.irez == 2:
                    xomi = el.argpo + self.argpdot * atime
                    x2omi = xomi + xomi
                    x2li = xli + xli
                    xndt = (self.d2201 * math.sin(x2omi + xli - G22)
                            + self.d2211 * math.sin(xli - G22)
                            + self.d3210 * math.sin(xomi + xli - G32)
                            + self.d3222 * math.sin(-xomi + xli - G32)
                            + self.d4410 * math.sin(x2omi + x2li - G44)
                            + self.d4422 * math.sin(x2li - G44)
                            + self.d5220 * math.sin(xomi + xli - G52)
                            + self.d5232 * math.sin(-xomi + xli - G52)
                            + self.d5421 * math.sin(xomi + x2li - G54)
                            + self.d5433 * math.sin(-xomi + x2li - G54))
                    xldot = xni + self.xfact
                    xnddt = (self.d2201 * math.cos(x2omi + xli - G22)
                             + self.d2211 * math.cos(xli - G22)
                             + self.d3210 * math.cos(xomi + xli - G32)
                             + self.d3222 * math.cos(-xomi + xli - G32)
                             + self.d5220 * math.cos(xomi + xli - G52)
                             + self.d5232 * math.cos(-xomi + xli - G52)
                             + 2.0 * (self.d4410
                                      * math.cos(x2omi + x2li - G44)
                                      + self.d4422 * math.cos(x2li - G44)
                                      + self.d5421
                                      * math.cos(xomi + x2li - G54)
                                      + self.d5433
                                      * math.cos(-xomi + x2li - G54)))
                    xnddt *= xldot
                else:
                    xndt = (self.del1 * math.sin(xli - FASX2)
                            + self.del2 * math.sin(2.0 * (xli - FASX4))
                            + self.del3 * math.sin(3.0 * (xli - FASX6)))
                    xldot = xni + self.xfact
                    xnddt = (self.del1 * math.cos(xli - FASX2)
                            + 2.0 * self.del2 * math.cos(2.0 * (xli - FASX4))
                            + 3.0 * self.del3 * math.cos(3.0 * (xli - FASX6)))
                    xnddt *= xldot
                if abs(t - atime) < STEP:
                    ft = t - atime
                    break
                xli = xli + xldot * delt + xndt * STEP2
                xni = xni + xndt * delt + xnddt * STEP2
                atime += delt
            self.xni, self.xli, self.atime = xni, xli, atime
            nm = xni + xndt * ft + xnddt * ft * ft * 0.5
            xl = xli + xldot * ft + xndt * ft * ft * 0.5
            if self.irez != 1:
                mm = xl - 2.0 * nodem + 2.0 * theta
            else:
                mm = xl - nodem - argpm + theta
        return em, inclm, nodem, argpm, mm, nm

    def _dpper(self, t: float, ep, inclp, nodep, argpp, mp):
        """SDP4 'dpper': lunisolar long-period periodic corrections to
        the mean elements at output time (absolute form, peo..pho = 0 —
        the Vallado 2006 'improved' convention)."""
        # solar
        zm = self.zmos + ZNS * t
        zf = zm + 2.0 * ZES * math.sin(zm)
        sinzf = math.sin(zf)
        f2 = 0.5 * sinzf * sinzf - 0.25
        f3 = -0.5 * sinzf * math.cos(zf)
        ses = self.se2 * f2 + self.se3 * f3
        sis = self.si2 * f2 + self.si3 * f3
        sls = self.sl2 * f2 + self.sl3 * f3 + self.sl4 * sinzf
        sghs = self.sgh2 * f2 + self.sgh3 * f3 + self.sgh4 * sinzf
        shs = self.sh2 * f2 + self.sh3 * f3
        # lunar
        zm = self.zmol + ZNL * t
        zf = zm + 2.0 * ZEL * math.sin(zm)
        sinzf = math.sin(zf)
        f2 = 0.5 * sinzf * sinzf - 0.25
        f3 = -0.5 * sinzf * math.cos(zf)
        sel = self.ee2 * f2 + self.e3 * f3
        sil = self.xi2 * f2 + self.xi3 * f3
        sll = self.xl2 * f2 + self.xl3 * f3 + self.xl4 * sinzf
        sghl = self.xgh2 * f2 + self.xgh3 * f3 + self.xgh4 * sinzf
        shll = self.xh2 * f2 + self.xh3 * f3

        pe = ses + sel
        pinc = sis + sil
        pl = sls + sll
        pgh = sghs + sghl
        ph = shs + shll

        inclp = inclp + pinc
        ep = ep + pe
        sinip = math.sin(inclp)
        cosip = math.cos(inclp)
        if inclp >= 0.2:
            ph = ph / sinip
            pgh = pgh - cosip * ph
            argpp = argpp + pgh
            nodep = nodep + ph
            mp = mp + pl
        else:
            # Lyddane modification for low inclination
            sinop = math.sin(nodep)
            cosop = math.cos(nodep)
            alfdp = sinip * sinop + ph * cosop + pinc * cosip * sinop
            betdp = sinip * cosop - ph * sinop + pinc * cosip * cosop
            nodep = math.fmod(nodep, TWOPI)
            xls = mp + argpp + cosip * nodep + pl + pgh - pinc * nodep * sinip
            xnoh = nodep
            nodep = math.atan2(alfdp, betdp)
            if abs(xnoh - nodep) > math.pi:
                nodep += TWOPI if nodep < xnoh else -TWOPI
            mp = mp + pl
            argpp = xls - mp - cosip * nodep
        return ep, inclp, nodep, argpp, mp

    def propagate(self, tsince: float):
        """Position (km) and velocity (km/s) at tsince minutes from epoch."""
        if self.is_deep_space:
            return self._propagate_deep(tsince)
        el = self.el
        # secular gravity + drag
        xmdf = el.mo + self.mdot * tsince
        argpdf = el.argpo + self.argpdot * tsince
        xnoddf = el.nodeo + self.nodedot * tsince
        argp = argpdf
        xmp = xmdf
        tsq = tsince * tsince
        xnode = xnoddf + self.xnodcf * tsq
        tempa = 1.0 - self.c1 * tsince
        tempe = el.bstar * self.c4 * tsince
        templ = self.t2cof * tsq
        if not self.simple:
            delomg = self.omgcof * tsince
            delm = self.xmcof * ((1.0 + self.eta * math.cos(xmdf)) ** 3
                                 - self.delmo)
            temp = delomg + delm
            xmp = xmdf + temp
            argp = argpdf - temp
            tcube = tsq * tsince
            tfour = tsince * tcube
            tempa = tempa - self.d2 * tsq - self.d3 * tcube - self.d4 * tfour
            tempe = tempe + el.bstar * self.c5 * (math.sin(xmp) - self.sinmo)
            templ = templ + self.t3cof * tcube + tfour * (self.t4cof
                                                          + tsince * self.t5cof)
        a = self.aodp * tempa * tempa
        e = el.ecco - tempe
        e = min(max(e, 1.0e-6), 0.999999)
        xl = xmp + argp + xnode + self.xnodp * templ
        xn = XKE / a ** 1.5
        return self._kepler_tail(a, e, argp, xl, xnode, el.inclo, xn,
                                 self.aycof, self.xlcof, self.x3thm1,
                                 self.x1mth2, self.x7thm1, self.sinio,
                                 self.cosio)

    def _propagate_deep(self, tsince: float):
        """SDP4 propagation: near-Earth J2/J4 secular + simplified drag,
        lunisolar secular (+ resonance integration) via _dspace, lunisolar
        periodics via _dpper, then the shared Kepler/short-period tail
        with the inclination-dependent coefficients recomputed from the
        perturbed inclination."""
        el = self.el
        t = tsince
        xmdf = el.mo + self.mdot * t
        argpdf = el.argpo + self.argpdot * t
        xnoddf = el.nodeo + self.nodedot * t
        tsq = t * t
        nodem = xnoddf + self.xnodcf * tsq
        tempa = 1.0 - self.c1 * t
        tempe = el.bstar * self.c4 * t
        templ = self.t2cof * tsq

        em, inclm, nodem, argpm, mm, nm = self._dspace(
            t, el.ecco, el.inclo, nodem, argpdf, xmdf)
        if nm <= 0.0:
            raise RuntimeError(f"SDP4: non-positive mean motion {nm!r}")
        am = (XKE / nm) ** (2.0 / 3.0) * tempa * tempa
        nm = XKE / am ** 1.5
        em = em - tempe
        if em >= 1.0 or em < -0.001:
            raise RuntimeError(f"SDP4: eccentricity out of range {em!r}")
        em = max(em, 1.0e-6)
        mm = mm + self.xnodp * templ
        xlm = mm + argpm + nodem
        nodem = math.fmod(nodem, TWOPI)
        argpm = math.fmod(argpm, TWOPI)
        xlm = math.fmod(xlm, TWOPI)
        mm = math.fmod(xlm - argpm - nodem, TWOPI)

        ep, xincp, nodep, argpp, mp = self._dpper(t, em, inclm, nodem,
                                                  argpm, mm)
        if xincp < 0.0:
            xincp = -xincp
            nodep += math.pi
            argpp -= math.pi
        if ep < 0.0 or ep > 1.0:
            raise RuntimeError(f"SDP4: perturbed eccentricity {ep!r}")
        ep = min(max(ep, 1.0e-6), 0.999999)

        sinip = math.sin(xincp)
        cosip = math.cos(xincp)
        aycof = 0.25 * A3OVK2 * sinip
        if abs(cosip + 1.0) > 1.5e-12:
            xlcof = (0.125 * A3OVK2 * sinip
                     * (3.0 + 5.0 * cosip) / (1.0 + cosip))
        else:
            xlcof = (0.125 * A3OVK2 * sinip
                     * (3.0 + 5.0 * cosip) / 1.5e-12)
        cosisq = cosip * cosip
        x3thm1 = 3.0 * cosisq - 1.0
        x1mth2 = 1.0 - cosisq
        x7thm1 = 7.0 * cosisq - 1.0

        xl = mp + argpp + nodep
        return self._kepler_tail(am, ep, argpp, xl, nodep, xincp, nm,
                                 aycof, xlcof, x3thm1, x1mth2, x7thm1,
                                 sinip, cosip)

    def _kepler_tail(self, a, e, argp, xl, xnode, xinc, xn, aycof, xlcof,
                     x3thm1, x1mth2, x7thm1, sinio, cosio):
        """Long-period periodics, Kepler solve, J2 short-period
        periodics, and the TEME orientation — shared by the SGP4 and
        SDP4 branches (the deep-space branch passes coefficients
        recomputed from the lunisolar-perturbed inclination)."""
        beta = math.sqrt(1.0 - e * e)

        # long-period periodics
        axn = e * math.cos(argp)
        temp = 1.0 / (a * beta * beta)
        xll = temp * xlcof * axn
        aynl = temp * aycof
        xlt = xl + xll
        ayn = e * math.sin(argp) + aynl

        # Kepler solve for E + omega
        capu = math.fmod(xlt - xnode, TWOPI)
        epw = capu
        for _ in range(10):
            sinepw = math.sin(epw)
            cosepw = math.cos(epw)
            # capu = U - axn*sin(U) + ayn*cos(U)  (U = E + omega;
            # e*sinE expanded in the axn/ayn basis)
            f = capu - epw + axn * sinepw - ayn * cosepw
            df = -1.0 + axn * cosepw + ayn * sinepw
            delta = -f / df
            if abs(delta) > 0.95:
                delta = math.copysign(0.95, delta)
            epw = epw + delta
            if abs(delta) < 1.0e-12:
                break
        sinepw = math.sin(epw)
        cosepw = math.cos(epw)

        # short-period preliminaries
        ecose = axn * cosepw + ayn * sinepw
        esine = axn * sinepw - ayn * cosepw
        elsq = axn * axn + ayn * ayn
        pl = a * (1.0 - elsq)
        r = a * (1.0 - ecose)
        rdot = XKE * math.sqrt(a) * esine / r
        rfdot = XKE * math.sqrt(pl) / r
        betal = math.sqrt(1.0 - elsq)
        temp = esine / (1.0 + betal)
        cosu = a / r * (cosepw - axn + ayn * temp)
        sinu = a / r * (sinepw - ayn - axn * temp)
        u = math.atan2(sinu, cosu)
        sin2u = 2.0 * sinu * cosu
        cos2u = 2.0 * cosu * cosu - 1.0
        temp = 1.0 / pl
        temp1 = CK2 * temp
        temp2 = temp1 * temp

        # short-period periodics
        rk = (r * (1.0 - 1.5 * temp2 * betal * x3thm1)
              + 0.5 * temp1 * x1mth2 * cos2u)
        uk = u - 0.25 * temp2 * x7thm1 * sin2u
        xnodek = xnode + 1.5 * temp2 * cosio * sin2u
        xinck = xinc + 1.5 * temp2 * cosio * sinio * cos2u
        rdotk = rdot - xn * temp1 * x1mth2 * sin2u
        rfdotk = rfdot + xn * temp1 * (x1mth2 * cos2u
                                       + 1.5 * x3thm1)

        # orientation vectors -> TEME
        sinuk = math.sin(uk)
        cosuk = math.cos(uk)
        sinik = math.sin(xinck)
        cosik = math.cos(xinck)
        sinnok = math.sin(xnodek)
        cosnok = math.cos(xnodek)
        xmx = -sinnok * cosik
        xmy = cosnok * cosik
        ux = xmx * sinuk + cosnok * cosuk
        uy = xmy * sinuk + sinnok * cosuk
        uz = sinik * sinuk
        vx = xmx * cosuk - cosnok * sinuk
        vy = xmy * cosuk - sinnok * sinuk
        vz = sinik * cosuk

        pos = (rk * ux * XKMPER, rk * uy * XKMPER, rk * uz * XKMPER)
        vel_fac = XKMPER / 60.0
        vel = ((rdotk * ux + rfdotk * vx) * vel_fac,
               (rdotk * uy + rfdotk * vy) * vel_fac,
               (rdotk * uz + rfdotk * vz) * vel_fac)
        return pos, vel


def sgp4_ephemeris(line1: str, line2: str, times_s):
    """Sampled SGP4/SDP4 positions (km) at the given times (seconds from
    epoch). Deep-space TLEs (period >= 225 min) route through the SDP4
    branch (lunisolar + resonance terms)."""
    import numpy as np

    prop = SGP4(elements_from_tle(line1, line2))
    return np.asarray([prop.propagate(t / 60.0)[0] for t in times_s])


def is_deep_space(line1: str, line2: str) -> bool:
    """True when the TLE's recovered period is >= 225 min (SDP4 class)."""
    return SGP4(elements_from_tle(line1, line2)).is_deep_space
