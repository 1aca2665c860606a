"""Central configuration: simulation constants and Planck-2018 cosmology.

The reference duplicates its physical constants across four engines
(reference: universe_2d.py:169-181, universe_3d.py:110-113,
universe_genesis.py:63-91, ultimate_reality_engine.py:97-114) and embeds
simulation defaults in the direct engine (reference: simulation.py:36-39).
Here they live in one place, as frozen dataclasses that are hashable
(PyTorch counterpart of ``nbody_tpu.config``; pure Python).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Direct N-body simulation constants (reference: simulation.py:36-39)."""

    G: float = 0.001
    softening: float = 0.1
    dt: float = 0.01

    @property
    def softening_sq(self) -> float:
        return self.softening * self.softening


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Planck-2018 flat LambdaCDM parameters.

    Single source of truth for every cosmological engine
    (reference: universe_2d.py:169-181, universe_genesis.py:63-91).
    """

    H0: float = 67.4          # km/s/Mpc
    omega_m: float = 0.315
    omega_lambda: float = 0.685
    omega_b: float = 0.049
    omega_r: float = 9.0e-5
    sigma8: float = 0.811
    n_s: float = 0.965
    bao_scale_mpc: float = 147.0   # comoving sound horizon at drag epoch
    k_pivot: float = 0.05          # Mpc^-1
    T_cmb: float = 2.7255          # K

    def hubble_E(self, z: float):
        """Dimensionless Hubble rate E(z) = H(z)/H0 for flat LCDM."""
        a3 = (1.0 + z) ** 3
        a4 = (1.0 + z) ** 4
        return (self.omega_m * a3 + self.omega_r * a4 + self.omega_lambda) ** 0.5

    def hubble_parameter(self, z: float) -> float:
        """H(z) in km/s/Mpc."""
        return self.H0 * self.hubble_E(z)

    def growth_factor(self, z: float) -> float:
        """Approximate linear growth factor D(z), normalised to D(0)=1.

        Carroll, Press & Turner (1992) fitting form — same approximation
        class as the reference engines (universe_2d.py:228-234).
        """

        def g(zz: float) -> float:
            E2 = self.hubble_E(zz) ** 2
            om = self.omega_m * (1.0 + zz) ** 3 / E2
            ol = self.omega_lambda / E2
            return (
                2.5
                * om
                / (om ** (4.0 / 7.0) - ol + (1.0 + om / 2.0) * (1.0 + ol / 70.0))
            )

        return (g(z) / (1.0 + z)) / g(0.0)

    def cosmic_time_gyr(self, z: float, n_steps: int = 2048) -> float:
        """Age of the universe at redshift z in Gyr (numeric integral).

        Replaces the reference's lookup-table approach
        (universe_2d.py:188-217) with a direct log-spaced trapezoid rule.
        """
        # t(z) = (1/H0) * int_z^inf dz' / ((1+z') E(z'))
        # substitute a = 1/(1+z'):  t = (1/H0) int_0^a da' / (a' E(a'))
        a_end = 1.0 / (1.0 + z)
        # integrate in log(a) from tiny a to a_end: dt = d(ln a) / (H0 E)
        ln_a0, ln_a1 = math.log(1e-8), math.log(a_end)
        total = 0.0
        prev = None
        for i in range(n_steps + 1):
            ln_a = ln_a0 + (ln_a1 - ln_a0) * i / n_steps
            a = math.exp(ln_a)
            zz = 1.0 / a - 1.0
            f = 1.0 / self.hubble_E(zz)
            if prev is not None:
                total += 0.5 * (f + prev) * (ln_a1 - ln_a0) / n_steps
            prev = f
        # 1/H0 in Gyr: H0 [km/s/Mpc] -> 977.8 / H0 Gyr
        return total * 977.79222 / self.H0


PLANCK18 = Cosmology()
DEFAULT_SIM = SimConfig()
