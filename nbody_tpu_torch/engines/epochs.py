"""Cosmic epoch taxonomy shared by every cosmological engine.

Single source of truth replacing per-engine duplicates
(reference: universe_2d.py:241-281, universe_genesis.py:98-136).
"""

from __future__ import annotations

import dataclasses
import enum


class CosmicEpoch(enum.Enum):
    RECOMBINATION = "cmb"
    DARK_AGES = "dark_ages"
    FIRST_STARS = "first_stars"
    REIONIZATION = "reion"
    GALAXY_FORMATION = "galaxies"
    PEAK_SF = "peak_sf"
    DARK_ENERGY = "dark_energy"
    PRESENT = "now"


@dataclasses.dataclass(frozen=True)
class EpochInfo:
    name: str
    redshift: float
    time_gyr: float
    description: str
    color: str


EPOCHS = {
    CosmicEpoch.RECOMBINATION: EpochInfo("CMB/Recombination", 1089, 0.00038,
                                         "Photons decouple", "#ff6b6b"),
    CosmicEpoch.DARK_AGES: EpochInfo("Dark Ages", 100, 0.017,
                                     "No stars yet", "#2c3e50"),
    CosmicEpoch.FIRST_STARS: EpochInfo("First Stars", 20, 0.18,
                                       "Pop III stars ignite", "#f39c12"),
    CosmicEpoch.REIONIZATION: EpochInfo("Reionization", 7.7, 0.7,
                                        "UV ionizes IGM", "#9b59b6"),
    CosmicEpoch.GALAXY_FORMATION: EpochInfo("Galaxy Formation", 6, 0.94,
                                            "First galaxies", "#3498db"),
    CosmicEpoch.PEAK_SF: EpochInfo("Peak Star Formation", 2, 3.3,
                                   "Cosmic noon", "#2ecc71"),
    CosmicEpoch.DARK_ENERGY: EpochInfo("Dark Energy Era", 0.4, 9.8,
                                       "Acceleration begins", "#1abc9c"),
    CosmicEpoch.PRESENT: EpochInfo("Present Day", 0, 13.8, "Now", "#ecf0f1"),
}


def get_current_epoch(z: float) -> CosmicEpoch:
    """Epoch thresholds (reference: universe_2d.py:272-281)."""
    if z > 1000:
        return CosmicEpoch.RECOMBINATION
    if z > 30:
        return CosmicEpoch.DARK_AGES
    if z > 15:
        return CosmicEpoch.FIRST_STARS
    if z > 6:
        return CosmicEpoch.REIONIZATION
    if z > 3:
        return CosmicEpoch.GALAXY_FORMATION
    if z > 1:
        return CosmicEpoch.PEAK_SF
    if z > 0.3:
        return CosmicEpoch.DARK_ENERGY
    return CosmicEpoch.PRESENT
