"""Galaxy initial conditions (torch RNG).

PyTorch counterpart of ``nbody_tpu.models.galaxy``: the same IC model on
an explicit ``torch.Generator``. Torch's and JAX's generators give
different numbers from one seed, so the port's own ICs match the JAX
package's statistically, and runs that must start from the JAX ICs read
the committed fixture (``load_disk_fixture``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

DATA_DIR = Path(__file__).resolve().parent.parent / "data"


def create_disk_galaxy(generator: torch.Generator, num_stars: int = 5000,
                       galaxy_radius: float = 10.0,
                       core_mass_fraction: float = 0.3, G: float = 0.001,
                       device=None) -> Tensors:
    """Exponential-disk galaxy with bulge-dominated inner region and
    near-circular orbits (reference: galaxy.py:10-92).

    Radii via inverse-CDF sampling of P(r) ~ exp(-r/scale) truncated at
    2*galaxy_radius; tangential velocities from an analytic bulge+disk
    enclosed-mass model; 10% isotropic velocity dispersion. Drawn on the
    generator's device, returned on ``device`` (default: the same)."""
    gen_dev = generator.device
    scale = galaxy_radius / 3.0
    max_r = galaxy_radius * 2.0

    u = torch.rand(num_stars, generator=generator, device=gen_dev)
    radii = -scale * torch.log(1.0 - u * (1.0 - math.exp(-max_r / scale)))
    radii = torch.clamp(radii, 0.1, max_r)
    angles = torch.rand(num_stars, generator=generator,
                        device=gen_dev) * 2.0 * math.pi

    positions = torch.stack([radii * torch.cos(angles),
                             radii * torch.sin(angles)], dim=-1)
    masses = torch.ones(num_stars, dtype=torch.float32, device=gen_dev)
    total_mass = float(num_stars)

    # Enclosed mass: quadratic bulge inside core_radius, exponential-disk
    # cumulative profile outside (reference: galaxy.py:61-76).
    core_radius = galaxy_radius * 0.2
    bulge = core_mass_fraction * total_mass * (radii / core_radius) ** 2
    disk = ((1.0 - core_mass_fraction) * total_mass
            * (1.0 - (1.0 + radii / scale) * torch.exp(-radii / scale))
            / (1.0 - 2.0 * math.exp(-max_r / scale)))
    enclosed = torch.where(radii < core_radius, bulge,
                           core_mass_fraction * total_mass + disk)

    v_circ = torch.sqrt(G * enclosed / torch.clamp(radii, min=0.1))
    dispersion = 0.1 * v_circ.mean()
    velocities = torch.stack([-v_circ * torch.sin(angles),
                              v_circ * torch.cos(angles)], dim=-1)
    velocities = velocities + torch.randn(
        velocities.shape, generator=generator, device=gen_dev) * dispersion
    device = gen_dev if device is None else device
    return (positions.to(device), velocities.to(device), masses.to(device))


def load_disk_fixture(num_stars: int = 5000, seed: int = 42,
                      device=None) -> Tensors:
    """The JAX package's disk ICs, ``create_disk_galaxy(PRNGKey(seed),
    num_stars)`` on the CPU, committed as ``data/disk_s{N}_seed{S}.npz``:
    the ICs the torch-reference trajectories under
    ``tools/reference_cache/`` were made from."""
    path = DATA_DIR / f"disk_s{num_stars}_seed{seed}.npz"
    with np.load(path) as blob:
        return tuple(torch.as_tensor(blob[k], device=device)
                     for k in ("positions", "velocities", "masses"))
