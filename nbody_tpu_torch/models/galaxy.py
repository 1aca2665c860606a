"""Galaxy initial conditions (torch RNG).

PyTorch counterpart of ``nbody_tpu.models.galaxy``: the disk, test-disk,
Plummer-sphere and disk-in-NFW-halo IC models on an explicit
``torch.Generator``. Torch's and JAX's generators give
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


def _uniform(generator: torch.Generator, n: int, low: float = 0.0,
             high: float = 1.0) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device)
    return low + (high - low) * u


def create_test_galaxy(generator: torch.Generator, num_stars: int = 1000,
                       G: float = 0.001, device=None) -> Tensors:
    """Uniform disk with Keplerian velocities, for quick experiments
    (reference: galaxy.py:95-124; JAX ``create_test_galaxy``)."""
    radii = torch.sqrt(_uniform(generator, num_stars)) * 10.0 + 0.5
    angles = _uniform(generator, num_stars) * 2.0 * math.pi
    positions = torch.stack([radii * torch.cos(angles),
                             radii * torch.sin(angles)], dim=-1)
    masses = torch.ones(num_stars, dtype=torch.float32,
                        device=generator.device)
    v_circ = torch.sqrt(G * num_stars * 0.5 / radii)
    velocities = torch.stack([-v_circ * torch.sin(angles),
                              v_circ * torch.cos(angles)], dim=-1)
    device = generator.device if device is None else device
    return (positions.to(device), velocities.to(device), masses.to(device))


def create_plummer_sphere(generator: torch.Generator, num_stars: int = 5000,
                          scale_radius: float = 10.0, G: float = 0.001,
                          device=None) -> Tensors:
    """3-D Plummer sphere with isotropic Gaussian velocities (JAX
    ``create_plummer_sphere``): radii by inverse-CDF sampling of
    M(<r)/M = (r/a)^3 / (1 + (r/a)^2)^{3/2}, truncated at 10a; directions
    uniform on S^2; velocities Gaussian with the local dispersion
    sigma^2(r) = G M / (6 sqrt(r^2 + a^2)); all masses 1."""
    a = scale_radius
    total_mass = float(num_stars)
    # Inverse CDF: u = x^3/(1+x^2)^{3/2}  =>  x = u^{1/3}/sqrt(1-u^{2/3}),
    # with u capped so r <= 10a (u_max = CDF(10a)).
    u_max = 1000.0 / (1.0 + 100.0) ** 1.5
    u = _uniform(generator, num_stars, 1e-6, u_max)
    u23 = u ** (2.0 / 3.0)
    radii = torch.clamp(a * torch.sqrt(u23 / (1.0 - u23)), 0.05 * a, 10.0 * a)

    z = _uniform(generator, num_stars, -1.0, 1.0)
    phi = _uniform(generator, num_stars) * 2.0 * math.pi
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    positions = torch.stack([radii * s * torch.cos(phi),
                             radii * s * torch.sin(phi), radii * z], dim=-1)

    sigma = torch.sqrt(G * total_mass / (6.0 * torch.sqrt(radii * radii
                                                          + a * a)))
    velocities = torch.randn((num_stars, 3), generator=generator,
                             device=generator.device) * sigma[:, None]
    masses = torch.ones(num_stars, dtype=torch.float32,
                        device=generator.device)
    device = generator.device if device is None else device
    return (positions.to(device), velocities.to(device), masses.to(device))


def nfw_enclosed_mass(r: torch.Tensor, M_total, r_s: float) -> torch.Tensor:
    """Analytic NFW M(<r) = M_total * f(r/r_s) / f(10), with
    f(x) = ln(1+x) - x/(1+x) (reference: galaxy.py:127-139)."""
    x = r / r_s
    f_x = torch.log1p(x) - x / (1.0 + x)
    f_norm = math.log(11.0) - 10.0 / 11.0
    return M_total * f_x / f_norm


def create_galaxy_with_halo(generator: torch.Generator, num_stars: int = 5000,
                            galaxy_radius: float = 10.0,
                            halo_radius: float = 30.0,
                            dm_mass_ratio: float = 5.0, G: float = 0.001,
                            device=None) -> Tensors:
    """Disk galaxy embedded in an analytic NFW dark-matter halo: flat
    rotation-curve ICs (reference: galaxy.py:142-211; JAX
    ``create_galaxy_with_halo``). The halo adds to the circular
    velocities but adds no particles."""
    pos, _, masses = create_disk_galaxy(generator, num_stars, galaxy_radius,
                                        G=G)
    dm_total = masses.sum() * dm_mass_ratio
    r = torch.sqrt((pos * pos).sum(dim=-1))
    theta = torch.atan2(pos[:, 1], pos[:, 0])

    # Enclosed visible mass via sort + cumsum (reference: galaxy.py:186-192).
    order = torch.argsort(r, stable=True)
    enclosed_visible = torch.empty_like(masses).scatter_(
        0, order, torch.cumsum(masses[order], dim=0))
    enclosed_dm = nfw_enclosed_mass(r, dm_total, halo_radius)

    v_circ = torch.sqrt(G * (enclosed_visible + enclosed_dm)
                        / torch.clamp(r, min=0.1))
    vel = torch.stack([-v_circ * torch.sin(theta),
                       v_circ * torch.cos(theta)], dim=-1)
    dispersion = 0.05 * v_circ.mean()
    vel = vel + torch.randn(vel.shape, generator=generator,
                            device=generator.device) * dispersion
    device = generator.device if device is None else device
    return (pos.to(device), vel.to(device), masses.to(device))


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
