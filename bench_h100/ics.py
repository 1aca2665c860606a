"""Initial conditions of the benchmark's configurations, made from the seed
on the run's device (a ``torch.Generator`` there, a few large calls).

The benchmark makes the inputs itself and hands the same tensors to the
program and to the reference: each configuration's one realization from
its ``ic_seed``, ordered by the run's seed. The formulas are those of the upstream
project's ``galaxy.py`` (the exponential disk) and of the Plummer (1911)
sphere, as ``nbody_tpu_torch.models.galaxy`` states them; the draws are
the benchmark's own, so one seed gives the same ICs on every run.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    that fits 64 bits unsigned; larger ones are folded into that range)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 64))


def exponential_disk(gen: torch.Generator, n: int, cfg: dict) -> tuple:
    """D=2 exponential disk, bulge-dominated core, near-circular orbits
    with an isotropic dispersion of ``velocity_dispersion`` times the mean
    circular speed; all masses ``mass``."""
    dev = gen.device
    radius = cfg["galaxy_radius"]
    core_frac = cfg["core_mass_fraction"]
    scale = radius / 3.0
    max_r = radius * 2.0
    u = torch.rand((2, n), generator=gen, device=dev)
    radii = -scale * torch.log(1.0 - u[0] * (1.0 - math.exp(-max_r / scale)))
    radii = torch.clamp(radii, 0.1, max_r)
    angles = u[1] * 2.0 * math.pi
    pos = torch.stack([radii * torch.cos(angles),
                       radii * torch.sin(angles)], dim=-1)
    m = torch.full((n,), float(cfg["mass"]), dtype=torch.float32, device=dev)
    total = float(cfg["mass"]) * n
    core_r = radius * 0.2
    bulge = core_frac * total * (radii / core_r) ** 2
    disk = ((1.0 - core_frac) * total
            * (1.0 - (1.0 + radii / scale) * torch.exp(-radii / scale))
            / (1.0 - 2.0 * math.exp(-max_r / scale)))
    enclosed = torch.where(radii < core_r, bulge, core_frac * total + disk)
    v_circ = torch.sqrt(cfg["G"] * enclosed / torch.clamp(radii, min=0.1))
    sigma = cfg["velocity_dispersion"] * v_circ.mean()
    vel = torch.stack([-v_circ * torch.sin(angles),
                       v_circ * torch.cos(angles)], dim=-1)
    vel = vel + torch.randn((n, 2), generator=gen, device=dev) * sigma
    return pos.contiguous(), vel.contiguous(), m


def plummer_sphere(gen: torch.Generator, n: int, cfg: dict) -> tuple:
    """D=3 Plummer sphere of scale radius a: radii by inverse-CDF sampling
    of M(<r)/M = (r/a)^3 / (1 + (r/a)^2)^(3/2), truncated at 10a;
    directions uniform on the sphere; isotropic Gaussian velocities of the
    local dispersion sigma^2(r) = G M / (6 sqrt(r^2 + a^2)); all masses
    ``mass``."""
    dev = gen.device
    a = cfg["scale_radius"]
    total = float(cfg["mass"]) * n
    u_max = 1000.0 / (1.0 + 100.0) ** 1.5
    u = torch.rand((3, n), generator=gen, device=dev)
    cdf = 1e-6 + (u_max - 1e-6) * u[0]
    c23 = cdf ** (2.0 / 3.0)
    radii = torch.clamp(a * torch.sqrt(c23 / (1.0 - c23)), 0.05 * a, 10.0 * a)
    z = 2.0 * u[1] - 1.0
    phi = u[2] * 2.0 * math.pi
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    pos = torch.stack([radii * s * torch.cos(phi), radii * s * torch.sin(phi),
                       radii * z], dim=-1)
    sigma = torch.sqrt(cfg["G"] * total / (6.0 * torch.sqrt(radii * radii
                                                            + a * a)))
    vel = torch.randn((n, 3), generator=gen, device=dev) * sigma[:, None]
    m = torch.full((n,), float(cfg["mass"]), dtype=torch.float32, device=dev)
    return pos.contiguous(), vel.contiguous(), m


FAMILIES = {"exponential_disk": exponential_disk,
            "plummer_sphere": plummer_sphere}


def make(cfg: dict, n: int, seed: int, device) -> tuple:
    """(positions (n, D), velocities (n, D), masses (n,)) f32 on
    ``device``: configuration ``cfg``'s one realization of n stars (drawn
    from its ``ic_seed``), in the order that ``seed`` permutes them to.

    Every seed runs the same stars in another order: a realization's own
    shape sets part of the work (the pruned bounds pass finds the diameter
    among its candidates on one disk and falls back to the full pass on
    another), and an order changes the rounding of every sum."""
    family = FAMILIES[cfg["family"]]
    pos, vel, m = family(generator(cfg["ic_seed"], device), n, cfg)
    order = torch.randperm(n, generator=generator(seed, device),
                           device=device)
    return pos[order].contiguous(), vel[order].contiguous(), m[order]
