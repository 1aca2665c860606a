"""Universe Genesis: Big-Bang-to-now engine with the full epoch timeline.

PyTorch counterpart of ``nbody_tpu.engines.genesis`` (reference:
universe_genesis.py:217-784): sigma8/n_s-normalised primordial power
spectrum with BAO transfer wiggles, Zel'dovich displacement and
velocities, the full cosmic timeline, 64^3 PM evolution at dz=0.5, and a
dashboard + state export. ``GENESIS_TIMELINE`` mirrors the reference's
CosmicEpoch enum, all fifteen members, Planck through Present Day.

The ICs' phases come from a ``torch.Generator`` (``make_genesis_ics``),
so a seed gives other trajectories than JAX's; ``genesis_from_uniform``
builds the ICs from given uniform draws. Runs on the card unless given
``--device cpu``; ``--mesh`` runs the sharded PM.

Usage:
    python -m nbody_tpu_torch.engines.genesis --particles 32768 --precision int4
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.config import PLANCK18, Cosmology
from nbody_tpu_torch.engines.cosmo import RHO_CRIT, CosmologicalEngine, PMConfig
from nbody_tpu_torch.engines.universe2d import make_mesh
from nbody_tpu_torch.ops import pm


@dataclass(frozen=True)
class GenesisEpochInfo:
    name: str
    redshift: float
    time_desc: str
    description: str


GENESIS_TIMELINE = [
    GenesisEpochInfo("Planck Era", float("inf"), "t < 1e-43 s",
                     "Quantum gravity regime"),
    GenesisEpochInfo("Inflation", 1e26, "1e-36 to 1e-32 s",
                     "Exponential expansion seeds perturbations"),
    GenesisEpochInfo("Quark Epoch", 1e12, "1e-12 to 1e-6 s",
                     "Quark-gluon plasma"),
    GenesisEpochInfo("Hadron Epoch", 1e9, "1e-6 to 1 s",
                     "Protons and neutrons form"),
    GenesisEpochInfo("Nucleosynthesis", 4e8, "10 s to 20 min",
                     "Light elements fuse"),
    GenesisEpochInfo("Radiation Era", 3400, "20 min to 47 kyr",
                     "Radiation dominates expansion"),
    GenesisEpochInfo("Recombination/CMB", 1089, "380 kyr",
                     "Photons decouple"),
    GenesisEpochInfo("Dark Ages", 100, "380 kyr to 150 Myr",
                     "Cooling hydrogen, no stars"),
    GenesisEpochInfo("First Stars", 20, "150-400 Myr",
                     "Population III ignition"),
    GenesisEpochInfo("Reionization", 7.7, "150 Myr to 1 Gyr",
                     "UV ionizes the IGM"),
    GenesisEpochInfo("Galaxy Formation", 6, "400 Myr onwards",
                     "First galaxies assemble"),
    GenesisEpochInfo("Peak Star Formation", 2, "3.3 Gyr", "Cosmic noon"),
    GenesisEpochInfo("Matter Era", 1, "47 kyr to 9.8 Gyr",
                     "Matter dominates"),
    GenesisEpochInfo("Dark Energy Era", 0.4, "9.8 Gyr onward",
                     "Accelerating expansion"),
    GenesisEpochInfo("Present Day", 0.0, "13.8 Gyr", "Now"),
]


def genesis_from_uniform(uniform, num_side: int, cfg: PMConfig,
                         start_redshift: float,
                         cosmo: Cosmology = PLANCK18):
    """sigma8/n_s-normalised primordial ICs from ``uniform``, the
    (num_side,)*D draws in [0, 1) behind the random phases
    (reference: universe_genesis.py:268-348):
        P(k) = A_s (k/k_pivot)^(n_s-1) T(k)^2,
        T(k) = exp(-(k/0.1)^2) (1 + 0.15 sin(5 k / k_bao)),
        psi_k = delta_k / k^2, displacement *= D(z) * 10,
        v = a H f psi * 0.01.
    ``nbody_tpu.engines.genesis.make_genesis_ics`` after its draw, op for
    op, on ``uniform``'s device. Returns (positions, velocities, masses)."""
    uniform = torch.as_tensor(uniform, dtype=torch.float32)
    device = uniform.device
    dim, box, n = cfg.dim, cfg.box_size, num_side

    spacing = box / n
    axis = pm.jax_linspace(spacing / 2, box - spacing / 2, n)
    mesh = np.meshgrid(*([axis] * dim), indexing="ij")
    positions = torch.from_numpy(
        np.stack([m.reshape(-1) for m in mesh], axis=1)).to(device)

    k1d = pm.jax_fftfreq(n, box / n) * np.float32(2) * np.float32(math.pi)
    kvecs = [torch.from_numpy(k).to(device)
             for k in np.meshgrid(*([k1d] * dim), indexing="ij")]
    k_mag = torch.sqrt(sum(k * k for k in kvecs) + 1e-10)

    k_bao = 2 * math.pi / cosmo.bao_scale_mpc
    x = k_mag / 0.1
    transfer = torch.exp(-(x * x)) * (
        1.0 + 0.15 * torch.sin(k_mag / k_bao * 5.0))
    a_s = cosmo.sigma8 * 1e-4
    pk_ = (a_s * torch.pow(k_mag / cosmo.k_pivot + 1e-10, cosmo.n_s - 1.0)
           * (transfer * transfer))

    phases = uniform * 2 * math.pi
    delta_k = torch.sqrt(pk_) * torch.exp(1j * phases)
    psi_k = delta_k / (k_mag * k_mag + 1e-10)
    psi_k[(0,) * dim] = 0.0

    disps = [torch.real(torch.fft.ifftn(-1j * kv * psi_k)).reshape(-1)
             for kv in kvecs]
    displacement = torch.stack(disps, dim=1)

    growth = cosmo.growth_factor(start_redshift)
    displacement = displacement * growth * 10.0
    positions = (positions + displacement) % box

    a = 1.0 / (1.0 + start_redshift)
    f_growth = cosmo.omega_m ** 0.55
    H_z = cosmo.hubble_parameter(start_redshift)
    velocities = a * H_z * f_growth * displacement * 0.01

    total_mass = cosmo.omega_m * RHO_CRIT * box ** dim
    masses = torch.full((n ** dim,), total_mass / n ** dim,
                        dtype=torch.float32, device=device)
    return (positions.to(torch.float32), velocities.to(torch.float32),
            masses)


def make_genesis_ics(generator: torch.Generator, num_side: int,
                     cfg: PMConfig, start_redshift: float,
                     cosmo: Cosmology = PLANCK18):
    """Primordial ICs with their phases drawn from ``generator`` (a CPU
    ``torch.Generator``), built on the CPU."""
    uniform = torch.rand((num_side,) * cfg.dim, generator=generator,
                         dtype=torch.float32)
    return genesis_from_uniform(uniform, num_side, cfg, start_redshift,
                                cosmo)


class UniverseGenesis(CosmologicalEngine):
    """Genesis preset: 3-D, 64^3 grid, dz=0.5, full timeline
    (reference: universe_genesis.py:217-511)."""

    def __init__(self, num_particles: int = 32768,
                 box_size_mpc: float = 500.0, start_redshift: float = 100.0,
                 precision: str = "float32", seed: int = 42, **kw):
        kw.setdefault("dm_ratio", 0.0)  # genesis has no DM background field
        super().__init__(num_particles=num_particles,
                         box_size_mpc=box_size_mpc,
                         start_redshift=start_redshift, precision=precision,
                         seed=seed, dim=3, n_grid=64,
                         ic_fn=make_genesis_ics, **kw)
        self.epoch_transitions = []

    def _on_epoch_transition(self, tick: int, z: float, epoch):
        self.epoch_transitions.append(
            {"tick": tick, "redshift": z, "epoch": epoch.value})


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Universe Genesis: Big Bang to now (PyTorch / CUDA)")
    p.add_argument("--particles", type=int, default=32768)
    p.add_argument("--box-size", type=float, default=500.0)
    p.add_argument("--start-z", type=float, default=100.0)
    p.add_argument("--dz", type=float, default=0.5)
    p.add_argument("--precision", type=str, default="float32")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--output", type=str, default="output/genesis")
    p.add_argument("--animate", action="store_true",
                   help="rotating live dashboard instead of periodic "
                        "PNG frames (gif when headless)")
    p.add_argument("--mesh", action="store_true",
                   help="run the sharded PM pipeline over all local "
                        "devices of --device's type "
                        "(parallel/pm_sharded.py)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)

    print("COSMIC TIMELINE:")
    for info in GENESIS_TIMELINE:
        print(f"  {info.name:24s} z={info.redshift:<12} {info.time_desc}")

    mesh = make_mesh(args.mesh, args.device)
    u = UniverseGenesis(num_particles=args.particles,
                        box_size_mpc=args.box_size,
                        start_redshift=args.start_z,
                        precision=args.precision, seed=args.seed,
                        mesh=mesh, device=args.device)
    from nbody_tpu_torch.engines.dashboard3d import Dashboard3D

    dash = Dashboard3D(u, args.output)
    if args.animate:
        path = dash.animate(dz=args.dz, steps_per_frame=10, frames=20)
        if path:
            print(f"animation written to {path}")
        return None
    t0 = time.time()
    frames = 0
    while not u.completed:
        u.step(args.dz, num_steps=20)
        if u.tick % 60 == 0 or u.completed:
            dash.render_frame()
            frames += 1
    dash.render_frame(tag="final")
    wall = time.time() - t0

    sd = u.get_state_dict()
    np.savez(out / "genesis_final_state.npz",
             positions=sd["positions"], velocities=sd["velocities"],
             masses=sd["masses"])
    report = {k: v for k, v in sd.items()
              if k not in ("positions", "velocities", "masses")}
    report["bao_scale_mpc"] = u.get_bao_scale()
    report["clustering"] = u.get_clustering()
    report["epoch_transitions"] = u.epoch_transitions
    report["glitch_summary"] = u.glitch_detector.get_glitch_summary()
    report["energy_first"] = (u.history["energy"][0]
                              if u.history["energy"] else None)
    report["energy_last"] = (u.history["energy"][-1]
                             if u.history["energy"] else None)
    report["wall_seconds"] = wall
    (out / "genesis_report.json").write_text(
        json.dumps(report, indent=2, default=str))
    print(f"\nGenesis complete: z={args.start_z} -> {u.redshift:.2f} in "
          f"{wall:.1f}s ({u.tick} steps)")
    print(json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()
