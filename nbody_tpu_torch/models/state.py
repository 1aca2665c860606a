"""Particle state as NamedTuples of tensors.

PyTorch counterpart of ``nbody_tpu.models.state``. The degraded modes
keep f32 state; the float64 baseline keeps native f64 state (the JAX
package's double-double pairs are not needed on a GPU). ``tick`` is a
plain int: the engine loop counts ticks on the host, so advancing it
launches nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ParticleState(NamedTuple):
    """f32 state for all degraded precision modes."""

    positions: torch.Tensor      # (N, D) f32
    velocities: torch.Tensor     # (N, D) f32
    masses: torch.Tensor         # (N,) f32
    accelerations: torch.Tensor  # (N, D) f32
    tick: int

    @property
    def num_particles(self) -> int:
        return self.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.positions.shape[1]


class BaselineState(NamedTuple):
    """Native float64 state for the baseline mode."""

    positions: torch.Tensor      # (N, D) f64
    velocities: torch.Tensor     # (N, D) f64
    masses: torch.Tensor         # (N,) f64
    accelerations: torch.Tensor  # (N, D) f64
    tick: int

    @property
    def num_particles(self) -> int:
        return self.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.positions.shape[1]

    def to_f32(self) -> ParticleState:
        return ParticleState(
            positions=self.positions.to(torch.float32),
            velocities=self.velocities.to(torch.float32),
            masses=self.masses.to(torch.float32),
            accelerations=self.accelerations.to(torch.float32),
            tick=self.tick,
        )


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def make_state(positions, velocities, masses, device=None) -> ParticleState:
    positions = _tensor(positions, torch.float32, device)
    return ParticleState(
        positions=positions,
        velocities=_tensor(velocities, torch.float32, device),
        masses=_tensor(masses, torch.float32, device),
        accelerations=torch.zeros_like(positions),
        tick=0,
    )


def make_baseline_state(positions, velocities, masses,
                        device=None) -> BaselineState:
    positions = _tensor(positions, torch.float64, device)
    return BaselineState(
        positions=positions,
        velocities=_tensor(velocities, torch.float64, device),
        masses=_tensor(masses, torch.float64, device),
        accelerations=torch.zeros_like(positions),
        tick=0,
    )


def _f64_value(x) -> np.ndarray:
    """A double-double (anything with ``hi``/``lo``) summed in f64, else
    the array itself in f64."""
    if hasattr(x, "hi") and hasattr(x, "lo"):
        return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)
    return np.asarray(x, np.float64)


def from_jax_numpy(state, device=None):
    """The port's state from a JAX ``ParticleState`` or ``BaselineState``
    whose leaves were exported as numpy arrays (for example
    ``jax.tree.map(np.asarray, state)``). A double-double field marks the
    baseline: hi + lo is summed in f64 and the result is a BaselineState;
    otherwise a ParticleState in f32."""
    baseline = hasattr(state.positions, "hi")
    if baseline:
        return BaselineState(
            positions=_tensor(_f64_value(state.positions), torch.float64,
                              device),
            velocities=_tensor(_f64_value(state.velocities), torch.float64,
                               device),
            masses=_tensor(_f64_value(state.masses), torch.float64, device),
            accelerations=_tensor(_f64_value(state.accelerations),
                                  torch.float64, device),
            tick=int(np.asarray(state.tick)),
        )
    return ParticleState(
        positions=_tensor(state.positions, torch.float32, device),
        velocities=_tensor(state.velocities, torch.float32, device),
        masses=_tensor(state.masses, torch.float32, device),
        accelerations=_tensor(state.accelerations, torch.float32, device),
        tick=int(np.asarray(state.tick)),
    )


class CosmoState(NamedTuple):
    """State of the particle-mesh engine (``engines/cosmo.py``).

    ``redshift`` (f32-exact) and ``tick`` live on the host: the engine
    knows both from its schedule, so reading them never waits for the
    device (the JAX engine keeps device scalars and host shadows of them)."""

    positions: torch.Tensor   # (N, D) f32, comoving Mpc in [0, box)
    velocities: torch.Tensor  # (N, D) f32
    masses: torch.Tensor      # (N,) f32, in units of mass_unit_msun
    redshift: float
    tick: int


def cosmo_from_jax_numpy(state, device=None) -> CosmoState:
    """The port's CosmoState from a JAX ``CosmoState`` whose leaves were
    exported as numpy arrays (``jax.tree.map(np.asarray, state)``); the
    masses stay in the JAX engine's normalized units, whose
    ``mass_unit_msun`` goes with them
    (``CosmologicalEngine.load_jax_state``)."""
    return CosmoState(
        positions=_tensor(state.positions, torch.float32, device),
        velocities=_tensor(state.velocities, torch.float32, device),
        masses=_tensor(state.masses, torch.float32, device),
        redshift=float(np.float32(state.redshift)),
        tick=int(np.asarray(state.tick)),
    )
