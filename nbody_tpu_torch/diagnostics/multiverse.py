"""Multiverse divergence: floating-point summation order as a physics probe.

PyTorch counterpart of ``nbody_tpu.diagnostics.multiverse`` (reference:
reality_glitch_tests.py:148-256): three "universes" from identical ICs,

* A: float32 on the dense force (``DirectSimulation(force_impl="dense")``),
* B: the same force with the source axis reversed before the reduction
  (the reference's ``torch.flip``: another rounding sequence),
* C: float16 intermediates on the dense force,

stepped in lockstep while measuring the pairwise state divergence, a
Lyapunov-rate fit and the zlib entropy. Each universe is bitwise
repeatable on its device; the card sums in other orders than the CPU, so
B's trajectory is held by the report (its divergence grows), not bit for
bit against another device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from nbody_tpu_torch.config import DEFAULT_SIM, SimConfig
from nbody_tpu_torch.diagnostics.glitch import measure_state_entropy
from nbody_tpu_torch.models.direct import DirectSimulation
from nbody_tpu_torch.ops.precision import Precision


def reversed_sum_accelerations(positions: torch.Tensor, masses: torch.Tensor,
                               cfg: SimConfig) -> torch.Tensor:
    """Force with the source-axis reduction order reversed
    (reference: reality_glitch_tests.py:163-181): the same math as the
    dense float32 force, another floating-point rounding sequence. Plain
    torch ops on the positions' device; the pair products are summed
    over the (reversed) source axis elementwise, off the tensor cores."""
    n = positions.shape[0]
    src = positions.flip(0)
    diff = src[None, :, :] - positions[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1) + cfg.softening_sq
    inv_d = torch.rsqrt(d2)
    inv_d3 = inv_d * inv_d * inv_d
    factor = cfg.G * masses.flip(0)[None, :] * inv_d3
    ids = torch.arange(n, device=positions.device)
    self_mask = ids.flip(0)[None, :] == ids[:, None]
    factor = torch.where(self_mask, torch.zeros((), device=factor.device),
                         factor)
    return torch.sum(factor[:, :, None] * diff, dim=1)


@dataclasses.dataclass
class MultiverseReport:
    ticks: List[int]
    divergence_reversed: List[float]   # |A - B| mean position divergence
    divergence_fp16: List[float]       # |A - C|
    lyapunov_reversed: float           # divergence growth rate (1/tick)
    lyapunov_fp16: float
    entropy_bits_a: float
    entropy_bits_b: float
    heisenberg_product: float          # dx * dv at the end (A vs B)


def _run_reversed(pos, vel, acc, m, cfg: SimConfig, num_steps: int):
    """num_steps kick-drift-kick steps with the reversed-sum force."""
    half_dt = cfg.dt / 2
    for _ in range(num_steps):
        vel = vel + acc * half_dt
        pos = pos + vel * cfg.dt
        acc = reversed_sum_accelerations(pos, m, cfg)
        vel = vel + acc * half_dt
    return pos, vel, acc


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class MultiverseSim:
    """Three universes stepped in lockstep on ``device`` (cuda unless
    named): A (standard engine), B (reversed-sum force on raw tensors),
    C (fp16)."""

    def __init__(self, positions, velocities, masses,
                 cfg: SimConfig = DEFAULT_SIM, device=None):
        self.cfg = cfg
        self.universe_a = DirectSimulation(positions, velocities, masses,
                                           precision=Precision.FLOAT32,
                                           cfg=cfg, force_impl="dense",
                                           device=device)
        self.universe_c = DirectSimulation(positions, velocities, masses,
                                           precision=Precision.FLOAT16,
                                           cfg=cfg, force_impl="dense",
                                           device=device)
        dev = self.universe_a.device
        self._b_state = tuple(
            torch.as_tensor(x).to(device=dev, dtype=torch.float32)
            for x in (positions, velocities, masses))
        self._b_acc = reversed_sum_accelerations(self._b_state[0],
                                                 self._b_state[2], cfg)

    def _step_b(self, num_steps: int):
        pos, vel, m = self._b_state
        pos, vel, acc = _run_reversed(pos, vel, self._b_acc, m, self.cfg,
                                      num_steps)
        self._b_state = (pos, vel, m)
        self._b_acc = acc

    def step(self, num_ticks: int = 10):
        """Advance all three universes in lockstep; returns the pair of
        mean position divergences (|A-B|, |A-C|), the incremental entry
        the live dashboard consumes."""
        self.universe_a.step(num_ticks)
        self._step_b(num_ticks)
        self.universe_c.step(num_ticks)
        pa = _host(self.universe_a.positions)
        db = float(np.abs(pa - _host(self._b_state[0])).mean())
        dc = float(np.abs(pa - _host(self.universe_c.positions)).mean())
        return db, dc

    def run(self, num_ticks: int = 200, interval: int = 20) -> MultiverseReport:
        ticks, div_b, div_c = [], [], []
        for t in range(0, num_ticks, interval):
            db, dc = self.step(interval)
            ticks.append(t + interval)
            div_b.append(db)
            div_c.append(dc)

        def lyapunov(divs):
            d = np.asarray(divs)
            valid = d > 1e-12
            if valid.sum() < 3:
                return 0.0
            x = np.asarray(ticks, float)[valid]
            y = np.log(d[valid])
            return float(np.polyfit(x, y, 1)[0])

        ent_a = measure_state_entropy(self.universe_a.positions,
                                      self.universe_a.velocities)
        ent_b = measure_state_entropy(self._b_state[0], self._b_state[1])

        pa, pb = _host(self.universe_a.positions), _host(self._b_state[0])
        va, vb = _host(self.universe_a.velocities), _host(self._b_state[1])
        dx = float(np.abs(pa - pb).mean())
        dv = float(np.abs(va - vb).mean())
        return MultiverseReport(
            ticks=ticks, divergence_reversed=div_b, divergence_fp16=div_c,
            lyapunov_reversed=lyapunov(div_b), lyapunov_fp16=lyapunov(div_c),
            entropy_bits_a=ent_a.bits_per_float,
            entropy_bits_b=ent_b.bits_per_float,
            heisenberg_product=dx * dv,
        )
