"""The control of the benchmark's check: the plain reference put in the
program's place and computed in bfloat16, the nearest precision below the
float32 state that the cells' modes run on. Its runs must come out not
correct; their numbers are the upper readings that the limits in
``limits/`` were set below.

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3

runs the cell's set-up and a window of one tick with its snapshot (a
chunk of CONTROL_TICKS) on the control for each seed, judges it as a run
is judged, and exits 0 only if every run came out not correct. With
``--sound`` it reads the program instead, for the lower readings: the
cell's set-up and a window of one unit a seed, in one process; every unit
integrates the same ticks from the ICs, so the numbers are those of a run
of any length. It then exits 0 only if every run came out correct. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from bench_h100 import harness, reference  # noqa: E402

CONTROL_DTYPE = torch.bfloat16
# The control's window: its readings need no more (each is of one state).
CONTROL_TICKS = 1


class ControlSim:
    """DirectSimulation's surface (``state``, ``run_with_history``) on the
    reference, every tensor and operation in ``dtype``."""

    def __init__(self, pos, vel, m, mode: str, cfg: dict,
                 dtype=CONTROL_DTYPE):
        self.mode, self.dtype = mode, dtype
        self.G, self.dt = cfg["G"], cfg["dt"]
        self.eps2, self.min_d2 = cfg["softening"] ** 2, cfg["min_dist_sq"]
        p, v, mm = pos.to(dtype), vel.to(dtype), m.to(dtype)
        self.gm = (self.G * m).to(dtype)
        self.state = SimpleNamespace(positions=p, velocities=v, masses=mm,
                                     accelerations=self._force(p), tick=0)

    def _force(self, p):
        levels = reference.LEVELS.get(self.mode)
        grid = None
        if levels is not None:
            lo, hi = reference.log_grid(p, self.eps2, self.min_d2)
            grid = (levels, self.min_d2, lo, hi)
        rows = torch.arange(p.shape[0], device=p.device)
        acc, _ = reference.accelerations(p, self.gm, rows, self.eps2,
                                         grid=grid, dtype=self.dtype)
        if levels is not None:
            acc, _ = reference.quantize_force(acc, levels)
        return acc.to(self.dtype)

    def run_with_history(self, num_ticks: int, snapshot_interval: int):
        s = self.state
        p, v, a = s.positions, s.velocities, s.accelerations
        kinetic, potential = [], []
        chunks = max(num_ticks // snapshot_interval, 1)
        steps = min(snapshot_interval, num_ticks)
        for _ in range(chunks):
            for _ in range(steps):
                half = v + a * (0.5 * self.dt)
                p = p + half * self.dt
                a = self._force(p)
                v = half + a * (0.5 * self.dt)
            kinetic.append(reference.kinetic(v, s.masses, dtype=self.dtype))
            potential.append(reference.potential(p, s.masses, self.G,
                                                 self.eps2, dtype=self.dtype))
        self.state = SimpleNamespace(positions=p, velocities=v,
                                     masses=s.masses, accelerations=a,
                                     tick=s.tick + chunks * steps)
        return SimpleNamespace(kinetic=np.asarray(kinetic),
                               potential=np.asarray(potential)), None


def factory(run, dtype=CONTROL_DTYPE):
    """The control as a program for ``harness.run_cell``."""
    return lambda pos, vel, m: ControlSim(pos, vel, m, run.traffic["mode"],
                                          run.config, dtype)


def run_control(workload: str, seed: int, device: str, manifest=None,
                traffic_overrides: dict | None = None) -> dict:
    """One control run of ``workload``: the result line (``correct``
    and ``checks`` are what matter)."""
    manifest = manifest or harness.Manifest()
    probe = harness.Run(manifest, workload, seed, 0, False, device,
                        traffic_overrides)
    overrides = {**(traffic_overrides or {}),
                 "snapshot_interval": CONTROL_TICKS}
    return harness.run_cell(workload, seed, 0, False, device, manifest,
                            program=factory(probe),
                            traffic_overrides=overrides)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sound", action="store_true",
                   help="read the program, not the control")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        print("error: the control runs at the cell's size on the card",
              file=sys.stderr)
        return 2
    as_expected = True
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.sound:
            line = harness.run_cell(args.workload, seed, 0, False, "cuda")
        else:
            line = run_control(args.workload, seed, "cuda")
        line.pop("_run")
        as_expected &= line["correct"] == args.sound
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "sound": args.sound, "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0 if as_expected else 1


if __name__ == "__main__":
    sys.exit(main())
