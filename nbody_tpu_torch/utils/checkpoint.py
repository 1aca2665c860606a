"""Checkpoint / resume for long runs.

PyTorch counterpart of ``nbody_tpu.utils.checkpoint``'s npz path (the
reference has no resume capability, only terminal-state JSON exports:
simulation.py:160-168). A state is a NamedTuple of tensors and host
scalars — ``ParticleState`` / ``BaselineState`` of the direct engine,
``CosmoState`` of the PM engine — saved field by field into
``ckpt_<step>.npz`` with JSON metadata beside it, and restored into the
structure, dtypes and device of a template state.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


class CheckpointManager:
    """Periodic checkpoint writer/reader keyed by step number."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _ckpts(self):
        return sorted(self.directory.glob("ckpt_*.npz"),
                      key=lambda p: int(p.stem.split("_")[1]))

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, metadata: dict | None = None):
        """Save a NamedTuple state + JSON metadata at ``step``."""
        fields = {name: (v.detach().cpu().numpy()
                         if isinstance(v, torch.Tensor) else np.asarray(v))
                  for name, v in zip(state._fields, state)}
        np.savez(self.directory / f"ckpt_{step}.npz", **fields)
        (self.directory / f"ckpt_{step}.meta.json").write_text(
            json.dumps({"metadata": metadata or {},
                        "type": type(state).__name__}, default=str))
        self._prune()

    def _prune(self):
        ckpts = self._ckpts()
        while len(ckpts) > self.max_to_keep:
            victim = ckpts.pop(0)
            victim.unlink(missing_ok=True)
            victim.with_suffix(".meta.json").unlink(missing_ok=True)

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        ckpts = self._ckpts()
        return int(ckpts[-1].stem.split("_")[1]) if ckpts else None

    def restore(self, step: int, template: Any) -> Any:
        """Restore into the structure of ``template``: each tensor field on
        the template's device with its dtype, each host scalar as the
        template's type."""
        with np.load(self.directory / f"ckpt_{step}.npz") as data:
            values = []
            for name, t in zip(template._fields, template):
                v = data[name]
                if isinstance(t, torch.Tensor):
                    values.append(torch.from_numpy(v).to(device=t.device,
                                                         dtype=t.dtype))
                else:
                    values.append(type(t)(v.item()))
        return type(template)(*values)

    def restore_to_sharding(self, step: int, template: Any, mesh) -> Any:
        """Restore a checkpoint onto a ``parallel.ring.ParticleMesh``,
        possibly of another shape than the one it was saved from: every
        tensor on the mesh's first device, where the one controller keeps
        a resident state (the sharded runners pad it to their shard
        boundary on entry); host scalars as the template's type."""
        state = self.restore(step, template)
        home = mesh.devices[0]
        return type(state)(*(v.to(home) if isinstance(v, torch.Tensor)
                             else v for v in state))

    def load_metadata(self, step: int) -> dict:
        p = self.directory / f"ckpt_{step}.meta.json"
        return (json.loads(p.read_text()).get("metadata", {})
                if p.exists() else {})


@dataclasses.dataclass
class ResumableRun:
    """Helper that wires a DirectSimulation to periodic checkpoints."""

    sim: Any
    manager: CheckpointManager
    checkpoint_every: int = 1000

    def run(self, total_ticks: int):
        """Run to total_ticks, resuming from the latest checkpoint."""
        latest = self.manager.latest_step()
        if latest is not None and latest > int(self.sim.state.tick):
            self.sim.state = self.manager.restore(latest, self.sim.state)
            print(f"  resumed from checkpoint at tick {latest}")
        while int(self.sim.state.tick) < total_ticks:
            chunk = min(self.checkpoint_every,
                        total_ticks - int(self.sim.state.tick))
            self.sim.step(chunk)
            self.manager.save(int(self.sim.state.tick), self.sim.state,
                              {"precision": self.sim.quantizer.mode.value})
        return self.sim
