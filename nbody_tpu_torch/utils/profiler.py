"""Timing fence (PyTorch counterpart of ``nbody_tpu.utils.profiler.fence``)."""

from __future__ import annotations

import torch


def fence(x):
    """Wait until the work behind ``x`` has finished; returns x.

    PyTorch returns before the GPU finishes, so a wall-clock timing must
    end here: ``torch.cuda.synchronize`` on the device of the first CUDA
    tensor found in ``x`` (a tensor or a nested tuple/list/dict of them).
    Host values need no fence."""
    stack = [x]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
                return x
        elif isinstance(leaf, dict):
            stack.extend(leaf.values())
        elif isinstance(leaf, (tuple, list)):
            stack.extend(leaf)
    return x
