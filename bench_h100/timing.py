"""The benchmark's kernel naming: a frozen copy of ``chip_smoke.py``'s
``kernel_name`` (commit 41d9088), which names the kernels of every trace
the harness reads."""

from __future__ import annotations


def kernel_name(key: str) -> str:
    """chip_smoke.py:537-541. A profiler kernel key without its namespace,
    return type and parameter list: "sym_force_tri<0, 2, true>"."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].strip()
