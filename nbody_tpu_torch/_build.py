"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled with nvcc, at first use, into a
shared library of its own with a plain C interface, loaded with
``ctypes``. The nvcc processes of all sources start together and run in
parallel:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <stem>.so csrc/<stem>.cu

No ``--use_fast_math``: the int-sim chain needs the accurate logf/expf
(a different log moves the log-grid bin edges). The libraries land in
``build/nbody_tpu_torch/<hash>/`` at the repository root, keyed by a hash
of the sources, the shared headers (``csrc/*.cuh``) and the flags, so an
edit rebuilds and a rerun reuses them. Only the repository's own sources
are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "nbody_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _L = ctypes.c_uint, ctypes.c_longlong
# C functions of each source: name -> argtypes (every one returns an int).
SIGNATURES = {
    "sym_force": {
        "nbody_sym_force_tile": [],
        "nbody_sym_force_resident": [_I, _I, _I, _I],
        "nbody_sym_force": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P,
                            _P, _P, _P, _P, _I, _P, _I, _P, _P],
        "nbody_sym_force_lab": [_P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P,
                                _P, _P],
        "nbody_sym_force_one_pass": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                                     _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                                     _P],
        "nbody_int_table_sweep": [_P, _I, _F, _F, _U, _L, _P, _P, _P, _P],
        "nbody_int_table_bytes": [_I],
        "nbody_one_pass_receivers": [],
        "nbody_sym_force_one_pass_resident": [_I, _I, _I, _I],
    },
    "sym_force_lab": {
        "nbody_sym_force_lab_r4": [_P, _P, _P, _I, _I, _I, _F, _F, _I, _I,
                                   _P, _P, _P],
    },
    "sym_force_mxu": {
        "nbody_sym_force_mxu": [_P, _P, _I, _I, _F, _I, _P, _P, _P],
    },
    "max_dist_sq": {
        "nbody_max_d2": [_P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P],
        "nbody_pair_max_tiled": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                                 _P],
        "nbody_pair_max_geometry": [],
        "nbody_pair_max_tiled_resident": [_I],
        "nbody_max_d2_tiled": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P],
        "nbody_max_d2_tiled_resident": [_I],
    },
    "row_force": {
        "nbody_row_force_tiled": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _F, _F,
                                  _I, _I, _P, _P, _P],
        "nbody_row_force_geometry": [],
        "nbody_row_force_tiled_resident": [_I, _I, _I],
    },
    "pair_sym_force": {
        "nbody_pair_sym_force": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _F,
                                 _F, _I, _I, _P, _P, _P, _P, _P],
        "nbody_pair_sym_force_one_pass": [_P, _P, _I, _P, _P, _I, _P, _I, _I,
                                          _I, _F, _F, _I, _I, _P, _P, _P, _P,
                                          _I, _P, _P],
        "nbody_pair_sym_force_one_pass_resident": [_I, _I, _I],
    },
    "pair_pe_rows": {
        "nbody_pair_pe_rows": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                               _P],
        "nbody_pair_pe_rows_tiled": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P,
                                     _P, _P, _I, _P, _P, _P],
        "nbody_pair_pe_geometry": [],
        "nbody_pair_pe_tiled_resident": [_I],
    },
    "pm_deposit": {
        "nbody_pm_deposit_runs": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                                  _P],
    },
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the builds this process ran (ptxas -v)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of nbody_tpu_torch cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, stems) -> None:
    """One nvcc per source, all started at once; raises if any fails."""
    global BUILD_LOG
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for stem in stems:
        tmp = out_dir / f"{stem}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((stem, tmp, cmd, proc))
    logs, failed = [], []
    for stem, tmp, cmd, proc in jobs:
        log = proc.communicate()[0]
        logs.append(f"== {stem}.cu\n{log}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{stem}.so")
    BUILD_LOG = "".join(logs)
    if failed:
        raise RuntimeError("\n".join(failed))


def library():
    """The loaded kernels, building them first if needed: a namespace of
    the C functions of every source, with their ctypes signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _digest()
            missing = [s for s in SIGNATURES
                       if not (out_dir / f"lib{s}.so").exists()]
            if missing:
                _compile(out_dir, missing)
            fns = {}
            for stem, sigs in SIGNATURES.items():
                cdll = ctypes.CDLL(str(out_dir / f"lib{stem}.so"))
                for name, argtypes in sigs.items():
                    fn = getattr(cdll, name)
                    fn.argtypes = argtypes
                    fn.restype = _I
                    fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib
