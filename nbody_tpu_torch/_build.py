"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled with nvcc, at first use, into one
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

No ``--use_fast_math``: the int-sim chain needs the accurate logf/expf
(a different log moves the log-grid bin edges). The library lands in
``build/nbody_tpu_torch/<hash>/`` at the repository root, keyed by a hash
of the sources and the flags, so an edit rebuilds and a rerun reuses it.
Only the repository's own sources are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "nbody_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the build this process ran (ptxas -v)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of nbody_tpu_torch cannot be built")
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, sources) -> None:
    global BUILD_LOG
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{BUILD_LOG}")
    os.replace(tmp, out)


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nbody_sym_force_tile.argtypes = []
    lib.nbody_sym_force_tile.restype = i
    lib.nbody_sym_force.argtypes = [p, p, p, i, i, i, i, f, f, i, p, p, p]
    lib.nbody_sym_force.restype = i
    lib.nbody_max_d2.argtypes = [p, i, i, p, p, i, p, p]
    lib.nbody_max_d2.restype = i


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            out = BUILD_ROOT / _digest(sources) / "libnbody_hopper.so"
            if not out.exists():
                _compile(out, sources)
            lib = ctypes.CDLL(str(out))
            _bind(lib)
            _lib = lib
        return _lib
