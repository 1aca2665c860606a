"""Native host-side monitor kernels (C extension with a numpy fallback).

PyTorch port's own copy of ``nbody_tpu.native``: ``byte_entropy`` and
``float_census``, the hot per-tick host probes of the glitch layer
(``fastent.c`` beside this file, a copy of the JAX package's source, says
why they are native). At first use the source is compiled with the host C
compiler (``$CC``, else ``cc``) into ``build/nbody_tpu_torch/native/<hash>/``
at the repository root, never beside the source; if the build or the load
fails, the numpy versions below serve every call. ``route()`` says which
of the two this process uses. Both run on the host: they read snapshots
already copied off the device.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("nbody_tpu_torch.native")

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "fastent.c"
BUILD_ROOT = _HERE.parent.parent / "build" / "nbody_tpu_torch" / "native"
_MODULE = "nbody_tpu_torch.native._fastent"

_lock = threading.Lock()
_impl = None   # the extension module, False once the fallback is chosen
BUILD_ERROR = ""   # why the extension is not in use, when it is not


def _so_path() -> Path:
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(SOURCE.read_bytes() + include.encode()).hexdigest()
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_ROOT / h[:16] / f"_fastent{suffix}"


def _build(path: Path) -> None:
    """Compile fastent.c into ``path`` (one .so, no setup.py run); raises
    on failure."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC",
           f"-I{sysconfig.get_paths()['include']}", str(SOURCE), "-o",
           str(tmp), "-lm"]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, path)


def _load():
    global _impl, BUILD_ERROR
    with _lock:
        if _impl is None:
            path = _so_path()
            try:
                if not path.exists():
                    _build(path)
                loader = importlib.machinery.ExtensionFileLoader(_MODULE,
                                                                 str(path))
                spec = importlib.util.spec_from_file_location(
                    _MODULE, str(path), loader=loader)
                module = importlib.util.module_from_spec(spec)
                loader.exec_module(module)
                _impl = module
            except (OSError, ImportError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", b"") or b""
                BUILD_ERROR = (f"{type(e).__name__}: {e} "
                               f"{detail.decode(errors='replace')}").strip()
                logger.info("fastent build or load failed (%s); using the "
                            "numpy fallback", BUILD_ERROR)
                _impl = False
        return _impl


def route() -> str:
    """"native" when the C extension serves the calls, else "numpy"."""
    return "native" if _load() else "numpy"


def byte_entropy(buf: bytes) -> tuple[float, int]:
    """Shannon entropy in bits/byte + distinct byte count."""
    impl = _load()
    if impl:
        return impl.byte_entropy(buf)
    return byte_entropy_numpy(buf)


def byte_entropy_numpy(buf: bytes) -> tuple[float, int]:
    """The numpy version of byte_entropy."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    if arr.size == 0:
        return 0.0, 0
    counts = np.bincount(arr, minlength=256)
    q = counts[counts > 0] / arr.size
    return float(-(q * np.log2(q)).sum()), int((counts > 0).sum())


def float_census(buf: bytes) -> tuple[int, int, int, int, float]:
    """(nan, inf, subnormal, zero, min_nonzero_abs) of a float32 buffer."""
    impl = _load()
    if impl:
        return impl.float_census(buf)
    return float_census_numpy(buf)


def float_census_numpy(buf: bytes) -> tuple[int, int, int, int, float]:
    """The numpy version of float_census."""
    arr = np.frombuffer(buf, dtype=np.float32)
    bits = arr.view(np.uint32)
    mag = bits & np.uint32(0x7FFFFFFF)
    expo = mag >> 23
    nan = int(((expo == 255) & (mag != 0x7F800000)).sum())
    inf = int((mag == 0x7F800000).sum())
    sub = int(((expo == 0) & (mag != 0)).sum())
    zero = int((mag == 0).sum())
    finite_nonzero = (expo != 255) & (mag != 0)
    min_nonzero = (float(np.abs(arr[finite_nonzero]).min())
                   if finite_nonzero.any() else 0.0)
    return nan, inf, sub, zero, min_nonzero
