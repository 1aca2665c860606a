"""The build's entry table against the kernel sources and their callers.

``nbody_tpu_torch._build.SIGNATURES`` declares, for each ``csrc/*.cu``
source, the C functions that ``library()`` loads and their ctypes
argument types. These tests read the sources as text (there is no nvcc
on the CPU) and hold, for each source:

* its ``extern "C" int nbody_*`` functions, by name and parameter count,
  equal to its ``SIGNATURES`` entry's names and ``argtypes`` lengths, so
  that no entry is left behind by a deleted kernel and none is loaded
  with the wrong arity;
* every one of its entries named somewhere in the package (other than
  ``_build.py``) or in ``chip_smoke.py``, as ``lib.<name>`` or as a
  string (the labs look their entries up by name), so that no entry
  outlives the code that called it.

    python -m pytest -q tests/test_torch_build_entries.py
"""

import re
from pathlib import Path

import pytest

from nbody_tpu_torch import _build

REPO = Path(__file__).resolve().parents[1]
# Every source, and every stem of the table (a stem without a source
# fails on reading it).
STEMS = sorted({p.stem for p in _build.CSRC.glob("*.cu")}
               | set(_build.SIGNATURES))
ENTRY = re.compile(r'extern\s+"C"\s+int\s+(nbody_\w+)\s*\(([^)]*)\)')


def _entries(stem: str) -> dict:
    """{name: parameter count} of the extern "C" functions of a source."""
    text = (_build.CSRC / f"{stem}.cu").read_text()
    out = {}
    for name, params in ENTRY.findall(text):
        params = params.strip()
        out[name] = 0 if params in ("", "void") else params.count(",") + 1
    return out


def _callers() -> str:
    """The text of every module that may call a kernel entry."""
    paths = [p for p in (REPO / "nbody_tpu_torch").rglob("*.py")
             if p.name != "_build.py"] + [REPO / "chip_smoke.py"]
    return "\n".join(p.read_text() for p in paths)


@pytest.mark.parametrize("stem", STEMS)
def test_entries_match_the_source(stem):
    want = {name: len(args)
            for name, args in _build.SIGNATURES.get(stem, {}).items()}
    assert _entries(stem) == want


@pytest.mark.parametrize("stem", STEMS)
def test_every_entry_has_a_caller(stem):
    text = _callers()
    unused = [name for name in _build.SIGNATURES.get(stem, {})
              if not re.search(rf"lib\.{name}\b|[\"']{name}[\"']", text)]
    assert not unused, f"{stem}.cu entries nothing calls: {unused}"
