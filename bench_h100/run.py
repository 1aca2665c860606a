"""Run one cell of the benchmark of nbody_tpu_torch on this machine's cards:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result line (one JSON object) last on
standard output; see harness.py."""

import sys
from pathlib import Path

# The checkout's root, in place of this directory (whose module names
# must not shadow the standard library's).
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from bench_h100 import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
