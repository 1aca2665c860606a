"""Kernel lab round 4: the equal-mass sym kernel's knobs on the card.

Counterpart of ``tools/kernel_lab_r4.py``'s ``main()`` (the TPU lab of
kernel #1's equal-mass path), with its protocol: an N=129024 disk (seed
42), float32 and int4 (forces quantized), 10 steps with a data dependency
(p += f(p) * 1e-6), wall time after a synchronise, best of 3 after one
warm-up (``kernel_lab.measure``). N = 129024 = 2016 x 64 = 1008 x 128 =
672 x 192 is a multiple of every variant's tile side. Rows, in
``main()``'s order, each knob's Hopper counterpart:

  prod                      the general sym_force
  uniform                   sym_force_uniform, the baseline
  A: base2 chain            log2 / exp2 with ln 2 folded in (int4 only)
  C: dual-acc (wide2)       one accumulator per pair parity: round 1's
                            2-wide variant
  D: wide-acc (wideacc)     one pass, reaction partials in registers,
                            one block reduction a tile
  B: register-tiled R=2     2 receivers a thread, tiles of 128
  B: register-tiled R=3     3 receivers a thread, tiles of 192
  A+D: base2 wide-acc       both (int4 only)

The masses are checked once; every row calls unguarded functions. Each
row first prints its largest relative difference against prod, then its
ms a step and pairs/s.

    python -m nbody_tpu_torch.lab.kernel_lab_r4 [--device cuda] [--n 129024]
        [--steps 10]
"""

from __future__ import annotations

import argparse

from nbody_tpu_torch.lab import kernel_lab

N = 129024
# (label, lab variant) after prod and uniform, in tools/kernel_lab_r4.py
# main()'s order.
ROWS = (("A: base2 chain", "base2"), ("C: dual-acc (wide2)", "wide2"),
        ("D: wide-acc (wideacc)", "wideacc"),
        ("B: register-tiled R=2 (rt2)", "rt2"),
        ("B: register-tiled R=3 (rt3)", "rt3"),
        ("A+D: base2 wide-acc (base2_wideacc)", "base2_wideacc"))


def rows_of(q) -> dict:
    """{label: lab variant} of mode q: the base-2 rows in int modes only."""
    return {label: v for label, v in ROWS
            if q.is_int or not kernel_lab.LAB_VARIANTS[v].base2}


def run(device, n: int = N, steps: int = 10, seed: int = 42) -> list:
    """The round-4 lab's table (kernel_lab.lab_table's rows)."""
    return kernel_lab.lab_table(device, n, steps, seed, rows_of,
                                tag="lab_r4")


def main(argv=None) -> list:
    from nbody_tpu_torch.cli import _resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=N,
                    help=f"stars (a multiple of 384; default {N})")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps per timed run (default 10)")
    args = ap.parse_args(argv)
    return run(_resolve_device(args.device), args.n, args.steps)


if __name__ == "__main__":
    main()
