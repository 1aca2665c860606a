"""force_roofline: the least time of the force evaluations in the traced
window (each N(N-1)/2 unordered pairs at the function's own FP32 count
for the cell's mode, D and equal masses, or its bytes, over the H100's
published peaks; bench_h100/roofline.py) over the device time of the
kernels with the role "force" there, in %."""

from bench_h100 import roofline


def read(run):
    s = run.summary
    if s is None or not s["roles"].get("force"):
        return None
    n, dim = run.traffic["n"], run.config["dim"]
    ms, _ = roofline.force_bound_ms(n, dim, run.traffic["mode"],
                                    run.config["equal_masses"])
    return 100.0 * s["work"]["ticks"] * ms * 1e-3 / s["roles"]["force"]
