"""bounds_ms_per_tick: device time of the kernels with the role "bounds"
(max_d2's launches and the candidates' top-k) in the traced window, per
tick, in ms."""


def read(run):
    s = run.summary
    if s is None or not s["roles"].get("bounds"):
        return None
    return s["roles"]["bounds"] / s["work"]["ticks"] * 1e3
