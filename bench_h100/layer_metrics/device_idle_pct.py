"""device_idle_pct: the share of the traced window in which no device
operation ran (the union of the profiler's device events), in %."""


def read(run):
    s = run.summary
    if s is None or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
