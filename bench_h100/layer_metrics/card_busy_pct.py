"""card_busy_pct: the device time of every operation in the traced
window, summed over the cards, over the cell's cards times the window,
in %: the cards' mean busy share (``device_idle_pct`` is the union over
the cards, which a multi-card cell's one busy card fills)."""


def read(run):
    s = run.summary
    if s is None or not s["window_s"]:
        return None
    busy = sum(seconds for _, seconds in s["kernels"].values())
    return 100.0 * busy / (run.workload["chips"] * s["window_s"])
