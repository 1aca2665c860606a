"""pairs_per_s: N^2 x ticks completed over the window's seconds (root
bench.py's N^2 convention), snapshots inside the window, by the host's
clock around whole chunks that end with the host holding their output."""


def read(run):
    if not run.work.get("pairs") or not run.window_s:
        return None
    return run.work["pairs"] / run.window_s
