"""ring_copy_ms_per_tick: device time of the operations with the role
"ring_copy" (the ring's peer copies between cards: rotations, reduces,
replicated grids, gathers) in the traced window, summed over the cards,
per tick, in ms."""


def read(run):
    s = run.summary
    if s is None or not s["roles"].get("ring_copy"):
        return None
    return s["roles"]["ring_copy"] / s["work"]["ticks"] * 1e3
