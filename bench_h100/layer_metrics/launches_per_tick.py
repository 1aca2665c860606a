"""launches_per_tick: the port's kernel launches (hopper_nbody.LAUNCHES,
every kernel and variant) over the window, per tick."""


def read(run):
    launches = run.stats.get("launches")
    ticks = run.work.get("ticks")
    total = sum(launches.values()) if launches else 0
    if not total or not ticks:
        return None
    return total / ticks
