"""snapshot_ms: device time of the kernels with the role "snapshot"
(pair_pe_rows, the radius and bound-fraction sorts) in the traced window,
per snapshot, in ms."""


def read(run):
    s = run.summary
    if s is None or not s["roles"].get("snapshot") \
            or not s["work"].get("snapshots"):
        return None
    return s["roles"]["snapshot"] / s["work"]["snapshots"] * 1e3
