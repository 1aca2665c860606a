"""ring_copy_roofline: the least time of the traced units' peer copies
(the bytes that the ring's counters say crossed cards,
``parallel.ring.TRAFFIC["moved_bytes_peer"]``, as the entry sums them a
unit, over one H100 SXM's NVLink rate in one direction) over the device
time of the operations with the role "ring_copy" there, in %. A program
without the counters reads nothing."""

# NVIDIA's published 900 GB/s of NVLink per H100 SXM is both directions
# together: 450 GB/s a direction.
NVLINK_BYTES_PER_S = 450e9


def read(run):
    s = run.summary
    if s is None or not s["roles"].get("ring_copy"):
        return None
    moved = s["work"].get("moved_bytes_peer")
    if not moved:
        return None
    return 100.0 * moved / NVLINK_BYTES_PER_S / s["roles"]["ring_copy"]
