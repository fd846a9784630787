"""ring.allgather_roofline: the least time of the traced window's
allgather calls (``roofline.ring_seconds``) over the device time of
the work launched inside the program's ``ring::allgather`` spans (the
ring kernel and its error word's fill)."""

from portbench import roofline
from portbench.spans import device_s


def read(run):
    calls = [c for c in run.traced.get("ring_calls") or ()
             if c[0] == "allgather"]
    spent = device_s(run.trace, "ring::allgather")
    if not calls or not spent:
        return None
    return 100 * sum(roofline.ring_seconds(*c) for c in calls) / spent
