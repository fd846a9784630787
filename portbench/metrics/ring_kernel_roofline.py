"""ring_kernel_roofline: the least time of every collective call in the
traced window (``roofline.ring_seconds``) over the device time of the
ring kernels (device events whose name starts with ``ring_``)."""

from portbench import roofline
from portbench.profiling import kernel_name


def read(run):
    calls = run.traced.get("ring_calls")
    if not calls or run.trace is None:
        return None
    spent = run.trace.device_s(
        lambda e: kernel_name(e["name"]).startswith("ring_"))
    if spent <= 0:
        return None
    return 100 * sum(roofline.ring_seconds(*c) for c in calls) / spent
