"""busbw: nccl-tests' bus bytes of every call the window completed, over
its length, in GB/s (``roofline.bus_bytes``)."""


def read(run):
    if not run.window.get("calls"):
        return None
    return run.window["bus_bytes"] / run.window["seconds"] / 1e9
