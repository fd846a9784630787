"""ring.host_us_per_call: the mean host time of the traced window's
collective calls (the program's ``ring::<mode>`` spans) outside their
``ring::wait`` child, the host's wait for the kernel's error word: the
plan, the output's and the error word's allocation, the launch."""

from portbench.spans import RING_MODES, self_us


def read(run):
    if run.trace is None:
        return None
    return self_us(run.trace, ["ring::" + m for m in RING_MODES],
                   "ring::wait")
