"""The program's own spans in a traced sub-window, and the device work
launched inside them.

The port opens a ``torch.profiler.record_function`` range for each span
it records (``ytk_mp4j_tpu_torch.obs.spans.span``) while a profiler
runs: ``gbdt::round``, ``gbdt::level`` and the round's phases
``gbdt::<phase>``, ``ring::<mode>`` and its child ``ring::wait``. They
are host ranges of the trace, on the clock of its launches, and ranges of
one name do not overlap one another. A program that opens none of them
leaves every reader here with nothing to read: each returns None.
"""

from __future__ import annotations

import bisect

GBDT_PHASES = ("gradients", "histograms", "fold", "splits", "route",
               "leaf_sums", "margins")
RING_MODES = ("allreduce", "reduce_scatter", "allgather")


def ranges(trace, name: str) -> list:
    """[(start, end)] (us) of the host ranges named ``name``, by start."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in trace.host
                  if e.get("name") == name)


def launched_in(trace, name: str) -> set:
    """Correlation ids of the launches made inside ``name`` ranges."""
    spans = ranges(trace, name)
    starts = [lo for lo, _ in spans]
    out = set()
    for e in trace.launches:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] <= spans[i][1]:
            out.add(e.get("args", {}).get("correlation"))
    return out


def device_s(trace, name: str):
    """Device seconds of the work launched inside ``name`` ranges, or None
    where the trace holds no such range."""
    if trace is None or not ranges(trace, name):
        return None
    corr = launched_in(trace, name)
    return trace.device_s(
        lambda e: e.get("args", {}).get("correlation") in corr)


def phase_ms_per_tree(run, phase: str):
    """Device ms a round of the work launched inside ``gbdt::<phase>``
    spans, over the traced window's rounds."""
    trees = run.traced.get("trees")
    spent = device_s(run.trace, "gbdt::" + phase)
    if not trees or spent is None:
        return None
    return 1e3 * spent / trees


def self_us(trace, names, child: str):
    """Mean host time (us) of the ranges named in ``names`` outside the
    ``child`` ranges that lie inside them, or None where there are none."""
    outer = sorted(r for n in names for r in ranges(trace, n))
    if not outer:
        return None
    inner = ranges(trace, child)
    starts = [lo for lo, _ in inner]
    total = 0.0
    for lo, hi in outer:
        total += hi - lo
        i = bisect.bisect_left(starts, lo)
        while i < len(inner) and inner[i][1] <= hi:
            total -= inner[i][1] - inner[i][0]
            i += 1
    return total / len(outer)
