"""A traced sub-window: ``torch.profiler`` over a few seconds of the
cell's loop, and what the per-layer readers take from its trace.

The CUPTI guards are frozen copies. From ``chip_smoke.py``'s
``device_ms``: each profile first launches ``MARKER_LAUNCHES`` marker
kernels (``torch.cuda._sleep(1)``, ATen's ``spin_kernel``), which are
left out, because CUPTI loses the kernels of a profile's first launches.
From ``chip_smoke.py``'s ``profile_run``: only what starts after the
profiled range begins counts, a launch whose kernel the trace lacks is
counted as dropped, and the profile is taken again, ``ATTEMPTS`` times
at most, keeping the attempt that dropped the fewest.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

ATTEMPTS = 3
MARKER_LAUNCHES = 256
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# runtime and driver calls that launch a kernel, by name prefix
LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel",
               "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")
RANGE = "portbench::"          # prefix of the harness's labelled ranges
WINDOW = "portbench_window"    # the profiled range itself


def kernel_name(name: str) -> str:
    """A device event's name without namespace, template and arguments."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    return base.split("<")[0].strip().split(" ")[-1]


def labelled(label: str, fn):
    """``fn`` inside a profiler range ``portbench::<label>``."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(RANGE + label):
            return fn(*args, **kwargs)
    return run


@dataclass
class Trace:
    """The device events, launches and host ranges of one profiled
    window, in seconds (timestamps in microseconds, as the trace has)."""
    begin: float
    end: float
    device: list            # device events that start inside the window
    launches: list          # launch API events inside the window
    host: list              # host events (ops and ranges) inside it
    dropped: int
    items: dict = field(default_factory=dict)   # the driver's counts

    @property
    def window_s(self) -> float:
        return (self.end - self.begin) / 1e6

    def busy_spans(self, pred=None):
        """Merged [start, end) spans (us) of the device events that pass
        ``pred``, clipped to the window."""
        spans = sorted((max(e["ts"], self.begin),
                        min(e["ts"] + e["dur"], self.end))
                       for e in self.device if pred is None or pred(e))
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            elif b > a:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_spans()) / 1e6

    def device_s(self, pred) -> float:
        """Summed durations (s) of the device events that pass ``pred``."""
        return sum(e["dur"] for e in self.device if pred(e)) / 1e6

    def launched_in(self, label: str) -> set:
        """Correlation ids of launches made inside the labelled range
        ``portbench::<label>`` (such ranges do not overlap one another)."""
        ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.host
                        if e.get("name") == RANGE + label)
        starts = [lo for lo, _ in ranges]
        out = set()
        for e in self.launches:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= ranges[i][1]:
                out.add(e.get("args", {}).get("correlation"))
        return out

    def range_device_s(self, label: str) -> float:
        """Device seconds of the work launched inside ``label`` ranges."""
        corr = self.launched_in(label)
        return self.device_s(
            lambda e: e.get("args", {}).get("correlation") in corr)

    def top_ops(self, k: int = 10):
        """The device operations that took most time: [[name, s], ...]."""
        tot = {}
        for e in self.device:
            n = kernel_name(e["name"])
            tot[n] = tot.get(n, 0.0) + e["dur"] / 1e6
        return [[n, s] for n, s in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """The ``k`` longest idle gaps of the device, each named by what
        the host was doing at its middle (the innermost host op or range
        there): [[name, s], ...]."""
        gaps, at = [], self.begin
        for a, b in self.busy_spans():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.end > at:
            gaps.append((at, self.end))
        out = []
        for a, b in sorted(gaps, key=lambda ab: ab[0] - ab[1])[:k]:
            mid = (a + b) / 2
            inner = [e for e in self.host if e["ts"] <= mid <= e["ts"] + e[
                "dur"] and e.get("name") != WINDOW]
            name = (min(inner, key=lambda e: e["dur"])["name"] if inner
                    else "host: python")
            out.append([name, (b - a) / 1e6])
        return out


def _read(path: str) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW]
    if not win:
        return None
    begin, end = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    inside = [e for e in events if begin <= e["ts"] <= end]
    device = [e for e in inside if e.get("cat") in DEVICE_CATS]
    launches = [e for e in inside if e.get("name", "").startswith(
        LAUNCH_APIS)]
    host = [e for e in inside if e.get("cat") in ("cpu_op",
                                                  "user_annotation")]
    seen = {e.get("args", {}).get("correlation") for e in device}
    dropped = sum(1 for e in launches
                  if e.get("args", {}).get("correlation") not in seen)
    return Trace(begin, end, device, launches, host, dropped)


def profile(run_some, seconds: float):
    """Profile ``run_some(seconds)`` (which runs the cell's loop for about
    that long, synchronised at its end, and returns the driver's counts
    of what it ran) under the CUPTI guards; returns the kept
    :class:`Trace`, its ``items`` those counts, or None where no attempt
    saw a device event. A later attempt is made only while the best so
    far dropped launches."""
    best = None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        for _ in range(ATTEMPTS):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(MARKER_LAUNCHES):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                with torch.profiler.record_function(WINDOW):
                    items = run_some(seconds)
                    torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            tr = _read(path)
            if tr is not None and tr.device:
                tr.items = items
                if best is None or tr.dropped < best.dropped:
                    best = tr
                if not tr.dropped:
                    break
    finally:
        os.remove(path)
    return best
