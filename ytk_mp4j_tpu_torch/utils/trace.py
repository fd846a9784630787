"""Lightweight per-collective tracing (a copy of
``ytk_mp4j_tpu/utils/trace.py``, with two divergences: the profile window
is ``torch.profiler``'s, where the reference opens ``jax.profiler``'s,
and payload sizes count torch tensors by ``numel * element_size``).

The reference has no built-in profiling (SURVEY.md section 5: "at most
log-line timing in check programs"); this subsystem is the cheap win
named there. Zero overhead when disabled (one module-global check per
collective call); when enabled inside :class:`trace_collectives`, every
backend collective (socket, thread, device) records a
``(name, seconds, nbytes)`` event, and :func:`summary` aggregates
count / time / bytes / effective GB/s per collective.

Optionally opens a ``torch.profiler`` window: pass ``profile_dir`` to
wrap the traced region in a profile (the host's activity, and the card's
where CUDA is available) whose trace is written into ``profile_dir``
(TensorBoard- and Perfetto-loadable).

Usage::

    from ytk_mp4j_tpu_torch.utils import trace

    with trace.trace_collectives():
        cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM)
    print(trace.summary())
"""

from __future__ import annotations

import functools
import math
import threading
import time
from typing import Any

import numpy as np
import torch

from ytk_mp4j_tpu_torch.obs import spans as _spans

_lock = threading.Lock()
_enabled = False
_events: list[tuple[str, float, int]] = []


def _payload_bytes(x: Any, _seen: set[int] | None = None) -> int:
    """Best-effort payload size of a collective operand.

    Containers (dicts/lists of arrays) count each distinct underlying
    buffer ONCE: two views sharing a base — e.g. the halves of one
    scratch array deposited under two dict keys — must not double-count
    (dedup by ``id(arr.base)``, no O(n^2) ``np.shares_memory`` sweep).
    Non-numeric scalars (``None``, arbitrary objects, non-numeric numpy
    scalars) count 0, not a phantom 8.
    """
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        if _seen is not None:
            base = x.base if isinstance(x.base, np.ndarray) else x
            if id(base) in _seen:
                return 0
            _seen.add(id(base))
        return x.nbytes
    if isinstance(x, np.generic):
        return x.nbytes if np.issubdtype(x.dtype, np.number) else 0
    if isinstance(x, dict):
        seen = set() if _seen is None else _seen
        return sum(_payload_bytes(v, seen) for v in x.values())
    if isinstance(x, (list, tuple)):
        seen = set() if _seen is None else _seen
        return sum(_payload_bytes(v, seen) for v in x)
    if isinstance(x, (bytes, str)):
        return len(x)
    if isinstance(x, (int, float, complex)):
        return 8
    if hasattr(x, "nbytes"):  # other array types
        try:
            return int(x.nbytes)
        except Exception:
            return 0
    return 0


def record(name: str, seconds: float, nbytes: int) -> None:
    if _enabled:
        with _lock:
            _events.append((name, seconds, nbytes))


# Canonical collective-method list shared by every backend; instrument()
# skips names a backend doesn't define (e.g. the in-jit functional layer
# has no maps), so one list serves all without drift.
COLLECTIVE_METHODS = (
    "allreduce_array", "reduce_array", "broadcast_array",
    "allgather_array", "gather_array", "scatter_array",
    "reduce_scatter_array", "allreduce_map", "allreduce_map_async",
    "allreduce_map_multi", "allreduce_array_multi",
    "reduce_map", "broadcast_map", "gather_map", "allgather_map",
    "scatter_map", "reduce_scatter_map", "barrier", "thread_barrier",
)
# NOTE: the _async row times the DISPATCH half only (encode + device
# launch + d2h start); the blocking fetch/decode lives in the
# handle's result() and is deliberately not a collective row.


def instrument(cls, methods=COLLECTIVE_METHODS):
    """Wrap each of ``cls``'s collective methods with :func:`traced`
    (names the class doesn't define are skipped)."""
    for name in methods:
        fn = cls.__dict__.get(name)
        if fn is not None and callable(fn):
            setattr(cls, name, traced(fn))
    return cls


_in_collective = threading.local()


def traced(fn):
    """Wrap a collective method: when tracing is enabled, time the call
    and record the payload size of its first data argument. Only the
    OUTERMOST traced call on a thread records — collectives implemented
    by composing other collectives (e.g. allreduce_map = reduce_map +
    broadcast_map) must not double-count or emit phantom rows.

    Independently of the trace on/off switch, the wrapper scopes the
    backend's always-on :class:`~ytk_mp4j_tpu_torch.utils.stats.CommStats`
    (when the instance carries one as ``_comm_stats``) so wire/reduce/
    serialize phase events recorded deeper in the stack attribute to
    the collective that caused them; each OUTERMOST scope also lands as
    a span in the bounded ring (obs.spans, Chrome-trace exportable) and,
    on failure, fires the backend's ``_on_collective_error`` hook (the
    slave ships a DIAGNOSE to the master so a timed-out collective
    yields a cluster-wide hang diagnosis instead of a bare error)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        stats = getattr(self, "_comm_stats", None)
        outermost = (stats.begin(fn.__name__)
                     if stats is not None else 0)
        trace_this = _enabled and getattr(_in_collective, "depth", 0) == 0
        if not trace_this and not outermost:
            try:
                return fn(self, *args, **kwargs)
            finally:
                if stats is not None:
                    stats.end(outermost)
        nbytes = _payload_bytes(args[0]) if (trace_this and args) else 0
        if trace_this:
            _in_collective.depth = 1
        t0 = time.perf_counter()
        try:
            out = fn(self, *args, **kwargs)
        except Exception as e:
            # hook BEFORE stats.end so the diagnosis payload still sees
            # the failed collective as `current` (best-effort, only at
            # the outermost frame — composed collectives report once)
            if outermost:
                hook = getattr(self, "_on_collective_error", None)
                if hook is not None:
                    hook(fn.__name__, e)
            raise
        finally:
            if trace_this:
                _in_collective.depth = 0
            dur = time.perf_counter() - t0
            if outermost:
                _spans.collective(fn.__name__, t0, dur,
                                  stats.rank, outermost)
            if stats is not None:
                stats.end(outermost)
        if trace_this:
            record(f"{type(self).__name__}.{fn.__name__}", dur, nbytes)
        return out

    return wrapper


class trace_collectives:
    """Context manager enabling collective tracing (optionally plus a
    ``torch.profiler`` window when ``profile_dir`` is given). Re-entrant:
    nested scopes keep tracing enabled until the outermost exits. At most
    ONE scope in the stack may pass ``profile_dir`` (one profiler at a
    time); a second raises before any state changes."""

    _depth = 0
    _profiler_owner: "trace_collectives | None" = None

    def __init__(self, profile_dir: str | None = None, clear: bool = True):
        self.profile_dir = profile_dir
        self.clear = clear
        self._prof = None

    def __enter__(self):
        global _enabled
        # start the profiler BEFORE flipping global state: __exit__ never
        # runs when __enter__ raises, so state must only change once
        # nothing else can fail
        if self.profile_dir is not None:
            with _lock:
                if trace_collectives._profiler_owner is not None:
                    raise RuntimeError(
                        "a trace_collectives scope with profile_dir is "
                        "already active; the profiler cannot nest")
                trace_collectives._profiler_owner = self
            try:
                self._prof = _open_profiler(self.profile_dir)
            except BaseException:
                with _lock:
                    trace_collectives._profiler_owner = None
                raise
        with _lock:
            if trace_collectives._depth == 0 and self.clear:
                _events.clear()
            trace_collectives._depth += 1
            _enabled = True
        return self

    def __exit__(self, *exc):
        global _enabled
        if trace_collectives._profiler_owner is self:
            prof, self._prof = self._prof, None
            try:
                prof.stop()
            finally:
                with _lock:
                    trace_collectives._profiler_owner = None
        with _lock:
            trace_collectives._depth -= 1
            if trace_collectives._depth == 0:
                _enabled = False
        return False


def _open_profiler(profile_dir: str):
    """Start a ``torch.profiler`` window whose trace lands in
    ``profile_dir`` when it stops."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


def events() -> list[tuple[str, float, int]]:
    """Raw ``(name, seconds, nbytes)`` events recorded so far."""
    with _lock:
        return list(_events)


def clear() -> None:
    with _lock:
        _events.clear()


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted list."""
    idx = math.ceil(q * len(sorted_vals)) - 1
    return sorted_vals[max(0, min(len(sorted_vals) - 1, idx))]


def summary() -> dict[str, dict[str, float]]:
    """Aggregate events: per collective name, ``{calls, seconds, bytes,
    gb_per_s}`` (payload bytes over wall time — an effective, not wire,
    rate) plus per-call duration percentiles ``{p50, p95, max}`` in
    seconds — one straggling call stays visible behind a healthy mean."""
    agg: dict[str, dict[str, float]] = {}
    durs: dict[str, list[float]] = {}
    for name, sec, nb in events():
        a = agg.setdefault(name, {"calls": 0, "seconds": 0.0, "bytes": 0})
        a["calls"] += 1
        a["seconds"] += sec
        a["bytes"] += nb
        durs.setdefault(name, []).append(sec)
    for name, a in agg.items():
        a["gb_per_s"] = (a["bytes"] / a["seconds"] / 1e9
                         if a["seconds"] > 0 else 0.0)
        ds = sorted(durs[name])
        a["p50"] = _percentile(ds, 0.50)
        a["p95"] = _percentile(ds, 0.95)
        a["max"] = ds[-1]
    return agg


def format_summary() -> str:
    """Human-readable table of :func:`summary` (rank-0-style report)."""
    agg = summary()
    if not agg:
        return "(no collective events traced)"
    w = max(len(k) for k in agg)
    lines = [f"{'collective':<{w}}  calls  seconds    MB      GB/s"
             f"    p50ms    p95ms    maxms"]
    for name in sorted(agg):
        a = agg[name]
        lines.append(
            f"{name:<{w}}  {a['calls']:>5d}  {a['seconds']:>7.4f}  "
            f"{a['bytes'] / 1e6:>7.2f}  {a['gb_per_s']:>7.3f}  "
            f"{a['p50'] * 1e3:>7.3f}  {a['p95'] * 1e3:>7.3f}  "
            f"{a['max'] * 1e3:>7.3f}")
    return "\n".join(lines)


def export_chrome_trace(path: str) -> int:
    """Export the span ring (collective + chunk-level wire/reduce/
    serialize phase spans, always-on — see :mod:`ytk_mp4j_tpu_torch.obs.spans`)
    as Chrome-trace/Perfetto JSON; returns the event count. One file per
    process; merge per-rank files with ``mp4j-scope merge``."""
    return _spans.export_chrome_trace(path)
