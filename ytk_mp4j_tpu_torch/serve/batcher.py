"""Micro-batch accumulation under a latency deadline.

A copy of ``ytk_mp4j_tpu/serve/batcher.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

The serve front end's core tradeoff: one collective round per REQUEST
is latency-optimal and throughput-terrible (every round pays the full
substrate latency for one example); one round per large batch is the
reverse. The :class:`MicroBatcher` buys amortization without an
unbounded tail — the OLDEST queued request waits at most
``deadline_ms`` (``MP4J_SERVE_DEADLINE_MS``) before whatever has
accumulated dispatches, and a batch that reaches ``max_batch``
(``MP4J_SERVE_MAX_BATCH``) dispatches immediately without waiting the
deadline out.

One dispatch thread owns every downstream collective: the substrate's
collectives are ordered per comm, so request concurrency MUST be
funneled through a single caller — callers enqueue under the
condition variable and block on a :class:`ServeFuture`, never on the
comm itself. All deadline arithmetic is on the monotonic clock and
every blocking wait in here carries an explicit timeout (mp4j-lint
R28 — authored alongside this module — flags anything else in
``serve/``).
"""

from __future__ import annotations

import threading
import time

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.utils import tuning

# idle-poll backstop for the dispatch thread's condition waits: the
# notify on submit()/close() is the real wakeup, the timeout only
# bounds a lost-wakeup pathology (and satisfies the R28 contract that
# no serve-path wait is unbounded)
_IDLE_WAIT_SECS = 0.2
# join budget for close(): generous vs any single dispatch (which is
# itself deadline-bounded), tiny vs a hang
_CLOSE_JOIN_SECS = 30.0


class ServeFuture:
    """Deferred prediction for one enqueued request — the serve twin
    of ``comm/progress.CollectiveFuture`` (same Event-publication
    shape, same wait-without-consuming timeout contract)."""

    __slots__ = ("_done", "_result", "_exc")

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None):
        """Block until the batch containing this request completes;
        returns the prediction or re-raises the dispatch failure. A
        ``timeout`` expiry raises ``Mp4jError`` without consuming the
        future (wait again)."""
        if not self._done.wait(timeout):
            raise Mp4jError(
                f"serve future not complete after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    # the concurrent.futures-familiar spelling
    def result(self, timeout: float | None = None):
        return self.wait(timeout)

    def _resolve(self, value) -> None:
        self._result = value
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()


class MicroBatcher:
    """Accumulate requests into micro-batches and hand them to
    ``dispatch_fn(requests) -> results`` on a single owned thread.

    ``dispatch_fn`` receives the batched request payloads in enqueue
    order and must return one result per request (or raise — the
    failure fans out to every future of the batch, and the batcher
    keeps serving subsequent batches: one poisoned batch is not a
    dead plane).
    """

    def __init__(self, dispatch_fn, deadline_ms=None, max_batch=None,
                 on_batch=None, on_latency=None,
                 name: str = "mp4j-serve-batcher"):
        self.deadline_secs = tuning.serve_deadline_ms(deadline_ms) / 1e3
        self.max_batch = tuning.serve_max_batch(max_batch)
        self._dispatch_fn = dispatch_fn
        self._on_batch = on_batch     # (n, reason, wait_secs) observer
        self._on_latency = on_latency  # per-request enqueue->resolve secs
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # [(payload, future, t_enqueue_monotonic)], enqueue order
        self._queue: list = []
        self._closed = False
        self.batches = 0
        self.batch_full = 0           # dispatched because max_batch hit
        self.batch_deadline = 0       # dispatched because deadline hit
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._thread.start()

    # -- caller side ----------------------------------------------------
    def submit(self, payload) -> ServeFuture:
        """Enqueue one request; returns its :class:`ServeFuture`."""
        fut = ServeFuture()
        with self._cond:
            if self._closed:
                raise Mp4jError("serve batcher is closed")
            self._queue.append((payload, fut, time.monotonic()))
            self._cond.notify()
        return fut

    def close(self, timeout: float = _CLOSE_JOIN_SECS) -> None:
        """Stop accepting requests, drain what is queued, join the
        dispatch thread (bounded), fail anything still undelivered."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        with self._cond:
            leftovers = [f for _p, f, _t in self._queue]
            self._queue.clear()
        for fut in leftovers:
            fut._fail(Mp4jError("serve batcher closed before dispatch"))

    # -- dispatch thread ------------------------------------------------
    def _collect(self):
        """Block (bounded waits only) until a batch is due; pops and
        returns ``(entries, reason)`` — ``reason`` is ``"full"``,
        ``"deadline"`` or ``"drain"`` — or ``(None, "")`` at shutdown
        with an empty queue."""
        with self._cond:
            while True:
                if self._queue and self._closed:
                    # drain mode: no more arrivals are possible, so
                    # waiting out the deadline buys nothing
                    return self._pop_locked(), "drain"
                if len(self._queue) >= self.max_batch:
                    return self._pop_locked(), "full"
                if self._queue:
                    due = self._queue[0][2] + self.deadline_secs
                    remaining = due - time.monotonic()
                    if remaining <= 0:
                        return self._pop_locked(), "deadline"
                    self._cond.wait(timeout=remaining)
                elif self._closed:
                    return None, ""
                else:
                    self._cond.wait(timeout=_IDLE_WAIT_SECS)

    def _pop_locked(self) -> list:
        batch = self._queue[:self.max_batch]
        del self._queue[:self.max_batch]
        return batch

    def _run(self) -> None:
        while True:
            entries, reason = self._collect()
            if entries is None:
                return
            self.batches += 1
            if reason == "full":
                self.batch_full += 1
            elif reason == "deadline":
                self.batch_deadline += 1
            # oldest request's accumulation wait — the deadline the
            # batcher is accountable for (dispatch latency downstream
            # of here belongs to the collective substrate)
            wait_secs = time.monotonic() - entries[0][2]
            payloads = [p for p, _f, _t in entries]
            try:
                results = self._dispatch_fn(payloads)
            except BaseException as exc:  # fan the failure out
                for _p, fut, _t in entries:
                    fut._fail(exc)
                if self._on_batch is not None:
                    self._on_batch(len(entries), "error", wait_secs)
                continue
            if len(results) != len(entries):
                exc = Mp4jError(
                    f"dispatch returned {len(results)} results for "
                    f"{len(entries)} requests")
                for _p, fut, _t in entries:
                    fut._fail(exc)
                continue
            for (_p, fut, _t), res in zip(entries, results):
                fut._resolve(res)
            if self._on_latency is not None:
                now = time.monotonic()
                for _p, _f, t_enq in entries:
                    self._on_latency(now - t_enq)
            if self._on_batch is not None:
                self._on_batch(len(entries), reason, wait_secs)
