"""Futures of the nonblocking collectives: ``CollectiveFuture``,
``completed_future``, ``eager_future`` and ``DeferredFuture``, copied from
``ytk_mp4j_tpu/comm/progress.py:99``, ``:165``, ``:174`` and ``:189``.

The device comms need no progression thread: ``DistributedComm`` and
``GpuCommCluster`` run a dense ``i*`` collective at once and return a
resolved future (the card's queue already runs the work behind the
caller), and ``GpuCommCluster.iallreduce_map`` returns a
``DeferredFuture`` whose device work and copy to pinned memory are in
flight when it returns. The progression thread of the reference's socket
plane comes with the host planes.
"""

from __future__ import annotations

import threading

from ytk_mp4j_tpu_torch.exceptions import Mp4jError


class CollectiveFuture:
    """Deferred result of a nonblocking collective (``i*`` methods).

    ``wait()`` blocks until the collective completes and returns the
    same (in-place mutated) payload the blocking twin returns, or
    re-raises the collective's failure. Attributes: ``op`` (the blocking
    twin's name), ``epoch`` (the recovery epoch at submit), ``seq`` (the
    collective ordinal)."""

    __slots__ = ("op", "epoch", "seq", "_done", "_result", "_exc",
                 "_observed")

    def __init__(self, op: str, epoch: int = 0):
        self.op = op
        self.epoch = epoch
        self.seq = 0
        self._done = threading.Event()
        self._result = None
        self._exc: BaseException | None = None
        self._observed = False    # wait()/exception() delivered it

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None):
        """Block until completion; returns the collective's result or
        re-raises its failure. A ``timeout`` expiry raises ``Mp4jError``
        without consuming the future (wait again)."""
        if not self._done.wait(timeout):
            raise Mp4jError(
                f"future '{self.op}' not complete after {timeout}s")
        self._observed = True
        if self._exc is not None:
            raise self._exc
        return self._result

    # the concurrent.futures-familiar spelling
    def result(self, timeout: float | None = None):
        return self.wait(timeout)

    def exception(self, timeout: float | None = None):
        """The collective's failure (None on success); blocks like
        :meth:`wait`."""
        if not self._done.wait(timeout):
            raise Mp4jError(
                f"future '{self.op}' not complete after {timeout}s")
        self._observed = True
        return self._exc

    def _resolve(self, value) -> None:
        self._result = value
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()


def completed_future(op: str, value) -> CollectiveFuture:
    """An already-resolved future: the collective ran synchronously, the
    future API stays uniform."""
    fut = CollectiveFuture(op)
    fut._resolve(value)
    return fut


def eager_future(obj, name: str, *args, **kwargs) -> CollectiveFuture:
    """Run ``obj.<name>(*args, **kwargs)`` now and wrap the outcome in a
    resolved future: a backend whose collectives are synchronous keeps
    the uniform ``i*().wait()`` contract, its failures delivered at
    ``wait()``."""
    fut = CollectiveFuture(name)
    try:
        fut._resolve(getattr(obj, name)(*args, **kwargs))
    except Exception as e:
        fut._fail(e)
    return fut


class DeferredFuture(CollectiveFuture):
    """A future whose ``wait()`` runs ``fn()`` once, on the first waiter's
    thread: it wraps ``GpuCommCluster``'s ``PendingMap`` (the device
    collective is already in flight; only the wait on its copy and the
    decode are deferred). ``done()`` is False until then."""

    __slots__ = ("_lock", "_fn")

    def __init__(self, op: str, fn):
        super().__init__(op)
        self._lock = threading.Lock()
        self._fn = fn

    def _force(self) -> None:
        with self._lock:
            if not self._done.is_set():
                try:
                    self._resolve(self._fn())
                except BaseException as e:
                    self._fail(e)

    def wait(self, timeout: float | None = None):
        self._force()
        return super().wait(timeout)

    def result(self, timeout: float | None = None):
        return self.wait(timeout)

    def exception(self, timeout: float | None = None):
        self._force()
        return super().exception(timeout)
