"""Nonblocking collectives: futures + the helper-thread communication
scheduler.

A copy of ``ytk_mp4j_tpu/comm/progress.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package. The only change is to
prose: ``DeferredFuture`` wraps ``GpuCommCluster``'s ``PendingMap``, where
the reference's wraps the TPU cluster's.

The socket plane was synchronous per collective: every ``allreduce``
blocked the caller while the wire drained. This module generalizes the
two earlier mechanisms — the submit-time channel binding
(``_submit_send``) and the single-threaded shm ``duplex_exchange``
event loop — into ONE progression thread per slave that drives many
outstanding collectives through a single poll loop over the Channel
SPI, with per-collective state machines for the existing chunked
rhd/ring schedules, so chunk k+1's wire overlaps chunk k's reduce
across *different* outstanding collectives too.

Architecture
------------

- :class:`CollectiveFuture` — the handle ``ProcessCommSlave.iallreduce``
  / ``igather`` / ``iallgather`` / ``ireduce_scatter`` /
  ``iallreduce_map`` return. It carries its submit **epoch** and its
  collective **ordinal**; ``wait()`` blocks for the result (the same
  in-place mutated payload the blocking twin returns) and re-raises the
  collective's failure.

- :class:`ProgressScheduler` — one daemon progression thread per slave,
  started lazily on the first ``i*`` submission (a job that never goes
  async pays nothing). Submissions classify into three execution kinds,
  always consumed in submit order (submit order IS the job-wide
  collective order, exactly as for blocking calls):

  * **engine** — numeric raw-plane dense collectives (rhd/ring
    schedules, gather) run as *state machines*: each collective's
    schedule is enumerated up front into exchange ops; every op's send/
    recv legs enqueue tickets into per-``(peer, direction)`` FIFO
    queues at admission, and the poll loop moves bytes on whichever
    runnable leg's socket is ready (nonblocking TCP via ``select``;
    legs whose channel rides the shm rings pump the SPSC ring
    piece/sync-byte schedule chunk-granularly through
    ``transport.shm.SendPump``/``RecvPump`` — wire-identical to the
    blocking chunked exchange, never blocking the loop). Because every
    rank enqueues the SAME per-channel leg sequence (pure schedules ×
    identical submit order — the R1/R8 discipline), bytes always pair
    with the peer's matching leg whatever the local interleaving; and
    because each collective's ops arm strictly in order with the
    identical per-chunk merge boundaries, results are bit-exact with
    the blocking path.

  * **fused map** — under ``MP4J_COALESCE_USECS > 0``, consecutive
    ``iallreduce_map`` submissions fuse into one
    ``allreduce_map_multi`` call: ONE vocabulary-sync negotiation and
    one columnar frame train carry many tiny maps, and the negotiated
    batch size (the min of every rank's offered count, carried in the
    sync header) keeps ranks in lockstep however raggedly their
    schedulers coalesced. De-fused on completion; leftovers re-queue.

  * **inline** — everything else (framed/compressed/object operands,
    tree/twolevel schedules, the non-coalesced map plane) executes the
    ordinary blocking method on the progression thread: still
    asynchronous to the caller, FIFO-ordered, riding the existing
    recovery/audit/stats machinery unchanged.

Epoch-fence contract (recovery composed with membership): an engine batch is
ONE recovery unit — every member's payload is snapshotted at admission
(through the same ``_preserve_payload`` pool machinery the blocking
wrapper uses), the batch publishes ``(base ordinal, in-flight)`` so the
master's per-collective release gate and the elastic ``joiner_seq``
rule see one coherent position, and an abort round restores EVERY
member (audit-digest-checked) and re-drives the whole batch at the new
epoch. Futures resolve only once their collective can no longer be
retried (batch completion), so a caller never observes a transiently
restored buffer. ``wait_all()`` is the collective-boundary drain;
blocking collectives, ``barrier()`` and ``close()`` drain outstanding
futures first so mixed async/blocking programs keep one job-wide
collective order (mp4j-lint R16 flags the un-awaited-future hazard
statically).
"""

from __future__ import annotations

import collections
import select
import threading
import time

import numpy as np

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.exceptions import (
    Mp4jError, Mp4jFatalError, Mp4jTransportError)
from ytk_mp4j_tpu_torch.transport import shm as shm_mod
from ytk_mp4j_tpu_torch.transport.channel import _raw_view
from ytk_mp4j_tpu_torch.utils import native, tuning

# engine byte-moving granularity per socket syscall; the merge/pipeline
# chunking stays MP4J_CHUNK_BYTES (identical boundaries to the blocking
# engine — bit-exactness depends on it)
_IO_SLICE = 1 << 20


class CollectiveFuture:
    """Deferred result of a nonblocking collective (``i*`` methods).

    ``wait()`` blocks until the collective completes and returns the
    same (in-place mutated) payload the blocking twin returns — or
    re-raises the collective's failure. The payload buffer must not be
    read or mutated between submit and ``wait()``: the scheduler owns
    it, and a recovery retry may transiently restore it.

    Attributes: ``op`` (the blocking twin's name), ``epoch`` (the
    job-wide recovery epoch at submit — the fence the abort protocol
    validates retries against), ``seq`` (the collective ordinal,
    assigned when the scheduler admits the collective).
    """

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

    # -- caller side ----------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None):
        """Block until completion; returns the collective's result or
        re-raises its failure. A ``timeout`` expiry raises
        ``Mp4jError`` without consuming the future (wait again)."""
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

    # -- scheduler side -------------------------------------------------
    def _resolve(self, value) -> None:
        self._result = value
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()


def completed_future(op: str, value) -> CollectiveFuture:
    """An already-resolved future — the eager backends' (thread /
    distributed, and the device dense paths) ``i*`` return value: the
    collective ran synchronously, the future API stays uniform."""
    fut = CollectiveFuture(op)
    fut._resolve(value)
    return fut


def eager_future(obj, name: str, *args, **kwargs) -> CollectiveFuture:
    """Run ``obj.<name>(*args)`` NOW and wrap the outcome in a
    resolved future — the backends whose collectives are inherently
    synchronous (thread barrier-aligned groups, the single-controller
    device paths, ``MP4J_ASYNC=0``) keep the uniform ``i*().wait()``
    contract, failures delivered at ``wait()`` like the scheduled
    path."""
    fut = CollectiveFuture(name)
    try:
        fut._resolve(getattr(obj, name)(*args, **kwargs))
    except Exception as e:
        fut._fail(e)
    return fut


class DeferredFuture(CollectiveFuture):
    """A future whose ``wait()`` lazily runs ``resolve()`` once, on the
    first waiter's thread — wraps ``GpuCommCluster``'s ``PendingMap`` (the
    device collective is already in flight; only the blocking fetch +
    decode is deferred)."""

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


# ----------------------------------------------------------------------
# submission records
# ----------------------------------------------------------------------
class _Item:
    __slots__ = ("future", "name", "args", "kwargs", "kind", "ordinal",
                 "snapshot", "arec", "ops", "cursor", "seq", "t0",
                 "payload", "wire", "resolved")

    def __init__(self, future, name, args, kwargs, kind):
        self.future = future
        self.name = name          # blocking twin's method name
        self.args = args          # (payload, operand[, operator])
        self.kwargs = kwargs
        self.kind = kind          # "engine" | "map" | "inline"
        self.ordinal = 0          # recovery ordinal (at admission)
        self.snapshot = None      # payload snapshot for retries
        self.arec = None          # audit record
        self.ops: list[_Op] = []
        self.cursor = 0           # index of the op currently in flight
        self.seq = 0              # CommStats sequence number
        self.t0 = 0.0
        self.payload = None
        self.resolved = False     # future resolved (engine: at its
        # collective's completion, so a rolling submit window
        # pipelines; a recovery retry re-runs even resolved members
        # bit-exactly — see the CollectiveFuture recovery caveat)
        # per-COLLECTIVE wire folds (verify mode): the shared audit
        # accumulators assume one collective at a time, but several of
        # ours interleave on the wire — each item folds its own legs
        # (sequential within a collective, so plain crc folds compose)
        # and installs them at commit, keeping the cross-rank pairwise
        # wire comparison exact whatever the local interleaving
        self.wire: dict = {}

    def fold(self, peer: int, direction: str, buf,
             transport: str) -> None:
        from ytk_mp4j_tpu_torch.obs import audit as audit_mod
        key = (int(peer), direction)
        ent = self.wire.get(key)
        if ent is None:
            ent = self.wire[key] = [0, 0, transport]
        ent[0] = audit_mod.fold_wire(ent[0], buf)
        ent[1] += len(buf)


class _Op:
    """One exchange step of one engine collective: up to one send leg
    and one recv leg (full duplex), an optional per-chunk merge, and an
    ``on_done`` hook (ring carry rotation, final deposits).

    ``acc`` set => the receive rides pooled scratch (``rbuf``) and each
    completed chunk merges: ``acc = op(acc, rbuf)`` (the rhd shape), or
    with ``ring=True`` the inverse ``rbuf = op(rbuf, acc)`` (the ring
    reduce-scatter shape, where the scratch becomes the next carry) —
    both exactly the blocking engine's operand order.
    """

    __slots__ = ("item", "idx", "sp", "sarr", "rp", "rdst", "acc",
                 "operator", "ring", "on_done", "armed", "wait_since",
                 "legs", "pending_legs", "rbuf")

    def __init__(self, item, idx, sp=None, sarr=None, rp=None,
                 rdst=None, acc=None, operator=None, ring=False,
                 on_done=None):
        self.item = item
        self.idx = idx
        self.sp = sp
        self.sarr = sarr          # ndarray | callable -> ndarray | None
        self.rp = rp
        self.rdst = rdst          # in-place recv destination (ndarray)
        self.acc = acc            # merge counterpart (see class doc)
        self.operator = operator
        self.ring = ring
        self.on_done = on_done
        self.armed = False
        self.wait_since = None    # first deferred-arm tick (see _arm)
        self.legs: list[_Leg] = []
        if sp is not None:
            self.legs.append(_Leg(self, "send", sp))
        if rp is not None:
            self.legs.append(_Leg(self, "recv", rp))
        self.pending_legs = len(self.legs)
        self.rbuf = None          # pooled scratch (acc path)

    def merge_chunk(self, stats, bucket: str, lo: int, hi: int) -> None:
        t0 = time.perf_counter()
        if self.ring:
            native.reduce_into(self.operator, self.rbuf[lo:hi],
                               self.acc[lo:hi])
        else:
            native.reduce_into(self.operator, self.acc[lo:hi],
                               self.rbuf[lo:hi])
        stats.add("reduce_seconds", time.perf_counter() - t0,
                  bucket=bucket)


class _Leg:
    __slots__ = ("op", "dir", "peer", "ch", "view", "off", "n",
                 "chunks", "merged", "busy", "last_progress", "src",
                 "started", "pump")

    def __init__(self, op, dir_, peer):
        self.op = op
        self.dir = dir_           # "send" | "recv"
        self.peer = peer
        self.ch = None
        self.view = None          # memoryview (cast B) once armed
        self.off = 0
        self.n = 0
        self.chunks = ()          # element ranges (recv merge path)
        self.merged = 0           # chunks merged so far
        self.busy = 0.0           # seconds inside socket syscalls
        self.last_progress = 0.0
        self.src = None           # ndarray backing the view
        self.started = False      # first byte attempted (fold point)
        self.pump = None          # shm chunk pump (SendPump/RecvPump)


class ProgressScheduler:
    """The per-slave helper progression thread (see module docstring).

    Owned by :class:`~ytk_mp4j_tpu_torch.comm.process_comm.ProcessCommSlave`;
    created lazily on the first ``i*`` submission.
    """

    def __init__(self, slave):
        self._s = slave
        # force the one-time native load/build attempt HERE, on the
        # constructing thread with no scheduler lock in existence yet:
        # _full_ok consults the cached verdict from under _cv, and a
        # lazy first load there would run g++ (subprocess, seconds)
        # inside the lock every submit()/wait() needs (R20)
        native.ensure_loaded()
        self._cv = threading.Condition()
        self._pending: collections.deque[_Item] = collections.deque()
        self._outstanding = 0
        self._busy = False        # a unit (batch/map/inline) active:
        # wait_all must not return between the last future's
        # resolution and the unit's EPILOGUE (progress-state
        # restoration, audit commits) — a caller racing into a
        # blocking collective there would claim a duplicate ordinal
        # and clobber the audit wire accumulators
        self._failed: list[CollectiveFuture] = []
        self._fatal: BaseException | None = None
        self._stop = False
        self._thread: threading.Thread | None = None
        self._max_out = slave._max_outstanding
        self._coalesce_s = slave._coalesce_usecs / 1e6
        # wake pipe: submit() taps it so the full-native batch driver
        # (blocked in its C++ poll) returns promptly to admit new
        # collectives into the running batch
        import os
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        # overlap accounting (the ovl% column in mp4j-scope live):
        # wall intervals with >=1 / >=2 collectives outstanding,
        # flushed into the "<async>" stats family at quiescent points
        self._n = 0
        self._peak_booked = 0
        self._last_t: float | None = None
        self._inflight_s = 0.0
        self._overlap_s = 0.0

    # ------------------------------------------------------------------
    # caller side
    # ------------------------------------------------------------------
    def submit(self, name: str, args: tuple, kwargs: dict,
               kind: str) -> CollectiveFuture:
        s = self._s
        # fail fast only on TERMINAL state: a pending (recoverable)
        # abort round must NOT surface here — the caller's submit is
        # not inside any retry scope, so raising the fence's
        # Mp4jAbortError would crash the rank on exactly the faults
        # the blocking path absorbs (it parks in _join_pending_round
        # instead); the scheduler's own rec.run waits the round out
        if s._recovery.fatal is not None:
            raise s._recovery.fatal_exc()
        fut = CollectiveFuture(name, epoch=s._recovery.epoch)
        item = _Item(fut, name, args, kwargs, kind)
        with self._cv:
            self._raise_terminal()
            if self._stop:
                raise Mp4jError("slave is closed")
            # backpressure: MP4J_MAX_OUTSTANDING bounds queued + active
            while self._outstanding >= self._max_out:
                self._cv.wait(0.2)
                self._raise_terminal()
                if s._recovery.fatal is not None:
                    raise s._recovery.fatal_exc()
            self._pending.append(item)
            self._outstanding += 1
            self._account_locked(+1)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"mp4j-prog-r{s._rank}")
                self._thread.start()
            self._cv.notify_all()
        try:
            import os
            os.write(self._wake_w, b"x")   # nudge the batch driver
        except OSError:
            pass   # pipe full: a wake is already pending
        return fut

    def _raise_terminal(self) -> None:
        """Re-raise the scheduler's terminal error with its ORIGINAL
        type (an injected FaultKill must surface as FaultKill on the
        dying rank's own submissions, not re-wrapped)."""
        exc = self._fatal
        if exc is None:
            return
        if isinstance(exc, Mp4jError):
            raise exc
        raise Mp4jFatalError(str(exc))

    def active(self) -> bool:
        with self._cv:
            return self._outstanding > 0

    def outstanding(self) -> int:
        """Queued-or-in-flight count, read under the scheduler's
        condition (the progression thread decrements it there)."""
        with self._cv:
            return self._outstanding

    def wait_all(self, timeout: float | None = None) -> None:
        """The collective-boundary drain: block until every outstanding
        future resolved; re-raise the FIRST failure among futures that
        were never awaited (an awaited future's error was already
        delivered to its waiter)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            while self._outstanding > 0 or self._busy:
                remaining = (0.2 if deadline is None
                             else min(0.2, deadline - time.monotonic()))
                if remaining <= 0:
                    raise Mp4jError(
                        f"wait_all: {self._outstanding} collective(s) "
                        f"still outstanding after {timeout}s")
                self._cv.wait(max(remaining, 0.001))
            failed, self._failed = self._failed, []
        for f in failed:
            if not f._observed:
                f._observed = True
                raise f._exc

    def drain_for_blocking(self) -> None:
        """Called by blocking collectives / ``barrier()`` / ``close()``
        before they touch the data plane: outstanding futures complete
        first so the job-wide collective order stays the submit order.
        No-op on the progression thread itself (inline execution calls
        the blocking methods from there)."""
        if threading.current_thread() is self._thread:
            return
        if self.active():
            self.wait_all()

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop accepting submissions and wait out the outstanding
        work (bounded) — the close() path. Releases the wake pipe
        once the progression thread exited (a long-lived process
        cycling slaves must not leak two fds per scheduler)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            deadline = time.monotonic() + timeout
            while self._outstanding > 0 and self._fatal is None \
                    and time.monotonic() < deadline:
                self._cv.wait(0.2)
        t = self._thread
        if t is not None:
            t.join(max(0.1, deadline - time.monotonic()))
        if t is None or not t.is_alive():
            import os
            for fd in (self._wake_r, self._wake_w):
                try:
                    os.close(fd)
                except OSError:
                    pass

    # ------------------------------------------------------------------
    # accounting (cv held)
    # ------------------------------------------------------------------
    def _account_locked(self, delta: int) -> None:
        now = time.perf_counter()
        if self._last_t is not None and self._n > 0:
            dt = now - self._last_t
            self._inflight_s += dt
            if self._n > 1:
                self._overlap_s += dt
        self._last_t = now
        self._n += delta
        stats = self._s._comm_stats
        stats.metrics.set_gauge("async/outstanding", float(self._n))
        if self._n > self._peak_booked:
            # outstanding_peak stays monotone by booking INCREASES
            # only, so the heartbeat's additive delta algebra carries
            # it: the per-rank value is the true peak; cluster folds
            # sum peaks across ranks (documented in README)
            stats.add("outstanding_peak", self._n - self._peak_booked,
                      bucket="<async>")
            # mp4j-lint: disable=R15 (_n is the outstanding-collective count, not roster state)
            self._peak_booked = self._n
        if self._n == 0 and self._inflight_s > 0.0:
            stats.add("async_inflight", self._inflight_s,
                      bucket="<async>")
            if self._overlap_s > 0.0:
                stats.add("async_overlap", self._overlap_s,
                          bucket="<async>")
            self._inflight_s = 0.0
            self._overlap_s = 0.0

    def _finish(self, item: _Item, value=None,
                exc: BaseException | None = None) -> None:
        # resolve BEFORE the outstanding count drops: a wait_all()
        # waiter wakes on the count and may immediately re-raise an
        # unobserved failure — the future must already carry it
        if exc is not None:
            item.future._fail(exc)
        else:
            item.future._resolve(value)
        with self._cv:
            self._account_locked(-1)
            self._outstanding -= 1
            if exc is not None:
                self._failed.append(item.future)
            self._cv.notify_all()

    # ------------------------------------------------------------------
    # progression thread
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending:
                    if self._stop or self._fatal is not None:
                        return
                    self._cv.wait(0.2)
                head = self._pending[0]
                self._busy = True
            try:
                if head.kind == "engine":
                    self._run_engine_batch()
                elif head.kind == "map":
                    self._run_map_batch()
                elif head.kind == "array":
                    self._run_array_batch()
                else:
                    self._run_inline()
            except BaseException as e:
                # terminal (Mp4jFatalError, an injected kill, an engine
                # defect): fail every queued future with the same error
                # so no waiter ever hangs, then stop the scheduler
                self._go_fatal(e)
                return
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _go_fatal(self, exc: BaseException) -> None:
        with self._cv:
            self._fatal = exc
            self._busy = False
            items = list(self._pending)
            self._pending.clear()
            self._cv.notify_all()
        for it in items:
            self._finish(it, exc=exc)

    def _pop_head(self) -> _Item:
        with self._cv:
            return self._pending.popleft()

    # -- inline ---------------------------------------------------------
    def _run_inline(self) -> None:
        item = self._pop_head()
        try:
            out = getattr(self._s, item.name)(*item.args,
                                              **item.kwargs)
        except Mp4jFatalError:
            self._finish(item, exc=self._s._recovery.fatal_exc(
                str(self._s._recovery.fatal or "fatal abort")))
            raise
        except Exception as e:
            if _is_kill(e):
                self._finish(item, exc=e)
                raise
            self._finish(item, exc=e)
            return
        self._finish(item, value=out)

    # -- fused maps (small-message coalescing) --------------------------
    def _run_map_batch(self) -> None:
        s = self._s
        batch = [self._pop_head()]
        operand = batch[0].args[1]
        operator = batch[0].args[2]
        deadline = time.monotonic() + self._coalesce_s
        while len(batch) < self._max_out:
            with self._cv:
                if not self._pending:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(min(remaining, 0.002))
                nxt = self._pending[0] if self._pending else None
                # only CONSECUTIVE same-signature maps fuse: batching
                # by content keeps the multi-call sequence identical on
                # every rank whatever the local timing (the negotiated
                # batch size absorbs ragged coalescing depth)
                if (nxt is not None and nxt.kind == "map"
                        and nxt.args[1] is operand
                        and nxt.args[2] is operator):
                    batch.append(self._pending.popleft())
                    continue
                if nxt is not None:
                    break
        dicts = [it.args[0] for it in batch]
        try:
            m = s.allreduce_map_multi(dicts, operand, operator)
        except Mp4jFatalError:
            for it in batch:
                self._finish(it, exc=s._recovery.fatal_exc(
                    str(s._recovery.fatal or "fatal abort")))
            raise
        except Exception as e:
            for it in batch:
                self._finish(it, exc=e)
            if _is_kill(e):
                raise
            return
        # de-fuse: the negotiated first m maps completed; leftovers
        # (this rank coalesced deeper than the slowest rank) re-queue
        # at the FRONT so submit order is preserved
        leftovers = batch[m:]
        if leftovers:
            with self._cv:
                self._pending.extendleft(reversed(leftovers))
        for it in batch[:m]:
            self._finish(it, value=it.args[0])

    # -- fused dense small arrays ----------------------------
    def _run_array_batch(self) -> None:
        """The array-plane twin of :meth:`_run_map_batch`: consecutive
        same-signature small ``iallreduce`` submissions arriving within
        the coalescing window fuse into ONE count-negotiated
        ``allreduce_array_multi`` exchange; the negotiated first ``m``
        resolve, leftovers re-queue at the front (submit order
        preserved — the job-wide collective order)."""
        s = self._s
        batch = [self._pop_head()]
        operand = batch[0].args[1]
        operator = batch[0].args[2]
        deadline = time.monotonic() + self._coalesce_s
        while len(batch) < self._max_out:
            with self._cv:
                if not self._pending:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(min(remaining, 0.002))
                nxt = self._pending[0] if self._pending else None
                # only CONSECUTIVE same-signature arrays fuse — the
                # map batch's rule, for the same job-wide reason
                if (nxt is not None and nxt.kind == "array"
                        and nxt.args[1] is operand
                        and nxt.args[2] is operator):
                    batch.append(self._pending.popleft())
                    continue
                if nxt is not None:
                    break
        arrs = [it.args[0] for it in batch]
        try:
            m = s.allreduce_array_multi(arrs, operand, operator)
        except Mp4jFatalError:
            for it in batch:
                self._finish(it, exc=s._recovery.fatal_exc(
                    str(s._recovery.fatal or "fatal abort")))
            raise
        except Exception as e:
            for it in batch:
                self._finish(it, exc=e)
            if _is_kill(e):
                raise
            return
        leftovers = batch[m:]
        if leftovers:
            with self._cv:
                self._pending.extendleft(reversed(leftovers))
        for it in batch[:m]:
            self._finish(it, value=it.args[0])

    # ==================================================================
    # the interleaved raw-plane engine
    # ==================================================================
    def _run_engine_batch(self) -> None:
        s = self._s
        rec = s._recovery
        tun = s._tuner
        if tun is not None and tun.dirty:
            # the batch is ONE collective boundary: pending tuner
            # decisions (chunk granularity, socket buffers) land
            # before any member's wire byte moves, exactly where the
            # blocking wrapper applies them — engine legs then read
            # the adapted per-link chunk schedule via _chunk_for
            s._tuner_apply(tun)
        batch: list[_Item] = []
        queues: dict[tuple[int, str], collections.deque] = {}
        touched: dict = {}       # channels switched to nonblocking
        first = [True]
        base = s._progress_state[0] + 1
        s._progress_state = (base, True)

        def preserve():
            return None          # per-item snapshots live at admission

        def restore(_):
            self._restore_batch(batch)

        def attempt():
            admit = first[0]
            first[0] = False
            if not admit:
                # retry: rebuild every member's state machine from its
                # restored payload; the ticket queues are re-derived so
                # the fresh epoch's channels replay the same sequence
                queues.clear()
                for it in batch:
                    self._build_ops(it)
                    self._enqueue(it, queues)
            try:
                self._drive(batch, queues, touched, admit=admit,
                            base=base)
            finally:
                self._restore_channels(touched)

        outermost = rec.enter()
        try:
            assert outermost, "engine batch nested inside a collective"
            try:
                if s._faults is not None:
                    # batch boundary: earlier ordinals' unfired
                    # one-shot directives disarm here (the sequential
                    # path disarms at each next collective instead)
                    s._faults.prune_below(base)
                # admit the head before rec.run so the batch is never
                # empty (further admissions happen inside the drive)
                self._admit(self._pop_head(), batch, queues, base)
                rec.run(batch[0].name, attempt, preserve, restore)
            except BaseException as e:
                if s._audit is not None:
                    for it in batch:
                        if it.arec is not None:
                            s._audit.abandon(it.arec, e)
                for it in batch:
                    if not it.resolved:
                        self._finish(it, exc=e)
                if isinstance(e, Mp4jFatalError) or _is_kill(e):
                    raise
                if not isinstance(e, (Mp4jError, OSError, EOFError)):
                    raise          # engine defect: surface loudly
                return
            finally:
                s._progress_state = (
                    batch[-1].ordinal if batch else base, False)
            # audit records commit once, at batch end: a retry would
            # re-run even already-resolved members, and a committed
            # record must carry the FINAL attempt's wire folds
            audit = s._audit
            now = time.perf_counter()
            for it in batch:
                if audit is not None and it.arec is not None:
                    if audit.wire_on and it.wire:
                        audit.put_wire(it.wire)
                    audit.commit(it.arec, it.payload)
                if not it.resolved:   # pragma: no cover - safety net
                    it.resolved = True
                    s._comm_stats.async_end(it.name, now - it.t0)
                    self._finish(it, value=it.payload)
        finally:
            rec.exit()

    # -- admission ------------------------------------------------------
    def _admit(self, item: _Item, batch, queues, base: int) -> None:
        try:
            self._admit_inner(item, batch, queues, base)
        except BaseException as e:
            # an admission that dies BEFORE the item joins the batch
            # (an injected kill firing at on_collective, a schedule-
            # build defect) must still fail the item's future — the
            # batch error path only covers members, and a popped-but-
            # lost item would strand its waiter forever
            if item not in batch:
                self._finish(item, exc=e)
            raise

    def _admit_inner(self, item: _Item, batch, queues,
                     base: int) -> None:
        s = self._s
        item.ordinal = base + len(batch)
        item.payload = item.args[0]
        if s._faults is not None:
            # kill plans fire here, exactly as at the blocking
            # wrapper's entry (retried attempts keep the first
            # ordinal: _admit runs once per submission, never on a
            # retry rebuild, so a one-shot fault cannot re-fire into
            # its own recovery). The WINDOW variant arms without
            # disarming earlier batch members' directives — batch
            # ordinals are concurrent, not sequential
            s._faults.on_collective_window(item.ordinal, s._fault_kill)
        if s._max_retries > 0 and item.name not in (
                "allgather_array", "gather_array"):
            # the same tight snapshot rule as _SNAPSHOT_FREE: pure
            # overwrite collectives retry from the caller's intact data
            from ytk_mp4j_tpu_torch.comm import process_comm as pc
            item.snapshot = pc._preserve_payload(s, item.payload)
        if s._audit is not None:
            item.arec = s._audit.begin(
                item.ordinal, item.name, item.payload,
                self._audit_meta(item))
        item.seq = s._comm_stats.async_begin(item.name)
        item.t0 = time.perf_counter()
        self._build_ops(item)
        batch.append(item)
        self._enqueue(item, queues)

    @staticmethod
    def _audit_meta(item: _Item) -> dict:
        kw = item.kwargs
        meta_: dict = {}
        if len(item.args) > 1:
            meta_["operand"] = item.args[1].name
        if len(item.args) > 2:
            meta_["operator"] = item.args[2].name
        if "root" in kw:
            meta_["root"] = int(kw.get("root", 0))
        # records replayable as the blocking twin carry only the
        # standard leading run; ranges / nonzero root / sub-ranges mark
        # the record non-replayable instead of replaying another call
        if (kw.get("from_", 0) != 0 or kw.get("to") is not None
                or kw.get("ranges") is not None
                or kw.get("root", 0) != 0):
            meta_["nonstd"] = True
        return meta_

    def _restore_batch(self, batch: list[_Item]) -> None:
        s = self._s
        audit = s._audit
        if audit is not None:
            # the failed attempt's wire folds died in the epoch drain
            # on the peer side too (see the blocking wrapper)
            audit.reset_wire()
        from ytk_mp4j_tpu_torch.comm import process_comm as pc
        from ytk_mp4j_tpu_torch.obs import audit as audit_mod
        for it in batch:
            if it.snapshot is None:
                continue
            pc._restore_payload(it.payload, it.snapshot)
            if audit is not None and it.arec is not None:
                h, _sig = audit_mod.digest_payload(it.payload)
                if h != it.arec["in"]:
                    raise Mp4jError(
                        f"audit: restored retry snapshot of "
                        f"'{it.name}' (collective #{it.ordinal}) "
                        f"digests {h:#018x}, original input was "
                        f"{it.arec['in']:#018x} — the snapshot was "
                        "corrupted; refusing to retry from tainted "
                        "input")

    # -- schedule builders ---------------------------------------------
    def _build_ops(self, item: _Item) -> None:
        s = self._s
        name = item.name
        item.cursor = 0
        item.ops = []
        item.wire = {}
        if name == "allreduce_array":
            arr, operand, operator = item.args[0:3]
            arr, lo, hi = s._norm_range(arr, operand,
                                        item.kwargs.get("from_", 0),
                                        item.kwargs.get("to"))
            algo = _resolved_allreduce_algo(
                s, arr, lo, hi, operand, item.kwargs.get("algo", "auto"))
            if algo == "rhd":
                item.ops = _rhd_ops(s, item, arr, lo, hi, operator)
            else:
                segs = meta.partition_range(lo, hi, s._n)
                item.ops = _ring_rs_ops(s, item, arr, segs, operator)
                item.ops += _ring_ag_ops(s, item, arr, segs,
                                         base_idx=len(item.ops))
        elif name == "reduce_scatter_array":
            arr, operand, operator = item.args[0:3]
            arr, _, _ = s._norm_range(arr, operand, 0, None)
            ranges = (item.kwargs.get("ranges")
                      or meta.partition_range(0, len(arr), s._n))
            item.ops = _ring_rs_ops(s, item, arr, ranges, operator)
        elif name == "allgather_array":
            arr, operand = item.args[0:2]
            arr, _, _ = s._norm_range(arr, operand, 0, None)
            ranges = (item.kwargs.get("ranges")
                      or meta.partition_range(0, len(arr), s._n))
            item.ops = _ring_ag_ops(s, item, arr, ranges)
        elif name == "gather_array":
            arr, operand = item.args[0:2]
            arr, _, _ = s._norm_range(arr, operand, 0, None)
            root = item.kwargs.get("root", 0)
            s._check_root(root)
            ranges = (item.kwargs.get("ranges")
                      or meta.partition_range(0, len(arr), s._n))
            item.ops = _gather_ops(s, item, arr, ranges, root)
        else:                    # pragma: no cover - classifier bug
            raise Mp4jError(f"engine cannot schedule '{name}'")

    def _enqueue(self, item: _Item,
                 queues: dict[tuple[int, str], collections.deque]
                 ) -> None:
        """Enqueue every leg ticket of every op UP FRONT: the complete
        per-(peer, direction) sequence is what makes interleaving safe
        — both endpoints derive the identical order from the pure
        schedules and the shared submit order, so a later collective's
        leg can never overtake an earlier one on the same wire."""
        for op in item.ops:
            for leg in op.legs:
                queues.setdefault((leg.peer, leg.dir),
                                  collections.deque()).append(leg)

    # -- the poll loop --------------------------------------------------
    def _drive(self, batch, queues, touched, admit: bool,
               base: int) -> None:
        if native.have_progress_multi():
            s = self._s
            # the batch leg-graph driver books its wire records POST
            # HOC, which is only truthful for receive buffers (merges
            # never touch them); a SEND view's bytes are overwritten
            # by later rounds of its own schedule, so verify-mode wire
            # folds must ride the per-leg loop, which folds each leg
            # at its true wire time. Fault hooks likewise fire per leg.
            wire_on = s._audit is not None and s._audit.wire_on
            if s._faults is None and not wire_on and \
                    all(self._full_ok(it) for it in batch) and \
                    self._drive_full(batch, queues, touched, admit,
                                     base):
                return
            return self._drive_native(batch, queues, touched, admit,
                                      base)
        return self._drive_py(batch, queues, touched, admit, base)

    # -- the batch leg-graph driver (one native call per batch) ---------
    def _full_ok(self, it: _Item) -> bool:
        """Whether a collective's whole op list can run inside the
        native leg-graph driver: no carry chains or completion hooks
        (ring reduce-scatter rotates pooled buffers in Python), and
        every merge must have a native kernel. A pure function of the
        call parameters — but only an EXECUTION-strategy choice (the
        wire bytes and their per-channel order are identical on every
        path), so no cross-rank agreement is needed."""
        if it.kind != "engine":
            return False
        for op in it.ops:
            if op.ring or op.on_done is not None:
                return False
            if op.acc is not None and native.reduce_opcode(
                    op.operator, op.acc.dtype) is None:
                return False
        return True

    def _drive_full(self, batch, queues, touched, admit: bool,
                    base: int) -> bool:
        """Run the WHOLE batch's leg graph in the native driver
        (``mp4j_run_legs``): every leg of every outstanding collective,
        its FIFO and op-order dependencies encoded as gates, and its
        reduce-merge run natively at leg completion — one Python-to-C
        round trip per batch instead of one per leg, which is what
        lets k outstanding collectives amortize the per-exchange
        scheduling costs k-fold. Falls back (returns False, nothing
        moved) when any channel rides shm — the rings are not fds; the
        hybrid loop owns them."""
        import ctypes

        s = self._s
        rec = s._recovery
        for it in batch:
            for op in it.ops:
                if not op.armed and not self._arm(op, touched):
                    return False     # peer not dialed in yet
                for leg in op.legs:
                    if isinstance(leg.ch, shm_mod.ShmChannel):
                        return False     # hybrid loop owns the rings
        timeout = s._peer_timeout

        def build(gates):
            legs: list[_Leg] = []
            last_q: dict[tuple[int, str], int] = {}
            for it in batch:
                prev_op: list[int] = []
                for op in it.ops:
                    cur: list[int] = []
                    for leg in op.legs:
                        cur.append(len(legs))
                        legs.append(leg)
                    for i in cur:
                        leg = legs[i]
                        # gate 0: the per-(peer, direction) FIFO
                        # predecessor; gates 1-2: the previous op's
                        # legs (the collective's own sequencing).
                        # Only wire-touching legs may anchor the FIFO
                        # chain: a zero-length leg (an empty rhd
                        # segment) is "complete" at birth, so a
                        # successor gated on it would unblock before
                        # the chain BEHIND it finished — two same-
                        # (peer, dir) legs ungated at once, and the
                        # fd slot scan would pair the stream's bytes
                        # with the wrong collective
                        g = ([last_q.get((leg.peer, leg.dir), -1)]
                             + prev_op[:2])
                        while len(g) < 3:
                            g.append(-1)
                        gates[i * 3:i * 3 + 3] = g
                        if leg.n > 0:
                            last_q[(leg.peer, leg.dir)] = i
                    if cur:
                        prev_op = cur
            return legs

        while True:
            cap = sum(len(op.legs) for it in batch for op in it.ops)
            if cap > 256:
                return False     # far beyond MP4J_MAX_OUTSTANDING use
            gates = np.full(3 * cap, -1, np.int32)
            legs = build(gates)
            n = len(legs)
            fds = np.fromiter((lg.ch.sock.fileno() for lg in legs),
                              np.int32, n)
            dirs = np.fromiter(
                (0 if lg.dir == "send" else 1 for lg in legs),
                np.int32, n)
            bufs = (ctypes.c_void_p * n)(
                *[lg.src.ctypes.data for lg in legs])
            lens = np.fromiter((lg.n for lg in legs), np.int64, n)
            dones = np.fromiter((lg.off for lg in legs), np.int64, n)
            mdst = (ctypes.c_void_p * n)()
            msrc = (ctypes.c_void_p * n)()
            mdtype = np.zeros(n, np.int32)
            mopcode = np.zeros(n, np.int32)
            mcount = np.zeros(n, np.int64)
            # chunk-granular native merges: the merge step
            # is the leg's tuner-adapted chunk schedule, the cursor
            # resumes mid-buffer across rebuilds/handovers
            mchunk = np.zeros(n, np.int64)
            melems = np.zeros(n, np.int64)
            for i, lg in enumerate(legs):
                op = lg.op
                if lg.dir == "recv" and op.acc is not None:
                    dt, oc = native.reduce_opcode(op.operator,
                                                  op.acc.dtype)
                    mdst[i] = op.acc.ctypes.data
                    msrc[i] = op.rbuf.ctypes.data
                    mdtype[i] = dt
                    mopcode[i] = oc
                    mcount[i] = op.acc.size
                    if lg.chunks:
                        mchunk[i] = lg.chunks[0][1] - lg.chunks[0][0]
                        melems[i] = (lg.chunks[lg.merged - 1][1]
                                     if lg.merged else 0)
            status = np.zeros(n, np.int8)
            stall_since = time.monotonic()
            last_total = int(dones.sum())
            grew = False
            t0 = time.perf_counter()
            while True:
                try:
                    rc = native.run_legs(
                        fds, dirs, bufs, lens, dones, gates,
                        mdst, msrc, mdtype, mopcode, mcount,
                        mchunk, melems, status, self._wake_r, 0.05)
                except Mp4jError as e:
                    self._sync_full(legs, dones, melems)
                    bad = np.flatnonzero(status != 0)
                    peer = (legs[int(bad[0])].peer if bad.size
                            else "?")
                    raise Mp4jTransportError(
                        f"async exchange with peer {peer} failed: "
                        f"{e}") from None
                rec.poll()
                if rc == 1:
                    break
                total = int(dones.sum())
                if total != last_total:
                    last_total = total
                    stall_since = time.monotonic()
                elif timeout is not None and \
                        time.monotonic() - stall_since > timeout:
                    self._sync_full(legs, dones, melems)
                    raise Mp4jTransportError(
                        f"async batch stalled for {timeout}s "
                        f"({int((lens - dones).sum())} bytes pending)")
                if rc == 2 and admit:
                    self._sync_full(legs, dones, melems)
                    added = False
                    with self._cv:
                        while (self._pending
                               and self._pending[0].kind == "engine"
                               and len(batch) < self._max_out):
                            self._admit(self._pending.popleft(),
                                        batch, queues, base)
                            added = True
                            if not self._full_ok(batch[-1]):
                                break
                    if added:
                        if not all(self._full_ok(it)
                                   for it in batch):
                            # a newcomer the leg-graph driver cannot
                            # express: finish the batch on the hybrid
                            # loop (wire-identical)
                            self._handover_folds(legs)
                            self._drive_native(batch, queues,
                                               touched, False, base)
                            return True
                        for it in batch:
                            for op in it.ops:
                                if not op.armed and \
                                        not self._arm(op, touched):
                                    # a newcomer whose peer has not
                                    # dialed in yet: the hybrid loop
                                    # retries arming each pass
                                    self._handover_folds(legs)
                                    self._drive_native(
                                        batch, queues, touched,
                                        False, base)
                                    return True
                                for leg in op.legs:
                                    if isinstance(
                                            leg.ch,
                                            shm_mod.ShmChannel):
                                        self._handover_folds(legs)
                                        self._drive_native(
                                            batch, queues, touched,
                                            False, base)
                                        return True
                        grew = True
                        break     # rebuild arrays with the newcomers
            if grew:
                continue
            dt_total = time.perf_counter() - t0
            self._sync_full(legs, dones, melems)
            # post-hoc stats bookkeeping (the driver ran the bytes;
            # records follow). Wire AUDIT folds never ride this path:
            # verify mode routes to the per-leg loop (see _drive) —
            # a send view's bytes are overwritten by its schedule's
            # later rounds, so only at-wire-time folds are truthful.
            nbytes_total = max(1, int(lens.sum()))
            for lg in legs:
                lg.busy = dt_total * lg.n / nbytes_total
            for it in batch:
                for op in it.ops:
                    for lg in op.legs:
                        q = queues.get((lg.peer, lg.dir))
                        if q and q[0] is lg:
                            q.popleft()
                        elif q and lg in q:
                            q.remove(lg)
                        self._leg_done(lg)
            return True

    @staticmethod
    def _sync_full(legs, dones, melems) -> None:
        """Mirror the native driver's in-out progress back onto the
        leg objects (rebuilds and error paths read them). ``melems``
        always lands on a chunk boundary — the native merge step IS
        the leg's chunk schedule — so the chunk cursor is exact."""
        for i, lg in enumerate(legs):
            lg.off = int(dones[i])
            done = int(melems[i])
            if done:
                lg.merged = (sum(1 for _, hi in lg.chunks
                                 if hi <= done)
                             if lg.chunks else 1)

    def _handover_folds(self, legs) -> None:
        """Catch the wire folds up before handing a part-run batch to
        the hybrid loop: bytes the native driver already received must
        fold now (the hybrid loop folds incrementally from the current
        offset); send legs keep their not-started state — the hybrid
        leg-start folds the whole intended view once, as always."""
        if self._s._audit is None or not self._s._audit.wire_on:
            for lg in legs:
                if lg.dir == "recv" and lg.off > 0:
                    lg.started = True
            return
        for lg in legs:
            if lg.dir == "recv" and lg.off > 0 and not lg.started:
                lg.op.item.fold(lg.peer, "recv", lg.view[:lg.off],
                                lg.ch.transport)
                lg.started = True

    def _drive_native(self, batch, queues, touched, admit: bool,
                      base: int) -> None:
        """The per-leg native byte mover: every runnable tcp leg (each
        per-channel queue's head whose op's turn has come) goes down
        to ONE C++ poll loop per pass (``mp4j_progress_multi``), which
        moves bytes on whichever fd is ready and returns on leg
        completions (or a fence-poll tick); shm legs pump the ring
        piece/sync-byte schedule chunk-granularly in Python each pass
        (wire-identical to the blocking path at every size — see
        :meth:`_pump_shm`). This is the engine's fallback when the
        whole-batch leg-graph driver (:meth:`_drive_full`) cannot
        express a member; correctness equal, more Python per leg."""
        import ctypes

        s = self._s
        rec = s._recovery
        timeout = s._peer_timeout
        while True:
            rec.poll()
            if admit and len(batch) < self._max_out:
                with self._cv:
                    while (self._pending
                           and self._pending[0].kind == "engine"
                           and len(batch) < self._max_out):
                        self._admit(self._pending.popleft(), batch,
                                    queues, base)
            progressed = False
            legs: list[_Leg] = []
            for q in queues.values():
                if not q:
                    continue
                leg = q[0]
                op = leg.op
                if op.item.cursor != op.idx:
                    continue      # not this collective's turn yet
                if not op.armed:
                    if not self._arm(op, touched):
                        continue  # peer not dialed in yet: next pass
                    progressed = True
                if isinstance(leg.ch, shm_mod.ShmChannel):
                    # the rings are not fds: pump in Python each pass
                    if self._pump_shm(leg):
                        progressed = True
                    if self._leg_settled(leg):
                        q.popleft()
                        self._leg_done(leg)
                        progressed = True
                    elif timeout is not None and \
                            time.monotonic() - leg.last_progress \
                            > timeout:
                        to = "to" if leg.dir == "send" else "from"
                        raise Mp4jTransportError(
                            f"async {leg.dir} {to} peer {leg.peer} "
                            f"stalled for {timeout}s (collective "
                            f"#{leg.op.item.ordinal})")
                    continue
                if not leg.started:
                    self._leg_start(leg)
                if leg.off >= leg.n:
                    # already complete (a leg-graph handover, or a
                    # zero-length leg): retire it here — the native
                    # pass below only processes legs that moved
                    q.popleft()
                    self._leg_done(leg)
                    progressed = True
                    continue
                legs.append(leg)
            if all(it.cursor >= len(it.ops) for it in batch):
                with self._cv:
                    more = (admit and self._pending
                            and self._pending[0].kind == "engine"
                            and len(batch) < self._max_out)
                if not more:
                    return
                continue
            if not legs:
                if not progressed:
                    time.sleep(0.0005)
                continue
            # the native driver's poll set is capped at 256 fds; the
            # scan order is queue order, so slicing stays FIFO-fair
            # (the tail runs on later passes)
            legs = legs[:256]
            n = len(legs)
            fds = np.fromiter((leg.ch.sock.fileno() for leg in legs),
                              np.int32, n)
            dirs = np.fromiter(
                (0 if leg.dir == "send" else 1 for leg in legs),
                np.int32, n)
            bufs = (ctypes.c_void_p * n)(
                *[leg.src.ctypes.data for leg in legs])
            lens = np.fromiter((leg.n for leg in legs), np.int64, n)
            dones = np.fromiter((leg.off for leg in legs), np.int64, n)
            status = np.zeros(n, np.int8)
            tick = 0.001 if progressed else 0.05
            t0 = time.perf_counter()
            try:
                native.progress_multi(fds, dirs, bufs, lens, dones,
                                      status, tick)
            except Mp4jError as e:
                bad = np.flatnonzero(status != 0)
                peer = (legs[int(bad[0])].peer if bad.size
                        else "?")
                raise Mp4jTransportError(
                    f"async exchange with peer {peer} failed: {e}"
                ) from None
            dt = time.perf_counter() - t0
            now = time.monotonic()
            moved_total = int(dones.sum()) - sum(
                leg.off for leg in legs)
            for i, leg in enumerate(legs):
                delta = int(dones[i]) - leg.off
                if delta <= 0:
                    if timeout is not None and \
                            now - leg.last_progress > timeout:
                        to = "to" if leg.dir == "send" else "from"
                        raise Mp4jTransportError(
                            f"async {leg.dir} {to} peer {leg.peer} "
                            f"stalled for {timeout}s (collective "
                            f"#{leg.op.item.ordinal})")
                    continue
                prev = leg.off
                leg.off = int(dones[i])
                leg.last_progress = now
                if moved_total > 0:
                    leg.busy += dt * delta / moved_total
                if leg.dir == "recv":
                    if s._audit is not None and s._audit.wire_on:
                        # fold arrivals BEFORE any merge mutates the
                        # scratch (the ring shape merges in place)
                        leg.op.item.fold(leg.peer, "recv",
                                         leg.view[prev:leg.off],
                                         leg.ch.transport)
                    self._merge_ready(leg)
                if leg.off >= leg.n:
                    queues[(leg.peer, leg.dir)].popleft()
                    self._leg_done(leg)

    def _drive_py(self, batch, queues, touched, admit: bool,
                  base: int) -> None:
        s = self._s
        rec = s._recovery
        while True:
            rec.poll()
            # dynamic admission (first attempt only): consecutive
            # engine-eligible submissions join the running batch so a
            # stream of iallreduces overlaps end to end
            if admit and len(batch) < self._max_out:
                with self._cv:
                    while (self._pending
                           and self._pending[0].kind == "engine"
                           and len(batch) < self._max_out):
                        self._admit(self._pending.popleft(), batch,
                                    queues, base)
            progressed = False
            rsel: dict[int, _Leg] = {}
            wsel: dict[int, _Leg] = {}
            rwait: list[_Leg] = []
            for q in queues.values():
                if not q:
                    continue
                leg = q[0]
                op = leg.op
                if op.item.cursor != op.idx:
                    continue      # not this collective's turn yet
                if not op.armed:
                    if not self._arm(op, touched):
                        continue  # peer not dialed in yet: next pass
                    progressed = True
                if isinstance(leg.ch, shm_mod.ShmChannel):
                    moved = self._pump_shm(leg)
                else:
                    moved = (self._pump_send(leg) if leg.dir == "send"
                             else self._pump_recv(leg))
                if moved:
                    progressed = True
                    leg.last_progress = time.monotonic()
                if self._leg_settled(leg):
                    q.popleft()
                    self._leg_done(leg)
                    progressed = True
                elif leg.pump is not None and leg.dir == "send" \
                        and not leg.pump.want_carrier:
                    # blocked on ring SPACE (peer reader behind):
                    # nothing selectable — park on a short tick
                    rwait.append(leg)
                else:
                    fd = leg.ch.sock.fileno()
                    (wsel if leg.dir == "send" else rsel)[fd] = leg
            if all(it.cursor >= len(it.ops) for it in batch):
                with self._cv:
                    more = (admit and self._pending
                            and self._pending[0].kind == "engine"
                            and len(batch) < self._max_out)
                if not more:
                    return
                continue          # admit the newcomers first
            if not progressed:
                self._park(rsel, wsel, rwait)

    def _park(self, rsel, wsel, rwait=()) -> None:
        if rsel or wsel:
            try:
                select.select(list(rsel), list(wsel), [],
                              0.002 if rwait else 0.02)
            except (OSError, ValueError):
                # a torn-down fd (abort teardown raced the select):
                # the next pump raises a clean transport error
                time.sleep(0.001)
        else:
            time.sleep(0.0005 if rwait else 0.001)
        timeout = self._s._peer_timeout
        if timeout is not None:
            now = time.monotonic()
            for leg in [*rsel.values(), *wsel.values(), *rwait]:
                if now - leg.last_progress > timeout:
                    to = "to" if leg.dir == "send" else "from"
                    raise Mp4jTransportError(
                        f"async {leg.dir} {to} peer {leg.peer} "
                        f"stalled for {timeout}s (collective "
                        f"#{leg.op.item.ordinal})")

    # -- arming ---------------------------------------------------------
    def _arm(self, op: _Op, touched: dict) -> bool:
        """Bind the op's channels NOW, under the epoch fence (the
        submit-time-binding discipline: an op from an aborted attempt
        must die with its own epoch's channel, never late-resolve a
        fresh one), resolve buffers, and flip TCP sockets nonblocking
        for the poll loop.

        Channel binding is NON-blocking: when an accept-side channel
        has not been dialed yet this returns False and the op stays
        queued for a later pass — parking the progression thread here
        would stop every other leg it owns, and the missing dial can
        be cursor-gated behind exactly those legs' bytes on the peer
        (a cross-rank establishment/byte deadlock). A dead peer still
        surfaces: the deferral clock raises after the job timeout."""
        s = self._s
        chans = []
        for leg in op.legs:
            ch = s._fenced_try(leg.peer)
            if ch is None:
                now = time.monotonic()
                if op.wait_since is None:
                    op.wait_since = now
                elif s._timeout is not None and \
                        now - op.wait_since > s._timeout:
                    raise Mp4jTransportError(
                        f"timeout waiting for peer {leg.peer} to "
                        f"connect (collective #{op.item.ordinal})")
                return False
            chans.append(ch)
        op.wait_since = None
        sarr = op.sarr() if callable(op.sarr) else op.sarr
        for leg, ch in zip(op.legs, chans):
            leg.ch = ch
            if leg.dir == "send":
                leg.src = (np.ascontiguousarray(sarr)
                           if sarr is not None else None)
        if op.acc is not None and op.rbuf is None:
            op.rbuf = s._scratch.take(op.acc.dtype, op.acc.size)
        for leg in op.legs:
            if leg.dir == "send":
                leg.view = memoryview(_raw_view(leg.src)).cast("B")
            else:
                dst = op.rbuf if op.acc is not None else op.rdst
                leg.src = dst
                leg.view = memoryview(_raw_view(dst)).cast("B")
                # per-LINK chunk granularity: merge (and,
                # on shm, wire) boundaries follow the tuner's adapted
                # decision exactly like the blocking _chunked_exchange
                # — merges are element-wise, so any partition is
                # bit-exact; shm links pin the job default (_chunk_for)
                leg.chunks = tuning.chunk_ranges(
                    dst.size, dst.dtype.itemsize,
                    s._chunk_for(leg.peer))
            leg.n = len(leg.view)
            leg.last_progress = time.monotonic()
            if leg.ch not in touched:
                touched[leg.ch] = True
                leg.ch.sock.setblocking(False)
        op.pending_legs = len(op.legs)
        op.armed = True
        if not op.legs:           # pragma: no cover - degenerate op
            self._op_done(op)
        return True

    def _leg_start(self, leg: _Leg) -> None:
        """First-byte hooks: the send-side audit fold (BEFORE any
        injected corruption — the record describes what this rank
        MEANT to send) into the collective's OWN fold accumulator, and
        the fault-injection I/O hook."""
        s = self._s
        leg.started = True
        wire_on = s._audit is not None and s._audit.wire_on
        if leg.dir == "send":
            if wire_on:
                leg.op.item.fold(leg.peer, "send", leg.view,
                                 leg.ch.transport)
            if s._faults is not None:
                s._faults.on_io(leg.ch, "send")
                f = s._faults.take_corrupt(leg.ch, leg.n)
                if f is not None:
                    from ytk_mp4j_tpu_torch.resilience import faults as fm
                    corrupted = fm.corrupt_copy(leg.src)
                    leg.src = corrupted
                    leg.view = memoryview(
                        _raw_view(corrupted)).cast("B")
        else:
            if s._faults is not None:
                s._faults.on_io(leg.ch, "recv")

    def _restore_channels(self, touched: dict) -> None:
        for ch in list(touched):
            try:
                ch.set_timeout(self._s._peer_timeout)
            except OSError:
                pass   # torn down since; the drain owns the close
        touched.clear()

    # -- byte movement --------------------------------------------------
    def _pump_recv(self, leg: _Leg) -> int:
        if not leg.started:
            self._leg_start(leg)
        sock = leg.ch.sock
        moved = 0
        while leg.off < leg.n:
            want = min(leg.n - leg.off, _IO_SLICE)
            t0 = time.perf_counter()
            try:
                r = sock.recv_into(leg.view[leg.off:], want)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                raise Mp4jTransportError(
                    f"async recv from peer {leg.peer} failed: {e}"
                ) from None
            finally:
                leg.busy += time.perf_counter() - t0
            if r == 0:
                raise Mp4jTransportError(
                    f"peer {leg.peer} closed the connection mid-"
                    f"collective ({leg.n - leg.off}/{leg.n} bytes "
                    "short)")
            prev = leg.off
            leg.off += r
            moved += r
            if self._s._audit is not None and self._s._audit.wire_on:
                # fold arrivals BEFORE any merge mutates the scratch
                # (the ring shape merges in place); crc folds are
                # chunking-invariant, so arbitrary recv spans compose
                leg.op.item.fold(leg.peer, "recv",
                                 leg.view[prev:leg.off],
                                 leg.ch.transport)
            self._merge_ready(leg)
        return moved

    def _pump_send(self, leg: _Leg) -> int:
        if not leg.started:
            self._leg_start(leg)
        sock = leg.ch.sock
        moved = 0
        while leg.off < leg.n:
            t0 = time.perf_counter()
            try:
                r = sock.send(leg.view[leg.off:leg.off + _IO_SLICE])
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                raise Mp4jTransportError(
                    f"async send to peer {leg.peer} failed: {e}"
                ) from None
            finally:
                leg.busy += time.perf_counter() - t0
            leg.off += r
            moved += r
        return moved

    def _merge_ready(self, leg: _Leg) -> None:
        """Run the op's per-chunk merge for every fully-received chunk
        — ascending offsets over the same ``tuning.chunk_ranges``
        boundaries as the blocking engine, so the merge order (and
        therefore the result) is bit-identical."""
        op = leg.op
        if op.acc is None:
            return
        itemsize = op.rbuf.dtype.itemsize
        while leg.merged < len(leg.chunks):
            clo, chi = leg.chunks[leg.merged]
            if leg.off < chi * itemsize:
                break
            op.merge_chunk(self._s._comm_stats, op.item.name, clo, chi)
            leg.merged += 1

    # -- completion -----------------------------------------------------
    def _leg_done(self, leg: _Leg) -> None:
        s = self._s
        op = leg.op
        s._comm_stats.add_wire(
            leg.n if leg.dir == "send" else 0,
            leg.n if leg.dir == "recv" else 0,
            leg.busy, chunks=max(1, len(leg.chunks)),
            bucket=op.item.name, peer=leg.peer,
            transport=leg.ch.transport)
        op.pending_legs -= 1
        if op.pending_legs <= 0:
            self._op_done(op)

    def _op_done(self, op: _Op) -> None:
        if op.on_done is not None:
            op.on_done(op)        # may claim op.rbuf (ring carry)
        if op.rbuf is not None:
            self._s._give_buf(op.rbuf)
            op.rbuf = None
        it = op.item
        it.cursor = op.idx + 1
        if it.cursor >= len(it.ops) and not it.resolved:
            # resolve AT COMPLETION (not batch end) so a rolling
            # submit window pipelines: the waiter wakes while the rest
            # of the batch is still on the wire. A later abort round
            # re-runs this collective from its snapshot bit-exactly,
            # so the resolved value stays truthful; only a concurrent
            # read DURING an active recovery can observe the transient
            # restore (documented on CollectiveFuture).
            it.resolved = True
            self._s._comm_stats.async_end(
                it.name, time.perf_counter() - it.t0)
            self._finish(it, value=it.payload)

    # -- shm chunk pumps -------------------------------------
    @staticmethod
    def _leg_settled(leg: _Leg) -> bool:
        """Retirable: every wire byte moved — for a shm pump leg that
        includes owed carrier sync bytes, which must flush before a
        later leg on the same (peer, dir) queue may touch the carrier
        stream (the per-direction protocol order)."""
        return leg.off >= leg.n and (leg.pump is None
                                     or leg.pump.done)

    def _pump_shm(self, leg: _Leg) -> int:
        """Drive one shm engine leg through its nonblocking chunk pump
        (:class:`transport.shm.SendPump`/``RecvPump``). The chunk
        bounds are the SAME per-link schedule the blocking
        ``_chunked_exchange`` derives (``_chunk_for``; shm links pin
        the job default), and each chunk routes ring-vs-carrier by the
        same size rule — so the per-direction wire streams are
        bit-identical to the blocking twin's and a mixed
        engine/blocking pair cannot desync."""
        s = self._s
        if not leg.started:
            self._leg_start(leg)
        pump = leg.pump
        if pump is None:
            # built AFTER _leg_start: an injected send corruption
            # swaps leg.view, and the pump must ship what the fault
            # actually put on the wire
            isz = leg.src.dtype.itemsize
            chunks = leg.chunks or tuning.chunk_ranges(
                leg.src.size, isz, s._chunk_for(leg.peer))
            bounds = [(lo * isz, hi * isz) for lo, hi in chunks]
            cls = (shm_mod.SendPump if leg.dir == "send"
                   else shm_mod.RecvPump)
            pump = leg.pump = cls(leg.ch, leg.view, bounds)
        prev = leg.off
        t0 = time.perf_counter()
        try:
            moved = pump.pump()
        finally:
            leg.busy += time.perf_counter() - t0
        leg.off = pump.off
        if moved:
            leg.last_progress = time.monotonic()
        if leg.dir == "recv" and leg.off > prev:
            if s._audit is not None and s._audit.wire_on:
                # fold arrivals BEFORE any merge mutates the scratch
                leg.op.item.fold(leg.peer, "recv",
                                 leg.view[prev:leg.off],
                                 leg.ch.transport)
            self._merge_ready(leg)
        return moved


def _is_kill(e: BaseException) -> bool:
    from ytk_mp4j_tpu_torch.resilience import faults as fm
    return isinstance(e, fm.FaultKill)


# ----------------------------------------------------------------------
# pure schedule builders — these mirror the blocking engine EXACTLY
# (same partners, same segment windows, same merge boundaries and
# operand order; mp4j-lint R1/R8 discipline: pure functions of the
# job-wide call parameters), which is what makes i*().wait() and the
# blocking twin bit-identical (tests/test_async.py conformance grid).
# ----------------------------------------------------------------------
def _resolved_allreduce_algo(s, arr, lo, hi, operand,
                             algo: str) -> str:
    if algo == "auto":
        return tuning.select_allreduce_algo(
            (hi - lo) * operand.dtype.itemsize, s._n,
            s._algo_small, s._algo_large)
    return algo


def engine_eligible(s, name: str, args: tuple, kwargs: dict) -> bool:
    """Whether a submission may run on the interleaved raw engine.
    This is a LOCAL execution-strategy choice — the wire bytes and
    their per-channel order are identical on the engine and the
    blocking path — so it may consult local facts (contiguity, the
    native-transport build) without any cross-rank agreement."""
    if s._n <= 1 or s._use_twolevel():
        return False
    # shm-paired jobs ride the engine too: a leg on a
    # ShmChannel pumps the ring piece/sync-byte schedule chunk-
    # granularly (transport.shm.SendPump/RecvPump) instead of
    # executing the exchange as one blocking step, so the scheduler
    # keeps serving collective k's legs while k+1's ring pieces
    # stream — the interleave-induced cycle that once forced shm
    # submissions inline cannot form against nonblocking pumps.
    if name not in ("allreduce_array", "reduce_scatter_array",
                    "allgather_array", "gather_array"):
        return False
    arr = args[0] if args else None
    operand = args[1] if len(args) > 1 else None
    if operand is None or not getattr(operand, "is_numeric", False) \
            or operand.compress or not s._raw_ok(operand):
        return False
    if not isinstance(arr, np.ndarray) or arr.ndim != 1 \
            or arr.dtype != operand.dtype \
            or not arr.flags.c_contiguous or not arr.flags.writeable:
        return False
    algo = kwargs.get("algo", "auto")
    if name == "allreduce_array":
        if kwargs.get("from_", 0) != 0 or kwargs.get("to") is not None:
            return False
        return _resolved_allreduce_algo(
            s, arr, 0, arr.size, operand, algo) in ("rhd", "ring")
    if name == "reduce_scatter_array":
        resolved = (tuning.select_partitioned_algo(
            arr.nbytes, s._n, s._algo_small, s._algo_large)
            if algo == "auto" else algo)
        return resolved == "ring"
    if name == "allgather_array":
        ranges = kwargs.get("ranges")
        if algo == "ring":
            return True
        if algo != "auto":
            return False
        if ranges is not None:
            contiguous = all(ranges[i][1] == ranges[i + 1][0]
                             for i in range(len(ranges) - 1))
            if not contiguous:
                return True       # auto picks ring for these
            size = (ranges[-1][1] - ranges[0][0]) \
                * operand.dtype.itemsize
        else:
            size = arr.nbytes
        return tuning.select_partitioned_algo(
            size, s._n, s._algo_small, s._algo_large) == "ring"
    return True                   # gather_array: always direct sends


def _rhd_ops(s, item, arr, lo, hi, operator) -> list[_Op]:
    """Recursive halving/doubling, mirroring ``_rhd_allreduce``."""
    n, r = s._n, s._rank
    ops: list[_Op] = []
    p = 1
    while p * 2 <= n:
        p *= 2
    extra = n - p
    if r >= p:                    # folded rank
        fold = r - p
        ops.append(_Op(item, 0, sp=fold, sarr=arr[lo:hi]))
        ops.append(_Op(item, 1, rp=fold, rdst=arr[lo:hi]))
        return ops
    i = 0
    if r < extra:                 # fold partner: merge the extra rank
        ops.append(_Op(item, i, rp=r + p, acc=arr[lo:hi],
                       operator=operator))
        i += 1
    segs = meta.partition_range(lo, hi, p)

    def span(a, b):
        return segs[a][0], segs[b - 1][1]

    vr = r
    dist = p >> 1
    while dist >= 1:              # reduce-scatter by halving
        partner = vr ^ dist
        block0 = (vr // (2 * dist)) * (2 * dist)
        if vr & dist:
            keep = (block0 + dist, block0 + 2 * dist)
            give = (block0, block0 + dist)
        else:
            keep = (block0, block0 + dist)
            give = (block0 + dist, block0 + 2 * dist)
        gs, ge = span(*give)
        ks, ke = span(*keep)
        ops.append(_Op(item, i, sp=partner, sarr=arr[gs:ge],
                       rp=partner, acc=arr[ks:ke], operator=operator))
        i += 1
        dist >>= 1
    dist = 1
    while dist < p:               # allgather by doubling (in place)
        pv = vr ^ dist
        mb0 = (vr // dist) * dist
        tb0 = (pv // dist) * dist
        ms, me = span(mb0, mb0 + dist)
        ts, te = span(tb0, tb0 + dist)
        ops.append(_Op(item, i, sp=pv, sarr=arr[ms:me], rp=pv,
                       rdst=arr[ts:te]))
        i += 1
        dist *= 2
    if r < extra:                 # unfold
        ops.append(_Op(item, i, sp=r + p, sarr=arr[lo:hi]))
    return ops


def _ring_rs_ops(s, item, arr, segs, operator) -> list[_Op]:
    """Pipelined ring reduce-scatter, mirroring
    ``_ring_reduce_scatter``: the received scratch merges the LOCAL
    segment in (``rbuf = op(rbuf, local)``) and becomes the next
    step's carry; the final carry deposits into this rank's segment."""
    n, r = s._n, s._rank
    right, left = (r + 1) % n, (r - 1) % n
    ops: list[_Op] = []
    state: dict = {"carry": None, "carry_buf": None}

    def make_done(last: bool):
        def done(op: _Op):
            rbuf = op.rbuf
            op.rbuf = None        # claimed as the carry, not pooled
            if state["carry_buf"] is not None:
                s._give_buf(state["carry_buf"])
            state["carry"] = rbuf
            state["carry_buf"] = rbuf
            if last:
                ms, me = segs[r]
                arr[ms:me] = state["carry"]
                s._give_buf(state["carry_buf"])
                state["carry"] = None
                state["carry_buf"] = None
        return done

    for step in range(n - 1):
        ss, se = segs[(r - 1 - step) % n]
        ri_s, ri_e = segs[(r - 2 - step) % n]
        local = arr[ri_s:ri_e]

        def sarr(st=state, ss=ss, se=se):
            return st["carry"] if st["carry"] is not None \
                else arr[ss:se]

        ops.append(_Op(item, step, sp=right, sarr=sarr, rp=left,
                       acc=local, operator=operator, ring=True,
                       on_done=make_done(step == n - 2)))
    return ops


def _ring_ag_ops(s, item, arr, segs, base_idx: int = 0) -> list[_Op]:
    """Pipelined ring allgather, mirroring ``_ring_allgather``:
    segments land in place, no merge."""
    n, r = s._n, s._rank
    right, left = (r + 1) % n, (r - 1) % n
    ops: list[_Op] = []
    for step in range(n - 1):
        ss, se = segs[(r - step) % n]
        rs, re = segs[(r - 1 - step) % n]
        ops.append(_Op(item, base_idx + step, sp=right,
                       sarr=arr[ss:se], rp=left, rdst=arr[rs:re]))
    return ops


def _gather_ops(s, item, arr, ranges, root) -> list[_Op]:
    """Rooted gather, mirroring ``gather_array``'s direct sends."""
    n, r = s._n, s._rank
    ops: list[_Op] = []
    if r == root:
        i = 0
        for peer in range(n):
            if peer == root:
                continue
            ps, pe = ranges[peer]
            ops.append(_Op(item, i, rp=peer, rdst=arr[ps:pe]))
            i += 1
    else:
        ps, pe = ranges[r]
        ops.append(_Op(item, 0, sp=root, sarr=arr[ps:pe]))
    return ops
