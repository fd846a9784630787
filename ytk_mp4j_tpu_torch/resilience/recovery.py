"""Epoch-fenced abort/retry recovery for the socket backend.

A copy of ``ytk_mp4j_tpu/resilience/recovery.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

The job-wide **epoch** is an integer every rank agrees on, advanced
only by the master's abort protocol. Peer connections pin the epoch at
dial time (it rides the peer handshake), so "drain stale-epoch frames"
has a sharp mechanical meaning: an abort round closes every connection
of the old epoch, and whatever bytes were in flight die with their
sockets — no frame parsing of torn streams, no heuristics, and it
covers the unframed raw plane for free.

Protocol (one **abort round**, driven by the master)::

    rank r: collective fails with a transport error
         -> ABORT_REQ {epoch, collective, error}          (control plane)
    master: first request for this epoch fans out ("abort", epoch+1)
    every rank (control thread): tear down peer channels  <- the drain;
            also unblocks any rank stuck in a data-plane call
         -> ABORT_ACK {epoch+1}
    master: all live ranks acked -> ("abort_go", epoch+1)
    every rank: epoch := epoch+1; failed collectives restore their
            preserved input and re-run; peer channels re-dial lazily
            with capped exponential backoff (MP4J_RECONNECT_BACKOFF)

Terminal aborts: a dead control connection, a stalled abort round
(``MP4J_DEAD_RANK_SECS`` without full acks), an escalated barrier
stall, or an exhausted retry budget (``MP4J_MAX_RETRIES``) makes the
master fan out ("abort_fatal", msg): every surviving rank raises the
SAME :class:`~ytk_mp4j_tpu_torch.exceptions.Mp4jFatalError` within its
bounded wait — never a hang, never a partial result.

What retries: only :data:`RECOVERABLE` failures (transport errors and
raw OS socket errors). Validation/misuse errors propagate untouched —
the reference's semantics, see ``exceptions.py``.

Idempotence: the recovery wrapper snapshots the collective's mutable
payload (array/list/map) at the OUTERMOST entry and restores it before
each retry, because several collectives merge into the caller's buffer
mid-flight (recursive halving, composed reduce+scatter). This copy is
the only steady-state cost of resilience — the fence itself is a flag
check — and it is skipped entirely at ``MP4J_MAX_RETRIES=0``.
"""

from __future__ import annotations

import collections
import threading
import time

from ytk_mp4j_tpu_torch.exceptions import (
    Mp4jAbortError, Mp4jError, Mp4jEvicted, Mp4jFatalError,
    Mp4jTransportError)
from ytk_mp4j_tpu_torch.obs import spans

# the recoverable class: wire-level Mp4jTransportError (which includes
# the fence's Mp4jAbortError) plus raw socket/OS failures surfaced by
# an abort teardown cutting a live operation (EBADF, ECONNRESET, EOF
# from a helper-thread send, ...)
RECOVERABLE = (Mp4jTransportError, OSError, EOFError)


class RecoveryManager:
    """Per-slave recovery state machine.

    Two call sides, matching the slave's two threads:

    - the CONTROL thread delivers master messages via
      :meth:`on_abort` / :meth:`on_go` / :meth:`on_fatal` (and MUST
      keep doing so while a collective blocks — that is what unhangs
      it);
    - the COLLECTIVE thread runs attempts through :meth:`run` and
      polls the epoch fence via :meth:`poll`.

    ``send_ctl(kind, payload)`` ships a control message to the master
    (best-effort; may raise). ``teardown()`` closes every peer channel
    (idempotent; called from the control thread). ``stats`` is the
    slave's :class:`~ytk_mp4j_tpu_torch.utils.stats.CommStats` — retries and
    aborts land in its counters and in the span ring.
    """

    def __init__(self, *, rank: int, max_retries: int,
                 dead_rank_secs: float, send_ctl, teardown, stats,
                 wake=None, drain=None, progress=None,
                 terminal_hook=None):
        self.rank = rank
        self.max_retries = max_retries
        self.dead_rank_secs = dead_rank_secs
        self._send_ctl = send_ctl
        self._teardown = teardown
        self._stats = stats
        self._wake = wake or (lambda: None)
        self._drain = drain or (lambda: None)
        # flight-recorder hook: fired exactly once, on the
        # FIRST terminal abort, BEFORE the fatal flag wakes any waiter
        # — the slave's final telemetry flush + postmortem dump must
        # land before the collective thread raises and the caller
        # starts tearing the process down
        self._terminal_hook = terminal_hook
        self._terminal_fired = False
        # bounded epoch/retry event log — the postmortem bundle's
        # recovery.json (monotonic timestamps: deltas are what matter)
        self._events: collections.deque = collections.deque(maxlen=256)
        # own lock (NOT _cond: _note runs inside _cond-held sections);
        # keeps (deque, count) consistent for the sink's cursor math
        self._events_lock = threading.Lock()
        self._event_count = 0    # events ever noted (sink cursor)
        # (collective ordinal, in-flight flag) for the abort ack: the
        # master refuses to release a round whose ranks sit at
        # DIFFERENT collectives — recovery is per-collective, and a
        # fault spanning a collective boundary is unrecoverable (a
        # completed rank cannot re-serve its contribution)
        self._progress = progress or (lambda: (0, False))
        self._cond = threading.Condition()
        self.epoch = 0          # last epoch the master released (go)
        self._target = 0        # highest abort epoch announced
        self._fatal: str | None = None
        # planned eviction: the terminal message is a clean
        # release, not a failure — waiters raise Mp4jEvicted instead
        # of Mp4jFatalError and the postmortem recorder stays quiet
        self._evicted = False
        # the soft boundary fence: while set, the
        # collective thread PARKS at its next outermost entry (acking
        # its position) instead of starting the collective — the
        # master's planned-eviction quiesce, with the wire untouched.
        # ``_fence_goal`` is the ordinal the master wants COMPLETED
        # before parking (fence_advance): a rank parked early would
        # starve a peer's in-flight batch that still needs it, so the
        # master advances laggards to the global max ordinal first
        self._fence_token: int | None = None
        self._fence_goal = 0
        self._requested = 0     # highest abort epoch we asked for
        self._tl = threading.local()

    # ------------------------------------------------------------------
    # control-thread side
    # ------------------------------------------------------------------
    def _note(self, kind: str, detail: str = "") -> None:
        with self._events_lock:
            self._events.append((time.monotonic(), kind, detail))
            self._event_count += 1

    def note(self, kind: str, detail: str = "") -> None:
        """Public event-log append for the membership layer:
        replacement/adoption/shrink events join the same durable log
        the abort/retry protocol writes, so the sink and
        ``mp4j-scope postmortem`` report full membership history."""
        self._note(kind, detail)

    def events(self) -> list[tuple]:
        """The bounded epoch/retry event log (postmortem bundle)."""
        with self._events_lock:
            return list(self._events)

    def seed(self, epoch: int) -> None:
        """Pin a freshly adopted joiner's recovery state to the epoch
        the membership round released: the joiner was never
        part of epochs < ``epoch``, so both the released epoch and the
        announce target start there — the fence sees a quiescent,
        current state, and the joiner's peer dials pin the epoch every
        survivor expects."""
        with self._cond:
            self.epoch = int(epoch)
            self._target = int(epoch)
            self._requested = int(epoch)

    def events_since(self, cursor: int) -> tuple[int, list[tuple], int]:
        """``(new_cursor, events, dropped)`` — the durable sink's
        non-destructive delta read over the bounded event log, mirroring ``obs.spans.take_since``."""
        with self._events_lock:
            return spans.ring_delta(self._events, self._event_count,
                                    cursor)

    def on_fence(self, token: int) -> None:
        """The master wants every rank parked at a collective
        boundary (a planned eviction): arm the fence. The
        collective thread acks and parks at its NEXT outermost entry
        — nothing is torn down, so a canceled fence costs nothing."""
        with self._cond:
            self._fence_token = int(token)
            self._fence_goal = 0
            self._cond.notify_all()
        self._note("fence", f"token={token}")
        self._wake()

    def on_fence_advance(self, token: int, goal: int) -> None:
        """The master moved the fence's park ordinal: this rank
        parked (or would park) BEHIND a peer's in-flight ordinal, and
        a rank parked early starves every peer whose admitted batch
        still needs it — run through ordinal ``goal`` first, then
        park and re-ack. Parking after COMPLETING an ordinal is
        starvation-free: completion implies this rank's sends for it
        (and everything before it) are already on the wire."""
        with self._cond:
            if self._fence_token == int(token):
                self._fence_goal = max(self._fence_goal, int(goal))
            self._cond.notify_all()
        self._note("fence_advance", f"token={token} goal={goal}")
        self._wake()

    def on_fence_release(self, token: int) -> None:
        """The master canceled the fence (a rank could not reach a
        boundary in time, or the eviction became moot): parked ranks
        resume exactly where they were — zero disruption."""
        with self._cond:
            if self._fence_token == int(token):
                self._fence_token = None
            self._cond.notify_all()
        self._note("fence_release", f"token={token}")
        self._wake()

    def _join_fence(self) -> None:
        """Collective-thread side of the fence: at an OUTERMOST
        collective entry with the fence armed — and this rank's
        position at or past the fence goal — ack the position and
        park until the fence resolves: into an abort round (the
        eviction proceeds; ``_join_pending_round`` below takes over),
        a release (canceled; resume free), an ADVANCE (a peer's
        in-flight batch still needs this rank — resume through the
        new goal, re-park at the next boundary), or a terminal
        message. Bounded: a masterless fence must not hang the job
        past the recovery deadline."""
        deadline = time.monotonic() + self.dead_rank_secs
        while True:
            with self._cond:
                tok = self._fence_token
                goal = self._fence_goal
            if tok is None:
                return
            seq, _ = self._progress()
            if seq < goal:
                return      # run on; re-park once the goal completes
            try:
                self._send_ctl("fence_ack",
                               {"token": tok, "seq": seq})
            except (Mp4jError, OSError):
                pass    # master gone; its watchdog owns the outcome
            self._note("fence_park", f"token={tok} seq={seq}")
            with self._cond:
                while (self._fence_token == tok
                       and self._fence_goal <= seq
                       and self._fatal is None
                       and self._target <= self.epoch):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    self._cond.wait(min(remaining, 0.5))
                if (self._fence_token != tok or self._fatal is not None
                        or self._target > self.epoch):
                    return

    def on_abort(self, target: int) -> None:
        """Master announced an abort round targeting ``target``: tear
        down the old epoch's data plane and ack. Runs on the control
        thread so it fires even while the collective thread is blocked
        mid-exchange (the teardown is what unblocks it)."""
        with self._cond:
            if target <= self._target:
                return          # duplicate/stale announcement
            self._target = target
            # an abort round supersedes any armed fence: the round IS
            # the quiesce now, and the parked ranks fall through into
            # _join_pending_round to wait for the go
            self._fence_token = None
            self._cond.notify_all()
        self._note("abort", f"epoch->{target}")
        self._teardown()
        self._stats.add("aborts_seen", 1)
        spans.mark("abort", self.rank, epoch=target)
        try:
            seq, inflight = self._progress()
            self._send_ctl("abort_ack", {"epoch": target, "seq": seq,
                                         "inflight": inflight})
        except (Mp4jError, OSError):
            pass   # master gone; its watchdog turns this terminal
        self._wake()

    def on_go(self, epoch: int) -> None:
        """Master released the round: advance the job-wide epoch."""
        with self._cond:
            if epoch > self.epoch:
                self.epoch = epoch
            self._cond.notify_all()
        self._note("go", f"epoch={epoch}")
        self._wake()

    def on_fatal(self, msg: str) -> None:
        """Terminal abort (from the master's fan-out, or locally when
        the master is unreachable): record the one job-wide message and
        wake every waiter. The FIRST call also fires the terminal hook
        — final telemetry flush + postmortem dump — before
        the fatal flag is published, so every survivor's bundle is on
        disk before any thread raises; the hook is wrapped: a recorder
        failure must never block the abort itself."""
        with self._cond:
            first = not self._terminal_fired
            self._terminal_fired = True
        if first:
            self._note("fatal", msg[:120])
            if self._terminal_hook is not None:
                try:
                    self._terminal_hook(msg)
                # the job is dying with `msg`; a best-effort recorder
                # error (full disk, dead master channel) must not
                # replace or delay that
                # mp4j-lint: disable=R5 (best-effort flight recorder)
                except Exception:
                    pass
        with self._cond:
            if self._fatal is None:
                self._fatal = msg
            self._cond.notify_all()
        self._teardown()
        spans.mark("abort_fatal", self.rank)
        self._wake()

    def on_evicted(self, msg: str) -> None:
        """Planned eviction: the master's autoscaler
        replaced this LIVE rank from a warm spare at a collective
        boundary, and this message is the release. Terminal like a
        fatal (the data plane belongs to the replacement now; every
        blocked wait must break), but CLEAN: waiters raise
        :class:`Mp4jEvicted`, the terminal hook stays unfired (a
        planned eviction leaves no postmortem — nothing failed), and
        ``close()`` skips the master handshake the master already
        wrote off."""
        with self._cond:
            self._terminal_fired = True   # no flight-recorder dump
            if self._fatal is None:
                self._fatal = msg
                self._evicted = True
            self._cond.notify_all()
        self._note("evicted", msg[:120])
        self._teardown()
        spans.mark("evicted", self.rank)
        self._wake()

    @property
    def fatal(self) -> str | None:
        return self._fatal

    @property
    def evicted(self) -> bool:
        """Whether the terminal message is a planned eviction."""
        return self._evicted

    def fatal_exc(self, msg: str | None = None) -> Mp4jError:
        """THE terminal-exception constructor: every site that raises
        the job-wide terminal message must come through here so a
        planned eviction surfaces as :class:`Mp4jEvicted` (clean
        release) and everything else as :class:`Mp4jFatalError` —
        two sites deciding independently would disagree."""
        text = self._fatal if msg is None else msg
        return (Mp4jEvicted(text) if self._evicted
                else Mp4jFatalError(text))

    # ------------------------------------------------------------------
    # collective-thread side
    # ------------------------------------------------------------------
    def poll(self) -> None:
        """The epoch fence: one flag check on the hot path. Raises
        when this rank must stop touching the data plane — a pending
        abort round (recoverable), a terminal abort (fatal), or a
        ZOMBIE attempt: once the master releases a new epoch, an
        attempt started under the old one may still be unwinding, and
        without the attempt-epoch pin it would acquire fresh channels
        and consume (or corrupt) frames that belong to the retry."""
        if self._fatal is not None:
            raise self.fatal_exc()
        if self._target > self.epoch:
            raise Mp4jAbortError(
                f"epoch fence: abort round -> {self._target} in flight "
                f"(this rank still at epoch {self.epoch})")
        att = getattr(self._tl, "attempt_epoch", None)
        if att is not None and att != self.epoch:
            raise Mp4jAbortError(
                f"epoch fence: attempt pinned to epoch {att} but the "
                f"job moved to epoch {self.epoch} (zombie attempt)")

    def check_channel(self, ch_epoch: int) -> None:
        """Validate a just-acquired channel's pinned epoch against the
        running attempt (or, outside any attempt, the current epoch).
        Closes the fence's one remaining gap: a thread that passed
        ``poll`` and then BLOCKED waiting for a peer dial-in can wake
        holding a channel from a newer epoch after a full abort round
        completed mid-wait — using it would steal the retry's frames."""
        att = getattr(self._tl, "attempt_epoch", None)
        want = att if att is not None else self.epoch
        if ch_epoch != want:
            raise Mp4jAbortError(
                f"epoch fence: channel pinned to epoch {ch_epoch} but "
                f"this attempt runs at epoch {want}")

    def abort_pending(self) -> bool:
        """Non-raising fence read — wait-predicate form of
        :meth:`poll` (peer-connect waits wake on it)."""
        return self._fatal is not None or self._target > self.epoch

    def enter(self) -> bool:
        """Outermost-collective tracking for the recovery wrapper
        (composed collectives recover at the outermost frame only)."""
        depth = getattr(self._tl, "depth", 0)
        self._tl.depth = depth + 1
        return depth == 0

    def exit(self) -> None:
        self._tl.depth = getattr(self._tl, "depth", 1) - 1

    def run(self, name: str, attempt, preserve, restore):
        """Run ``attempt()`` under the abort/retry engine.

        ``preserve()`` snapshots the collective's mutable input (called
        once, before the first attempt); ``restore(saved)`` puts it
        back before a retry. Raises ``Mp4jFatalError`` with the
        master's job-wide message when recovery is impossible."""
        saved = preserve() if self.max_retries > 0 else None
        tries = 0
        try:
            return self._run_rounds(name, attempt, restore, saved, tries)
        finally:
            self._tl.attempt_epoch = None

    def _run_rounds(self, name, attempt, restore, saved, tries):
        while True:
            self._join_fence()
            self._join_pending_round()
            # release fds of channels the last round tore down — only
            # the collective thread may do this (native-poll fd-reuse
            # hazard, see Channel.invalidate)
            self._drain()
            epoch0 = self.epoch
            self._tl.attempt_epoch = epoch0   # pin (see poll)
            try:
                return attempt()
            except Mp4jFatalError:
                raise
            except RECOVERABLE as e:
                if self.max_retries == 0:
                    # fail-stop (the reference's contract): first
                    # transport error is final, nothing job-wide
                    if isinstance(e, Mp4jError):
                        raise
                    raise Mp4jTransportError(
                        f"collective '{name}' failed: {e!r}") from e
                if self._fatal is not None:
                    raise self.fatal_exc() from e
                if tries >= self.max_retries:
                    self._go_terminal(
                        f"collective '{name}' on rank {self.rank} "
                        f"failed after {tries} recovery "
                        f"round(s): {e}", cause=e)
                tries += 1
                self._stats.add("retries", 1, bucket=name)
                self._note("retry", f"{name} attempt={tries}")
                spans.mark("retry", self.rank, collective=name,
                           attempt=tries, error=repr(e)[:120])
                self._request_abort(epoch0, name, e)
                self._await_epoch_past(epoch0, name)
                if restore is not None:
                    restore(saved)

    # ------------------------------------------------------------------
    def _join_pending_round(self) -> None:
        """A rank entering a collective while an abort round is in
        flight (its control thread already tore down and acked) waits
        here for the go instead of dialing into a dying epoch."""
        deadline = time.monotonic() + self.dead_rank_secs
        with self._cond:
            while self._fatal is None and self._target > self.epoch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.5))
        if self._fatal is not None:
            raise self.fatal_exc()
        if self._target > self.epoch:
            self._go_terminal(
                f"rank {self.rank}: abort round -> {self._target} "
                f"stalled for {self.dead_rank_secs:.1f}s with no "
                "release from the master")

    def _request_abort(self, epoch0: int, name: str, e) -> None:
        with self._cond:
            if self._requested > epoch0:
                return     # this epoch's round is already requested
            self._requested = epoch0 + 1
        try:
            self._send_ctl("abort_req", {
                "epoch": epoch0, "collective": name,
                "error": repr(e)[:300]})
        except (Mp4jError, OSError):
            self._go_terminal(
                f"rank {self.rank}: master unreachable while "
                f"requesting recovery of '{name}' ({e})")

    def _await_epoch_past(self, epoch0: int, name: str) -> None:
        deadline = time.monotonic() + self.dead_rank_secs
        with self._cond:
            while self._fatal is None and self.epoch <= epoch0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.5))
        if self._fatal is not None:
            raise self.fatal_exc()
        if self.epoch <= epoch0:
            self._go_terminal(
                f"rank {self.rank}: recovery of '{name}' stalled for "
                f"{self.dead_rank_secs:.1f}s (abort round never "
                "completed — dead rank or dead master)")

    def _go_terminal(self, msg: str, cause=None):
        """Ask the master to fan out a terminal abort, then raise the
        SAME message it broadcasts (so every rank's error reads
        identically); fall back to the local message if the master is
        gone. Never returns."""
        try:
            self._send_ctl("abort_req", {"fatal": True, "error": msg})
        except (Mp4jError, OSError):
            self.on_fatal(msg)
        deadline = time.monotonic() + min(self.dead_rank_secs, 10.0)
        with self._cond:
            while self._fatal is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.25))
        raise self.fatal_exc(self._fatal or msg) from cause
