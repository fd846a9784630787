"""Deterministic fault injection for the socket data plane.

A copy of ``ytk_mp4j_tpu/resilience/faults.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

A :class:`FaultPlan` is a list of directives parsed from the
``MP4J_FAULT_PLAN`` grammar (or built programmatically) and evaluated
by a per-rank :class:`FaultInjector` that the slave installs on its
peer channels. Determinism is the point: a chaos test must fail the
same way every run, so directives trigger on the slave's collective
ordinal (the Nth outermost collective this rank enters), never on wall
time, and any probabilistic directive draws from an RNG seeded by
``(plan seed, rank, directive index)``.

Grammar (``;``-separated directives, ``:``-separated ``key=value``
fields after the action; whitespace ignored)::

    seed=42; reset:rank=1:nth=3:peer=2; delay:rank=0:nth=2:secs=0.2
    slow:rank=3:secs=0.01; kill:rank=2:nth=5

Actions:

- ``delay`` — sleep ``secs`` once, before the first channel I/O of
  collective ``nth`` on ``rank``.
- ``slow``  — sleep ``secs`` before EVERY channel I/O from collective
  ``nth`` onward (a persistently slow rank).
- ``reset`` — close the peer connection (to ``peer`` if given, else
  whichever peer channel does I/O first) at collective ``nth``,
  mid-frame: the hook fires between a frame's header and payload, so
  the remote side observes a torn frame, not a clean boundary.
- ``kill``  — at the entry of collective ``nth``, abruptly close every
  socket this slave owns (peers, master, listen) and raise
  :class:`FaultKill` — the closest a thread-hosted test rank can get
  to ``kill -9``. The master sees the control connection die and fans
  out the terminal abort.
- ``corrupt`` — flip one byte of the next payload frame (>=
  ``CORRUPT_MIN`` bytes, so frame headers and tiny control tuples are
  never hit — a desynced frame stream would be a crash, not the
  silent corruption this directive exists to simulate) sent at
  collective ``nth``. The flip happens in a COPY below the audit
  plane's sender-side digests, never in the caller's buffer, so the
  wire carries corrupted bytes while the sender's records stay clean —
  exactly the shape ``MP4J_AUDIT=verify`` must detect.
  Hooked at the same channel primitives as ``reset`` (and at the raw
  exchange for the native/shm data planes). The flipped byte is the
  frame's middle byte XOR 0xFF — deterministic, like every directive.

Every directive fires at most once except ``slow``, which persists
once armed. ``prob`` (0..1, default 1) gates arming through the seeded
RNG.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

from ytk_mp4j_tpu_torch.exceptions import Mp4jError

_ACTIONS = ("delay", "slow", "reset", "kill", "corrupt")
_ONCE = ("delay", "reset", "kill")

# a corrupt directive only fires on buffers at least this large:
# payload frames, never the u8/u64 frame headers or small pickled
# control tuples whose corruption would desync the framing (a crash,
# not a silent wrong answer)
CORRUPT_MIN = 4096


class FaultKill(Mp4jError):
    """An injected slave death. Deliberately NOT a transport error:
    the dying rank must not retry its own murder — it propagates out
    of the collective while the survivors' recovery engines handle the
    fallout."""


@dataclasses.dataclass
class Fault:
    """One parsed directive (see the module grammar)."""

    action: str
    rank: int
    nth: int = 1
    secs: float = 0.0
    peer: int | None = None
    prob: float = 1.0

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise Mp4jError(
                f"fault plan: unknown action {self.action!r} "
                f"(expected one of {_ACTIONS})")
        if self.rank < 0 or self.nth < 1:
            raise Mp4jError(
                f"fault plan: rank must be >= 0 and nth >= 1 "
                f"(got rank={self.rank}, nth={self.nth})")
        if self.action in ("delay", "slow") and self.secs <= 0:
            raise Mp4jError(
                f"fault plan: {self.action} needs secs > 0")
        if not 0.0 <= self.prob <= 1.0:
            raise Mp4jError(
                f"fault plan: prob={self.prob} outside [0, 1]")


_FIELD_TYPES = {"rank": int, "nth": int, "secs": float, "peer": int,
                "prob": float}


@dataclasses.dataclass
class FaultPlan:
    """A parsed, validated plan — the same object on every rank of a
    job (the injector filters by rank locally)."""

    faults: list[Fault] = dataclasses.field(default_factory=list)
    seed: int = 0

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``MP4J_FAULT_PLAN`` grammar; garbage raises
        ``Mp4jError`` at slave setup, not mid-collective."""
        faults: list[Fault] = []
        seed = 0
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                try:
                    seed = int(part[len("seed="):])
                except ValueError:
                    raise Mp4jError(
                        f"fault plan: bad seed in {part!r}") from None
                continue
            fields = [f.strip() for f in part.split(":")]
            action, kvs = fields[0], fields[1:]
            kwargs: dict = {}
            for kv in kvs:
                key, sep, val = kv.partition("=")
                key = key.strip()
                if not sep or key not in _FIELD_TYPES:
                    raise Mp4jError(
                        f"fault plan: bad field {kv!r} in {part!r} "
                        f"(expected one of {sorted(_FIELD_TYPES)})")
                try:
                    kwargs[key] = _FIELD_TYPES[key](val.strip())
                except ValueError:
                    raise Mp4jError(
                        f"fault plan: {key}={val!r} is not a "
                        f"{_FIELD_TYPES[key].__name__}") from None
            if "rank" not in kwargs:
                raise Mp4jError(
                    f"fault plan: directive {part!r} needs rank=")
            faults.append(Fault(action=action, **kwargs))
        return cls(faults=faults, seed=seed)

    def for_rank(self, rank: int) -> list[Fault]:
        return [f for f in self.faults if f.rank == rank]


def corrupt_copy(buf):
    """A COPY of ``buf`` with its middle byte flipped (XOR 0xFF) —
    deterministic, and never mutating the caller's buffer: the frame
    on the wire lies while every local record stays truthful, the
    exact hazard shape the audit plane must catch. Accepts bytes-likes
    and numpy arrays; returns the matching kind."""
    import numpy as np

    if isinstance(buf, np.ndarray):
        out = buf.copy()
        flat = out.view(np.uint8).reshape(-1)
        flat[flat.size // 2] ^= 0xFF
        return out
    out = bytearray(buf)
    out[len(out) // 2] ^= 0xFF
    return bytes(out)


class FaultInjector:
    """Per-rank evaluator of a :class:`FaultPlan`.

    The slave calls :meth:`on_collective` at every OUTERMOST collective
    entry (arming directives whose ordinal matched, executing kills)
    and installs the injector on its peer channels, whose I/O
    primitives call :meth:`on_io` — where armed delays/slows sleep and
    armed resets cut the connection. Thread-safe: channel I/O may run
    on the send-helper thread.
    """

    def __init__(self, plan: FaultPlan, rank: int):
        self._rank = rank
        self._lock = threading.Lock()
        self._armed: list[Fault] = []
        self._pending: list[Fault] = []
        for i, f in enumerate(plan.faults):
            if f.rank != rank:
                continue
            if f.prob < 1.0:
                rng = random.Random(f"{plan.seed}:{rank}:{i}")
                if rng.random() >= f.prob:
                    continue
            self._pending.append(f)

    @property
    def empty(self) -> bool:
        return not self._pending and not self._armed

    def on_collective(self, ordinal: int, kill_cb=None) -> None:
        """Arm directives whose ``nth`` equals this collective ordinal;
        execute kills. ``kill_cb(fault)`` performs the slave-side
        socket teardown before this raises :class:`FaultKill`. Retried
        attempts keep the first attempt's ordinal, so a one-shot fault
        does not re-fire into its own recovery."""
        kill: Fault | None = None
        with self._lock:
            # a one-shot directive belongs to ONE ordinal: if its
            # peer= filter saw no matching I/O during its collective,
            # it must disarm, not leak into a later collective the
            # plan never targeted
            self._armed = [f for f in self._armed
                           if f.action == "slow" or f.nth == ordinal]
            still: list[Fault] = []
            for f in self._pending:
                if f.nth == ordinal or (f.action == "slow"
                                        and f.nth <= ordinal):
                    if f.action == "kill":
                        kill = f
                    else:
                        self._armed.append(f)
                else:
                    still.append(f)
            self._pending = still
        if kill is not None:
            if kill_cb is not None:
                kill_cb(kill)
            raise FaultKill(
                f"fault injection: rank {self._rank} killed at "
                f"collective {ordinal}")

    def on_collective_window(self, ordinal: int, kill_cb=None) -> None:
        """Concurrent-batch variant of :meth:`on_collective`: the nonblocking scheduler admits SEVERAL ordinals
        back-to-back before any of their I/O moves, so arming ordinal
        k+1 must not disarm ordinal k's still-unfired directives (the
        per-ordinal prune assumes sequential collectives). Arms
        ``nth == ordinal`` directives and executes kills; stale armed
        directives are pruned at the next batch boundary
        (:meth:`prune_below`)."""
        kill: Fault | None = None
        with self._lock:
            still: list[Fault] = []
            for f in self._pending:
                if f.nth == ordinal or (f.action == "slow"
                                        and f.nth <= ordinal):
                    if f.action == "kill":
                        kill = f
                    else:
                        self._armed.append(f)
                else:
                    still.append(f)
            self._pending = still
        if kill is not None:
            if kill_cb is not None:
                kill_cb(kill)
            raise FaultKill(
                f"fault injection: rank {self._rank} killed at "
                f"collective {ordinal}")

    def prune_below(self, ordinal: int) -> None:
        """Disarm one-shot directives armed for ordinals before
        ``ordinal`` — the batch-boundary half of
        :meth:`on_collective_window`: those collectives completed
        without matching I/O, so their directives must not leak into a
        later batch the plan never targeted."""
        with self._lock:
            self._armed = [f for f in self._armed
                           if f.action == "slow" or f.nth >= ordinal]

    def take_corrupt(self, channel, nbytes: int):
        """Pop one armed ``corrupt`` directive for this channel's peer
        if ``nbytes`` clears :data:`CORRUPT_MIN`; returns the
        :class:`Fault` or ``None``. Separate from :meth:`on_io`
        because the caller must know BEFORE the write whether to
        substitute a flipped copy — and only payload-sized buffers are
        eligible (see the grammar note)."""
        if nbytes < CORRUPT_MIN:
            return None
        with self._lock:
            for f in self._armed:
                if f.action == "corrupt" and (
                        f.peer is None or f.peer == channel.peer_rank):
                    self._armed.remove(f)
                    return f
        return None

    def on_io(self, channel, op: str) -> None:
        """Channel I/O hook (``op`` is ``"send"`` or ``"recv"``). At
        most ONE armed one-shot directive fires per I/O, so a plan
        carrying N resets at the same ordinal cuts N successive
        attempts (one per recovery round) — the lever for
        retry-exhaustion chaos tests — instead of burning all N on a
        single operation."""
        with self._lock:
            def match(f):
                return f.peer is None or f.peer == channel.peer_rank
            fire = [f for f in self._armed
                    if f.action == "slow" and match(f)]
            once = next((f for f in self._armed
                         if f.action in _ONCE and match(f)), None)
            if once is not None:
                self._armed.remove(once)
                fire.append(once)
        for f in fire:
            if f.action in ("delay", "slow"):
                time.sleep(f.secs)
            elif f.action == "reset":
                # cut the connection where we stand — between a frame's
                # header and payload when called from _send_all — so
                # both ends observe a mid-frame tear. shutdown WITHOUT
                # close: the paired helper-thread send (or the native
                # poll loop) may still hold this raw fd number, and
                # freeing it here would let a re-dial recycle it into
                # the wrong exchange — the exact hazard the recovery
                # teardown's invalidate()/deferred-close discipline
                # exists for. The tear triggers that teardown, which
                # owns the eventual close.
                channel.invalidate()
