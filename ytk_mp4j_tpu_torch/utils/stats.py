"""Per-collective transport statistics.

A copy of ``ytk_mp4j_tpu/utils/stats.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

Unlike :mod:`ytk_mp4j_tpu_torch.utils.trace` (opt-in wall-time tracing of
whole collective calls), this layer is ALWAYS ON and counts what the
data plane actually did, per collective family: wire bytes moved in
each direction, wire/reduce/serialize busy-time, chunk count, and call
count. The counters are cheap (a locked dict update per chunk/phase,
not per element) and are the measurement substrate every perf PR is
judged against — ``comm.stats()`` on the process and thread backends
returns a snapshot.

Attribution: :func:`ytk_mp4j_tpu_torch.utils.trace.traced` (which already
wraps every backend collective) calls :meth:`CommStats.begin` /
:meth:`CommStats.end` around the OUTERMOST collective call on a
thread, so phase events recorded deeper in the stack (channel sends,
native exchanges, merge kernels — possibly on helper threads) land on
the collective that caused them. Events outside any collective land on
``"<untracked>"``.

Observability hooks: every outermost ``begin`` bumps the
per-slave monotonically increasing collective **sequence number** the
cluster hang diagnosis compares across ranks, :meth:`progress` is the
heartbeat payload the slave ships to the master, and every phase event
also lands in the bounded span ring (:mod:`ytk_mp4j_tpu_torch.obs.spans`) as
a chunk-granularity timeline span tagged with its collective and
sequence number.

Schema of one snapshot entry (all keys always present)::

    {"calls": int, "bytes_sent": int, "bytes_recv": int,
     "chunks": int, "keys": int, "retries": int, "reconnects": int,
     "aborts_seen": int, "wire_bytes_tcp": int, "wire_bytes_shm": int,
     "wire_seconds": float, "reduce_seconds": float,
     "serialize_seconds": float}

Phase seconds are BUSY times and may overlap in wall time (the whole
point of the pipelined engine is that wire and reduce overlap), so
their sum can exceed the collective's wall time.

``wire_bytes_tcp`` / ``wire_bytes_shm`` split the wire
bytes (both directions summed) by the transport they rode, so
``mp4j-scope live`` and postmortem bundles show which plane moved a
collective's data; events whose channel does not declare a transport
(bare test channels) book into neither, so the split is a lower bound
that equals the total whenever every byte rode a tagged channel. The
frame-size histogram splits the same way (``frame_bytes/tcp`` /
``frame_bytes/shm`` metric families).

``keys`` counts map entries this rank encoded into columnar frames
(the socket map plane) — per call it equals the local map
size, so analytic keys-per-second and wire-bytes-per-key fall straight
out of a snapshot. Columnar phase attribution: codec encode/decode and
value packing book ``serialize_seconds`` (they are serialization, like
pickle on the object path), the vectorized sorted-union merge books
``reduce_seconds``, and the paired column frames book wire
seconds/bytes through the channel like any framed array.
"""

from __future__ import annotations

import threading
import time

from ytk_mp4j_tpu_torch.obs import metrics as metrics_mod
from ytk_mp4j_tpu_torch.obs import spans

_PHASES = ("wire_seconds", "reduce_seconds", "serialize_seconds")
# retries/reconnects/aborts_seen: how many recovery rounds a
# collective burned (booked into its bucket), how many peer channels
# were re-dialed into a fresh epoch, and how many abort fan-outs this
# rank observed (control-plane events, booked wherever the rank stood).
# replacements_seen/shrinks_seen: membership changes this
# rank lived through — an adoption on the joiner, a renumbering on
# every shrink survivor.
# outstanding_peak/coalesced_frames + async_inflight/async_overlap
#: the nonblocking scheduler's counters. outstanding_peak
# is kept monotone by booking increases only (per-rank value = the
# true peak; cluster folds sum peaks across ranks); coalesced_frames
# counts fused map executions that merged >= 2 maps in one frame
# train; async_inflight/async_overlap are WALL seconds with >= 1 /
# >= 2 collectives outstanding (suffix-free on purpose — they are
# wall intervals, not busy phases, and must stay out of the phase
# span/critpath machinery), the substrate of the ovl% column.
# wire_bytes_shm_ring: the subset of wire_bytes_shm that
# moved through the lock-free rings themselves (raw-plane pieces AND
# frame-routed payload units) rather than the pair's TCP carrier — the
# acceptance evidence that the framed/columnar-map planes actually
# ride the rings for co-located pairs.
# coalesced_elems: elements shipped by fused
# allreduce_array_multi batches that merged >= 2 arrays — the array
# plane's analogue of the map plane's keys-under-coalescing evidence.
_COUNTERS = ("calls", "bytes_sent", "bytes_recv", "chunks", "keys",
             "retries", "reconnects", "aborts_seen",
             "replacements_seen", "shrinks_seen",
             "wire_bytes_tcp", "wire_bytes_shm",
             "wire_bytes_shm_ring",
             "outstanding_peak", "coalesced_frames",
             "coalesced_elems",
             "async_inflight", "async_overlap")

# transports the wire split books; anything else (bare test
# channels, transport-agnostic callers) keeps the untagged totals only
_TRANSPORTS = ("tcp", "shm")


def _zero() -> dict[str, float]:
    entry: dict[str, float] = {k: 0 for k in _COUNTERS}
    entry.update({k: 0.0 for k in _PHASES})
    return entry


class CommStats:
    """Per-backend collective counters (see module docstring).

    ``begin``/``end`` nest per THREAD (only the outermost names the
    bucket); the add methods may be called from any thread — helper
    threads inherit the bucket that was current when the work was
    handed to them via the ``bucket()`` handle.

    ``rank`` (set by the owning slave after rendezvous) tags the span
    ring's timeline track and the heartbeat's identity; ``None`` (e.g.
    a standalone thread group) renders as rank 0.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._agg: dict[str, dict[str, float]] = {}
        self._tl = threading.local()
        self.rank: int | None = None
        # metrics plane: per-family latency + frame-size
        # histograms ride here; the heartbeat ships their deltas.
        # MP4J_METRICS=0 turns every observe into a flag check.
        self.metrics = metrics_mod.MetricsRegistry()
        # audit plane: the owning slave's AuditRing, set
        # alongside ``rank`` — channels reach it through their
        # ``stats`` attachment for the per-frame wire digests
        # (MP4J_AUDIT=verify|capture); None when auditing is off or
        # the stats belong to a non-audited backend
        self.audit = None
        # progress state for the telemetry heartbeat / hang diagnosis
        self._seq = 0                      # outermost collectives entered
        self._current: str | None = None   # collective in flight
        self._current_since = 0.0
        self._last: str | None = None      # last collective completed
        self._last_phase: str | None = None
        # helper-thread fallback: pool workers doing wire work on a
        # collective's behalf have no thread-local scope, so the
        # outermost begin also publishes the name here. Concurrent
        # outermost scopes only happen on the thread backend, where the
        # barrier-aligned schedule guarantees they share one name.
        self._shared_name: str | None = None
        self._shared_seq = 0
        self._shared_depth = 0
        # per-link rolling accumulators: the tuner's
        # evidence substrate — cumulative wire bytes/seconds/frames per
        # peer link (split per transport) plus compression outcomes
        # (raw payload bytes -> wire bytes), all monotone so windowed
        # deltas fall out of two snapshots. Applied per-link socket
        # buffer sizes land here too (note_link) so the decision the
        # transport actually took is observable next to its evidence.
        self._links: dict[int, dict[str, float]] = {}

    # -- attribution ---------------------------------------------------
    def begin(self, name: str) -> int:
        """Enter a collective scope; returns the (truthy) sequence
        number when this is the outermost scope on the calling thread,
        0 for nested scopes (the caller must pass the return value back
        to :meth:`end`)."""
        depth = getattr(self._tl, "depth", 0)
        self._tl.depth = depth + 1
        if depth == 0:
            self._tl.name = name
            now = time.perf_counter()
            # per-thread start time: on the shared thread-backend stats
            # another thread's begin() can overwrite _current_since, so
            # the latency histogram reads the thread-local copy
            self._tl.t0 = now
            with self._lock:
                self._seq += 1
                seq = self._seq
                self._current = name
                self._current_since = now
                self._last_phase = None  # phase is per-collective: a
                # rank stuck before booking any phase must not report
                # the PREVIOUS collective's last phase in its heartbeat
                self._bucket_locked(name)["calls"] += 1
                self._shared_name = name
                self._shared_seq = seq
                self._shared_depth += 1
            self._tl.seq = seq
            return seq
        return 0

    def end(self, outermost: int) -> None:
        self._tl.depth = getattr(self._tl, "depth", 1) - 1
        if outermost:
            name = getattr(self._tl, "name", None)
            t0 = getattr(self._tl, "t0", None)
            self._tl.name = None
            with self._lock:
                self._last = self._current or self._last
                self._current = None
                self._shared_depth -= 1
                if self._shared_depth <= 0:
                    self._shared_name = None
            # per-family latency histogram (metrics plane):
            # observed outside the lock — the registry has its own
            if name is not None and t0 is not None:
                self.metrics.observe(
                    f"latency/{name}", time.perf_counter() - t0,
                    metrics_mod.LATENCY_LO, metrics_mod.LATENCY_BUCKETS)

    def bucket(self) -> str:
        """The current attribution bucket: this thread's collective
        scope, else the slave's active collective (helper threads),
        else ``"<untracked>"``."""
        return self._attribution()[0]

    def _attribution(self) -> tuple[str, int]:
        """(bucket, seq) captured TOGETHER, so a span's seq tag always
        matches the collective instance it is attributed to — on the
        shared thread-backend stats another thread's begin() may bump
        the global seq while this thread's scope is still open."""
        name = getattr(self._tl, "name", None)
        if name is not None:
            return name, getattr(self._tl, "seq", 0)
        shared = self._shared_name
        if shared is not None:
            return shared, self._shared_seq
        return "<untracked>", self._seq

    # -- nonblocking-scheduler attribution ------------------
    def async_begin(self, name: str) -> int:
        """Open a scheduler-driven collective scope WITHOUT the
        thread-local nesting of :meth:`begin` — the progression thread
        holds several collectives open at once, and per-thread depth
        tracking would fold them into one. Bumps the sequence number,
        counts the call, and publishes the shared helper-thread
        attribution name; pair with :meth:`async_end`."""
        now = time.perf_counter()
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._current = name
            self._current_since = now
            self._last_phase = None
            self._bucket_locked(name)["calls"] += 1
            self._shared_name = name
            self._shared_seq = seq
            self._shared_depth += 1
        return seq

    def async_end(self, name: str, seconds: float) -> None:
        """Close an :meth:`async_begin` scope, feeding the per-family
        latency histogram with the collective's submit-to-complete
        wall time."""
        with self._lock:
            self._last = name
            self._shared_depth -= 1
            if self._shared_depth <= 0:
                self._shared_depth = 0
                self._shared_name = None
                self._current = None
        self.metrics.observe(
            f"latency/{name}", seconds,
            metrics_mod.LATENCY_LO, metrics_mod.LATENCY_BUCKETS)

    class _Scope:
        __slots__ = ("stats", "name", "seq", "prev")

        def __init__(self, stats, name, seq):
            self.stats = stats
            self.name = name
            self.seq = seq

        def __enter__(self):
            tl = self.stats._tl
            self.prev = (getattr(tl, "name", None),
                         getattr(tl, "seq", 0))
            tl.name = self.name
            tl.seq = self.seq
            return self

        def __exit__(self, *exc):
            tl = self.stats._tl
            tl.name, tl.seq = self.prev
            return False

    def scope(self, name: str, seq: int):
        """Thread-local attribution override (no depth/seq side
        effects): the nonblocking engine wraps a blocking primitive it
        executes on a collective's behalf so the primitive's internal
        bookings land on that collective's bucket."""
        return self._Scope(self, name, seq)

    def seed_seq(self, seq: int) -> None:
        """Seed the collective sequence number of a freshly adopted
        joiner: its heartbeats must report the JOB's
        position, not 0 — a zero seq would read as the maximal laggard
        in every skew table and hang diagnosis the moment it joins."""
        with self._lock:
            self._seq = max(self._seq, int(seq))
            self._shared_seq = self._seq

    def progress(self) -> dict:
        """The heartbeat progress record (schema: obs.telemetry):
        sequence number, the collective in flight (and for how long),
        the last completed collective, and the last phase booked."""
        with self._lock:
            current_secs = (time.perf_counter() - self._current_since
                            if self._current is not None else 0.0)
            return {"seq": self._seq, "current": self._current,
                    "last": self._last, "phase": self._last_phase,
                    "current_secs": current_secs}

    # -- recording -----------------------------------------------------
    def _bucket_locked(self, name: str) -> dict[str, float]:
        entry = self._agg.get(name)
        if entry is None:
            entry = self._agg[name] = _zero()
        return entry

    def add(self, key: str, value: float, bucket: str | None = None) -> None:
        if bucket is None:
            name, seq = self._attribution()
        else:
            name, seq = bucket, self._seq
        is_phase = key.endswith("_seconds")
        with self._lock:
            self._bucket_locked(name)[key] += value
            if is_phase:
                self._last_phase = key[:-len("_seconds")]
        # module-flag guard: with spans disabled (MP4J_SPAN_RING=0) the
        # hot path pays one attribute read, not a call + kwargs dict
        if is_phase and spans._enabled:
            spans.phase(key[:-len("_seconds")], value, self.rank, name,
                        seq)

    def add_wire(self, bytes_sent: int, bytes_recv: int, seconds: float,
                 chunks: int = 1, bucket: str | None = None,
                 peer: int | None = None,
                 transport: str | None = None) -> None:
        if bucket is None:
            name, seq = self._attribution()
        else:
            name, seq = bucket, self._seq
        tagged = transport if transport in _TRANSPORTS else None
        with self._lock:
            e = self._bucket_locked(name)
            e["bytes_sent"] += bytes_sent
            e["bytes_recv"] += bytes_recv
            e["wire_seconds"] += seconds
            e["chunks"] += chunks
            if tagged is not None:
                e[f"wire_bytes_{tagged}"] += bytes_sent + bytes_recv
            if peer is not None:
                lk = self._link_locked(peer)
                lk["bytes"] += bytes_sent + bytes_recv
                lk["secs"] += seconds
                lk["frames"] += 1
                if tagged is not None:
                    lk[f"bytes_{tagged}"] += bytes_sent + bytes_recv
            self._last_phase = "wire"
        if spans._enabled:
            # transport rides the span args too: the
            # critical-path analyzer attributes a dominated ordinal to
            # a (rank, peer link, transport), so the wire span must
            # name the plane the bytes rode, not just the peer
            spans.phase("wire", seconds, self.rank, name, seq,
                        bytes_sent=bytes_sent or None,
                        bytes_recv=bytes_recv or None, peer=peer,
                        transport=tagged)
        # frame-size histogram, one observation per direction moved,
        # split per transport (the transport attribution)
        if self.metrics.enabled:
            fam = (f"frame_bytes/{tagged}" if tagged is not None
                   else "frame_bytes")
            if bytes_sent:
                self.metrics.observe(fam, bytes_sent,
                                     metrics_mod.FRAME_LO,
                                     metrics_mod.FRAME_BUCKETS)
            if bytes_recv:
                self.metrics.observe(fam, bytes_recv,
                                     metrics_mod.FRAME_LO,
                                     metrics_mod.FRAME_BUCKETS)

    # -- per-link evidence ----------------------------------
    def _link_locked(self, peer: int) -> dict[str, float]:
        lk = self._links.get(peer)
        if lk is None:
            lk = self._links[peer] = {
                "bytes": 0, "secs": 0.0, "frames": 0,
                "bytes_tcp": 0, "bytes_shm": 0,
                "comp_raw": 0, "comp_wire": 0, "comp_frames": 0,
                "xfer_bytes": 0, "xfers": 0}
        return lk

    def add_transfer(self, peer: int, nbytes: int) -> None:
        """Book one BULK transfer (a collective exchange segment) on
        ``peer``'s link — the granularity evidence the tuner's chunk
        policy consumes (add_wire's per-chunk frames can't recover
        the original transfer size)."""
        with self._lock:
            lk = self._link_locked(peer)
            lk["xfer_bytes"] += nbytes
            lk["xfers"] += 1

    def add_compress(self, peer: int, raw: int, wire: int) -> None:
        """Book one compression outcome on ``peer``'s link: ``raw``
        payload bytes went out as ``wire`` bytes. The rolling ratio
        (and the implied zlib cost already booked as serialize
        seconds) is the evidence the tuner's per-link compression
        policy weighs."""
        with self._lock:
            lk = self._link_locked(peer)
            lk["comp_raw"] += raw
            lk["comp_wire"] += wire
            lk["comp_frames"] += 1

    def note_link(self, peer: int, **info) -> None:
        """Record non-counter link facts (applied socket buffer
        sizes, transport tag) — absolute values, not accumulators."""
        with self._lock:
            self._link_locked(peer).update(info)

    def link_snapshot(self) -> dict[int, dict[str, float]]:
        """Per-peer-link rolling accumulators; two
        snapshots diff into one tuner decision window."""
        with self._lock:
            return {p: dict(v) for p, v in self._links.items()}

    def forget_links(self) -> None:
        """Drop the per-link accumulators (membership changes: a
        renumbered peer id must not inherit the old occupant's
        evidence)."""
        with self._lock:
            self._links.clear()

    # -- reading -------------------------------------------------------
    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._agg.items()}

    def clear(self) -> None:
        with self._lock:
            self._agg.clear()


def merge_snapshots(*snaps: dict[str, dict[str, float]]
                    ) -> dict[str, dict[str, float]]:
    """Key-wise sum of snapshots (the thread backend combines its
    intra-process counters with the shared process slave's; the master
    folds heartbeat DELTAS back into its rolling cumulative view)."""
    out: dict[str, dict[str, float]] = {}
    for snap in snaps:
        for name, entry in snap.items():
            acc = out.setdefault(name, _zero())
            for k, v in entry.items():
                acc[k] = acc.get(k, 0) + v
    return out


def diff_snapshots(cur: dict[str, dict[str, float]],
                   prev: dict[str, dict[str, float]]
                   ) -> dict[str, dict[str, float]]:
    """``cur - prev``, pruned to families that actually changed —
    the heartbeat payload: a long job's beat is
    bounded by activity since the last beat, not by every collective
    family ever seen. All stats are monotone accumulators, so
    ``merge_snapshots(prev, diff_snapshots(cur, prev)) == cur``."""
    out: dict[str, dict[str, float]] = {}
    for name, entry in cur.items():
        base = prev.get(name)
        if base is None:
            delta = dict(entry)
        else:
            delta = {k: v - base.get(k, 0) for k, v in entry.items()}
        if any(delta.values()):
            out[name] = delta
    return out
