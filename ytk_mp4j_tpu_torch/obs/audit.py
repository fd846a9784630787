"""mp4j-audit — collective correctness auditing.

A copy of ``ytk_mp4j_tpu/obs/audit.py``, with its imports re-rooted at the
port; it imports nothing of the JAX package.

The third observability plane: mp4j-scope sees *time*, the
metrics plane sees *volume*; this plane sees *content*. Every
outermost collective on the socket backend gets a **digest record**
``(seq, family, operand sig, input digest, output digest)`` appended to
a bounded per-rank ring; in ``verify`` mode records also carry
**per-frame wire digests** (composable ``zlib.crc32`` over the exact
bytes the wire sees, folded at the Channel SPI so tcp and shm get them
for free, with transport attribution) and ship to the master as
heartbeat deltas, where :class:`ClusterAuditor` folds them and flags
any collective ordinal where ranks disagree — naming the ordinal, the
family and the minority ranks. ``capture`` mode additionally stores the
input payloads so ``mp4j-scope replay`` can re-execute the captured
schedule in-process on the thread backend and diff digests
record-by-record: offline reproduction of a divergence with no cluster.

Two digest algorithms, chosen for what each audits:

- **payload digests** (collective inputs/outputs) use a block-
  positional u64 xor hash over the canonicalized bytes
  (``ascontiguousarray`` + native byte order — the false-divergence
  hazard mp4j-lint R13 guards): the payload's u64 words split into 16
  contiguous blocks, each xor-reduced in one vectorized pass, and the
  16 block values combine with odd per-block weights. Measured 21-35
  GB/s on the bench host vs ~11 for a u64 ``np.dot`` polynomial and
  ~1 for ``zlib.crc32`` — the difference between a default-on
  ``digest`` mode and one nobody would leave enabled. Detection
  power matches the threat model (corruption, not adversaries): any
  flipped BIT changes exactly one block's xor and therefore the
  digest, always; transpositions across blocks change two weighted
  terms; only a reorder of equal-width words WITHIN one 1/16th block
  — not a shape wire corruption can take — escapes.
- **wire digests** (verify mode) use composable ``zlib.crc32`` folds —
  ``crc32(b, crc32(a)) == crc32(a + b)`` — over the exact bytes each
  channel/raw exchange moves, keyed per (peer, direction, transport).
  Folding is boundary-invariant, so the sender's per-buffer folds and
  the receiver's chunked receive folds agree whenever the byte STREAM
  agrees; a flipped bit anywhere in flight makes the pair's folds
  disagree, which the master reports as a wire divergence naming both
  ranks and the transport. Crucially this catches *consistent-wrong*
  corruption too: a corrupted contribution folded into a reduce makes
  every rank's output equal-but-wrong (output digests agree!), but the
  sender's clean send-fold vs the receiver's corrupted recv-fold still
  disagree.

Digest semantics per payload kind (job-wide canonical, see
:func:`digest_payload`): arrays digest their canonical bytes mixed with
dtype token and element count; maps digest as an ORDER-INSENSITIVE sum
of per-item (key, value) mixes, so dict iteration order — which
legitimately differs across ranks — can never cause a false
divergence; lists digest positionally; everything else digests its
pickle (deterministic for the plain keys/values that ride the wire).

Which families are cross-rank comparable: the replicated-output
collectives (:data:`REPLICATED`) — allreduce/broadcast/allgather for
arrays and maps, including the columnar map plane and the two-level
schedules, whose outputs are bitwise identical on every rank by
contract. Rooted/scattered families still record (and replay, and
family-compare: a rank running a DIFFERENT collective at the same
ordinal is flagged as schedule divergence), but their outputs
legitimately differ per rank and are never digest-compared.

This module deliberately imports nothing from ``comm`` at module scope
(the obs discipline); the replay driver imports the thread backend
lazily inside the function.
"""

from __future__ import annotations

import base64
import collections
import json
import os
import pickle
import threading
import time
import zlib

import numpy as np

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.obs import spans as spans_mod
from ytk_mp4j_tpu_torch.utils import tuning

_MASK = (1 << 64) - 1
_PRIME = 0x9E3779B97F4A7C15       # odd -> per-position injectivity
_PRIME2 = 0xBF58476D1CE4E5B9

# collectives whose OUTPUT is replicated bitwise on every rank — the
# set the master digest-compares. Rooted families
# record but only family-compare.
REPLICATED = frozenset({
    "allreduce_array", "broadcast_array", "allgather_array",
    "allreduce_map", "broadcast_map", "allgather_map",
})

# capture-mode payloads above this size are not captured (the record
# keeps digests + a "capskip" flag); bounds per-record memory like the
# ring bounds record count
CAPTURE_MAX_BYTES = 8 * 1024 * 1024


# ----------------------------------------------------------------------
# payload digests (u64 polynomial hash, vectorized)
# ----------------------------------------------------------------------
_BLOCKS = 16
# odd per-block weights: position across blocks is load-bearing
_BLOCK_W = ((np.arange(1, _BLOCKS + 1, dtype=np.uint64)
             * np.uint64(_PRIME)) | np.uint64(1))


def _mix(h: int) -> int:
    """splitmix64-style finalizer: diffuses low-entropy inputs so
    combined digests (sums, xors) don't cancel structurally."""
    h &= _MASK
    h = ((h ^ (h >> 30)) * _PRIME2) & _MASK
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK
    return h ^ (h >> 31)


def digest_bytes(buf) -> int:
    """Block-positional u64 digest of a contiguous bytes-like (see
    the module docstring for the detection-power argument).

    The u64 main body splits into 16 CONTIGUOUS blocks, each
    xor-reduced in one vectorized pass (contiguous rows keep numpy at
    memory bandwidth — a strided 16-lane layout measured 4x slower),
    then combines with odd per-block weights; the division remainder
    words, the sub-8-byte tail and the total length fold in
    afterwards, so ``b"a" + b"\\0"`` and ``b"a"`` differ.
    """
    u8 = np.frombuffer(buf, dtype=np.uint8)
    n = u8.size
    n8 = n >> 3
    h = 0
    if n8:
        words = u8[:n8 * 8].view(np.uint64)
        m = (n8 // _BLOCKS) * _BLOCKS
        if m:
            blocks = np.bitwise_xor.reduce(
                words[:m].reshape(_BLOCKS, -1), axis=1)
            h = int((blocks * _BLOCK_W).sum())
        for t in words[m:]:
            h = (h * _PRIME + int(t)) & _MASK
    tail = u8[n8 * 8:]
    if tail.size:
        h = (h * _PRIME + int.from_bytes(tail.tobytes(), "little")) & _MASK
    return _mix(h ^ ((n * _PRIME2) & _MASK))


def _dtype_token(dt: np.dtype) -> str:
    # wire name, mirroring transport.channel: extension float dtypes
    # (kind 'V') go by NAME because their .str decodes as raw void
    return dt.name if dt.kind == "V" else dt.str


def canon_array(a: np.ndarray) -> np.ndarray:
    """Canonical digest form of an array: contiguous, native byte
    order. Two ranks holding the SAME values in different memory
    layouts (a strided view; a big-endian wire relic) must digest
    identically — the false-divergence hazard mp4j-lint R13 exists
    for."""
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("="))
    return np.ascontiguousarray(a)


def digest_array(a: np.ndarray) -> int:
    a = canon_array(a)
    try:
        body = a.view(np.uint8).reshape(-1)
    except (TypeError, ValueError):
        # object / unviewable dtypes digest their pickle
        return digest_obj(a.tolist())
    h = digest_bytes(body)
    return _mix(h ^ zlib.crc32(_dtype_token(a.dtype).encode())
                ^ ((a.size * _PRIME) & _MASK))


def digest_obj(x) -> int:
    """Pickle-based digest for scalars/keys/odd values (deterministic
    for the plain ints/strings/tuples that ride the wire; an
    unpicklable object digests as a fixed sentinel — same on every
    rank, so it can never false-diverge, it just audits as opaque)."""
    try:
        return digest_bytes(pickle.dumps(x, protocol=4))
    except Exception:
        return _mix(0xDEAD)


def digest_payload(x) -> tuple[int, str]:
    """``(digest, operand signature)`` of one collective payload.

    The signature is a human/replay hint (``<f8[120000]``,
    ``map[800]``), not part of the digest; cross-rank comparison uses
    the digest only (map sizes legitimately differ pre-merge)."""
    if isinstance(x, np.ndarray):
        return digest_array(x), f"{_dtype_token(x.dtype)}[{x.size}]"
    if isinstance(x, dict):
        # order-insensitive combine: sum of per-item mixes mod 2^64 —
        # dict iteration order differs across ranks by construction
        h = 0
        for k, v in x.items():
            vh = (digest_array(v) if isinstance(v, np.ndarray)
                  else digest_obj(v))
            h = (h + _mix(digest_obj(k)
                          ^ ((vh * _PRIME) & _MASK))) & _MASK
        return _mix(h ^ ((len(x) * _PRIME2) & _MASK)), f"map[{len(x)}]"
    if isinstance(x, (list, tuple)):
        h = 0
        for i, v in enumerate(x):
            vh = (digest_array(v) if isinstance(v, np.ndarray)
                  else digest_obj(v))
            h = (h * _PRIME + _mix(vh ^ i)) & _MASK
        return _mix(h), f"list[{len(x)}]"
    if x is None:
        return _mix(1), "none"
    return digest_obj(x), type(x).__name__


def _payload_nbytes_floor(x) -> int:
    """A LOWER bound on a payload's serialized size, one cheap walk:
    array buffers only (pickle can never be smaller than the raw
    bytes). Used to skip capture-mode pickling of payloads that are
    certainly over the cap; an underestimate only costs the (bounded)
    pickle-then-discard pass it exists to avoid."""
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, dict):
        return sum(v.nbytes for v in x.values()
                   if isinstance(v, np.ndarray))
    if isinstance(x, (list, tuple)):
        return sum(v.nbytes for v in x if isinstance(v, np.ndarray))
    return 0


def fold_wire(crc: int, buf) -> int:
    """One composable wire-digest fold (zlib.crc32). Boundary-
    invariant: folding a stream in any chunking yields the same value,
    so sender-side per-buffer folds match receiver-side chunked-receive
    folds whenever the bytes match."""
    return zlib.crc32(buf, crc)


# ----------------------------------------------------------------------
# the per-rank audit ring
# ----------------------------------------------------------------------
class AuditRing:
    """Per-slave audit state: the bounded record ring, the current
    collective's wire-digest accumulators, and the heartbeat delta
    cursor.

    Modes (``MP4J_AUDIT``): ``digest`` records in/out digests only
    (record-only — nothing ships); ``verify`` adds the per-frame wire
    folds and ships records on the heartbeat; ``capture`` adds input
    payload capture for offline replay. ``off`` is represented by NOT
    constructing a ring at all (the slave keeps ``_audit = None``), so
    the disabled hot path is one attribute check.

    Thread-safety: ``on_wire`` may run on the send-helper thread
    concurrently with the collective thread's hooks; the ring lock
    serializes both. Exactly one collective is in flight per slave
    (the socket backend's contract), so the wire accumulators need no
    seq key — ``begin`` clears them, ``commit``/``abandon`` collects.
    """

    def __init__(self, mode: str | None = None, rank: int | None = None,
                 capacity: int | None = None):
        self.mode = tuning.audit_mode(mode)
        if self.mode == "off":
            raise Mp4jError("AuditRing(mode='off'): keep audit=None "
                            "instead of an off ring")
        self.rank = rank
        # set by the owning slave after rendezvous: the dump carries it
        # so replay knows the TRUE job size even when the highest
        # rank(s) died without leaving a bundle
        self.slave_num: int | None = None
        # rank replacement: a joining spare inherits the
        # last cross-rank-verified ordinal from the adoption manifest,
        # so its ring starts ALIGNED — every record it ever writes has
        # seq > watermark, and postmortem/replay readers know ordinals
        # at or below it were verified before this rank even existed
        self.watermark = 0
        self.wire_on = self.mode in ("verify", "capture")
        self.ships = self.mode in ("verify", "capture")
        self.captures = self.mode == "capture"
        cap = tuning.audit_ring() if capacity is None else int(capacity)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self._shipped = 0       # records already taken as a delta
        self._dropped = 0       # records that fell off unshipped
        self._appended = 0      # records ever appended (sink cursor)
        # current-collective wire folds: (peer, dir) -> [crc, bytes,
        # transport]
        self._wire: dict = {}

    # -- recording (collective thread + send helper) --------------------
    def begin(self, seq: int, family: str, payload, meta: dict) -> dict:
        """Open the record for outermost collective ``seq``: digest the
        input, optionally capture it, clear the wire accumulators."""
        h, sig = digest_payload(payload)
        rec = {"seq": int(seq), "fam": family, "sig": sig, "in": h,
               "out": None, **meta}
        if self.captures:
            cap = self._capture(payload)
            if cap is not None:
                rec["cap"] = cap
            else:
                rec["capskip"] = True
        with self._lock:
            self._wire.clear()
        return rec

    @staticmethod
    def _capture(payload) -> str | None:
        # cheap LOWER bound on the pickle size first: a 2 GB buffer
        # must not pay a full serialize pass (and a transient 2x
        # allocation) on the collective thread just to be discarded
        # as oversized — pickle of an ndarray is >= its nbytes
        if _payload_nbytes_floor(payload) > CAPTURE_MAX_BYTES:
            return None
        try:
            raw = pickle.dumps(payload, protocol=4)
        except Exception:
            return None
        if len(raw) > CAPTURE_MAX_BYTES:
            return None
        return base64.b64encode(zlib.compress(raw, 1)).decode("ascii")

    def on_wire(self, peer, direction: str, bufs, transport: str) -> None:
        """Fold wire bytes into the current collective's (peer,
        direction) accumulator — called from the Channel SPI
        (framed/columnar frames) and from the raw exchange (the native
        poll loop and the shm rings move bytes below the Python
        channel primitives, so the raw plane folds whole segments at
        exchange granularity; crc composability makes the two
        bookkeeping units comparable)."""
        if peer is None:
            return
        key = (int(peer), direction)
        with self._lock:
            ent = self._wire.get(key)
            if ent is None:
                ent = self._wire[key] = [0, 0, transport]
            for b in bufs:
                ent[0] = fold_wire(ent[0], b)
                # mp4j-lint: disable=R13 (length read, not a byte serialization)
                ent[1] += memoryview(b).nbytes

    def put_wire(self, folds: dict) -> None:
        """Install precomputed per-collective wire folds for the
        record about to :meth:`commit`: the nonblocking
        engine interleaves several collectives on the wire, so it
        folds each collective's legs into its OWN accumulator —
        ``{(peer, direction): [crc, nbytes, transport]}`` — and
        installs them here one record at a time, keeping the
        cross-rank pairwise wire comparison exact whatever the local
        interleaving was."""
        with self._lock:
            self._wire.clear()
            self._wire.update({k: list(v) for k, v in folds.items()})

    def reset_wire(self) -> None:
        """Drop the in-flight attempt's wire folds — called from the
        recovery restore path: a retried collective's failed attempt
        put bytes on a torn epoch's wire that the peer never folded
        (they died in the drain), so carrying them into the record
        would false-diverge every recovered seq."""
        with self._lock:
            self._wire.clear()

    def _collect_wire(self) -> dict | None:
        with self._lock:
            if not self._wire:
                return None
            out: dict = {}
            for (peer, direction), (crc, nbytes, transport) in \
                    self._wire.items():
                e = out.setdefault(str(peer), {"t": transport})
                e["s" if direction == "send" else "r"] = [crc, nbytes]
            self._wire.clear()
            return out

    def commit(self, rec: dict, payload) -> dict:
        """Close the record: digest the output, attach the wire folds,
        append to the ring."""
        h, sig = digest_payload(payload)
        rec["out"] = h
        rec["osig"] = sig
        if self.wire_on:
            w = self._collect_wire()
            if w:
                rec["wire"] = w
        self._append(rec)
        return rec

    def abandon(self, rec: dict, error: BaseException) -> None:
        """The collective raised terminally: record the attempt with
        the error instead of an output digest (the master skips digest
        comparison for errored records; postmortem/replay still see
        where the schedule stopped)."""
        rec["err"] = repr(error)[:200]
        rec.pop("cap", None)    # a failed record cannot replay
        with self._lock:
            self._wire.clear()
        self._append(rec)

    def _append(self, rec: dict) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                # the oldest record falls off: a shipped one just
                # advances the cursor; an UNSHIPPED one is a reportable
                # loss (the heartbeat delta carries the drop count)
                if self._shipped > 0:
                    self._shipped -= 1
                elif self.ships:
                    self._dropped += 1
            self._ring.append(rec)
            self._appended += 1

    # -- reading / shipping ---------------------------------------------
    def records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def read_since(self, cursor: int) -> tuple[int, list[dict], int]:
        """``(new_cursor, records, dropped)`` — records appended since
        ``cursor`` that are still in the ring, plus the count that
        already fell off. Non-destructive and independent of the
        heartbeat's ``take_delta`` cursor: the durable sink
        reads here without stealing records from the master's
        verification stream. Capture payloads stay out — the sink is a
        telemetry stream, the bundle carries bytes."""
        with self._lock:
            total, recs, dropped = spans_mod.ring_delta(
                self._ring, self._appended, cursor)
            return (total,
                    [{k: v for k, v in r.items() if k != "cap"}
                     for r in recs],
                    dropped)

    def take_delta(self) -> dict | None:
        """Records appended since the last take — the heartbeat
        payload (verify/capture modes; bounded by the ring: records
        that fell off unshipped are reported as a drop count, never
        silently lost). Capture payloads do NOT ride the heartbeat —
        the control plane carries digests, the bundle carries bytes."""
        if not self.ships:
            return None
        with self._lock:
            fresh = len(self._ring) - self._shipped
            if fresh <= 0 and not self._dropped:
                return None
            recs = list(self._ring)[-fresh:] if fresh > 0 else []
            self._shipped = len(self._ring)
            dropped, self._dropped = self._dropped, 0
        out = {"records": [{k: v for k, v in r.items() if k != "cap"}
                           for r in recs]}
        if dropped:
            out["dropped"] = dropped
        return out

    def dump(self) -> dict:
        """The postmortem-bundle / replay-bundle document
        (``audit.json``). ``watermark`` is nonzero only for an adopted
        joiner: the verified ordinal it inherited."""
        return {"rank": self.rank, "mode": self.mode,
                "slave_num": self.slave_num,
                "watermark": self.watermark,
                "records": self.records()}


# ----------------------------------------------------------------------
# master-side verification (pure state machine; comm/master.py owns it)
# ----------------------------------------------------------------------
_PENDING_CAP = 512


class ClusterAuditor:
    """Folds per-rank digest records and verifies each collective
    ordinal once every live rank has reported it.

    Checks per complete seq:

    - **schedule**: every rank must be running the same collective
      family at the same ordinal (a cheap mismatched-schedule
      detector that works even for rooted families);
    - **output digests** for :data:`REPLICATED` families: all ranks
      must agree bitwise; a disagreement names the minority ranks;
    - **wire digests** (when present): for every ordered pair, rank
      a's send-fold to b must equal b's recv-fold from a — the check
      that catches consistent-wrong corruption (a flipped byte folded
      into a reduce gives every rank the same wrong output) and
      attributes it to a transport;
    - **retry snapshots** are checked rank-locally at restore time
      (see ``comm/process_comm.py``), not here.

    NOT thread-safe: the owner (the master, under its lock)
    serializes folds. Log lines for NEW divergences are returned so
    the owner can emit them outside its lock.
    """

    def __init__(self, slave_num: int):
        self.slave_num = slave_num
        self._pending: dict[int, dict[int, dict]] = {}
        self.verified_seq = 0       # highest seq verified clean
        self.verified_total = 0     # seqs verified clean, lifetime
        self.divergence_total = 0
        self.divergences: collections.deque = collections.deque(maxlen=64)
        self.dropped_records = 0    # slaves' rings overflowed unshipped
        self.unverified_dropped = 0  # pending seqs pruned incomplete
        self.rank_seq: dict[int, int] = {}   # highest audited seq/rank

    def fold(self, rank: int, delta: dict | None,
             live: set[int]) -> list[str]:
        """Fold one heartbeat's audit delta; returns log lines for
        newly detected divergences."""
        if not delta:
            return []
        self.dropped_records += int(delta.get("dropped", 0))
        lines: list[str] = []
        for rec in delta.get("records", ()):
            try:
                seq = int(rec["seq"])
            except (KeyError, TypeError, ValueError):
                continue
            self.rank_seq[rank] = max(self.rank_seq.get(rank, 0), seq)
            self._pending.setdefault(seq, {})[rank] = rec
            lines.extend(self._maybe_verify(seq, live))
        # bound the pending table: a rank that stops shipping (died,
        # ring overflow) must not grow it forever
        while len(self._pending) > _PENDING_CAP:
            oldest = min(self._pending)
            del self._pending[oldest]
            self.unverified_dropped += 1
        return lines

    def _maybe_verify(self, seq: int, live: set[int]) -> list[str]:
        got = self._pending.get(seq)
        if got is None or not live <= set(got):
            return []
        del self._pending[seq]
        lines: list[str] = []
        # compare EVERY rank that reported the seq, not just the
        # still-live set: close flushes race rank departures, and a
        # cleanly-closed rank's records are exactly as comparable —
        # live-only comparison would shrink to one rank at job end
        # and wave corrupted seqs through as "verified"
        recs = {r: got[r] for r in sorted(got)}
        fams = {r: rec.get("fam") for r, rec in recs.items()}
        if len(set(fams.values())) > 1:
            # the minority schedule's ranks are the implicated ones
            fam_groups: dict = {}
            for r, f in fams.items():
                fam_groups.setdefault(f, []).append(r)
            fam_major = max(fam_groups.values(), key=len)
            dissent = [r for f, rs in fam_groups.items()
                       if rs is not fam_major for r in rs]
            lines.append(self._flag(
                seq, "schedule",
                f"ranks disagree about collective #{seq}: "
                + ", ".join(f"rank {r} ran {f!r}"
                            for r, f in fams.items()),
                ranks=dissent))
            return lines
        fam = next(iter(fams.values()))
        errs = [r for r, rec in recs.items() if "err" in rec]
        if errs:
            return lines    # failed collective: recovery owns this
        lines.extend(self._check_wire(seq, fam, recs))
        # nonstd calls (explicit from_/to/ranges/partitioner) digest
        # the WHOLE payload while the collective only replicates part
        # of it — bytes outside the range legitimately differ per
        # rank, so output comparison would false-alarm on healthy
        # jobs (checkprocess's ranged allreduce is the canonical
        # case); the wire check above still covers them
        nonstd = any(rec.get("nonstd") for rec in recs.values())
        if fam in REPLICATED and not nonstd:
            groups: dict[int, list[int]] = {}
            for r, rec in recs.items():
                groups.setdefault(rec.get("out"), []).append(r)
            if len(groups) > 1:
                majority = max(groups.values(), key=len)
                minority = sorted(r for d, rs in groups.items()
                                  if rs is not majority for r in rs)
                lines.append(self._flag(
                    seq, "output",
                    f"collective #{seq} ({fam}): replicated outputs "
                    f"DIVERGE — minority rank(s) {minority} disagree "
                    f"with ranks {sorted(majority)} "
                    f"({len(groups)} distinct digests)",
                    ranks=minority))
        if not lines:
            self.verified_total += 1
            if seq > self.verified_seq:
                self.verified_seq = seq
        return lines

    def _check_wire(self, seq: int, fam: str,
                    recs: dict[int, dict]) -> list[str]:
        lines = []
        for a, rec in recs.items():
            for peer_s, ent in (rec.get("wire") or {}).items():
                b = int(peer_s)
                back = (recs.get(b, {}).get("wire") or {}).get(str(a))
                if back is None:
                    continue
                sent, rcvd = ent.get("s"), back.get("r")
                if sent and rcvd and sent != rcvd:
                    lines.append(self._flag(
                        seq, "wire",
                        f"collective #{seq} ({fam}): wire digest "
                        f"mismatch rank {a} -> rank {b} over "
                        f"{ent.get('t', '?')}: sent "
                        f"crc={sent[0]:#010x}/{sent[1]}B but received "
                        f"crc={rcvd[0]:#010x}/{rcvd[1]}B — bytes "
                        "corrupted in flight",
                        ranks=[a, b]))
        return lines

    def _flag(self, seq: int, kind: str, msg: str,
              ranks: list[int] | tuple = ()) -> str:
        """Record one divergence. ``ranks`` names the implicated
        ranks structurally (minority / wire endpoints / schedule
        dissenters) so the health plane can escalate them
        without parsing the human-readable message."""
        self.divergence_total += 1
        self.divergences.append({"seq": seq, "kind": kind, "msg": msg,
                                 "ranks": sorted(int(r) for r in ranks)})
        return f"audit: DIVERGENCE ({kind}) {msg}"

    # -- elastic membership ----------------------------------
    def note_replacement(self, rank: int, resume_seq: int) -> list[str]:
        """Rank ``rank`` was re-populated from a spare resuming at
        ``resume_seq``: ordinals at or below it can never receive a
        record from the NEW occupant, so settle every pending seq in
        that range against whoever did report it (the dead occupant's
        pre-death records included — they are honest and comparable)
        instead of letting those seqs jam the pending table until the
        cap prunes them as silently unverified."""
        lines: list[str] = []
        for seq in sorted(s for s in self._pending if s <= resume_seq):
            # live=∅ forces completeness: verify among the reporters
            lines.extend(self._maybe_verify(seq, set()))
        return lines

    def note_grow(self, slave_num: int, resume_seq: int) -> list[str]:
        """The roster GREW: ordinals at or below the
        joiners' resume position can never receive their records —
        settle those pending seqs against whoever did report (the
        ``note_replacement`` rule), then widen the expected rank
        count for everything after."""
        lines: list[str] = []
        for seq in sorted(s for s in self._pending if s <= resume_seq):
            # live=∅ forces completeness among the actual reporters
            lines.extend(self._maybe_verify(seq, set()))
        self.slave_num = slave_num
        return lines

    def note_shrink(self, slave_num: int,
                    mapping: dict[int, int]) -> None:
        """The roster renumbered (shrink): remap the per-rank audit
        positions and drop pending seqs — their records are keyed by
        OLD ranks, and the retried ordinal's fresh records arrive
        under the new numbering (comparing across the rename would
        false-diverge every survivor against itself)."""
        self.slave_num = slave_num
        self.rank_seq = {mapping[r]: s for r, s in self.rank_seq.items()
                        if r in mapping}
        self.unverified_dropped += len(self._pending)
        self._pending.clear()

    def status(self) -> dict:
        """The cluster audit document (metrics endpoint, live view,
        postmortem manifest)."""
        return {
            "verified_seq": self.verified_seq,
            "verified_total": self.verified_total,
            "divergences": self.divergence_total,
            "last_divergences": list(self.divergences)[-8:],
            "dropped_records": self.dropped_records,
            "unverified_dropped": self.unverified_dropped,
            "rank_seq": {str(r): s for r, s in
                         sorted(self.rank_seq.items())},
        }


# ----------------------------------------------------------------------
# record/replay (the ``mp4j-scope replay`` command)
# ----------------------------------------------------------------------
def write_rank_audit(root: str, rank: int, dump: dict) -> str:
    """Write one rank's ``audit.json`` under ``root/rank_NNNN/`` —
    the same layout the postmortem flight recorder uses, so a clean
    capture run and a crash bundle replay identically."""
    d = os.path.join(root, f"rank_{rank:04d}")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "audit.json")
    # tmp + replace (mp4j-lint R14): replay must never decode a dump
    # torn by a dying process as a short-but-valid schedule
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(dump, fh)
    os.replace(tmp, path)
    return path


def load_audit_bundles(root: str) -> dict[int, dict]:
    """``{rank: audit document}`` from every ``rank_*/audit.json``
    under ``root`` (postmortem bundles and clean capture dumps alike);
    each document carries ``records``, ``mode`` and — since it is
    load-bearing for replay's dead-rank detection — ``slave_num``."""
    out: dict[int, dict] = {}
    for name in sorted(os.listdir(root)):
        if not name.startswith("rank_"):
            continue
        p = os.path.join(root, name, "audit.json")
        if not os.path.exists(p):
            continue
        try:
            rank = int(name[len("rank_"):])
        except ValueError:
            continue
        with open(p, encoding="utf-8") as fh:
            out[rank] = json.load(fh)
    return out


def _decode_capture(cap: str):
    return pickle.loads(zlib.decompress(base64.b64decode(cap)))


_REPLAY_FAMILIES = frozenset({
    "allreduce_array", "reduce_array", "broadcast_array",
    "allgather_array", "gather_array", "scatter_array",
    "reduce_scatter_array", "allreduce_map", "reduce_map",
    "broadcast_map", "gather_map", "allgather_map", "scatter_map",
    "reduce_scatter_map",
})


def _resolve(rec):
    """(method kwargs, reason) — replay call arguments resolved from a
    record's operand/operator/root names, or (None, why-not)."""
    from ytk_mp4j_tpu_torch.operands import Operands
    from ytk_mp4j_tpu_torch.operators import Operators

    if rec.get("fam") not in _REPLAY_FAMILIES:
        return None, f"family {rec.get('fam')!r} not replayable"
    if rec.get("nonstd"):
        return None, "call used non-default args (ranges/from_/to)"
    kwargs: dict = {}
    opn = rec.get("operand")
    if opn:
        byname = {o.name: o for o in Operands.NUMERIC}
        byname["STRING"] = Operands.STRING
        byname["OBJECT"] = Operands.OBJECT_OPERAND()
        if opn not in byname:
            return None, f"unknown operand {opn!r}"
        kwargs["operand"] = byname[opn]
    orn = rec.get("operator")
    if orn:
        try:
            kwargs["operator"] = Operators.by_name(orn)
        except Mp4jError:
            return None, f"operator {orn!r} not replayable (custom?)"
    if rec.get("root") is not None:
        kwargs["root"] = int(rec["root"])
    return kwargs, None


def replay_bundle(root: str) -> tuple[str, int]:
    """Re-execute a captured schedule on the thread backend and diff
    digests record-by-record; returns ``(report text, diverged
    count)``.

    Every rank's captured INPUT payloads for record k are handed to a
    standalone ``ThreadCommSlave`` group (one thread per rank, no
    master, no sockets) which runs the recorded collective; the
    replayed input/output digests are then compared with the recorded
    ones. A recorded output digest that disagrees with the clean
    replay reproduces the live divergence offline — down to which
    ranks and which digests.

    Parity note: the thread backend's merge association differs from
    some socket schedules (rhd/ring vs pairwise tree), so genuinely
    order-sensitive float reductions can differ in low bits; for the
    order-insensitive operator/value combinations the cross-backend
    property grids pin, replay is bit-exact. Records without captured
    payloads (digest/verify mode, oversized, custom operators) are
    reported as skipped, never silently dropped.
    """
    # lazy import: comm imports obs.audit; importing the thread
    # backend at module scope would cycle
    from ytk_mp4j_tpu_torch.comm.thread_comm import ThreadCommSlave

    bundles = load_audit_bundles(root)
    if not bundles:
        raise ValueError(f"{root}: no rank_*/audit.json bundles")
    ranks = sorted(bundles)
    # the TRUE job size comes from the bundles themselves (a dump
    # records slave_num): a dead HIGHEST rank leaves a contiguous
    # 0..n-2 bundle set that rank-contiguity alone cannot distinguish
    # from a healthy (n-1)-rank job — re-executing with the wrong
    # group size would flag every record of a run whose only fault
    # was the kill
    n = max([max(ranks) + 1]
            + [int(doc["slave_num"]) for doc in bundles.values()
               if doc.get("slave_num")])
    by_seq: dict[int, dict[int, dict]] = {}
    for r, doc in bundles.items():
        for rec in doc.get("records") or []:
            by_seq.setdefault(int(rec.get("seq", 0)), {})[r] = rec
    lines = [f"replay: {root} — {len(ranks)}/{n} rank(s), "
             f"{len(by_seq)} recorded collective(s)"]
    if ranks != list(range(n)):
        # a dead rank left no bundle: its inputs are gone, so the
        # schedule cannot be re-executed — degrade to the recorded
        # cross-rank comparison below, don't pretend to replay
        missing = sorted(set(range(n)) - set(ranks))
        lines.append(f"  cannot re-execute: rank(s) {missing} left no "
                     "audit bundle; comparing recorded digests only")
        slaves = None
    else:
        slaves = ThreadCommSlave.spawn_group(n)
    diverged = 0

    for seq in sorted(by_seq):
        recs = by_seq[seq]
        if set(recs) != set(ranks):
            lines.append(f"  #{seq}: SKIP — only ranks "
                         f"{sorted(recs)} recorded it")
            continue
        fams = {rec["fam"] for rec in recs.values()}
        if len(fams) > 1:
            diverged += 1
            lines.append(f"  #{seq}: SCHEDULE DIVERGENCE — "
                         + ", ".join(f"rank {r}: {rec['fam']}"
                                     for r, rec in sorted(recs.items())))
            continue
        fam = next(iter(fams))
        if any("err" in rec for rec in recs.values()):
            lines.append(f"  #{seq} {fam}: SKIP — recorded error "
                         "(schedule stopped here)")
            continue
        if slaves is None:
            nonstd = any(rec.get("nonstd") for rec in recs.values())
            if fam in REPLICATED and not nonstd:
                outs = {rec.get("out") for rec in recs.values()}
                if len(outs) > 1:
                    diverged += 1
                    lines.append(f"  #{seq} {fam}: DIVERGED "
                                 "(recorded digests disagree)")
                else:
                    lines.append(f"  #{seq} {fam}: ok (recorded)")
            else:
                lines.append(f"  #{seq} {fam}: SKIP — "
                             + ("non-default args"
                                if nonstd else "rooted family")
                             + ", recorded-only comparison")
            continue
        kwargs, why = _resolve(recs[ranks[0]])
        caps = {r: rec.get("cap") for r, rec in recs.items()}
        if kwargs is None or any(c is None for c in caps.values()):
            why = why or "no captured payload (run MP4J_AUDIT=capture)"
            lines.append(f"  #{seq} {fam}: SKIP — {why}")
            continue
        try:
            payloads = {r: _decode_capture(caps[r]) for r in ranks}
        except Exception as e:      # torn/corrupt capture bytes — the
            # exact artifact replay exists to diagnose, never a crash
            diverged += 1
            lines.append(f"  #{seq} {fam}: CAPTURE CORRUPT — payload "
                         f"decode failed ({e!r})")
            continue
        # replayed input digests must reproduce the recorded ones —
        # a mismatch means the capture itself is corrupt
        bad_in = [r for r in ranks
                  if digest_payload(payloads[r])[0] != recs[r]["in"]]
        if bad_in:
            diverged += 1
            lines.append(f"  #{seq} {fam}: CAPTURE CORRUPT — replayed "
                         f"input digest differs on rank(s) {bad_in}")
            continue
        out_digests, errs = _replay_one(slaves, fam, kwargs, payloads)
        if errs:
            # a replay-side execution error is its own diagnosis, not
            # a digest divergence — report the exception text. The
            # error may have stranded peer threads INSIDE the
            # collective, wedging the group's barriers: abandon it
            # (stuck daemon threads die with the process) and respawn
            # fresh slaves so the remaining records replay cleanly
            diverged += 1
            det = ", ".join(f"rank {r}: {e!r}"
                            for r, e in sorted(errs.items()))
            lines.append(f"  #{seq} {fam}: REPLAY ERROR — {det}")
            slaves = ThreadCommSlave.spawn_group(n)
            continue
        bad = [r for r in ranks
               if out_digests[r] != recs[r].get("out")]
        if bad:
            diverged += 1

            def hx(v):
                return f"{v:#018x}" if isinstance(v, int) else repr(v)

            det = ", ".join(
                f"rank {r}: recorded {hx(recs[r].get('out'))} != "
                f"replayed {hx(out_digests[r])}" for r in bad)
            lines.append(f"  #{seq} {fam}: DIVERGED — {det}")
        else:
            lines.append(f"  #{seq} {fam}: ok")
    if slaves is not None:
        for s in slaves:
            s.close(0)
    lines.append(f"replay: {diverged} diverged record(s)"
                 if diverged else "replay: all records clean")
    return "\n".join(lines), diverged


def _replay_one(slaves, fam: str, kwargs: dict,
                payloads: dict) -> tuple[dict[int, int],
                                         dict[int, BaseException]]:
    """Run one recorded collective across the thread group; returns
    (per-rank output digests, per-rank exceptions). An execution error
    surfaces as the record's REPLAY ERROR diagnosis rather than
    killing replay or masquerading as a digest divergence."""
    out: dict[int, int] = {}
    errs: dict[int, BaseException] = {}

    def run(slave):
        # no barrier here: the caller joins every thread before the
        # next record, and a barrier would wedge the erroring thread
        # behind peers stranded inside the failed collective
        r = slave.rank
        payload = payloads[r]
        try:
            getattr(slave, fam)(payload, **kwargs)
            out[r] = digest_payload(payload)[0]
        except Exception as e:       # noqa: BLE001 - reported per record
            errs[r] = e

    threads = [threading.Thread(target=run, args=(s,), daemon=True)
               for s in slaves]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30.0
    for t in threads:
        t.join(max(0.1, deadline - time.monotonic()))
    for r in payloads:
        if r not in out and r not in errs:
            errs[r] = TimeoutError(
                "replay thread never completed (one rank's error can "
                "strand its peers mid-collective)")
    return out, errs
