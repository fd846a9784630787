"""Elastic membership for the socket backend.

A copy of ``ytk_mp4j_tpu/resilience/membership.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

The epoch-fenced abort/retry deliberately kept the roster fixed, so
a permanently dead rank was a job-wide :class:`Mp4jFatalError` — the
one failure class the chaos grid could not recover from. This module
holds the membership layer's shared vocabulary: the master's warm-spare
pool and membership event log, and the pure functions both sides of the
protocol derive their decisions from (mp4j-lint R1/R8 discipline: a
membership decision is a pure function of the shared round state, never
of anything rank-local).

Two modes, selected by ``MP4J_ELASTIC`` (validated in
``utils.tuning.elastic_mode``; default ``off`` keeps the pre-elastic
fail-fatal contract bit-for-bit):

**replace** — bit-exact continuation from a warm spare::

    spare: registers with the master at startup ({"spare": True} in the
           REGISTER payload), holds the control channel, pings, idles
    rank r dies (connection lost / stalled ack / escalated barrier)
    master: opens (or upgrades) an abort round -> epoch e
            requests a MANIFEST from the lowest live survivor:
              columnar keycodec vocabularies (pinned at the pre-attempt
              sizes every survivor's retry truncates back to), the
              outermost-collective ordinal, the barrier generation
    every survivor: tears down the old epoch's data plane, acks
    master: all acks + manifest -> sends the spare ("adopt", manifest
            + rank r + new roster + the audit watermark); the spare
            seeds its epoch/ordinal/vocabulary/barrier state, starts
            its control/accept threads, acks
    master: installs the spare's channel at rank r, swaps the roster,
            fans ("abort_go", e, {"replaced": ..., "roster": ...})
    survivors: swap the roster, restore their preserved inputs and
            re-run; the joiner's first collective enters at the SAME
            ordinal — the retry pairs bit-exactly, zero survivor errors

**shrink** — degraded continuation for reduction-only workloads::

    master: same round, no spare; survivors renumber contiguously
            (old ranks sorted ascending -> 0..n-2, a pure function of
            the survivor set), the roster drops the dead entry, and
            ("abort_go", e, {"shrink": ...}) ships the mapping
    survivors: adopt their new rank/slave_num, rebuild topology
            (host groups included) at n-1, and the fenced retry
            re-runs the collective over the surviving inputs

Shrink loses the dead rank's contribution by construction — correct
n-1 results, not bit-exact continuation — and it renumbers ranks, so
only workloads whose collective arguments do not bake in the original
rank count (allreduce/reduce/broadcast families; not caller-provided
``ranges``) survive it. mp4j-lint R15 polices the code-level half of
that hazard: topology derived from the roster must be read through the
roster-versioned accessor (``ProcessCommSlave._set_roster``), never
cached in long-lived attributes a renumbering silently strands.
"""

from __future__ import annotations

import collections
import time

from ytk_mp4j_tpu_torch.comm import keycodec
from ytk_mp4j_tpu_torch.exceptions import Mp4jError


# ----------------------------------------------------------------------
# pure protocol functions (both sides must derive identical answers)
# ----------------------------------------------------------------------
def joiner_seq(progress: dict[int, tuple[int, bool]]) -> int:
    """The collective ordinal a joining spare must resume AT (i.e. the
    count of collectives it should consider completed), from the
    survivors' abort-ack progress samples ``{rank: (seq, inflight)}``.

    In-flight survivors are retrying ordinal ``m = max(inflight
    seqs)``; idle survivors sit at ``m - 1`` (the master's
    ``_mixed_progress`` check enforces exactly this shape before any
    release). The joiner must behave like an idle rank — enter ``m``
    fresh — so it resumes at ``m - 1``. With nobody in flight (the
    death was detected between collectives) everyone sits at the same
    seq and the joiner matches it."""
    if not progress:
        return 0
    inflight = [s for s, f in progress.values() if f]
    if inflight:
        return max(inflight) - 1
    return max(s for s, _ in progress.values())


def shrink_mapping(slave_num: int, dead: set[int]) -> dict[int, int]:
    """Contiguous renumbering of the survivors: old rank -> new rank,
    survivors ordered by old rank. A pure function of (slave_num,
    dead) so the master and every survivor derive the identical map."""
    survivors = [r for r in range(slave_num) if r not in dead]
    return {old: new for new, old in enumerate(survivors)}


def swap_roster(roster: list, replacements: dict[int, tuple]) -> list:
    """A new roster with ``replacements[rank]`` entries swapped in —
    the replace-mode roster (same length, dead entries now point at
    the adopted spares' listen sockets / host fingerprints)."""
    out = list(roster)
    for rank, entry in replacements.items():
        out[rank] = entry
    return out


def shrink_roster(roster: list, mapping: dict[int, int]) -> list:
    """The n-1 roster: surviving entries in new-rank order."""
    out: list = [None] * len(mapping)
    for old, new in mapping.items():
        out[new] = roster[old]
    return out


def grow_roster(roster: list, entries: list[tuple]) -> list:
    """The n+k roster (grow mode): the adopted spares'
    (host, port, fp) entries appended in NEW-rank order — existing
    ids never move, so survivors keep every peer channel they hold."""
    return list(roster) + list(entries)


# ----------------------------------------------------------------------
# vocabulary replay (the manifest's columnar half)
# ----------------------------------------------------------------------
def export_vocab(codecs: dict, pin: dict | None) -> dict[str, list]:
    """Export the columnar key vocabularies for the adoption manifest:
    per key kind, the key list in CODE order. ``pin`` (the surviving
    donor's pre-attempt codec sizes, captured by the recovery wrapper's
    ``preserve``) truncates the export to the state every survivor's
    retry rolls back to — a failed map attempt may have tentatively
    grown the donor's codec, and shipping that growth would hand the
    joiner codes the retry's sync round is about to reassign.

    A kind ABSENT from a non-None pin did not exist at attempt entry
    (the codec was created by the in-flight attempt — the job's FIRST
    map of that kind, killed mid-sync): every survivor's retry
    truncates it to 0 (``sizes.get(kind, 0)`` in the wrapper's
    restore), so the export must ship it EMPTY too. Shipping the
    tentative growth instead hands the joiner a code table no survivor
    holds — its unique keys are silently absent from the retry's
    novelty round (already encoded locally, so never offered), and the
    job's code->key tables diverge permanently: the mid-map-sync
    replay gap, closed by the count negotiation."""
    out: dict[str, list] = {}
    for kind, codec in codecs.items():
        size = codec.size if pin is None else pin.get(kind, 0)
        keys = codec.export(size)
        if keys:
            out[kind] = keys
    return out


def import_vocab(target: dict, vocab: dict) -> None:
    """Rebuild a joiner's (empty) codec table from an exported
    manifest: code i maps to ``vocab[kind][i]``, exactly the
    assignment every survivor holds."""
    for kind, keys in (vocab or {}).items():
        if kind in target:
            raise Mp4jError(
                f"import_vocab: codec for kind {kind!r} already exists")
        codec = keycodec.codec_for_kind(kind)
        codec.import_keys(keys)
        target[kind] = codec


# ----------------------------------------------------------------------
# master-side bookkeeping (owned by Master, guarded by its lock)
# ----------------------------------------------------------------------
class SpareRecord:
    """One registered warm spare: its control channel, roster entry
    (host, listen_port, fp) and lifecycle flags."""

    __slots__ = ("idx", "ch", "entry", "alive", "adopting_rank",
                 "adopt_since", "last_ping", "grow")

    def __init__(self, idx: int, ch, entry: tuple):
        self.idx = idx
        self.ch = ch
        self.entry = entry
        self.alive = True
        self.adopting_rank: int | None = None   # mid-adoption target
        self.adopt_since: float | None = None   # mono ts of adopt send
        self.last_ping = time.monotonic()
        # grow mode: this adoption EXPANDS the roster (a NEW rank id at
        # a resize_point boundary) instead of replacing a casualty
        self.grow = False


class MembershipLog:
    """Counters + bounded event history for the membership plane —
    the source of the Prometheus series (``mp4j_replacements_total``,
    ``mp4j_shrinks_total``, ``mp4j_spares_available``), the
    ``mp4j-scope live`` badges, and the postmortem manifest's
    membership section. Guarded by the owner's (master's) lock."""

    def __init__(self, mode: str):
        self.mode = mode
        self.replacements = 0
        self.shrinks = 0
        # planned (autoscaler-driven) evictions and grow
        # rounds, counted apart from death-driven replacements — the
        # operator must be able to tell recovery from actuation
        self.planned_evictions = 0
        self.grows = 0
        self.events: collections.deque = collections.deque(maxlen=64)
        # rank -> current badge ("REPLACED@e1", "SHRUNK 3->2@e1")
        self.badges: dict[int, str] = {}

    def note_replace(self, rank: int, epoch: int, spare_idx: int,
                     why: str) -> None:
        self.replacements += 1
        self.badges[rank] = f"REPLACED@e{epoch}"
        self.events.append({
            "kind": "replace", "rank": rank, "epoch": epoch,
            "spare": spare_idx, "why": why,
            "mono": time.monotonic()})

    def note_evict(self, rank: int, epoch: int, spare_idx: int,
                   why: str) -> None:
        """A LIVE rank was proactively evicted and replaced (a
        planned eviction) — the autoscaler polls for this event kind
        to confirm its action landed."""
        self.planned_evictions += 1
        self.replacements += 1
        self.badges[rank] = f"EVICTED@e{epoch}"
        self.events.append({
            "kind": "planned_evict", "rank": rank, "epoch": epoch,
            "spare": spare_idx, "why": why,
            "mono": time.monotonic()})

    def note_spare(self, idx: int) -> None:
        """A warm spare registered. The autoscaler resolves a pending
        ``provision`` action on this event — observing the
        ``spares_available`` gauge alone is race-prone: a waiting
        membership round can claim the fresh spare synchronously at
        registration, so the gauge never visibly leaves 0 even though
        the provision succeeded (and saved the job)."""
        self.events.append({
            "kind": "spare_registered", "spare": idx,
            "mono": time.monotonic()})

    def note_evict_cancel(self, rank: int, token: int,
                          why: str) -> None:
        """An eviction FENCE was canceled before anything was torn
        down — zero disruption, the victim stays a member. The
        autoscaler reads this as a benign RETRY (budget refunded),
        never a circuit-breaker failure."""
        self.events.append({
            "kind": "evict_fence_cancel", "rank": rank,
            "token": token, "why": why, "mono": time.monotonic()})

    def note_evict_abort(self, ranks: list[int], epoch: int,
                         why: str) -> None:
        """A planned-eviction round could not complete (spare pool
        exhausted mid-round): the round was released as a plain abort
        with the victim still a member. The autoscaler reads this
        event as a FAILED action (circuit-breaker input)."""
        self.events.append({
            "kind": "evict_abort", "ranks": list(ranks),
            "epoch": epoch, "why": why, "mono": time.monotonic()})

    def note_grow(self, new_ranks: list[int], epoch: int,
                  gen: int) -> None:
        """Registered spares were adopted into NEW rank ids at a
        ``resize_point()`` boundary (grow mode)."""
        self.grows += 1
        for r in new_ranks:
            self.badges[r] = f"GROWN@z{gen}"
        self.events.append({
            "kind": "grow", "ranks": list(new_ranks), "epoch": epoch,
            "gen": gen, "mono": time.monotonic()})

    def note_grow_cancel(self, gen: int, why: str) -> None:
        """An approved grow was dropped BEFORE any adoption was
        dispatched (revalidation under the lock found the spare gone
        or a round open): zero disruption — the autoscaler settles
        its pending action as a benign retry, mirroring
        :meth:`note_evict_cancel`."""
        self.events.append({
            "kind": "grow_cancel", "gen": gen, "why": why,
            "mono": time.monotonic()})

    def note_grow_abort(self, ranks: list[int], gen: int,
                        why: str) -> None:
        """A grow round failed mid-adoption and was rolled back: the
        resize released unchanged, any seeded joiners were released
        with ``Mp4jEvicted``. A FAILED action for the autoscaler."""
        self.events.append({
            "kind": "grow_abort", "ranks": list(ranks), "gen": gen,
            "why": why, "mono": time.monotonic()})

    def note_shrink(self, dead: list[int], mapping: dict[int, int],
                    epoch: int, why: str) -> None:
        self.shrinks += 1
        self.badges = {new: f"SHRUNK {old}->{new}@e{epoch}"
                       for old, new in mapping.items() if old != new}
        self.events.append({
            "kind": "shrink", "dead": list(dead),
            "ranks": dict(mapping), "epoch": epoch, "why": why,
            "mono": time.monotonic()})

    def status(self, spares_available: int, spares_total: int) -> dict:
        """The membership document (metrics doc / postmortem manifest):
        plain JSON-ready values only."""
        return {
            "mode": self.mode,
            "replacements": self.replacements,
            "shrinks": self.shrinks,
            "planned_evictions": self.planned_evictions,
            "grows": self.grows,
            "spares_available": spares_available,
            "spares_total": spares_total,
            "badges": {str(r): b for r, b in self.badges.items()},
            "events": [dict(e) for e in self.events],
        }
