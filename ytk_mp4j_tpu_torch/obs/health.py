"""mp4j-health — streaming anomaly detection and per-rank verdicts.

A copy of ``ytk_mp4j_tpu/obs/health.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

The repo measures three telemetry planes — mp4j-scope time spans,
the metrics volume plane and the audit content
plane — but until this module nothing *interpreted* them.
This is the health plane: it folds every heartbeat into rolling
per-rank baselines, runs a detector set over the deltas, and drives a
per-rank hysteresis state machine whose verdicts are the decision
substrate the elastic autoscaler (ROADMAP) consumes — this plane
RECOMMENDS, it never acts.

State machine (per rank)::

    HEALTHY -> DEGRADED -> SUSPECT -> EVICT_RECOMMENDED
       ^          |           |              |
       +---- hysteresis: one level down per CLEAR_FOLDS clean folds
    DEAD  (from the existing liveness path; replacement resets)

Escalation is pressure-driven: each detector hit adds its severity to
a per-(rank, detector) leaky pressure counter (capped, halved on clean
folds); max pressure >= :data:`TH_DEGRADED` targets DEGRADED,
>= :data:`TH_SUSPECT` targets SUSPECT, and the machine climbs ONE
level per fold so a single noisy beat can never catapult a rank. Two
signals jump the ladder: an audit divergence naming the rank (content
corruption — straight to SUSPECT) and the dominator streak
(``MP4J_HEALTH_DOMINATOR_ORDINALS`` consecutive slow ordinals gated by
one rank — the ROADMAP's eviction contract — straight to
EVICT_RECOMMENDED, with SUSPECT forced at half the streak). Stepping
DOWN requires :data:`CLEAR_FOLDS` consecutive clean folds per level —
the hysteresis that keeps an intermittent straggler from flapping.

Detector set (each a pure function over snapshot deltas — tests drive
them without sockets):

- ``dominator`` — online port of :mod:`critpath`'s blame attribution:
  slaves fold their own span-ring delta into per-ordinal cells
  (:class:`SpanFolder`) and ship them on the heartbeat; the engine
  attributes each ordinal once every live rank's cell arrived
  (:func:`critpath.attribute` on the live deltas) and tracks both the
  sliding-window dominance share and the consecutive-ordinal streak.
  A dominance hit requires the ordinal to be SLOW against the rolling
  duration baseline (:data:`DOM_SLOW_FACTOR`) — a topology-biased but
  fast dominator on a healthy grid must stay quiet.
- ``latency_drift`` — per-family latency vs the rank's OWN baseline:
  EWMA of the per-fold mean plus the log2-histogram mean-bucket index;
  drift = mean above baseline by ``MP4J_HEALTH_DRIFT_PCT`` *and* the
  bucket index shifted a full log2 bucket (the histogram confirmation
  that defeats mean-only noise), two folds in a row.
- ``storm`` — retry/reconnect/abort counters: a leaky accumulator over
  the stats deltas; one clean recovery round never fires, a storm does.
- ``sink_drop`` — the durable sink is dropping records (full disk,
  dead drain): the ``sink/dropped_records`` counter moved.
- ``backlog`` — ``async/outstanding`` growing monotonically across
  folds: the scheduler is falling behind its submissions.
- ``hb_flap`` — heartbeat inter-arrival jitter: a beat landing far
  outside the rank's own EWMA gap (and the configured period).
- ``audit`` — divergence escalation: the cluster auditor named this
  rank in a divergence (minority output, wire pair, schedule).

Verdict transitions are emitted as structured **alert events** — into
the master log, pushed to the subject rank's recovery log and durable
sink (the ``alerts`` record kind in :mod:`sink`), exported as
Prometheus series (``mp4j_rank_health_state``, ``mp4j_alerts_total``,
``mp4j_evict_recommended``, ``mp4j_straggler_onsets_total``,
``mp4j_critpath_dominator``), surfaced via ``Master.health_status()``
(the operator hook a future autoscaler calls), the ``health`` column
in ``mp4j-scope live``, the ``mp4j-scope health`` subcommand, and the
postmortem report's health timeline.

Everything here is deliberately import-light (stdlib +
:mod:`critpath`/:mod:`spans`) and lock-free: the engine is owned by
the master and called under the master's lock; the slave-side pieces
(:class:`SpanFolder`, :class:`AlertLog`) carry their own tiny locks.
"""

from __future__ import annotations

import collections
import threading
import time

from ytk_mp4j_tpu_torch.obs import critpath, spans

# ---------------------------------------------------------------------
# states
# ---------------------------------------------------------------------
HEALTHY = 0
DEGRADED = 1
SUSPECT = 2
EVICT_RECOMMENDED = 3
DEAD = 4
STATE_NAMES = {HEALTHY: "HEALTHY", DEGRADED: "DEGRADED",
               SUSPECT: "SUSPECT",
               EVICT_RECOMMENDED: "EVICT_RECOMMENDED", DEAD: "DEAD"}
# compact forms for the 6-char `mp4j-scope live` column, keyed both
# ways (the live view holds state NAMES from the metrics doc)
STATE_SHORT = {HEALTHY: "ok", DEGRADED: "DEGR", SUSPECT: "SUSP",
               EVICT_RECOMMENDED: "EVICT", DEAD: "DEAD"}
SHORT_BY_NAME = {STATE_NAMES[c]: s for c, s in STATE_SHORT.items()}

DETECTORS = ("dominator", "latency_drift", "storm", "sink_drop",
             "backlog", "hb_flap", "audit", "liveness")

# ---------------------------------------------------------------------
# hysteresis constants
# ---------------------------------------------------------------------
# pressure thresholds: DEGRADED needs two ordinary (sev-1) hits close
# together, SUSPECT needs sustained hitting — a single noisy fold can
# never leave HEALTHY
TH_DEGRADED = 2.0
TH_SUSPECT = 5.0
PRESSURE_CAP = 10.0
# consecutive clean folds required to step DOWN one level (and the
# streak must re-earn each level) — the anti-flap hysteresis
CLEAR_FOLDS = 3
# folds a per-family latency baseline learns before drift can fire
WARMUP_FOLDS = 5
# consecutive drifting folds after which the baseline ADOPTS the new
# level — a legitimate workload change (bigger payloads) must become
# the new normal instead of flagging forever
DRIFT_ADAPT_FOLDS = 64
# dominance noise gates: the share window must hold this many
# attributed ordinals before a share hit can fire, and a dominated
# ordinal only counts as gating when its duration exceeds the rolling
# baseline by this factor (one log2 bucket, the drift philosophy) —
# a topology-biased dominator on a fast healthy grid stays quiet
DOM_MIN_FILL = 16
DOM_SLOW_FACTOR = 2.0
# minimum per-fold histogram observations before a drift comparison
# is statistically worth making
DRIFT_MIN_COUNT = 4
# storm accumulator: fires at this many recovery events net of decay
# (one clean retry round is 1-2 events — never a storm)
STORM_THRESHOLD = 3.0
# backlog: consecutive growing folds before the scheduler counts as
# falling behind
BACKLOG_FOLDS = 3
# heartbeat flap: a gap this multiple of the larger of (configured
# period, own EWMA gap) is a flap
FLAP_FACTOR = 4.0
# pending-ordinal bound: cells wait here for the last rank's heartbeat;
# a dead/wedged rank must not grow this forever
MAX_PENDING_CELLS = 2048

_PHASES = ("wire", "reduce", "serialize")


def _wall() -> float:
    # alert/baseline timestamps are ARTIFACT timestamps (rendered in
    # timelines next to sink records, compared across hosts), not
    # duration arithmetic
    # mp4j-lint: disable=R11 (artifact timestamp, not a duration)
    return time.time()


# ---------------------------------------------------------------------
# slave side: span-ring delta -> per-ordinal cells on the heartbeat
# ---------------------------------------------------------------------
class SpanFolder:
    """Folds this rank's span-ring delta into COMPLETED per-ordinal
    cells for the heartbeat's ``health_delta`` — the live-delta feed
    the engine's online dominator attribution consumes.

    A cell is the same shape :mod:`critpath` reconstructs offline::

        {"seq", "family", "t0" (wall), "dur",
         "phases": {"wire","reduce","serialize"},
         "links": {peer: {"secs", "transport", "bytes"}}}

    Phase spans land in the ring before their collective span, so a
    beat may catch an ordinal's phases without its collective span —
    those cells stay pending until the collective span arrives (or the
    pending bound evicts them: an aborted attempt's phases never
    complete). The per-beat cell count is capped (``max_cells``) with
    overflow counted, never silent — the payload-boundedness rule
    every heartbeat delta follows."""

    def __init__(self, rank: int, max_cells: int = 128,
                 max_pending: int = 512):
        self._rank = int(rank)
        self._cur = spans.oldest_cursor()
        self._pending: dict[int, dict] = {}
        self._max_cells = int(max_cells)
        self._max_pending = int(max_pending)
        self._lock = threading.Lock()
        self.dropped = 0            # lifetime, for status/debugging

    def _cell(self, seq: int) -> dict:
        return self._pending.setdefault(seq, {
            "seq": seq, "family": None, "t0": None, "dur": 0.0,
            "phases": dict.fromkeys(_PHASES, 0.0), "links": {}})

    def take(self) -> dict | None:
        """The heartbeat increment: ``{"cells": [...], "dropped": n}``
        or None when nothing completed since the last beat."""
        with self._lock:
            self._cur, items, ring_dropped = spans.take_since(self._cur)
            done: list[dict] = []
            for s in items:
                try:
                    name, cat, t0, dur, pid, _tid, args = s
                except (TypeError, ValueError):
                    continue
                if pid != self._rank:
                    continue
                args = args or {}
                seq = int(args.get("seq") or 0)
                if not seq:
                    continue
                if cat == "collective":
                    c = self._cell(seq)
                    c["family"] = name
                    c["t0"] = round(spans.to_wall(t0), 6)
                    c["dur"] = round(float(dur), 9)
                    self._pending.pop(seq, None)
                    done.append(c)
                elif cat == "phase" and name in _PHASES:
                    c = self._cell(seq)
                    c["phases"][name] = round(
                        c["phases"][name] + float(dur), 9)
                    if name == "wire" and args.get("peer") is not None:
                        link = c["links"].setdefault(
                            int(args["peer"]),
                            {"secs": 0.0, "transport": None, "bytes": 0})
                        link["secs"] = round(
                            link["secs"] + float(dur), 9)
                        if args.get("transport"):
                            link["transport"] = args["transport"]
                        link["bytes"] += int(args.get("bytes_sent") or 0) \
                            + int(args.get("bytes_recv") or 0)
            dropped = ring_dropped
            # bound the pending table: an aborted attempt's phases
            # never see their collective span — evict oldest ordinals
            while len(self._pending) > self._max_pending:
                self._pending.pop(min(self._pending), None)
                dropped += 1
            # bound the beat: ship the NEWEST completed cells (the
            # engine's window wants recency; old cells would only
            # re-open already-attributed ordinals)
            if len(done) > self._max_cells:
                dropped += len(done) - self._max_cells
                done = done[-self._max_cells:]
            self.dropped += dropped
            if not done and not dropped:
                return None
            return {"cells": done, "dropped": dropped}


class AlertLog:
    """Bounded per-rank alert-event log (the slave-side landing pad
    for the master's health-alert pushes). The durable sink drains it
    with the shared cursor-delta read (:func:`spans.ring_delta`) into
    the ``alerts`` record kind."""

    def __init__(self, maxlen: int = 512):
        self._events: collections.deque = collections.deque(
            maxlen=maxlen)
        self._count = 0
        self._lock = threading.Lock()

    def note(self, event: dict) -> None:
        with self._lock:
            self._events.append(dict(event))
            self._count += 1

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def events_since(self, cursor: int) -> tuple[int, list[dict], int]:
        with self._lock:
            return spans.ring_delta(self._events, self._count, cursor)


# ---------------------------------------------------------------------
# pure detector functions (each owns one small baseline dict)
# ---------------------------------------------------------------------
def detect_latency_drift(base: dict, hist_delta: dict,
                         drift_pct: float) -> tuple[int, str] | None:
    """One family's per-fold latency delta vs this rank's own EWMA
    baseline. ``base`` holds ``{"ewma", "ewma_bucket", "n", "arm",
    "driftn"}`` and is mutated in place; ``hist_delta`` is a metrics
    histogram delta (``{"lo", "n", "counts", "count", "sum"}``).

    Fires (sev, msg) when the fold's mean exceeds the baseline by
    ``drift_pct`` percent AND the mean log2-bucket index shifted at
    least one full bucket (2x) — both, two folds in a row. The
    baseline only learns from NON-drifting folds, so a degraded rank
    keeps firing instead of normalizing its own slowdown; after
    :data:`DRIFT_ADAPT_FOLDS` consecutive drifting folds the new
    level is adopted as the new normal."""
    count = int(hist_delta.get("count") or 0)
    if count < DRIFT_MIN_COUNT:
        return None
    mean = float(hist_delta.get("sum") or 0.0) / count
    counts = hist_delta.get("counts") or []
    occupied = sum(i * c for i, c in enumerate(counts))
    bucket = occupied / count
    if base.get("n", 0) < WARMUP_FOLDS:
        _learn(base, mean, bucket)
        return None
    factor = 1.0 + drift_pct / 100.0
    drifting = (mean > base["ewma"] * factor
                and bucket >= base["ewma_bucket"] + 1.0)
    if not drifting:
        base["arm"] = 0
        base["driftn"] = 0
        _learn(base, mean, bucket)
        return None
    base["driftn"] = base.get("driftn", 0) + 1
    if base["driftn"] >= DRIFT_ADAPT_FOLDS:
        # the new normal: adopt it and go quiet
        base.update(ewma=mean, ewma_bucket=bucket, n=WARMUP_FOLDS,
                    arm=0, driftn=0)
        return None
    base["arm"] = base.get("arm", 0) + 1
    if base["arm"] < 2:
        return None                 # first drifting fold only arms
    sev = 2 if mean > base["ewma"] * factor * 2.0 else 1
    return (sev, f"latency {mean * 1e3:.2f}ms vs baseline "
                 f"{base['ewma'] * 1e3:.2f}ms "
                 f"(+{(mean / base['ewma'] - 1) * 100:.0f}%, "
                 f"{bucket - base['ewma_bucket']:.1f} log2 buckets)")


def _learn(base: dict, mean: float, bucket: float,
           alpha: float = 0.2) -> None:
    n = base.get("n", 0)
    if n == 0:
        base["ewma"] = mean
        base["ewma_bucket"] = bucket
    else:
        base["ewma"] += alpha * (mean - base["ewma"])
        base["ewma_bucket"] += alpha * (bucket - base["ewma_bucket"])
    base["n"] = n + 1


def detect_storm(base: dict, events: float) -> tuple[int, str] | None:
    """Retry/reconnect/abort storm: a leaky accumulator (halved each
    fold) over the fold's recovery-event count. One clean recovery
    round (1-2 events) never reaches :data:`STORM_THRESHOLD`."""
    acc = base.get("acc", 0.0) * 0.5 + float(events)
    base["acc"] = acc
    if acc < STORM_THRESHOLD:
        return None
    sev = 2 if acc >= 2 * STORM_THRESHOLD else 1
    return (sev, f"recovery storm: {acc:.1f} weighted "
                 "retry/reconnect/abort events in the window")


def detect_sink_drop(base: dict, dropped_delta: float
                     ) -> tuple[int, str] | None:
    """The durable sink dropped records since the last fold — a full
    disk or dead drain thread is a telemetry OUTAGE, exactly the
    healthy-looking-dead state the sink's ``!`` marker exists for."""
    if dropped_delta <= 0:
        return None
    base["total"] = base.get("total", 0.0) + dropped_delta
    return (1, f"durable sink dropping records "
               f"(+{int(dropped_delta)} this fold, "
               f"{int(base['total'])} total)")


def detect_backlog(base: dict, outstanding: float | None
                   ) -> tuple[int, str] | None:
    """``mp4j_outstanding_collectives`` growing monotonically across
    :data:`BACKLOG_FOLDS` folds: the nonblocking scheduler is falling
    behind its submissions instead of oscillating with the workload."""
    if outstanding is None:
        return None
    prev = base.get("prev")
    if prev is not None and outstanding > prev:
        base["grow"] = base.get("grow", 0) + 1
    elif prev is not None and outstanding < prev:
        base["grow"] = 0
    base["prev"] = outstanding
    if base.get("grow", 0) < BACKLOG_FOLDS:
        return None
    return (1, f"outstanding-collective backlog growing "
               f"{base['grow']} folds straight "
               f"(now {outstanding:.0f})")


def detect_hb_flap(base: dict, gap: float | None, hb_secs: float
                   ) -> tuple[int, str] | None:
    """Heartbeat inter-arrival jitter: this beat arrived after a gap
    far outside both the configured period and the rank's own EWMA
    gap — the rank is wedging and recovering, not beating steadily."""
    if gap is None:
        return None
    ewma = base.get("ewma")
    hit = None
    floor = max(hb_secs, 0.05)
    if base.get("n", 0) >= WARMUP_FOLDS:
        bound = FLAP_FACTOR * max(floor, ewma)
        if gap > bound:
            hit = (1, f"heartbeat gap {gap:.2f}s vs expected "
                      f"~{max(floor, ewma):.2f}s (flapping)")
    if hit is None:
        # learn only steady gaps — a flap must not inflate its own
        # baseline out of detectability
        base["ewma"] = (gap if ewma is None
                        else ewma + 0.2 * (gap - ewma))
        base["n"] = base.get("n", 0) + 1
    return hit


# ---------------------------------------------------------------------
# per-rank verdict record
# ---------------------------------------------------------------------
class _RankHealth:
    __slots__ = ("state", "since_wall", "since_seq", "pressure",
                 "clean", "dirty", "alerts", "lat", "links", "hb",
                 "storm", "sink", "backlog", "last_seq", "why")

    def __init__(self):
        self.state = HEALTHY
        self.since_wall = _wall()
        self.since_seq = 0
        self.pressure: dict[str, float] = {}
        self.clean = 0              # consecutive clean folds
        self.dirty = False          # hit since this rank's last fold
        self.alerts: dict[str, int] = {}   # detector -> alerts emitted
        self.lat: dict[str, dict] = {}     # family -> drift baseline
        self.links: dict[int, dict] = {}   # peer -> {"ewma_gbs", "n"}
        self.hb: dict = {}
        self.storm: dict = {}
        self.sink: dict = {}
        self.backlog: dict = {}
        self.last_seq = 0
        self.why = ""               # last transition's message


class HealthEngine:
    """The master-owned streaming health engine (module docstring).
    Single-threaded by contract: every method is called under the
    master's lock, right where the heartbeat folds — the engine itself
    takes no locks."""

    def __init__(self, slave_num: int, *, enabled: bool = True,
                 window: int = 64, dominator_ordinals: int = 500,
                 drift_pct: float = 100.0, hb_secs: float = 0.5):
        self.slave_num = int(slave_num)
        self.enabled = bool(enabled)
        self.window = int(window)
        self.dominator_ordinals = int(dominator_ordinals)
        self.drift_pct = float(drift_pct)
        self.hb_secs = float(hb_secs)
        self._ranks: dict[int, _RankHealth] = {}
        # online dominator state
        self._cells: dict[int, dict[int, dict]] = {}   # seq -> rank -> cell
        self._dom_recent: collections.deque = collections.deque(
            maxlen=max(self.window, 1))    # (seq, dominator, slow)
        # cause-aware dominator rows: the tuner's leader-
        # demotion policy needs the CAUSE ("link->K over tcp") next to
        # the dominator, which the share window above deliberately
        # drops — a parallel bounded deque of dicts keeps the two
        # consumers decoupled
        self._dom_rows: collections.deque = collections.deque(
            maxlen=max(self.window, 1))
        # _dom_rows crosses lock domains: folds append under the
        # master's lock, the tuner controller snapshots under its own
        # — a private lock makes the rows' discipline self-contained
        self._dom_lock = threading.Lock()
        self._streak_rank: int | None = None
        self._streak = 0
        self._dur_ewma = 0.0
        self._dur_n = 0
        self._attributed = 0
        self._cells_dropped = 0
        self._onsets = 0
        self._onset_active: dict[int, bool] = {}
        # alert plumbing
        self._alerts: collections.deque = collections.deque(maxlen=64)
        self._alert_seq = 0
        self.alerts_total = 0
        self.first_degraded: dict | None = None
        self._arrival: dict[int, float] = {}    # rank -> mono arrival

    # -- fold entry points ---------------------------------------------
    def fold(self, rank: int, payload: dict, now: float,
             live: set[int]) -> list[dict]:
        """Fold one heartbeat (called from the master's telemetry
        fold). ``now`` is monotonic; returns newly emitted alert
        events."""
        if not self.enabled:
            return []
        rank = int(rank)
        rec = self._ranks.setdefault(rank, _RankHealth())
        if rec.state == DEAD:
            return []               # zombie beat after declaration
        hits: dict[int, list[tuple[str, int, str]]] = {rank: []}
        own = hits[rank]
        progress = payload.get("progress") or {}
        rec.last_seq = int(progress.get("seq") or rec.last_seq)

        # heartbeat inter-arrival
        last = self._arrival.get(rank)
        self._arrival[rank] = now
        gap = (now - last) if last is not None else None
        hit = detect_hb_flap(rec.hb, gap, self.hb_secs)
        if hit:
            own.append(("hb_flap", *hit))

        # stats delta: recovery storms
        sd = payload.get("stats_delta") or {}
        events = sum(float(e.get(k, 0) or 0)
                     for e in sd.values() if isinstance(e, dict)
                     for k in ("retries", "reconnects", "aborts_seen"))
        hit = detect_storm(rec.storm, events)
        if hit:
            own.append(("storm", *hit))

        # metrics delta: latency drift per family, sink drops, backlog
        md = payload.get("metrics_delta") or {}
        for name, h in (md.get("histograms") or {}).items():
            if not name.startswith("latency/"):
                continue
            fam = name[len("latency/"):]
            hit = detect_latency_drift(
                rec.lat.setdefault(fam, {}), h, self.drift_pct)
            if hit:
                own.append(("latency_drift", hit[0],
                            f"{fam}: {hit[1]}"))
        drops = float((md.get("counters") or {}).get(
            "sink/dropped_records", 0) or 0)
        hit = detect_sink_drop(rec.sink, drops)
        if hit:
            own.append(("sink_drop", *hit))
        hit = detect_backlog(
            rec.backlog,
            (md.get("gauges") or {}).get("async/outstanding"))
        if hit:
            own.append(("backlog", *hit))

        # the online dominator: fold this rank's cells, attribute what
        # completed (hits may target OTHER ranks), track baselines
        floors: dict[int, int] = {}
        alerts: list[dict] = []
        self._fold_cells(rank, payload.get("health_delta"), live,
                         hits, floors, alerts)

        for r, rhits in hits.items():
            alerts.extend(self._apply(r, rhits, floors.get(r),
                                      own_fold=(r == rank)))
        return alerts

    def note_audit(self, entries: list[dict], live: set[int]
                   ) -> list[dict]:
        """Audit-divergence escalation: each divergence naming ranks
        forces those ranks at least to SUSPECT — content corruption
        outranks every latency signal."""
        if not self.enabled:
            return []
        alerts: list[dict] = []
        for e in entries or ():
            for r in e.get("ranks") or ():
                r = int(r)
                if live and r not in live:
                    continue
                alerts.extend(self._apply(
                    r, [("audit", 3,
                         f"audit divergence at collective "
                         f"#{e.get('seq')}: {e.get('msg', '')[:160]}")],
                    SUSPECT, own_fold=False))
        return alerts

    def note_dead(self, rank: int, why: str) -> list[dict]:
        """The liveness path declared ``rank`` dead — the one verdict
        this engine does not decide itself, recorded so the health
        plane tells one coherent story."""
        if not self.enabled:
            return []
        rec = self._ranks.setdefault(int(rank), _RankHealth())
        if rec.state == DEAD:
            return []
        old = rec.state
        rec.state = DEAD
        rec.since_wall = _wall()
        rec.why = why
        ev = self._emit(int(rank), "liveness", old, DEAD,
                        f"declared dead: {why}", rec)
        return [ev]

    def note_replacement(self, rank: int) -> list[dict]:
        """A spare was adopted into ``rank``: the verdict, pressures
        and baselines belonged to the dead occupant — the joiner
        starts HEALTHY with fresh baselines."""
        if not self.enabled:
            return []
        rec = self._ranks.get(int(rank))
        old = rec.state if rec is not None else HEALTHY
        self._ranks[int(rank)] = _RankHealth()
        self._arrival.pop(int(rank), None)
        if old == HEALTHY:
            return []
        ev = self._emit(int(rank), "liveness", old, HEALTHY,
                        "replaced from a warm spare — fresh baselines",
                        self._ranks[int(rank)])
        return [ev]

    def note_grow(self, slave_num: int) -> None:
        """The roster GREW: widen the expected rank count.
        Ordinals completed before the growth can never collect the
        joiners' cells — drop them (counted, never silent) so they
        don't jam the pending table until the cap prunes them; the
        joiners' verdicts start HEALTHY lazily on their first fold."""
        self.slave_num = int(slave_num)
        self._cells_dropped += sum(len(c) for c in self._cells.values())
        self._cells.clear()

    def note_shrink(self, slave_num: int,
                    mapping: dict[int, int]) -> None:
        """The roster renumbered: remap verdicts, drop the dead, and
        drop pending cells (they are keyed by OLD ranks; the retried
        ordinals' fresh cells arrive under the new numbering)."""
        self.slave_num = int(slave_num)
        self._ranks = {mapping[r]: rec for r, rec in self._ranks.items()
                       if r in mapping}
        self._arrival = {mapping[r]: t for r, t in self._arrival.items()
                         if r in mapping}
        self._onset_active = {mapping[r]: a for r, a
                              in self._onset_active.items()
                              if r in mapping}
        self._cells_dropped += sum(len(c) for c in self._cells.values())
        self._cells.clear()
        self._dom_recent.clear()
        self._streak_rank, self._streak = None, 0

    # -- the online dominator ------------------------------------------
    def _fold_cells(self, rank: int, delta: dict | None,
                    live: set[int], hits: dict, floors: dict,
                    out: list[dict]) -> None:
        if not delta:
            return
        rec = self._ranks.setdefault(rank, _RankHealth())
        self._cells_dropped += int(delta.get("dropped") or 0)
        for cell in delta.get("cells") or ():
            seq = int(cell.get("seq") or 0)
            if not seq:
                continue
            links = {int(p): lk for p, lk
                     in (cell.get("links") or {}).items()}
            # rolling per-link wire GB/s baseline (status evidence for
            # the autoscaler: which link a slow rank is slow ON)
            for peer, lk in links.items():
                secs = float(lk.get("secs") or 0.0)
                if secs > 0 and lk.get("bytes"):
                    gbs = float(lk["bytes"]) / secs / 1e9
                    base = rec.links.setdefault(
                        peer, {"ewma_gbs": gbs, "n": 0})
                    base["ewma_gbs"] += 0.2 * (gbs - base["ewma_gbs"])
                    base["n"] += 1
            self._cells.setdefault(seq, {})[rank] = {
                "family": cell.get("family"),
                "t0": cell.get("t0"),
                "dur": float(cell.get("dur") or 0.0),
                "phases": {p: float((cell.get("phases") or {})
                                    .get(p, 0.0)) for p in _PHASES},
                "links": links,
            }
        need = len(live) if live else self.slave_num
        for seq in sorted(self._cells):
            if len(self._cells[seq]) < need:
                continue
            rows = critpath.attribute({seq: self._cells.pop(seq)})
            if rows:
                self._note_row(rows[0], hits, floors, out)
        # bound pending: a wedged rank's missing cells must not grow
        # this forever — evict oldest (counted, never silent)
        while len(self._cells) > MAX_PENDING_CELLS:
            victim = min(self._cells)
            self._cells_dropped += len(self._cells.pop(victim))

    def _note_row(self, row: dict, hits: dict, floors: dict,
                  out: list[dict]) -> None:
        self._attributed += 1
        dom = int(row["dominator"])
        dur = float(row["dur"])
        slow = (self._dur_n >= DOM_MIN_FILL
                and dur > self._dur_ewma * DOM_SLOW_FACTOR)
        if not slow:
            # baseline learns only non-gating ordinals after warmup,
            # so a persistent straggler cannot normalize itself
            self._dur_ewma = (dur if self._dur_n == 0 else
                              self._dur_ewma
                              + 0.05 * (dur - self._dur_ewma))
            self._dur_n += 1
        self._dom_recent.append((int(row["seq"]), dom, slow))
        with self._dom_lock:
            self._dom_rows.append({"seq": int(row["seq"]), "dom": dom,
                                   "cause": row.get("cause") or "?",
                                   "slow": slow})
        if slow and dom == self._streak_rank:
            self._streak += 1
        elif slow:
            self._streak_rank, self._streak = dom, 1
        else:
            self._streak_rank, self._streak = None, 0

        # the streak trigger stands on its own (the ROADMAP contract:
        # N consecutive gated ordinals => evictable) — it must not
        # wait for the window share to qualify; slowness is already
        # baked in (only slow dominated rows extend the streak)
        floor = None
        sev = 1
        cause = row.get("cause") or "?"
        if self._streak >= self.dominator_ordinals:
            floor, sev = EVICT_RECOMMENDED, 2
        elif self._streak >= max(self.dominator_ordinals // 2, 2):
            floor, sev = SUSPECT, 2
        if floor is not None:
            floors[dom] = max(floors.get(dom, 0), floor)
        win = self._dom_recent
        dom_rows = [s for _, d, s in win if d == dom]
        share = len(dom_rows) / len(win)
        slow_share = (sum(dom_rows) / len(dom_rows)) if dom_rows else 0
        qualified = (len(win) >= DOM_MIN_FILL
                     and share >= critpath.ONSET_SHARE
                     and slow_share >= 0.5)
        if qualified or floor is not None:
            msg = (f"critical-path dominator: {share * 100:.0f}% of "
                   f"the last {len(win)} ordinal(s), cause {cause}, "
                   f"streak {self._streak}")
            if floor == EVICT_RECOMMENDED:
                msg += (f" >= MP4J_HEALTH_DOMINATOR_ORDINALS="
                        f"{self.dominator_ordinals}")
            hits.setdefault(dom, []).append(("dominator", sev, msg))
        if qualified and not self._onset_active.get(dom):
            self._onset_active[dom] = True
            self._onsets += 1
            dom_rec = self._ranks.setdefault(dom, _RankHealth())
            dom_rec.alerts["dominator"] = \
                dom_rec.alerts.get("dominator", 0) + 1
            out.append(self._push_alert({
                "rank": dom, "detector": "dominator",
                "kind": "onset",
                "from": STATE_NAMES[self._state_of(dom)],
                "to": STATE_NAMES[self._state_of(dom)],
                "seq": int(row["seq"]),
                "msg": f"straggler onset at collective "
                       f"#{row['seq']}: {msg}"}))
        # re-arm every rank that dropped well below the threshold
        counts: dict[int, int] = {}
        for _, d, _s in win:
            counts[d] = counts.get(d, 0) + 1
        for r in list(self._onset_active):
            if (self._onset_active[r]
                    and counts.get(r, 0) / len(win)
                    < critpath.ONSET_SHARE / 2):
                self._onset_active[r] = False

    def _state_of(self, rank: int) -> int:
        rec = self._ranks.get(rank)
        return rec.state if rec is not None else HEALTHY

    # -- hysteresis state machine --------------------------------------
    def _apply(self, rank: int, rhits: list, floor: int | None,
               own_fold: bool) -> list[dict]:
        rec = self._ranks.setdefault(rank, _RankHealth())
        if rec.state == DEAD:
            return []
        if rhits:
            rec.dirty = True
            rec.clean = 0
            for det, sev, _msg in rhits:
                rec.pressure[det] = min(
                    PRESSURE_CAP, rec.pressure.get(det, 0.0) + sev)
        elif own_fold:
            # this rank's own fold with no hit from any source since
            # its previous fold: decay toward recovery
            if rec.dirty:
                rec.dirty = False
            else:
                rec.clean += 1
                for det in list(rec.pressure):
                    rec.pressure[det] *= 0.5
                    if rec.pressure[det] < 0.25:
                        del rec.pressure[det]

        maxp = max(rec.pressure.values(), default=0.0)
        target = HEALTHY
        if maxp >= TH_DEGRADED:
            target = DEGRADED
        if maxp >= TH_SUSPECT:
            target = SUSPECT
        if floor:
            target = max(target, floor)

        alerts: list[dict] = []
        if target > rec.state:
            # jump straight to a forced floor (audit, dominator
            # streak); pressure-driven escalation climbs ONE level per
            # fold so a single noisy beat can never catapult a rank
            new = max(rec.state + 1, floor or 0)
            new = min(new, target)
            det, msg = self._dominant(rec, rhits)
            alerts.append(self._transition(rank, rec, new, det, msg))
        elif (target < rec.state and rec.clean >= CLEAR_FOLDS
              and not floor):
            new = rec.state - 1
            rec.clean = 0           # re-earn each level down
            alerts.append(self._transition(
                rank, rec, new, "recovery",
                f"{CLEAR_FOLDS} clean folds — stepping down"))
        return alerts

    @staticmethod
    def _dominant(rec: _RankHealth, rhits: list) -> tuple[str, str]:
        """The detector (and message) a transition is attributed to:
        the loudest hit THIS fold, else the highest-pressure one."""
        if rhits:
            det, _sev, msg = max(rhits, key=lambda h: h[1])
            return det, msg
        if rec.pressure:
            det = max(rec.pressure, key=rec.pressure.get)
            return det, f"sustained {det} pressure"
        return "recovery", ""

    def _transition(self, rank: int, rec: _RankHealth, new: int,
                    det: str, msg: str) -> dict:
        old = rec.state
        rec.state = new
        rec.since_wall = _wall()
        rec.since_seq = rec.last_seq
        rec.why = msg
        return self._emit(rank, det, old, new, msg, rec)

    def _emit(self, rank: int, det: str, old: int, new: int,
              msg: str, rec: _RankHealth) -> dict:
        ev = {"rank": rank, "detector": det, "kind": "state",
              "from": STATE_NAMES[old], "to": STATE_NAMES[new],
              "seq": rec.last_seq, "msg": msg}
        self._push_alert(ev)
        if new > old and old == HEALTHY and self.first_degraded is None:
            self.first_degraded = {
                "rank": rank, "detector": det, "wall": ev["wall"],
                "seq": rec.last_seq, "to": STATE_NAMES[new],
                "msg": msg}
        # EVERY emitted alert counts in mp4j_alerts_total{rank,
        # detector} — liveness (DEAD/replacement) included, so the
        # per-detector counters always sum to alerts_total
        rec.alerts[det] = rec.alerts.get(det, 0) + 1
        return ev

    def _push_alert(self, ev: dict) -> dict:
        self._alert_seq += 1
        self.alerts_total += 1
        ev.setdefault("id", self._alert_seq)
        ev.setdefault("wall", _wall())
        self._alerts.append(ev)
        return ev

    # -- the operator hook ---------------------------------------------
    def dominator_rows(self) -> list[dict]:
        """The recent cause-aware attribution rows ``[{seq, dom,
        cause, slow}]`` (bounded by the window) — the evidence the
        master's tuner controller feeds
        :func:`ytk_mp4j_tpu_torch.utils.tuner.decide_leaders`."""
        with self._dom_lock:
            return list(self._dom_rows)

    def dominator_shares(self) -> dict[int, float]:
        """Sliding-window dominance share per rank (the
        ``mp4j_critpath_dominator`` gauge)."""
        win = self._dom_recent
        if not win:
            return {}
        counts: dict[int, int] = {}
        for _, d, _s in win:
            counts[d] = counts.get(d, 0) + 1
        return {r: c / len(win) for r, c in sorted(counts.items())}

    def status(self) -> dict:
        """The health document — ``Master.health_status()``, the
        metrics doc's ``cluster.health`` section, the postmortem
        manifest. This is the contract the future elastic autoscaler
        reads: ``evict_recommended`` lists the ranks this plane
        RECOMMENDS replacing (it never acts), each with the detector
        evidence behind the verdict."""
        ranks = {}
        for r in sorted(self._ranks):
            rec = self._ranks[r]
            ranks[str(r)] = {
                "state": STATE_NAMES[rec.state],
                "state_code": rec.state,
                "since_wall": rec.since_wall,
                "since_seq": rec.since_seq,
                "why": rec.why,
                "pressure": {d: round(p, 2)
                             for d, p in sorted(rec.pressure.items())},
                "alerts": dict(sorted(rec.alerts.items())),
                "links_gbs": {str(p): round(b["ewma_gbs"], 4)
                              for p, b in sorted(rec.links.items())},
            }
        return {
            "enabled": self.enabled,
            "window": self.window,
            "dominator_ordinals": self.dominator_ordinals,
            "ranks": ranks,
            "evict_recommended": sorted(
                r for r, rec in self._ranks.items()
                if rec.state == EVICT_RECOMMENDED),
            "dominator": {
                "shares": {str(r): round(s, 3) for r, s
                           in self.dominator_shares().items()},
                "streak_rank": self._streak_rank,
                "streak": self._streak,
                "attributed": self._attributed,
                "cells_dropped": self._cells_dropped,
                "onsets": self._onsets,
            },
            "alerts_total": self.alerts_total,
            "first_degraded": self.first_degraded,
            "last_alerts": list(self._alerts)[-8:],
        }


# ---------------------------------------------------------------------
# rendering (the `mp4j-scope health` subcommand + postmortem section)
# ---------------------------------------------------------------------
_fmt_wall = critpath.fmt_wall


def format_alert(ev: dict) -> str:
    if ev.get("kind") == "autoscale":
        # an autoscaler action event — rides the same
        # alert pipe so timelines interleave actions with verdicts
        return (f"{_fmt_wall(ev.get('wall'))}  autoscaler "
                f"{ev.get('event')} {ev.get('action')}"
                + (f" rank {ev['rank']}"
                   if ev.get("rank") is not None else "")
                + f": {ev.get('msg', '')}")
    if ev.get("kind") == "tuner":
        # a self-tuning data-plane event (leader demotion,
        # audit trip) — same pipe, same timelines
        return (f"{_fmt_wall(ev.get('wall'))}  tuner "
                f"{ev.get('event')}"
                + (f" rank {ev['rank']}"
                   if ev.get("rank") is not None else "")
                + f": {ev.get('msg', '')}")
    if ev.get("kind") == "onset":
        return (f"{_fmt_wall(ev.get('wall'))}  rank {ev.get('rank')} "
                f"ONSET ({ev.get('detector')}): {ev.get('msg', '')}")
    return (f"{_fmt_wall(ev.get('wall'))}  rank {ev.get('rank')} "
            f"{ev.get('from')} -> {ev.get('to')} "
            f"({ev.get('detector')}"
            + (f", collective #{ev['seq']}" if ev.get("seq") else "")
            + f"): {ev.get('msg', '')}")


def format_status(health: dict) -> str:
    """Current verdicts from a live master's health document (the
    ``mp4j-scope health URL`` view)."""
    if not health:
        return "(no health plane — master runs MP4J_HEALTH=0?)"
    lines = [f"mp4j health — {len(health.get('ranks', {}))} rank(s), "
             f"{health.get('alerts_total', 0)} alert(s), "
             f"window {health.get('window')} ordinal(s)"]
    ranks = health.get("ranks") or {}
    if ranks:
        lines.append(f"  {'rank':>4}  {'state':<18}  {'since':<23}  "
                     "evidence")
        for r in sorted(ranks, key=int):
            e = ranks[r]
            evidence = ", ".join(
                f"{d}={p}" for d, p in (e.get("pressure") or {}).items()) \
                or e.get("why") or "-"
            lines.append(f"  {r:>4}  {e.get('state', '?'):<18}  "
                         f"{_fmt_wall(e.get('since_wall')):<23}  "
                         f"{evidence}")
    evict = health.get("evict_recommended") or []
    if evict:
        lines.append(f"EVICT RECOMMENDED: rank(s) "
                     f"{', '.join(map(str, evict))} — the autoscaler "
                     "hook (health_status()) carries the evidence")
    dom = health.get("dominator") or {}
    if dom.get("shares"):
        share_s = ", ".join(f"rank {r}: {s * 100:.0f}%"
                            for r, s in dom["shares"].items())
        lines.append(f"dominator window: {share_s} "
                     f"({dom.get('attributed', 0)} ordinal(s) "
                     f"attributed, {dom.get('onsets', 0)} onset(s))")
    fd = health.get("first_degraded")
    if fd:
        lines.append(
            f"first degradation: rank {fd.get('rank')} -> "
            f"{fd.get('to')} via {fd.get('detector')} at "
            f"{_fmt_wall(fd.get('wall'))} (collective "
            f"#{fd.get('seq')})")
    for ev in health.get("last_alerts") or []:
        lines.append("  " + format_alert(ev))
    return "\n".join(lines)


def format_history(alerts: list[dict], ranks: list[int] | None = None
                   ) -> str:
    """Verdict history from durable-sink ``alerts`` records (the
    ``mp4j-scope health DIR`` view): the full transition timeline,
    the first-degradation headline, and each rank's final verdict."""
    if not alerts:
        return ("(no health alerts in the sink — the job stayed "
                "HEALTHY, or ran MP4J_HEALTH=0)")
    alerts = sorted(alerts, key=lambda e: (e.get("wall") or 0,
                                           e.get("id") or 0))
    lines = [f"health timeline — {len(alerts)} alert(s)"]
    first = next((e for e in alerts
                  if e.get("kind") == "state"
                  and e.get("from") == "HEALTHY"), None)
    if first is not None:
        lines.append(
            f"first degradation: rank {first.get('rank')} -> "
            f"{first.get('to')} via {first.get('detector')} at "
            f"{_fmt_wall(first.get('wall'))}"
            + (f" (collective #{first['seq']})"
               if first.get("seq") else ""))
    for ev in alerts:
        lines.append("  " + format_alert(ev))
    final: dict[int, str] = {}
    for ev in alerts:
        if ev.get("kind") == "state":
            final[int(ev["rank"])] = ev.get("to", "?")
    for r in ranks or []:
        final.setdefault(int(r), "HEALTHY")
    if final:
        lines.append("final verdicts: " + ", ".join(
            f"rank {r}: {s}" for r, s in sorted(final.items())))
    return "\n".join(lines)
