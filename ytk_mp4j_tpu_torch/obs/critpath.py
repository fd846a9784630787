"""Cross-rank critical-path attribution over durable sink segments.

A copy of ``ytk_mp4j_tpu/obs/critpath.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

The skew tables say *which* rank lags; this module says
*why* and *since when*. Input is the per-rank record stream the
durable sink (:mod:`ytk_mp4j_tpu_torch.obs.sink`) wrote — collective and
phase spans with WALL timestamps, plus audit/recovery records — and
the output is, for every collective ordinal the job ran:

- a reconstructed **cross-rank timeline** (per-rank start/end, phase
  busy decomposition: wire / reduce / serialize / other-wait);
- the **critical-path dominator**: the (rank, cause) that gated the
  ordinal's completion, where cause is either ``late-arrival`` (the
  rank entered the collective far behind the others — upstream
  compute skew), a dominant local phase (``wire``/``reduce``/
  ``serialize``), or a **peer link** (``link->K over tcp|shm``) when
  the blame votes of the OTHER ranks' wire waits point at one rank;
- aggregation into a **dominator table** (per rank: ordinals gated,
  share, cumulative gated seconds, dominant cause) and **straggler
  onset** detection: sliding windows over the ordinal axis flag the
  first window where one rank's dominance share crosses the
  threshold, with the onset ordinal and wall timestamp — "rank 3
  started gating everything at 14:02:31", not just "rank 3 is slow".

Dominator rule (per ordinal, given per-rank collective spans and
phase spans):

1. every rank *votes*: its wire seconds per peer are blame on that
   peer (time spent on the link INCLUDES waiting for the peer's
   bytes), and its own reduce/serialize busy is self-blame;
2. a rank's **score** is its own busy plus the blame it received
   from everyone else's wire votes — an injected-slow rank wins both
   terms (its own slowed I/O books wire on every link it touches, and
   every peer's wait books blame on it);
3. unless the **late-arrival** signal dominates first: when the
   latest-entering rank's start lags the median start by more than
   half the median duration (and by an absolute floor), upstream
   skew, not in-collective behavior, gated the ordinal.

Everything here is a pure function of the loaded records —
``mp4j-scope analyze`` renders the report offline, ``mp4j-scope
tail`` follows a live directory. Imports nothing from ``comm``.
"""

from __future__ import annotations

import time

_PHASES = ("wire", "reduce", "serialize")
# late-arrival detection: start skew must exceed BOTH a fraction of
# the median span duration and an absolute floor (scheduler jitter on
# microsecond collectives must not read as a straggler)
_LATE_FRAC = 0.5
_LATE_FLOOR = 1e-4
# straggler-onset windows over the ordinal axis
ONSET_WINDOW = 32
ONSET_SHARE = 0.5


def collect(job: dict[int, dict]) -> dict:
    """Fold ``sink.load_job`` output into per-ordinal per-rank state:
    ``{"ordinals": {seq: {rank: {family, t0, dur, phases: {phase:
    secs}, links: {peer: {"secs", "transport"}}}}}, "ranks": [...],
    "audit": [...], "recovery": {rank: [...]}, "alerts": [...],
    "torn": {rank: n}, "meta": {rank: {...}}}``."""
    ordinals: dict[int, dict[int, dict]] = {}
    audit_recs: list[dict] = []
    recovery: dict[int, list] = {}
    alerts: list[dict] = []
    seen_alerts: set = set()
    torn: dict[int, int] = {}
    meta: dict[int, dict] = {}

    def cell(rank: int, seq: int) -> dict:
        return ordinals.setdefault(seq, {}).setdefault(rank, {
            "family": None, "t0": None, "dur": 0.0,
            "phases": dict.fromkeys(_PHASES, 0.0), "links": {}})

    for rank, doc in job.items():
        torn[rank] = int(doc.get("torn", 0))
        for rec in doc.get("records", ()):
            kind = rec.get("t")
            if kind == "meta" and rank not in meta:
                meta[rank] = rec
            elif kind == "spans":
                for s in rec.get("spans", ()):
                    _fold_span(cell, rank, s)
            elif kind == "audit":
                for a in rec.get("records", ()):
                    a = dict(a)
                    a["rank"] = rank
                    audit_recs.append(a)
            elif kind == "recovery":
                recovery.setdefault(rank, []).extend(
                    rec.get("events", ()))
            elif kind == "alerts":
                # health-plane verdict events: dedup by the
                # master's monotone alert id — an alert orphaned onto
                # a fallback rank must not double in the timeline
                for ev in rec.get("alerts", ()):
                    key = ev.get("id")
                    if key is not None and key in seen_alerts:
                        continue
                    seen_alerts.add(key)
                    alerts.append(ev)
    alerts.sort(key=lambda e: (e.get("wall") or 0, e.get("id") or 0))
    return {"ordinals": ordinals, "ranks": sorted(job),
            "audit": audit_recs, "recovery": recovery,
            "alerts": alerts, "torn": torn, "meta": meta}


def _fold_span(cell, rank: int, s: list) -> None:
    try:
        name, cat, t0, dur, pid, _tid, args = s
    except (TypeError, ValueError):
        return
    args = args or {}
    if cat == "collective":
        seq = int(args.get("seq") or 0)
        if not seq:
            return
        c = cell(rank, seq)
        c["family"] = name
        c["t0"] = float(t0)
        c["dur"] = float(dur)
    elif cat == "phase" and name in _PHASES:
        seq = int(args.get("seq") or 0)
        if not seq:
            return
        c = cell(rank, seq)
        c["phases"][name] += float(dur)
        if name == "wire":
            peer = args.get("peer")
            if peer is not None:
                link = c["links"].setdefault(int(peer), {
                    "secs": 0.0, "transport": None, "bytes": 0})
                link["secs"] += float(dur)
                if args.get("transport"):
                    link["transport"] = args["transport"]
                link["bytes"] += int(args.get("bytes_sent") or 0) \
                    + int(args.get("bytes_recv") or 0)


def attribute(ordinals: dict[int, dict[int, dict]]) -> list[dict]:
    """Per-ordinal critical-path attribution (module docstring rule);
    only ordinals at least two ranks reported with collective spans
    are attributable. Returns rows sorted by ordinal::

        {"seq", "family", "start", "end", "dur", "dominator",
         "cause", "transport", "score", "margin",
         "waits": {rank: {"wire","reduce","serialize","other"}}}
    """
    rows: list[dict] = []
    for seq in sorted(ordinals):
        cells = {r: c for r, c in ordinals[seq].items()
                 if c["t0"] is not None}
        if len(cells) < 2:
            continue
        starts = {r: c["t0"] for r, c in cells.items()}
        ends = {r: c["t0"] + c["dur"] for r, c in cells.items()}
        durs = sorted(c["dur"] for c in cells.values())
        med_dur = durs[len(durs) // 2]
        # LOWER median start: the upper median would zero the skew
        # whenever half the ranks (or the peer, at n=2) are late
        # together — a 2-rank job's 10 s straggler must still read as
        # late-arrival, not as wire blame on its waiting peer
        med_start = sorted(starts.values())[(len(starts) - 1) // 2]
        late_rank = max(starts, key=lambda r: (starts[r], -r))
        late_by = starts[late_rank] - med_start
        fam = next((c["family"] for c in cells.values()
                    if c["family"]), "?")

        waits = {}
        for r, c in cells.items():
            busy = sum(c["phases"].values())
            waits[r] = {**{p: c["phases"][p] for p in _PHASES},
                        "other": max(0.0, c["dur"] - busy)}

        if late_by > max(_LATE_FRAC * med_dur, _LATE_FLOOR):
            dom, cause, transport = late_rank, "late-arrival", None
            score = late_by
        else:
            # blame votes: time rank r spent on its link with peer p
            # is blame on p (the link books waiting for p's bytes);
            # own reduce/serialize busy is self-blame
            blame = dict.fromkeys(cells, 0.0)
            via: dict[int, dict] = {r: {} for r in cells}
            for r, c in cells.items():
                blame[r] += (c["phases"]["reduce"]
                             + c["phases"]["serialize"])
                for peer, link in c["links"].items():
                    if peer in blame and peer != r:
                        blame[peer] += link["secs"]
                        via[peer][r] = link
            # a rank's own wire busy also scores on itself (an
            # injected-slow rank's sleeps book there)
            score_of = {r: blame[r] + cells[r]["phases"]["wire"]
                        for r in cells}
            dom = max(score_of, key=lambda r: (score_of[r], -r))
            score = score_of[dom]
            received = blame[dom] - (cells[dom]["phases"]["reduce"]
                                     + cells[dom]["phases"]["serialize"])
            own = waits[dom]
            own_max = max(_PHASES, key=lambda p: own[p])
            if received > 0 and received >= own[own_max] * 0.5:
                voters = via[dom]
                transport = next(
                    (lk["transport"] for lk in voters.values()
                     if lk.get("transport")), None)
                cause = f"link->{dom}"
                if transport:
                    cause += f" over {transport}"
            else:
                cause, transport = own_max, None
        others = [e for r, e in ends.items() if r != dom]
        rows.append({
            "seq": seq, "family": fam,
            "start": min(starts.values()), "end": max(ends.values()),
            "dur": max(ends.values()) - min(starts.values()),
            "dominator": dom, "cause": cause, "transport": transport,
            "score": score,
            "margin": max(0.0, ends[dom] - max(others))
            if others else 0.0,
            "waits": waits,
        })
    return rows


def dominator_table(rows: list[dict]) -> dict[int, dict]:
    """Aggregate attribution rows per rank: ordinals gated, share of
    all attributed ordinals, cumulative gated seconds (sum of the
    rank's dominated ordinal durations), and the most common cause."""
    out: dict[int, dict] = {}
    n = len(rows)
    for row in rows:
        e = out.setdefault(row["dominator"], {
            "ordinals": 0, "share": 0.0, "gated_secs": 0.0,
            "causes": {}})
        e["ordinals"] += 1
        e["gated_secs"] += row["dur"]
        e["causes"][row["cause"]] = e["causes"].get(row["cause"], 0) + 1
    for e in out.values():
        e["share"] = e["ordinals"] / n if n else 0.0
        e["top_cause"] = max(e["causes"], key=e["causes"].get)
    return out


def onset_trend(rows: list[dict], window: int = ONSET_WINDOW,
                share: float = ONSET_SHARE) -> list[dict]:
    """Straggler-onset detection: slide a ``window``-ordinal window
    over the attribution rows; whenever a rank FIRST reaches a
    dominance share >= ``share`` inside a window, emit an onset event
    with the window's first ordinal and its wall timestamp. A rank
    that later drops below half the threshold and crosses again emits
    a fresh onset (intermittent stragglers show every episode)."""
    events: list[dict] = []
    active: dict[int, bool] = {}
    step = max(1, window // 2)
    starts = list(range(0, max(len(rows) - window + 1, 1), step))
    # always scan a final window ending at the last row: a straggler
    # whose onset falls in the job's trailing < window ordinals (the
    # degradation right before a crash — exactly the signal this
    # exists for) must not fall between window starts
    tail_start = max(0, len(rows) - window)
    if rows and starts[-1] != tail_start:
        starts.append(tail_start)
    for i in starts:
        win = rows[i:i + window]
        if not win:
            break
        counts: dict[int, int] = {}
        for row in win:
            counts[row["dominator"]] = counts.get(row["dominator"],
                                                  0) + 1
        for rank, c in counts.items():
            frac = c / len(win)
            if frac >= share and not active.get(rank):
                active[rank] = True
                first = win[0]
                events.append({
                    "rank": rank, "share": frac,
                    "onset_seq": first["seq"],
                    "onset_wall": first["start"],
                    "cause": max((r["cause"] for r in win
                                  if r["dominator"] == rank),
                                 key=[r["cause"] for r in win
                                      if r["dominator"] == rank].count),
                })
        for rank in list(active):
            if counts.get(rank, 0) / len(win) < share / 2:
                active[rank] = False
    return events


def analyze(job: dict[int, dict]) -> dict:
    """The full structured analysis of one sink directory's load:
    timeline rows, dominator table, onset events, per-rank phase
    totals, audit/recovery/torn summaries."""
    state = collect(job)
    rows = attribute(state["ordinals"])
    table = dominator_table(rows)
    phase_totals: dict[int, dict] = {}
    for row in rows:
        for r, w in row["waits"].items():
            acc = phase_totals.setdefault(r, dict.fromkeys(
                (*_PHASES, "other"), 0.0))
            for k, v in w.items():
                acc[k] += v
    divergences = [a for a in state["audit"] if a.get("err")]
    # the self-tuning data plane's durable decision history:
    # every applied/decided/tripped event the slaves noted into their
    # recovery logs, pulled out for `mp4j-scope tuner` — next to the
    # fenced leader updates and trip alerts that ride the alert pipe
    tuner_events: list[dict] = []
    for rank, events in state["recovery"].items():
        for ev in events:
            try:
                ts, kind, detail = ev
            except (TypeError, ValueError):
                continue
            if kind == "tuner":
                tuner_events.append({"rank": rank, "ts": ts,
                                     "msg": detail})
    tuner_events.sort(key=lambda e: (e["ts"], e["rank"]))
    return {
        "ranks": state["ranks"],
        "ordinals_attributed": len(rows),
        "rows": rows,
        "dominators": table,
        "onsets": onset_trend(rows),
        "phase_totals": phase_totals,
        "torn": state["torn"],
        "recovery": state["recovery"],
        "health_alerts": state["alerts"],
        "tuner_events": tuner_events,
        "audit_records": len(state["audit"]),
        "audit_errors": divergences,
        "meta": state["meta"],
    }


def fmt_wall(ts) -> str:
    """THE wall-timestamp formatter every obs report shares (analyze
    rows, health timelines, postmortem sections) — one place for the
    format, not three drifting copies."""
    if not isinstance(ts, (int, float)):
        return "?"
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(ts)) \
        + f".{int(ts % 1 * 1000):03d}"


_fmt_wall = fmt_wall


def format_report(analysis: dict, root: str = "",
                  last_rows: int = 8) -> str:
    """The ``mp4j-scope analyze`` report: header, dominator table,
    per-phase wait decomposition, onset trend, recovery/torn notes,
    and the tail of the per-ordinal timeline."""
    a = analysis
    lines = [f"critical-path report{': ' + root if root else ''} — "
             f"{len(a['ranks'])} rank(s), "
             f"{a['ordinals_attributed']} attributed collective(s)"]
    torn = {r: n for r, n in a["torn"].items() if n}
    if torn:
        lines.append("torn tails: " + ", ".join(
            f"rank {r}: {n}" for r, n in sorted(torn.items()))
            + " (segment cut mid-record — all prior records recovered)")
    if not a["rows"]:
        lines.append("(no attributable collectives — need collective "
                     "spans from >= 2 ranks; is the sink enabled and "
                     "MP4J_SPAN_RING > 0?)")
        lines.extend(_health_lines(a))
        return "\n".join(lines)

    lines.append("")
    lines.append("critical-path dominators:")
    lines.append(f"  {'rank':>4}  {'ordinals':>8}  {'share':>6}  "
                 f"{'gated s':>8}  top cause")
    for r in sorted(a["dominators"],
                    key=lambda r: -a["dominators"][r]["ordinals"]):
        e = a["dominators"][r]
        lines.append(f"  {r:>4}  {e['ordinals']:>8}  "
                     f"{e['share'] * 100:>5.1f}%  "
                     f"{e['gated_secs']:>8.3f}  {e['top_cause']}")

    lines.append("")
    lines.append("per-phase wait decomposition (busy seconds, "
                 "attributed ordinals):")
    lines.append(f"  {'rank':>4}  {'wire':>8}  {'reduce':>8}  "
                 f"{'serialize':>9}  {'other/wait':>10}")
    for r in sorted(a["phase_totals"]):
        p = a["phase_totals"][r]
        lines.append(f"  {r:>4}  {p['wire']:>8.3f}  "
                     f"{p['reduce']:>8.3f}  {p['serialize']:>9.3f}  "
                     f"{p['other']:>10.3f}")

    if a["onsets"]:
        lines.append("")
        lines.append("straggler onset:")
        for ev in a["onsets"]:
            lines.append(
                f"  rank {ev['rank']} began dominating the critical "
                f"path at collective #{ev['onset_seq']} "
                f"({_fmt_wall(ev['onset_wall'])}), "
                f"{ev['share'] * 100:.0f}% of the window, "
                f"cause {ev['cause']}")
    lines.extend(_health_lines(a))
    for rank, events in sorted(a["recovery"].items()):
        if events:
            tail = "; ".join(f"{kind}({detail})" if detail else kind
                             for _, kind, detail in events[-4:])
            lines.append(f"rank {rank} recovery events (last "
                         f"{min(len(events), 4)}): {tail}")
    if a["audit_errors"]:
        lines.append(f"audit: {len(a['audit_errors'])} errored "
                     "collective record(s) in the stream")

    lines.append("")
    lines.append(f"last {min(last_rows, len(a['rows']))} collectives:")
    for row in a["rows"][-last_rows:]:
        cause = row["cause"]
        lines.append(
            f"  #{row['seq']:<5} {row['family']:<22} "
            f"{row['dur'] * 1e3:>8.2f} ms  gated by rank "
            f"{row['dominator']} ({cause})")
    return "\n".join(lines)


def _health_lines(a: dict) -> list[str]:
    """The health plane's durable verdict history: what
    degraded first, when, and which detector saw it. Local import —
    :mod:`health` imports this module for the online attribution."""
    if not a.get("health_alerts"):
        return []
    from ytk_mp4j_tpu_torch.obs import health as health_mod
    return ["", *health_mod.format_history(
        a["health_alerts"], a["ranks"]).splitlines()]


def format_row(row: dict) -> str:
    """One timeline line (the ``mp4j-scope tail`` increment)."""
    return (f"#{row['seq']:<5} {row['family']:<22} "
            f"{_fmt_wall(row['start'])}  {row['dur'] * 1e3:>8.2f} ms  "
            f"gated by rank {row['dominator']} ({row['cause']})")
