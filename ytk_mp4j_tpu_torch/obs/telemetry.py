"""Cluster telemetry: heartbeat schema, cross-rank skew, hang diagnosis.

A copy of ``ytk_mp4j_tpu/obs/telemetry.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

Pure functions over per-rank telemetry records — the stateful consumers
are the master (``comm/master.py``, live heartbeat table) and the
``mp4j-scope`` CLI (post-hoc per-rank ``comm.stats()`` dumps); both
share this implementation. Deliberately imports nothing from ``comm``.

Heartbeat schema (one ``TELEMETRY`` message, slave -> master)::

    {"progress": {"seq": int,          # collectives ENTERED so far
                  "current": str|None, # collective in flight, if any
                  "last": str|None,    # last collective completed
                  "phase": str|None,   # last phase booked (wire/...)
                  "current_secs": float},  # time inside `current`
     "stats": {collective: {calls, bytes_sent, bytes_recv, chunks,
                            wire_seconds, reduce_seconds,
                            serialize_seconds}}}

``seq`` is the per-slave monotonically increasing collective sequence
number (bumped by ``CommStats.begin`` on every outermost collective
call), the quantity hang diagnosis compares across ranks: in a correct
SPMD schedule every rank runs the same collective sequence, so a rank
whose ``seq`` trails the cluster maximum is the rank everyone else is
waiting for.
"""

from __future__ import annotations

import statistics
import time

from ytk_mp4j_tpu_torch.obs.health import SHORT_BY_NAME as _STATE_SHORT

_PHASES = ("wire_seconds", "reduce_seconds", "serialize_seconds")


def busy_seconds(entry: dict[str, float]) -> float:
    """A rank's total busy time for one collective family (phase times
    are busy, possibly overlapping, times — see utils.stats)."""
    return float(sum(entry.get(p, 0.0) for p in _PHASES))


def cluster_skew(per_rank: dict[int, dict[str, dict[str, float]]]
                 ) -> dict[str, dict]:
    """Cross-rank skew per collective family.

    ``per_rank`` maps rank -> ``comm.stats()`` snapshot. Returns, per
    collective name seen on any rank::

        {"ranks": int,                 # ranks reporting this family
         "calls": int,                 # max calls any rank made
         "bytes": int,                 # total wire bytes, all ranks
         "busy_min"/"busy_median"/"busy_max": float,
         "stragglers": [rank, ...]}    # ranks at busy_max (ties kept)

    A straggler here is the rank spending the most busy time in the
    family — on a balanced workload that is noise, on a skewed one it
    names who the other ranks waited for.
    """
    names: set[str] = set()
    for snap in per_rank.values():
        names.update(snap)
    out: dict[str, dict] = {}
    for name in names:
        rows = {r: snap[name] for r, snap in per_rank.items()
                if name in snap}
        busys = {r: busy_seconds(e) for r, e in rows.items()}
        bmax = max(busys.values())
        out[name] = {
            "ranks": len(rows),
            "calls": int(max(e.get("calls", 0) for e in rows.values())),
            "bytes": int(sum(e.get("bytes_sent", 0)
                             + e.get("bytes_recv", 0)
                             for e in rows.values())),
            "busy_min": min(busys.values()),
            "busy_median": statistics.median(busys.values()),
            "busy_max": bmax,
            "stragglers": sorted(r for r, b in busys.items()
                                 if b >= bmax and bmax > 0),
        }
    return out


def format_skew(skew: dict[str, dict]) -> str:
    """Human-readable skew table (the ``mp4j-scope report`` view)."""
    if not skew:
        return "(no telemetry)"
    w = max(len(n) for n in skew)
    lines = [f"{'collective':<{w}}  ranks  calls      MB  "
             f"busy min/med/max (s)  stragglers"]
    for name in sorted(skew):
        s = skew[name]
        lines.append(
            f"{name:<{w}}  {s['ranks']:>5d}  {s['calls']:>5d}  "
            f"{s['bytes'] / 1e6:>6.2f}  "
            f"{s['busy_min']:>6.3f}/{s['busy_median']:>6.3f}/"
            f"{s['busy_max']:>6.3f}  "
            f"{','.join(map(str, s['stragglers'])) or '-'}")
    return "\n".join(lines)


def format_live(doc: dict) -> str:
    """The ``mp4j-scope live`` frame: one view of a master metrics
    document (``Master.metrics_doc`` / the ``/metrics.json``
    endpoint) — cluster rates, then one row per rank with throughput,
    current collective, sequence lag, retry count, health verdict and
    heartbeat age. Stragglers (the busy-max ranks of any collective
    family, same rule as :func:`cluster_skew`) are marked ``*``; ranks
    behind the max sequence number show their lag. The whole table
    stays within 120 columns. A rank whose heartbeat is older than 2x
    the heartbeat period renders ``stale`` in its derived rate column
    — the master's rate window freezes at the last fold, and a wedged
    rank must not display a healthy-looking throughput."""
    ranks = doc.get("ranks", {})
    cl = doc.get("cluster", {})
    rates = cl.get("rates", {})
    head = (f"mp4j live — {len(ranks)}/{doc.get('slave_num', '?')} "
            f"ranks reporting | "
            f"{rates.get('bytes_per_sec', 0.0) / 1e9:.3f} GB/s | "
            f"{rates.get('collectives_per_sec', 0.0):.1f} coll/s | "
            f"{rates.get('keys_per_sec', 0.0):.0f} keys/s "
            f"(window {doc.get('window_secs', 0):.0f}s)")
    audit = cl.get("audit") or {}
    if audit.get("rank_seq") or audit.get("divergences"):
        # the audit plane only reports under MP4J_AUDIT=verify|capture;
        # a nonzero divergence count is the headline of the whole view
        head += (f"\naudit: verified through collective "
                 f"#{audit.get('verified_seq', 0)}, "
                 f"{audit.get('divergences', 0)} divergence(s)")
        if audit.get("divergences"):
            last = (audit.get("last_divergences") or [{}])[-1]
            head += f"\n  last: {last.get('msg', '?')}"
    # elastic membership: the spares line + event headline;
    # absent entirely for non-elastic jobs with no spares registered
    ms = cl.get("membership") or {}
    badges = {str(r): b for r, b in (ms.get("badges") or {}).items()}
    if (ms.get("mode", "off") != "off" or ms.get("spares_total")
            or ms.get("replacements") or ms.get("shrinks")):
        head += (f"\nmembership: mode={ms.get('mode', 'off')} | "
                 f"spares {ms.get('spares_available', 0)}/"
                 f"{ms.get('spares_total', 0)} available | "
                 f"{ms.get('replacements', 0)} replacement(s), "
                 f"{ms.get('shrinks', 0)} shrink(s)")
        events = ms.get("events") or []
        if events:
            ev = events[-1]
            if ev.get("kind") == "replace":
                head += (f"\n  last: rank {ev.get('rank')} REPLACED "
                         f"from spare #{ev.get('spare')} @ epoch "
                         f"{ev.get('epoch')}")
            else:
                head += (f"\n  last: SHRUNK, dropped {ev.get('dead')} "
                         f"@ epoch {ev.get('epoch')}")
    # health head-line: only when the plane has something
    # to say — any alert ever, or any rank off HEALTHY right now
    hl = cl.get("health") or {}
    hl_states = {r: e.get("state", "HEALTHY")
                 for r, e in (hl.get("ranks") or {}).items()}
    if hl.get("alerts_total") or any(s != "HEALTHY"
                                     for s in hl_states.values()):
        bad = ", ".join(f"rank {r} {s}" for r, s in
                        sorted(hl_states.items(), key=lambda kv:
                               int(kv[0])) if s != "HEALTHY")
        head += (f"\nhealth: {hl.get('alerts_total', 0)} alert(s)"
                 + (f" | {bad}" if bad else " | all HEALTHY again"))
        evict = hl.get("evict_recommended") or []
        if evict:
            head += (" | EVICT recommended: "
                     + ",".join(map(str, evict)))
        last = hl.get("last_alerts") or []
        if last:
            ev = last[-1]
            head += (f"\n  last: rank {ev.get('rank')} "
                     f"{ev.get('from')}->{ev.get('to')} "
                     f"({ev.get('detector')}) "
                     f"{str(ev.get('msg', ''))[:60]}")
    # serve head-line: the inference plane's QPS / tail
    # latency / cache hit-rate / degraded tally; absent entirely for
    # training jobs (no serve/* counters anywhere in the registry)
    sv = cl.get("serve") or {}
    if sv.get("active"):
        hr = sv.get("hit_rate")
        head += (f"\nserve: {sv.get('qps', 0.0):.1f} QPS | "
                 f"p50 {sv.get('p50_ms', 0.0):.2f}ms "
                 f"p99 {sv.get('p99_ms', 0.0):.2f}ms | "
                 f"{sv.get('requests', 0)} req in "
                 f"{sv.get('batches', 0)} batch(es) | cache "
                 + (f"{100.0 * hr:.0f}% hit" if hr is not None
                    else "off")
                 + (f" | {sv['degraded_batches']} DEGRADED"
                    if sv.get("degraded_batches") else ""))
    # autoscaler head-line: mode, trip state, action tally;
    # absent entirely when MP4J_AUTOSCALE=off (no controller exists)
    asc = cl.get("autoscale") or {}
    if asc:
        acted = sum((asc.get("actions") or {}).values())
        would = sum((asc.get("observed") or {}).values())
        head += (f"\nautoscale: mode={asc.get('mode')}"
                 + (" TRIPPED" if asc.get("tripped") else "")
                 + f" | {acted} action(s)"
                 + (f", {would} observed" if would else "")
                 + f" | budget {asc.get('budget', {}).get('used', 0)}"
                 f"/{asc.get('budget', {}).get('limit', 0)}")
        events = asc.get("events") or []
        if events:
            ev = events[-1]
            head += (f"\n  last: {ev.get('event')} "
                     f"{ev.get('action')} "
                     f"{str(ev.get('msg', ''))[:60]}")
    if not ranks:
        return head + "\n(no rank telemetry yet)"
    skew = cluster_skew({int(r): info.get("stats", {})
                         for r, info in ranks.items()
                         if info.get("stats")})
    stragglers = {r for s in skew.values() for r in s["stragglers"]}
    max_seq = max(info.get("progress", {}).get("seq", 0)
                  for info in ranks.values())
    hb_secs = float(doc.get("hb_secs") or 0.0)
    lines = [head,
             f"{'rank':>4} {'seq':>5} {'lag':>3} {'ep':>2}  "
             f"{'state':<32} {'MB/s':>8} {'shm%':>4} {'ovl%':>4} "
             f"{'aud':>5} {'sink':>6} {'rtry':>4} {'health':>6}  "
             f"{'roster':<8}  hb age"]
    for r in sorted(ranks, key=int):
        info = ranks[r]
        prog = info.get("progress", {})
        seq = prog.get("seq", 0)
        lag = max_seq - seq
        age = float(info.get("age", 0.0))
        if prog.get("current"):
            state = (f"in {prog['current']} "
                     f"({prog.get('current_secs', 0.0):.1f}s"
                     + (f", {prog['phase']}" if prog.get("phase")
                        else "") + ")")
        elif prog.get("last"):
            state = f"idle after {prog['last']}"
        else:
            state = "idle"
        retries = sum(int(e.get("retries", 0))
                      for e in info.get("stats", {}).values())
        # which plane the bytes rode: shm share of the
        # transport-tagged wire bytes; "-" before any tagged byte moved
        shm_b = sum(e.get("wire_bytes_shm", 0)
                    for e in info.get("stats", {}).values())
        tagged = shm_b + sum(e.get("wire_bytes_tcp", 0)
                             for e in info.get("stats", {}).values())
        shm_pct = f"{100.0 * shm_b / tagged:.0f}" if tagged else "-"
        # overlap column: of the wall time this rank had
        # nonblocking collectives in flight, the fraction where >= 2
        # overlapped — the scheduler's ovl% headline; "-" until the
        # rank submits any i* work
        asy = info.get("stats", {}).get("<async>", {})
        inflight = asy.get("async_inflight", 0.0)
        ovl_pct = (f"{100.0 * asy.get('async_overlap', 0.0) / inflight:.0f}"
                   if inflight else "-")
        # audit column: the rank's last audited collective
        # ordinal; "-" until the rank ships audit records
        aud = info.get("audit_seq", 0)
        # sink column: MB the rank's durable sink has made
        # safe, with a ! marker when it is dropping records; "-" only
        # when the sink is truly disarmed (no bytes AND no drops — a
        # full disk writes nothing but drops plenty, and rendering
        # that as disarmed would hide exactly the failure the marker
        # exists for)
        sink_b = info.get("counters", {}).get("sink/bytes", 0)
        sink_drop = info.get("counters", {}).get(
            "sink/dropped_records", 0)
        sink_col = (f"{sink_b / 1e6:.1f}M" + ("!" if sink_drop else "")
                    if sink_b or sink_drop else "-")
        mark = "*" if int(r) in stragglers else " "
        # epoch + roster badge: which recovery epoch the
        # rank runs at, and whether its id was REPLACED from a spare
        # or SHRUNK into a new number this job
        epoch = prog.get("epoch") or 0
        badge = badges.get(str(r), "-")
        # health column: the rank's current verdict, "-"
        # when the master runs without the health plane
        health_col = _STATE_SHORT.get(hl_states.get(str(r)), "-")
        # stale-heartbeat annotation: the rate
        # column is DERIVED from the rank's last fold — render the
        # fact that it is history, not throughput, once the beat is
        # 2x the heartbeat period late
        stale = hb_secs > 0 and age > 2.0 * hb_secs
        mbs = ("stale" if stale else
               f"{info.get('rates', {}).get('bytes_per_sec', 0.0) / 1e6:.2f}")
        lines.append(
            f"{mark}{r:>3} {seq:>5} {lag if lag else '-':>3} "
            f"{epoch if epoch else '-':>2}  "
            f"{state:<32.32} "
            f"{mbs:>8} "
            f"{shm_pct:>4} "
            f"{ovl_pct:>4} "
            f"{aud if aud else '-':>5} "
            f"{sink_col:>6} "
            f"{retries:>4} "
            f"{health_col:>6}  "
            f"{badge:<8.8}  {age:.1f}s")
    return "\n".join(lines)


def _health_tally(ladder: dict[str, int]) -> str:
    """Compress a health-ladder tally (``{"HEALTHY": 3, "DEGRADED":
    1}``) into the fleet table's cell: ``3H1D``; ``-`` when the job
    reports no health plane."""
    if not ladder:
        return "-"
    order = {"HEALTHY": 0, "SUSPECT": 1, "DEGRADED": 2, "CRITICAL": 3}
    parts = []
    for name in sorted(ladder, key=lambda n: order.get(n, 9)):
        parts.append(f"{ladder[name]}{_STATE_SHORT.get(name, name[:1])}")
    return "".join(parts)


def _fleet_state_cell(state: str, age: float) -> str:
    """``LIVE`` / ``STALE(4.2s)`` / ``GONE(44s)`` — a non-LIVE row
    always says how old its facts are."""
    if state == "LIVE":
        return "LIVE"
    return f"{state}({age:.0f}s)" if age >= 9.5 else \
        f"{state}({age:.1f}s)"


def format_fleet(model: dict) -> str:
    """The ``mp4j-scope fleet`` frame: one view of a fleet model
    (:func:`ytk_mp4j_tpu_torch.obs.fleet.fold_fleet`) — the aggregate
    head-line, one row per job (identity, staleness state, ranks,
    rates, retries, health-ladder tally, roster generation), then one
    block per SHARED host fingerprint with each co-resident job's
    ranks / wire bytes / live rate / slow-link verdicts, and a
    ``CONTENTION`` line per flagged host. Pure over the model dict."""
    agg = model.get("aggregate") or {}
    jobs = model.get("jobs") or {}
    head = (f"mp4j fleet — {agg.get('live', 0)}/{agg.get('jobs', 0)} "
            f"job(s) LIVE | {agg.get('ranks', 0)} ranks | "
            f"{agg.get('bytes_per_sec', 0.0) / 1e9:.3f} GB/s | "
            f"{agg.get('collectives_per_sec', 0.0):.1f} coll/s")
    lines = [head,
             f"{'job':<10} {'state':<12} {'ranks':>6} {'MB/s':>8} "
             f"{'coll/s':>7} {'QPS':>7} {'rtry':>4} {'health':>7} "
             f"{'gen':>3}  url"]
    for key in sorted(jobs):
        st = jobs[key]
        s = st.get("summary")
        cell = _fleet_state_cell(st.get("state") or "?",
                                 float(st.get("age", 0.0)))
        if s is None:
            lines.append(f"{'-':<10} {cell:<12} {'-':>6} {'-':>8} "
                         f"{'-':>7} {'-':>7} {'-':>4} {'-':>7} "
                         f"{'-':>3}  {st.get('url', key)} "
                         f"(never scraped)")
            continue
        ranks_cell = f"{s['ranks_reporting']}/{s['slave_num']}"
        # serve jobs read distinctly from batch jobs: the
        # QPS cell is a number only when the job runs the inference
        # plane; "-" for pure training jobs
        sv = s.get("serve")
        qps_cell = f"{sv['qps']:.1f}" if sv else "-"
        lines.append(
            f"{(s['job_id'] or '-'):<10.10} {cell:<12} "
            f"{ranks_cell:>6} "
            f"{s['bytes_per_sec'] / 1e6:>8.2f} "
            f"{s['collectives_per_sec']:>7.1f} "
            f"{qps_cell:>7} "
            f"{s['retries']:>4d} "
            f"{_health_tally(s['health']['states']):>7} "
            f"{s['roster_gen']:>3d}  {st.get('url', key)}")
    hosts = model.get("hosts") or {}
    for fp in model.get("shared_hosts") or []:
        lines.append(f"shared host {fp}:")
        for jid in sorted(hosts.get(fp, {}).get("jobs", {})):
            j = hosts[fp]["jobs"][jid]
            ranks = ",".join(map(str, j["ranks"]))
            slow = ",".join(j["slow_links"]) or "-"
            lines.append(
                f"  job {jid:<10.10} ranks [{ranks}]  "
                f"{j['wire_bytes'] / 1e6:.2f} MB wire  "
                f"{j['bytes_per_sec'] / 1e6:.2f} MB/s  "
                f"slow links: {slow}")
    for c in model.get("contention") or []:
        verdicts = "; ".join(f"{j}: {','.join(v)}"
                             for j, v in c["slow"].items())
        lines.append(
            f"CONTENTION host {c['host_fp']}: "
            f"{', '.join(c['jobs'])} busy simultaneously, "
            f"each holding slow-link verdicts ({verdicts})")
    return "\n".join(lines)


def _wall_hms(wall) -> str:
    try:
        return time.strftime("%H:%M:%S", time.localtime(float(wall)))
    except (TypeError, ValueError, OverflowError, OSError):
        return "??:??:??"


def format_fleet_report(report: dict) -> str:
    """The ``mp4j-scope fleet-report`` view: jobs ever seen with their
    last-known state, the merged event timeline (job up/stale/gone/
    restart, health transitions, autoscaler actions, contention
    on/off) and contention episodes, from
    :func:`ytk_mp4j_tpu_torch.obs.fleet.fleet_report`'s dict. Pure."""
    lines = [f"fleet report — {report.get('snapshots', 0)} "
             f"snapshot(s), {len(report.get('events') or [])} "
             f"event(s), {report.get('segments', 0)} segment(s), "
             f"{report.get('torn', 0)} torn tail(s)"]
    jobs = report.get("jobs") or {}
    if jobs:
        lines.append("jobs:")
        for key in sorted(jobs):
            j = jobs[key]
            lines.append(
                f"  job {(j.get('job_id') or '-'):<10} "
                f"{(j.get('state') or '?'):<6} "
                f"{j.get('slave_num', '?')} rank(s)  "
                f"gen {j.get('roster_gen', '?')}  {j.get('url', key)}")
    events = report.get("events") or []
    if events:
        lines.append("timeline:")
        for ev in events:
            lines.append(f"  {_wall_hms(ev.get('wall'))}  "
                         f"{ev.get('kind', '?'):<14} "
                         f"{ev.get('msg', '')}")
    else:
        lines.append("timeline: (no events recorded)")
    eps = report.get("episodes") or []
    if eps:
        lines.append("contention episodes:")
        for ep in eps:
            onset = ep.get("onset_wall")
            clear = ep.get("clear_wall")
            span = (f"{_wall_hms(onset)}..{_wall_hms(clear)} "
                    f"({float(clear) - float(onset):.1f}s)"
                    if clear is not None
                    else f"{_wall_hms(onset)}.. (unresolved at end "
                         "of history)")
            lines.append(f"  host {ep.get('host_fp')}: {span}")
    return "\n".join(lines)


def render_diagnosis(table: dict[int, dict], slave_num: int) -> list[str]:
    """Render a hang/straggler diagnosis from the master's heartbeat
    table.

    ``table`` maps rank -> ``{"seq", "current", "last", "phase",
    "age"}`` (``age`` = seconds since that rank's last heartbeat
    arrived). Returns log lines: the cluster's max sequence number,
    then one line per rank — laggards (seq behind the max) with their
    lag, where they last were, and how stale their heartbeat is — and a
    closing line naming the likely stuck rank(s).
    """
    if not table:
        return [f"no telemetry received from any of the {slave_num} "
                "rank(s) — cannot localize the hang (heartbeats "
                "disabled? MP4J_HEARTBEAT_SECS=0)"]
    max_seq = max(t["seq"] for t in table.values())
    lines = [f"cluster diagnosis: max collective seq {max_seq}, "
             f"{len(table)}/{slave_num} ranks reporting"]
    stuck: list[int] = []
    for rank in range(slave_num):
        t = table.get(rank)
        if t is None:
            stuck.append(rank)
            lines.append(f"rank {rank}: NO heartbeat ever received")
            continue
        lag = max_seq - t["seq"]
        if t.get("current"):
            where = (f"stuck in '{t['current']}'"
                     + (f" (phase {t['phase']})" if t.get("phase")
                        else "")
                     + f" for {t.get('current_secs', 0.0):.1f}s")
        elif t.get("last"):
            where = f"idle after '{t['last']}'"
        else:
            where = "no collective entered yet"
        mark = f"lag {lag}" if lag > 0 else "up to date"
        lines.append(
            f"rank {rank}: seq {t['seq']} ({mark}), {where}; "
            f"last heartbeat {t.get('age', 0.0):.1f}s ago")
        if lag > 0:
            stuck.append(rank)
    if stuck:
        lines.append(
            f"likely stuck rank(s): {', '.join(map(str, stuck))} — "
            "behind the cluster schedule; the other ranks' bounded "
            "waits expired waiting for them")
    else:
        lines.append(
            "all reporting ranks are at the same sequence number — "
            "the stall is inside one collective (rank skew or a dead "
            "transport), not a mismatched schedule")
    return lines
