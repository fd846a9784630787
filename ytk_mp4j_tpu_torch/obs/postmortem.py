"""Postmortem flight recorder: per-rank crash bundles + merged report.

A copy of ``ytk_mp4j_tpu/obs/postmortem.py``, with its imports re-rooted
at the port; it imports nothing of the JAX package.

A ``Mp4jFatalError`` used to leave nothing on disk: the job's spans,
stats and recovery history died with the processes, and debugging a
production incident meant reproducing it. With ``MP4J_POSTMORTEM_DIR``
set, every rank that reaches a terminal abort dumps a **bundle** before
it raises (hooked into the recovery engine's fatal fan-out, so the
survivors of a dead rank all dump), and the master writes a cluster
**manifest**; ``mp4j-scope postmortem <dir>`` merges them into one
report that names the dead and lagging ranks.

Bundle layout (``<dir>/rank_NNNN/``)::

    trace.json      span ring as Chrome-trace JSON (load in Perfetto)
    stats.json      {"rank", "reason", "epoch", "progress", "stats"}
    metrics.json    histogram/counter registry snapshot (obs.metrics)
    recovery.json   {"epoch", "events": [[mono_ts, kind, detail], ...]}
    complete.json   completeness marker, written LAST: a bundle without
                    it was torn mid-dump and the report says so

Master manifest (``<dir>/manifest.json``)::

    {"slave_num", "reason", "departed": {rank: why},
     "diagnosis": [...], "table": {rank: progress+age}, "wall_time"}

Everything here is best-effort by design — the job is already dying;
a full disk must never turn a clean ``Mp4jFatalError`` into something
worse. Writers catch ``OSError`` at the call site.
"""

from __future__ import annotations

import json
import os
import time

from ytk_mp4j_tpu_torch.obs import spans, telemetry
from ytk_mp4j_tpu_torch.obs.critpath import fmt_wall as _fmt_wall

_BUNDLE_FILES = ("trace.json", "stats.json", "metrics.json",
                 "recovery.json", "audit.json", "sink.json")


def bundle_dir(root: str, rank: int) -> str:
    return os.path.join(root, f"rank_{rank:04d}")


def write_bundle(root: str, rank: int, *, reason: str, progress: dict,
                 stats: dict, metrics: dict, epoch: int,
                 events: list | None = None,
                 audit: dict | None = None,
                 sink: dict | None = None) -> str:
    """Write one rank's postmortem bundle; returns the bundle dir.
    The ``complete.json`` marker goes last so a reader can distinguish
    a finished bundle from one torn by the dying process, and every
    file lands via tmp + ``os.replace`` (mp4j-lint R14) so a crash
    mid-dump can never leave a syntactically truncated JSON
    masquerading as a complete one — ``complete.json``-last used to be
    the ONLY guard. ``audit`` is the rank's audit-ring dump
    — the record ring that makes the bundle replayable offline
    (``mp4j-scope replay``); ``sink`` is the durable sink's
    status record pointing the report at full-job segment history."""
    d = bundle_dir(root, rank)
    os.makedirs(d, exist_ok=True)
    spans.export_chrome_trace(os.path.join(d, "trace.json"))
    _dump(d, "stats.json", {"rank": rank, "reason": reason,
                            "epoch": epoch, "progress": progress,
                            "stats": stats})
    _dump(d, "metrics.json", metrics)
    _dump(d, "recovery.json", {"epoch": epoch,
                               "events": list(events or [])})
    if audit is not None:
        _dump(d, "audit.json", audit)
    if sink is not None:
        _dump(d, "sink.json", sink)
    _dump(d, "complete.json", {
        "rank": rank, "files": list(_BUNDLE_FILES),
        # wall clock: a postmortem artifact's timestamp must be
        # human-meaningful across hosts, not a per-process counter
        # mp4j-lint: disable=R11 (artifact timestamp, not a duration)
        "wall_time": time.time()})
    return d


def _dump(d: str, name: str, obj) -> None:
    """Atomic bundle-file write (tmp + ``os.replace``): the visible
    path only ever holds a complete JSON document — a crash between
    write and replace leaves the tmp file, never a torn artifact."""
    path = os.path.join(d, name)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def write_master_manifest(root: str, *, slave_num: int, reason: str,
                          table: dict, departed: dict,
                          diagnosis: list[str],
                          audit: dict | None = None,
                          sink_dir: str | None = None,
                          membership: dict | None = None,
                          health: dict | None = None,
                          autoscale: dict | None = None) -> str:
    """The master's cluster-level half of the recorder: who the job
    thought was alive, why it died, and the final heartbeat table
    (fresh — the slaves' fatal-path telemetry flush lands before the
    closing manifest refresh). ``audit`` carries the
    cluster audit status — the last cross-rank-verified collective
    ordinal is the report's known-good watermark; ``sink_dir`` names the job's durable-sink root so the merged report
    can join full-job segment history; ``membership``
    records the elastic mode, spare availability and full
    replacement/shrink history so the report covers every roster the
    job ever ran under; ``health`` freezes the health
    plane's final verdicts — per-rank state, the first-degradation
    event and the recent alert tail — so the report can answer *what
    degraded first, when, and which detector saw it*; ``autoscale`` freezes the controller's ledger — actions taken,
    would-be actions observed, circuit-breaker state — so the report
    shows what the autopilot DID about the degradation it saw."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "manifest.json")
    _dump(root, "manifest.json", {
        "slave_num": slave_num,
        "reason": reason,
        "departed": {str(r): why for r, why in departed.items()},
        "diagnosis": list(diagnosis),
        "audit": audit,
        "sink_dir": sink_dir or None,
        "membership": membership,
        "health": health,
        "autoscale": autoscale,
        "table": {str(r): t for r, t in table.items()},
        # mp4j-lint: disable=R11 (artifact timestamp, not a duration)
        "wall_time": time.time(),
    })
    return path


# ----------------------------------------------------------------------
# merged report (the ``mp4j-scope postmortem`` command)
# ----------------------------------------------------------------------

def load_bundles(root: str) -> dict[int, dict]:
    """Read every COMPLETE bundle under ``root``; returns
    ``{rank: {"stats": ..., "recovery": ..., "metrics": ...,
    "complete": ..., "torn": bool}}`` (torn bundles appear with
    whatever files survived and ``torn=True``)."""
    out: dict[int, dict] = {}
    for name in sorted(os.listdir(root)):
        if not name.startswith("rank_"):
            continue
        try:
            rank = int(name[len("rank_"):])
        except ValueError:
            continue
        d = os.path.join(root, name)
        entry: dict = {"torn": not os.path.exists(
            os.path.join(d, "complete.json"))}
        for fname in _BUNDLE_FILES + ("complete.json",):
            p = os.path.join(d, fname)
            if os.path.exists(p):
                try:
                    with open(p, encoding="utf-8") as fh:
                        entry[fname.rsplit(".", 1)[0]] = json.load(fh)
                except (OSError, json.JSONDecodeError):
                    entry["torn"] = True
        out[rank] = entry
    return out


def merge_report(root: str) -> str:
    """One report from a postmortem directory: names the dead rank(s)
    (no bundle / departed per the manifest), the lagging rank(s)
    (behind the max collective sequence number), the cluster skew
    table, and each rank's last position."""
    manifest = None
    mpath = os.path.join(root, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath, encoding="utf-8") as fh:
            manifest = json.load(fh)
    bundles = load_bundles(root)
    if manifest is None and not bundles:
        raise ValueError(f"{root}: no postmortem bundles or manifest")

    slave_num = (manifest["slave_num"] if manifest
                 else (max(bundles) + 1 if bundles else 0))
    lines = [f"postmortem report: {root}"]
    if manifest:
        lines.append(f"reason: {manifest.get('reason')}")
    lines.append(f"bundles: {len(bundles)}/{slave_num} ranks"
                 + (" (+" + ", ".join(
                     f"rank {r} TORN" for r in sorted(bundles)
                     if bundles[r]["torn"]) + ")"
                    if any(b["torn"] for b in bundles.values()) else ""))

    departed = {int(r): why for r, why in
                (manifest.get("departed") or {}).items()} if manifest \
        else {}
    # dead = left no bundle at all. A rank that dumped and THEN closed
    # nonzero (every survivor of a fatal does) is a casualty, not the
    # cause — the manifest's departed map only supplies the "why" for
    # the ranks that never wrote.
    dead = sorted(set(range(slave_num)) - set(bundles))
    for r in dead:
        why = departed.get(r, "no postmortem bundle written")
        lines.append(f"DEAD rank {r}: {why}")

    # membership history: every replacement/shrink the job
    # survived before it finally died — a postmortem that omits them
    # would blame rank ids that belonged to different processes over
    # the job's lifetime
    ms = (manifest or {}).get("membership") or {}
    if ms.get("replacements") or ms.get("shrinks"):
        lines.append(
            f"membership: mode={ms.get('mode')}, "
            f"{ms.get('replacements', 0)} replacement(s), "
            f"{ms.get('shrinks', 0)} shrink(s), "
            f"{ms.get('spares_available', 0)} spare(s) left")
        for ev in ms.get("events") or []:
            if ev.get("kind") == "replace":
                lines.append(
                    f"membership event: rank {ev.get('rank')} REPLACED "
                    f"from spare #{ev.get('spare')} @ epoch "
                    f"{ev.get('epoch')} ({ev.get('why')})")
            else:
                lines.append(
                    f"membership event: SHRUNK, dropped "
                    f"{ev.get('dead')} @ epoch {ev.get('epoch')} "
                    f"({ev.get('why')})")

    # health timeline: what degraded first, when, and which
    # detector saw it — the manifest froze the engine's final verdicts
    # at abort time (the durable sink join below carries the FULL
    # alert history when the job ran with a sink)
    health = (manifest or {}).get("health") or {}
    if health.get("ranks"):
        verdicts = ", ".join(
            f"rank {r}: {e.get('state')}"
            for r, e in sorted(health["ranks"].items(), key=lambda kv:
                               int(kv[0]))
            if e.get("state") != "HEALTHY")
        lines.append("health verdicts at abort time: "
                     + (verdicts or "all reporting ranks HEALTHY"))
        fd = health.get("first_degraded")
        if fd:
            lines.append(
                f"health: first degradation was rank {fd.get('rank')} "
                f"-> {fd.get('to')} via {fd.get('detector')} at "
                f"{_fmt_wall(fd.get('wall'))}"
                + (f" (collective #{fd['seq']})" if fd.get("seq")
                   else "") + f": {fd.get('msg', '')}")
        for ev in health.get("last_alerts") or []:
            lines.append(
                f"health alert: rank {ev.get('rank')} "
                f"{ev.get('from')} -> {ev.get('to')} "
                f"({ev.get('detector')}) at "
                f"{_fmt_wall(ev.get('wall'))}: "
                f"{ev.get('msg', '')}")
        evict = health.get("evict_recommended") or []
        if evict:
            lines.append(
                f"health: EVICT was recommended for rank(s) "
                f"{', '.join(map(str, evict))} before the fatal")

    # autoscaler actions: what the autopilot did (or would
    # have done) about the degradation the health section describes —
    # a postmortem that shows verdicts without actions can't tell a
    # controller that failed to act from one that was never armed
    asc = (manifest or {}).get("autoscale") or {}
    if asc:
        lines.append(
            f"autoscaler: mode={asc.get('mode')}"
            + (" TRIPPED (recommend-only)" if asc.get("tripped")
               else "")
            + f", actions {asc.get('actions')}, "
            f"budget {asc.get('budget', {}).get('used', 0)}/"
            f"{asc.get('budget', {}).get('limit', 0)}")
        if asc.get("tripped"):
            lines.append(
                f"autoscaler: breaker tripped: {asc.get('tripped_why')}")
        for ev in asc.get("events") or []:
            lines.append(
                f"autoscaler event: {ev.get('event')} "
                f"{ev.get('action')}"
                + (f" rank {ev['rank']}"
                   if ev.get("rank") is not None else "")
                + f" at {_fmt_wall(ev.get('wall'))}: "
                  f"{ev.get('msg', '')}")

    # known-good watermark: the last collective ordinal the
    # master cross-rank-verified before the fatal — everything up to
    # it is PROVEN bit-identical across ranks, so the search space for
    # "when did it go wrong" starts there, not at step 0
    audit = (manifest or {}).get("audit") or {}
    if audit.get("verified_seq"):
        lines.append(
            f"known-good watermark: collective #{audit['verified_seq']} "
            "was the last cross-rank-verified seq before the fatal "
            f"({audit.get('verified_total', 0)} seq(s) verified, "
            f"{audit.get('divergences', 0)} divergence(s))")
    elif audit:
        lines.append(
            "known-good watermark: none — no collective was cross-rank-"
            "verified before the fatal (audit mode below 'verify', or "
            "the job died before the first complete round)")
    for d in audit.get("last_divergences") or []:
        lines.append(f"audit divergence: {d.get('msg')}")

    # sequence-number lag across the bundles that exist
    table = {}
    for r, b in sorted(bundles.items()):
        prog = (b.get("stats") or {}).get("progress") or {}
        table[r] = {"seq": int(prog.get("seq", 0)),
                    "current": prog.get("current"),
                    "last": prog.get("last"),
                    "phase": prog.get("phase"),
                    "current_secs": float(prog.get("current_secs", 0.0)),
                    "age": 0.0}
    if table:
        lines.append("")
        lines.extend(telemetry.render_diagnosis(table, slave_num))
        per_rank = {r: (b.get("stats") or {}).get("stats") or {}
                    for r, b in bundles.items()}
        skew = telemetry.cluster_skew(
            {r: s for r, s in per_rank.items() if s})
        if skew:
            lines.append("")
            lines.append(telemetry.format_skew(skew))
    for r, b in sorted(bundles.items()):
        ev = (b.get("recovery") or {}).get("events") or []
        if ev:
            tail = "; ".join(f"{kind}({detail})" if detail else kind
                             for _, kind, detail in ev[-6:])
            lines.append(f"rank {r} recovery log (last "
                         f"{min(len(ev), 6)}): {tail}")
    if manifest and manifest.get("diagnosis"):
        lines.append("")
        lines.append("master diagnosis at abort time:")
        lines.extend(f"  {ln}" for ln in manifest["diagnosis"])

    # durable-sink join: when the job ran with the streaming
    # sink, the report gains FULL-JOB history — critical-path
    # dominators and straggler onset over every ordinal the segments
    # kept, not just the ring tails the bundles froze
    sink_root = (manifest or {}).get("sink_dir")
    if not sink_root:
        for b in bundles.values():
            root_hint = (b.get("sink") or {}).get("root")
            if root_hint:
                sink_root = root_hint
                break
    if sink_root and os.path.isdir(sink_root):
        try:
            from ytk_mp4j_tpu_torch.obs import critpath, sink as sink_mod
            analysis = critpath.analyze(sink_mod.load_job(sink_root))
            lines.append("")
            lines.append("durable sink (full-job history):")
            lines.extend("  " + ln for ln in critpath.format_report(
                analysis, sink_root).splitlines())
        except Exception as e:      # torn segments must not kill the
            # postmortem path they exist to enrich
            lines.append(f"durable sink at {sink_root}: unreadable "
                         f"({e!r})")
    return "\n".join(lines)
