"""``mp4j-scope`` — cluster telemetry CLI.

A copy of ``ytk_mp4j_tpu/obs/cli.py``, with its imports re-rooted at the
port; it imports nothing of the JAX package.

Usage::

    mp4j-scope merge -o merged.json rank0.json rank1.json ...
    mp4j-scope report [--json] stats0.json stats1.json ...
    mp4j-scope live http://master-host:PORT [--interval 1.0] [--once]
    mp4j-scope postmortem /path/to/MP4J_POSTMORTEM_DIR
    mp4j-scope replay /path/to/BUNDLE_DIR
    mp4j-scope analyze /path/to/MP4J_SINK_DIR [--json]
    mp4j-scope health /path/to/MP4J_SINK_DIR | http://master:PORT
    mp4j-scope tuner /path/to/MP4J_SINK_DIR | http://master:PORT
    mp4j-scope tail /path/to/MP4J_SINK_DIR [--interval 1.0] [--once]
    mp4j-scope fleet URL [URL ...] [--interval 2.0] [--once] [--sink DIR]
    mp4j-scope fleet-report /path/to/FLEET_SINK_DIR
    mp4j-scope bench-diff BENCH_rA.json BENCH_rB.json [--threshold PCT]
    python -m ytk_mp4j_tpu_torch.obs report ...

``merge`` combines per-rank Chrome-trace exports
(``trace.export_chrome_trace`` output, one file per rank) into a single
timeline loadable in ``chrome://tracing`` / Perfetto — ranks keep
distinct ``pid`` tracks.

``report`` renders the cross-rank skew table (per-collective
min/median/max busy time, bytes, straggler ranks) from per-rank
``comm.stats()`` JSON dumps. Each input file holds either one rank's
snapshot (``{collective: {...}}``, rank taken from the argument order)
or an explicit ``{"rank": N, "stats": {...}}`` wrapper.

``live`` polls the master's metrics endpoint (``MP4J_METRICS_PORT``)
and renders the per-rank throughput / current collective / sequence
lag / retry table with straggler highlighting; ``--once`` prints a
single frame (scripts, tests).

``postmortem`` merges a flight-recorder directory (per-rank bundles +
the master manifest, ``MP4J_POSTMORTEM_DIR``) into one report naming
the dead and lagging ranks, plus the audit plane's known-good
watermark (the last cross-rank-verified collective before the fatal).

``replay`` re-executes a captured schedule
(``MP4J_AUDIT=capture`` bundles: postmortem dirs or
``ProcessCommSlave.dump_audit`` dumps) in-process on the thread
backend and diffs digests record-by-record — offline reproduction of
a divergence with no cluster. Exit 1 when any record diverges.

``analyze`` reads a durable sink directory
(``MP4J_SINK_DIR``: crc-framed per-rank segments) and prints the
job-lifetime critical-path report — per-collective dominators,
per-phase wait decomposition, straggler-onset timestamps, torn-tail
counts. ``tail`` follows the same directory live, printing each
collective's timeline line as all ranks' records land (``--once``
prints the current backlog and exits).

``health`` renders per-rank health verdicts: given a
durable sink DIRECTORY it reconstructs the full verdict history from
the ``alerts`` records (every transition, the first-degradation
timeline, final verdicts); given a master URL it shows the live
health document (current states, detector-pressure evidence,
dominator window, recent alerts).

``tuner`` renders the self-tuning data plane: given a
durable sink DIRECTORY it prints the decision history (every
per-link decision the ranks noted, plus fenced leader updates and
audit trips from the alert stream); given a master URL it shows the
live tuner document (mode, leader overrides, per-rank applied
decisions, trip state).

``fleet`` scrapes N job masters' ``/metrics.json`` +
``/health.json`` endpoints on a cadence and renders the cross-job
fleet table: one row per job (staleness state ``LIVE``/``STALE``/
``GONE``, ranks, rates, retries, health-ladder tally), shared-host
blocks with per-job byte attribution on each co-resident host
fingerprint, and cross-job ``CONTENTION`` rows. ``--sink DIR`` (or
``MP4J_FLEET_SINK_DIR``) additionally lands the fleet history
durably as crc-framed segments; ``fleet-report`` reconstructs the
merged fleet event timeline (job up/stale/gone/restart, health
transitions, autoscaler actions, contention episodes) offline from
such a directory.

``bench-diff`` compares two ``bench.py`` JSON outputs against
per-metric regression budgets (``obs.benchdiff``); exit 1 on a
regression — the perf gate.

Exit codes: 0 ok, 1 bench-diff regression / replay divergence, 2 bad
invocation / unreadable input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

from ytk_mp4j_tpu_torch.obs import (audit, benchdiff, critpath,
                              fleet as fleet_mod,
                              health as health_mod, postmortem,
                              sink as sink_mod, spans, telemetry)
from ytk_mp4j_tpu_torch.utils import tuning


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mp4j-scope",
        description="cluster-wide mp4j telemetry: timeline merge, "
                    "cross-rank skew report, live metrics view, "
                    "postmortem merge, bench regression gate")
    sub = ap.add_subparsers(dest="cmd", required=True)

    mg = sub.add_parser("merge", help="merge per-rank Chrome-trace "
                                      "files into one timeline")
    mg.add_argument("-o", "--out", required=True,
                    help="output trace-event JSON path")
    mg.add_argument("traces", nargs="+", help="per-rank trace files")

    rp = sub.add_parser("report", help="cross-rank skew table from "
                                       "per-rank comm.stats() dumps")
    rp.add_argument("--json", action="store_true",
                    help="emit the skew as JSON instead of a table")
    rp.add_argument("stats", nargs="+", help="per-rank stats JSON files")

    lv = sub.add_parser("live", help="poll a running master's metrics "
                                     "endpoint (MP4J_METRICS_PORT)")
    lv.add_argument("url", help="endpoint base, e.g. "
                                "http://127.0.0.1:9090 (scheme optional)")
    lv.add_argument("--interval", type=float, default=1.0,
                    help="poll period in seconds (default 1.0)")
    lv.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clears)")

    pm = sub.add_parser("postmortem",
                        help="merge a flight-recorder directory into "
                             "one report naming the dead/lagging rank")
    pm.add_argument("dir", help="the job's MP4J_POSTMORTEM_DIR")

    rp2 = sub.add_parser("replay",
                         help="re-execute a captured audit bundle on "
                              "the thread backend and diff digests "
                              "record-by-record (MP4J_AUDIT=capture)")
    rp2.add_argument("dir", help="bundle dir (rank_*/audit.json)")

    an = sub.add_parser("analyze",
                        help="job-lifetime critical-path report from "
                             "a durable sink directory "
                             "(MP4J_SINK_DIR)")
    an.add_argument("dir", help="sink dir (rank_*/seg_*.mp4j)")
    an.add_argument("--json", action="store_true",
                    help="emit the structured analysis as JSON")

    hp = sub.add_parser("health",
                        help="per-rank health verdicts: history from "
                             "a sink dir, or live from a master URL")
    hp.add_argument("target",
                    help="a MP4J_SINK_DIR (verdict history) or a "
                         "master metrics URL (current verdicts)")
    hp.add_argument("--json", action="store_true",
                    help="emit the raw health document/alert list")

    tn = sub.add_parser("tuner",
                        help="self-tuning data-plane decisions: "
                             "history from a sink dir, or live "
                             "per-link decisions from a master URL")
    tn.add_argument("target",
                    help="a MP4J_SINK_DIR (decision history) or a "
                         "master metrics URL (live tuner document)")
    tn.add_argument("--json", action="store_true",
                    help="emit the raw tuner document/event list")

    tl = sub.add_parser("tail",
                        help="follow a durable sink directory live, "
                             "one line per completed collective")
    tl.add_argument("dir", help="sink dir (rank_*/seg_*.mp4j)")
    tl.add_argument("--interval", type=float, default=1.0,
                    help="poll period in seconds (default 1.0)")
    tl.add_argument("--once", action="store_true",
                    help="print the current backlog and exit")

    fl = sub.add_parser("fleet",
                        help="scrape N job masters and render the "
                             "cross-job fleet table (shared hosts, "
                             "contention, per-job health)")
    fl.add_argument("urls", nargs="+", metavar="URL",
                    help="master endpoint bases, e.g. "
                         "http://127.0.0.1:9090 (scheme optional)")
    fl.add_argument("--interval", type=float, default=None,
                    help="poll period in seconds (default "
                         "MP4J_FLEET_POLL_SECS, 2.0)")
    fl.add_argument("--once", action="store_true",
                    help="one scrape sweep + one frame, then exit")
    fl.add_argument("--sink", default=None, metavar="DIR",
                    help="land fleet history durably in DIR as "
                         "crc-framed segments (default "
                         "MP4J_FLEET_SINK_DIR; empty = no sink)")

    fr = sub.add_parser("fleet-report",
                        help="merged fleet event timeline + "
                             "contention episodes from a fleet sink "
                             "directory, offline")
    fr.add_argument("dir", help="fleet sink dir (seg_*.mp4j)")
    fr.add_argument("--json", action="store_true",
                    help="emit the raw reconstruction as JSON")

    bd = sub.add_parser("bench-diff",
                        help="compare two bench.py JSON outputs "
                             "against per-metric regression budgets")
    bd.add_argument("old", help="baseline BENCH file")
    bd.add_argument("new", help="candidate BENCH file")
    bd.add_argument("--threshold", type=float, default=None,
                    metavar="PCT",
                    help="override every per-metric budget with this "
                         "max tolerated drop, in percent (e.g. 10)")
    return ap


def _load_rank_stats(paths: list[str]) -> dict[int, dict]:
    per_rank: dict[int, dict] = {}
    for i, p in enumerate(paths):
        with open(p, encoding="utf-8") as fh:
            doc = json.load(fh)
        if isinstance(doc, dict) and "stats" in doc and "rank" in doc:
            per_rank[int(doc["rank"])] = doc["stats"]
        elif isinstance(doc, dict):
            per_rank[i] = doc
        else:
            raise ValueError(f"{p}: not a stats snapshot")
    return per_rank


def _fetch_doc(base: str) -> dict:
    if "://" not in base:
        base = "http://" + base
    with urllib.request.urlopen(base.rstrip("/") + "/metrics.json",
                                timeout=5.0) as resp:
        return json.load(resp)


def _analyze(args) -> int:
    analysis = critpath.analyze(sink_mod.load_job(args.dir))
    if args.json:
        print(json.dumps(analysis, sort_keys=True, default=str))
    else:
        print(critpath.format_report(analysis, args.dir))
    return 0


def _tail(args) -> int:
    """Follow mode: each poll re-reads the sink and prints every
    collective whose cross-rank attribution is COMPLETE and new
    since the last poll, plus recovery events as they land. An
    ordinal is held back until every rank's spans have landed —
    ranks flush on independent cadences, and attributing from the
    ranks that happened to flush first would systematically
    misattribute exactly the ordinals a slow-flushing straggler
    gates. An ordinal older than the newest fully-covered one can
    never complete (a rank died mid-job) and prints with what
    survived. Full re-reads keep the loop simple and robust against
    rotation/eviction under the tailer; a sink directory is at most
    slave_num * MP4J_SINK_BYTES."""
    seen: set[int] = set()
    pending: dict[int, int] = {}    # seq -> polls waited incomplete
    seen_recovery: dict[int, int] = {}
    while True:
        analysis = critpath.analyze(sink_mod.load_job(args.dir))
        n = max((int(m.get("slave_num") or 0)
                 for m in analysis["meta"].values()), default=0) \
            or len(analysis["ranks"])
        horizon = max((r["seq"] for r in analysis["rows"]
                       if len(r["waits"]) >= n), default=0)
        for row in analysis["rows"]:
            seq = row["seq"]
            if seq in seen:
                continue
            # emit once coverage is complete, once a NEWER ordinal is
            # fully covered (every rank already flushed past this
            # one), after 3 incomplete polls (a dead rank's spans are
            # never coming — the ordinals around a crash must not be
            # withheld forever), or on --once (final state)
            stale = pending.get(seq, 0) >= 3
            if len(row["waits"]) >= n or seq < horizon or stale \
                    or args.once:
                seen.add(seq)
                pending.pop(seq, None)
                print(critpath.format_row(row), flush=True)
            else:
                pending[seq] = pending.get(seq, 0) + 1
        for rank, events in sorted(analysis["recovery"].items()):
            start = seen_recovery.get(rank, 0)
            for _, kind, detail in events[start:]:
                print(f"rank {rank} recovery: {kind}"
                      + (f" ({detail})" if detail else ""), flush=True)
            seen_recovery[rank] = len(events)
        if args.once:
            return 0
        try:
            time.sleep(max(args.interval, 0.1))
        except KeyboardInterrupt:
            return 0


def _health(args) -> int:
    """Verdict history from a sink dir, or current verdicts from a
    live master (the health operator view)."""
    if os.path.isdir(args.target):
        analysis = critpath.analyze(sink_mod.load_job(args.target))
        alerts = analysis.get("health_alerts") or []
        if args.json:
            print(json.dumps(alerts, sort_keys=True, default=str))
        else:
            print(health_mod.format_history(alerts,
                                            analysis["ranks"]))
        return 0
    doc = _fetch_doc(args.target)
    hl = (doc.get("cluster") or {}).get("health")
    if args.json:
        print(json.dumps(hl, sort_keys=True, default=str))
    else:
        print(health_mod.format_status(hl or {}))
    return 0


def _format_tuner_doc(doc: dict | None) -> str:
    """The live tuner view: mode/trip head line, leader
    overrides, then one line per rank with its applied per-link
    decisions."""
    if not doc:
        return "tuner: off (MP4J_TUNER=off — static knobs only)"
    lines = [f"tuner: mode={doc.get('mode')} "
             f"demotions={doc.get('demotions', 0)} "
             f"version={doc.get('version', 0)}"
             + (f"  TRIPPED: {doc['tripped']}"
                if doc.get("tripped") else "")]
    if doc.get("overrides"):
        lines.append(f"  leader overrides (host group -> leader): "
                     f"{doc['overrides']}")
    for r in sorted(doc.get("ranks") or {}, key=int):
        t = doc["ranks"][r] or {}
        applied = t.get("applied") or {}
        dec = ", ".join(
            f"->{p}: chunk={d.get('chunk_bytes') or 'static'} "
            f"compress={'static' if d.get('compress') is None else d['compress']}"
            for p, d in sorted(applied.items(), key=lambda kv: int(kv[0])))
        lines.append(
            f"  rank {r}: decisions={t.get('decisions_total', 0)}"
            + (f"  TRIPPED: {t['tripped']}" if t.get("tripped") else "")
            + (f"  [{dec}]" if dec else "  [all links static]"))
    for ev in (doc.get("events") or [])[-6:]:
        lines.append("  " + health_mod.format_alert(ev))
    return "\n".join(lines)


def _tuner(args) -> int:
    """Decision history from a sink dir, or the live tuner document
    from a master URL (the tuner operator view)."""
    if os.path.isdir(args.target):
        analysis = critpath.analyze(sink_mod.load_job(args.target))
        events = analysis.get("tuner_events") or []
        alerts = [a for a in (analysis.get("health_alerts") or ())
                  if a.get("kind") == "tuner"]
        if args.json:
            print(json.dumps({"events": events, "alerts": alerts},
                             sort_keys=True, default=str))
            return 0
        if not events and not alerts:
            print("no tuner events in this sink directory "
                  "(MP4J_TUNER=off, or the job made no decisions)")
            return 0
        for ev in events:
            print(f"rank {ev['rank']}: {ev['msg']}")
        for a in alerts:
            print(health_mod.format_alert(a))
        return 0
    doc = _fetch_doc(args.target)
    tun = (doc.get("cluster") or {}).get("tuner")
    if args.json:
        print(json.dumps(tun, sort_keys=True, default=str))
    else:
        print(_format_tuner_doc(tun))
    return 0


def _live(args) -> int:
    last_frame: str | None = None
    last_ok: float | None = None
    while True:
        try:
            last_frame = telemetry.format_live(_fetch_doc(args.url))
            last_ok = time.monotonic()
            frame = last_frame
        except (OSError, ValueError, json.JSONDecodeError) as e:
            # mid-watch endpoint death is a FACT to render, not a
            # traceback to die with — but an
            # endpoint that never answered once is a usage error and
            # keeps the exit-2 path
            if args.once or last_ok is None:
                raise
            frame = (last_frame + "\n" if last_frame else "") + (
                f"STALE (last seen "
                f"{time.monotonic() - last_ok:.0f}s ago) — "
                f"{args.url}: {e}")
        if args.once:
            print(frame)
            return 0
        # ANSI clear + home: a poor man's top(1); the frame is small
        print("\x1b[2J\x1b[H" + frame, flush=True)
        try:
            time.sleep(max(args.interval, 0.1))
        except KeyboardInterrupt:
            return 0


def _fleet(args) -> int:
    """The cross-job fleet watch: one FleetPoller sweep
    per interval, rendered via ``telemetry.format_fleet``. Staleness
    handling lives in the poller — a dead master degrades its own
    row (LIVE -> STALE -> GONE), never this loop."""
    sink_dir = args.sink if args.sink is not None \
        else tuning.fleet_sink_dir()
    fs = fleet_mod.FleetSink(sink_dir) if sink_dir else None
    poller = fleet_mod.FleetPoller(args.urls, poll_secs=args.interval,
                                   sink=fs)
    try:
        while True:
            frame = telemetry.format_fleet(poller.poll_once())
            if args.once:
                print(frame)
                return 0
            print("\x1b[2J\x1b[H" + frame, flush=True)
            try:
                time.sleep(max(poller.poll_secs, 0.1))
            except KeyboardInterrupt:
                return 0
    finally:
        if fs is not None:
            fs.close()


def _fleet_report(args) -> int:
    report = fleet_mod.fleet_report(args.dir)
    if args.json:
        print(json.dumps(report, sort_keys=True, default=str))
    else:
        print(telemetry.format_fleet_report(report))
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        if args.cmd == "merge":
            n = spans.merge_chrome_traces(args.out, args.traces)
            print(f"mp4j-scope: merged {n} events from "
                  f"{len(args.traces)} file(s) into {args.out}")
            return 0
        if args.cmd == "live":
            return _live(args)
        if args.cmd == "postmortem":
            print(postmortem.merge_report(args.dir))
            return 0
        if args.cmd == "replay":
            text, diverged = audit.replay_bundle(args.dir)
            print(text)
            return 1 if diverged else 0
        if args.cmd == "analyze":
            return _analyze(args)
        if args.cmd == "health":
            return _health(args)
        if args.cmd == "tuner":
            return _tuner(args)
        if args.cmd == "tail":
            return _tail(args)
        if args.cmd == "fleet":
            return _fleet(args)
        if args.cmd == "fleet-report":
            return _fleet_report(args)
        if args.cmd == "bench-diff":
            thr = (None if args.threshold is None
                   else args.threshold / 100.0)
            text, regressed = benchdiff.run(args.old, args.new, thr)
            print(text)
            return 1 if regressed else 0
        skew = telemetry.cluster_skew(_load_rank_stats(args.stats))
        if args.json:
            print(json.dumps(skew, sort_keys=True))
        else:
            print(telemetry.format_skew(skew))
        return 0
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            urllib.error.URLError) as e:
        print(f"mp4j-scope: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
