"""Live metrics plane: counters, gauges, log-scale histograms, rates.

A copy of ``ytk_mp4j_tpu/obs/metrics.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

This module is the measurement substrate of the monitoring layer,
sitting one level above :mod:`ytk_mp4j_tpu_torch.utils.stats` (which keeps
per-collective lifetime totals): it adds the quantities totals cannot
answer —

- **histograms** with fixed log2-scale buckets: per-collective-family
  latency (``latency/<family>``, seconds) and wire frame sizes
  (``frame_bytes``), cheap enough to stay default-on (one lock + two
  integer bumps per observation; ``MP4J_METRICS=0`` turns every
  observe into a no-op);
- **delta shipping**: :func:`diff_snapshot` / :func:`fold_snapshot`
  turn cumulative registry snapshots into bounded heartbeat payloads —
  a slave ships only what changed since its last beat, the master
  folds deltas back into a rolling cumulative view (counters and
  bucket counts are additive, so out-of-order folds are harmless);
- **rate windows**: :class:`RateWindow` keeps a bounded ring of
  ``(time, cumulative totals)`` interval snapshots so rates (GB/s,
  collectives/s, keys/s) are derivable over a sliding
  ``MP4J_METRICS_WINDOW_SECS`` window instead of diluted lifetime
  averages;
- **rendering**: :func:`to_prometheus` serializes the master's metrics
  document (see ``Master.metrics_doc``) as Prometheus text-format 0.0.4
  — the same document serves as the JSON schema.

Histogram bucket layout: ``n`` log2 buckets above ``lo`` plus one
overflow bucket. Bucket ``0`` holds values ``<= lo``; bucket ``i``
holds ``(lo * 2**(i-1), lo * 2**i]``; bucket ``n`` holds everything
above ``lo * 2**(n-1)`` (rendered as ``le="+Inf"``). Quantile
estimates return the UPPER edge of the bucket containing the
nearest-rank order statistic, so an estimate is exact to one bucket
(a factor of 2) by construction — the property the tier-1 tests pin
against ``numpy.percentile``.

Everything here is deliberately import-light (stdlib only): ``utils.
stats`` feeds it from the comm hot path, and the ``mp4j-scope`` CLI
consumes it offline.
"""

from __future__ import annotations

import collections
import math
import threading

from ytk_mp4j_tpu_torch.utils import tuning

# Canonical bucket layouts (job-wide constants, like the stats schema:
# the master folds per-rank histograms bucket-wise, which is only
# meaningful when every rank uses the identical layout).
LATENCY_LO = 1e-6          # 1 us .. ~34 s in 36 log2 buckets
LATENCY_BUCKETS = 36
FRAME_LO = 64.0            # 64 B .. ~4.3 GB in 27 log2 buckets
FRAME_BUCKETS = 27

# ----------------------------------------------------------------------
# THE metric catalogue (mp4j-lint R17 doc-drift guard): every metric
# family — registry-internal flat names AND Prometheus series the
# /metrics endpoint renders — must have a one-line entry here. A
# ``<segment>`` marks a dynamic label segment (R17 prefix-matches it).
# Registering or rendering a family absent from this table is a lint
# error: an undocumented series is invisible to the operators the
# metrics plane exists for.
# ----------------------------------------------------------------------
METRICS_DOC: dict[str, str] = {
    # -- registry families (flat names inside MetricsRegistry) --------
    "latency/<family>": "per-collective-family latency histogram "
                        "(log2 buckets, seconds)",
    "frame_bytes": "wire frame size histogram, untagged transports "
                   "(log2 buckets, bytes)",
    "frame_bytes/<transport>": "wire frame size histogram per "
                               "transport (tcp/shm)",
    "sink/bytes": "bytes the durable sink made safe on disk "
                  "",
    "sink/records": "telemetry records the durable sink wrote",
    "sink/dropped_records": "telemetry records the sink LOST (ring "
                            "overflow, full disk, encode poison) — "
                            "nonzero means an outage, never noise",
    "sink/lag_secs": "seconds between the sink's last two drains",
    "sink/dir_bytes": "bytes currently on disk in the rank's segment "
                      "dir (bounded by MP4J_SINK_BYTES)",
    "async/outstanding": "nonblocking collectives queued + in flight "
                         "on this rank's scheduler",
    "tuner/decisions": "per-link tuner decisions APPLIED at collective "
                       "boundaries on this rank",
    # -- serve plane — the latency/serve_request histogram
    # rides the latency/<family> row above
    "serve/requests": "requests the serve frontend completed",
    "serve/batches": "micro-batches dispatched",
    "serve/batch_full": "batches dispatched because max_batch filled",
    "serve/batch_deadline": "batches dispatched at the accumulation "
                            "deadline (MP4J_SERVE_DEADLINE_MS)",
    "serve/cache_hits": "hot-key cache row hits",
    "serve/cache_misses": "hot-key cache row misses (pulled over the "
                          "columnar map plane)",
    "serve/cache_stale": "cached rows dropped past the staleness "
                         "bound (MP4J_SERVE_STALE_VERSIONS)",
    "serve/cache_rows": "rows resident in the hot-key cache now",
    "serve/pull_rows": "rows pulled from the sharded table",
    "serve/degraded_batches": "batches delivered with an incomplete "
                              "contributor set (replacement warming "
                              "up / out-of-vocabulary rows) — "
                              "delivered, not hung, but say so",
    "serve/qps": "serve requests per second (sliding window)",
    "serve/worker_rounds": "serve rounds a worker rank answered",
    # -- Prometheus series (the /metrics endpoint) --------------------
    "mp4j_ranks_reporting": "ranks whose heartbeats the master holds",
    "mp4j_slave_num": "the job's configured rank count",
    "mp4j_calls_total": "collective calls per rank and family",
    "mp4j_bytes_sent_total": "payload bytes sent per rank and family",
    "mp4j_bytes_recv_total": "payload bytes received per rank/family",
    "mp4j_chunks_total": "pipeline chunks exchanged per rank/family",
    "mp4j_keys_total": "map entries encoded columnar per rank/family",
    "mp4j_retries_total": "epoch-fenced retry rounds per rank/family",
    "mp4j_reconnects_total": "peer re-dials during recovery",
    "mp4j_aborts_seen_total": "abort rounds this rank tore down for",
    "mp4j_wire_bytes_tcp_total": "wire bytes moved over TCP",
    "mp4j_wire_bytes_shm_total": "wire bytes moved over shm rings",
    "mp4j_phase_seconds_total": "busy seconds per rank, family and "
                                "phase (wire/reduce/serialize)",
    "mp4j_rank_seq": "per-rank outermost collective sequence number",
    "mp4j_heartbeat_age_seconds": "seconds since each rank's last "
                                  "heartbeat arrived",
    "mp4j_rank_<rate>": "per-rank sliding-window rates "
                        "(bytes/collectives/keys per second)",
    "mp4j_cluster_<rate>": "cluster sliding-window rates",
    "mp4j_audit_divergences_total": "cross-rank digest divergences "
                                    "flagged",
    "mp4j_audit_verified_seqs": "collective ordinals verified "
                                "bit-identical across ranks",
    "mp4j_audit_verified_seq_watermark": "highest cross-rank-verified "
                                         "ordinal (the known-good "
                                         "watermark)",
    "mp4j_replacements_total": "dead ranks replaced from warm spares "
                               "",
    "mp4j_shrinks_total": "shrink rounds survived",
    "mp4j_spares_available": "idle warm spares registered now",
    "mp4j_sink_bytes_total": "durable-sink bytes per rank + cluster",
    "mp4j_sink_records_total": "durable-sink records per rank",
    "mp4j_sink_dropped_records_total": "durable-sink records LOST per "
                                       "rank — alert on growth",
    "mp4j_sink_lag_seconds": "per-rank sink drain lag",
    "mp4j_outstanding_collectives": "nonblocking collectives in "
                                    "flight per rank + cluster",
    "mp4j_collective_latency_seconds": "cluster latency histogram per "
                                       "collective family",
    "mp4j_frame_bytes": "cluster wire frame size histogram "
                        "(transport-labelled)",
    # -- health plane --------------------------------------
    "mp4j_rank_health_state": "per-rank health verdict (0 HEALTHY, "
                              "1 DEGRADED, 2 SUSPECT, "
                              "3 EVICT_RECOMMENDED, 4 DEAD)",
    "mp4j_alerts_total": "health alerts emitted per rank and "
                         "detector — any growth is a story",
    "mp4j_evict_recommended": "ranks the health plane currently "
                              "recommends evicting (it never acts)",
    "mp4j_straggler_onsets_total": "straggler onsets the online "
                                   "dominator detected (the "
                                   "offline onset events, live)",
    "mp4j_critpath_dominator": "per-rank share of recently attributed "
                               "ordinals this rank gated (sliding "
                               "window)",
    # -- autoscaler ------------------------------------------
    "mp4j_autoscale_actions_total": "autoscaler actions DISPATCHED, "
                                    "by action (evict_replace / "
                                    "provision / grow) — alert on "
                                    "unexpected growth",
    "mp4j_autoscale_tripped": "1 when the autoscaler's circuit "
                              "breaker tripped it back to "
                              "recommend-only (two consecutive "
                              "failed actions)",
    # -- serve plane -----------------------------------------
    "mp4j_serve_requests_total": "serve requests completed per rank "
                                 "(+ cluster total)",
    "mp4j_serve_batches_total": "serve micro-batches dispatched per "
                                "rank (+ cluster total)",
    "mp4j_serve_cache_hits_total": "serve hot-key cache hits per rank "
                                   "(+ cluster total)",
    "mp4j_serve_cache_misses_total": "serve hot-key cache misses per "
                                     "rank (+ cluster total)",
    "mp4j_serve_degraded_batches_total": "serve batches delivered "
                                         "degraded per rank (+ "
                                         "cluster total)",
    "mp4j_serve_qps": "cluster serve requests per second (frontend "
                      "sliding window)",
    # -- self-tuning data plane ------------------------------
    "mp4j_tuner_decisions_total": "per-link tuner decisions applied "
                                  "per rank (+ cluster total)",
    "mp4j_tuner_demotions_total": "fenced host-leader demotions the "
                                  "master's tuner controller "
                                  "dispatched",
    "mp4j_tuner_tripped": "1 when an audit divergence tripped the "
                          "tuner back to static defaults (latched "
                          "for the job)",
}


def bucket_edges(lo: float, n: int) -> list[float]:
    """The ``n`` finite upper edges ``[lo, 2*lo, ..., lo * 2**(n-1)]``
    (the overflow bucket's edge is +Inf)."""
    return [lo * 2.0 ** i for i in range(n)]


def bucket_index(value: float, lo: float, n: int) -> int:
    """Index of the bucket holding ``value`` (0..n, where n is the
    overflow bucket). Exact at the edges by construction: the log2
    guess is fixed up so ``value <= lo * 2**idx`` and
    ``value > lo * 2**(idx-1)`` always hold."""
    if value <= lo:
        return 0
    idx = int(math.ceil(math.log2(value / lo)))
    while idx < n and value > lo * 2.0 ** idx:
        idx += 1
    while idx > 1 and value <= lo * 2.0 ** (idx - 1):
        idx -= 1
    return min(max(idx, 0), n)


def _new_hist(lo: float, n: int) -> dict:
    return {"lo": lo, "n": n, "counts": [0] * (n + 1),
            "count": 0, "sum": 0.0}


def hist_quantile(h: dict, q: float) -> float:
    """Nearest-rank quantile estimate: the UPPER edge of the bucket
    containing the ``ceil(q * count)``-th smallest observation (so the
    true order statistic is within one bucket below the estimate).
    Empty histogram -> 0.0; overflow bucket -> +Inf (the histogram
    only knows the value exceeded its largest edge)."""
    count = h["count"]
    if count <= 0:
        return 0.0
    target = max(1, math.ceil(min(max(q, 0.0), 1.0) * count))
    cum = 0
    for i, c in enumerate(h["counts"]):
        cum += c
        if cum >= target:
            if i >= h["n"]:
                return math.inf
            return h["lo"] * 2.0 ** i if i else h["lo"]
    return math.inf


class MetricsRegistry:
    """Cheap thread-safe registry of counters, gauges and fixed
    log2-bucket histograms. All names are flat strings; histogram
    families encode their one label in the name (``latency/<family>``)
    — the renderer splits it back out. Disabled (``MP4J_METRICS=0``)
    every mutator is a single flag check."""

    def __init__(self, enabled: bool | None = None):
        self._enabled = (tuning.metrics_enabled() if enabled is None
                         else bool(enabled))
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, dict] = {}

    @property
    def enabled(self) -> bool:
        return self._enabled

    def inc(self, name: str, value: float = 1) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float, lo: float, n: int) -> None:
        if not self._enabled:
            return
        idx = bucket_index(value, lo, n)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _new_hist(lo, n)
            h["counts"][idx] += 1
            h["count"] += 1
            h["sum"] += value

    def snapshot(self) -> dict:
        """Deep copy: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {lo, n, counts, count, sum}}}``."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: {**h, "counts": list(h["counts"])}
                               for k, h in self._hists.items()},
            }


def _empty_snapshot() -> dict:
    return {"counters": {}, "gauges": {}, "histograms": {}}


def diff_snapshot(cur: dict, prev: dict) -> dict:
    """``cur - prev`` over registry snapshots, pruned: unchanged
    counters/histograms are dropped so a heartbeat's payload is
    bounded by what actually happened since the last beat, not by
    every metric ever seen. Gauges are
    last-value semantics and always ship whole."""
    out = _empty_snapshot()
    pc = prev.get("counters", {})
    for k, v in cur.get("counters", {}).items():
        d = v - pc.get(k, 0)
        if d:
            out["counters"][k] = d
    out["gauges"] = dict(cur.get("gauges", {}))
    ph = prev.get("histograms", {})
    for k, h in cur.get("histograms", {}).items():
        p = ph.get(k)
        if p is None:
            if h["count"]:
                out["histograms"][k] = {**h, "counts": list(h["counts"])}
            continue
        if h["count"] == p["count"]:
            continue
        out["histograms"][k] = {
            "lo": h["lo"], "n": h["n"],
            "counts": [a - b for a, b in zip(h["counts"], p["counts"])],
            "count": h["count"] - p["count"],
            "sum": h["sum"] - p["sum"],
        }
    return out


def fold_snapshot(agg: dict, delta: dict) -> dict:
    """Fold a delta (or a whole snapshot) into a cumulative aggregate;
    returns a NEW snapshot (inputs untouched). Counters and bucket
    counts add; gauges take the delta's value."""
    out = {
        "counters": dict(agg.get("counters", {})),
        "gauges": dict(agg.get("gauges", {})),
        "histograms": {k: {**h, "counts": list(h["counts"])}
                       for k, h in agg.get("histograms", {}).items()},
    }
    for k, v in delta.get("counters", {}).items():
        out["counters"][k] = out["counters"].get(k, 0) + v
    out["gauges"].update(delta.get("gauges", {}))
    for k, h in delta.get("histograms", {}).items():
        a = out["histograms"].get(k)
        if a is None or a["lo"] != h["lo"] or a["n"] != h["n"]:
            # unseen family (or a layout change across versions):
            # the delta becomes the aggregate
            out["histograms"][k] = {**h, "counts": list(h["counts"])}
            continue
        a["counts"] = [x + y for x, y in zip(a["counts"], h["counts"])]
        a["count"] += h["count"]
        a["sum"] += h["sum"]
    return out


class RateWindow:
    """Bounded ring of ``(t, cumulative totals)`` interval snapshots;
    rates are ``(newest - oldest) / dt`` over the points still inside
    the window — a sliding-window derivative, immune to the lifetime
    dilution a totals/uptime quotient suffers. Not thread-safe: the
    owner (the master, under its lock) serializes access."""

    def __init__(self, window_secs: float, maxlen: int = 512):
        self.window = float(window_secs)
        # minimum spacing between RETAINED points: notes arriving
        # faster than window/(maxlen/2) replace the newest point
        # instead of appending, so the deque always spans the full
        # window no matter the note rate — the master feeds the
        # cluster window once per heartbeat PER RANK, which at fleet
        # size would otherwise shrink the effective window to
        # maxlen/(2N) beats with no warning
        self._min_dt = self.window / (maxlen / 2)
        self._points: collections.deque = collections.deque(maxlen=maxlen)

    def note(self, t: float, totals: dict[str, float]) -> None:
        pts = self._points
        if len(pts) >= 2 and t - pts[-2][0] < self._min_dt:
            pts[-1] = (t, dict(totals))     # coalesce: keep freshest
        else:
            pts.append((t, dict(totals)))
        cutoff = t - self.window
        while len(pts) > 2 and pts[0][0] < cutoff:
            pts.popleft()

    def rates(self) -> dict[str, float]:
        """``{key}_per_sec`` for every key in the newest totals; 0.0
        until the window holds two points."""
        if len(self._points) < 2:
            keys = self._points[-1][1] if self._points else {}
            return {f"{k}_per_sec": 0.0 for k in keys}
        t0, first = self._points[0]
        t1, last = self._points[-1]
        dt = t1 - t0
        if dt <= 0:
            return {f"{k}_per_sec": 0.0 for k in last}
        return {f"{k}_per_sec": (last.get(k, 0) - first.get(k, 0)) / dt
                for k in last}


# ----------------------------------------------------------------------
# Prometheus text-format rendering (the /metrics endpoint)
# ----------------------------------------------------------------------
_STATS_COUNTER_KEYS = ("calls", "bytes_sent", "bytes_recv", "chunks",
                       "keys", "retries", "reconnects", "aborts_seen",
                       "wire_bytes_tcp", "wire_bytes_shm")
_STATS_PHASE_KEYS = ("wire_seconds", "reduce_seconds",
                     "serialize_seconds")


def _esc(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _hist_lines(out: list[str], metric: str, labels: str, h: dict) -> None:
    cum = 0
    edges = bucket_edges(h["lo"], h["n"])
    sep = "," if labels else ""
    for i, c in enumerate(h["counts"]):
        cum += c
        le = _fmt(edges[i]) if i < h["n"] else "+Inf"
        out.append(f'{metric}_bucket{{{labels}{sep}le="{le}"}} {cum}')
    out.append(f"{metric}_sum{{{labels}}} {_fmt(float(h['sum']))}"
               if labels else f"{metric}_sum {_fmt(float(h['sum']))}")
    out.append(f"{metric}_count{{{labels}}} {h['count']}"
               if labels else f"{metric}_count {h['count']}")


def to_prometheus(doc: dict) -> str:
    """Render a master metrics document (``Master.metrics_doc``) as
    Prometheus text format 0.0.4: per-rank and cluster-aggregate
    counter series, cluster-folded latency/frame histograms, and the
    windowed rate gauges. Every metric family is emitted as ONE
    contiguous block (the format requires it — strict parsers like
    promtool reject a family that reappears after another metric), so
    samples are collected per family first and ranks vary inside the
    block."""
    whos = [*sorted(doc.get("ranks", {}), key=int)]
    stats_of = {r: doc["ranks"][r].get("stats", {}) for r in whos}
    stats_of["cluster"] = doc.get("cluster", {}).get("stats", {})

    out: list[str] = []
    out.append("# TYPE mp4j_ranks_reporting gauge")
    out.append(f"mp4j_ranks_reporting {len(whos)}")
    out.append("# TYPE mp4j_slave_num gauge")
    out.append(f"mp4j_slave_num {doc.get('slave_num', 0)}")

    for key in _STATS_COUNTER_KEYS:
        block = []
        for who in [*whos, "cluster"]:
            for family in sorted(stats_of[who]):
                v = stats_of[who][family].get(key, 0)
                if v:
                    block.append(
                        f'mp4j_{key}_total{{rank="{_esc(who)}",'
                        f'collective="{_esc(family)}"}} '
                        f"{_fmt(float(v))}")
        if block:
            out.append(f"# TYPE mp4j_{key}_total counter")
            out.extend(block)
    phase_block = []
    for who in [*whos, "cluster"]:
        for family in sorted(stats_of[who]):
            for key in _STATS_PHASE_KEYS:
                v = stats_of[who][family].get(key, 0.0)
                if v:
                    phase_block.append(
                        f'mp4j_phase_seconds_total{{rank="{_esc(who)}",'
                        f'collective="{_esc(family)}",'
                        f'phase="{key[:-len("_seconds")]}"}} '
                        f"{_fmt(float(v))}")
    if phase_block:
        out.append("# TYPE mp4j_phase_seconds_total counter")
        out.extend(phase_block)

    out.append("# TYPE mp4j_rank_seq gauge")
    for r in whos:
        prog = doc["ranks"][r].get("progress", {})
        out.append(f'mp4j_rank_seq{{rank="{_esc(r)}"}} '
                   f"{prog.get('seq', 0)}")
    out.append("# TYPE mp4j_heartbeat_age_seconds gauge")
    for r in whos:
        out.append(f'mp4j_heartbeat_age_seconds{{rank="{_esc(r)}"}} '
                   f"{_fmt(float(doc['ranks'][r].get('age', 0.0)))}")
    # per-rank rate gauges, one family (= one rate key) per block
    rate_keys = sorted({k for r in whos
                        for k in doc["ranks"][r].get("rates", {})})
    for k in rate_keys:
        out.append(f"# TYPE mp4j_rank_{k} gauge")
        for r in whos:
            rates = doc["ranks"][r].get("rates", {})
            if k in rates:
                out.append(f'mp4j_rank_{k}{{rank="{_esc(r)}"}} '
                           f"{_fmt(float(rates[k]))}")

    for k, v in sorted(doc.get("cluster", {}).get("rates", {}).items()):
        out.append(f"# TYPE mp4j_cluster_{k} gauge")
        out.append(f"mp4j_cluster_{k} {_fmt(float(v))}")

    # audit plane: divergence counter + verification
    # watermark — present whenever the master carries an auditor (the
    # series stay at 0 unless slaves run MP4J_AUDIT=verify|capture,
    # so dashboards can alert on `> 0` unconditionally)
    audit = doc.get("cluster", {}).get("audit")
    if audit is not None:
        out.append("# TYPE mp4j_audit_divergences_total counter")
        out.append("mp4j_audit_divergences_total "
                   f"{int(audit.get('divergences', 0))}")
        out.append("# TYPE mp4j_audit_verified_seqs gauge")
        out.append("mp4j_audit_verified_seqs "
                   f"{int(audit.get('verified_total', 0))}")
        out.append("# TYPE mp4j_audit_verified_seq_watermark gauge")
        out.append("mp4j_audit_verified_seq_watermark "
                   f"{int(audit.get('verified_seq', 0))}")

    # elastic membership: replacement/shrink counters and
    # the warm-spare gauge — present whenever the master carries a
    # membership log (they stay 0 for non-elastic jobs, so dashboards
    # can alert on growth unconditionally)
    ms = doc.get("cluster", {}).get("membership")
    if ms is not None:
        out.append("# TYPE mp4j_replacements_total counter")
        out.append(
            f"mp4j_replacements_total {int(ms.get('replacements', 0))}")
        out.append("# TYPE mp4j_shrinks_total counter")
        out.append(f"mp4j_shrinks_total {int(ms.get('shrinks', 0))}")
        out.append("# TYPE mp4j_spares_available gauge")
        out.append(
            f"mp4j_spares_available {int(ms.get('spares_available', 0))}")

    # durable-sink series: per-rank registry counters named
    # sink/<what> plus the drain-lag gauge; a cluster total per
    # counter so dashboards can alert on drop growth fleet-wide. The
    # series exist whenever a rank arms MP4J_SINK_DIR and stay absent
    # otherwise (no zero-noise for sinkless jobs).
    for key, metric in (("sink/bytes", "mp4j_sink_bytes_total"),
                        ("sink/records", "mp4j_sink_records_total"),
                        ("sink/dropped_records",
                         "mp4j_sink_dropped_records_total")):
        block = []
        total = 0.0
        for r in whos:
            v = doc["ranks"][r].get("counters", {}).get(key)
            if v:
                total += v
                block.append(f'{metric}{{rank="{_esc(r)}"}} '
                             f"{_fmt(float(v))}")
        if block:
            block.append(f'{metric}{{rank="cluster"}} '
                         f"{_fmt(float(total))}")
            out.append(f"# TYPE {metric} counter")
            out.extend(block)
    lag_block = []
    for r in whos:
        g = doc["ranks"][r].get("gauges", {}).get("sink/lag_secs")
        if g is not None:
            lag_block.append(
                f'mp4j_sink_lag_seconds{{rank="{_esc(r)}"}} '
                f"{_fmt(float(g))}")
    if lag_block:
        out.append("# TYPE mp4j_sink_lag_seconds gauge")
        out.extend(lag_block)

    # nonblocking-collective gauge: how many collectives
    # each rank's scheduler currently holds outstanding, plus a
    # cluster sum; present only for ranks that went async (no
    # zero-noise for fully blocking jobs)
    out_block = []
    total_out = 0.0
    for r in whos:
        g = doc["ranks"][r].get("gauges", {}).get("async/outstanding")
        if g is not None:
            total_out += float(g)
            out_block.append(
                f'mp4j_outstanding_collectives{{rank="{_esc(r)}"}} '
                f"{_fmt(float(g))}")
    if out_block:
        out_block.append(
            f'mp4j_outstanding_collectives{{rank="cluster"}} '
            f"{_fmt(total_out)}")
        out.append("# TYPE mp4j_outstanding_collectives gauge")
        out.extend(out_block)

    # health plane: per-rank verdict gauge, per-(rank,
    # detector) alert counter, the evict recommendation count, and the
    # online dominator's onset counter + window-share gauge — present
    # whenever the master runs the health engine (MP4J_HEALTH=1, the
    # default), absent entirely when disabled (no zero-noise)
    hl = doc.get("cluster", {}).get("health")
    if hl is not None:
        out.append("# TYPE mp4j_rank_health_state gauge")
        for r, e in sorted((hl.get("ranks") or {}).items(),
                           key=lambda kv: int(kv[0])):
            out.append(f'mp4j_rank_health_state{{rank="{_esc(r)}"}} '
                       f"{int(e.get('state_code', 0))}")
        alert_block = []
        for r, e in sorted((hl.get("ranks") or {}).items(),
                           key=lambda kv: int(kv[0])):
            for det, n in sorted((e.get("alerts") or {}).items()):
                if n:
                    alert_block.append(
                        f'mp4j_alerts_total{{rank="{_esc(r)}",'
                        f'detector="{_esc(det)}"}} {int(n)}')
        if alert_block:
            out.append("# TYPE mp4j_alerts_total counter")
            out.extend(alert_block)
        out.append("# TYPE mp4j_evict_recommended gauge")
        out.append(f"mp4j_evict_recommended "
                   f"{len(hl.get('evict_recommended') or ())}")
        dom = hl.get("dominator") or {}
        out.append("# TYPE mp4j_straggler_onsets_total counter")
        out.append(f"mp4j_straggler_onsets_total "
                   f"{int(dom.get('onsets', 0))}")
        shares = dom.get("shares") or {}
        if shares:
            out.append("# TYPE mp4j_critpath_dominator gauge")
            for r, s in sorted(shares.items(),
                               key=lambda kv: int(kv[0])):
                out.append(
                    f'mp4j_critpath_dominator{{rank="{_esc(r)}"}} '
                    f"{_fmt(float(s))}")

    # self-tuning data plane: per-rank applied-decision
    # counters (from the slave registry's tuner/decisions) plus the
    # master controller's demotion counter and trip gauge — present
    # whenever the master runs with MP4J_TUNER != off
    tun_block = []
    tun_total = 0.0
    for r in whos:
        v = doc["ranks"][r].get("counters", {}).get("tuner/decisions")
        if v:
            tun_total += v
            tun_block.append(
                f'mp4j_tuner_decisions_total{{rank="{_esc(r)}"}} '
                f"{_fmt(float(v))}")
    if tun_block:
        tun_block.append(
            f'mp4j_tuner_decisions_total{{rank="cluster"}} '
            f"{_fmt(tun_total)}")
        out.append("# TYPE mp4j_tuner_decisions_total counter")
        out.extend(tun_block)
    tun = doc.get("cluster", {}).get("tuner")
    if tun is not None:
        out.append("# TYPE mp4j_tuner_demotions_total counter")
        out.append(f"mp4j_tuner_demotions_total "
                   f"{int(tun.get('demotions', 0))}")
        out.append("# TYPE mp4j_tuner_tripped gauge")
        out.append(f"mp4j_tuner_tripped "
                   f"{1 if tun.get('tripped') else 0}")

    # serve plane: per-rank request/batch/cache counters
    # (frontend families, worker rounds fold into the same names) plus
    # the frontend's sliding-window QPS gauge — present only for
    # serving jobs (no zero-noise for pure training jobs)
    for key, metric in (
            ("serve/requests", "mp4j_serve_requests_total"),
            ("serve/batches", "mp4j_serve_batches_total"),
            ("serve/cache_hits", "mp4j_serve_cache_hits_total"),
            ("serve/cache_misses", "mp4j_serve_cache_misses_total"),
            ("serve/degraded_batches",
             "mp4j_serve_degraded_batches_total")):
        block = []
        total = 0.0
        for r in whos:
            v = doc["ranks"][r].get("counters", {}).get(key)
            if v:
                total += v
                block.append(f'{metric}{{rank="{_esc(r)}"}} '
                             f"{_fmt(float(v))}")
        if block:
            block.append(f'{metric}{{rank="cluster"}} '
                         f"{_fmt(float(total))}")
            out.append(f"# TYPE {metric} counter")
            out.extend(block)
    srv = doc.get("cluster", {}).get("serve")
    if srv is not None and srv.get("active"):
        out.append("# TYPE mp4j_serve_qps gauge")
        out.append(f"mp4j_serve_qps {_fmt(float(srv.get('qps', 0.0)))}")

    # autoscaler: per-action dispatch counters + the
    # circuit-breaker gauge — present whenever the master runs a
    # controller (MP4J_AUTOSCALE=observe|act), absent entirely when
    # off (no zero-noise; `off` is today's behavior bit-for-bit)
    asc = doc.get("cluster", {}).get("autoscale")
    if asc is not None:
        out.append("# TYPE mp4j_autoscale_actions_total counter")
        for action, n in sorted((asc.get("actions") or {}).items()):
            out.append(
                f'mp4j_autoscale_actions_total{{action="{_esc(action)}"'
                f"}} {int(n)}")
        out.append("# TYPE mp4j_autoscale_tripped gauge")
        out.append(f"mp4j_autoscale_tripped "
                   f"{1 if asc.get('tripped') else 0}")

    out.append("# TYPE mp4j_collective_latency_seconds histogram")
    hists = doc.get("cluster", {}).get("histograms", {})
    for name in sorted(hists):
        h = hists[name]
        if name.startswith("latency/"):
            _hist_lines(out, "mp4j_collective_latency_seconds",
                        f'collective="{_esc(name[len("latency/"):])}"', h)
    out.append("# TYPE mp4j_frame_bytes histogram")
    for name in sorted(hists):
        # transport-labelled families (frame_bytes/tcp, frame_bytes/
        # shm) next to the legacy unlabelled series, all one
        # contiguous mp4j_frame_bytes block
        if name == "frame_bytes":
            _hist_lines(out, "mp4j_frame_bytes", "", hists[name])
        elif name.startswith("frame_bytes/"):
            _hist_lines(
                out, "mp4j_frame_bytes",
                f'transport="{_esc(name[len("frame_bytes/"):])}"',
                hists[name])
    return "\n".join(out) + "\n"
