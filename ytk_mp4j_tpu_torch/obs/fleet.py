"""mp4j-fleet — cross-job fleet observability.

A copy of ``ytk_mp4j_tpu/obs/fleet.py``, with its imports re-rooted at the
port; it imports nothing of the JAX package.

Every observability plane below this one ends at ONE master and ONE
job. Production traffic is many concurrent jobs sharing hosts and
links — and before any federation broker can *arbitrate* spares and
links between jobs, something has to *see* across them. This module is
that read-only fleet plane:

- :class:`FleetPoller` scrapes N job masters' ``/metrics.json`` +
  ``/health.json`` control surfaces (the endpoints built "for
  EXTERNAL orchestrators") on a cadence, with a bounded timeout on
  every request and a per-job staleness/backoff state machine —
  ``LIVE -> STALE -> GONE`` — so a hung or dead master degrades its
  OWN row and never wedges or crashes the poller. A master restart is
  detected as a ``job_id`` change at the same URL (the master's
  identity stamp), never guessed from heuristics.
- :func:`job_summary` / :func:`fold_fleet` fold the per-job documents
  into a **host- and link-centric fleet model** keyed on the roster
  host fingerprints: which jobs co-reside on which host,
  each job's wire bytes and live byte rate on that host, its per-link
  tuner decisions there, a health-ladder tally, and the cluster
  aggregate rates.
- :func:`detect_contention` flags the single-tenant blind spot the
  ROADMAP names: two jobs sharing a host both see "the link is slow"
  and neither yields. Detected as **overlapping busy windows** (both
  jobs moving bytes on the same host fingerprint in the same poll)
  plus **simultaneous slow-link verdicts** (each job's tuner applied
  per-link decisions there — the verdict a single-tenant tuner
  reaches when its link underperforms).
- :class:`FleetSink` lands fleet history durably using the crc-framed
  segment format of :mod:`ytk_mp4j_tpu_torch.obs.sink` (same torn-tail
  recovery guarantees, same rotation/eviction budget discipline), and
  :func:`fleet_report` reconstructs the merged **fleet event
  timeline** — job up/stale/gone/restart, per-rank health
  transitions, autoscaler actions, contention onsets — offline from a
  fleet sink directory (``mp4j-scope fleet-report``).

Obs discipline: imports nothing from ``comm`` — the poller observes
jobs strictly through their public HTTP control surfaces, exactly like
an external orchestrator would.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

from ytk_mp4j_tpu_torch.obs import sink as sink_mod
from ytk_mp4j_tpu_torch.utils import tuning

LIVE = "LIVE"
STALE = "STALE"
GONE = "GONE"
# GONE follows STALE at this multiple of MP4J_FLEET_STALE_SECS: one
# missed scrape window is a blip, three is a corpse
GONE_FACTOR = 3.0
# consecutive-failure backoff cap, in poll periods: a dead master is
# re-probed often enough to catch a restart, rarely enough not to
# burn the sweep budget on connection timeouts
_BACKOFF_CAP_POLLS = 8.0
# bounded in-memory event ring (the durable copy rides FleetSink)
_EVENT_CAP = 4096


def normalize_url(base: str) -> str:
    """Scheme-optional like ``mp4j-scope live``: ``host:port`` means
    ``http://host:port``."""
    if "://" not in base:
        base = "http://" + base
    return base.rstrip("/")


# ---------------------------------------------------------------------
# pure folds: per-job documents -> fleet model
# ---------------------------------------------------------------------
def _rank_wire_bytes(info: dict) -> int:
    return int(sum(e.get("bytes_sent", 0) + e.get("bytes_recv", 0)
                   for e in (info.get("stats") or {}).values()))


def _slow_links(tuner_doc: dict | None, rank: str) -> list[str]:
    """The tuner's applied per-link decisions for one rank, as
    ``"rank->peer"`` tokens. An applied decision (a non-static chunk
    size or an explicit compress verdict) IS the single-tenant
    "this link is slow/underperforming" verdict the contention
    detector cross-references between jobs."""
    t = (tuner_doc or {}).get("ranks", {}).get(rank) or {}
    out = []
    for peer, dec in sorted((t.get("applied") or {}).items(),
                            key=lambda kv: str(kv[0])):
        if dec and (dec.get("chunk_bytes") is not None
                    or dec.get("compress") is not None):
            out.append(f"{rank}->{peer}")
    return out


def job_summary(metrics_doc: dict, health_doc: dict | None = None
                ) -> dict:
    """Fold ONE job's control documents into its fleet row: identity,
    aggregate rates, retry total, health-ladder tally, and the
    host-centric view (ranks / wire bytes / live byte rate / slow
    links per roster host fingerprint). Pure — the poller and the
    synthetic-document tests share it."""
    ranks = metrics_doc.get("ranks") or {}
    cl = metrics_doc.get("cluster") or {}
    rates = cl.get("rates") or {}
    tuner = cl.get("tuner")
    hosts: dict[str, dict] = {}
    retries = 0
    wire_bytes = 0
    for r, info in ranks.items():
        fp = str(info.get("host_fp") or "")
        h = hosts.setdefault(fp, {"ranks": [], "wire_bytes": 0,
                                  "bytes_per_sec": 0.0,
                                  "slow_links": []})
        h["ranks"].append(int(r))
        rb = _rank_wire_bytes(info)
        h["wire_bytes"] += rb
        wire_bytes += rb
        h["bytes_per_sec"] += float(
            (info.get("rates") or {}).get("bytes_per_sec", 0.0))
        h["slow_links"].extend(_slow_links(tuner, str(r)))
        retries += int(sum(e.get("retries", 0)
                           for e in (info.get("stats") or {}).values()))
    for h in hosts.values():
        h["ranks"].sort()
    # health-ladder tally from /health.json (falls back to the metrics
    # doc's cluster.health section — same schema — when the health
    # endpoint was unreachable but metrics was not)
    hdoc = health_doc if health_doc is not None else cl.get("health")
    hstates = {str(r): e.get("state", "HEALTHY")
               for r, e in ((hdoc or {}).get("ranks") or {}).items()}
    ladder: dict[str, int] = {}
    for s in hstates.values():
        ladder[s] = ladder.get(s, 0) + 1
    asc = cl.get("autoscale") or {}
    # serve summary: carried whole so the fleet view can
    # render serve jobs distinctly (QPS cell); None for batch jobs
    serve = cl.get("serve") if (cl.get("serve") or {}).get("active") \
        else None
    return {
        "job_id": str(metrics_doc.get("job_id") or ""),
        "started_wall": metrics_doc.get("started_wall"),
        "roster_gen": int(metrics_doc.get("roster_gen") or 0),
        "slave_num": int(metrics_doc.get("slave_num") or 0),
        "ranks_reporting": len(ranks),
        "bytes_per_sec": float(rates.get("bytes_per_sec", 0.0)),
        "collectives_per_sec": float(
            rates.get("collectives_per_sec", 0.0)),
        "keys_per_sec": float(rates.get("keys_per_sec", 0.0)),
        "wire_bytes": wire_bytes,
        "retries": retries,
        "hosts": hosts,
        "health": {
            "states": ladder,
            "by_rank": hstates,
            "alerts_total": int((hdoc or {}).get("alerts_total") or 0),
            "evict_recommended": list(
                (hdoc or {}).get("evict_recommended") or ()),
        },
        "autoscale_actions": int(
            sum((asc.get("actions") or {}).values())
            + sum((asc.get("observed") or {}).values())),
        "serve": serve,
    }


def detect_contention(hosts: dict[str, dict],
                      busy_bytes_per_sec: float = 0.0) -> list[dict]:
    """Cross-job contention rows from a folded host map
    (``fold_fleet``'s ``hosts``): a host fingerprint where at least
    two jobs show **overlapping busy windows** (live byte rate above
    ``busy_bytes_per_sec`` in the same poll) and at least two of
    those busy jobs **simultaneously hold slow-link verdicts** there
    (tuner applied decisions). That conjunction is the single-tenant
    blind spot: each job's tuner correctly concluded its own link is
    slow, and none of them can see that the *other tenant* is why."""
    out = []
    for fp in sorted(hosts):
        if not fp:
            continue        # "" = fingerprint opt-out, not a host
        jobs = hosts[fp].get("jobs") or {}
        busy = {jid: j for jid, j in jobs.items()
                if float(j.get("bytes_per_sec", 0.0))
                > busy_bytes_per_sec}
        slow = {jid: j["slow_links"] for jid, j in busy.items()
                if j.get("slow_links")}
        if len(busy) >= 2 and len(slow) >= 2:
            out.append({"host_fp": fp,
                        "jobs": sorted(busy),
                        "slow": {jid: list(v)
                                 for jid, v in sorted(slow.items())}})
    return out


def fold_fleet(jobstates: dict[str, dict],
               busy_bytes_per_sec: float = 0.0) -> dict:
    """The fleet model: fold per-URL poll states (``{"url", "state",
    "age", "summary"|None}``) into per-job rows, the host-centric
    co-residency map, contention rows and the aggregate. Pure — the
    poller feeds it live states, tests feed it synthetic ones.

    A STALE job's last summary still participates in the host map
    (its ranks have not provably left the host — that is what STALE
    means), but only LIVE jobs count toward the aggregate rates and
    the busy side of contention: a frozen byte rate from a wedged
    master must not manufacture phantom load."""
    hosts: dict[str, dict] = {}
    agg = {"jobs": len(jobstates), "live": 0, "ranks": 0,
           "bytes_per_sec": 0.0, "collectives_per_sec": 0.0}
    for key in sorted(jobstates):
        st = jobstates[key]
        s = st.get("summary")
        if s is None:
            continue
        live = st.get("state") == LIVE
        if live:
            agg["live"] += 1
            agg["ranks"] += s["ranks_reporting"]
            agg["bytes_per_sec"] += s["bytes_per_sec"]
            agg["collectives_per_sec"] += s["collectives_per_sec"]
        jid = s["job_id"] or st.get("url") or key
        for fp, h in (s.get("hosts") or {}).items():
            row = hosts.setdefault(str(fp), {"jobs": {}})
            row["jobs"][jid] = {
                "url": st.get("url", key),
                "state": st.get("state"),
                "ranks": list(h["ranks"]),
                "wire_bytes": int(h["wire_bytes"]),
                # a non-LIVE job's rate is history, not load (above)
                "bytes_per_sec": (float(h["bytes_per_sec"])
                                  if live else 0.0),
                "slow_links": list(h["slow_links"]),
            }
    shared = sorted(fp for fp, row in hosts.items()
                    if fp and len(row["jobs"]) >= 2)
    return {
        "jobs": {key: {"url": st.get("url", key),
                       "state": st.get("state"),
                       "age": float(st.get("age", 0.0)),
                       "summary": st.get("summary")}
                 for key, st in jobstates.items()},
        "hosts": hosts,
        "shared_hosts": shared,
        "contention": detect_contention(hosts, busy_bytes_per_sec),
        "aggregate": agg,
    }


# ---------------------------------------------------------------------
# the poller
# ---------------------------------------------------------------------
class FleetPoller:
    """Scrape N job masters on a cadence and maintain the fleet model.

    Never crashes, never hangs: every fetch carries an explicit
    bounded ``timeout`` (mp4j-lint R27 territory), every per-job
    failure is absorbed into that job's ``LIVE -> STALE -> GONE``
    state machine with capped exponential backoff, and
    :meth:`poll_once` is exception-free by construction (scrape-side
    surprises are counted in ``scrape_errors``, fold-side code is
    pure). A master that comes back under the SAME URL with a NEW
    ``job_id`` is a restart (``job_restart`` event), not a
    continuation.

    ``fetch`` is the injection seam for deterministic tests: a
    callable ``(url) -> (metrics_doc, health_doc)`` raising on
    failure. The default fetches both documents over HTTP. ``now``
    likewise injects the monotonic clock.
    """

    def __init__(self, urls, *, poll_secs: float | None = None,
                 stale_secs: float | None = None,
                 timeout: float | None = None,
                 sink: "FleetSink | None" = None,
                 fetch=None, now=time.monotonic):
        self.urls = [normalize_url(u) for u in urls]
        self.poll_secs = (tuning.fleet_poll_secs()
                          if poll_secs is None else float(poll_secs))
        self.stale_secs = (tuning.fleet_stale_secs()
                           if stale_secs is None else float(stale_secs))
        # per-request bound: never longer than the staleness budget
        # (a scrape still in flight when its job goes STALE is the
        # wedge this plane exists to avoid), never degenerate
        self.timeout = (max(0.1, min(self.poll_secs, 5.0,
                                     self.stale_secs / 2))
                        if timeout is None else float(timeout))
        self.sink = sink
        self._fetch = fetch if fetch is not None else self._http_fetch
        self._now = now
        self.scrape_errors = 0          # absorbed per-job failures
        self._lock = threading.Lock()
        t0 = self._now()
        self._jobs: dict[str, dict] = {
            u: {"url": u, "state": STALE, "job_id": None,
                "summary": None, "last_ok": None, "born": t0,
                "failures": 0, "next_try": t0, "last_error": None}
            for u in self.urls}
        self._events: list[dict] = []
        self._contended: set[str] = set()
        self._model: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- scraping ------------------------------------------------------
    def _http_fetch(self, url: str) -> tuple[dict, dict | None]:
        with urllib.request.urlopen(url + "/metrics.json",
                                    timeout=self.timeout) as resp:
            mdoc = json.load(resp)
        try:
            with urllib.request.urlopen(url + "/health.json",
                                        timeout=self.timeout) as resp:
                hdoc = json.load(resp)
        except Exception:       # noqa: BLE001 - metrics alone suffices
            # (an old master without the health endpoint, a scrape
            # racing shutdown): the fold falls back to the metrics
            # doc's cluster.health section
            hdoc = None
        return mdoc, hdoc if isinstance(hdoc, dict) else None

    def _event(self, kind: str, job: dict, msg: str,
               events_out: list[dict]) -> None:
        ev = {
            # wall stamp: fleet timelines merge across machines, like
            # every sink artifact
            # mp4j-lint: disable=R11 (event timestamp, not a duration)
            "wall": time.time(),
            "kind": kind, "url": job["url"],
            "job_id": job.get("job_id"), "msg": msg}
        self._events.append(ev)
        del self._events[:-_EVENT_CAP]
        events_out.append(ev)

    def _note_success(self, job: dict, mdoc: dict, hdoc,
                      events_out: list[dict]) -> None:
        summary = job_summary(mdoc, hdoc)
        jid = summary["job_id"] or None
        prev = job.get("job_id")
        prev_summary = job.get("summary")
        if prev is None and jid is not None and prev_summary is None:
            self._event("job_up", {**job, "job_id": jid},
                        f"job {jid} up at {job['url']} "
                        f"({summary['slave_num']} ranks)", events_out)
        elif prev is not None and jid is not None and jid != prev:
            self._event("job_restart", {**job, "job_id": jid},
                        f"{job['url']}: job id {prev} -> {jid} "
                        "(master restarted)", events_out)
        elif job["state"] != LIVE:
            self._event("job_back", {**job, "job_id": jid},
                        f"job {jid} reachable again "
                        f"(was {job['state']})", events_out)
        # per-rank health transitions between consecutive scrapes of
        # the SAME job incarnation
        if prev_summary is not None and jid == prev:
            old = prev_summary["health"]["by_rank"]
            for r, s in sorted(summary["health"]["by_rank"].items(),
                               key=lambda kv: kv[0]):
                o = old.get(r)
                if o is not None and o != s:
                    self._event("health", job,
                                f"job {jid}: rank {r} {o}->{s}",
                                events_out)
            if (summary["autoscale_actions"]
                    > prev_summary["autoscale_actions"]):
                self._event("autoscale", job,
                            f"job {jid}: autoscaler acted "
                            f"({summary['autoscale_actions']} total)",
                            events_out)
        job.update(state=LIVE, job_id=jid, summary=summary,
                   last_ok=self._now(), failures=0, last_error=None,
                   next_try=self._now())

    def _note_failure(self, job: dict, err: Exception,
                      events_out: list[dict]) -> None:
        self.scrape_errors += 1
        job["failures"] += 1
        job["last_error"] = repr(err)
        # capped exponential backoff: a dead master costs one bounded
        # connect attempt per backoff window, not per sweep
        delay = min(self.poll_secs * (2.0 ** (job["failures"] - 1)),
                    self.poll_secs * _BACKOFF_CAP_POLLS)
        job["next_try"] = self._now() + delay

    def _age(self, job: dict) -> float:
        ref = job["last_ok"] if job["last_ok"] is not None \
            else job["born"]
        return max(0.0, self._now() - ref)

    def _degrade(self, job: dict, events_out: list[dict]) -> None:
        """Advance the staleness ladder from the age of the last
        successful scrape — runs every sweep, backoff or not, so a
        job in deep backoff still degrades on schedule."""
        age = self._age(job)
        if age > self.stale_secs * GONE_FACTOR:
            if job["state"] != GONE:
                self._event("job_gone", job,
                            f"job {job.get('job_id') or job['url']} "
                            f"GONE (no scrape for {age:.1f}s)",
                            events_out)
                job["state"] = GONE
        elif age > self.stale_secs:
            if job["state"] == LIVE:
                self._event("job_stale", job,
                            f"job {job.get('job_id') or job['url']} "
                            f"STALE (no scrape for {age:.1f}s)",
                            events_out)
                job["state"] = STALE

    # -- one sweep -----------------------------------------------------
    def poll_once(self) -> dict:
        """One scrape sweep over every URL + fold + event detection +
        durable append. Returns the fresh fleet model. Never raises —
        the chaos contract: SIGKILL of an entire job mid-poll shows
        up as that job's STALE->GONE walk, zero exceptions here."""
        events_out: list[dict] = []
        with self._lock:
            for url in self.urls:
                job = self._jobs[url]
                if self._now() >= job["next_try"]:
                    try:
                        mdoc, hdoc = self._fetch(url)
                        if not isinstance(mdoc, dict):
                            raise ValueError(
                                f"{url}: non-object metrics document")
                        self._note_success(job, mdoc, hdoc, events_out)
                    except Exception as e:  # noqa: BLE001 - absorbed
                        # into the state machine; ANY scrape-side
                        # surprise (refused, reset, timeout, torn
                        # JSON, schema garbage) is a staleness fact
                        # about that job, not a poller fatal
                        self._note_failure(job, e, events_out)
                self._degrade(job, events_out)
            model = fold_fleet(
                {u: {"url": j["url"], "state": j["state"],
                     "age": self._age(j), "summary": j["summary"]}
                 for u, j in self._jobs.items()})
            now_contended = {c["host_fp"] for c in model["contention"]}
            for fp in sorted(now_contended - self._contended):
                row = next(c for c in model["contention"]
                           if c["host_fp"] == fp)
                self._event(
                    "contention_on", {"url": "", "job_id": None},
                    f"host {fp}: cross-job contention between "
                    f"{', '.join(row['jobs'])} (slow links: "
                    + "; ".join(f"{j}: {','.join(v)}"
                                for j, v in row["slow"].items())
                    + ")", events_out)
            for fp in sorted(self._contended - now_contended):
                self._event("contention_off", {"url": "",
                                               "job_id": None},
                            f"host {fp}: contention cleared",
                            events_out)
            self._contended = now_contended
            self._model = model
        if self.sink is not None:
            for ev in events_out:
                self.sink.append({"t": "fleet_event", **ev})
            self.sink.append({
                "t": "fleet",
                # mp4j-lint: disable=R11 (snapshot timestamp)
                "wall": time.time(),
                "jobs": {k: {"url": v["url"], "state": v["state"],
                             "age": round(v["age"], 3),
                             "summary": v["summary"]}
                         for k, v in model["jobs"].items()},
                "shared_hosts": model["shared_hosts"],
                "contention": model["contention"],
                "aggregate": model["aggregate"]})
        return model

    def model(self) -> dict | None:
        """The last folded fleet model (None before the first sweep)."""
        with self._lock:
            return self._model

    def events(self) -> list[dict]:
        """The bounded in-memory event tail, oldest first."""
        with self._lock:
            return list(self._events)

    def states(self) -> dict[str, str]:
        """``{url: LIVE|STALE|GONE}`` right now."""
        with self._lock:
            return {u: j["state"] for u, j in self._jobs.items()}

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "FleetPoller":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="mp4j-fleet-poller")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_secs):
            self.poll_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        if self.sink is not None:
            self.sink.close()


# ---------------------------------------------------------------------
# durable fleet history
# ---------------------------------------------------------------------
class FleetSink:
    """Durable fleet history: the poller's snapshots and events as
    crc-framed records in rotating segment files under ONE directory
    (the :mod:`ytk_mp4j_tpu_torch.obs.sink` framing — same torn-tail
    recovery: a ``kill -9`` mid-append tears at most the single frame
    being written, and :func:`read_fleet` recovers every prior
    record). Oldest-segment eviction bounds the directory at
    ``budget_bytes`` no matter how long the fleet is watched.

    Best-effort like the per-rank sink: a full disk degrades to
    dropped records (counted in ``dropped_records``), never to a
    poller failure."""

    def __init__(self, root: str, *, budget_bytes: int | None = None):
        self.root = str(root)
        self.budget = (tuning.sink_bytes() if budget_bytes is None
                       else int(budget_bytes))
        self.seg_bytes = max(64 * 1024, self.budget // 8)
        self._lock = threading.Lock()
        self._fh = None
        self._seg_index = 0
        self._seg_size = 0
        self._seg_sizes: dict[str, int] = {}     # basename -> bytes
        self.records_written = 0
        self.bytes_written = 0
        self.dropped_records = 0
        self.last_error: str | None = None

    def append(self, rec: dict) -> None:
        """Append one record frame; never raises (the poller must
        survive a full disk the way a rank's drain thread does)."""
        try:
            frame = sink_mod.encode_record({
                **rec, "v": 1})
            with self._lock:
                fh = self._ensure_segment(len(frame))
                sink_mod._write_all(fh, frame)
                self._seg_size += len(frame)
                self._seg_sizes[os.path.basename(self._seg_path())] = \
                    self._seg_size
                self.bytes_written += len(frame)
                self.records_written += 1
        except Exception as e:      # noqa: BLE001 - telemetry must
            # never fail the observer; see SinkWriter.flush
            with self._lock:
                self.dropped_records += 1
                self.last_error = repr(e)
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None

    def _seg_path(self) -> str:
        return os.path.join(self.root,
                            f"seg_{self._seg_index:08d}.mp4j")

    def _ensure_segment(self, incoming: int):
        """Open segment, rotating + evicting under the budget (the
        SinkWriter discipline, single-directory edition). Caller
        holds the lock."""
        if self._fh is not None and self._seg_size + incoming \
                > self.seg_bytes:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        if self._fh is None:
            os.makedirs(self.root, exist_ok=True)
            if not self._seg_sizes:
                # resume past anything already on disk
                for p in sink_mod.list_segments(self.root):
                    base = os.path.basename(p)
                    try:
                        self._seg_sizes[base] = os.path.getsize(p)
                        idx = int(base[len("seg_"):-len(".mp4j")])
                        self._seg_index = max(self._seg_index, idx + 1)
                    except (OSError, ValueError):
                        continue
            else:
                self._seg_index += 1
            self._evict(incoming)
            # unbuffered append-only segment write — crc-delimited
            # frames, reader tolerates a torn tail (sink precedent)
            # mp4j-lint: disable=R14 (sanctioned segment append path)
            self._fh = open(self._seg_path(), "ab", buffering=0)
            self._seg_size = 0
        return self._fh

    def _evict(self, incoming: int) -> None:
        target = max(self.seg_bytes, self.budget - self.seg_bytes)
        total = sum(self._seg_sizes.values()) + incoming
        active = os.path.basename(self._seg_path())
        for base in sorted(self._seg_sizes):
            if total <= target or base == active:
                break
            try:
                os.remove(os.path.join(self.root, base))
            except OSError:
                break       # can't evict the oldest -> newer ones
                # likely can't go either; keep the accounting honest
            total -= self._seg_sizes.pop(base)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_fleet(root: str) -> dict:
    """Every intact fleet record from a fleet sink directory
    (:func:`ytk_mp4j_tpu_torch.obs.sink.read_dir` — the shared crc-framed
    reader, shared torn-tail guarantees)."""
    return sink_mod.read_dir(root)


def fleet_report(root: str) -> dict:
    """Offline reconstruction from a fleet sink dir: the merged event
    timeline (job up/stale/gone/restart, health transitions,
    autoscaler actions, contention on/off), the jobs ever seen with
    their last-known state, and contention EPISODES (onset..clear
    windows, open-ended when the history ends contended)."""
    doc = read_fleet(root)
    events = [r for r in doc["records"] if r.get("t") == "fleet_event"]
    events.sort(key=lambda e: e.get("wall", 0.0))
    snaps = [r for r in doc["records"] if r.get("t") == "fleet"]
    jobs: dict[str, dict] = {}
    for snap in snaps:          # oldest first: last write wins
        for key, st in (snap.get("jobs") or {}).items():
            s = st.get("summary") or {}
            jobs[key] = {
                "url": st.get("url", key),
                "state": st.get("state"),
                "job_id": s.get("job_id"),
                "slave_num": s.get("slave_num"),
                "roster_gen": s.get("roster_gen"),
                "last_wall": snap.get("wall"),
            }
    episodes: list[dict] = []
    open_eps: dict[str, dict] = {}
    for ev in events:
        host = None
        if ev.get("kind") in ("contention_on", "contention_off"):
            # host fp is the token after "host " in the message
            msg = str(ev.get("msg") or "")
            host = msg.split(":", 1)[0].removeprefix("host ").strip() \
                if msg.startswith("host ") else msg
        if ev.get("kind") == "contention_on" and host is not None:
            open_eps[host] = {"host_fp": host,
                              "onset_wall": ev.get("wall"),
                              "clear_wall": None,
                              "msg": ev.get("msg")}
            episodes.append(open_eps[host])
        elif ev.get("kind") == "contention_off" and host is not None:
            ep = open_eps.pop(host, None)
            if ep is not None:
                ep["clear_wall"] = ev.get("wall")
    return {"events": events, "jobs": jobs, "episodes": episodes,
            "snapshots": len(snaps), "torn": doc["torn"],
            "segments": doc["segments"]}
