"""Rendezvous master — the control plane.

A copy of ``ytk_mp4j_tpu/comm/master.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

The reference runs a master process that slaves connect to: it assigns
ranks, distributes the slave roster (rank -> host:port), serves as the
centralized log sink for ``info()/error()``, coordinates barriers, and
aggregates exit codes at ``close(code)`` (SURVEY.md sections 2, 3a, 3e).

This is that master, rebuilt in Python over the framed-socket transport.
It can run embedded (a thread, for tests and single-host jobs) or as a
CLI: ``python -m ytk_mp4j_tpu_torch.comm.master --port P --slaves N``.

Failure model (a deliberate departure from the reference's
fail-stop scope, SURVEY.md section 5): the slave count is still fixed —
no elastic membership — but transient transport faults are recoverable.
The master drives the epoch-fenced abort protocol (resilience.recovery):
an ABORT_REQ from any rank fans out an abort round, all-rank acks gate
the ``abort_go`` release, and unrecoverable states (dead control
connection, stalled round, exhausted retry budget, watchdog-escalated
barrier stall) fan out ONE terminal abort so every surviving rank
raises the same ``Mp4jFatalError`` within its bounded wait.
``MP4J_MAX_RETRIES=0`` restores the reference's exact fail-stop
contract. Rendezvous keeps its optional timeout.

Observability: slaves piggyback periodic TELEMETRY heartbeats
(``{progress, stats}``, schema in obs.telemetry) on the control
channel; the master keeps a per-rank table, serves cross-rank skew via
:meth:`Master.cluster_stats`, and turns the paper's worst failure mode
— a silent mismatched-schedule deadlock — into a runtime report: a
slave whose bounded collective wait expires ships a DIAGNOSE, and a
barrier generation stalled past ``stall_timeout`` trips the watchdog;
either way the master logs which ranks trail the cluster's max
collective sequence number, where each laggard last was, and how stale
its heartbeat is. Heartbeats ride the control plane only — they can
never block a data-plane exchange.
"""

from __future__ import annotations

import argparse
import http.server
import json
import secrets
import socket
import sys
import threading
import time

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.obs import audit as audit_mod
from ytk_mp4j_tpu_torch.obs import health as health_mod
from ytk_mp4j_tpu_torch.obs import metrics as metrics_mod
from ytk_mp4j_tpu_torch.obs import postmortem as postmortem_mod
from ytk_mp4j_tpu_torch.obs import telemetry as telemetry_mod
from ytk_mp4j_tpu_torch.resilience import autoscaler as autoscaler_mod
from ytk_mp4j_tpu_torch.resilience import membership as membership_mod
from ytk_mp4j_tpu_torch.transport.channel import Channel
from ytk_mp4j_tpu_torch.transport.tcp import TcpChannel
from ytk_mp4j_tpu_torch.utils import stats as stats_mod
from ytk_mp4j_tpu_torch.utils import tuner as tuner_mod
from ytk_mp4j_tpu_torch.utils import tuning

# control-plane message kinds (slave -> master)
REGISTER = "register"
LOG = "log"
BARRIER = "barrier"
CLOSE = "close"
TELEMETRY = "telemetry"   # periodic heartbeat: {progress, stats}
DIAGNOSE = "diagnose"     # a slave's bounded wait expired; report it
ABORT_REQ = "abort_req"   # a collective failed; start an abort round
ABORT_ACK = "abort_ack"   # slave finished tearing down the old epoch
SPARE_PING = "spare_ping"  # an idle warm spare proving liveness
ADOPT_ACK = "adopt_ack"   # a spare finished seeding its adopted rank
MANIFEST = "manifest"     # a survivor's adoption manifest contribution
RESIZE = "resize"         # a rank reached a resize_point() boundary
FENCE_ACK = "fence_ack"   # a rank parked at its collective boundary


class _Slot:
    """One connected slave: its channel, a per-channel send lock
    (master->slave pushes may originate on any serve thread), and a
    MUTABLE rank — a shrink round renumbers survivors, and the serve
    thread must attribute every later message to the rank the slave
    currently holds, not the one it registered with."""

    __slots__ = ("rank", "ch", "lock", "dead", "quiet")

    def __init__(self, rank: int, ch: Channel):
        self.rank = rank
        self.ch = ch
        self.lock = threading.Lock()
        # set when the rank is DECLARED dead while its channel still
        # answers (watchdog escalation): the serve thread must stop
        # attributing this zombie's messages to a rank id that a
        # replacement spare may now legitimately hold
        self.dead = False
        # planned eviction in flight: inbound messages are
        # dropped WITHOUT closing the channel — the victim's rank id
        # already belongs to the adopted spare, but the channel must
        # stay open until the ("evicted",) release lands on it (a
        # dead-style close here would turn the clean Mp4jEvicted into
        # a "master connection lost" fatal on the victim)
        self.quiet = False


class Master:
    """Rank assignment, roster exchange, log sink, barrier, exit codes,
    plus the cluster telemetry table (heartbeats, skew, hang diagnosis)."""

    def __init__(self, slave_num: int, port: int = 0, host: str = "",
                 log_stream=None, timeout: float | None = 120.0,
                 handshake_timeout: float | None = 5.0,
                 stall_timeout: float | None = 60.0,
                 dead_rank_secs: float | None = None,
                 metrics_port: int | None = None,
                 postmortem_dir: str | None = None,
                 sink_dir: str | None = None,
                 elastic: str | None = None,
                 spares: int | None = None,
                 adopt_secs: float | None = None,
                 health: bool | None = None,
                 autoscale: str | None = None,
                 autoscale_cooldown: float | None = None,
                 autoscale_budget: int | None = None,
                 provision_hook=None,
                 provision_cmd: str | None = None,
                 autoscale_tick: float = 0.25,
                 tuner: str | None = None):
        """``timeout`` bounds the whole rendezvous; ``handshake_timeout``
        bounds each accepted connection's registration message, so one
        stray dial-in stalls rendezvous briefly instead of consuming the
        entire budget while real slaves queue behind it.
        ``stall_timeout`` arms the barrier watchdog: a barrier
        generation with some ranks still missing after this many
        seconds gets a hang diagnosis logged (once per generation);
        ``None`` disables the watchdog.

        ``dead_rank_secs`` (None reads ``MP4J_DEAD_RANK_SECS``;
        ``float("inf")`` disables escalation, restoring the earlier
        log-only watchdog) is the ESCALATION threshold: a barrier generation or an
        abort round still incomplete after this many seconds means a
        rank is permanently gone or permanently diverged, and the
        watchdog escalates from the log-only diagnosis to a
        terminal abort fan-out — every surviving rank raises the same
        clean error instead of relying on its local timeout. It is
        deliberately much larger than ``stall_timeout``: the diagnosis
        is cheap and reversible, declaring a rank dead is neither.

        ``metrics_port`` (None reads ``MP4J_METRICS_PORT``,
        which unset keeps the endpoint off) serves the live metrics
        plane over plain HTTP on the CONTROL plane only: ``/metrics``
        is Prometheus text format, ``/metrics.json`` the same document
        as JSON. ``0`` binds an ephemeral port; the bound port is
        ``self.metrics_port``. ``postmortem_dir`` (None reads
        ``MP4J_POSTMORTEM_DIR``; empty disables) makes a terminal
        abort also write the flight recorder's cluster manifest.
        ``sink_dir`` (None reads ``MP4J_SINK_DIR`` gated by
        ``MP4J_SINK``; empty disables) names the job's durable-sink
        root in that manifest so ``mp4j-scope postmortem`` joins the
        full-job segment history — the same constructor seam as
        ``postmortem_dir``.

        ``elastic`` (None reads ``MP4J_ELASTIC``, default
        ``off``) selects the elastic-membership mode: ``off`` keeps
        the pre-elastic contract (a dead rank is a job-wide
        ``Mp4jFatalError``), ``replace`` adopts a warm spare into the
        dead rank's id at the next epoch (bit-exact continuation),
        ``shrink`` renumbers the survivors and continues at n-1.
        ``spares`` (None reads ``MP4J_SPARES``) is how many warm-spare
        registrations rendezvous waits for before the job starts;
        spares may also register later, mid-job. ``adopt_secs`` (None
        reads ``MP4J_ADOPT_SECS``) bounds each adoption handshake
        before the next spare is tried.

        ``health`` (None reads ``MP4J_HEALTH``, default on)
        arms the streaming health engine (:mod:`ytk_mp4j_tpu_torch.obs.
        health`): every heartbeat fold also feeds per-rank baselines
        and the detector set, verdict transitions are pushed to the
        subject rank's recovery log + durable sink and exported on
        ``/metrics``, and :meth:`health_status` is the operator hook
        the autoscaler calls — the health plane recommends, the
        AUTOSCALER acts.

        ``autoscale`` (None reads ``MP4J_AUTOSCALE``,
        default ``off``) arms mp4j-autopilot
        (:mod:`ytk_mp4j_tpu_torch.resilience.autoscaler`): the controller
        loop that reads :meth:`health_status` and drives the
        membership machinery — planned eviction of
        ``EVICT_RECOMMENDED`` ranks, spare auto-provisioning via
        ``provision_hook`` (a callable receiving this master) or
        ``provision_cmd`` (None reads ``MP4J_PROVISION_CMD``), and
        grow approval at ``resize_point()`` boundaries — behind the
        cooldown (``autoscale_cooldown`` /
        ``MP4J_AUTOSCALE_COOLDOWN_SECS``), budget
        (``autoscale_budget`` / ``MP4J_AUTOSCALE_BUDGET``),
        audit-green and circuit-breaker safety rails. ``observe``
        runs the controller but only LOGS would-be actions;
        ``autoscale_tick`` paces the loop (tests).

        ``tuner`` (None reads ``MP4J_TUNER``, default
        ``observe``) arms the master's half of the self-tuning data
        plane: the controller watches the health engine's cause-aware
        dominator rows and — in ``act`` mode — demotes a persistently
        wire-dominated host leader through a FENCED topology update
        (every rank parked at the same collective boundary, the
        override pushed, the fence released), and trips every rank's
        tuner back to static defaults on any cross-rank audit
        divergence. ``observe`` records would-be demotions only."""
        self.slave_num = slave_num
        self.timeout = timeout
        self.handshake_timeout = handshake_timeout
        self.stall_timeout = stall_timeout
        self.dead_rank_secs = tuning.dead_rank_secs(dead_rank_secs)
        # elastic knobs validated BEFORE any socket binds (a knob
        # conflict must not leak a bound listener out of a failed
        # constructor — the metrics-server precedent)
        self.elastic = tuning.elastic_mode(elastic)
        self._spares_expected = tuning.spares(spares)
        self._adopt_secs = tuning.adopt_secs(adopt_secs)
        self.log_stream = log_stream if log_stream is not None else sys.stderr
        # log sink config: validated once at construction (a typo'd
        # MP4J_LOG_LEVEL fails the job here, not silently mid-run)
        self._min_level = tuning.LOG_LEVELS[tuning.log_level()]
        self._rank_width = max(1, len(str(max(slave_num - 1, 0))))
        # job id: rides the rendezvous reply and namespaces
        # every shm segment this job's peer pairs create, so two jobs
        # on one host can never collide on a segment name
        self.job_id = secrets.token_hex(4)
        # job identity stamps: the fleet poller correlates
        # a job's /metrics.json and /health.json documents and detects
        # a master restart (new job_id at the same URL) without
        # heuristics. Wall clock: identity for humans/scrapers across
        # hosts, never duration arithmetic
        # mp4j-lint: disable=R11 (identity timestamp, not a duration)
        self.started_wall = time.time()
        # bumped under the lock at every roster publication
        # (rendezvous, replace, shrink, grow) — scrapers distinguish
        # "same job, new roster" from "same roster, fresh numbers"
        self._roster_gen = 0
        # rendezvous listen socket — sanctioned raw-socket site: the
        # master IS the control plane the transport SPI is negotiated
        # over (mp4j-lint R12 baseline)
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host or "0.0.0.0", port))
        self._server.listen(slave_num * 2)
        self.port = self._server.getsockname()[1]
        # the address the master ADVERTISES to out-of-process tooling
        # (the autoscaler's MP4J_PROVISION_CMD env): the explicit bind
        # host when given, else this machine's hostname — a
        # wildcard-bound master must not hand a provisioner on
        # another host a loopback address
        self.host = host or ""
        self._slots: list[_Slot] = []           # by CURRENT rank
        self._exit_codes: dict[int, int] = {}
        self._barrier_waiting: dict[int, list[int]] = {}  # gen -> ranks
        self._barrier_since: dict[int, float] = {}        # gen -> mono ts
        # highest generation ever released: an adopted joiner seeded
        # from a manifest sampled a beat early may re-send an already-
        # released generation — release it back to that rank alone
        # instead of opening a ghost generation nobody else will join
        #
        self._barrier_max_released = -1
        self._diagnosed_gens: set[int] = set()
        self._diag_incident_seq: int | None = None  # debounce key
        # recovery protocol state
        self._abort_epoch = 0                   # highest epoch fanned out
        self._abort_acks: set[int] = set()      # ranks acked current round
        self._abort_progress: dict[int, tuple[int, bool]] = {}
        self._abort_since: float | None = None  # mono ts of open round
        self._departed: dict[int, str] = {}     # rank -> why it left
        self._fatal_msg: str | None = None      # terminal abort, once
        # elastic membership: warm-spare pool + the open
        # round's membership extension (kind/dead/manifest/adoptions).
        # All guarded by self._lock like the abort state.
        self._membership = membership_mod.MembershipLog(self.elastic)
        self._spare_pool: list[membership_mod.SpareRecord] = []
        self._spare_seq = 0                     # spares ever registered
        self._spare_threads: list[threading.Thread] = []
        self._serve_threads: list[threading.Thread] = []
        self._roster: list[tuple] = []          # current (host, port, fp)
        self._round_kind: str | None = None     # None/'abort'/mode
        self._round_dead: dict[int, str] = {}   # this round's casualties
        self._round_why = ""                    # first casualty's message
        self._round_manifest: dict | None = None
        self._round_manifest_from: int | None = None
        self._round_seq: int | None = None      # joiner resume ordinal
        self._round_adoptions: dict[int, membership_mod.SpareRecord] = {}
        self._round_adopted: dict[int, membership_mod.SpareRecord] = {}
        # planned eviction: the LIVE ranks this round
        # replaces proactively, with the victims' pre-adoption slots
        # kept aside for the ("evicted",) release push
        self._round_evict: dict[int, str] = {}
        self._round_evict_slots: dict[int, _Slot] = {}
        # resize/grow state: per-generation arrival lists,
        # the donor payload (rank 0's vocab + positions), and the open
        # grow round's adoption bookkeeping
        self._resize_waiting: dict[int, list[int]] = {}
        self._resize_since: dict[int, float] = {}
        self._resize_donor: dict[int, dict] = {}
        # generations CLAIMED by a _complete_resize call: two slave
        # serve threads can see the same generation complete (the
        # last two arrivals race), and the grow decision consults the
        # controller OUTSIDE the lock — without the claim, the loser
        # releases the generation unchanged while the winner's grow
        # is mid-adoption, orphaning it. A generation is completed
        # exactly once; gens are monotone, so claims never recycle.
        self._resize_claimed: set[int] = set()
        # generations RELEASED so far (next expected = this value):
        # the adoption manifest's resize seed takes the max of this
        # and the donor's own count — a donor sampled in the window
        # between a generation's release fan-out and its ctl-side
        # processing reports one generation stale, and a joiner
        # seeded stale would re-send a completed generation that can
        # never fill (watchdog fatal on a healthy job)
        self._resize_released = 0
        self._grow_state: dict | None = None
        # the eviction fence: before a planned-eviction
        # round tears anything down, every live rank must be parked
        # at a collective boundary (fence ack) or idle in a barrier/
        # resize wait — quiescence BY CONSTRUCTION, so the round can
        # never manufacture the mixed-progress fatal. A fence that
        # cannot complete cancels with zero disruption (the wire was
        # never touched).
        self._evict_fence: dict | None = None
        self._fence_seq = 0
        self._fence_secs = max(1.0, min(self._adopt_secs, 5.0))
        # rank -> last heartbeat: progress fields + stats + arrival time
        self._telemetry: dict[int, dict] = {}
        # audit plane: folds heartbeat digest-record deltas
        # and flags cross-rank divergences (obs.audit.ClusterAuditor);
        # passive — it only ever sees records when slaves run
        # MP4J_AUDIT=verify|capture
        self._auditor = audit_mod.ClusterAuditor(slave_num)
        # health plane: the streaming verdict engine,
        # folded right next to the auditor in _record_telemetry; None
        # when disabled so every fold site pays one attribute check
        self._hb_secs = tuning.heartbeat_secs()
        self._health: health_mod.HealthEngine | None = (
            health_mod.HealthEngine(
                slave_num,
                window=tuning.health_window(),
                dominator_ordinals=tuning.health_dominator_ordinals(),
                drift_pct=tuning.health_drift_pct(),
                hb_secs=self._hb_secs)
            if tuning.health_enabled(health) else None)
        # autoscaler: knobs validated even when off (the
        # knob discipline — a typo'd MP4J_AUTOSCALE_COOLDOWN_SECS
        # fails setup, not the first action); the controller itself
        # only exists in observe/act and starts with serve()
        autoscale_mode = tuning.autoscale_mode(autoscale)
        tuning.autoscale_cooldown_secs(autoscale_cooldown)
        tuning.autoscale_budget(autoscale_budget)
        self._autoscaler: autoscaler_mod.Autoscaler | None = None
        if autoscale_mode != "off":
            self._autoscaler = autoscaler_mod.Autoscaler(
                self, mode=autoscale_mode,
                cooldown_secs=autoscale_cooldown,
                budget=autoscale_budget,
                provision_hook=provision_hook,
                provision_cmd=provision_cmd,
                tick_secs=autoscale_tick)
        # self-tuning data plane, master half: the tuner
        # controller state — leader overrides live + proposed, the
        # audit trip latch, event history. Guarded by its own lock
        # (ticks run on per-slave serve threads); pushes happen
        # outside it (the outbox discipline).
        self._tuner_mode = tuning.tuner_mode(tuner)
        self._tuner_ctl: dict | None = None
        if self._tuner_mode != "off":
            self._tuner_ctl = {
                "mode": self._tuner_mode, "overrides": {},
                "version": 0, "demotions": 0, "tripped": None,
                "last_action": 0.0, "event_seq": 0,
                "events": [],
            }
        self._tuner_lock = threading.Lock()
        # demotion cooldown: several decision windows, so one fence
        # cancel (a rank deep in compute) retries calmly, not per beat
        self._tuner_cooldown = max(5.0, tuning.tuner_window_secs() * 4)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.final_code: int | None = None
        # -- live metrics plane -------------------------------
        self._postmortem_dir = (tuning.postmortem_dir()
                                if postmortem_dir is None
                                else str(postmortem_dir))
        # durable-sink root: the master never writes
        # segments itself, but the manifest records where the ranks'
        # sinks are so `mp4j-scope postmortem` can join full-job
        # history into the report
        if sink_dir is None:
            self._sink_dir = (tuning.sink_dir()
                              if tuning.sink_enabled() else "")
        else:
            self._sink_dir = str(sink_dir)
        self._metrics_window = tuning.metrics_window_secs()
        # per-rank + cluster rate rings, fed on every heartbeat fold;
        # cluster totals are maintained incrementally (O(1 rank) per
        # beat), not re-summed across the fleet under the lock
        self._rank_windows: dict[int, metrics_mod.RateWindow] = {}
        self._rank_totals: dict[int, dict[str, float]] = {}
        self._cluster_totals: dict[str, float] = {}
        # cluster histogram/counter aggregate, folded incrementally
        # from each heartbeat's metrics_delta (never re-summed across
        # the fleet at scrape time)
        self._cluster_metrics: dict = {"counters": {}, "gauges": {},
                                       "histograms": {}}
        self._cluster_window = metrics_mod.RateWindow(
            self._metrics_window)
        self._metrics_server: http.server.ThreadingHTTPServer | None = None
        self.metrics_port: int | None = None
        want_port = tuning.metrics_port(override=metrics_port)
        if want_port is not None:
            try:
                self._start_metrics_server(host, want_port)
            except BaseException:
                # don't leak the already-bound listeners (data plane,
                # and the metrics socket if it bound before the fail)
                # out of a failed constructor — a retry Master on the
                # same explicit port would hit EADDRINUSE until GC
                self._stop_metrics_server()
                self._server.close()
                raise

    # ------------------------------------------------------------------
    def serve(self) -> int:
        """Run rendezvous then the control loop; returns aggregate exit
        code (0 iff every slave closed with 0)."""
        try:
            return self._serve()
        finally:
            # every listener must die with serve() on EVERY path — a
            # rendezvous timeout raising past a leaked HTTP server or
            # a still-bound data-plane socket would hold the port
            # against the retry Master
            self._server.close()
            self._write_postmortem_manifest()
            self._stop_metrics_server()

    def _serve(self) -> int:
        self._rendezvous()
        with self._lock:
            for slot in self._slots:
                t = threading.Thread(target=self._serve_slave,
                                     args=(slot,), daemon=True,
                                     name=f"master-slave{slot.rank}")
                t.start()
                self._serve_threads.append(t)
        # late spare registrations: a replacement spare may
        # dial in any time after the job started; the rendezvous
        # listener stays open for exactly that
        spare_accept = threading.Thread(target=self._spare_accept_loop,
                                        daemon=True,
                                        name="mp4j-spare-accept")
        spare_accept.start()
        # the watchdog now also drives the dead-rank ESCALATION
        #: it must run even with stall_timeout=None —
        # disabling the diagnosis must not silently disable the
        # terminal abort that bounds every recovery wait. Only when
        # BOTH functions are off (dead_rank_secs=inf too) is there
        # nothing it could ever do — skip the thread instead of
        # waking at 1 Hz for the job's lifetime
        watchdog = None
        if (self.stall_timeout is not None
                or self.dead_rank_secs != float("inf")):
            watchdog = threading.Thread(target=self._watchdog_loop,
                                        daemon=True,
                                        name="mp4j-watchdog")
            watchdog.start()
        # the autoscaler controller loop: observes/acts on
        # health verdicts for the job's lifetime; the shared stop
        # event ends it with serve()
        if self._autoscaler is not None:
            self._autoscaler.start(self._stop)
        try:
            # the list GROWS when a spare is adopted (its serve thread
            # becomes the rank's), so re-read it until drained
            i = 0
            while True:
                with self._lock:
                    if i >= len(self._serve_threads):
                        break
                    t = self._serve_threads[i]
                i += 1
                t.join()
        finally:
            self._stop.set()
            # unadopted spares idle in a blocking recv: release them
            # so their constructors raise Mp4jSpareReleased instead of
            # waiting out a timeout against a finished job
            with self._lock:
                fatal_msg = self._fatal_msg
            self._release_spares(
                fatal_msg or "job completed without adopting "
                "this spare")
        if watchdog is not None:
            watchdog.join(2.0)
        if self._autoscaler is not None:
            self._autoscaler.join(2.0)
        # serve()'s finally closes the listener, refreshes the
        # flight-recorder manifest with the FINAL table (the slaves'
        # fatal-path telemetry flushes landed after the fan-out-time
        # write) and stops the endpoint
        with self._lock:
            codes = [self._exit_codes.get(r, 1)
                     for r in range(self.slave_num)]
            final = max(codes) if codes else 0
            self.final_code = final
        return final

    def serve_in_thread(self) -> "Master":
        self._thread = threading.Thread(target=self.serve, daemon=True,
                                        name="mp4j-master")
        self._thread.start()
        return self

    def join(self, timeout: float | None = None):
        if self._thread is not None:
            self._thread.join(timeout)

    # ------------------------------------------------------------------
    def _rendezvous(self):
        """Accept slave registrations; assign ranks in registration order
        (pinned free choice — the reference's exact rule is unverified);
        broadcast the roster to all. Warm spares (``spare: True`` in the
        REGISTER payload) are parked in the spare pool instead
        of claiming a rank; rendezvous additionally waits for
        ``spares`` of them so a job configured with spares starts with
        its pool warm."""
        deadline = (None if self.timeout is None
                    else time.monotonic() + self.timeout)
        pending = []  # (channel, (host, listen_port, fp))
        self._server.settimeout(1.0)
        while True:
            with self._lock:
                pooled = len(self._spare_pool)
            if (len(pending) >= self.slave_num
                    and pooled >= self._spares_expected):
                break
            if deadline is not None and time.monotonic() > deadline:
                got = [hp for _, hp in pending]
                raise Mp4jError(
                    f"rendezvous timeout: {len(pending)}/{self.slave_num} "
                    f"slaves and {pooled}/"
                    f"{self._spares_expected} spares registered (heard "
                    f"from: {got or 'none'} — the missing slaves never "
                    "dialed in)")
            # bound the registration handshake: a stray connection that
            # never sends must neither hang rendezvous (no timeout) nor
            # consume the whole budget while real slaves queue behind it
            remaining = (None if deadline is None
                         else max(0.1, deadline - time.monotonic()))
            bounds = [t for t in (remaining, self.handshake_timeout)
                      if t is not None]
            try:
                sock, addr = self._server.accept()
            except socket.timeout:
                continue
            # sanctioned channel-construction site: rendezvous wraps
            # the just-accepted control connection (R12 baseline)
            ch = TcpChannel(sock)
            try:
                ch.set_timeout(min(bounds) if bounds else None)
                # anything a hostile/broken dial-in can do — reset,
                # garbage frame, non-tuple payload, malformed REGISTER
                # body, timeout — must not kill rendezvous for the
                # real slaves, so the whole decode stays in this try
                kind, payload = ch.recv()
                ok = kind == REGISTER and isinstance(payload, dict)
                listen_port = int(payload["listen_port"]) if ok else 0
                host = str(payload.get("host") or addr[0]) if ok else ""
                # host fingerprint: opaque token two slaves
                # share iff they can attach each other's shm segments;
                # "" means the slave opted out (MP4J_SHM=0)
                fp = str(payload.get("fp") or "") if ok else ""
                is_spare = bool(payload.get("spare")) if ok else False
            except Exception:
                ok = False
            if not ok:
                ch.close()
                continue
            ch.set_timeout(None)  # control plane is fail-stop from here
            if is_spare:
                self._register_spare(ch, (host, listen_port, fp))
                continue
            if len(pending) >= self.slave_num:
                # every rank is claimed; rendezvous only stays open
                # for the spares it is still waiting on — a surplus
                # non-spare dial-in must not mint an out-of-range rank
                ch.close()
                continue
            pending.append((ch, (host, listen_port, fp)))
        roster = [hp for _, hp in pending]
        slots = [_Slot(rank, ch) for rank, (ch, _) in enumerate(pending)]
        # publish table + slots under the lock (the autoscaler and
        # spare-accept threads are already running); the handshake
        # sends stay OUTSIDE it — send_obj blocks on the peer
        with self._lock:
            self._roster = roster
            self._roster_gen += 1
            self._slots.extend(slots)
        for rank, (ch, _) in enumerate(pending):
            ch.send_obj({"rank": rank, "roster": roster,
                         "job": self.job_id})

    def _serve_slave(self, slot: _Slot):
        ch = slot.ch
        try:
            while True:
                kind, payload = ch.recv()
                if slot.dead:
                    # a zombie: this rank was declared dead and its id
                    # may already belong to a replacement — drop the
                    # connection instead of laundering its messages
                    ch.close()
                    return
                if slot.quiet:
                    # planned eviction in flight: the rank
                    # id belongs to the adopted spare, but the channel
                    # must survive until the ("evicted",) release —
                    # drop the message, keep serving
                    continue
                # the CURRENT rank, re-read per message: a shrink round
                # renumbers survivors mid-job
                rank = slot.rank
                if kind == LOG:
                    self._log(rank, payload["level"], payload["msg"])
                elif kind == BARRIER:
                    self._barrier(slot, payload["gen"])
                elif kind == TELEMETRY:
                    self._record_telemetry(rank, payload)
                elif kind == DIAGNOSE:
                    self._handle_diagnose(rank, payload)
                elif kind == ABORT_REQ:
                    self._handle_abort_req(rank, payload)
                elif kind == ABORT_ACK:
                    self._handle_abort_ack(rank, payload)
                elif kind == MANIFEST:
                    self._handle_manifest(rank, payload)
                elif kind == RESIZE:
                    self._handle_resize(slot, payload)
                elif kind == FENCE_ACK:
                    self._handle_fence_ack(rank, payload)
                elif kind == CLOSE:
                    code = payload["code"]
                    with self._lock:
                        already_dead = rank in self._departed
                        if not already_dead:
                            self._exit_codes[rank] = code
                        live_left = (set(range(self.slave_num))
                                     - set(self._departed)
                                     - set(self._exit_codes))
                    with slot.lock:
                        ch.send_obj("closed")
                    ch.close()
                    if already_dead:
                        # this rank's death is already being handled
                        # (declared dead, possibly replaced): its late
                        # close must not re-kill the job
                        return
                    self._mark_departed(
                        rank, f"closed with code {code}")
                    if code != 0 and live_left:
                        # a nonzero close is a defect report; peers
                        # blocked on this rank's data would otherwise
                        # only find out at their own (long) timeouts.
                        # Deliberately NOT an elastic trigger: the
                        # process defected with its own error — its
                        # state is suspect, replacement would launder a
                        # defect into "recovery"
                        self._fatal_abort(
                            f"rank {rank} exited with code {code} "
                            "before the job completed; aborting the "
                            "job")
                    return
                else:
                    self._log(rank, "ERROR", f"unknown message {kind!r}")
        except Exception as e:
            # a dead slave (reset, EOF, corrupt frame) marks a nonzero
            # exit code and the master keeps serving the others — but
            # no longer silently: a lost connection means the
            # process died without closing, so the job cannot complete
            # under MP4J_ELASTIC=off. The elastic modes
            # dispatch through _on_rank_dead instead: replacement from
            # a warm spare, or a contiguous shrink of the survivors.
            if slot.dead or slot.quiet:
                # this rank was ALREADY declared dead — or released by
                # a planned eviction, whose clean process
                # exit closes the channel — either way the error is
                # expected aftermath, and a shrink may meanwhile have
                # renumbered a healthy survivor into slot.rank, so a
                # fresh declaration here would kill THAT rank (found
                # by the health chaos loop: the health-alert
                # dispatch shifted this race's timing, but the hole
                # predates it)
                self._log(slot.rank, "INFO",
                          f"evicted/declared-dead rank's channel "
                          f"closed: {e!r}")
                return
            rank = slot.rank
            self._log(rank, "ERROR", f"slave connection lost: {e!r}")
            with self._lock:
                self._exit_codes.setdefault(rank, 1)
            self._on_rank_dead(
                rank, f"connection lost ({e!r})",
                f"rank {rank} is dead (connection lost: {e!r}); "
                "aborting the job")

    # -- recovery protocol ------------------------------------
    def _send_to(self, rank: int, obj) -> None:
        """Push one control message to a slave; a rank that dies while
        we push is marked departed, never crashes a serve thread."""
        try:
            with self._lock:
                slot = self._slots[rank]
            with slot.lock:
                slot.ch.send_obj(obj)
        except (Mp4jError, OSError):
            self._mark_departed(rank, "unreachable on push")

    def _live_ranks(self) -> set[int]:
        with self._lock:
            return set(range(self.slave_num)) - set(self._departed)

    def _mark_departed(self, rank: int, why: str) -> None:
        with self._lock:
            self._departed.setdefault(rank, why)
            pending = self._abort_since is not None
        if pending:
            # an open abort round can never complete without this rank
            # — terminal under MP4J_ELASTIC=off; the elastic modes
            # extend the round into a membership round instead
            self._on_rank_dead(
                rank, why,
                f"rank {rank} left during recovery ({why}); "
                "aborting the job")

    def _handle_abort_req(self, rank: int, payload: dict) -> None:
        if payload.get("fatal"):
            self._fatal_abort(
                f"terminal abort requested by rank {rank}: "
                f"{payload.get('error')}")
            return
        target = int(payload.get("epoch", 0)) + 1
        with self._lock:
            if target <= self._abort_epoch:
                dup = True      # round already fanned out; debounce
            else:
                dup = False
                self._open_round_locked(target)
                dead = dict(self._departed)
        self._log(rank, "ERROR",
                  f"collective '{payload.get('collective')}' failed "
                  f"(epoch {payload.get('epoch')}): "
                  f"{payload.get('error')}")
        if dup:
            return
        if dead:
            msg = (f"cannot recover: rank(s) {sorted(dead)} already gone "
                   f"({'; '.join(f'{r}: {w}' for r, w in sorted(dead.items()))})")
            if self.elastic == "off":
                self._fatal_abort(msg)
                return
            # elastic: the departed ranks become this
            # round's casualties — the round just opened fans out
            # below, then the membership machinery takes over
            self._log("M", "WARN",
                      f"abort round -> epoch {target}: tearing down "
                      f"the data plane on all surviving ranks")
            for r in sorted(self._live_ranks()):
                self._send_to(r, ("abort", target))
            self._begin_membership(dead, msg)
            return
        self._log("M", "WARN",
                  f"abort round -> epoch {target}: tearing down the "
                  f"data plane on all {self.slave_num} ranks")
        for r in sorted(self._live_ranks()):
            self._send_to(r, ("abort", target))

    def _open_round_locked(self, target: int) -> None:
        """Reset the round state for a new abort round (caller holds
        the lock and has verified ``target`` advances the epoch)."""
        self._abort_epoch = target
        self._abort_acks = set()
        self._abort_progress = {}
        self._abort_since = time.monotonic()
        self._round_kind = "abort"
        self._round_dead = {}
        self._round_why = ""
        self._round_manifest = None
        self._round_manifest_from = None
        self._round_seq = None
        self._round_adoptions = {}
        self._round_adopted = {}
        self._round_evict = {}
        self._round_evict_slots = {}

    def _handle_abort_ack(self, rank: int, payload: dict) -> None:
        with self._lock:
            if int(payload.get("epoch", 0)) != self._abort_epoch:
                return          # ack for a stale round
            self._abort_acks.add(rank)
            self._abort_progress[rank] = (int(payload.get("seq", 0)),
                                          bool(payload.get("inflight")))
        self._try_advance_round()

    def _handle_manifest(self, rank: int, payload: dict) -> None:
        """A survivor's adoption-manifest contribution:
        pinned keycodec vocabularies + its progress/barrier position."""
        with self._lock:
            if (int(payload.get("epoch", 0)) != self._abort_epoch
                    or self._round_kind not in ("replace", "evict")):
                return          # stale round, or mode changed
            self._round_manifest = payload
            self._round_manifest_from = rank
        self._try_advance_round()

    # -- resize points + grow mode ---------------------------
    def _handle_resize(self, slot: _Slot, payload: dict) -> None:
        """A rank reached a ``resize_point()`` boundary. Arrivals
        collect per generation like barriers; rank 0's message carries
        the canonical vocabulary export (at a quiesced boundary every
        rank's codecs are identical by construction — the sync rounds
        grow them lockstep). When the last rank arrives the round
        completes: grow under ``MP4J_ELASTIC=grow`` +
        ``MP4J_AUTOSCALE=act`` (behind the autoscaler's rails), or a
        no-change release."""
        gen = int(payload.get("gen", 0))
        with self._lock:
            rank = slot.rank
            fatal = self._fatal_msg
            if fatal is None:
                waiting = self._resize_waiting.setdefault(gen, [])
                self._resize_since.setdefault(gen, time.monotonic())
                if rank not in waiting:
                    waiting.append(rank)
                if payload.get("vocab") is not None:
                    self._resize_donor[gen] = dict(payload)
        if fatal is not None:
            # like a barrier into a dead job: re-push the terminal
            self._send_to(rank, ("abort_fatal", fatal))
            return
        self._check_resize_complete()
        # a resize arrival is a boundary too
        self._check_fence()

    def _check_resize_complete(self) -> None:
        """Complete every resize generation all CURRENT ranks have
        reached. Callers re-invoke after membership changes (a shrink
        may have removed the only missing arrival) — one pass per
        call."""
        with self._lock:
            # strictly IN ORDER, and never while a grow is in flight:
            # freshly adopted joiners resize at gen+1 against the OLD
            # slave_num (it only advances at grow finalize), so an
            # arrival-count check alone would complete gen+1 for the
            # joiners while the survivors are still inside gen's grow
            # — the release paths bump _resize_released and re-invoke
            # this scan, so held generations complete on their turn
            done = [gen for gen, ranks
                    in self._resize_waiting.items()
                    if len(ranks) >= self.slave_num
                    and gen == self._resize_released
                    and self._grow_state is None]
        for gen in sorted(done):
            self._complete_resize(gen)

    def _complete_resize(self, gen: int) -> None:
        """All ranks quiesced at resize generation ``gen``: grow when
        the mode + the autoscaler's safety rails allow, else release
        unchanged. The grow decision consults the autoscaler OUTSIDE
        the master lock (lock discipline: master -> controller only)."""
        with self._lock:
            if gen not in self._resize_waiting:
                return          # already completed (re-entry)
            if gen in self._resize_claimed:
                return          # another serve thread owns this gen
            self._resize_claimed.add(gen)
            if self._grow_state is not None \
                    and self._grow_state["gen"] == gen:
                # THIS generation's grow is mid-adoption (a joiner's
                # early next-gen resize_point can re-trigger the
                # completeness scan): releasing it unchanged here
                # would orphan the grow — survivors resume at the old
                # n while the joiners arrive at n+k. The finalize (or
                # abort) path owns this generation's release.
                return
            donor = self._resize_donor.get(gen)
            avail = [s for s in self._spare_pool
                     if s.alive and s.adopting_rank is None]
            can_grow = (self.elastic == "grow"
                        and self._fatal_msg is None
                        and self._abort_since is None
                        and self._grow_state is None
                        # an armed eviction fence owns the quiesce: a
                        # grow starting under it would race the
                        # fence's round into two concurrent
                        # membership changes over one roster
                        and self._evict_fence is None
                        and donor is not None and bool(avail))
            audit = self._auditor.status()
            ranks = list(self._resize_waiting[gen])
        k = 0
        if can_grow and self._autoscaler is not None:
            k = self._autoscaler.approve_grow(len(avail), audit)
        if k <= 0:
            with self._lock:
                self._resize_waiting.pop(gen, None)
                self._resize_since.pop(gen, None)
                self._resize_donor.pop(gen, None)
                self._resize_released = max(self._resize_released,
                                            gen + 1)
            for r in ranks:
                self._send_to(r, ("resize_go", gen, None))
            self._check_resize_complete()
            return
        adopts: list = []
        with self._lock:
            # revalidate under the lock (a spare may have died while
            # the controller deliberated)
            avail = [s for s in self._spare_pool
                     if s.alive and s.adopting_rank is None][:k]
            if not avail or self._grow_state is not None \
                    or self._abort_since is not None:
                chosen = []
            else:
                chosen = avail
            if not chosen:
                # the approved grow DROPPED at revalidation (the
                # spare died / a round opened while the controller
                # deliberated): nothing was touched, so the
                # controller's pending 'grow' must settle as a benign
                # RETRY, not bleed out at the deadline as a breaker
                # failure — record the cancel event it resolves on
                self._membership.note_grow_cancel(
                    gen, "grow dropped at revalidation: spare lost "
                    "or a round opened while the controller "
                    "deliberated")
                self._resize_waiting.pop(gen, None)
                self._resize_since.pop(gen, None)
                self._resize_donor.pop(gen, None)
                self._resize_released = max(self._resize_released,
                                            gen + 1)
            else:
                base = self.slave_num
                grown = membership_mod.grow_roster(
                    self._roster, [rec.entry for rec in chosen])
                epoch = self._abort_epoch
                now = time.monotonic()
                pending: dict[int, membership_mod.SpareRecord] = {}
                for i, rec in enumerate(chosen):
                    rec.adopting_rank = base + i
                    rec.grow = True
                    rec.adopt_since = now
                    pending[base + i] = rec
                self._grow_state = {
                    "gen": gen, "pending": pending, "adopted": {},
                    "roster": grown, "epoch": epoch,
                    "resume_seq": int(donor.get("seq", 0)),
                    # kept for mid-grow adoption retries: a
                    # replacement joiner must seed from the SAME
                    # donor payload (barrier position, vocabulary)
                    # as the spare it replaces
                    "donor": dict(donor),
                }
                for i, rec in enumerate(chosen):
                    adopts.append((base + i, rec,
                                   self._grow_adopt_info(
                                       base + i, grown, donor, gen,
                                       epoch, "grow")))
        if not adopts:
            for r in ranks:
                self._send_to(r, ("resize_go", gen, None))
            self._check_resize_complete()
            return
        for r, rec, info in adopts:
            self._log("M", "WARN",
                      f"grow: adopting spare #{rec.idx} into NEW "
                      f"rank {r} (resize {gen}, epoch "
                      f"{info['epoch']})")
            self._send_spare(rec, ("adopt", info))

    def _grow_adopt_info(self, rank: int, roster: list, donor: dict,
                         gen: int, epoch: int, why: str) -> dict:
        """ONE builder for the grow adoption message — the initial
        adoptions and the mid-grow retry must seed joiners from the
        identical donor payload shape, or a field added to one path
        silently mis-seeds joiners adopted via the other (the
        parked-barrier / divergent-codes class)."""
        seq = int(donor.get("seq", 0))
        return {
            "rank": rank, "epoch": epoch, "roster": list(roster),
            "job": self.job_id, "grow": True, "seq": seq,
            "stats_seq": int(donor.get("stats_seq", seq)),
            "barrier_gen": int(donor.get("barrier_gen", 0)),
            # the joiner's NEXT resize pairs with the survivors' next
            "resize_gen": gen + 1,
            "vocab": donor.get("vocab") or {},
            "watermark": self._auditor.verified_seq,
            "why": why,
        }

    def _try_advance_grow(self) -> None:
        """Every grow adoption acked: advance the roster/slave_num,
        record the event, and release the resize generation to the
        pre-existing ranks with the grown roster."""
        with self._lock:
            gs = self._grow_state
            if gs is None or gs["pending"] or self._fatal_msg is not None:
                return
            self._grow_state = None
            gen = gs["gen"]
            new_ranks = sorted(gs["adopted"])
            old_n = self.slave_num
            self._roster = gs["roster"]
            self._roster_gen += 1
            self.slave_num = len(self._roster)
            self._rank_width = max(
                1, len(str(max(self.slave_num - 1, 0))))
            self._membership.note_grow(new_ranks, gs["epoch"], gen)
            audit_lines = self._auditor.note_grow(
                self.slave_num, gs["resume_seq"])
            if self._health is not None:
                self._health.note_grow(self.slave_num)
            ranks = [r for r in self._resize_waiting.pop(gen, [])
                     if r not in self._departed]
            self._resize_since.pop(gen, None)
            self._resize_donor.pop(gen, None)
            self._resize_released = max(self._resize_released,
                                        gen + 1)
            info = {"roster": self._roster, "grown": new_ranks,
                    "gen": gen}
        for line in audit_lines:
            self._log("M", "ERROR", line)
        self._log("M", "WARN",
                  f"grow round complete: {old_n} -> {self.slave_num} "
                  f"rank(s) (new: {new_ranks}); releasing resize "
                  f"{gen}")
        for r in ranks:
            self._send_to(r, ("resize_go", gen, info))
        # a held NEXT generation (the joiners resize early) may be
        # complete at the grown slave_num now
        self._check_resize_complete()

    def _retry_grow_adoption(self, rank: int, why: str) -> None:
        """A grow adoption failed: when NO other joiner has been
        seeded yet (their roster copies would hold the dead spare's
        listen address for this rank), try the next available spare
        for the same NEW rank id; otherwise roll the whole grow back
        — degrading a growth to a no-op is always safe (nobody
        depends on ranks that never existed)."""
        abort = None
        adopt = None
        with self._lock:
            gs = self._grow_state
            if gs is None:
                return
            rec = next((s for s in self._spare_pool
                        if s.alive and s.adopting_rank is None), None)
            if rec is None:
                abort = why + "; warm-spare pool exhausted"
            elif gs["adopted"] or gs["pending"]:
                abort = (why + "; other joiners already hold the "
                         "promised roster — rolling the grow back")
            else:
                rec.adopting_rank = rank
                rec.grow = True
                rec.adopt_since = time.monotonic()
                gs["pending"][rank] = rec
                # the grown roster promised THIS listen address for
                # the new rank — swap the replacement's entry in
                gs["roster"][rank] = rec.entry
                # seed from the SAME donor payload as the spare this
                # one replaces (one builder: _grow_adopt_info)
                adopt = (rank, rec, self._grow_adopt_info(
                    rank, gs["roster"], gs.get("donor") or {},
                    gs["gen"], gs["epoch"], "grow (retry)"))
        if abort is not None:
            self._abort_grow(abort)
            return
        r, rec, info = adopt
        self._log("M", "WARN",
                  f"grow: retrying NEW rank {r} with spare "
                  f"#{rec.idx} ({why})")
        self._send_spare(rec, ("adopt", info))

    def _abort_grow(self, reason: str) -> None:
        """Roll a failed grow back: release every already-seeded
        joiner with a clean ``Mp4jEvicted``, release the resize
        generation UNCHANGED to the waiting ranks, and record the
        failure (the autoscaler's circuit breaker reads it)."""
        with self._lock:
            gs, self._grow_state = self._grow_state, None
            if gs is None:
                return
            gen = gs["gen"]
            victims = {**gs["pending"], **gs["adopted"]}
            for r in victims:
                if 0 <= r < len(self._slots) \
                        and self._slots[r] is not None \
                        and self._slots[r].rank == r:
                    self._slots[r].quiet = True
            ranks = [r for r in self._resize_waiting.pop(gen, [])
                     if r not in self._departed]
            self._resize_since.pop(gen, None)
            self._resize_donor.pop(gen, None)
            self._resize_released = max(self._resize_released,
                                        gen + 1)
            self._membership.note_grow_abort(
                sorted(victims), gen, reason)
        self._log("M", "ERROR",
                  f"grow round ABORTED ({reason}): releasing resize "
                  f"{gen} unchanged; {len(victims)} joiner(s) "
                  "released")
        for r, rec in sorted(victims.items()):
            try:
                rec.ch.send_obj(("evicted",
                                 f"grow round aborted: {reason}"))
            except (Mp4jError, OSError):
                pass
        with self._lock:
            for r in victims:
                if 0 <= r < len(self._slots) \
                        and self._slots[r] is not None:
                    self._slots[r].dead = True
        for r in ranks:
            self._send_to(r, ("resize_go", gen, None))
        self._check_resize_complete()

    # -- elastic membership ----------------------------------
    def _on_rank_dead(self, rank: int, why: str, fatal_msg: str) -> None:
        """Central dead-rank dispatch. ``fatal_msg`` is EXACTLY the
        message the pre-elastic master fanned out — used verbatim when
        elastic membership is off (the MP4J_ELASTIC=off contract is
        bit-for-bit the old behavior) or cannot help."""
        with self._lock:
            already = self._fatal_msg is not None
            pending = self._abort_since is not None
            # the health plane's DEAD verdict rides the SAME liveness
            # decision, never a second opinion
            dead_alerts = (self._health.note_dead(rank, why)
                           if self._health is not None else [])
        self._dispatch_health_alerts(dead_alerts)
        if self.elastic == "off" or already:
            with self._lock:
                self._departed.setdefault(rank, why)
            if pending:
                # pre-elastic precedence: an open abort round can
                # never complete without this rank, and THAT message
                # is the one the old _mark_departed fanned out first
                self._fatal_abort(
                    f"rank {rank} left during recovery ({why}); "
                    "aborting the job")
            self._fatal_abort(fatal_msg)   # debounced if above fired
            return
        self._begin_membership({rank: why}, fatal_msg)

    def _begin_membership(self, dead: dict[int, str],
                          fatal_msg: str) -> None:
        """Open (or extend) a membership round for the newly dead
        ranks: fan out the abort if no round is open, upgrade the
        round's kind to the elastic mode, request the adoption
        manifest (replace), and push a terminal notice to any declared-
        dead rank whose control channel still answers (a watchdog-
        declared straggler must learn it was replaced, not hang)."""
        notify: list[tuple[_Slot, Channel]] = []
        fan_abort = False
        manifest_req: int | None = None
        fatal: str | None = None
        # a death outranks an in-flight grow: its joiners were seeded
        # at an epoch this round is about to retire — roll the grow
        # back before the membership round claims the spare pool
        with self._lock:
            grow_pending = self._grow_state is not None
        if grow_pending and dead:
            self._abort_grow(
                f"membership round opened (rank(s) {sorted(dead)} "
                "dead)")
        with self._lock:
            if self._fatal_msg is not None:
                return
            # grow mode's death response IS replacement (it has a
            # spare pool by construction); shrink/replace unchanged
            mode = ("replace" if self.elastic == "grow"
                    else self.elastic)
            fresh = {r: w for r, w in dead.items()
                     if r not in self._round_dead}
            for r, w in dead.items():
                self._departed.setdefault(r, w)
            if self._abort_since is None:
                self._open_round_locked(self._abort_epoch + 1)
                fan_abort = True
            if self._round_evict and dead:
                # a REAL death arrived while a planned eviction was
                # quiescing: abandon the eviction — the
                # victim stays a live member of what is now an
                # ordinary membership round, and the autoscaler's
                # pending action resolves as failed. An adoption
                # already assigned to a still-alive victim is
                # released back to the pool; one assigned to a victim
                # that itself just died carries over (the replace
                # path below adopts into exactly that id).
                for r, rec in list(self._round_adoptions.items()):
                    if r in self._round_evict and r not in dead:
                        rec.adopting_rank = None
                        rec.adopt_since = None
                        del self._round_adoptions[r]
                for r in self._round_evict:
                    # the cancel event settles the controller's
                    # pending action as a benign retry NOW — without
                    # it the one-in-flight rail blocks every other
                    # action until the ~25 s deadline, then charges a
                    # breaker strike for an abandonment the master
                    # chose deliberately
                    self._membership.note_evict_cancel(
                        r, 0, "a real death superseded the planned "
                        "eviction")
                self._round_evict = {}
                self._round_evict_slots = {}
            self._round_kind = mode
            for r, w in fresh.items():
                self._round_dead[r] = w
                if not self._round_why:
                    self._round_why = fatal_msg
                slot = (self._slots[r]
                        if 0 <= r < len(self._slots) else None)
                if slot is not None:
                    slot.dead = True
                    notify.append((slot, slot.ch))
            live = set(range(self.slave_num)) - set(self._departed)
            if not live:
                fatal = fatal_msg + "; no surviving rank left"
            elif mode == "replace":
                avail = sum(1 for s in self._spare_pool
                            if s.alive and s.adopting_rank is None)
                if avail < (len(self._round_dead)
                            - len(self._round_adopted)
                            - len(self._round_adoptions)):
                    # today's clean Mp4jFatalError: elasticity was
                    # requested but the pool cannot cover the loss
                    fatal = (fatal_msg
                             + "; no warm spare available to replace "
                             f"rank(s) {sorted(self._round_dead)}")
                elif (self._round_manifest is None
                        and (self._round_manifest_from is None
                             or self._round_manifest_from not in live)):
                    manifest_req = min(live)
                    self._round_manifest_from = manifest_req
            target = self._abort_epoch
        if fatal is not None:
            self._fatal_abort(fatal)
            return
        for slot, ch in notify:
            # best-effort: the rank was DECLARED dead, but a merely
            # wedged process should still raise the same clean error
            try:
                with slot.lock:
                    ch.send_obj(("abort_fatal", fatal_msg))
            except (Mp4jError, OSError):
                pass
        if dead:
            self._log(
                "M", "WARN",
                f"membership round ({mode}) -> epoch {target}: "
                f"rank(s) {sorted(dead)} declared dead "
                f"({'; '.join(f'{r}: {w}' for r, w in sorted(dead.items()))})")
        if fan_abort:
            for r in sorted(self._live_ranks()):
                self._send_to(r, ("abort", target))
        if manifest_req is not None:
            self._send_to(manifest_req, ("manifest_req", target))
        # a real membership round cancels any armed eviction fence
        # (the death outranks the planned action)
        self._check_fence()
        self._try_advance_round()

    def _next_spare_locked(self):
        for rec in self._spare_pool:
            if rec.alive and rec.adopting_rank is None:
                return rec
        return None

    def _try_advance_round(self) -> None:
        """Evaluate the open round against its completion condition and
        take the next step: release a plain abort round, start spare
        adoptions, or finalize a membership round. Re-entered whenever
        an input lands — an ack, a departure, the manifest, an adopt
        ack, a spare death."""
        adopts: list[tuple[int, object, dict]] = []
        fatal: str | None = None
        release = None
        with self._lock:
            if self._abort_since is None or self._fatal_msg is not None:
                return
            live = set(range(self.slave_num)) - set(self._departed)
            if not live or not live <= self._abort_acks:
                return
            kind = self._round_kind or "abort"
            epoch = self._abort_epoch
            progress = {r: self._abort_progress.get(r, (0, False))
                        for r in sorted(live)}
            if kind == "evict":
                # the victim's progress is EXCLUDED from the
                # per-collective coherence check, exactly like a dead
                # rank's: a persistently slow victim sits
                # one collective BEHIND its peers at quiesce time —
                # the precise state eviction exists to resolve — and
                # its unfinished collective leaves with it (survivors
                # already hold its contributions to everything they
                # completed; the joiner enters the retried collective
                # fresh, the dead-replacement rule)
                progress = {r: p for r, p in progress.items()
                            if r not in self._round_evict}
            mixed = self._mixed_progress(progress)
            if mixed is not None:
                fatal = mixed
            elif kind == "abort":
                self._abort_since = None
                self._round_kind = None
                release = ("abort", epoch, None, sorted(live), [], (),
                           ())
            elif kind in ("replace", "evict"):
                # one adoption path for both variants: `replace` fills
                # DEAD ranks (empty pool is terminal — the job cannot
                # continue at n), `evict` proactively swaps LIVE ranks
                # (empty pool ABANDONS the eviction and
                # releases a plain abort — the victim is still a
                # member, so degrading to no-op is strictly safer)
                casualties = (self._round_dead if kind == "replace"
                              else self._round_evict)
                if self._round_manifest is not None:
                    if self._round_seq is None:
                        self._round_seq = membership_mod.joiner_seq(
                            progress)
                    need = [r for r in sorted(casualties)
                            if r not in self._round_adoptions
                            and r not in self._round_adopted]
                    abandon = None
                    for r in need:
                        rec = self._next_spare_locked()
                        if rec is None:
                            if kind == "replace":
                                fatal = (self._round_why
                                         + "; no warm spare available "
                                         f"to replace rank {r}")
                            else:
                                abandon = (
                                    "planned eviction of rank(s) "
                                    f"{sorted(casualties)} abandoned: "
                                    "warm-spare pool exhausted; "
                                    "releasing the round as a plain "
                                    "abort")
                            break
                        rec.adopting_rank = r
                        rec.adopt_since = time.monotonic()
                        self._round_adoptions[r] = rec
                    if abandon is not None:
                        # abandoning is only SOUND when the quiesced
                        # state is coherent INCLUDING the victim: a
                        # victim interrupted one collective behind
                        # would retry ordinal m-1 against survivors
                        # retrying m — raw exchanges carry no
                        # collective tag, so the mispairing is silent
                        # corruption, not an error. Incoherent + no
                        # spare -> hold the round open for a late
                        # spare registration (_register_spare
                        # re-drives it; the watchdog's stalled-round
                        # fatal bounds the wait).
                        full = {r2: self._abort_progress.get(
                                    r2, (0, False))
                                for r2 in sorted(live)}
                        if self._mixed_progress(full) is not None:
                            abandon = None
                    if abandon is not None:
                        self._membership.note_evict_abort(
                            sorted(casualties), epoch, abandon)
                        self._abort_since = None
                        self._round_kind = None
                        self._round_evict = {}
                        self._round_evict_slots = {}
                        self._round_manifest = None
                        self._round_manifest_from = None
                        self._round_seq = None
                        release = ("abort", epoch, None, sorted(live),
                                   [abandon], (), ())
                    elif fatal is None:
                        man = self._round_manifest
                        repl = {r2: rec2.entry for r2, rec2
                                in self._round_adoptions.items()}
                        roster = membership_mod.swap_roster(
                            self._roster, repl)
                        for r in need:
                            rec = self._round_adoptions[r]
                            adopts.append((r, rec, {
                                "rank": r, "epoch": epoch,
                                "roster": roster, "job": self.job_id,
                                "seq": self._round_seq,
                                # the donor's CommStats position (it
                                # counts nested collectives the
                                # recovery ordinal does not) keeps the
                                # joiner's heartbeat seq out of the
                                # skew table's laggard column
                                "stats_seq": int(man.get(
                                    "stats_seq", self._round_seq)),
                                "barrier_gen": int(
                                    man.get("barrier_gen", 0)),
                                # max with the master's released
                                # count: a pending generation needs
                                # the joiner's arrival (donor == the
                                # master then), a just-released one
                                # must not be replayed (see
                                # _resize_released)
                                "resize_gen": max(
                                    int(man.get("resize_gen", 0)),
                                    self._resize_released),
                                "vocab": man.get("vocab") or {},
                                "watermark":
                                    self._auditor.verified_seq,
                                "why": casualties.get(r, ""),
                            }))
                        if (not adopts and set(casualties)
                                <= set(self._round_adopted)):
                            release = self._finalize_replace_locked(
                                epoch, live)
            elif kind == "shrink":
                release = self._finalize_shrink_locked(epoch)
        if fatal is not None:
            self._fatal_abort(fatal)
            return
        for r, rec, info in adopts:
            self._log("M", "WARN",
                      f"adopting spare #{rec.idx} into rank {r} "
                      f"(epoch {epoch}, resume seq {info['seq']})")
            self._send_spare(rec, ("adopt", info))
        if release is None:
            return
        (kind, epoch, info, targets, extra_lines, release_gens,
         evict_notify) = release
        # planned-eviction release, ordered for the victim
        # race: the ("evicted",) push rides the still-open channel
        # FIRST (its slot is already quiet, so inbound noise cannot
        # close it), only then does the slot go fully dead — and the
        # epoch releases to the survivors + joiner after that
        for slot, r, msg in evict_notify:
            try:
                with slot.lock:
                    slot.ch.send_obj(("evicted", msg))
            except (Mp4jError, OSError):
                pass    # the victim died anyway; nothing to release
            slot.dead = True
        for line in extra_lines:
            self._log("M", "ERROR", line)
        if kind == "abort":
            self._log("M", "WARN",
                      f"abort round complete: releasing epoch {epoch} "
                      f"to all ranks")
            for r in targets:
                self._send_to(r, ("abort_go", epoch))
        elif kind == "replace":
            self._log("M", "WARN",
                      f"membership round complete: rank(s) "
                      f"{sorted(info['replaced'])} replaced from warm "
                      f"spares; releasing epoch {epoch}")
            for r in targets:
                self._send_to(r, ("abort_go", epoch, info))
        elif kind == "shrink":
            self._log("M", "WARN",
                      f"membership round complete: shrunk to "
                      f"{self.slave_num} rank(s) "
                      f"(dropped {info['shrink']['departed']}); "
                      f"releasing epoch {epoch}")
            for r in targets:
                self._send_to(r, ("abort_go", epoch, info))
            for gen in release_gens:
                for r in range(self.slave_num):
                    self._send_to(r, ("barrier_release", gen))
        # a membership change can complete a pending resize round
        # (shrink: the dead rank was the only missing arrival)
        self._check_resize_complete()

    # -- planned eviction ------------------------------------
    def request_planned_evict(self, rank: int, why: str) -> bool:
        """Proactively replace a LIVE rank from a warm spare at the
        next collective boundary — the autoscaler's actuation hook
        (callable by an operator too). Opens a membership round of
        kind ``evict``: every rank (victim included) quiesces through
        the epoch-fenced abort round, the lowest live NON-victim
        survivor donates the adoption manifest, a spare is adopted
        into the victim's id, and the victim is released with a clean
        :class:`~ytk_mp4j_tpu_torch.exceptions.Mp4jEvicted` while everyone
        else continues bit-exactly — the proactive twin of the
        death-driven replace path.

        Returns False (nothing opened) when the request cannot start:
        wrong elastic mode, a round or fence already open, the rank
        gone, no live peer to donate the manifest, or no spare
        available. Everything is validated HERE under the lock — the
        caller's snapshot may be stale, and a refusal is always safe.

        The quiesce is a two-step: first the soft FENCE parks every
        live rank at its next outermost collective entry (the wire
        untouched — a fence that cannot complete cancels for free),
        and only a fully-fenced cluster opens the abort round, so the
        round's teardown can never manufacture the per-collective
        mixed-progress fatal on a healthy job."""
        why = str(why)[:300]
        with self._lock:
            live = set(range(self.slave_num)) - set(self._departed)
            ok = (self.elastic in ("replace", "grow")
                  and self._fatal_msg is None
                  and self._abort_since is None
                  and self._grow_state is None
                  and self._evict_fence is None
                  and rank in live and len(live) >= 2
                  and self._next_spare_locked() is not None
                  # rendezvous must have seated every rank (a request
                  # this early has no slot to fence)
                  and len(self._slots) >= self.slave_num
                  and 0 <= rank < len(self._slots)
                  and not (self._slots[rank].dead
                           or self._slots[rank].quiet))
            if not ok:
                return False
            self._fence_seq += 1
            token = self._fence_seq
            self._evict_fence = {"token": token, "rank": rank,
                                 "why": why, "acks": {},
                                 "goal": 0,
                                 "since": time.monotonic()}
        self._log("M", "WARN",
                  f"planned eviction: fencing the job at the next "
                  f"collective boundary to replace LIVE rank {rank} "
                  f"({why})")
        for r in sorted(live):
            self._send_to(r, ("fence", token))
        self._check_fence()
        return True

    def _handle_fence_ack(self, rank: int, payload: dict) -> None:
        with self._lock:
            f = self._evict_fence
            if f is None or int(payload.get("token", -1)) != f["token"]:
                return          # stale fence
            f["acks"][rank] = int(payload.get("seq", 0))
        self._check_fence()

    def _check_fence(self) -> None:
        """Evaluate the armed eviction fence: complete it into an
        abort round once every live rank is provably at a boundary
        (fence ack, or idle in a barrier/resize wait — SPMD makes
        those states schedule-equivalent), or cancel it (fence
        release, zero disruption) when it can no longer succeed:
        victim gone, a real round opened, the pool drained, or the
        deadline passed (a rank deep in application compute never
        reaches a boundary — retrying later is free)."""
        start = None
        cancel = None
        advance = None
        push = None     # tuner fence completion
        with self._lock:
            f = self._evict_fence
            if f is None:
                return
            kind = f.get("kind", "evict")
            live = set(range(self.slave_num)) - set(self._departed)
            victim = f["rank"]
            now = time.monotonic()
            if self._fatal_msg is not None:
                cancel = "job is terminally aborting"
            elif self._abort_since is not None:
                cancel = "a membership/abort round opened meanwhile"
            elif self._grow_state is not None:
                # the mirror of _complete_resize's fence guard: two
                # concurrent membership rounds over one roster would
                # finalize in either order and silently resurrect
                # stale entries
                cancel = "a grow round is in flight"
            elif kind == "evict" and (
                    victim not in live or len(live) < 2
                    or self._slots[victim].dead
                    or self._slots[victim].quiet):
                cancel = f"rank {victim} is no longer an evictable " \
                         "member"
            elif kind == "evict" \
                    and self._next_spare_locked() is None:
                cancel = "the warm-spare pool drained"
            elif now - f["since"] > self._fence_secs:
                missing = sorted(live - set(f["acks"]))
                cancel = (f"rank(s) {missing} did not reach a "
                          f"collective boundary within "
                          f"{self._fence_secs:.1f}s")
            else:
                idle = set(f["acks"])
                for ranks in self._barrier_waiting.values():
                    idle.update(ranks)
                for ranks in self._resize_waiting.values():
                    idle.update(ranks)
                # starvation rule: a rank parked at an
                # ordinal BEHIND a peer's position starves every
                # in-flight batch that still needs it — advance the
                # laggards to the global max ordinal (acked positions
                # plus the un-acked ranks' heartbeat in-flight seqs)
                # and only complete the fence when every parked rank
                # sits at the SAME boundary
                seqs = set(f["acks"].values())
                hb_max = max(
                    (int(self._telemetry[r]["seq"])
                     for r in live - set(f["acks"])
                     if r in self._telemetry), default=0)
                # the goal never decreases, but an ack BELOW an
                # already-set goal must still be advanced (a rank
                # acking late at a low seq would otherwise stall the
                # fence to its deadline: goal>f["goal"] is false yet
                # the seqs can never equalize)
                goal = max([hb_max, f["goal"],
                            *f["acks"].values()], default=0)
                laggards = [r for r, s in f["acks"].items()
                            if s < goal]
                if kind == "tuner":
                    # the tuner update needs every live rank PARKED at
                    # one boundary via an explicit ack. Starvation
                    # rule, sharpened for hot blocking jobs: a rank
                    # BLOCKED INSIDE ordinal K reports the same
                    # entered-seq as a rank PARKED AT K's entry (the
                    # wrapper bumps before the park), so equal seqs
                    # can still hide a deadlock — the parked ranks
                    # starve the blocked ones. Whenever an unacked
                    # rank's heartbeat position is at or past a parked
                    # rank's, advance the parked ranks PAST that
                    # ordinal (goal = max + 1 — strictly above their
                    # entered seq, which is what wakes the slave-side
                    # park); they run it, everyone converges on the
                    # next boundary and re-acks.
                    acked = set(f["acks"])
                    hb_unacked = [
                        int(self._telemetry[r]["seq"])
                        for r in live - acked if r in self._telemetry]
                    goal = None
                    if live <= acked and len(seqs) <= 1:
                        self._evict_fence = None
                        push = (f["token"], dict(f["payload"]),
                                sorted(live))
                    elif live <= acked:
                        # every rank parked, at UNEQUAL boundaries
                        # (rooted/partial collectives let a rank
                        # complete ordinals a peer never touched):
                        # advance the behind ranks to the front
                        # rank's position — max(seqs) exceeds their
                        # entered seq, so the slave-side park wakes
                        goal = max(max(seqs), f["goal"])
                    elif (f["acks"] and hb_unacked
                          and max(hb_unacked)
                          >= min(f["acks"].values())):
                        goal = max(max(hb_unacked) + 1, f["goal"])
                    if goal is not None:
                        laggards = [r for r, s in f["acks"].items()
                                    if s < goal]
                        if laggards:
                            f["goal"] = goal
                            for r in laggards:
                                del f["acks"][r]
                            advance = (f["token"], goal, laggards)
                elif laggards:
                    f["goal"] = goal
                    for r in laggards:
                        del f["acks"][r]
                    advance = (f["token"], goal, laggards)
                elif live <= idle and len(seqs) <= 1:
                    self._evict_fence = None
                    self._open_round_locked(self._abort_epoch + 1)
                    self._round_kind = "evict"
                    self._round_why = (f"planned eviction of rank "
                                       f"{victim}: {f['why']}")
                    self._round_evict = {victim: f["why"]}
                    self._round_evict_slots = {
                        victim: self._slots[victim]}
                    donor = min(live - {victim})
                    self._round_manifest_from = donor
                    start = (self._abort_epoch, donor, sorted(live))
            if cancel is not None:
                token = f["token"]
                self._evict_fence = None
                if kind == "evict":
                    self._membership.note_evict_cancel(
                        victim, token, cancel)
        if cancel is not None:
            self._log("M", "WARN",
                      f"{'tuner' if kind == 'tuner' else 'eviction'} "
                      f"fence canceled ({cancel}); releasing "
                      "the parked ranks untouched")
            for r in sorted(self._live_ranks()):
                self._send_to(r, ("fence_release", token))
            return
        if advance is not None:
            token, goal, laggards = advance
            self._log("M", "WARN",
                      f"eviction fence: advancing rank(s) {laggards} "
                      f"to ordinal {goal} (a peer's in-flight batch "
                      "still needs them)")
            for r in laggards:
                self._send_to(r, ("fence_advance", token, goal))
            return
        if push is not None:
            # tuner fence complete: every live rank is
            # parked at the SAME collective boundary — push the
            # leader overrides (applied on each rank's ctl thread),
            # THEN release the fence: the master channel is ordered,
            # so every rank applies before its collective thread
            # resumes. Atomic topology switch, wire untouched.
            token, overrides, targets = push
            with self._tuner_lock:
                ctl = self._tuner_ctl
                if ctl is not None:
                    ctl["overrides"] = dict(overrides)
                    ctl["version"] += 1
                    ctl["demotions"] += 1
            self._log("M", "WARN",
                      f"tuner fence complete: applying leader "
                      f"overrides {overrides} at a job-wide "
                      "collective boundary")
            for r in targets:
                self._send_to(r, ("tuner_leaders", overrides))
                self._send_to(r, ("fence_release", token))
            self._tuner_event(
                "demote", f"leader overrides {overrides} applied "
                f"(fence token {token})")
            return
        if start is None:
            return
        target, donor, targets = start
        self._log("M", "WARN",
                  f"eviction fence complete: every rank at a "
                  f"boundary; abort round -> epoch {target}")
        for r in targets:
            self._send_to(r, ("abort", target))
        self._send_to(donor, ("manifest_req", target))
        self._try_advance_round()

    def _finalize_replace_locked(self, epoch: int, live: set[int]):
        """All survivors acked, every casualty's spare acked its
        adoption: swap the roster, resurrect the replaced ranks and
        compose the go message (caller holds the lock and fans out).
        Planned evictions finalize through the same path —
        the difference is the victim is ALIVE: its pre-adoption slot
        goes ``quiet`` here (inbound dropped, channel kept) and the
        composed ``evict_notify`` pushes the clean ``("evicted",)``
        release before the epoch go."""
        repl = {r: rec.entry for r, rec in self._round_adopted.items()}
        self._roster = membership_mod.swap_roster(self._roster, repl)
        self._roster_gen += 1
        joiners = sorted(self._round_adopted)
        extra_lines: list[str] = []
        evict_notify: list[tuple[_Slot, int, str]] = []
        for r in joiners:
            rec = self._round_adopted[r]
            self._departed.pop(r, None)
            self._exit_codes.pop(r, None)
            if r in self._round_evict:
                why = self._round_evict.get(r, "")
                self._membership.note_evict(r, epoch, rec.idx, why)
                old = self._round_evict_slots.get(r)
                if old is not None:
                    old.quiet = True
                    evict_notify.append((old, r, (
                        f"rank {r} evicted by the autoscaler and "
                        f"replaced from warm spare #{rec.idx} @ epoch "
                        f"{epoch}: {why}")))
            else:
                self._membership.note_replace(
                    r, epoch, rec.idx, self._round_dead.get(r, ""))
            extra_lines.extend(
                self._auditor.note_replacement(
                    r, self._round_seq or 0))
            if self._health is not None:
                # the joiner starts HEALTHY with fresh baselines; the
                # reset alert is informational (the DEAD alert already
                # reached the durable sinks)
                extra_lines.extend(
                    "health: " + health_mod.format_alert(ev)
                    for ev in self._health.note_replacement(r))
        info = {"replaced": joiners, "roster": self._roster,
                "epoch": epoch}
        targets = sorted(live)
        self._abort_since = None
        self._round_kind = None
        self._round_dead = {}
        self._round_adoptions = {}
        self._round_adopted = {}
        self._round_evict = {}
        self._round_evict_slots = {}
        self._round_manifest = None
        self._round_manifest_from = None
        self._round_seq = None
        return ("replace", epoch, info, targets, extra_lines, (),
                evict_notify)

    def _finalize_shrink_locked(self, epoch: int):
        """All survivors acked a shrink round: renumber them
        contiguously, rebuild every rank-keyed table under the new
        numbering, and compose the go message (caller holds the lock
        and fans out)."""
        dead = set(self._departed)
        mapping = membership_mod.shrink_mapping(self.slave_num, dead)
        new_roster = membership_mod.shrink_roster(self._roster, mapping)
        dead_list = sorted(dead)
        new_slots: list = [None] * len(mapping)
        for old, new in mapping.items():
            slot = self._slots[old]
            slot.rank = new
            new_slots[new] = slot
        self._slots = new_slots
        self._roster = new_roster
        self._roster_gen += 1
        self.slave_num = len(mapping)
        self._rank_width = max(1, len(str(max(self.slave_num - 1, 0))))
        self._exit_codes = {mapping[r]: c for r, c
                            in self._exit_codes.items() if r in mapping}
        self._telemetry = {mapping[r]: t for r, t
                           in self._telemetry.items() if r in mapping}
        self._rank_windows = {mapping[r]: w for r, w
                              in self._rank_windows.items()
                              if r in mapping}
        self._rank_totals = {mapping[r]: t for r, t
                             in self._rank_totals.items() if r in mapping}
        self._departed = {}
        self._abort_progress = {}
        self._auditor.note_shrink(self.slave_num, mapping)
        if self._health is not None:
            self._health.note_shrink(self.slave_num, mapping)
        self._membership.note_shrink(dead_list, mapping, epoch,
                                     self._round_why)
        # pending resize generations renumber like barriers; a
        # generation completed by the shrink is picked up by the
        # _check_resize_complete scan after the release fan-out
        self._resize_waiting = {
            gen: [mapping[r] for r in ranks if r in mapping]
            for gen, ranks in self._resize_waiting.items()}
        # pending barriers renumber too; one now-complete generation
        # (every survivor already arrived, only the dead were missing)
        # releases on the way out
        release_gens = []
        for gen, ranks in list(self._barrier_waiting.items()):
            self._barrier_waiting[gen] = [
                mapping[r] for r in ranks if r in mapping]
            if len(self._barrier_waiting[gen]) == self.slave_num:
                release_gens.append(gen)
                self._barrier_max_released = max(
                    self._barrier_max_released, gen)
                del self._barrier_waiting[gen]
                self._barrier_since.pop(gen, None)
        info = {"shrink": {"roster": new_roster, "ranks": mapping,
                           "departed": dead_list, "epoch": epoch}}
        targets = sorted(mapping.values())
        self._abort_since = None
        self._round_kind = None
        self._round_dead = {}
        self._round_manifest = None
        self._round_manifest_from = None
        self._round_seq = None
        return ("shrink", epoch, info, targets, [], release_gens, ())

    # -- warm spares -----------------------------------------
    def _register_spare(self, ch: Channel, entry: tuple) -> None:
        """Park a warm-spare registration: ack it, pool it, and start
        its serve thread (pings until adopted)."""
        with self._lock:
            idx = self._spare_seq
            self._spare_seq += 1
            rec = membership_mod.SpareRecord(idx, ch, entry)
            self._spare_pool.append(rec)
            # the registration EVENT is what a pending provision
            # action resolves on — a waiting round may claim this
            # spare before any status snapshot shows the pool > 0
            self._membership.note_spare(idx)
        try:
            ch.send_obj({"spare": idx, "job": self.job_id})
        except (Mp4jError, OSError):
            self._spare_gone(rec, "died during registration")
            return
        t = threading.Thread(target=self._serve_spare, args=(rec,),
                             daemon=True, name=f"master-spare{idx}")
        with self._lock:
            self._spare_threads.append(t)
        t.start()
        self._log("M", "INFO",
                  f"warm spare #{idx} registered "
                  f"({entry[0]}:{entry[1]})")
        # a membership round waiting out an exhausted pool (
        # an evict round that cannot safely abandon) resumes the
        # moment a fresh spare registers
        self._try_advance_round()

    def _spare_accept_loop(self) -> None:
        """Post-rendezvous listener: only spare registrations are
        accepted mid-job (a late non-spare dial-in has no rank to
        claim)."""
        while not self._stop.is_set():
            try:
                sock, addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return          # listener closed with serve()
            ch = TcpChannel(sock)
            try:
                ch.set_timeout(self.handshake_timeout)
                kind, payload = ch.recv()
                ok = (kind == REGISTER and isinstance(payload, dict)
                      and bool(payload.get("spare")))
                entry = ((str(payload.get("host") or addr[0]),
                          int(payload["listen_port"]),
                          str(payload.get("fp") or ""))
                         if ok else None)
            except Exception:
                ok = False
            if not ok:
                ch.close()
                continue
            ch.set_timeout(None)
            self._register_spare(ch, entry)

    def _serve_spare(self, rec) -> None:
        """Read one spare's control channel: liveness pings until an
        adoption completes — then this THREAD becomes the adopted
        rank's serve thread (the channel is the same object; only its
        role changes)."""
        slot = None
        try:
            while True:
                kind, payload = rec.ch.recv()
                if kind == SPARE_PING:
                    rec.last_ping = time.monotonic()
                elif kind == ADOPT_ACK:
                    slot = self._finish_adoption(rec)
                    if slot is not None:
                        break
                elif kind == LOG:
                    self._log(f"s{rec.idx}", payload["level"],
                              payload["msg"])
                elif kind == CLOSE:
                    # a spare shutting down cleanly before adoption
                    try:
                        rec.ch.send_obj("closed")
                    except (Mp4jError, OSError):
                        pass
                    rec.ch.close()
                    self._spare_gone(rec, "closed")
                    return
                # anything else from an unadopted spare is noise
        except Exception as e:
            self._spare_gone(rec, f"connection lost ({e!r})")
            return
        self._serve_slave(slot)

    def _finish_adoption(self, rec):
        """An adopted spare acked: install its channel as the rank's
        slot and hand the round machinery the news. Returns the slot
        (the caller's thread continues as the rank's serve thread), or
        None when the ack is stale."""
        with self._lock:
            r = rec.adopting_rank
            if r is None or self._fatal_msg is not None:
                return None
            rec.adopt_since = None
            slot = _Slot(r, rec.ch)
            if rec.grow:
                # grow adoption: a NEW rank id — the slot
                # list extends (acks may land out of rank order; the
                # padding slots fill as their own acks arrive, and the
                # roster/slave_num only advance at grow finalize)
                gs = self._grow_state
                if gs is None or gs["pending"].get(r) is not rec:
                    return None     # grow aborted meanwhile
                del gs["pending"][r]
                gs["adopted"][r] = rec
                while len(self._slots) <= r:
                    self._slots.append(None)
                self._slots[r] = slot
            else:
                self._slots[r] = slot
                self._round_adopted[r] = rec
            if rec in self._spare_pool:
                self._spare_pool.remove(rec)
            # the dead occupant's telemetry must not pollute the
            # joiner's: fresh windows, fresh deltas (cluster TOTALS
            # keep the dead rank's history — it really happened)
            self._telemetry.pop(r, None)
            self._rank_windows.pop(r, None)
            self._rank_totals.pop(r, None)
            self._serve_threads.append(threading.current_thread())
        self._log("M", "WARN",
                  f"spare #{rec.idx} adopted as rank {r}"
                  + (" (grow)" if rec.grow else ""))
        if rec.grow:
            self._try_advance_grow()
        else:
            self._try_advance_round()
        return slot

    def _send_spare(self, rec, obj) -> None:
        try:
            rec.ch.send_obj(obj)
        except (Mp4jError, OSError):
            self._spare_gone(rec, "unreachable on adopt push")

    def _spare_gone(self, rec, why: str) -> None:
        """A spare died (pre- or mid-adoption): drop it from the pool,
        un-assign any in-flight adoption and re-drive the round — the
        next spare is tried, or the round goes terminal through the
        no-spare path."""
        retry = False
        retry_evict = False
        retry_grow = False
        with self._lock:
            rec.alive = False
            if rec in self._spare_pool:
                self._spare_pool.remove(rec)
            r = rec.adopting_rank
            rec.adopting_rank = None
            rec.adopt_since = None
            if r is not None and self._round_adoptions.get(r) is rec:
                del self._round_adoptions[r]
                # a planned-eviction round retries (or abandons)
                # through its own branch — _begin_membership would
                # misread the round as a death
                retry_evict = self._round_kind == "evict"
                retry = not retry_evict
            gs = self._grow_state
            if (rec.grow and gs is not None
                    and gs["pending"].get(r) is rec):
                del gs["pending"][r]
                retry_grow = True
            round_why = self._round_why
        self._log("M", "WARN", f"warm spare #{rec.idx} lost: {why}")
        try:
            rec.ch.close()
        except OSError:
            pass
        if retry:
            # re-enter through _begin_membership so the no-spare path
            # produces the same clean fatal as never having had one
            self._begin_membership({}, round_why or
                                   f"spare #{rec.idx} died mid-adoption")
            self._try_advance_round()
        elif retry_evict:
            # the evict branch assigns the next spare, or abandons the
            # eviction and releases a plain abort (never fatal)
            self._try_advance_round()
        if retry_grow:
            self._retry_grow_adoption(
                r, f"spare #{rec.idx} died mid-grow-adoption")

    def _release_spares(self, reason: str) -> None:
        with self._lock:
            pool = list(self._spare_pool)
            self._spare_pool = []
            threads = list(self._spare_threads)
        for rec in pool:
            try:
                rec.ch.send_obj(("release", reason))
            except (Mp4jError, OSError):
                pass
            try:
                rec.ch.close()
            except OSError:
                pass
        me = threading.current_thread()
        for t in threads:
            # the fatal path can be DRIVEN from a spare's own serve
            # thread (last spare dies mid-adoption -> no-spare fatal);
            # joining it would raise "cannot join current thread"
            if t is not me:
                t.join(2.0)

    @staticmethod
    def _mixed_progress(progress: dict) -> str | None:
        """Recovery is PER-COLLECTIVE: a round may only be released
        when every in-flight rank is retrying the SAME collective
        ordinal m, and every idle rank sits exactly one behind (it
        will enter m fresh). Any other shape means the fault spans a
        collective boundary — a rank that already completed m cannot
        re-serve its contribution (its input snapshot is gone), so
        retrying would deadlock or, worse, pair mismatched exchanges
        into silently wrong results. Returns the terminal message, or
        None when consistent."""
        inflight = {r: s for r, (s, f) in progress.items() if f}
        if not inflight:
            return None
        m = max(inflight.values())
        bad = {r: s for r, (s, f) in progress.items()
               if (f and s != m) or (not f and s != m - 1)}
        if not bad:
            return None
        detail = ", ".join(
            f"rank {r} at collective #{s}"
            f"{' (in flight)' if progress[r][1] else ' (completed)'}"
            for r, s in sorted(bad.items()))
        return (f"cannot recover: the fault spans a collective "
                f"boundary — ranks retrying collective #{m} but "
                f"{detail}; recovery is per-collective (align the "
                "schedule, e.g. with a barrier, to make this fault "
                "window recoverable)")

    def _fatal_abort(self, msg: str) -> None:
        """Fan the terminal abort out to every live rank, once. The
        message is composed HERE so all ranks raise identically."""
        with self._lock:
            if self._fatal_msg is not None:
                return
            self._fatal_msg = msg
            self._abort_since = None
        self._log("M", "ERROR", f"terminal abort: {msg}")
        for line in self.diagnose():
            self._log("M", "WARN", line)
        # flight recorder: write the manifest NOW (survivors may be
        # about to exit); serve() refreshes it once the slaves' final
        # fatal-path telemetry flushes have landed
        self._write_postmortem_manifest()
        for r in sorted(self._live_ranks()):
            self._send_to(r, ("abort_fatal", msg))
        # idle spares raise Mp4jSpareReleased instead of outliving
        # the job they were provisioned for
        self._release_spares(msg)

    def _log(self, rank, level: str, msg: str):
        """Centralized log sink: ISO-8601 timestamps and a fixed-width
        ``[rank/size LEVEL]`` prefix so interleaved multi-rank logs are
        sortable and greppable; lines below ``MP4J_LOG_LEVEL`` are
        dropped. ``rank`` may be the string ``"M"`` for master-origin
        lines (watchdog, rendezvous)."""
        if tuning.LOG_LEVELS.get(level, tuning.LOG_LEVELS["INFO"]) \
                < self._min_level:
            return
        now = time.time()
        ts = (time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(now))
              + f".{int(now % 1 * 1000):03d}")
        who = f"{rank!s:>{self._rank_width}}"
        print(f"{ts} [{who}/{self.slave_num} {level:<5}] {msg}",
              file=self.log_stream, flush=True)

    # -- telemetry ------------------------------------------------------
    def _record_telemetry(self, rank: int, payload: dict) -> None:
        """Fold one heartbeat into the rolling cluster time-series.

        The beat carries DELTAS (``stats_delta`` /
        ``metrics_delta``) folded onto the rank's cumulative view;
        a full ``stats`` snapshot (older senders, external tools)
        replaces it instead. Each fold also advances the rank's and
        the cluster's rate rings, so windowed GB/s / collectives/s /
        keys/s stay derivable without a second pass."""
        progress = payload.get("progress") or {}
        now = time.monotonic()
        audit_lines: list[str] = []
        health_alerts: list[dict] = []
        with self._lock:
            live = set(range(self.slave_num)) - set(self._departed)
            new_divergences: list[dict] = []
            if "audit_delta" in payload:
                # verification happens as records complete — a flagged
                # divergence is logged within one heartbeat of the last
                # rank's record arriving; log lines emitted OUTSIDE the
                # lock below
                before_div = self._auditor.divergence_total
                audit_lines = self._auditor.fold(
                    rank, payload.get("audit_delta"), live)
                grew = self._auditor.divergence_total - before_div
                if grew:
                    new_divergences = list(
                        self._auditor.divergences)[-grew:]
            if self._health is not None:
                # the health plane folds the SAME beat: baselines,
                # detectors, the online dominator over the shipped
                # cells, and audit-divergence escalation — alert
                # dispatch (log + push to the subject rank) happens
                # outside the lock below
                health_alerts = self._health.fold(
                    rank, payload, now, live)
                if new_divergences:
                    health_alerts.extend(self._health.note_audit(
                        new_divergences, live))
            prev = self._telemetry.get(rank)
            if "stats_delta" in payload:
                stats = stats_mod.merge_snapshots(
                    prev["stats"] if prev else {},
                    payload.get("stats_delta") or {})
            else:
                stats = (payload.get("stats")
                         or (prev["stats"] if prev else {}))
            delta = payload.get("metrics_delta") or {}
            metrics = metrics_mod.fold_snapshot(
                (prev or {}).get("metrics") or {}, delta)
            self._cluster_metrics = metrics_mod.fold_snapshot(
                self._cluster_metrics, delta)
            self._telemetry[rank] = {
                "seq": int(progress.get("seq", 0)),
                "current": progress.get("current"),
                "last": progress.get("last"),
                "phase": progress.get("phase"),
                "current_secs": float(progress.get("current_secs", 0.0)),
                # per-rank recovery epoch: `mp4j-scope
                # live` renders it next to the roster badges
                "epoch": int(progress.get("epoch", 0)),
                "stats": stats,
                "metrics": metrics,
                "mono": now,
                # per-rank tuner document: decisions
                # applied/would-apply, trip state — `mp4j-scope tuner`
                "tuner": payload.get("tuner"),
            }
            win = self._rank_windows.get(rank)
            if win is None:
                win = self._rank_windows[rank] = metrics_mod.RateWindow(
                    self._metrics_window)
            totals = self._stats_totals(stats)
            win.note(now, totals)
            # running cluster totals: add this rank's movement since
            # its last fold — O(1 rank) per beat, not a re-sum of every
            # rank's whole stats table under the master lock
            before = self._rank_totals.get(rank, {})
            for k, v in totals.items():
                self._cluster_totals[k] = (self._cluster_totals.get(k, 0)
                                           + v - before.get(k, 0))
            self._rank_totals[rank] = totals
            self._cluster_window.note(now, self._cluster_totals)
        for line in audit_lines:
            self._log("M", "ERROR", line)
        self._dispatch_health_alerts(health_alerts)
        self._tuner_tick(new_divergences, rank=rank,
                         tuner_doc=payload.get("tuner"))

    def _dispatch_health_alerts(self, alerts: list[dict]) -> None:
        """Emit freshly minted health alerts: one master log line
        each, plus a control-plane push to the SUBJECT rank (its
        recovery log and durable sink make the verdict durable). A
        dead/missing subject's alert lands on the lowest live rank
        instead — the evidence must outlive the patient."""
        if not alerts:
            return
        live = self._live_ranks()
        for ev in alerts:
            level = ("ERROR" if ev.get("to") in (
                "SUSPECT", "EVICT_RECOMMENDED", "DEAD") else "WARN")
            self._log("M", level,
                      "health: " + health_mod.format_alert(ev))
            target = ev.get("rank")
            if ev.get("to") == "DEAD" or target not in live:
                # never push a DEAD verdict at its own subject — the
                # channel is the thing that just died, and the failed
                # push would re-enter the death path as "unreachable
                # on push"; the evidence lands on the lowest OTHER
                # live rank instead
                target = next((r for r in sorted(live)
                               if r != ev.get("rank")), None)
            if target is not None and 0 <= target < len(self._slots):
                self._send_to(target, ("health_alert", ev))

    def _autoscale_event(self, ev: dict, level: str = "WARN") -> None:
        """Land one structured autoscaler event everywhere at once
        (the repo precedent): master log line, plus the
        health-alert control push to the lowest live rank — whose
        recovery log and durable sink make the action history outlive
        the master, and whose ``alerts`` records interleave actions
        with verdict transitions in every ``mp4j-scope health``
        timeline. Called by the autoscaler WITHOUT the master lock
        held (the push takes per-slot locks only)."""
        self._log("M", level,
                  "autoscale: " + health_mod.format_alert(ev))
        target = next(iter(sorted(self._live_ranks())), None)
        if target is not None and 0 <= target < len(self._slots):
            self._send_to(target, ("health_alert", ev))

    def autoscale_status(self) -> dict | None:
        """The autoscaler document: mode, per-action
        counters, observed (would-be) actions, budget, circuit-breaker
        state, the in-flight action and the bounded event history
        (schema: resilience.autoscaler.Autoscaler.status). None when
        ``MP4J_AUTOSCALE=off``."""
        return (self._autoscaler.status()
                if self._autoscaler is not None else None)

    # -- self-tuning data plane, master half ----------------
    def _tuner_event(self, kind: str, msg: str,
                     rank: int | None = None,
                     level: str = "WARN") -> dict:
        """Mint + dispatch one structured tuner event through the
        health-alert pipe (the autoscaler precedent): master log line
        plus a control push to the lowest live rank, whose recovery
        log and durable sink make the history outlive the master.
        Ids are negative in a range disjoint from the autoscaler's
        (-1e6 - seq) so timeline dedup can never collide. Called
        WITHOUT the master or tuner lock held."""
        with self._tuner_lock:
            ctl = self._tuner_ctl
            if ctl is None:
                # operator-driven request_tuner_leaders with the
                # controller off: still log + dispatch, nothing to
                # record
                ctl = {"event_seq": int(time.monotonic() * 1000) % 1000,
                       "mode": "off", "events": []}
            ctl["event_seq"] += 1
            ev = {"id": -(1_000_000 + ctl["event_seq"]),
                  "wall": time.time(), "kind": "tuner", "event": kind,
                  "rank": rank, "mode": ctl["mode"], "msg": msg}
            ctl["events"] = (ctl["events"] + [ev])[-32:]
        self._log("M", level, "tuner: " + health_mod.format_alert(ev))
        target = next(iter(sorted(self._live_ranks())), None)
        if target is not None and 0 <= target < len(self._slots):
            self._send_to(target, ("health_alert", ev))
        return ev

    def _tuner_tick(self, new_divergences: list[dict],
                    rank: int | None = None,
                    tuner_doc: dict | None = None) -> None:
        """One controller evaluation, run after every telemetry fold:
        (1) the AUDIT RAIL — any fresh cross-rank digest divergence
        trips every rank's tuner back to static defaults, latched for
        the job (re-pushed to any rank whose heartbeat shows an
        untripped tuner — a replacement/grow joiner constructs fresh
        and must inherit the latch); (2) the DOMINATOR watch — feed
        the health engine's cause-aware rows to the pure
        leader-demotion policy and, in act mode, actuate through a
        fenced topology update. ``rank``/``tuner_doc`` describe the
        heartbeat that triggered this tick."""
        ctl = self._tuner_ctl
        if ctl is None:
            return
        trip_why = None
        proposal = None
        relatch = None
        revert_overrides = False
        with self._tuner_lock:
            if new_divergences and ctl["tripped"] is None:
                d = new_divergences[0]
                trip_why = (f"cross-rank audit divergence at "
                            f"collective #{d.get('seq')}: "
                            f"{str(d.get('err'))[:160]}")
                ctl["tripped"] = trip_why
                revert_overrides = bool(ctl["overrides"])
            elif ctl["tripped"] is not None:
                # latched: maintenance only — re-latch late joiners
                # whose fresh tuner reports untripped, and keep
                # retrying the fenced revert of any leader overrides
                # still live ("back to static defaults" covers the
                # topology too; the fence may have been busy)
                if (tuner_doc is not None
                        and not tuner_doc.get("tripped")
                        and rank is not None):
                    relatch = (rank, ctl["tripped"])
                revert_overrides = bool(ctl["overrides"])
            elif (self._health is not None
                  and time.monotonic() - ctl["last_action"]
                  >= self._tuner_cooldown):
                rows = self._health.dominator_rows()
                with self._lock:
                    roster = list(self._roster)
                groups = tuner_mod.host_groups(roster)
                proposal = tuner_mod.decide_leaders(
                    rows, groups, ctl["overrides"])
                if proposal is not None:
                    ctl["last_action"] = time.monotonic()
        if relatch is not None:
            self._send_to(relatch[0], ("tuner_trip", relatch[1]))
        if trip_why is not None:
            for r in sorted(self._live_ranks()):
                self._send_to(r, ("tuner_trip", trip_why))
            self._tuner_event("trip", trip_why, level="ERROR")
        if revert_overrides:
            # fenced topology revert; a busy fence/round returns
            # False and the next tick retries
            self.request_tuner_leaders({})
            return
        if trip_why is not None or proposal is None:
            return
        if ctl["mode"] != "act":
            self._tuner_event(
                "would_demote",
                f"would demote leader(s) to {proposal} "
                "(observe mode — no action)")
            return
        if not self.request_tuner_leaders(proposal):
            self._tuner_event(
                "demote_skipped",
                f"leader demotion to {proposal} could not start "
                "(round/fence in flight?) — retrying after cooldown")

    def request_tuner_leaders(self, overrides: dict[int, int]) -> bool:
        """Apply a tuner leader-override map job-wide through a FENCE
        (callable by an operator too): park every live rank at the
        same outermost-collective boundary, push ``tuner_leaders``,
        release. Unlike the eviction fence nothing is torn down and
        no spare is needed — a fence that cannot complete cancels
        with zero disruption and the controller retries after its
        cooldown. Returns False when the request cannot start (a
        round or fence already open, rendezvous incomplete)."""
        with self._lock:
            ok = (self._fatal_msg is None
                  and self._abort_since is None
                  and self._grow_state is None
                  and self._evict_fence is None
                  and len(self._slots) >= self.slave_num)
            if not ok:
                return False
            self._fence_seq += 1
            token = self._fence_seq
            live = set(range(self.slave_num)) - set(self._departed)
            self._evict_fence = {
                "token": token, "kind": "tuner", "rank": None,
                "payload": {int(k): int(v)
                            for k, v in (overrides or {}).items()},
                "why": "tuner leader update", "acks": {}, "goal": 0,
                "since": time.monotonic()}
        self._log("M", "WARN",
                  f"tuner: fencing the job at the next collective "
                  f"boundary to apply leader overrides {overrides}")
        for r in sorted(live):
            self._send_to(r, ("fence", token))
        self._check_fence()
        return True

    def tuner_status(self) -> dict | None:
        """The self-tuning data plane's master document (
        None with ``MP4J_TUNER=off``): mode, live leader overrides,
        demotion count, trip state, recent controller events, and the
        per-rank tuner summaries from the heartbeats."""
        ctl = self._tuner_ctl
        if ctl is None:
            return None
        with self._tuner_lock:
            doc = {k: (dict(v) if isinstance(v, dict) else
                       list(v) if isinstance(v, list) else v)
                   for k, v in ctl.items() if k != "event_seq"}
        with self._lock:
            doc["ranks"] = {r: t.get("tuner")
                            for r, t in self._telemetry.items()
                            if t.get("tuner") is not None}
        return doc

    def _handle_diagnose(self, rank: int, payload: dict) -> None:
        """A slave's bounded collective wait expired: refresh its table
        entry from the report itself (fresher than its last heartbeat),
        then log the cluster-wide diagnosis — ONCE per incident. When
        one rank stalls, every other rank's bounded wait expires in the
        same window; without the debounce (keyed on the cluster's max
        sequence number) a 256-rank job would bury the one useful
        report under ~N full per-rank dumps."""
        self._record_telemetry(rank, payload)
        self._log(rank, "ERROR",
                  f"collective '{payload.get('collective')}' failed: "
                  f"{payload.get('error')}")
        with self._lock:
            incident = max((t["seq"] for t in self._telemetry.values()),
                           default=0)
            repeat = incident == self._diag_incident_seq
            self._diag_incident_seq = incident
        if repeat:
            self._log("M", "WARN",
                      f"rank {rank} reports the same incident (max seq "
                      f"{incident}) — full diagnosis already logged above")
            return
        for line in self.diagnose():
            self._log("M", "WARN", line)

    def _snapshot_table(self) -> dict[int, dict]:
        """One heartbeat-table snapshot (progress fields + age) —
        the shared shape behind the diagnosis, the metrics document
        and the postmortem manifest. Caller must NOT hold the lock."""
        now = time.monotonic()
        with self._lock:
            return {r: {**{k: t.get(k) for k in
                           ("seq", "current", "last", "phase",
                            "current_secs", "epoch")},
                        "age": now - t["mono"]}
                    for r, t in self._telemetry.items()}

    def diagnose(self) -> list[str]:
        """Render the hang/straggler diagnosis from the heartbeat
        table (obs.telemetry.render_diagnosis)."""
        return telemetry_mod.render_diagnosis(self._snapshot_table(),
                                              self.slave_num)

    def cluster_stats(self) -> dict[str, dict]:
        """Cross-rank skew per collective family from the latest
        heartbeat stats snapshots (schema:
        obs.telemetry.cluster_skew)."""
        with self._lock:
            per_rank = {r: t["stats"] for r, t in self._telemetry.items()
                        if t.get("stats")}
        return telemetry_mod.cluster_skew(per_rank)

    def format_cluster_stats(self) -> str:
        """The ``mp4j-scope report`` table, live from the master."""
        return telemetry_mod.format_skew(self.cluster_stats())

    # -- live metrics plane -----------------------------------
    def _start_metrics_server(self, host: str, port: int) -> None:
        """Bind the control-plane HTTP metrics endpoint. Loopback by
        default (host "" would mean every interface for the DATA
        master socket too, but metrics add nothing a peer needs — an
        operator scrapes where the master runs, or passes an explicit
        host)."""
        master = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):         # noqa: N802
                if self.path in ("/metrics", "/metrics/"):
                    body = metrics_mod.to_prometheus(
                        master.metrics_doc()).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path in ("/metrics.json", "/json"):
                    body = json.dumps(master.metrics_doc()).encode()
                    ctype = "application/json"
                elif self.path in ("/health.json", "/health"):
                    # the verdict document over HTTP (the autoscaler's
                    # surface): external orchestrators — a k8s
                    # operator, a cron — read evict recommendations
                    # without being in-process. Stamped with the job
                    # identity so a fleet scraper can
                    # correlate it with /metrics.json and detect a
                    # master restart; the health keys stay `enabled:
                    # false` (not JSON null) under MP4J_HEALTH=0 so
                    # the stamp always has a document to ride
                    hdoc = master.health_status() or {"enabled": False}
                    body = json.dumps(
                        {**hdoc, **master.job_doc()}).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                # control-plane responses are point-in-time telemetry:
                # any intermediary cache would hand a fleet scraper a
                # stale document that looks fresh
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes are not log lines
                pass

        srv = http.server.ThreadingHTTPServer(
            (host or "127.0.0.1", port), Handler)
        srv.daemon_threads = True
        self._metrics_server = srv
        self.metrics_port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True,
                         name="mp4j-metrics-http").start()

    def _stop_metrics_server(self) -> None:
        srv, self._metrics_server = self._metrics_server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()

    @staticmethod
    def _stats_totals(stats: dict) -> dict[str, float]:
        """Cumulative totals the rate windows differentiate."""
        return {
            "bytes": sum(e.get("bytes_sent", 0) + e.get("bytes_recv", 0)
                         for e in stats.values()),
            "collectives": sum(e.get("calls", 0)
                               for e in stats.values()),
            "keys": sum(e.get("keys", 0) for e in stats.values()),
        }

    def job_doc(self) -> dict:
        """The job-identity stamp both control-plane
        endpoints carry at top level: ``job_id`` (fresh per master —
        a changed id at the same URL IS a restart), the master's
        start wall time and the roster generation (bumped at every
        roster publication). Everything a fleet scraper needs to
        correlate the two documents and detect restarts without
        heuristics."""
        with self._lock:
            return {"job_id": self.job_id,
                    "started_wall": self.started_wall,
                    "roster_gen": self._roster_gen}

    def metrics_doc(self) -> dict:
        """The metrics document both endpoint formats serve: per-rank
        progress/stats/rates plus the cluster aggregate (summed stats,
        folded histograms, windowed rates). Plain JSON-ready dicts —
        ``obs.metrics.to_prometheus`` renders the text form."""
        now = time.monotonic()
        # controller status sampled OUTSIDE the master lock (lock
        # discipline: the controller never holds its own lock while
        # calling master methods, and this order — controller lock
        # only, then master lock — can never cycle)
        autoscale_status = (self._autoscaler.status()
                            if self._autoscaler is not None else None)
        tuner_status = self.tuner_status()
        with self._lock:
            roster_gen = self._roster_gen
            roster = self._roster
            ranks: dict[str, dict] = {}
            for r in sorted(self._telemetry):
                t = self._telemetry[r]
                win = self._rank_windows.get(r)
                # snapshots/aggregates are handed out by REFERENCE:
                # every fold/merge builds a NEW object (the previous
                # one is never mutated), so readers outside the lock
                # see a consistent frozen view — no per-scrape deep
                # copy of the whole fleet's stats under the lock
                ranks[str(r)] = {
                    "progress": {k: t.get(k) for k in
                                 ("seq", "current", "last", "phase",
                                  "current_secs", "epoch")},
                    "age": now - t["mono"],
                    "stats": t["stats"],
                    "rates": win.rates() if win is not None else {},
                    "histograms": (t.get("metrics") or {}).get(
                        "histograms", {}),
                    # registry counters/gauges ride the doc for
                    # the sink series (sink/bytes,
                    # sink/dropped_records, sink/lag_secs) render per
                    # rank in Prometheus and in `mp4j-scope live`
                    "counters": (t.get("metrics") or {}).get(
                        "counters", {}),
                    "gauges": (t.get("metrics") or {}).get(
                        "gauges", {}),
                    # roster host fingerprint: the key the
                    # fleet poller folds co-residency on — two jobs'
                    # ranks with EQUAL non-empty fingerprints share a
                    # host; "" means the rank opted out (MP4J_SHM=0)
                    "host_fp": (str(roster[r][2])
                                if 0 <= r < len(roster) else ""),
                }
            cluster_rates = self._cluster_window.rates()
            cluster_metrics = self._cluster_metrics
            audit_status = self._auditor.status()
            membership_status = self._membership_status_locked()
            health_status = (self._health.status()
                             if self._health is not None else None)
        cluster_stats = stats_mod.merge_snapshots(
            *(info["stats"] for info in ranks.values()))
        for r, info in ranks.items():
            info["audit_seq"] = int(
                audit_status["rank_seq"].get(r, 0))
        serve_status = _serve_section(ranks,
                                      cluster_metrics["histograms"])
        return {
            # job identity at top level: same fields as
            # job_doc(), sampled under the SAME lock hold as the rank
            # table so a scraper never sees a roster_gen from one
            # roster paired with ranks from another
            "job_id": self.job_id,
            "started_wall": self.started_wall,
            "roster_gen": roster_gen,
            "slave_num": self.slave_num,
            "window_secs": self._metrics_window,
            # heartbeat period: the live view
            # needs it to annotate a stale rank's derived rate columns
            "hb_secs": self._hb_secs,
            "ranks": ranks,
            "cluster": {
                "stats": cluster_stats,
                "rates": cluster_rates,
                "histograms": cluster_metrics["histograms"],
                "audit": audit_status,
                "membership": membership_status,
                "health": health_status,
                "autoscale": autoscale_status,
                "tuner": tuner_status,
                "serve": serve_status,
            },
        }

    def serve_status(self) -> dict | None:
        """The master's serve-roster surface: the folded
        serve section of :meth:`metrics_doc` — QPS, latency
        quantiles, cache hit rate, degraded-batch count — or ``None``
        when no rank has reported serve traffic (a pure training
        job). The autoscaler's load-following policy and
        ``mp4j-scope live/fleet`` read exactly this."""
        return self.metrics_doc()["cluster"]["serve"]

    def _membership_status_locked(self) -> dict:
        """ONE definition of the membership snapshot (availability
        predicate included) for every surface that renders it — the
        metrics doc, :meth:`membership_status` and the postmortem
        manifest must never disagree. Caller holds the lock."""
        return self._membership.status(
            spares_available=sum(
                1 for s in self._spare_pool
                if s.alive and s.adopting_rank is None),
            spares_total=self._spare_seq)

    def membership_status(self) -> dict:
        """The elastic-membership document: mode, counters,
        spare availability, per-rank badges and the bounded event
        history (schema: resilience.membership.MembershipLog.status)."""
        with self._lock:
            return self._membership_status_locked()

    def audit_status(self) -> dict:
        """The cluster audit document: last cross-rank-
        verified collective ordinal, divergence count, recent
        divergence details (schema: obs.audit.ClusterAuditor.status).
        All zeros unless slaves run ``MP4J_AUDIT=verify|capture``."""
        with self._lock:
            return self._auditor.status()

    def health_status(self) -> dict | None:
        """The health plane's verdict document — THE
        operator hook the future elastic autoscaler calls: per-rank
        state (``HEALTHY``/``DEGRADED``/``SUSPECT``/
        ``EVICT_RECOMMENDED``/``DEAD``) with detector-pressure
        evidence, the ``evict_recommended`` list, dominator window
        shares/streak, onset count and the recent alert tail (schema:
        obs.health.HealthEngine.status). This plane only ever
        RECOMMENDS — acting on a verdict (replacing a SUSPECT rank
        from a spare, shrinking around an EVICT_RECOMMENDED one) is
        the caller's decision. None when ``MP4J_HEALTH=0``."""
        with self._lock:
            return (self._health.status()
                    if self._health is not None else None)

    def _write_postmortem_manifest(self) -> None:
        """Flight-recorder manifest (once per write site, idempotent
        overwrite): only on a terminal abort — a clean job leaves no
        postmortem."""
        autoscale_status = (self._autoscaler.status()
                            if self._autoscaler is not None else None)
        with self._lock:
            reason = self._fatal_msg
            departed = dict(self._departed)
            audit_status = self._auditor.status()
            membership_status = self._membership_status_locked()
            health_status = (self._health.status()
                             if self._health is not None else None)
        if not self._postmortem_dir or reason is None:
            return
        # ONE table snapshot feeds both fields, so the manifest's
        # diagnosis and table describe the same instant
        table = self._snapshot_table()
        try:
            postmortem_mod.write_master_manifest(
                self._postmortem_dir, slave_num=self.slave_num,
                reason=reason, table=table, departed=departed,
                diagnosis=telemetry_mod.render_diagnosis(
                    table, self.slave_num),
                audit=audit_status,
                sink_dir=self._sink_dir or None,
                membership=membership_status,
                health=health_status,
                autoscale=autoscale_status)
        except OSError:
            pass  # best-effort: the job is already terminal

    def _watchdog_loop(self):
        """Diagnose stalled barriers, then ACT on them.

        A generation some ranks reached ``stall_timeout`` seconds ago
        while others never arrived is the mismatched-schedule deadlock
        signature — log the diagnosis once per generation (the
        behavior). A generation (or an open abort round) still
        incomplete after ``dead_rank_secs`` escalates to the terminal
        abort fan-out: the whole cluster raises one clean error instead
        of each rank relying on its local timeout — the watchdog is no
        longer log-only. ``stall_timeout=None`` disables the diagnosis
        only; ``dead_rank_secs=inf`` disables the escalation only."""
        bounds = [t for t in (self.stall_timeout, self.dead_rank_secs)
                  if t is not None and t != float("inf")]
        tick = min(1.0, max(0.05, min(bounds) / 4)) if bounds else 1.0
        while not self._stop.wait(tick):
            now = time.monotonic()
            stalled, fatal = [], None
            escalate: dict[int, str] = {}   # rank -> why (elastic)
            lost_spares = []
            with self._lock:
                round_open = self._abort_since is not None
                for gen, since in self._barrier_since.items():
                    if gen not in self._barrier_waiting:
                        continue
                    age = now - since
                    if (age > self.dead_rank_secs
                            and self._fatal_msg is None
                            # a barrier waiting out a membership round
                            # (the joiner has not re-arrived yet) is
                            # the round's business, not a new death
                            and not (self.elastic != "off"
                                     and round_open)):
                        missing = sorted(
                            set(range(self.slave_num))
                            - set(self._barrier_waiting[gen]))
                        fatal = (f"barrier gen {gen} stalled for "
                                 f"{age:.1f}s waiting on ranks "
                                 f"{missing}; aborting the job")
                        if self.elastic != "off":
                            for r in missing:
                                escalate.setdefault(
                                    r, f"barrier gen {gen} stalled "
                                    f"{age:.1f}s without it")
                    elif (self.stall_timeout is not None
                            and age > self.stall_timeout
                            and gen not in self._diagnosed_gens):
                        self._diagnosed_gens.add(gen)
                        stalled.append(
                            (gen, list(self._barrier_waiting[gen]), age))
                if (fatal is None and round_open
                        and now - self._abort_since > self.dead_rank_secs):
                    missing = sorted(set(range(self.slave_num))
                                     - set(self._departed)
                                     - self._abort_acks)
                    if missing:
                        fatal = (f"abort round -> epoch "
                                 f"{self._abort_epoch} stalled: no "
                                 f"teardown ack from ranks "
                                 f"{missing}; aborting the job")
                        if self.elastic != "off":
                            for r in missing:
                                escalate.setdefault(
                                    r, "no teardown ack within "
                                    f"{self.dead_rank_secs:.1f}s")
                    elif self._round_kind in ("replace", "shrink",
                                              "evict"):
                        # acks complete but the membership half never
                        # finished (manifest or adoption wedged past
                        # every narrower deadline): terminal
                        fatal = (f"membership round -> epoch "
                                 f"{self._abort_epoch} stalled for "
                                 f"{now - self._abort_since:.1f}s; "
                                 "aborting the job")
                # spare-adoption deadline: a spare that
                # never acks its adoption burns one deadline, not the
                # whole recovery budget — the next spare is tried
                for r, rec in list(self._round_adoptions.items()):
                    if (rec.adopt_since is not None
                            and now - rec.adopt_since > self._adopt_secs):
                        lost_spares.append(rec)
                # grow adoptions share the deadline
                if self._grow_state is not None:
                    for r, rec in list(
                            self._grow_state["pending"].items()):
                        if (rec.adopt_since is not None
                                and now - rec.adopt_since
                                > self._adopt_secs):
                            lost_spares.append(rec)
                # a resize generation stalled past the dead-rank
                # threshold means a rank never reached the boundary —
                # same escalation as a stalled barrier
                for gen, since in list(self._resize_since.items()):
                    if gen not in self._resize_waiting:
                        continue
                    age = now - since
                    if (age > self.dead_rank_secs
                            and self._fatal_msg is None
                            and fatal is None
                            and not (self.elastic != "off"
                                     and round_open)):
                        missing = sorted(
                            set(range(self.slave_num))
                            - set(self._resize_waiting[gen]))
                        fatal = (f"resize gen {gen} stalled for "
                                 f"{age:.1f}s waiting on ranks "
                                 f"{missing}; aborting the job")
                        if self.elastic != "off":
                            for r in missing:
                                escalate.setdefault(
                                    r, f"resize gen {gen} stalled "
                                    f"{age:.1f}s without it")
            for gen, ranks, age in stalled:
                missing = sorted(set(range(self.slave_num)) - set(ranks))
                self._log("M", "WARN",
                          f"barrier gen {gen} stalled for {age:.1f}s: "
                          f"ranks {sorted(ranks)} waiting on ranks "
                          f"{missing}")
                for line in self.diagnose():
                    self._log("M", "WARN", line)
            for rec in lost_spares:
                self._spare_gone(
                    rec, f"adoption not acked within "
                    f"{self._adopt_secs:.1f}s")
            # the eviction fence's deadline + liveness re-checks ride
            # the same tick
            self._check_fence()
            if fatal is not None:
                if self.elastic != "off" and escalate:
                    for r, why in escalate.items():
                        self._on_rank_dead(r, why, fatal)
                else:
                    self._fatal_abort(fatal)

    def _barrier(self, slot: _Slot, gen: int):
        release = False
        stale = False
        with self._lock:
            rank = slot.rank
            fatal = self._fatal_msg
            if fatal is None:
                if gen <= self._barrier_max_released:
                    stale = True    # see _barrier_max_released
                else:
                    waiting = self._barrier_waiting.setdefault(gen, [])
                    self._barrier_since.setdefault(gen,
                                                   time.monotonic())
                    waiting.append(rank)
                    if len(waiting) == self.slave_num:
                        release = True
                        self._barrier_max_released = max(
                            self._barrier_max_released, gen)
        if stale:
            self._send_to(rank, ("barrier_release", gen))
            return
        if fatal is not None:
            # the job is terminally aborted: never release a barrier
            # into it — a straggler arriving after the fan-out must
            # raise the fatal, not "complete" a dead job (re-push the
            # message in case the original fan-out raced its dial-in)
            self._send_to(rank, ("abort_fatal", fatal))
            return
        if release:
            # release everyone waiting on this generation
            for r in range(self.slave_num):
                self._send_to(r, ("barrier_release", gen))
            with self._lock:
                del self._barrier_waiting[gen]
                self._barrier_since.pop(gen, None)
        # a barrier arrival can complete an armed eviction fence (a
        # rank idling in a barrier IS at a boundary)
        self._check_fence()


def _serve_section(ranks: dict, cluster_hists: dict) -> dict | None:
    """Fold the per-rank serve counters/gauges into the cluster serve
    section: ``None`` for a job that never served a
    request (no zero-noise in docs or Prometheus), else QPS (the
    frontend's sliding-window gauge), p50/p99 request latency from
    the folded ``latency/serve_request`` histogram, cache hit rate
    and the degraded-batch count. Pure function of the already-built
    doc pieces — called outside the master lock."""
    counters: dict[str, float] = {}
    qps = 0.0
    for info in ranks.values():
        for k, v in (info.get("counters") or {}).items():
            if k.startswith("serve/"):
                counters[k] = counters.get(k, 0) + v
        g = (info.get("gauges") or {}).get("serve/qps")
        if g is not None:
            # one frontend owns the gauge; max() tolerates a stale
            # zero from a rank that briefly fronted earlier
            qps = max(qps, float(g))
    if not counters:
        return None
    h = cluster_hists.get("latency/serve_request")
    p50 = metrics_mod.hist_quantile(h, 0.50) if h else 0.0
    p99 = metrics_mod.hist_quantile(h, 0.99) if h else 0.0
    if h:
        # overflow-bucket quantiles come back +Inf; clamp to the
        # histogram's top finite edge so the doc stays strict JSON
        top = h["lo"] * 2.0 ** h["n"]
        p50 = min(p50, top)
        p99 = min(p99, top)
    hits = counters.get("serve/cache_hits", 0)
    misses = counters.get("serve/cache_misses", 0)
    return {
        "active": True,
        "qps": qps,
        "requests": int(counters.get("serve/requests", 0)),
        "batches": int(counters.get("serve/batches", 0)),
        "batch_deadline": int(counters.get("serve/batch_deadline", 0)),
        "batch_full": int(counters.get("serve/batch_full", 0)),
        "p50_ms": p50 * 1e3,
        "p99_ms": p99 * 1e3,
        "hit_rate": (hits / (hits + misses)
                     if (hits + misses) else None),
        "stale_rows": int(counters.get("serve/cache_stale", 0)),
        "degraded_batches": int(
            counters.get("serve/degraded_batches", 0)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ytk-mp4j-tpu rendezvous master")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--slaves", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    m = Master(args.slaves, port=args.port, timeout=args.timeout)
    print(f"mp4j master listening on port {m.port} for {args.slaves} slaves",
          file=sys.stderr, flush=True)
    return m.serve()


if __name__ == "__main__":
    sys.exit(main())
