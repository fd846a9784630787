"""Process-level slave — the CPU socket reference path.

A copy of ``ytk_mp4j_tpu/comm/process_comm.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package. It takes
numpy arrays at its API, as the reference does, and never CUDA tensors;
``utils.native`` reads ``Operator.kernel_code`` where the reference reads
``native_code``.

Faithful to the reference's design (SURVEY.md sections 2, 3a-3c): each
slave owns a listen socket plus lazily-established peer TCP connections,
registers with the rendezvous master to obtain its rank and the roster,
and implements all 7 collectives over {dense array, sparse map} operands
with in-place buffer semantics. ``info()/error()`` forward to the
master's console; ``barrier()``/``close(code)`` coordinate through the
master (SURVEY.md section 3e).

Algorithms: allreduce/reduce_scatter/allgather default to
``algo="auto"`` — size-aware selection (``utils.tuning``) between the
binomial tree (latency-bound small payloads), the reference's
MPICH-style Rabenseifner path — reduce-scatter by RECURSIVE HALVING +
allgather by RECURSIVE DOUBLING, with non-power-of-2 rank counts folded
in by a pre/post step (the "Kryo-socket recursive-halving path" of
BASELINE.json; SURVEY.md section 3b) — and the pipelined ring
(bandwidth-bound large payloads). Each step's transfer is split into
``MP4J_CHUNK_BYTES`` chunks so the merge of chunk k overlaps the wire
transfer of chunk k+1 (see ``_chunked_exchange``). Broadcast/reduce
are binomial trees; rooted gather/scatter are direct sends.

The per-round element-wise merge (the reference's CPU hot loop, SURVEY.md
section 3b step 2) runs through the native C++ kernel
(``utils.native.reduce_into``); receive scratch comes from a per-dtype
buffer pool, and ``stats()`` reports per-collective wire/reduce/
serialize phase counters (``utils.stats``).

This path is also the semantic oracle the device paths are tested
against.
"""

from __future__ import annotations

import copy
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.comm import keycodec
from ytk_mp4j_tpu_torch.comm import master as master_mod
from ytk_mp4j_tpu_torch.comm import progress as progress_mod
from ytk_mp4j_tpu_torch.comm.context import CommSlave
from ytk_mp4j_tpu_torch.obs import audit as audit_mod
from ytk_mp4j_tpu_torch.obs import health as health_mod
from ytk_mp4j_tpu_torch.obs import metrics as metrics_mod
from ytk_mp4j_tpu_torch.obs import postmortem
from ytk_mp4j_tpu_torch.obs import sink as sink_mod
from ytk_mp4j_tpu_torch.obs import spans as spans_mod
from ytk_mp4j_tpu_torch.ops import sparse as sparse_ops
from ytk_mp4j_tpu_torch.exceptions import (
    Mp4jError, Mp4jFatalError, Mp4jSpareReleased, Mp4jTransportError)
from ytk_mp4j_tpu_torch.operands import Operand, Operands
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.resilience import faults as faults_mod
from ytk_mp4j_tpu_torch.resilience import membership as membership_mod
from ytk_mp4j_tpu_torch.resilience.recovery import RecoveryManager
from ytk_mp4j_tpu_torch.transport import shm as shm_mod
from ytk_mp4j_tpu_torch.transport import tcp as tcp_mod
from ytk_mp4j_tpu_torch.transport.channel import Channel, _raw_view
from ytk_mp4j_tpu_torch.transport.tcp import connect
from ytk_mp4j_tpu_torch.utils import native, trace, tuning
from ytk_mp4j_tpu_torch.utils import stats as stats_mod
from ytk_mp4j_tpu_torch.utils import tuner as tuner_mod
from ytk_mp4j_tpu_torch.utils.stats import CommStats

import functools


class _ScratchPool:
    """Per-dtype reusable scratch buffers for collective steps.

    ``take(dtype, n)`` returns a length-``n`` view of a pooled (or
    fresh) contiguous buffer; ``give(view)`` returns the underlying
    buffer for reuse. Reuse matters on the hot path: a fresh
    ``np.empty`` per round re-pays mmap + first-touch page faults for
    every MB received, a full extra memory pass.

    Discipline: take/give pairs are owned by the collective's calling
    thread (no locking — a slave runs one collective at a time); give
    only what was taken, after the last read of it. The free list is
    capped, so a one-off giant collective cannot pin more than a few
    peak-sized buffers per dtype.
    """

    _MAX_FREE = 4

    def __init__(self):
        self._free: dict[np.dtype, list[np.ndarray]] = {}

    def take(self, dtype, n: int) -> np.ndarray:
        dt = np.dtype(dtype)
        free = self._free.get(dt)
        if free:
            best = None
            for i, b in enumerate(free):
                if b.size >= n and (best is None
                                    or b.size < free[best].size):
                    best = i
            if best is not None:
                return free.pop(best)[:n]
        return np.empty(max(n, 1), dtype=dt)[:n]

    def give(self, arr: np.ndarray) -> None:
        base = arr.base if isinstance(arr.base, np.ndarray) else arr
        free = self._free.setdefault(base.dtype, [])
        if len(free) < self._MAX_FREE:
            free.append(base)
            return
        # full list: keep the PEAK-sized buffers (evict the smallest
        # for a larger incomer) — a handful of small early collectives
        # must not permanently defeat pooling for the MB-scale rounds
        # the pool exists for
        smallest = min(range(len(free)), key=lambda i: free[i].size)
        if free[smallest].size < base.size:
            free[smallest] = base


class ProcessCommSlave(CommSlave):
    """A rank in a multi-process (TCP) mp4j job.

    Construction blocks until all expected slaves have registered with
    the master (reference behavior, SURVEY.md section 3a).
    """

    def __init__(self, master_host: str, master_port: int,
                 listen_host: str = "127.0.0.1",
                 timeout: float | None = 120.0,
                 peer_timeout: float | None = None,
                 handshake_timeout: float | None = 30.0,
                 native_transport: bool = True,
                 shm: bool | None = None,
                 host_fp: str | None = None,
                 map_columnar: bool | None = None,
                 max_retries: int | None = None,
                 reconnect_backoff: float | None = None,
                 dead_rank_secs: float | None = None,
                 fault_plan=None,
                 postmortem_dir: str | None = None,
                 audit: str | None = None,
                 sink_dir: str | None = None,
                 elastic: str | None = None,
                 spare: bool = False,
                 async_collectives: bool | None = None,
                 health: bool | None = None,
                 tuner: str | None = None):
        """``timeout`` bounds rendezvous/connect; ``peer_timeout`` (None =
        the reference's fail-stop hang) bounds each peer receive during
        collectives, turning a dead peer into an Mp4jError.
        ``handshake_timeout`` bounds the rank exchange on each inbound
        peer connection so a stray/half-dead dial-in cannot wedge the
        accept loop that every healthy peer depends on.

        ``native_transport`` enables the raw (unframed) data plane for
        numeric uncompressed operands — the C++ poll loop when the
        native library builds, a wire-identical pure-Python raw path
        otherwise. It is a JOB-wide wire-protocol choice: every slave in
        a job must pass the same value (the raw/framed decision must
        match on both ends of every exchange). False keeps the fully
        framed Python path — the frozen reference baseline bench.py
        measures against.

        ``shm`` (None reads ``MP4J_SHM``, default on) lets rendezvous
        negotiate the intra-host shared-memory transport: a
        dialing slave whose host fingerprint matches the peer's roster
        entry creates a shm ring pair and names it in the peer
        handshake; every other pair keeps TCP. JOB-wide like
        ``native_transport`` — every slave must agree on whether shm
        may be offered (the per-pair decision then rides the
        handshake, so both ends of one channel always agree).
        ``host_fp`` overrides the detected host fingerprint (testing +
        ops seam: partition co-located ranks into virtual hosts, or
        pin two cells apart); ranks only pair over shm — and the
        topology-aware two-level schedule only groups them — when
        their fingerprints are EQUAL and non-empty.

        ``map_columnar`` selects the map-collective wire plane for
        numeric operands (None reads ``MP4J_MAP_COLUMNAR``, default
        on): the columnar (codes, values) data plane, or False for the
        pickled-dict reference path. JOB-wide like ``native_transport``
        — every slave must agree (see the map-collective section
        comment).

        Resilience (all None -> env): ``max_retries``
        (``MP4J_MAX_RETRIES``) bounds the epoch-fenced abort/retry
        rounds per failed collective — 0 restores the reference's
        fail-stop; ``reconnect_backoff`` (``MP4J_RECONNECT_BACKOFF``)
        is the base of the capped exponential re-dial backoff;
        ``dead_rank_secs`` (``MP4J_DEAD_RANK_SECS``) bounds every
        recovery wait before the job goes terminal. ``fault_plan``
        (``MP4J_FAULT_PLAN``; a grammar string or a
        :class:`~ytk_mp4j_tpu_torch.resilience.faults.FaultPlan`) arms
        deterministic fault injection on this rank's data plane —
        chaos-test machinery, never on by default.

        ``postmortem_dir`` (None reads ``MP4J_POSTMORTEM_DIR``; empty
        disables) arms the flight recorder: on any terminal
        abort this rank dumps a postmortem bundle (span-ring Chrome
        trace, stats snapshot, metric histograms, epoch/retry log)
        there before raising.

        ``audit`` (None reads ``MP4J_AUDIT``, default
        ``digest``) selects the correctness-auditing mode —
        ``off|digest|verify|capture`` (:mod:`ytk_mp4j_tpu_torch.obs.audit`).
        JOB-wide like ``native_transport``: cross-rank digest
        comparison assumes every rank digests the same schedule the
        same way.

        ``sink_dir`` (None reads ``MP4J_SINK_DIR``, gated by
        ``MP4J_SINK``; empty disables) arms the durable streaming
        telemetry sink: a background thread drains this rank's span/
        stats/metrics/audit/recovery rings into crc-framed rotating
        segment files under ``<sink_dir>/rank_NNNN/`` (per-rank disk
        budget ``MP4J_SINK_BYTES``, oldest-segment eviction), so
        ``mp4j-scope analyze``/``tail`` can reconstruct full-job
        cross-rank timelines and critical-path attribution — ring
        tails no longer bound history.

        ``elastic`` (None reads ``MP4J_ELASTIC``) is the
        job's elastic-membership mode, validated here like every other
        job-wide knob — including the fail-stop conflict rule: an
        elastic mode next to ``max_retries=0`` raises at construction
        (the fenced retry is the mechanism that re-runs the
        interrupted collective after a membership change).

        ``async_collectives`` (None reads ``MP4J_ASYNC``,
        default on) selects how the nonblocking ``i*`` methods
        execute: on the per-slave helper progression thread
        (``comm/progress.py`` — many outstanding collectives driven
        through one poll loop, with wire/reduce overlap across them),
        or — when False — eagerly on the caller's thread, returning
        already-resolved futures. A LOCAL execution-strategy choice
        (wire-identical either way), unlike the JOB-wide
        ``MP4J_COALESCE_USECS`` coalescing window also validated
        here.

        ``health`` (None reads ``MP4J_HEALTH``, default on)
        arms this rank's half of the streaming health plane: each
        heartbeat also carries the rank's completed per-ordinal span
        cells (``health_delta`` — the live feed the master's online
        dominator attribution consumes) and the control thread lands
        the master's health-alert pushes in the recovery log and the
        durable sink's ``alerts`` records. Run every rank with the
        same value — a rank with it off ships no cells, so the master
        can attribute nothing.

        ``tuner`` (None reads ``MP4J_TUNER``, default
        ``observe``) arms this rank's half of the self-tuning data
        plane (:mod:`ytk_mp4j_tpu_torch.utils.tuner`): the heartbeat thread
        folds the rolling per-link wire stats into decision windows,
        and — in ``act`` mode — committed per-link ``(chunk_bytes,
        compress, socket-buffer)`` decisions apply at the NEXT
        outermost-collective boundary (never mid-collective). The
        framed wire format is receiver-auto-detected, so sender-side
        decisions cannot desync a pair; links with shm traffic keep
        the job-wide chunk schedule (it is part of the shm wire
        contract). Any cross-rank audit divergence trips the tuner
        back to static defaults for the job's lifetime.

        ``spare=True`` registers this slave as a WARM SPARE
        instead of claiming a rank: construction blocks — pinging the
        master from a background thread — until the master adopts it
        into a dead rank's id (the constructor then returns a fully
        seeded member of the running job: the dead rank's id at the
        current epoch, the columnar keycodec vocabularies, the resume
        ordinal in :attr:`resume_seq` and barrier position in
        :attr:`resume_barrier_gen`, and the cross-rank-verified audit
        watermark) or releases it (``Mp4jSpareReleased`` — the job
        ended without needing this spare)."""
        self._timeout = timeout
        self._peer_timeout = peer_timeout
        self._handshake_timeout = handshake_timeout
        self._native_transport = native_transport
        # resilience knobs, env-validated up front like the transport
        # tuning below
        self._max_retries = (tuning.max_retries() if max_retries is None
                             else int(max_retries))
        if self._max_retries < 0:
            raise Mp4jError(f"max_retries={max_retries} must be >= 0")
        self._reconnect_backoff = (tuning.reconnect_backoff()
                                   if reconnect_backoff is None
                                   else float(reconnect_backoff))
        self._dead_rank_secs = tuning.dead_rank_secs(dead_rank_secs)
        # elastic membership: the master drives the
        # protocol, but the mode is validated on EVERY rank — the
        # fail-stop conflict (elastic + max_retries=0) must fail the
        # job at setup, never silently pick a winner
        self._elastic = tuning.elastic_mode(elastic,
                                            max_retries=self._max_retries)
        self._spare = bool(spare)
        if fault_plan is None:
            spec = tuning.fault_plan_spec()
            fault_plan = faults_mod.FaultPlan.parse(spec) if spec else None
        elif isinstance(fault_plan, str):
            fault_plan = faults_mod.FaultPlan.parse(fault_plan)
        self._fault_plan = fault_plan
        self._postmortem_dir = (tuning.postmortem_dir()
                                if postmortem_dir is None
                                else str(postmortem_dir))
        self._pm_done = False
        # durable sink: dir + enable validated up front like
        # every other knob; the writer itself starts after rendezvous
        # (it needs the rank)
        if sink_dir is None:
            self._sink_dir = (tuning.sink_dir()
                              if tuning.sink_enabled() else "")
        else:
            self._sink_dir = str(sink_dir)
        self._sink: sink_mod.SinkWriter | None = None
        # health plane: knob validated up front like every
        # other; the span folder itself starts after rendezvous (it
        # needs the rank), the alert log exists unconditionally so a
        # master running health against a health-off slave still
        # lands its pushes somewhere durable
        self._health_on = tuning.health_enabled(health)
        self._health_folder: health_mod.SpanFolder | None = None
        self._health_alerts = health_mod.AlertLog()
        # job-wide transport tuning (env-validated here, before any
        # connection exists, so a typo'd knob fails the job cleanly)
        # and pipeline state — all of it must exist BEFORE the accept
        # thread starts: an early peer dial-in races __init__
        self._chunk_bytes = tuning.chunk_bytes()
        self._algo_small, self._algo_large = tuning.algo_thresholds()
        self._shm = tuning.shm_enabled() if shm is None else bool(shm)
        self._shm_ring_bytes = tuning.shm_ring_bytes()
        # host fingerprint: rides registration into the
        # roster; "" (shm off) makes this rank fingerprint-match
        # nobody, so every pair it joins keeps TCP
        if not self._shm:
            self._fp = ""
        elif host_fp is not None:
            self._fp = str(host_fp)
        else:
            self._fp = shm_mod.host_fingerprint()
        self._map_columnar = (tuning.map_columnar_enabled()
                              if map_columnar is None
                              else bool(map_columnar))
        # nonblocking collectives: knobs validated up front
        # like every other; the scheduler itself starts lazily on the
        # first i* submission, so a fully blocking job pays nothing
        self._async_on = (tuning.async_enabled()
                          if async_collectives is None
                          else bool(async_collectives))
        self._coalesce_usecs = tuning.coalesce_usecs()
        self._max_outstanding = tuning.max_outstanding()
        # self-tuning data plane: mode + window validated
        # up front like every other knob; the policy core runs on the
        # heartbeat thread, decisions apply at outermost-collective
        # boundaries only (the recovery wrapper drains the queue)
        self._tuner_mode = tuning.tuner_mode(tuner)
        self._tuner_window = tuning.tuner_window_secs()
        self._so_buf_map = tuning.so_buf_map()
        self._tuner: tuner_mod.LinkTuner | None = (
            tuner_mod.LinkTuner(self._tuner_mode, self._chunk_bytes,
                                self._so_buf_map)
            if self._tuner_mode != "off" else None)
        self._tuner_next = 0.0   # heartbeat-thread pacing (monotonic)
        # fenced leader overrides: written only by the ctl
        # thread inside a master tuner fence (every rank parked at the
        # same boundary) and reset by _set_roster on any membership
        # change — two-level schedules read the derived _leaders list
        self._leader_overrides: dict[int, int] = {}
        self._async: progress_mod.ProgressScheduler | None = None
        self._async_lock = threading.Lock()
        self._eager_failed: list = []   # MP4J_ASYNC=0 failures for
        # wait_all's re-raise contract (caller thread only)
        # persistent key<->code vocabularies for the columnar map
        # plane, kept IDENTICAL across ranks (grown only inside the
        # synchronized novelty exchange — see _map_sync)
        self._map_codecs: dict[str, object] = {}
        # pre-attempt codec sizes of the collective in flight (set by
        # the recovery wrapper's preserve): the adoption manifest's
        # vocabulary export pins to these — a failed map attempt's
        # tentative growth must not reach a joining spare when every
        # survivor's retry is about to truncate it away
        self._codec_pin: dict | None = None
        self._scratch = _ScratchPool()
        self._comm_stats = CommStats()
        # audit plane: mode validated up front like every
        # other job-wide knob; ``off`` keeps _audit None so the hot
        # path pays one attribute check
        audit_mode = tuning.audit_mode(audit)
        self._audit = (None if audit_mode == "off"
                       else audit_mod.AuditRing(audit_mode))
        self._comm_stats.audit = self._audit  # channels reach it here
        # own listen socket on an ephemeral port. Buffer-size knobs
        # apply BEFORE listen(): accepted peer sockets inherit them,
        # and the TCP window scale is fixed at the handshake.
        # sanctioned raw-socket site: the slave's own listen socket IS
        # the rendezvous surface peers negotiate transports over
        # (mp4j-lint R12 baseline)
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        tcp_mod.apply_socket_buf_sizes(self._server)
        self._server.bind((listen_host, 0))
        self._server.listen(64)
        self._listen_port = self._server.getsockname()[1]
        self._listen_host = listen_host

        # register with master; blocks until roster is complete.
        # ``timeout`` bounds the whole rendezvous exchange, not just the
        # TCP connect: a wedged master surfaces as Mp4jError, not a hang.
        self._master = connect(master_host, master_port, timeout=timeout)
        self._master.set_timeout(timeout)
        self._master.send_obj((master_mod.REGISTER, {
            "listen_port": self._listen_port, "host": listen_host,
            "fp": self._fp, "spare": self._spare}))
        reply = self._master.recv()
        adopt_info = None
        if self._spare:
            # blocks (pinging) until the master adopts this spare into
            # a dead rank's id — or releases it
            reply, adopt_info = self._spare_wait(reply)
        self._rank = reply["rank"]
        self._roster_version = 0
        self._set_roster(reply["roster"])
        # job id namespaces this job's shm segment names
        self._job_id = str(reply.get("job") or "0")
        # after rendezvous the master channel is fail-stop (barrier
        # waits are unbounded by design, see barrier())
        self._master.set_timeout(None)
        # all further master-channel sends share one lock: the
        # heartbeat thread interleaving frame bytes with a barrier or
        # log send would corrupt the control plane
        self._master_lock = threading.Lock()
        # heartbeat delta state: the last stats/metrics
        # snapshots shipped to the master, so every beat carries only
        # what changed since. One lock serializes the heartbeat
        # thread, the DIAGNOSE hook and close's final flush; it NEVER
        # nests inside _master_lock (deadlock discipline: payload
        # first, then send). Created before _sync_identity — the rank
        # mirror publishes under it.
        self._tel_lock = threading.Lock()
        self._tel_last_stats: dict = {}
        self._tel_last_metrics: dict = {}
        self._sync_identity()

        # peer channels: canonical rule — the HIGHER rank connects to the
        # lower rank's listen socket; one duplex channel per pair.
        self._peers: dict[int, Channel] = {}
        self._peer_cv = threading.Condition()
        self._dead_channels: list[Channel] = []   # torn down, fd alive

        # recovery engine + control-plane receiver. The
        # control thread is the ONLY reader of the master channel from
        # here on: barrier releases, close acks and abort fan-outs are
        # demultiplexed through it, so an asynchronous abort push can
        # never interleave with a barrier reply.
        # (outermost collectives entered, one currently in flight) as
        # ONE tuple-valued attribute: the control thread samples it for
        # the abort ack, and a two-field sample could tear between the
        # ordinal bump and the in-flight flag — the master would read
        # "idle at m+1" next to in-flight ranks retrying m+1 as a
        # collective-boundary fault and kill a recoverable job
        self._progress_state = (0, False)
        self._faults = None
        if self._fault_plan is not None:
            inj = faults_mod.FaultInjector(self._fault_plan, self._rank)
            if not inj.empty:
                self._faults = inj
        self._recovery = RecoveryManager(
            rank=self._rank, max_retries=self._max_retries,
            dead_rank_secs=self._dead_rank_secs,
            send_ctl=lambda kind, payload: self._master_send(
                (kind, payload)),
            teardown=self._teardown_peers, stats=self._comm_stats,
            wake=self._ctl_wake, drain=self._drain_dead_channels,
            progress=lambda: self._progress_state,
            terminal_hook=self._on_terminal_abort)
        self._ctl_cv = threading.Condition()
        self._barrier_released: set[int] = set()
        self._closed_ack = threading.Event()
        self._closed = False    # before the ctl thread can observe it
        self._ctl_thread = threading.Thread(
            target=self._ctl_loop, daemon=True,
            name=f"mp4j-ctl-r{self._rank}")
        self._ctl_thread.start()

        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"mp4j-accept-r{self._rank}")
        self._accept_thread.start()
        # paired send/recv helper (avoids head-of-line deadlock on large
        # simultaneous exchanges)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"mp4j-send-r{self._rank}")
        # outstanding helper-thread sends; only the collective thread
        # touches this (submit + the drain barrier), no lock needed
        self._send_futs: list = []
        self._barrier_gen = 0
        # barrier generations COMPLETED (vs. _barrier_gen = entered):
        # the adoption manifest ships this count so a joiner's next
        # barrier call pairs with the survivors'
        self._barrier_done = 0
        # resize-point generations: entered / completed
        # counts mirror the barrier pair; the ctl thread parks results
        # per generation until resize_point() collects them
        self._resize_gen = 0
        self._resize_done = 0
        self._resize_results: dict[int, dict] = {}
        # adoption resume position (0 on ordinary members): the
        # application reads these to know where the job already is
        self.resume_seq = 0
        self.resume_barrier_gen = 0
        if adopt_info is not None:
            self._adopt_seed(adopt_info)
            # ack BEFORE the heartbeat thread exists: the master's
            # spare serve thread switches into the rank's serve loop
            # on this message, and a TELEMETRY frame arriving first
            # would hit the spare-side dispatch
            self._master_send((master_mod.ADOPT_ACK,
                               {"rank": self._rank}))
        # telemetry heartbeat (control plane only — never touches the
        # peer data channels, so it cannot block a collective): ships
        # {progress, stats} to the master every MP4J_HEARTBEAT_SECS
        # (0 disables), feeding the cluster skew table and giving hang
        # diagnosis a last-known position for THIS rank even when it is
        # the one that stalls
        self._hb_stop = threading.Event()
        self._hb_secs = tuning.heartbeat_secs()
        # health plane: the span folder needs the rank —
        # it filters the process-global ring (thread-backed multi-
        # slave processes share it) and folds completed ordinals into
        # the heartbeat's health_delta cells
        if self._health_on and spans_mod.enabled():
            # mp4j-lint: disable=R15 (retargeted by _sync_identity on renumbering)
            self._health_folder = health_mod.SpanFolder(self._rank)
        self._hb_thread: threading.Thread | None = None
        if self._hb_secs > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"mp4j-hb-r{self._rank}")
            self._hb_thread.start()
        # durable sink drain thread — control plane only,
        # off the collective hot path entirely (the hot path pays the
        # ring appends it already paid)
        if self._sink_dir:
            self._sink = sink_mod.SinkWriter(
                self._sink_dir, self._rank, slave_num=self._n,
                stats=self._comm_stats, audit=self._audit,
                recovery=self._recovery,
                alerts=self._health_alerts).start()

    # ------------------------------------------------------------------
    # identity / control plane
    # ------------------------------------------------------------------
    @property
    def rank(self) -> int:
        return self._rank

    @property
    def slave_num(self) -> int:
        return self._n

    def metrics_registry(self):
        """This rank's live :class:`~ytk_mp4j_tpu_torch.obs.metrics.
        MetricsRegistry` — the sanctioned write surface for planes
        layered ON the comm (the serve frontend's latency/QPS/cache
        families ride the same heartbeat deltas as the collective
        stats)."""
        return self._comm_stats.metrics

    def _master_send(self, obj) -> None:
        """Serialized master-channel send (shared by the caller's
        control messages and the heartbeat thread)."""
        with self._master_lock:
            if self._closed:
                raise Mp4jError("slave is closed")
            self._master.send_obj(obj)

    def info(self, msg: str) -> None:
        self._master_send((master_mod.LOG, {"level": "INFO", "msg": msg}))

    def error(self, msg: str) -> None:
        self._master_send((master_mod.LOG, {"level": "ERROR", "msg": msg}))

    def barrier(self) -> None:
        # the collective-boundary drain: outstanding
        # nonblocking collectives complete before the barrier so the
        # job-wide collective order stays the submit order
        if self._async is not None:
            self._async.drain_for_blocking()
        gen = self._barrier_gen
        self._barrier_gen += 1
        self._master_send((master_mod.BARRIER, {"gen": gen}))
        with self._ctl_cv:
            # the release waits on the slowest rank indefinitely — the
            # reference's fail-stop contract, not a missing timeout —
            # but a terminal abort (dead rank, watchdog escalation)
            # breaks the wait with the cluster-wide error
            self._ctl_cv.wait_for(
                lambda: gen in self._barrier_released
                or self._recovery.fatal is not None)
            if gen in self._barrier_released:
                self._barrier_released.discard(gen)
                # completed-generation count: the adoption manifest's
                # barrier seed — every rank that PASSED
                # this barrier agrees on it, waiting ranks still show
                # the previous value
                self._barrier_done = gen + 1
                return
        raise self._recovery.fatal_exc()

    def resize_point(self) -> list:
        """An explicit APP EPOCH BOUNDARY the roster may change at
        (grow mode): every rank calls this at the same point
        in its schedule (like :meth:`barrier`); under
        ``MP4J_ELASTIC=grow`` + ``MP4J_AUTOSCALE=act`` the master
        adopts registered warm spares into NEW rank ids here —
        EXPANDING ``slave_num`` between epochs — and every rank
        returns the (possibly grown) roster. The adopted joiners'
        constructors return fully seeded (``resume_seq`` names the
        collective ordinal the job is at), exactly like replacement
        adoption. With growth unavailable (mode off, no spares, rails
        closed) this is a no-op rendezvous returning the current
        roster.

        Rank 0's call donates the canonical columnar vocabulary for
        the joiners' seed — at a quiesced boundary every rank's codec
        tables are identical by construction (they only ever grow
        inside the synchronized novelty exchange)."""
        if self._async is not None:
            # the collective-boundary drain, like barrier(): the
            # roster must not change under outstanding futures
            self._async.drain_for_blocking()
        gen = self._resize_gen
        self._resize_gen += 1
        payload = {"gen": gen, "seq": self._progress_state[0],
                   "stats_seq": self._comm_stats.progress()["seq"],
                   "barrier_gen": self._barrier_done}
        if self._rank == 0:
            payload["vocab"] = self._vocab_export()
        self._master_send((master_mod.RESIZE, payload))
        with self._ctl_cv:
            # unbounded like barrier(): the release waits on the
            # slowest rank; a terminal abort (or an eviction) breaks
            # the wait with the cluster-wide error
            self._ctl_cv.wait_for(
                lambda: gen in self._resize_results
                or self._recovery.fatal is not None)
            if gen in self._resize_results:
                self._resize_results.pop(gen)
                self._resize_done = gen + 1
                return list(self._roster)
        raise self._recovery.fatal_exc()

    # -- control-plane receiver -------------------------------
    @property
    def epoch(self) -> int:
        """The job-wide recovery epoch this rank has been released
        into (0 until the first abort round completes)."""
        return self._recovery.epoch

    def _ctl_wake(self) -> None:
        with self._ctl_cv:
            self._ctl_cv.notify_all()
        with self._peer_cv:
            self._peer_cv.notify_all()

    def _teardown_peers(self) -> None:
        """Invalidate every peer channel and forget it — the DRAIN of
        an abort round: in-flight frames of the old epoch die with
        their sockets (raw and framed planes alike), and any
        collective blocked on one of them unblocks with a transport
        error. The channels are only SHUT DOWN here, not closed: the
        fd release is deferred to the collective thread
        (:meth:`_drain_dead_channels`) so a native poll still
        unwinding cannot race a re-dial onto a recycled fd number.
        Idempotent; runs on the control thread."""
        with self._peer_cv:
            chans = list(self._peers.values())
            self._peers.clear()
            self._dead_channels.extend(chans)
            self._peer_cv.notify_all()
        for ch in chans:
            ch.invalidate()

    def _drain_dead_channels(self) -> None:
        """Release the fds of torn-down channels. Called from the
        COLLECTIVE thread between attempts (and at close): the
        previous attempt has fully unwound, so no native call can
        still hold these raw fd numbers — only now is fd reuse safe.

        "Fully unwound" must cover the send-helper thread too: a recv
        that raised first abandons its paired send future, and that
        worker may still be entering sendall on a torn fd — wait for
        every outstanding send (bounded: the teardown's shutdown()
        errors them out) before any fd is freed for reuse."""
        futs, self._send_futs = self._send_futs, []
        for f in futs:
            try:
                f.result(timeout=5.0)
            # Not a data path: these futures belong to a torn-down
            # attempt and are expected to error — the wait exists only
            # to fence fd reuse; the failure was already reported by
            # the recv that triggered the teardown.
            # mp4j-lint: disable=R5 (expected errors from torn-channel sends)
            except Exception:
                pass
        with self._peer_cv:
            chans = list(self._dead_channels)
            self._dead_channels.clear()
        for ch in chans:
            try:
                ch.close()
            except OSError:
                pass

    def _ctl_loop(self) -> None:
        """The single reader of the master channel after rendezvous:
        demultiplexes barrier releases, the close ack, and the
        recovery protocol's asynchronous abort pushes. Must stay alive
        while any collective blocks — delivering an abort is what
        unhangs it."""
        while True:
            try:
                msg = self._master.recv()
            except (Mp4jError, OSError, EOFError) as e:
                with self._master_lock:
                    closed = self._closed
                if not closed:
                    self._recovery.on_fatal(
                        f"master connection lost: {e!r}")
                    self._ctl_wake()
                return
            if msg == "closed":
                self._closed_ack.set()
                self._ctl_wake()
                return
            kind = msg[0] if isinstance(msg, tuple) and msg else None
            try:
                if kind == "barrier_release":
                    with self._ctl_cv:
                        self._barrier_released.add(msg[1])
                        self._ctl_cv.notify_all()
                elif kind == "abort":
                    self._recovery.on_abort(int(msg[1]))
                elif kind == "abort_go":
                    # a membership go carries the roster
                    # change; it must land BEFORE the epoch release
                    # wakes any retry — the re-dials read the roster
                    if len(msg) > 2 and msg[2]:
                        self._apply_membership(msg[2])
                    self._recovery.on_go(int(msg[1]))
                elif kind == "manifest_req":
                    # the master needs this survivor's adoption
                    # manifest: vocabulary export + progress
                    # + barrier position, all quiescent while the
                    # collective thread waits out the round
                    with self._ctl_cv:
                        barrier_gen = self._barrier_done
                        resize_gen = self._resize_done
                    try:
                        self._master_send((master_mod.MANIFEST, {
                            "epoch": int(msg[1]),
                            "vocab": self._vocab_export(),
                            "seq": self._progress_state[0],
                            "inflight": self._progress_state[1],
                            "stats_seq": self._comm_stats.progress()[
                                "seq"],
                            "barrier_gen": barrier_gen,
                            "resize_gen": resize_gen,
                        }))
                    except (Mp4jError, OSError):
                        pass  # master gone; its watchdog owns this
                elif kind == "health_alert":
                    # a health-plane verdict transition naming this
                    # rank (or orphaned onto it): land it in the
                    # recovery log and the alert log the durable sink
                    # drains — the evidence must survive the process
                    ev = msg[1] if isinstance(msg[1], dict) else {}
                    self._health_alerts.note(ev)
                    if ev.get("kind") == "autoscale":
                        # controller action events share
                        # the pipe: timelines interleave actions with
                        # the verdicts that caused them
                        self._recovery.note(
                            "autoscale",
                            f"{ev.get('event')} {ev.get('action')}: "
                            f"{ev.get('msg', '')}"[:160])
                    elif ev.get("kind") == "tuner":
                        # tuner controller events (demote /
                        # would_demote / trip) — same pipe, logged
                        # under their own kind so mp4j-scope tuner
                        # finds them (the health onset fallback would
                        # render them as "rank None onset (None)")
                        self._recovery.note(
                            "tuner",
                            f"{ev.get('event')}: "
                            f"{ev.get('msg', '')}"[:160])
                    else:
                        self._recovery.note(
                            "health",
                            f"rank {ev.get('rank')} {ev.get('from')}->"
                            f"{ev.get('to')} ({ev.get('detector')})"
                            if ev.get("kind") == "state" else
                            f"rank {ev.get('rank')} onset "
                            f"({ev.get('detector')})")
                elif kind == "tuner_leaders":
                    # fenced tuner topology update: lands
                    # while every rank is parked at the same boundary
                    # (the master releases the fence only after this
                    # push), so the leader switch is atomic job-wide
                    ov = msg[1] if isinstance(msg[1], dict) else {}
                    self._apply_leaders(ov)
                    self._recovery.note(
                        "tuner", f"leader overrides {ov or 'cleared'}")
                elif kind == "tuner_trip":
                    # audit divergence under adaptation: back to
                    # static defaults at the next boundary, policy
                    # frozen for the job's lifetime
                    why = str(msg[1])[:300]
                    if self._tuner is not None:
                        self._tuner.trip(why)
                    self._recovery.note("tuner", f"TRIPPED: {why}")
                elif kind == "fence":
                    # eviction fence: park at the next
                    # outermost collective boundary, wire untouched
                    self._recovery.on_fence(int(msg[1]))
                elif kind == "fence_advance":
                    self._recovery.on_fence_advance(int(msg[1]),
                                                    int(msg[2]))
                elif kind == "fence_release":
                    self._recovery.on_fence_release(int(msg[1]))
                elif kind == "evicted":
                    # planned eviction: this rank's id now
                    # belongs to an adopted spare — every parked wait
                    # breaks with a clean Mp4jEvicted, close() skips
                    # the handshake the master already wrote off
                    self._recovery.on_evicted(str(msg[1]))
                elif kind == "resize_go":
                    # resize release: a grown roster lands
                    # BEFORE resize_point() wakes (its re-dials and
                    # the next collective's schedule read it); None
                    # info = no change this generation
                    info = msg[2] if len(msg) > 2 else None
                    if info and "roster" in info:
                        self._set_roster(info["roster"])
                        self._sync_identity()
                        self._recovery.note(
                            "grow",
                            f"roster grew to {self._n} rank(s) "
                            f"(new: {info.get('grown')}) @ resize "
                            f"{msg[1]}")
                    with self._ctl_cv:
                        self._resize_results[int(msg[1])] = info or {}
                        self._ctl_cv.notify_all()
                    self._ctl_wake()
                elif kind == "abort_fatal":
                    self._recovery.on_fatal(str(msg[1]))
                else:
                    # fail fast like the barrier reply
                    # check: an unrecognized control frame means the
                    # two sides disagree about the protocol — waiting
                    # would hang
                    self._recovery.on_fatal(
                        f"control protocol violation: unexpected "
                        f"master message {msg!r}")
                    return
            except Exception as e:
                # a malformed-but-tuple frame (('abort',), ('abort',
                # 'x'), ...) must not kill the sole master-channel
                # reader silently: an untimed barrier wait would then
                # hang forever with nobody left to deliver the
                # master's eventual abort — turn it fatal instead
                self._recovery.on_fatal(
                    f"control protocol violation: malformed master "
                    f"message {msg!r} ({e!r})")
                return

    def _fault_kill(self, fault) -> None:
        """Fault-injected death (resilience.faults ``kill``): abruptly
        close every socket this rank owns, as a crashed process would.
        The master sees the control connection die and fans out the
        terminal abort to the survivors."""
        self._hb_stop.set()
        if self._sink is not None:
            self._sink.abort()   # a corpse flushes nothing
        with self._master_lock:
            self._closed = True
        self._teardown_peers()
        try:
            self._master.close()
        except OSError:
            pass
        self._server.close()

    # -- elastic membership: spare mode + roster updates ----
    def _spare_wait(self, reg_reply):
        """Block as a registered warm spare until the master adopts or
        releases this process. A ping thread keeps the spare's
        liveness visible (a silently dead spare must not be the thing
        a replacement round discovers mid-adoption). Returns
        ``(reply, adopt_info)`` where ``reply`` has the shape of a
        normal rendezvous reply."""
        if not (isinstance(reg_reply, dict) and "spare" in reg_reply):
            raise Mp4jError(
                f"master did not accept the spare registration "
                f"(got {reg_reply!r}); is this master elastic-aware?")
        # spares idle indefinitely by design: the rendezvous timeout
        # bounds registration, not the wait for a fault that may
        # never come
        self._master.set_timeout(None)
        lock = threading.Lock()   # ping thread vs. nobody else yet
        stop = threading.Event()

        def ping():
            while not stop.wait(1.0):
                try:
                    with lock:
                        self._master.send_obj(
                            (master_mod.SPARE_PING, {}))
                except (Mp4jError, OSError):
                    return

        t = threading.Thread(target=ping, daemon=True,
                             name="mp4j-spare-ping")
        t.start()
        try:
            while True:
                try:
                    msg = self._master.recv()
                except (Mp4jError, OSError, EOFError) as e:
                    raise Mp4jSpareReleased(
                        f"master connection lost while idling as a "
                        f"spare: {e!r}") from e
                kind = (msg[0] if isinstance(msg, tuple) and msg
                        else None)
                if kind == "adopt":
                    info = msg[1]
                    break
                if kind in ("release", "abort_fatal"):
                    raise Mp4jSpareReleased(str(msg[1]))
                # anything else is master-side noise; keep waiting
        except BaseException:
            stop.set()
            try:
                self._master.close()
            except OSError:
                pass
            self._server.close()
            raise
        stop.set()
        t.join(2.0)
        reply = {"rank": int(info["rank"]), "roster": info["roster"],
                 "job": info.get("job")}
        return reply, info

    def _adopt_seed(self, info: dict) -> None:
        """Seed a just-adopted joiner from the master-held manifest: the released epoch, the resume ordinal (the
        joiner's next collective pairs with the survivors' retry), the
        barrier generation, the columnar keycodec vocabularies (code
        tables identical to every survivor's post-restore state), and
        the cross-rank-verified audit watermark."""
        epoch = int(info.get("epoch", 0))
        self._recovery.seed(epoch)
        seq = int(info.get("seq", 0))
        self._progress_state = (seq, False)
        self._comm_stats.seed_seq(int(info.get("stats_seq", seq)))
        gen = int(info.get("barrier_gen", 0))
        self._barrier_gen = gen
        self._barrier_done = gen
        # resize position: the joiner's next resize_point
        # pairs with the survivors' next one (grow adoptions seed
        # gen+1 of the round that adopted them)
        rz = int(info.get("resize_gen", 0))
        self._resize_gen = rz
        self._resize_done = rz
        self.resume_seq = seq
        self.resume_barrier_gen = gen
        membership_mod.import_vocab(self._map_codecs,
                                    info.get("vocab") or {})
        if self._audit is not None:
            self._audit.watermark = int(info.get("watermark", 0))
        self._comm_stats.add("replacements_seen", 1)
        self._recovery.note(
            "adopted",
            f"rank {self._rank} @ epoch {epoch} seq {seq}"
            + (" (grow)" if info.get("grow") else "")
            + f" ({info.get('why', '')})"[:160])

    def _vocab_export(self) -> dict[str, list]:
        """This rank's keycodec vocabularies for the adoption manifest,
        pinned at the in-flight collective's pre-attempt sizes (see
        ``_codec_pin``). Runs on the CONTROL thread while the
        collective thread is parked in the abort round — the codecs
        are quiescent."""
        return membership_mod.export_vocab(self._map_codecs,
                                           self._codec_pin)

    def _apply_membership(self, info: dict) -> None:
        """Apply a membership go's roster change (control thread, runs
        BEFORE the epoch release wakes any retry — the re-dials must
        see the new roster). Replacement swaps entries under the same
        ids; shrink renumbers this rank and every roster-derived
        quantity through the one sanctioned accessor."""
        shrink = info.get("shrink")
        if shrink is not None:
            mapping = {int(k): int(v)
                       for k, v in shrink["ranks"].items()}
            old_rank = self._rank
            # mp4j-lint: disable=R15 (the renumbering site itself)
            self._rank = mapping[self._rank]
            self._set_roster(shrink["roster"])
            self._sync_identity()
            self._comm_stats.add("shrinks_seen", 1)
            self._recovery.note(
                "shrink",
                f"rank {old_rank}->{self._rank} of {self._n} "
                f"(dropped {shrink.get('departed')}) @ epoch "
                f"{shrink.get('epoch')}")
        elif "roster" in info:
            self._set_roster(info["roster"])
            self._recovery.note(
                "replace",
                f"rank(s) {info.get('replaced')} replaced @ epoch "
                f"{info.get('epoch')}")

    # -- telemetry (control plane only) --------------------------------
    def _telemetry_payload(self) -> dict:
        """The heartbeat message: progress plus stats/metric DELTAS
        since the last payload (a long job's beat
        is bounded by recent activity, not by every collective family
        ever seen). Deltas are additive, so the master may fold them
        in any arrival order; the last-shipped state advances under
        ``_tel_lock`` so concurrent senders never drop or double-ship
        an interval."""
        with self._tel_lock:
            stats = self._comm_stats.snapshot()
            mets = self._comm_stats.metrics.snapshot()
            sd = stats_mod.diff_snapshots(stats, self._tel_last_stats)
            md = metrics_mod.diff_snapshot(mets, self._tel_last_metrics)
            self._tel_last_stats = stats
            self._tel_last_metrics = mets
        prog = self._comm_stats.progress()
        # the recovery epoch rides every beat: `mp4j-scope
        # live` renders it next to the membership badges
        prog["epoch"] = self._recovery.epoch
        payload = {"progress": prog,
                   "stats_delta": sd, "metrics_delta": md}
        if self._health_folder is not None:
            # completed per-ordinal span cells: the online
            # dominator's live feed — bounded per beat like every
            # other delta, overflow counted, never silent
            hd = self._health_folder.take()
            if hd is not None:
                payload["health_delta"] = hd
        if self._audit is not None:
            # verify/capture ship digest records as deltas (the audit
            # ring keeps its own cursor, bounded like the stats delta);
            # digest mode is record-only and ships nothing
            ad = self._audit.take_delta()
            if ad is not None:
                payload["audit_delta"] = ad
        tun = self._tuner
        if tun is not None:
            # tuner window fold: the policy core consumes
            # the per-link stats window here on the heartbeat thread —
            # off the collective hot path — and the committed (or, in
            # observe mode, would-be) decisions land in the recovery
            # log (-> durable sink) and the shipped status document
            # the payload builder runs on the heartbeat thread AND on
            # the terminal-abort hook's final flush: the window gate
            # must be claimed atomically or both fold the same window
            now = time.monotonic()
            with self._tel_lock:
                due = now >= self._tuner_next
                if due:
                    self._tuner_next = now + self._tuner_window
            if due:
                for peer, d in tun.observe(
                        self._comm_stats.link_snapshot()):
                    self._recovery.note(
                        "tuner",
                        f"link->{peer} decided chunk="
                        f"{d.get('chunk_bytes')} compress="
                        f"{d.get('compress')} ({tun.mode})")
            payload["tuner"] = tun.status()
        return payload

    def _heartbeat_loop(self) -> None:
        while True:
            try:
                self._master_send(
                    (master_mod.TELEMETRY, self._telemetry_payload()))
            except (Mp4jError, OSError):
                return  # closed or master gone; telemetry is best-effort
            if self._hb_stop.wait(self._hb_secs):
                return

    def _on_collective_error(self, name: str, exc: BaseException) -> None:
        """Fired by trace.traced when an outermost collective raises:
        best-effort DIAGNOSE to the master, which logs the cluster-wide
        hang diagnosis (who is behind the max sequence number, where,
        how stale) instead of leaving a bare per-rank Mp4jError."""
        try:
            self._master_send((master_mod.DIAGNOSE, {
                "collective": name, "error": repr(exc)[:300],
                **self._telemetry_payload()}))
        except (Mp4jError, OSError):
            pass  # diagnosis is best-effort; the original exc surfaces

    def _on_terminal_abort(self, msg: str) -> None:
        """Recovery's terminal hook (runs once, before the fatal flag
        wakes any waiter): flush the final telemetry delta — so the
        master's last heartbeat table is fresh in postmortems, not
        only after a clean close — then dump this rank's flight-
        recorder bundle."""
        try:
            self._master_send(
                (master_mod.TELEMETRY, self._telemetry_payload()))
        except (Mp4jError, OSError):
            pass  # master may be the thing that died
        if self._sink is not None:
            # the fatal path may never reach close(): drain the rings
            # NOW so the job's last interval is durable before anyone
            # raises
            self._sink.flush()
        self._dump_postmortem(msg)

    def _dump_postmortem(self, reason: str) -> None:
        """Write this rank's postmortem bundle (once, best-effort)."""
        if not self._postmortem_dir or self._pm_done:
            return
        self._pm_done = True
        try:
            postmortem.write_bundle(
                self._postmortem_dir, self._rank, reason=reason,
                progress=self._comm_stats.progress(),
                stats=self._comm_stats.snapshot(),
                metrics=self._comm_stats.metrics.snapshot(),
                epoch=self._recovery.epoch,
                events=self._recovery.events(),
                audit=(self._audit.dump() if self._audit is not None
                       else None),
                sink=(self._sink.status() if self._sink is not None
                      else None))
        except OSError:
            pass  # the recorder must never worsen a dying job

    def close(self, code: int = 0) -> None:
        if self._closed:
            return
        # drain the nonblocking scheduler first (bounded): in-flight
        # futures either complete or fail with the terminal error —
        # close must never strand a waiter (mp4j-lint R16 flags the
        # un-awaited-future-before-close hazard statically)
        if self._async is not None:
            self._async.shutdown()
        self._hb_stop.set()
        # flush-on-close: the final collective's spans and
        # deltas reach the segment before the close handshake — a
        # clean job's sink is complete, not one interval short
        if self._sink is not None:
            self._sink.close()
        sent = False
        # final telemetry delta computed OUTSIDE _master_lock (the
        # heartbeat thread takes _tel_lock then _master_lock; nesting
        # them here in the other order would be a lock-order inversion)
        flush = self._telemetry_payload()
        # an EVICTED rank skips the whole handshake: the
        # master already wrote this process off (its rank id belongs
        # to the adopted spare, inbound messages are dropped), so the
        # CLOSE would land nowhere and the "closed" ack would never
        # come — waiting it out would turn every clean eviction into
        # a 5 s shutdown stall
        evicted = self._recovery.evicted
        with self._master_lock:
            if self._closed:
                return
            # final telemetry flush so the master's skew table covers
            # the whole run, then the close handshake
            if not evicted:
                try:
                    self._master.send_obj(
                        (master_mod.TELEMETRY, flush))
                except (Mp4jError, OSError):
                    pass  # master may already be gone; close proceeds
            self._closed = True
            if not evicted:
                try:
                    self._master.send_obj(
                        (master_mod.CLOSE, {"code": code}))
                    sent = True
                except (Mp4jError, OSError):
                    pass
        if sent:
            # the "closed" ack arrives on the control thread; bounded —
            # a vanished master must not wedge shutdown
            self._closed_ack.wait(5.0)
        self._master.close()
        with self._peer_cv:
            peers = list(self._peers.values())
        for ch in peers:
            # graceful: a peer recovering from a late abort round may
            # still be draining our final collective's bytes
            ch.close(graceful=True)
        self._drain_dead_channels()
        self._server.close()
        self._pool.shutdown(wait=False)

    def stats(self) -> dict[str, dict[str, float]]:
        """Per-collective transport counters: ``{collective: {calls,
        bytes_sent, bytes_recv, chunks, wire_seconds, reduce_seconds,
        serialize_seconds}}`` (schema: :mod:`ytk_mp4j_tpu_torch.utils.stats`).
        Always on; phase seconds are busy times and may overlap in wall
        time (pipelining is the point)."""
        return self._comm_stats.snapshot()

    def progress(self) -> dict:
        """This rank's telemetry progress record — the per-slave
        collective sequence number plus current/last collective and
        phase (schema: :mod:`ytk_mp4j_tpu_torch.obs.telemetry`). The same
        record the heartbeat ships to the master."""
        return self._comm_stats.progress()

    def audit_records(self) -> list[dict]:
        """This rank's audit record ring (empty when
        ``MP4J_AUDIT=off``): one record per outermost collective —
        ordinal, family, operand signature, input/output digests,
        wire folds (verify) and captured payloads (capture)."""
        return [] if self._audit is None else self._audit.records()

    def dump_audit(self, root: str) -> str | None:
        """Write this rank's ``rank_NNNN/audit.json`` under ``root``
        — the replay-bundle layout (``mp4j-scope replay``); the same
        file joins the postmortem bundle automatically on a terminal
        abort. Returns the path, or None with auditing off."""
        if self._audit is None:
            return None
        return audit_mod.write_rank_audit(root, self._rank,
                                          self._audit.dump())

    def sink_status(self) -> dict | None:
        """The durable sink's health record (None when the
        sink is disarmed): segment dir, bytes/records written,
        dropped-record count, eviction count, budget."""
        return None if self._sink is None else self._sink.status()

    def link_stats(self) -> dict[int, dict]:
        """Per-peer-link rolling wire evidence: cumulative
        bytes/seconds/frames (split per transport), compression
        outcomes (raw vs wire bytes), and the APPLIED per-link socket
        buffer sizes — the substrate the tuner's decisions are made
        from, and the record of what the transport actually did."""
        return self._comm_stats.link_snapshot()

    def tuner_status(self) -> dict | None:
        """The self-tuning data plane's document (None with
        ``MP4J_TUNER=off``): mode, trip state, decision count, and the
        per-link decisions currently applied (or, in observe mode,
        that WOULD apply)."""
        return None if self._tuner is None else self._tuner.status()

    # ------------------------------------------------------------------
    # peer transport
    # ------------------------------------------------------------------
    @staticmethod
    def _derive_host_groups(roster) -> list[list[int]]:
        """Rank groups sharing a host fingerprint (delegates to the
        shared pure function in :mod:`ytk_mp4j_tpu_torch.utils.tuner` —
        it lives there so the master's tuner controller and
        the slaves derive topology from ONE implementation)."""
        return tuner_mod.host_groups(roster)

    def _set_roster(self, roster) -> None:
        """THE roster-versioned topology update (mp4j-lint R15's
        sanctioned site): every roster-derived quantity — rank count,
        host groups, this rank's host members, the leader sets — is
        (re)derived here and ONLY here, so a membership change
        (replacement swaps a roster entry, shrink renumbers
        the survivors) updates ALL of them atomically with one call.
        Code elsewhere must read these attributes, never re-derive and
        cache its own copy — a long-lived private cache survives the
        renumbering silently wrong (that is rule R15)."""
        # mp4j-lint: disable=R15 (the sanctioned derivation site itself)
        self._roster = list(roster)
        self._n = len(self._roster)
        self._host_groups = tuner_mod.host_groups(self._roster)
        # a membership change invalidates any tuner leader override:
        # the demotion was evidence about the OLD topology (the master
        # re-issues it through a fresh fence if still warranted) — and
        # stale per-link evidence AND decisions must not inherit a
        # renumbered (or replaced) peer id: the LinkTuner resets too,
        # so a fresh process addressed by an old id starts from static
        # defaults, not the old occupant's committed adaptation
        self._leader_overrides = {}
        if self._roster_version > 0:
            stats = getattr(self, "_comm_stats", None)
            if stats is not None:
                stats.forget_links()
            tun = getattr(self, "_tuner", None)
            if tun is not None:
                tun.reset()
        self._members = next(g for g in self._host_groups
                             if self._rank in g)
        self._leader = self._members[0]
        self._leaders = [g[0] for g in self._host_groups]
        self._roster_version += 1

    def _apply_leaders(self, overrides: dict) -> None:
        """Apply a fenced tuner topology update: the master
        pushed ``tuner_leaders`` while EVERY rank is parked at the
        same collective boundary, so switching the effective leader
        set here — on the ctl thread, before the fence release wakes
        the collective thread — is atomic job-wide. Derivation rides
        the same pure functions as ``_set_roster``; an override that
        no longer names a member of its group falls back to the
        default leader rather than desyncing the schedule."""
        # mp4j-lint: disable=R15 (fenced job-wide update; reset by _set_roster)
        self._leader_overrides = {int(k): int(v)
                                  for k, v in (overrides or {}).items()}
        leaders = tuner_mod.leaders_for(self._host_groups,
                                        self._leader_overrides)
        gi = next(i for i, g in enumerate(self._host_groups)
                  if self._rank in g)
        self._leaders = leaders
        self._leader = leaders[gi]

    def _sync_identity(self) -> None:
        """Mirror the current (rank, slave_num) into the attached
        observability/recovery planes — the ONE place those mirrors
        are written, so a shrink renumbering cannot strand one of
        them on the old id (mp4j-lint R15 baseline)."""
        with self._tel_lock:
            self._comm_stats.rank = self._rank  # tags spans + heartbeats
        if self._audit is not None:
            self._audit.rank = self._rank   # tags the audit bundle
            self._audit.slave_num = self._n  # replay's dead-rank guard
        rec = getattr(self, "_recovery", None)
        if rec is not None:
            rec.rank = self._rank           # names this rank in aborts
        folder = getattr(self, "_health_folder", None)
        if folder is not None:
            # the span folder filters the process-global ring by this
            # rank's id — a shrink renumbering must retarget it or it
            # ships the OLD occupant's cells
            folder._rank = self._rank

    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return  # server closed
            ch = None
            try:
                # sanctioned channel-construction site: the inbound
                # peer handshake must be read over SOME transport
                # before the pair's negotiated transport exists (R12
                # baseline, like the rendezvous sites)
                ch = tcp_mod.TcpChannel(sock)
                # bound the rank exchange: a stray connection that never
                # sends must not wedge the accept loop every healthy
                # peer depends on. The handshake carries (rank, epoch)
                # — the dialer pins the channel's job-wide epoch here,
                # the frame-level half of the epoch fence — plus, for a
                # same-host pair, the shm segment name + ring size the
                # dialer created (transport negotiation).
                ch.set_timeout(self._handshake_timeout)
                # sanctioned pre-fence receive: the handshake decides
                # which epoch the channel BELONGS to, so the fence
                # cannot apply yet (mp4j-lint R10 baseline)
                hs = ch.recv()
                if len(hs) == 2:
                    peer_rank, peer_epoch = hs
                    seg_token, ring_bytes = None, 0
                else:
                    peer_rank, peer_epoch, seg_token, ring_bytes = hs
                    tok_ok = (isinstance(seg_token, tuple)
                              and len(seg_token) >= 2
                              and seg_token[0] in ("memfd", "shm"))
                    # floor mirrors the MP4J_SHM_RING_BYTES validator
                    # (ONE constant — mp4j-lint R22's knob-drift class)
                    if not (tok_ok and isinstance(ring_bytes, int)
                            and not isinstance(ring_bytes, bool)
                            and ring_bytes >= tuning.SHM_RING_FLOOR):
                        raise TypeError(
                            f"malformed shm handshake {hs!r}")
                # strict integer types, no coercion: int('2')/int(2.7)
                # would let a stray dial-in claim a healthy rank's
                # peer slot (bool is an int subclass — reject it too)
                if (isinstance(peer_rank, bool)
                        or not isinstance(peer_rank, int)
                        or isinstance(peer_epoch, bool)
                        or not isinstance(peer_epoch, int)):
                    raise TypeError(f"malformed peer handshake {hs!r}")
                if peer_rank >= self._n:
                    # a freshly grown joiner dials the moment its
                    # constructor returns, which can beat the master's
                    # resize_go to this rank by one control push
                    #: wait briefly for the roster to grow
                    # instead of rejecting a healthy peer
                    with self._peer_cv:
                        self._peer_cv.wait_for(
                            lambda: peer_rank < self._n
                            or self._recovery.fatal is not None,
                            timeout=self._handshake_timeout)
                if seg_token is not None:
                    # only a fingerprint-matched peer may offer a shm
                    # segment (a stray dial-in must not make us mmap
                    # arbitrary names/fds); attach and upgrade the
                    # channel — the TCP socket stays as the carrier
                    entry = (self._roster[peer_rank]
                             if 0 <= peer_rank < self._n else ())
                    # gate on the REGISTERED fingerprint, not the live
                    # _shm flag: a rank that fell back to TCP after a
                    # local segment-creation failure must still honor
                    # inbound offers (attaching costs no creation
                    # resources), or the offering dialer would loop
                    # against its rejections forever
                    if not (self._fp and len(entry) > 2
                            and entry[2] == self._fp):
                        raise TypeError(
                            f"unsolicited shm offer from {peer_rank}")
                    seg = shm_mod.attach_segment(seg_token)
                    ch = shm_mod.ShmChannel(sock, seg, ring_bytes,
                                            owner=False)
            except Exception:
                # a peer (or stray connection) died mid-handshake; the
                # accept loop must survive to serve the healthy peers.
                # Close the CHANNEL when one got as far as wrapping the
                # socket (an shm upgrade owns a segment the raw socket
                # close would strand), else the socket itself.
                if ch is not None:
                    ch.close()
                else:
                    sock.close()
                continue
            try:
                with self._peer_cv:
                    # a dialer can be ahead of us by one abort round
                    # (its go arrived first): wait for our own go
                    # instead of rejecting a healthy reconnect
                    if peer_epoch > self._recovery.epoch:
                        self._peer_cv.wait_for(
                            lambda: self._recovery.epoch >= peer_epoch
                            or self._recovery.fatal is not None,
                            timeout=self._handshake_timeout)
                    # only a well-formed, novel rank dialing at the
                    # CURRENT epoch may claim a peer slot: a stray
                    # dial-in — or a stale one from a torn-down epoch —
                    # must not hijack (or orphan) a healthy peer's
                    # channel. abort_pending closes the announce->go
                    # window, where the epoch number still matches but
                    # the teardown may already have drained _peers (a
                    # registration after it would never be invalidated)
                    if (not 0 <= peer_rank < self._n
                            or peer_rank == self._rank
                            or peer_rank in self._peers
                            or peer_epoch != self._recovery.epoch
                            or self._recovery.abort_pending()):
                        ch.close()
                        continue
                    ch.set_timeout(self._peer_timeout)
                    ch.stats = self._comm_stats  # books wire time
                    ch.peer_rank = peer_rank     # tags wire spans
                    ch.faults = self._faults     # fault-injection hook
                    ch.epoch = peer_epoch        # pinned for the fence
                    # per-link socket buffers: the
                    # accept side learns the peer only now, so the map
                    # applies post-handshake (no window-scale effect —
                    # documented; the dial side applies before connect)
                    if peer_rank in self._so_buf_map \
                            and ch.transport == "tcp":
                        try:
                            tcp_mod.set_so_bufs(
                                ch.sock, *self._so_buf_map[peer_rank])
                        except OSError:
                            pass
                    self._peers[peer_rank] = ch
                    self._peer_cv.notify_all()
            except Exception:
                # the epoch gate raising (fatal mid-wait, interpreter
                # teardown) must not strand the accepted channel's fd
                ch.close()
                raise
            self._tuner_register_channel(peer_rank, ch)
            if peer_epoch > 0:
                self._comm_stats.add("reconnects", 1)

    def _fenced(self, peer: int) -> Channel:
        """THE epoch-fence wrapper: every peer data-plane operation
        must acquire its channel here (mp4j-lint R10). One flag check
        on the hot path — when an abort round is in flight this raises
        immediately instead of dialing into (or writing to) a torn
        epoch, so every rank converges on the retry barrier instead of
        manufacturing fresh wire errors."""
        self._recovery.poll()
        ch = self._channel(peer)
        # the channel's pinned epoch must also match the attempt's: a
        # full abort round can complete while _channel blocks waiting
        # for a peer dial-in, handing a fresh-epoch channel to a stale
        # attempt that already passed poll()
        self._recovery.check_channel(ch.epoch)
        return ch

    def _fenced_try(self, peer: int) -> "Channel | None":
        """Non-blocking :meth:`_fenced` for the async engine's
        incremental arming. When this rank is the ACCEPT side (peer >
        rank) and the higher rank has not dialed in yet, returns None
        instead of parking in the peer cv: a blocked progression
        thread stops pumping every OTHER leg it owns, and the dial it
        waits for may itself be cursor-gated behind bytes those legs
        owe — a mixed establishment/byte-dependency deadlock (seen on
        the n=5 shm engine grid). Dial-side establishment stays
        synchronous: the peer's accept loop is always responsive, so
        the connect is bounded and cannot join a cycle."""
        self._recovery.poll()
        if peer > self._rank:
            with self._peer_cv:
                ch = self._peers.get(peer)
            if ch is None:
                return None
        else:
            ch = self._channel(peer)
        self._recovery.check_channel(ch.epoch)
        return ch

    def _channel(self, peer: int) -> Channel:
        if peer == self._rank or not (0 <= peer < self._n):
            raise Mp4jError(f"bad peer {peer}")
        with self._peer_cv:
            ch = self._peers.get(peer)
            if ch is not None:
                return ch
        if peer < self._rank:
            # Dial OUTSIDE the cv: only the collective thread ever
            # dials (helper-thread sends bind their channel at submit
            # time), so no serialization is needed — and a connect()
            # blocked on an unreachable host must not hold the lock
            # the control thread's abort teardown and the accept loop
            # both depend on (a held cv would stall this rank's
            # ABORT_ACK for the whole connect timeout and escalate a
            # recoverable fault to a terminal abort).
            ch = self._dial(peer)
            with self._peer_cv:
                if (ch.epoch != self._recovery.epoch
                        or self._recovery.abort_pending()):
                    # an abort round completed — or was announced and
                    # its teardown already ran (epoch unchanged until
                    # the go, so equality alone misses it) — while we
                    # were dialing: registering this channel would park
                    # it past the drain and wedge every retry behind
                    # it — discard and re-route through the recovery
                    # engine instead
                    ch.close()
                    self._recovery.poll()
                    raise Mp4jTransportError(
                        f"dial to peer {peer} landed in a torn-down "
                        f"epoch {ch.epoch}")
                ch.set_timeout(self._peer_timeout)
                ch.stats = self._comm_stats  # channels book wire time
                ch.peer_rank = peer          # tags wire spans
                ch.faults = self._faults     # fault-injection hook
                self._peers[peer] = ch
                self._peer_cv.notify_all()
            self._tuner_register_channel(peer, ch)
            if ch.epoch > 0:
                self._comm_stats.add("reconnects", 1)
            return ch
        with self._peer_cv:
            # lower rank waits for the higher rank to dial in; an abort
            # or terminal fan-out breaks the wait (the dial will never
            # come for a torn-down epoch)
            ok = self._peer_cv.wait_for(
                lambda: peer in self._peers
                or self._recovery.abort_pending(),
                timeout=self._timeout)
            if peer in self._peers:
                return self._peers[peer]
        self._recovery.poll()   # raises if that is why we woke
        if not ok:
            raise Mp4jTransportError(
                f"timeout waiting for peer {peer} to connect")
        raise Mp4jTransportError(
            f"peer {peer} never re-dialed after recovery")

    def _shm_peer(self, peer: int) -> bool:
        """Whether the (self, peer) pair negotiates shm: equal,
        non-empty host fingerprints in the shared roster — a pure
        function of job-wide state, so both ends agree before any
        byte moves."""
        entry = self._roster[peer]
        return bool(self._shm and self._fp and len(entry) > 2
                    and entry[2] == self._fp)

    def _dial(self, peer: int) -> Channel:
        """Dial a lower rank's listen socket with capped exponential
        backoff (``MP4J_RECONNECT_BACKOFF``): after an abort round the
        remote may still be tearing down, so the first attempt can see
        a refused/reset connect. Runs WITHOUT the peer cv (see
        _channel); the fence poll each iteration keeps the loop
        abort-aware. The channel's epoch is pinned HERE and rides the
        handshake — and for a same-host pair the dialer CREATES the
        shm segment and names it in the same handshake, so
        transport negotiation adds zero round trips."""
        host, port = self._roster[peer][0], self._roster[peer][1]
        use_shm = self._shm_peer(peer)
        deadline = (None if self._timeout is None
                    else time.monotonic() + self._timeout)
        backoff = max(self._reconnect_backoff, 0.001)
        while True:
            self._recovery.poll()
            epoch = self._recovery.epoch
            ch = None
            seg = None
            try:
                # per-link socket buffers: the
                # dialer knows the peer, so the override applies
                # BEFORE connect() — the TCP window scale is fixed at
                # the handshake
                ch = connect(host, port, timeout=self._timeout,
                             so_bufs=self._so_buf_map.get(peer))
                # sanctioned pre-fence send: the handshake pins the
                # epoch the fence will enforce (mp4j-lint R10 baseline)
                if use_shm:
                    lo, hi = min(self._rank, peer), max(self._rank, peer)
                    name = shm_mod.segment_name(self._job_id, lo, hi,
                                                epoch)
                    try:
                        seg = shm_mod.create_segment(
                            name, self._shm_ring_bytes)
                    except OSError as e:
                        # a LOCAL resource failure (fd limit, /dev/shm
                        # full on the fallback backing) would otherwise
                        # ride the backoff loop forever against a
                        # healthy peer — the accepter still takes the
                        # plain 2-tuple handshake, so stop offering shm
                        # and keep the job alive on TCP
                        self._shm = False
                        use_shm = False
                        try:
                            self.error(
                                f"shm segment creation failed ({e}); "
                                "this rank falls back to TCP for all "
                                "pairs")
                        except (Mp4jError, OSError):
                            pass   # pre-rendezvous error() cannot send
                if use_shm:
                    ch.send_obj((self._rank, epoch, seg.token,
                                 self._shm_ring_bytes))
                    ch = shm_mod.ShmChannel(ch.sock, seg,
                                            self._shm_ring_bytes,
                                            owner=True)
                else:
                    ch.send_obj((self._rank, epoch))
                ch.epoch = epoch
                return ch
            except (Mp4jTransportError, OSError):
                if seg is not None and not isinstance(ch,
                                                      shm_mod.ShmChannel):
                    # created but never wrapped: free the segment here
                    # (once wrapped, ch.close() below owns it)
                    seg.close()
                # OSError included: the remote can accept the TCP
                # connection and tear it down before our handshake
                # send lands (exactly the post-abort window this
                # backoff exists for) — a raw ECONNRESET/EPIPE must
                # back off locally, not burn a job-wide retry round
                if ch is not None:
                    ch.close()
                if (deadline is not None
                        and time.monotonic() + backoff > deadline):
                    raise
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)

    @staticmethod
    def _send_on(ch: Channel, data, compress: bool = False) -> None:
        if isinstance(data, np.ndarray):
            ch.send_array(data, compress=compress)
        else:
            ch.send_obj(data, compress=compress)

    # -- tuner decision consumption -------------------------
    # Per-link decisions are SENDER-LOCAL by construction: the framed
    # wire format is receiver-auto-detected (frame tags), and chunk
    # granularity is local on a byte-stream transport — see the safety
    # argument in utils/tuner.py. Both helpers are one dict.get on the
    # hot path and collapse to the static default with the tuner off,
    # observing, or tripped.
    def _compress_for(self, peer: int, requested: bool) -> bool:
        tun = self._tuner
        if tun is None or tun.mode != "act":
            return requested
        return tun.effective_compress(peer, requested)

    def _chunk_for(self, peer: int) -> int:
        tun = self._tuner
        if tun is None or tun.mode != "act" or self._shm_peer(peer):
            # shm pairs keep the job-wide schedule: the raw plane's
            # per-exchange ring/carrier routing makes it wire contract
            return self._chunk_bytes
        return tun.effective_chunk(peer, self._chunk_bytes)

    def _tuner_register_channel(self, peer: int, ch: Channel) -> None:
        """Channel-setup half of the tuner wiring: record the link's
        transport + applied socket buffer sizes in the per-link stats
        and re-apply any live chunk decision
        to the fresh channel (a recovery re-dial must not silently
        reset an adapted link)."""
        if ch.transport == "tcp":
            try:
                snd, rcv = tcp_mod.applied_buf_sizes(ch.sock)
                self._comm_stats.note_link(peer, transport="tcp",
                                           so_sndbuf=snd, so_rcvbuf=rcv)
            except OSError:
                self._comm_stats.note_link(peer, transport="tcp")
            tun = self._tuner
            if tun is not None and tun.mode == "act":
                ch.set_chunk_bytes(
                    tun.effective_chunk(peer, self._chunk_bytes))
        else:
            self._comm_stats.note_link(peer, transport=ch.transport)

    def _tuner_apply(self, tun) -> None:
        """Drain the tuner's pending decisions at an OUTERMOST
        collective boundary (the recovery wrapper calls this before
        any wire byte of the collective moves — decisions never change
        mid-collective). Also executes the audit-trip revert: every
        adapted link snaps back to the static defaults."""
        pending, revert = tun.take_pending()
        with self._peer_cv:
            chans = dict(self._peers)
        if revert:
            for peer, ch in chans.items():
                if ch.transport == "tcp":
                    ch.set_chunk_bytes(self._chunk_bytes)
            self._recovery.note(
                "tuner", "reverted all links to static defaults")
        for peer, d in pending.items():
            ch = chans.get(peer)
            cb = d.get("chunk_bytes")
            if cb and ch is not None and ch.transport == "tcp":
                ch.set_chunk_bytes(cb)
            if ch is not None and ch.transport == "tcp" and (
                    d.get("so_sndbuf") or d.get("so_rcvbuf")):
                try:
                    tcp_mod.set_so_bufs(ch.sock, d.get("so_sndbuf"),
                                        d.get("so_rcvbuf"))
                    snd, rcv = tcp_mod.applied_buf_sizes(ch.sock)
                    self._comm_stats.note_link(
                        peer, so_sndbuf=snd, so_rcvbuf=rcv)
                except OSError:
                    pass   # a refused resize keeps the old buffers
            self._comm_stats.metrics.inc("tuner/decisions")
            self._recovery.note(
                "tuner",
                f"link->{peer} applied chunk={d.get('chunk_bytes')} "
                f"compress={d.get('compress')}")

    def _send(self, peer: int, data, compress: bool = False) -> None:
        if isinstance(data, np.ndarray):
            self._comm_stats.add_transfer(peer, data.nbytes)
        self._send_on(self._fenced(peer), data,
                      self._compress_for(peer, compress))

    def _submit_send(self, peer: int, data, compress: bool = False):
        """Helper-thread send with the channel resolved NOW, under the
        epoch fence — a queued send job from an attempt the recovery
        engine has since aborted must error on its own (closed) channel,
        never late-resolve a fresh one and write stale-epoch bytes into
        the retry's stream."""
        if isinstance(data, np.ndarray):
            self._comm_stats.add_transfer(peer, data.nbytes)
        fut = self._pool.submit(self._send_on, self._fenced(peer),
                                 data, self._compress_for(peer, compress))
        # tracked so _drain_dead_channels can wait for abandoned
        # futures (a recv that raises first orphans its paired send)
        # before it frees fds; pruned opportunistically so a healthy
        # run never grows the list
        self._send_futs.append(fut)
        if len(self._send_futs) > 32:
            self._send_futs = [f for f in self._send_futs
                               if not f.done()]
        return fut

    def _recv(self, peer: int):
        # peer channels carry ``peer_timeout`` from creation (_channel /
        # _accept_loop); None is the reference's fail-stop default
        # mp4j-lint: disable=R2 (peer_timeout is set at channel creation)
        return self._fenced(peer).recv()

    def _sendrecv(self, send_peer: int, recv_peer: int, data,
                  compress: bool = False):
        """Send and receive concurrently (paired exchange, ring step)."""
        fut = self._submit_send(send_peer, data, compress)
        out = self._recv(recv_peer)
        fut.result()
        return out

    # ------------------------------------------------------------------
    # raw (unframed) data plane
    #
    # The numeric fast path: segment sizes are derived from collective
    # metadata on both ends, so no framing travels on the wire (the
    # reference's primitive DataOutputStream path, SURVEY.md section 2).
    # Whether an exchange is raw must be a pure function of job-wide
    # call parameters — operand properties and the job's
    # native_transport flag — NEVER of local library availability, or
    # ranks would disagree about the wire format. The C++ poll loop
    # (csrc/mp4j_transport.cpp) moves the bytes when available; the
    # Python fallback produces identical wire bytes.
    # ------------------------------------------------------------------
    def _raw_ok(self, operand: Operand) -> bool:
        return (self._native_transport and operand.is_numeric
                and not operand.compress)

    def _exchange_raw(self, send_peer: int, recv_peer: int,
                      sarr: np.ndarray | None, rarr: np.ndarray | None):
        """Full-duplex raw exchange; either side may be absent (None)."""
        send_ch = self._fenced(send_peer) if sarr is not None else None
        recv_ch = self._fenced(recv_peer) if rarr is not None else None
        if self._faults is not None:
            # injector hook at exchange granularity: the native C++
            # poll loop moves the bytes without touching the Python
            # channel primitives, so the channel-level hooks alone
            # would silently skip the raw plane
            if send_ch is not None:
                self._faults.on_io(send_ch, "send")
            if recv_ch is not None and recv_ch is not send_ch:
                self._faults.on_io(recv_ch, "recv")
        if sarr is not None:
            sarr = np.ascontiguousarray(sarr)
        # audit wire folds at EXCHANGE granularity: the
        # native poll loop and the shm rings move raw bytes below the
        # Python channel primitives, so the raw plane digests whole
        # segments here — crc composability makes these folds
        # comparable with the peer's, whatever its chunking
        wire_audit = (self._audit if self._audit is not None
                      and self._audit.wire_on else None)
        if wire_audit is not None and sarr is not None:
            # fold BEFORE any injected corruption: the sender's record
            # describes what it meant to send (see resilience.faults)
            wire_audit.on_wire(send_peer, "send", (_raw_view(sarr),),
                               send_ch.transport)
        if self._faults is not None and sarr is not None:
            f = self._faults.take_corrupt(send_ch, sarr.nbytes)
            if f is not None:
                sarr = faults_mod.corrupt_copy(sarr)
        sides = " ".join(
            ([f"send->{send_peer}"] if sarr is not None else [])
            + ([f"recv<-{recv_peer}"] if rarr is not None else []))
        t0 = time.perf_counter()
        # the native C++ poll loop needs real socket fds on BOTH legs;
        # a shm leg (native_fd() is None) routes the whole exchange
        # through the Python raw primitives — the ring copy IS the
        # fast path there, and the wire bytes are identical either way
        # (the raw/framed decision stays the job-wide _raw_ok rule;
        # native-vs-python within raw is per-exchange local, exactly
        # like the pre-SPI fallback on hosts without the C++ build)
        fd_s = (send_ch or recv_ch).native_fd()
        fd_r = (recv_ch or send_ch).native_fd()
        both_shm = (isinstance(send_ch or recv_ch, shm_mod.ShmChannel)
                    and isinstance(recv_ch or send_ch,
                                   shm_mod.ShmChannel))
        if both_shm:
            # hybrid routing (transport/shm.py): per DIRECTION, bytes
            # ride the ring iff the transfer clears _RING_MIN — a pure
            # function of the segment size both ends share. When BOTH
            # directions are carrier-bound, the exchange is exactly a
            # socket exchange, so hand the carrier fds to the same
            # native poll loop TCP uses (kernel wakeups; wire bytes
            # identical to the shm carrier path)
            s_small = sarr is None or sarr.nbytes < shm_mod._RING_MIN
            r_small = rarr is None or rarr.nbytes < shm_mod._RING_MIN
            if s_small and r_small:
                both_shm = False
                fd_s = (send_ch or recv_ch).sock.fileno()
                fd_r = (recv_ch or send_ch).sock.fileno()
        try:
            if both_shm:
                # single-threaded cooperative duplex — the ring
                # analogue of the native poll loop (a helper-thread
                # send would ping-pong the GIL around user-space
                # memcpys and pay a pool-future handoff per chunk)
                shm_mod.duplex_exchange(send_ch, sarr, recv_ch, rarr)
            else:
                done = False
                if fd_s is not None and fd_r is not None:
                    done = native.sendrecv_raw(fd_s, fd_r, sarr, rarr,
                                               self._peer_timeout)
                if not done:
                    # pure-Python fallback (no native build, or a
                    # MIXED shm+tcp step): helper thread sends while
                    # we receive — sockets park in the kernel, so a
                    # second thread is what keeps both directions
                    # moving
                    fut = (self._pool.submit(send_ch.send_raw, sarr)
                           if sarr is not None else None)
                    if rarr is not None:
                        recv_ch.recv_raw_into(rarr)
                    if fut is not None:
                        fut.result()
        except Exception as e:
            # also catches the fallback's raw socket errors (BrokenPipe,
            # socket.timeout from the helper-thread send) so the "dead
            # peer becomes Mp4jError" contract holds on every path —
            # typed TRANSPORT so the recovery engine may retry it
            raise Mp4jTransportError(
                f"raw exchange ({sides}) failed: {e}") from None
        dt = time.perf_counter() - t0
        if wire_audit is not None and rarr is not None:
            wire_audit.on_wire(recv_peer, "recv", (_raw_view(rarr),),
                               recv_ch.transport)
        sbytes = 0 if sarr is None else sarr.nbytes
        rbytes = 0 if rarr is None else rarr.nbytes
        if (send_ch is not None and recv_ch is not None
                and send_ch.transport != recv_ch.transport):
            # a mixed-transport full-duplex step (e.g. a ring rank
            # with one shm and one TCP neighbor): book each direction
            # on the plane it actually rode
            self._comm_stats.add_wire(sbytes, 0, dt, chunks=1,
                                      peer=send_peer,
                                      transport=send_ch.transport)
            self._comm_stats.add_wire(0, rbytes, 0.0, chunks=0,
                                      peer=recv_peer,
                                      transport=recv_ch.transport)
        else:
            self._comm_stats.add_wire(
                sbytes, rbytes, dt, chunks=1,
                peer=recv_peer if rarr is not None else send_peer,
                transport=(recv_ch or send_ch).transport)

    def _recv_buf(self, operand: Operand, n: int) -> np.ndarray:
        """A pooled scratch buffer (give back via ``_give_buf`` after
        the last read — see :class:`_ScratchPool`)."""
        return self._scratch.take(operand.dtype, n)

    def _give_buf(self, buf: np.ndarray) -> None:
        self._scratch.give(buf)

    # ------------------------------------------------------------------
    # pipelined chunked engine
    #
    # Each per-step segment splits into MP4J_CHUNK_BYTES chunks:
    # full-duplex exchange of chunk k, then merge of chunk k, repeated.
    # The double buffer is the KERNEL socket buffer: while we merge
    # chunk k, the peer's chunk k+1 is already streaming into our
    # receive buffer (and our own chunk k+1 drains from the send
    # buffer), so the wire transfer of k+1 overlaps the reduce of k
    # without any thread handoff — and the merge runs on cache-hot
    # bytes instead of re-reading the whole segment cold. Measured on
    # the bench host at MB-scale segments: ~1.6x over the monolithic
    # exchange; an explicit worker-thread double buffer was measured
    # SLOWER there (per-chunk future/GIL handoff beats the overlap on
    # a single core), hence the sequential loop.
    #
    # The chunk schedule is a pure function of the job-wide call
    # parameters (segment size, dtype, MP4J_CHUNK_BYTES) — never of
    # rank-local state (mp4j-lint R8) — so ranks always agree on it;
    # chunks merge in ascending offset order, which preserves the
    # unchunked per-element merge order bit-for-bit.
    # ------------------------------------------------------------------
    def _chunked_exchange(self, send_peer: int, recv_peer: int,
                          sarr: np.ndarray | None,
                          rarr: np.ndarray | None, on_chunk=None) -> None:
        """Raw full-duplex exchange in pipeline chunks; ``on_chunk(lo,
        hi)`` runs after ``rarr[lo:hi]`` has arrived, while the next
        chunk is in flight in the kernel buffers."""
        itemsize = (rarr if rarr is not None else sarr).dtype.itemsize
        n_send = 0 if sarr is None else sarr.size
        n_recv = 0 if rarr is None else rarr.size
        # bulk-transfer granularity evidence for the tuner's chunk
        # policy: the original segment sizes, which the
        # per-chunk wire bookings below cannot recover
        if sarr is not None:
            self._comm_stats.add_transfer(send_peer, sarr.nbytes)
        if rarr is not None and recv_peer != send_peer:
            self._comm_stats.add_transfer(recv_peer, rarr.nbytes)
        # per-link chunk size: each direction uses ITS
        # link's decided granularity — chunk boundaries are local on a
        # byte-stream transport, so asymmetric schedules cannot desync
        # (shm links always resolve to the job default, see _chunk_for)
        sch = tuning.chunk_ranges(n_send, itemsize,
                                  self._chunk_for(send_peer))
        rch = tuning.chunk_ranges(n_recv, itemsize,
                                  self._chunk_for(recv_peer))
        steps = max(len(sch), len(rch))
        if steps <= 1:
            self._exchange_raw(send_peer, recv_peer, sarr, rarr)
            if on_chunk is not None and n_recv:
                on_chunk(0, n_recv)
            return
        if sarr is not None:
            sarr = np.ascontiguousarray(sarr)
        for k in range(steps):
            sc = sarr[sch[k][0]:sch[k][1]] if k < len(sch) else None
            rc = rarr[rch[k][0]:rch[k][1]] if k < len(rch) else None
            self._exchange_raw(send_peer, recv_peer, sc, rc)
            if rc is not None and on_chunk is not None:
                on_chunk(*rch[k])

    def _reduce_into(self, operator: Operator, acc: np.ndarray,
                     src: np.ndarray) -> None:
        """``acc = op(acc, src)`` via the native kernel, booking
        reduce-phase time."""
        t0 = time.perf_counter()
        native.reduce_into(operator, acc, src)
        self._comm_stats.add("reduce_seconds", time.perf_counter() - t0)

    def _send_reduce_contrib(self, peer: int, chunk,
                             operand: Operand) -> None:
        """The send half that PAIRS with :meth:`_recv_reduce`: the
        receiver drains in ``MP4J_CHUNK_BYTES`` exchanges, so the raw
        sender must ship the same exchange schedule — on the shm plane
        the ring/carrier routing is a per-EXCHANGE size rule, and a
        monolithic send against a chunked receive deadlocks the moment
        a segment exceeds one chunk with a sub-``_RING_MIN`` tail (the
        tail rides the ring on one side and the carrier on the other).
        A pure function of the same job-wide sizes as the receiver's
        schedule, so both ends always agree (mp4j-lint R8
        discipline)."""
        if self._raw_ok(operand) and isinstance(chunk, np.ndarray):
            self._chunked_exchange(peer, peer, chunk, None)
        else:
            self._send_segment(peer, chunk, operand)

    def _recv_reduce(self, peer: int, acc: np.ndarray, operator: Operator,
                     operand: Operand) -> None:
        """Receive a segment the size of ``acc`` and merge it in,
        chunk-by-chunk (merge of chunk k overlaps the wire transfer of
        chunk k+1); raw or framed per the job-wide wire decision.
        Paired senders must use :meth:`_send_reduce_contrib` — the
        chunked exchange schedule is part of the wire contract on the
        shm plane (see there)."""
        rbuf = self._recv_buf(operand, acc.size)
        try:
            def merge(lo, hi):
                self._reduce_into(operator, acc[lo:hi], rbuf[lo:hi])

            if self._raw_ok(operand):
                self._chunked_exchange(peer, peer, None, rbuf,
                                       on_chunk=merge)
            else:
                self._fenced(peer).recv_array_into(rbuf, on_chunk=merge)
        finally:
            self._give_buf(rbuf)

    def _exchange_reduce(self, peer: int, send_view: np.ndarray,
                         acc: np.ndarray, operator: Operator,
                         operand: Operand) -> None:
        """Full-duplex partner exchange: ship ``send_view`` while
        receiving ``acc.size`` elements, merging arrivals into ``acc``
        chunk-by-chunk (the halving-round hot path)."""
        rbuf = self._recv_buf(operand, acc.size)
        try:
            def merge(lo, hi):
                self._reduce_into(operator, acc[lo:hi], rbuf[lo:hi])

            if self._raw_ok(operand):
                self._chunked_exchange(peer, peer, send_view, rbuf,
                                       on_chunk=merge)
            else:
                fut = self._submit_send(
                    peer, np.ascontiguousarray(send_view),
                    operand.compress)
                self._fenced(peer).recv_array_into(rbuf, on_chunk=merge)
                fut.result()
        finally:
            self._give_buf(rbuf)

    def _send_segment(self, peer: int, chunk, operand: Operand) -> None:
        """One-directional segment send for the tree/rooted collectives:
        raw when the job+operand allow, framed otherwise."""
        if self._raw_ok(operand):
            self._exchange_raw(peer, peer, chunk, None)
        else:
            self._send(peer, np.ascontiguousarray(chunk)
                       if isinstance(chunk, np.ndarray) else chunk,
                       compress=operand.compress)

    def _recv_segment_into(self, peer: int, arr, s: int, e: int,
                           operand: Operand) -> None:
        """Receive a segment directly into ``arr[s:e]`` — in place on
        the raw path AND the framed ndarray path (no temp buffer or
        copy); list containers assign through the container.

        The raw/framed decision must mirror :meth:`_send_segment`
        exactly — both are pure functions of ``_raw_ok(operand)`` — or
        sender and receiver would disagree on the wire format.
        """
        if self._raw_ok(operand):
            # check_array coerces numeric operands to ndarray; the raw
            # path is therefore always receivable in place.
            assert isinstance(arr, np.ndarray), \
                "numeric operand implies ndarray container (check_array)"
            self._exchange_raw_into(peer, peer, None, arr[s:e], operand)
        elif operand.is_numeric and isinstance(arr, np.ndarray):
            # framed numeric: stream the array frame straight into the
            # destination view (decompressing chunk-wise if compressed)
            view = arr[s:e]
            if view.flags.c_contiguous and view.flags.writeable:
                self._fenced(peer).recv_array_into(view)
            else:
                arr[s:e] = self._recv(peer)
        else:
            arr[s:e] = self._recv(peer)

    def _exchange_raw_into(self, send_peer: int, recv_peer: int,
                           sarr: np.ndarray | None, rview: np.ndarray,
                           operand: Operand) -> np.ndarray:
        """Raw exchange receiving into ``rview`` (via a pooled temp when
        the view is not directly receivable — contiguity is a LOCAL
        detail and must not influence the shared raw/framed decision)."""
        direct = rview.flags.c_contiguous and rview.flags.writeable
        if direct:
            self._exchange_raw(send_peer, recv_peer, sarr, rview)
            return rview
        rbuf = self._recv_buf(operand, rview.size)
        try:
            self._exchange_raw(send_peer, recv_peer, sarr, rbuf)
            rview[:] = rbuf
        finally:
            self._give_buf(rbuf)
        return rview

    # ------------------------------------------------------------------
    # dense-array helpers
    # ------------------------------------------------------------------
    @staticmethod
    def _merge(operator: Operator, operand: Operand, acc, src):
        """acc = op(acc, src), element-wise; native fast path for numeric."""
        if isinstance(acc, np.ndarray) and isinstance(src, np.ndarray):
            native.reduce_into(operator, acc, src)
            return acc
        return [operator.np_fn(a, b) for a, b in zip(acc, src)]

    def _norm_range(self, arr, operand: Operand, lo: int, hi: int | None):
        if operand.is_numeric:
            arr = operand.check_array(arr)
            if arr.ndim != 1:
                raise Mp4jError("socket path supports 1-D arrays")
        length = len(arr)
        if hi is None:
            hi = length
        if not (0 <= lo <= hi <= length):
            raise Mp4jError(f"range [{lo}, {hi}) out of bounds for {length}")
        return arr, lo, hi

    # ------------------------------------------------------------------
    # collectives: dense arrays
    # ------------------------------------------------------------------
    def allreduce_array(self, arr, operand: Operand = Operands.FLOAT,
                        operator: Operator = Operators.SUM,
                        from_: int = 0, to: int | None = None,
                        algo: str = "auto"):
        """Allreduce over ``arr[from_:to]``, in place on every rank.

        ``algo="auto"`` (default) picks by payload size — a pure
        function of the job-wide call parameters (bytes, rank count,
        ``MP4J_ALGO_*_BYTES`` thresholds), so every rank derives the
        same schedule: binomial ``"tree"`` (reduce+broadcast) for
        latency-bound small payloads, ``"rhd"`` for the middle,
        pipelined ``"ring"`` for bandwidth-bound large payloads.

        ``algo="rhd"`` (the reference's path): reduce-scatter by
        recursive halving + allgather by recursive doubling over the
        largest power-of-2 rank group, extra ranks folded in by a
        pre/post exchange. ``algo="ring"``: ring reduce-scatter + ring
        allgather. Both pipeline each step in ``MP4J_CHUNK_BYTES``
        chunks (merge of chunk k overlaps the wire transfer of k+1).

        Non-numeric (STRING/OBJECT list) operands take the rank-ordered
        binomial tree always: halving/ring merge order varies per
        segment, which is only equivalent for commutative operators;
        list reductions (e.g. concatenation) deserve deterministic rank
        order and are latency- not bandwidth-bound anyway.

        ``algo="twolevel"`` (what ``"auto"`` picks whenever
        the roster spans multiple hosts with co-located ranks): the
        classic topology-aware schedule — binomial reduce to each
        host's leader over the intra-host (shm) pairs, recursive
        halving/doubling among the leaders over TCP, binomial
        broadcast back out — so the inter-host wire carries each byte
        once per HOST instead of once per RANK.
        """
        if algo not in ("auto", "rhd", "ring", "tree", "twolevel"):
            raise Mp4jError(f"unknown allreduce algo {algo!r}")
        arr, lo, hi = self._norm_range(arr, operand, from_, to)
        if self._n == 1 or hi == lo:
            return arr
        if not operand.is_numeric:
            algo = "tree"
        elif algo == "auto":
            if self._use_twolevel():
                algo = "twolevel"
            else:
                algo = tuning.select_allreduce_algo(
                    (hi - lo) * operand.dtype.itemsize, self._n,
                    self._algo_small, self._algo_large)
        if algo == "twolevel":
            return self._twolevel_allreduce(arr, operand, operator,
                                            lo, hi)
        if algo == "tree":
            self.reduce_array(arr, operand, operator, root=0,
                              from_=from_, to=to)
            return self.broadcast_array(arr, operand, root=0,
                                        from_=from_, to=to)
        if algo == "rhd":
            return self._rhd_allreduce(arr, operand, operator, lo, hi)
        segs = meta.partition_range(lo, hi, self._n)
        self._ring_reduce_scatter(arr, segs, operand, operator)
        self._ring_allgather(arr, segs, operand)
        return arr

    # -- recursive halving/doubling (Rabenseifner), SURVEY.md 3b --------
    def _rhd_allreduce(self, arr, operand, operator, lo, hi,
                       group=None):
        """MPICH-style allreduce: fold extra ranks into the largest
        power-of-2 group, reduce-scatter by recursive halving, allgather
        by recursive doubling, unfold.

        Round structure (p = 2^floor(log2 n) participants):
        - fold: ranks >= p ship their whole range to ``rank - p``, which
          merges it; folded ranks then idle until unfold.
        - halving: log2(p) exchanges; each round partner = vr ^ dist with
          dist halving from p/2, exchanging half of the active segment
          window and merging the received half (native hot loop).
        - doubling: the mirror image; window doubles until every
          participant holds the full reduced range.
        - unfold: participants send the finished range back to their
          folded partner.

        ``group`` (a sorted rank subset containing this rank) runs the
        SAME schedule among just those ranks — the two-level engine's
        inter-host leg (one leader per host).
        """
        if group is None:
            n, r = self._n, self._rank
            gmap = range(n)
        else:
            n, r = len(group), group.index(self._rank)
            gmap = group
        raw = self._raw_ok(operand)
        p = 1
        while p * 2 <= n:
            p *= 2
        extra = n - p

        if r >= p:  # folded rank: contribute, then wait for the result
            fold = gmap[r - p]
            if raw:
                # chunked to mirror the fold partner's _recv_reduce
                # schedule (the shm routing contract — see
                # _send_reduce_contrib)
                self._chunked_exchange(fold, fold, arr[lo:hi], None)
                self._exchange_raw_into(fold, fold, None, arr[lo:hi],
                                        operand)
            else:
                self._send(fold, np.ascontiguousarray(arr[lo:hi]),
                           compress=operand.compress)
                self._recv_segment_into(fold, arr, lo, hi, operand)
            return arr
        if r < extra:  # fold partner: merge the extra rank's data
            self._recv_reduce(gmap[r + p], arr[lo:hi], operator, operand)

        vr = r
        segs = meta.partition_range(lo, hi, p)

        def span(a, b):  # byte range of segment window [a, b)
            return segs[a][0], segs[b - 1][1]

        # reduce-scatter: recursive halving (pipelined chunked merge)
        dist = p >> 1
        while dist >= 1:
            partner = gmap[vr ^ dist]
            block0 = (vr // (2 * dist)) * (2 * dist)
            if vr & dist:
                keep = (block0 + dist, block0 + 2 * dist)
                give = (block0, block0 + dist)
            else:
                keep = (block0, block0 + dist)
                give = (block0 + dist, block0 + 2 * dist)
            gs, ge = span(*give)
            ks, ke = span(*keep)
            self._exchange_reduce(partner, arr[gs:ge], arr[ks:ke],
                                  operator, operand)
            dist >>= 1

        # allgather: recursive doubling (no merge to overlap; the raw
        # exchange is already full-duplex and lands in place)
        dist = 1
        while dist < p:
            pv = vr ^ dist
            partner = gmap[pv]
            mb0 = (vr // dist) * dist
            tb0 = (pv // dist) * dist
            ms, me = span(mb0, mb0 + dist)
            ts, te = span(tb0, tb0 + dist)
            if raw:
                self._exchange_raw_into(partner, partner, arr[ms:me],
                                        arr[ts:te], operand)
            else:
                fut = self._submit_send(
                    partner, np.ascontiguousarray(arr[ms:me]),
                    operand.compress)
                self._recv_segment_into(partner, arr, ts, te, operand)
                fut.result()
            dist *= 2

        if r < extra:  # unfold: ship the finished range back
            if raw:
                self._exchange_raw(gmap[r + p], gmap[r + p], arr[lo:hi],
                                   None)
            else:
                self._send(gmap[r + p], np.ascontiguousarray(arr[lo:hi]),
                           compress=operand.compress)
        return arr

    # -- topology-aware two-level collectives -----------------
    # Group ranks by roster host fingerprint; run the intra-host legs
    # over the (shm) member pairs and ONE inter-host leg per host
    # leader over TCP. Every schedule below is a pure function of the
    # shared roster + call parameters (R1/R8 discipline). Numeric
    # operands only — the callers route non-numeric operands to the
    # rank-ordered tree before ever selecting these.
    def _use_twolevel(self) -> bool:
        return tuning.select_twolevel(
            [len(g) for g in self._host_groups])

    def _group_tree_reduce(self, acc, group, operand, operator,
                           root: int | None = None) -> None:
        """Binomial reduce of ``acc`` toward ``root`` (default: the
        group's smallest rank), merging IN PLACE into ``acc`` —
        callers pass either a buffer that will be overwritten anyway
        (allreduce) or an explicit scratch copy (reduce_scatter). The
        two-level legs pass the EFFECTIVE leader (a tuner
        demotion may root the walk at another member). One more
        client of THE shared binomial walk (see the map-plane
        comment): the merge mutates ``acc``, so the threaded value is
        just ``acc`` itself."""
        self._tree_reduce_walk(
            acc, group[0] if root is None else root,
            lambda peer, a: self._send_reduce_contrib(peer, a,
                                                      operand),
            lambda peer, a: (self._recv_reduce(peer, a, operator,
                                               operand), a)[1],
            group=group)

    def _group_tree_bcast(self, arr, lo, hi, group, operand,
                          root: int | None = None) -> None:
        """Binomial broadcast of the root's ``arr[lo:hi]`` to the
        group, received in place (the walk's threaded value is unused
        — receives land directly in ``arr[lo:hi]``). Root defaults to
        the group's smallest rank; the two-level legs pass the
        effective leader."""
        def recv(peer):
            self._recv_segment_into(peer, arr, lo, hi, operand)

        self._tree_bcast_walk(
            None, group[0] if root is None else root,
            lambda peer, _: self._send_segment(peer, arr[lo:hi],
                                               operand),
            recv, group=group)

    def _twolevel_allreduce(self, arr, operand, operator, lo, hi):
        """Intra-host reduce -> leaders' inter-host allreduce (RHD) ->
        intra-host broadcast. All three legs land in ``arr[lo:hi]``
        directly: allreduce overwrites the whole range on every rank,
        so no scratch copy is needed anywhere."""
        members, leaders = self._members, self._leaders
        if len(members) > 1:
            self._group_tree_reduce(arr[lo:hi], members, operand,
                                    operator, root=self._leader)
        if self._rank == self._leader and len(leaders) > 1:
            self._rhd_allreduce(arr, operand, operator, lo, hi,
                                group=leaders)
        if len(members) > 1:
            self._group_tree_bcast(arr, lo, hi, members, operand,
                                   root=self._leader)
        return arr

    def _twolevel_reduce_scatter(self, arr, ranges, operand, operator):
        """Intra-host reduce of the full span into a pooled scratch
        accumulator (the caller's positions outside each rank's owned
        range must stay untouched), leaders' inter-host allreduce,
        then the leader hands every member exactly its range. The
        scratch copy mirrors the tree path's reduce_array acc copy —
        same budget, but the heavy legs ride shm."""
        members, leaders = self._members, self._leaders
        acc = self._recv_buf(operand, len(arr))
        try:
            np.copyto(acc, arr)
            if len(members) > 1:
                self._group_tree_reduce(acc, members, operand, operator,
                                        root=self._leader)
            if self._rank == self._leader and len(leaders) > 1:
                self._rhd_allreduce(acc, operand, operator, 0, len(acc),
                                    group=leaders)
            if self._rank == self._leader:
                for m in members:
                    s, e = ranges[m]
                    if m == self._rank:
                        arr[s:e] = acc[s:e]
                    else:
                        self._send_segment(m, acc[s:e], operand)
            else:
                s, e = ranges[self._rank]
                self._recv_segment_into(self._leader, arr, s, e,
                                        operand)
        finally:
            self._give_buf(acc)
        return arr

    def _twolevel_allgather(self, arr, ranges, operand):
        """Intra-host gather to the leader, ring over HOST BLOCKS among
        the leaders (step s ships host block (h-s) right while host
        block (h-1-s) arrives from the left — each member range is one
        transfer, so the inter-host wire carries every byte exactly
        once per host), then intra-host broadcast of the tiled span.
        Caller guarantees the ranges tile contiguously (the same
        precondition the tree path enforces)."""
        members, leaders = self._members, self._leaders
        groups = self._host_groups
        if len(members) > 1:
            if self._rank == self._leader:
                for m in members:
                    if m != self._rank:
                        s, e = ranges[m]
                        self._recv_segment_into(m, arr, s, e, operand)
            else:
                s, e = ranges[self._rank]
                self._send_segment(self._leader, arr[s:e], operand)
        if self._rank == self._leader and len(leaders) > 1:
            raw = (self._raw_ok(operand)
                   and isinstance(arr, np.ndarray))
            H = len(leaders)
            h = leaders.index(self._rank)
            right, left = leaders[(h + 1) % H], leaders[(h - 1) % H]
            for step in range(H - 1):
                sblock = groups[(h - step) % H]
                rblock = groups[(h - 1 - step) % H]
                for i in range(max(len(sblock), len(rblock))):
                    sseg = ranges[sblock[i]] if i < len(sblock) else None
                    rseg = ranges[rblock[i]] if i < len(rblock) else None
                    sarr = (arr[sseg[0]:sseg[1]] if sseg is not None
                            else None)
                    if raw:
                        if rseg is not None:
                            self._exchange_raw_into(
                                right, left, sarr,
                                arr[rseg[0]:rseg[1]], operand)
                        elif sarr is not None:
                            self._exchange_raw(right, left, sarr, None)
                    else:
                        fut = (self._submit_send(
                            right, np.ascontiguousarray(sarr),
                            operand.compress)
                            if sarr is not None else None)
                        if rseg is not None:
                            self._recv_segment_into(left, arr, rseg[0],
                                                    rseg[1], operand)
                        if fut is not None:
                            fut.result()
        if len(members) > 1:
            lo, hi, _ = self._ranges_span(ranges)
            self._group_tree_bcast(arr, lo, hi, members, operand,
                                   root=self._leader)
        return arr

    @staticmethod
    def _ranges_span(ranges):
        """(lo, hi, contiguous): whether the per-rank ranges tile
        ``[lo, hi)`` without gaps — a pure function of the call's
        ``ranges`` argument, so every rank answers identically."""
        lo, hi = ranges[0][0], ranges[-1][1]
        contiguous = all(ranges[i][1] == ranges[i + 1][0]
                         for i in range(len(ranges) - 1))
        return lo, hi, contiguous

    def reduce_scatter_array(self, arr, operand: Operand = Operands.FLOAT,
                             operator: Operator = Operators.SUM,
                             ranges=None, algo: str = "auto"):
        """Rank r ends with segment ``ranges[r]`` of the reduction.

        ``algo="auto"`` (default): rank-ordered binomial tree
        (reduce + scatter) below the latency threshold, pipelined ring
        otherwise — the same job-wide size rule as allreduce; on a
        multi-host roster with co-located ranks it picks the two-level
        schedule instead (``"twolevel"``: intra-host reduce over shm,
        leaders' inter-host allreduce, leader scatters each member its
        range). ``"ring"`` / ``"tree"`` / ``"twolevel"``
        force a path; non-numeric operands always take the tree
        (deterministic rank order, see allreduce_array)."""
        if algo not in ("auto", "ring", "tree", "twolevel"):
            raise Mp4jError(f"unknown reduce_scatter algo {algo!r}")
        arr, lo, hi = self._norm_range(arr, operand, 0, None)
        if ranges is None:
            ranges = meta.partition_range(0, len(arr), self._n)
        if self._n == 1:
            return arr
        if not operand.is_numeric:
            algo = "tree"
        elif algo == "auto":
            if self._use_twolevel():
                algo = "twolevel"
            else:
                algo = tuning.select_partitioned_algo(
                    len(arr) * operand.dtype.itemsize, self._n,
                    self._algo_small, self._algo_large)
        if algo == "twolevel":
            return self._twolevel_reduce_scatter(arr, ranges, operand,
                                                 operator)
        if algo == "tree":
            # rank-ordered tree + scatter (see allreduce_array). Rank
            # 0's buffer is the tree root, so its positions OUTSIDE its
            # owned range must be restored afterwards — every backend
            # promises "other positions unchanged".
            orig = None
            if self._rank == 0:
                orig = (arr.copy() if isinstance(arr, np.ndarray)
                        else list(arr))
            self.reduce_array(arr, operand, operator, root=0)
            self.scatter_array(arr, operand, root=0, ranges=ranges)
            if self._rank == 0:
                s, e = ranges[0]
                arr[:s] = orig[:s]
                arr[e:] = orig[e:]
            return arr
        self._ring_reduce_scatter(arr, ranges, operand, operator)
        return arr

    def allgather_array(self, arr, operand: Operand = Operands.FLOAT,
                        ranges=None, algo: str = "auto"):
        """Each rank owns ``arr[ranges[rank]]``; all segments everywhere.

        ``algo="auto"`` (default): rooted binomial tree
        (gather + broadcast) below the latency threshold when the
        ranges tile a contiguous span, pipelined ring otherwise; on a
        multi-host roster with co-located ranks (and contiguous
        ranges) it picks ``"twolevel"`` — intra-host gather over shm,
        a leaders' ring over whole HOST blocks, intra-host broadcast. ``"tree"``/``"twolevel"`` require contiguous ranges
        (their broadcast covers the tiled span exactly); ``"ring"``
        accepts any ranges."""
        if algo not in ("auto", "ring", "tree", "twolevel"):
            raise Mp4jError(f"unknown allgather algo {algo!r}")
        arr, _, _ = self._norm_range(arr, operand, 0, None)
        if ranges is None:
            ranges = meta.partition_range(0, len(arr), self._n)
        if self._n == 1:
            return arr
        lo, hi, contiguous = self._ranges_span(ranges)
        if algo == "auto":
            if not contiguous or not operand.is_numeric:
                algo = "ring"
            elif self._use_twolevel():
                algo = "twolevel"
            else:
                algo = tuning.select_partitioned_algo(
                    (hi - lo) * operand.dtype.itemsize, self._n,
                    self._algo_small, self._algo_large)
        if algo == "twolevel" and not operand.is_numeric:
            # the two-level engine is numeric-only (it rides the raw
            # segment plane); the ring handles object operands
            algo = "ring"
        if algo == "twolevel":
            if not contiguous:
                raise Mp4jError(
                    "allgather algo='twolevel' needs contiguous ranges")
            return self._twolevel_allgather(arr, ranges, operand)
        if algo == "tree":
            if not contiguous:
                raise Mp4jError(
                    "allgather algo='tree' needs contiguous ranges")
            self.gather_array(arr, operand, root=0, ranges=ranges)
            return self.broadcast_array(arr, operand, root=0,
                                        from_=lo, to=hi)
        self._ring_allgather(arr, ranges, operand)
        return arr

    def _ring_reduce_scatter(self, arr, segs, operand, operator):
        """After n-1 ring steps, rank r holds segment r fully reduced.

        Step s: send segment (r-1-s) mod n (the one merged last step),
        receive segment (r-2-s) mod n from the left, merge with the
        local contribution — pipelined: the merge of chunk k runs while
        chunk k+1 is on the wire. Receive buffers rotate through the
        scratch pool (the carry stays live as next step's send source,
        so two pooled buffers alternate)."""
        n, r = self._n, self._rank
        numeric = isinstance(arr, np.ndarray)
        raw = self._raw_ok(operand) and numeric
        right, left = (r + 1) % n, (r - 1) % n
        carry = None       # accumulated segment in flight
        carry_buf = None   # pooled buffer backing the carry
        for s in range(n - 1):
            send_idx = (r - 1 - s) % n
            ss, se = segs[send_idx]
            out = carry if carry is not None else arr[ss:se]
            ri_s, ri_e = segs[(r - 2 - s) % n]
            local = arr[ri_s:ri_e]
            if numeric:
                rbuf = self._recv_buf(operand, ri_e - ri_s)

                def merge(a, b, rbuf=rbuf, local=local):
                    self._reduce_into(operator, rbuf[a:b], local[a:b])

                if raw:
                    self._chunked_exchange(right, left, out, rbuf,
                                           on_chunk=merge)
                else:
                    fut = self._submit_send(
                        right, np.ascontiguousarray(out),
                        operand.compress)
                    self._fenced(left).recv_array_into(rbuf,
                                                       on_chunk=merge)
                    fut.result()
                # the previous carry finished its last duty (this
                # step's send) — recycle its buffer
                if carry_buf is not None:
                    self._give_buf(carry_buf)
                carry = carry_buf = rbuf
            else:
                recv = self._sendrecv(right, left, out,
                                      compress=operand.compress)
                carry = [operator.np_fn(a, b)
                         for a, b in zip(recv, local)]
        # carry is now my fully-reduced segment (index r)
        ms, me = segs[r]
        arr[ms:me] = carry
        if carry_buf is not None:
            self._give_buf(carry_buf)
        return arr

    def _ring_allgather(self, arr, segs, operand: Operand):
        """After n-1 ring steps every rank holds all segments (no merge
        to overlap; raw exchanges are full-duplex and land in place,
        framed receives stream straight into the destination view)."""
        n, r = self._n, self._rank
        numeric = isinstance(arr, np.ndarray)
        raw = self._raw_ok(operand) and numeric
        right, left = (r + 1) % n, (r - 1) % n
        for s in range(n - 1):
            ss, se = segs[(r - s) % n]
            seg = arr[ss:se]
            rs, re = segs[(r - 1 - s) % n]
            if raw:
                self._exchange_raw_into(right, left, seg, arr[rs:re],
                                        operand)
            elif numeric and operand.is_numeric:
                fut = self._submit_send(
                    right, np.ascontiguousarray(seg),
                    operand.compress)
                self._recv_segment_into(left, arr, rs, re, operand)
                fut.result()
            else:
                recv = self._sendrecv(right, left, seg,
                                      compress=operand.compress)
                arr[rs:re] = recv
        return arr

    def reduce_array(self, arr, operand: Operand = Operands.FLOAT,
                     operator: Operator = Operators.SUM, root: int = 0,
                     from_: int = 0, to: int | None = None):
        """Binomial-tree reduce into ``root``'s buffer."""
        self._check_root(root)
        arr, lo, hi = self._norm_range(arr, operand, from_, to)
        if self._n == 1 or hi == lo:
            return arr
        vr = (self._rank - root) % self._n
        acc = arr[lo:hi]
        numeric = isinstance(acc, np.ndarray)
        if numeric:
            acc = acc.copy()
        else:
            # value-level copy (see _copy_value): the merge applies
            # the user operator to acc's elements, and an in-place op
            # must not reach the caller's objects — reduce_array is
            # _SNAPSHOT_FREE on the strength of this copy
            acc = [_copy_value(v) for v in acc]
        mask = 1
        while mask < self._n:
            if vr & mask:
                peer = ((vr - mask) + root) % self._n
                # the parent drains via _recv_reduce: chunk-matched
                # send (the shm routing contract)
                self._send_reduce_contrib(peer, acc, operand)
                break
            else:
                src_vr = vr + mask
                if src_vr < self._n:
                    peer = (src_vr + root) % self._n
                    if numeric:
                        # pipelined: merge chunk k while k+1 arrives
                        self._recv_reduce(peer, acc, operator, operand)
                    else:
                        recv = self._recv(peer)
                        acc = self._merge(operator, operand, acc, recv)
            mask <<= 1
        if self._rank == root:
            arr[lo:hi] = acc
        return arr

    def broadcast_array(self, arr, operand: Operand = Operands.FLOAT,
                        root: int = 0, from_: int = 0, to: int | None = None):
        """Binomial-tree broadcast of ``root``'s ``arr[from_:to]``."""
        self._check_root(root)
        arr, lo, hi = self._norm_range(arr, operand, from_, to)
        if self._n == 1 or hi == lo:
            return arr
        vr = (self._rank - root) % self._n
        mask = 1
        have = vr == 0
        while mask < self._n:
            if have:
                # every holder (vr < mask) sends to vr + mask this round
                dst_vr = vr + mask
                if dst_vr < self._n:
                    self._send_segment((dst_vr + root) % self._n,
                                       arr[lo:hi], operand)
            elif mask <= vr < 2 * mask:
                peer = ((vr - mask) + root) % self._n
                self._recv_segment_into(peer, arr, lo, hi, operand)
                have = True
            mask <<= 1
        return arr

    def gather_array(self, arr, operand: Operand = Operands.FLOAT,
                     root: int = 0, ranges=None):
        """Every rank's segment lands in ``root``'s buffer (direct sends)."""
        self._check_root(root)
        arr, _, _ = self._norm_range(arr, operand, 0, None)
        if ranges is None:
            ranges = meta.partition_range(0, len(arr), self._n)
        if self._n == 1:
            return arr
        if self._rank == root:
            for peer in range(self._n):
                if peer == root:
                    continue
                s, e = ranges[peer]
                self._recv_segment_into(peer, arr, s, e, operand)
        else:
            s, e = ranges[self._rank]
            self._send_segment(root, arr[s:e], operand)
        return arr

    def scatter_array(self, arr, operand: Operand = Operands.FLOAT,
                      root: int = 0, ranges=None):
        """Rank r receives segment ``ranges[r]`` of ``root``'s buffer."""
        self._check_root(root)
        arr, _, _ = self._norm_range(arr, operand, 0, None)
        if ranges is None:
            ranges = meta.partition_range(0, len(arr), self._n)
        if self._n == 1:
            return arr
        if self._rank == root:
            for peer in range(self._n):
                if peer == root:
                    continue
                s, e = ranges[peer]
                self._send_segment(peer, arr[s:e], operand)
        else:
            s, e = ranges[self._rank]
            self._recv_segment_into(root, arr, s, e, operand)
        return arr


    # ------------------------------------------------------------------
    # collectives: sparse maps (reference: *Map methods, SURVEY.md 3c)
    #
    # Two wire planes, selected per call:
    #
    # - COLUMNAR (default for numeric operands with ufunc operators):
    #   each map is encoded ONCE through the persistent
    #   comm.keycodec vocabulary into a (codes:int32,
    #   values:[n, *vshape]) pair and shipped as a paired framed-array
    #   unit (Channel.send_map_columns) — inheriting the framed plane's
    #   streaming compression, no-zero-fill receives and comm.stats()
    #   wire/serialize attribution — and merged with vectorized
    #   sorted-union + segment-reduce kernels (ops.sparse numpy twins)
    #   instead of a per-key Python loop. Vocabulary sync is part of
    #   the collective: novel keys ride a small pickled header exchange
    #   (near-empty once a gradient stream's vocabulary stabilizes) and
    #   every rank grows its codec with the same canonical key list, so
    #   code->key tables stay IDENTICAL job-wide — the invariant every
    #   later call's codes rely on. Columnar merges compute in the
    #   operand dtype (the declared operand is load-bearing, matching
    #   the device path's pack_values cast).
    # - PICKLED dicts (the Kryo analogue; the frozen reference wire
    #   under map_columnar=False): STRING/OBJECT operands, non-ufunc
    #   (object) operators, and any call whose negotiated header
    #   reports un-codec-able content on some rank (mixed/unsortable
    #   key kinds, ragged or object values). The negotiation makes the
    #   fallback a JOB-wIDE decision carried on the wire — ranks can
    #   never disagree about the plane of one exchange.
    #
    # (History: an earlier in-line note here measured a packed merge as
    # a LOSS at 20k-200k int keys — but that variant re-paid a full
    # per-call sorted-union + Python pack, exactly the work the
    # grow-only codec amortizes away. The honest re-run is bench.py's
    # socket_map_allreduce_sweep columnar-vs-pickle A/B, BENCH extra.)
    #
    # In-place semantics on every plane: the caller's dict is mutated.
    # ------------------------------------------------------------------
    @staticmethod
    def _merge_maps(operator: Operator, acc: dict, src: dict) -> dict:
        # the pickled plane's per-key merge loop (dict ops are C-level;
        # the columnar plane replaces this wholesale, see above)
        for k, v in src.items():
            if k in acc:
                acc[k] = operator.np_fn(acc[k], v)
            else:
                acc[k] = v
        return acc

    # -- the map planes' shared binomial-tree walks ---------------------
    # ONE copy of each walk, parameterized by the per-plane send/recv
    # callables: a protocol tweak (rank math, timeouts) lands on every
    # plane at once instead of needing six synchronized edits.
    def _walk_coords(self, root: int, group) -> tuple[int, int, list]:
        """(n, vr, rankmap) for a binomial walk over ``group`` (None =
        all ranks): ``vr`` is this rank's virtual index relative to
        ``root``; ``rankmap[v]`` the global rank at virtual index v.
        Group walks are the two-level engine's substrate:
        the SAME walk code serves the whole job, one host's members,
        or the host-leader set — the mapping is the only difference."""
        if group is None:
            n = self._n
            vr = (self._rank - root) % n
            return n, vr, [(v + root) % n for v in range(n)]
        n = len(group)
        ri = group.index(root)
        vr = (group.index(self._rank) - ri) % n
        return n, vr, [group[(v + ri) % n] for v in range(n)]

    def _tree_reduce_walk(self, value, root: int, send, recv_merge,
                          group=None):
        """Up-sweep: ``value`` merges toward ``root``. ``send(peer,
        value)`` ships this rank's merged value to its parent;
        ``recv_merge(peer, value) -> value`` receives a child's
        contribution and merges it in. Returns the full merge at
        ``root`` (a partial merge elsewhere). ``group`` restricts the
        walk to a rank subset (this rank and ``root`` must belong)."""
        n, vr, rankmap = self._walk_coords(root, group)
        mask = 1
        while mask < n:
            if vr & mask:
                send(rankmap[vr - mask], value)
                break
            src_vr = vr + mask
            if src_vr < n:
                value = recv_merge(rankmap[src_vr], value)
            mask <<= 1
        return value

    def _tree_bcast_walk(self, value, root: int, send, recv,
                         group=None):
        """Down-sweep: ``root``'s ``value`` reaches every rank (of
        ``group``, when given). ``recv(peer) -> value`` replaces the
        local value on first receipt; holders forward with
        ``send(peer, value)``."""
        n, vr, rankmap = self._walk_coords(root, group)
        mask = 1
        have = vr == 0
        while mask < n:
            if have:
                dst_vr = vr + mask
                if dst_vr < n:
                    send(rankmap[dst_vr], value)
            elif mask <= vr < 2 * mask:
                value = recv(rankmap[vr - mask])
                have = True
            mask <<= 1
        return value

    # -- columnar plane: negotiation / codec plumbing -------------------
    def _map_columnar_ok(self, operand: Operand,
                         operator: Operator | None = None) -> bool:
        """Whether this call may negotiate the columnar plane — a pure
        function of job-wide call parameters (operand, operator, the
        job's map_columnar flag), NEVER of rank-local map content: both
        ends of every exchange must agree whether a negotiation header
        travels at all (R4 discipline). Map-content problems are
        handled by the negotiation itself."""
        if not (self._map_columnar and operand.columnar_maps):
            return False
        if operator is None:
            return True
        # segment-reduce needs a real binary ufunc (reduceat); object
        # operators (plain Python callables) keep the pickled plane
        return isinstance(operator.np_fn, np.ufunc) and \
            operator.np_fn.nin == 2

    def _map_codec(self, kind: str):
        codec = self._map_codecs.get(kind)
        if codec is None:
            codec = self._map_codecs[kind] = keycodec.codec_for_kind(kind)
        return codec

    def _map_local_header(self, d: dict, operand: Operand):
        """``((ok, kind, vshape, novel), packed_values)`` for THIS
        rank's map. All local validation happens here, BEFORE any wire
        exchange, and its outcome rides the header: a bad map on one
        rank must divert EVERY rank to the pickled plane, not error on
        one side of an exchange (cf. distributed._union_device)."""
        if not d:
            return (True, None, None, []), None
        k0 = next(iter(d))
        kind = keycodec.kind_of(k0)
        codec = self._map_codec(kind)
        t0 = time.perf_counter()
        try:
            novel = codec.novel(d.keys(), len(d))
            vshape = tuple(np.shape(d[k0]))
            vals = keycodec.pack_values(d.values(), len(d), vshape,
                                        operand.dtype)
        except Mp4jError:
            return (False, kind, None, []), None
        self._comm_stats.add("serialize_seconds",
                             time.perf_counter() - t0)
        return (True, kind, vshape, novel), vals

    @staticmethod
    def _merge_map_headers(a, b):
        """Associative header merge for the sync up-sweep."""
        ok = a[0] and b[0]
        kind = a[1] if a[1] is not None else b[1]
        if a[1] is not None and b[1] is not None and a[1] != b[1]:
            ok = False
        vshape = a[2] if a[2] is not None else b[2]
        if a[2] is not None and b[2] is not None and a[2] != b[2]:
            ok = False
        novel = a[3] if not b[3] else list(dict.fromkeys(a[3] + b[3]))
        return (ok, kind, vshape, novel)

    @staticmethod
    def _map_decision(header):
        """Root's plane decision from the merged header: ``("col",
        kind, vshape, canonical_novel)``, ``("nop",)`` (every map
        empty), or ``("obj",)`` (negotiated pickle fallback). The
        canonical novelty order is sorted — the one growth order every
        rank can derive identically; an unsortable key mix cannot be
        canonicalized and falls back."""
        ok, kind, vshape, novel = header
        if not ok:
            return ("obj",)
        if kind is None:
            return ("nop",)
        try:
            canonical = sorted(novel)
        except TypeError:
            return ("obj",)
        return ("col", kind, vshape, canonical)

    def _map_bcast_obj(self, obj, root: int):
        """Binomial-tree broadcast of one small pickled object (the
        decision header)."""
        return self._tree_bcast_walk(obj, root, self._send, self._recv)

    def _map_sync(self, header, root: int):
        """Vocabulary-sync + plane-negotiation round: headers merge up
        the binomial tree to ``root``, the decision broadcasts back
        down, and on ``"col"`` every rank (including this one) grows
        its codec with the same canonical novelty — so every rank
        returns the same decision over identical code->key tables."""
        header = self._tree_reduce_walk(
            header, root, self._send,
            lambda peer, h: self._merge_map_headers(
                h, self._recv(peer)))
        decision = (self._map_decision(header)
                    if self._rank == root else None)
        decision = self._map_bcast_obj(decision, root)
        if decision[0] == "col":
            self._grow_map_codec(decision)
        return decision

    def _grow_map_codec(self, decision) -> None:
        _, kind, _vshape, canonical = decision
        if canonical:
            t0 = time.perf_counter()
            self._map_codec(kind).encode(canonical, len(canonical))
            self._comm_stats.add("serialize_seconds",
                                 time.perf_counter() - t0)

    # -- columnar plane: data movement ----------------------------------
    def _encode_map_columns(self, d: dict, decision, vals,
                            operand: Operand):
        """This rank's code-sorted (codes, values) columns. Every key
        is already in the vocabulary (the sync grew it), so encode is a
        pure vectorized lookup."""
        _, kind, vshape, _ = decision
        t0 = time.perf_counter()
        if not d:
            codes = np.empty(0, np.int32)
            vals = np.empty((0,) + tuple(vshape), operand.dtype)
        else:
            codes = self._map_codec(kind).encode(d.keys(), len(d))
        order = np.argsort(codes)
        cols = (codes[order], vals[order])
        self._comm_stats.add("serialize_seconds",
                             time.perf_counter() - t0)
        self._comm_stats.add("keys", int(codes.size))
        return cols

    def _decode_map_columns(self, decision, codes, vals) -> dict:
        t0 = time.perf_counter()
        out = dict(zip(self._map_codec(decision[1]).decode(codes),
                       list(vals)))
        self._comm_stats.add("serialize_seconds",
                             time.perf_counter() - t0)
        return out

    def _send_map_columns(self, peer: int, cols, operand: Operand):
        self._fenced(peer).send_map_columns(
            cols[0], cols[1],
            compress=self._compress_for(peer, operand.compress))

    def _recv_map_columns(self, peer: int):
        # peer channels carry peer_timeout from creation
        # mp4j-lint: disable=R2 (peer_timeout is set at channel creation)
        return self._fenced(peer).recv_map_columns()

    def _merge_map_columns(self, acc, src, operator: Operator):
        """Vectorized sorted-union merge, acc side first — the same
        ``op(acc[k], src[k])`` operand order as the dict loop, so the
        two planes agree bit-for-bit (ops.sparse contract)."""
        t0 = time.perf_counter()
        out = sparse_ops.np_merge_sorted_columns(
            acc[0], acc[1], src[0], src[1], operator.np_fn)
        self._comm_stats.add("reduce_seconds", time.perf_counter() - t0)
        return out

    def _reduce_map_columns(self, d: dict, vals, operand: Operand,
                            operator: Operator, root: int, decision,
                            group=None, cols=None):
        """Binomial-tree columnar reduce (over ``group`` when given);
        the returned columns are the full union at ``root`` (partial
        elsewhere). ``cols`` skips the encode for callers chaining
        walks over already-encoded columns (the two-level legs)."""
        if cols is None:
            cols = self._encode_map_columns(d, decision, vals, operand)
        return self._tree_reduce_walk(
            cols, root,
            lambda peer, acc: self._send_map_columns(peer, acc, operand),
            lambda peer, acc: self._merge_map_columns(
                acc, self._recv_map_columns(peer), operator),
            group=group)

    def _bcast_map_columns(self, cols, root: int, operand: Operand,
                           group=None):
        """Binomial-tree broadcast of ``root``'s columns (over
        ``group`` when given)."""
        return self._tree_bcast_walk(
            cols, root,
            lambda peer, c: self._send_map_columns(peer, c, operand),
            self._recv_map_columns, group=group)

    def _twolevel_allreduce_map_columns(self, d: dict, vals,
                                        operand: Operand,
                                        operator: Operator, decision):
        """Two-level columnar map allreduce: merge columns to
        each host leader over the intra-host (shm) pairs, tree-
        allreduce among the leaders over TCP, broadcast back out —
        same merge operand order as the flat walk (acc side first), so
        results are bit-identical for order-insensitive operator/value
        combinations and the inter-host wire carries each column set
        once per host."""
        members, leaders = self._members, self._leaders
        cols = self._encode_map_columns(d, decision, vals, operand)
        if len(members) > 1:
            cols = self._reduce_map_columns(
                d, vals, operand, operator, self._leader, decision,
                group=members, cols=cols)
        if self._rank == self._leader and len(leaders) > 1:
            cols = self._reduce_map_columns(
                d, vals, operand, operator, leaders[0], decision,
                group=leaders, cols=cols)
            cols = self._bcast_map_columns(cols, leaders[0], operand,
                                           group=leaders)
        if len(members) > 1:
            cols = self._bcast_map_columns(cols, self._leader, operand,
                                           group=members)
        return cols

    # -- pickled plane (the sanctioned fallback) ------------------------
    def _send_map_obj(self, peer: int, d, operand: Operand) -> None:
        """The ONE sanctioned pickled-map send: STRING/OBJECT operands,
        object operators, and negotiated fallbacks route here (README
        "Sparse map collectives"; mp4j-lint R9 baseline entry)."""
        self._send(peer, d, compress=operand.compress)

    def _reduce_map_obj(self, d: dict, operand: Operand,
                        operator: Operator, root: int) -> dict:
        # value-level copy, not dict(d): _merge_maps runs the user
        # operator directly on acc's value objects, and an in-place
        # op would otherwise mutate the caller's values mid-protocol —
        # reduce_map is _SNAPSHOT_FREE on the strength of this copy
        acc = self._tree_reduce_walk(
            {k: _copy_value(v) for k, v in d.items()}, root,
            lambda peer, a: self._send_map_obj(peer, a, operand),
            lambda peer, a: self._merge_maps(operator, a,
                                             self._recv(peer)))
        if self._rank == root:
            d.clear()
            d.update(acc)
        return d

    def _broadcast_map_obj(self, d: dict, operand: Operand,
                           root: int) -> dict:
        out = self._tree_bcast_walk(
            d, root,
            lambda peer, m: self._send_map_obj(peer, m, operand),
            self._recv)
        if out is not d:
            d.clear()
            d.update(out)
        return d

    def _gather_map_obj(self, d: dict, operand: Operand,
                        root: int) -> dict:
        if self._rank == root:
            owners = {k: root for k in d}
            for peer in range(self._n):
                if peer == root:
                    continue
                recv = self._recv(peer)
                for k, v in recv.items():
                    if k in d:
                        raise Mp4jError(
                            f"gather_map: duplicate key {k!r} owned by "
                            f"ranks {owners[k]} and {peer}; use "
                            f"reduce_map to combine")
                    d[k] = v
                    owners[k] = peer
        else:
            self._send_map_obj(root, d, operand)
        return d

    # -- the map collective family --------------------------------------
    def allreduce_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                      operator: Operator = Operators.SUM) -> dict:
        """Key-union reduce; every rank ends with the merged map. On
        the columnar plane the union stays in (codes, values) form end
        to end: one encode, log2(n) vectorized merges, one column
        broadcast, one decode."""
        if self._n == 1:
            return d
        if self._map_columnar_ok(operand, operator):
            header, vals = self._map_local_header(d, operand)
            decision = self._map_sync(header, 0)
            if decision[0] == "nop":
                return d
            if decision[0] == "col":
                if self._use_twolevel():
                    cols = self._twolevel_allreduce_map_columns(
                        d, vals, operand, operator, decision)
                else:
                    cols = self._reduce_map_columns(d, vals, operand,
                                                    operator, 0,
                                                    decision)
                    cols = self._bcast_map_columns(cols, 0, operand)
                merged = self._decode_map_columns(decision, *cols)
                d.clear()
                d.update(merged)
                return d
        self._reduce_map_obj(d, operand, operator, 0)
        return self._broadcast_map_obj(d, operand, 0)

    def reduce_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                   operator: Operator = Operators.SUM, root: int = 0) -> dict:
        """Binomial-tree key-wise merge into ``root``'s map."""
        self._check_root(root)
        if self._n == 1:
            return d
        if self._map_columnar_ok(operand, operator):
            header, vals = self._map_local_header(d, operand)
            decision = self._map_sync(header, root)
            if decision[0] == "nop":
                return d
            if decision[0] == "col":
                cols = self._reduce_map_columns(d, vals, operand,
                                                operator, root, decision)
                if self._rank == root:
                    merged = self._decode_map_columns(decision, *cols)
                    d.clear()
                    d.update(merged)
                return d
        return self._reduce_map_obj(d, operand, operator, root)

    def broadcast_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                      root: int = 0) -> dict:
        """Binomial-tree broadcast of ``root``'s map. Columnar: only
        root's keys matter, so the decision (with root's canonical
        novelty) rides the broadcast tree itself — no up-sweep."""
        self._check_root(root)
        if self._n == 1:
            return d
        if self._map_columnar_ok(operand):
            vals = None
            decision = None
            if self._rank == root:
                header, vals = self._map_local_header(d, operand)
                decision = self._map_decision(header)
            decision = self._map_bcast_obj(decision, root)
            if decision[0] == "nop":
                d.clear()      # root's map is empty; every copy is
                return d
            if decision[0] == "col":
                self._grow_map_codec(decision)
                cols = (self._encode_map_columns(d, decision, vals,
                                                 operand)
                        if self._rank == root else None)
                cols = self._bcast_map_columns(cols, root, operand)
                if self._rank != root:
                    d.clear()
                    d.update(self._decode_map_columns(decision, *cols))
                return d
        return self._broadcast_map_obj(d, operand, root)

    def gather_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                   root: int = 0) -> dict:
        """Disjoint union into ``root``'s map. A duplicate key raises
        an Mp4jError naming the key and BOTH owner ranks."""
        self._check_root(root)
        if self._n == 1:
            return d
        if self._map_columnar_ok(operand):
            header, vals = self._map_local_header(d, operand)
            if self._rank != root:
                self._send(root, header)
                decision = self._recv(root)
                if decision[0] == "col":
                    self._grow_map_codec(decision)
                    self._send_map_columns(
                        root,
                        self._encode_map_columns(d, decision, vals,
                                                 operand),
                        operand)
                    return d
                if decision[0] == "nop":
                    return d
            else:
                for peer in range(self._n):
                    if peer != root:
                        header = self._merge_map_headers(
                            header, self._recv(peer))
                decision = self._map_decision(header)
                for peer in range(self._n):
                    if peer != root:
                        self._send(peer, decision)
                if decision[0] == "nop":
                    return d
                if decision[0] == "col":
                    self._grow_map_codec(decision)
                    return self._gather_map_columns(d, decision,
                                                    operand, root)
        return self._gather_map_obj(d, operand, root)

    def _gather_map_columns(self, d: dict, decision, operand: Operand,
                            root: int) -> dict:
        """Root side of the columnar gather: collect every peer's
        columns, then ONE stable sort over (code, owner) and an
        adjacent-equality scan detects duplicates (naming the key and
        both owner ranks — concat order root-then-peers-ascending, so
        the pair reads in rank order). ``d`` is only mutated once the
        whole union is proven disjoint."""
        codec = self._map_codec(decision[1])
        own = (codec.encode(d.keys(), len(d)) if d
               else np.empty(0, np.int32))
        cols = [(own, None, root)]      # root's values stay in d
        for peer in range(self._n):
            if peer != root:
                rc, rv = self._recv_map_columns(peer)
                cols.append((rc, rv, peer))
        codes = np.concatenate([c for c, _, _ in cols])
        owners = np.concatenate([np.full(c.size, p, np.int32)
                                 for c, _, p in cols])
        order = np.argsort(codes, kind="stable")
        sc, so = codes[order], owners[order]
        dup = np.flatnonzero(sc[1:] == sc[:-1])
        if dup.size:
            i = int(dup[0])
            key = codec.decode(sc[i:i + 1])[0]
            raise Mp4jError(
                f"gather_map: duplicate key {key!r} owned by ranks "
                f"{int(so[i])} and {int(so[i + 1])}; use reduce_map "
                f"to combine")
        for rc, rv, _peer in cols[1:]:
            d.update(zip(codec.decode(rc), list(rv)))
        return d

    def allgather_map(self, d: dict, operand: Operand = Operands.DOUBLE) -> dict:
        """Disjoint union everywhere (gather to 0 + broadcast)."""
        self.gather_map(d, operand, root=0)
        return self.broadcast_map(d, operand, root=0)

    def scatter_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                    root: int = 0, partitioner=None) -> dict:
        """Rank r keeps the subset of ``root``'s entries whose keys hash
        to r (meta.key_partition — matches the device backends).

        ``partitioner(key) -> rank`` overrides the placement rule (the
        thread backend uses this to place by GLOBAL thread rank while
        shipping each process only its threads' share). The columnar
        plane's default placement rides the codec's cached per-code
        blake2b partition — the per-key hash is paid once per key ever,
        not once per call."""
        self._check_root(root)
        if self._n == 1:
            return d
        if self._map_columnar_ok(operand):
            return self._scatter_map_negotiated(d, operand, root,
                                                partitioner)
        return self._scatter_map_obj(d, operand, root, partitioner)

    def _scatter_map_negotiated(self, d: dict, operand: Operand,
                                root: int, partitioner) -> dict:
        """Scatter under the columnar gate: root decides the plane from
        its own map (only its keys travel) and prefixes every share
        with the decision; placement (and its validation) runs BEFORE
        any send so a bad partitioner raises without wedging peers
        mid-protocol."""
        if self._rank != root:
            decision = self._recv(root)
            if decision[0] == "col":
                self._grow_map_codec(decision)
                cols = self._recv_map_columns(root)
                d.clear()
                d.update(self._decode_map_columns(decision, *cols))
            elif decision[0] == "nop":
                d.clear()
            else:
                recv = self._recv(root)
                d.clear()
                d.update(recv)
            return d
        header, vals = self._map_local_header(d, operand)
        decision = self._map_decision(header)
        if decision[0] == "obj":
            for peer in range(self._n):
                if peer != root:
                    self._send(peer, decision)
            return self._scatter_map_obj(d, operand, root, partitioner,
                                         _negotiated=True)
        if decision[0] == "nop":
            for peer in range(self._n):
                if peer != root:
                    self._send(peer, decision)
            return d
        self._grow_map_codec(decision)
        codec = self._map_codec(decision[1])
        codes = (codec.encode(d.keys(), len(d)) if d
                 else np.empty(0, np.int32))
        if partitioner is None:
            part = codec.partition(codes, self._n)
        else:
            part = np.fromiter(
                (meta.check_partition_rank(partitioner(k), self._n, k)
                 for k in d.keys()), np.int32, len(d))
        for peer in range(self._n):
            if peer == root:
                continue
            self._send(peer, decision)
            m = part == peer
            self._send_map_columns(peer, (codes[m], vals[m]), operand)
        self._comm_stats.add("keys", int(codes.size))
        mine = part == root
        merged = self._decode_map_columns(decision, codes[mine],
                                          vals[mine])
        d.clear()
        d.update(merged)
        return d

    def _scatter_map_obj(self, d: dict, operand: Operand, root: int,
                         partitioner, _negotiated: bool = False) -> dict:
        if partitioner is None:
            partitioner = lambda k: meta.key_partition(k, self._n)  # noqa: E731
        if self._rank == root:
            shares: list[dict] = [{} for _ in range(self._n)]
            for k, v in d.items():
                shares[meta.check_partition_rank(
                    partitioner(k), self._n, k)][k] = v
            for peer in range(self._n):
                if peer != root:
                    self._send_map_obj(peer, shares[peer], operand)
            d.clear()
            d.update(shares[root])
        elif _negotiated:
            raise Mp4jError("scatter_map protocol error: non-root "
                            "reached the fallback sender")  # unreachable
        else:
            recv = self._recv(root)
            d.clear()
            d.update(recv)
        return d

    def reduce_scatter_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                           operator: Operator = Operators.SUM) -> dict:
        """Key-union reduce, then each rank keeps its hash share."""
        self.reduce_map(d, operand, operator, root=0)
        return self.scatter_map(d, operand, root=0)

    # ------------------------------------------------------------------
    # nonblocking collectives — see comm/progress.py
    #
    # Each i* method submits to the per-slave helper progression
    # thread and returns a CollectiveFuture; the blocking twin is
    # exactly i*(...).wait() in semantics AND bytes (the engine mirrors
    # the blocking schedules bit-for-bit; ineligible submissions
    # execute the blocking method itself on the progression thread).
    # Blocking collectives, barrier() and close() drain outstanding
    # futures first — comm.wait_all() is the explicit drain.
    # ------------------------------------------------------------------
    def _sched(self) -> progress_mod.ProgressScheduler:
        sched = self._async
        if sched is None:
            with self._async_lock:
                sched = self._async
                if sched is None:
                    sched = progress_mod.ProgressScheduler(self)
                    self._async = sched
        return sched

    def _iclassify(self, name: str, args: tuple, kwargs: dict) -> str:
        if name == "allreduce_map":
            # the multi (count-negotiating) protocol is a JOB-wide
            # choice: selected purely by the coalescing knob and the
            # call's operand/operator — never by rank-local queue depth
            if self._coalesce_usecs > 0 \
                    and self._map_columnar_ok(args[1], args[2]):
                return "map"
            return "inline"
        if name == "allreduce_array" and self._coalesce_usecs > 0 \
                and self._array_multi_ok(args, kwargs):
            # the dense small-array twin of the map plane:
            # same job-wide protocol-selection rule as "map" above
            return "array"
        if progress_mod.engine_eligible(self, name, args, kwargs):
            return "engine"
        return "inline"

    def _isubmit(self, name: str, args: tuple,
                 kwargs: dict) -> progress_mod.CollectiveFuture:
        if not self._async_on:
            # MP4J_ASYNC=0: eager caller-thread execution behind the
            # same future contract (the A/B + frozen-leg knob);
            # failures nobody awaits still surface at wait_all — the
            # drain's re-raise contract must not depend on the knob
            fut = progress_mod.CollectiveFuture(
                name, epoch=self._recovery.epoch)
            try:
                fut._resolve(getattr(self, name)(*args, **kwargs))
            except Exception as e:
                fut._fail(e)
                self._eager_failed.append(fut)
            return fut
        return self._sched().submit(name, args, kwargs,
                                    self._iclassify(name, args, kwargs))

    def iallreduce(self, arr, operand: Operand = Operands.FLOAT,
                   operator: Operator = Operators.SUM,
                   from_: int = 0, to: int | None = None,
                   algo: str = "auto") -> progress_mod.CollectiveFuture:
        """Nonblocking :meth:`allreduce_array`; ``.wait()`` returns the
        in-place reduced array."""
        return self._isubmit("allreduce_array", (arr, operand, operator),
                             {"from_": from_, "to": to, "algo": algo})

    def ireduce_scatter(self, arr, operand: Operand = Operands.FLOAT,
                        operator: Operator = Operators.SUM,
                        ranges=None, algo: str = "auto"
                        ) -> progress_mod.CollectiveFuture:
        """Nonblocking :meth:`reduce_scatter_array`."""
        return self._isubmit("reduce_scatter_array",
                             (arr, operand, operator),
                             {"ranges": ranges, "algo": algo})

    def iallgather(self, arr, operand: Operand = Operands.FLOAT,
                   ranges=None, algo: str = "auto"
                   ) -> progress_mod.CollectiveFuture:
        """Nonblocking :meth:`allgather_array`."""
        return self._isubmit("allgather_array", (arr, operand),
                             {"ranges": ranges, "algo": algo})

    def igather(self, arr, operand: Operand = Operands.FLOAT,
                root: int = 0, ranges=None
                ) -> progress_mod.CollectiveFuture:
        """Nonblocking :meth:`gather_array`."""
        return self._isubmit("gather_array", (arr, operand),
                             {"root": root, "ranges": ranges})

    def iallreduce_map(self, d: dict,
                       operand: Operand = Operands.DOUBLE,
                       operator: Operator = Operators.SUM
                       ) -> progress_mod.CollectiveFuture:
        """Nonblocking :meth:`allreduce_map`. Under
        ``MP4J_COALESCE_USECS > 0``, submissions arriving within the
        window fuse into one negotiation + columnar frame train
        (:meth:`allreduce_map_multi`) and de-fuse on completion."""
        return self._isubmit("allreduce_map", (d, operand, operator),
                             {})

    def wait_all(self, timeout: float | None = None) -> None:
        """The collective-boundary drain: block until every
        outstanding nonblocking collective resolved; re-raises the
        first failure among futures nobody awaited (eager-mode
        failures included — the contract must not depend on
        ``MP4J_ASYNC``)."""
        if self._async is not None:
            self._async.wait_all(timeout)
        while self._eager_failed:
            fut = self._eager_failed.pop(0)
            if not fut._observed:
                fut._observed = True
                raise fut._exc

    def outstanding(self) -> int:
        """How many nonblocking collectives are queued or in flight."""
        return (0 if self._async is None
                else self._async.outstanding())

    # -- the fused (coalesced) map collective ---------------------------
    @staticmethod
    def _merge_map_headers_multi(a, b):
        """Header merge for the count-negotiating sync: the classic
        4-field merge plus the fused-batch count, combined with MIN —
        the largest batch every rank can serve this round."""
        return ProcessCommSlave._merge_map_headers(
            a[:4], b[:4]) + (min(a[4], b[4]),)

    def _map_sync_multi(self, header, root: int):
        """Count-negotiating variant of :meth:`_map_sync` (map
        coalescing): the 5-field header ``(ok, kind, vshape, novel,
        count)`` merges up the tree, the root's decision gains the
        agreed batch size m = min(counts), and every rank grows its
        codec with the same canonical novelty. Novelty may cover maps
        beyond m (a deep coalescer offered more than the round
        serves): the growth is identical job-wide — harmless, and the
        next round's novelty exchange is near-empty for it."""
        header = self._tree_reduce_walk(
            header, root, self._send,
            lambda peer, h: self._merge_map_headers_multi(
                h, self._recv(peer)))
        decision = None
        if self._rank == root:
            decision = self._map_decision(header[:4]) + (header[4],)
        decision = self._map_bcast_obj(decision, root)
        if decision[0] == "col":
            self._grow_map_codec(decision[:-1])
        return decision

    def allreduce_map_multi(self, dicts: list,
                            operand: Operand = Operands.DOUBLE,
                            operator: Operator = Operators.SUM) -> int:
        """Fused key-union allreduce of SEVERAL maps under ONE
        vocabulary-sync negotiation (the small-message coalescing
        engine): each rank offers ``len(dicts)`` maps, the
        sync header negotiates the agreed batch ``m = min`` over every
        rank's offer, and the first ``m`` maps ship as ``m``
        back-to-back columnar frame pairs per tree exchange — one
        negotiation round trip amortized over the whole batch, merged
        per slot (same acc-first operand order as the classic plane,
        so each map's result is bit-identical to its own
        ``allreduce_map``). Returns ``m``; callers re-offer the
        remainder. In-place on every merged map; maps past ``m`` are
        untouched."""
        if not isinstance(dicts, list) or not dicts:
            raise Mp4jError(
                "allreduce_map_multi needs a non-empty list of dicts")
        if self._n == 1:
            return len(dicts)
        offered = len(dicts)
        vals: list = [None] * offered
        if self._map_columnar_ok(operand, operator):
            ok, kind, vshape, novel = True, None, None, []
            for i, d in enumerate(dicts):
                h, vals[i] = self._map_local_header(d, operand)
                ok, kind, vshape, novel = self._merge_map_headers(
                    (ok, kind, vshape, novel), h)
            header = (ok, kind, vshape, novel, offered)
        else:
            # non-columnar operand/operator: negotiate the count all
            # the same, fuse over the pickled plane
            header = (False, None, None, [], offered)
        decision = self._map_sync_multi(header, 0)
        m = int(decision[-1])
        if decision[0] == "nop":
            return m
        if decision[0] == "col":
            cdec = decision[:-1]
            # per-slot encode (books its own serialize time)
            cols = [self._encode_map_columns(dicts[i], cdec, vals[i],
                                             operand)
                    for i in range(m)]

            def send(peer, cs):
                for c in cs:
                    self._send_map_columns(peer, c, operand)

            def recv_merge(peer, cs):
                # recv slot i then merge slot i, in slot order — the
                # peer sends its m pairs back-to-back in the same order
                return [self._merge_map_columns(
                    cs[i], self._recv_map_columns(peer), operator)
                    for i in range(m)]

            cols = self._tree_reduce_walk(cols, 0, send, recv_merge)

            def recv(peer):
                return [self._recv_map_columns(peer)
                        for _ in range(m)]

            cols = self._tree_bcast_walk(cols, 0, send, recv)
            for i in range(m):
                merged = self._decode_map_columns(cdec, *cols[i])
                dicts[i].clear()
                dicts[i].update(merged)
            if m > 1:
                self._comm_stats.add("coalesced_frames", 1)
            return m
        # negotiated pickled fallback, still fused: a list-of-dicts
        # payload per tree exchange, merged per slot (value-level
        # copies keep the caller's objects out of the user operator —
        # the _SNAPSHOT_FREE discipline of reduce_map)
        acc = [{k: _copy_value(v) for k, v in dicts[i].items()}
               for i in range(m)]

        def send_obj(peer, a):
            self._send_map_obj(peer, a, operand)

        def recv_merge_obj(peer, a):
            r = self._recv(peer)
            for i in range(m):
                self._merge_maps(operator, a[i], r[i])
            return a

        acc = self._tree_reduce_walk(acc, 0, send_obj, recv_merge_obj)
        acc = self._tree_bcast_walk(acc, 0, send_obj, self._recv)
        for i in range(m):
            dicts[i].clear()
            dicts[i].update(acc[i])
        if m > 1:
            self._comm_stats.add("coalesced_frames", 1)
        return m

    # -- the fused (coalesced) ARRAY collective --------------
    @staticmethod
    def _merge_array_headers_multi(a, b):
        """Header merge for the array-plane count negotiation:
        ``(count, lengths, bad)`` — the agreed batch is the MIN count,
        and the per-slot lengths must agree over that prefix (ragged
        COUNTS are the protocol's whole point; ragged LENGTHS are a
        caller error surfaced job-wide)."""
        m = min(a[0], b[0])
        if a[1][:m] != b[1][:m]:
            return (m, a[1][:m], True)
        return (m, a[1][:m], a[2] or b[2])

    def _array_sync_multi(self, header, root: int):
        """Count-negotiating sync for :meth:`allreduce_array_multi`:
        the 3-field header merges up the binomial tree and the root's
        decision (agreed batch size m, or the length-mismatch error)
        broadcasts back — one small-object round trip amortized over
        the whole fused batch, exactly :meth:`_map_sync_multi`'s
        shape."""
        header = self._tree_reduce_walk(
            header, root, self._send,
            lambda peer, h: self._merge_array_headers_multi(
                h, self._recv(peer)))
        decision = header if self._rank == root else None
        return self._map_bcast_obj(decision, root)

    def allreduce_array_multi(self, arrs: list,
                              operand: Operand = Operands.FLOAT,
                              operator: Operator = Operators.SUM) -> int:
        """Fused allreduce of SEVERAL small dense arrays under ONE
        count negotiation (the map-coalescing engine ported
        to the array plane): each rank offers
        ``len(arrs)`` arrays, the sync negotiates the agreed batch
        ``m = min`` over every rank's offer, and the first ``m``
        arrays ship concatenated as ONE tree reduce + broadcast — the
        per-collective fixed cost (two tree walks of small frames,
        their syscalls and scheduler wakeups) amortizes across the
        batch.

        The fused exchange is pinned to the TREE schedule: each fused
        element's reduction association is the binomial-tree rank
        order regardless of array boundaries, which is exactly the
        schedule ``algo="auto"`` resolves for these arrays one at a
        time (small payloads -> "tree"), so every array's result is
        bit-identical to its own ``allreduce_array``. Returns ``m``;
        callers re-offer the remainder. In place on every merged
        array; arrays past ``m`` are untouched."""
        if not isinstance(arrs, list) or not arrs:
            raise Mp4jError(
                "allreduce_array_multi needs a non-empty list of arrays")
        if not operand.is_numeric:
            raise Mp4jError(
                "allreduce_array_multi is numeric-only (the dense "
                "small-array plane)")
        for a in arrs:
            if not (isinstance(a, np.ndarray) and a.ndim == 1
                    and a.flags.c_contiguous
                    and a.dtype == operand.dtype):
                raise Mp4jError(
                    "allreduce_array_multi needs 1-D contiguous "
                    f"arrays of dtype {operand.dtype}, got "
                    f"{type(a).__name__}"
                    + (f" {a.dtype} shape {a.shape}"
                       if isinstance(a, np.ndarray) else ""))
        if self._n == 1:
            return len(arrs)
        header = (len(arrs), tuple(int(a.size) for a in arrs), False)
        decision = self._array_sync_multi(header, 0)
        m, lengths, bad = decision
        if bad:
            raise Mp4jError(
                "allreduce_array_multi: ranks disagree on the fused "
                "arrays' lengths over the negotiated batch — every "
                "rank must offer identically-shaped slots")
        total = int(sum(lengths))
        if total:
            # one scratch buffer, one tree walk: the merge runs in
            # reduce_array's internal copy, the callers' arrays are
            # only READ until the final local scatter — snapshot-free
            # by the broadcast_map reasoning (_SNAPSHOT_FREE)
            scratch = np.empty(total, operand.dtype)
            off = 0
            for i in range(m):
                scratch[off:off + lengths[i]] = arrs[i]
                off += lengths[i]
            self.reduce_array(scratch, operand, operator, root=0)
            self.broadcast_array(scratch, operand, root=0)
            off = 0
            for i in range(m):
                arrs[i][:] = scratch[off:off + lengths[i]]
                off += lengths[i]
        if m > 1:
            self._comm_stats.add("coalesced_frames", 1)
            self._comm_stats.add("coalesced_elems", total)
        return m

    def _array_multi_ok(self, args: tuple, kwargs: dict) -> bool:
        """Whether an ``iallreduce`` submission may ride the fused
        array plane. A JOB-wide pure function of the call parameters
        (dtype/shape/size/knobs) — never of rank-local queue depth —
        so every rank classifies the same call sequence identically
        (the negotiated count then absorbs ragged coalescing depth)."""
        arr, operand = args[0], args[1]
        if not (isinstance(arr, np.ndarray) and arr.ndim == 1
                and arr.flags.c_contiguous
                and operand.is_numeric
                and arr.dtype == operand.dtype):
            return False
        if kwargs.get("from_", 0) != 0 or kwargs.get("to") is not None \
                or kwargs.get("algo", "auto") != "auto":
            return False
        if self._n <= 1 or self._use_twolevel():
            return False
        # only arrays whose auto schedule IS the tree (small payloads,
        # n >= 3): the fused walk is pinned to tree, and fused ==
        # sequential bit-exactness needs the blocking twin on the same
        # schedule
        return tuning.select_allreduce_algo(
            arr.nbytes, self._n, self._algo_small,
            self._algo_large) == "tree"

    # ------------------------------------------------------------------
    def _check_root(self, root: int):
        if not (0 <= root < self._n):
            raise Mp4jError(f"root {root} out of range [0, {self._n})")


# ----------------------------------------------------------------------
# epoch-fenced recovery wrapper (resilience.recovery)
#
# Installed UNDER trace.traced: a recovered retry stays inside the one
# traced/stats scope of its collective call (the wire cost of failed
# attempts books into the same bucket), and the DIAGNOSE hook fires
# only when recovery is exhausted — a successfully recovered fault
# never spams the master.
# ----------------------------------------------------------------------
# Collectives that are retry-idempotent WITHOUT an input snapshot —
# they never mutate the caller's buffer before their last wire
# operation, or mutate it only with pure overwrites a retry reproduces
# byte-for-byte:
#   broadcast/gather/scatter/allgather_array: receivers overwrite
#     segments with data the retry re-ships identically; senders read
#     intact data.
#   reduce_array / reduce_map: the merge runs in an internal copy; the
#     root writes back after its last receive, with no I/O after.
#   broadcast_map / scatter_map: d is rebuilt only after the walk (or
#     after the last share is sent) — no mid-protocol mutation.
# Everything else (allreduce: in-place halving merges; reduce_scatter:
# composed root mutation; gather/allgather/reduce_scatter_map: root's
# dict grows between receives) snapshots its input so a retry starts
# from the caller's original bytes. Keeping this set tight is a PERF
# decision: the snapshot memcpy is the resilience layer's only
# steady-state cost (bench.py socket_recovery steady_state).
_SNAPSHOT_FREE = frozenset({
    "broadcast_array", "gather_array", "scatter_array",
    "allgather_array", "reduce_array", "reduce_map", "broadcast_map",
    "scatter_map",
    # the fused map batch: merges run in internal column/
    # value copies; the caller's dicts mutate only after the last wire
    # operation of the walk — the broadcast_map reasoning, per slot
    "allreduce_map_multi",
    # the fused array batch: the tree walk runs on an
    # internal scratch concat; the callers' arrays are only read until
    # the final local scatter — same reasoning, per slot
    "allreduce_array_multi",
})

# Root-only mutators: every non-root rank only SENDS (both planes of
# gather_map go direct-to-root, no tree relay), so its payload is
# never touched and the retry snapshot copy is pure waste there. The
# map codec-size pin still applies on every rank.
_SNAPSHOT_ROOT_ONLY = frozenset({"gather_map"})


# immutable value types a container snapshot can share by reference
_IMMUTABLE_VALUES = (np.generic, int, float, complex, bool, str, bytes,
                     type(None))


def _copy_value(v):
    """Per-element snapshot copy for dict/list payloads. The dict-plane
    merge runs ``op(acc, src)`` directly on the caller's value objects,
    and a user operator may mutate ``acc`` in place — a shared
    reference would make the retry start from already-merged values.
    Immutables (the whole columnar numeric plane) stay zero-copy."""
    if isinstance(v, _IMMUTABLE_VALUES):
        return v
    if isinstance(v, np.ndarray):
        return v.copy()
    return copy.deepcopy(v)


def _preserve_payload(self, x):
    """Snapshot a collective's mutable input for retry idempotence.
    ndarray snapshots ride the slave's scratch pool — a fresh
    ``x.copy()`` per call would re-pay mmap + first-touch page faults
    for every MB, the exact cost the pool exists to amortize."""
    if isinstance(x, np.ndarray) and x.ndim == 1 and not x.dtype.hasobject:
        buf = self._scratch.take(x.dtype, x.size)
        np.copyto(buf, x)
        return buf
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: _copy_value(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_copy_value(v) for v in x]
    return None


def _restore_payload(x, saved) -> None:
    """Put the snapshot back before a retry. Mutable container values
    are re-copied on EVERY restore so ``saved`` stays pristine — a
    second recovery round must not see the first retry's mutations.
    Dict elements of a list payload (the fused map batch)
    restore IN PLACE: the caller (the scheduler's futures) holds
    references to those exact dict objects."""
    if saved is None:
        return
    if isinstance(x, np.ndarray):
        x[:] = saved
    elif isinstance(x, dict):
        x.clear()
        x.update((k, _copy_value(v)) for k, v in saved.items())
    elif isinstance(x, list):
        for i, v in enumerate(saved):
            if isinstance(v, dict) and isinstance(x[i], dict):
                _restore_payload(x[i], v)
            else:
                x[i] = _copy_value(v)


def _recovered(fn, snapshot: bool):
    """Wrap a collective method with the abort/retry engine (outermost
    frame only — composed collectives recover as one unit) and
    with the audit plane's per-collective digest record: the
    input digests at entry (before any wire byte moves), the output at
    return, and every retry's restored snapshot is digest-compared
    against the original attempt's input — the snapshot-corruption
    class once fixed by hand is machine-checked here."""
    import inspect

    sig = inspect.signature(fn)
    params = list(sig.parameters)
    payload_name = params[1] if len(params) > 1 else None
    root_skip = None    # (index of root in *args, its default)
    if fn.__name__ in _SNAPSHOT_ROOT_ONLY and "root" in params:
        root_skip = (params.index("root") - 1,
                     sig.parameters["root"].default)
    # audit metadata extraction (replay needs operand/operator/root
    # by NAME): arg position + default per interesting param, plus the
    # length of the leading (payload, operand/operator/root...) run —
    # positional args past it (ranges, from_) mark the record
    # non-replayable rather than replaying a different call
    aud_params = {}
    for _nm in ("operand", "operator", "root", "algo"):
        if _nm in params:
            aud_params[_nm] = (params.index(_nm) - 1,
                               sig.parameters[_nm].default)
    lead = 1
    for _p in params[2:]:
        if _p in ("operand", "operator", "root"):
            lead += 1
        else:
            break
    _STD_KW = frozenset({"operand", "operator", "root", "algo",
                         payload_name})
    _defaults = {p: sig.parameters[p].default for p in params[1:]}

    def _aud_meta(args, kwargs) -> dict:
        def pick(nm):
            if nm not in aud_params:
                return None
            i, dflt = aud_params[nm]
            return args[i] if len(args) > i else kwargs.get(nm, dflt)

        meta: dict = {}
        operand = pick("operand")
        if operand is not None:
            meta["operand"] = operand.name
        operator = pick("operator")
        if operator is not None:
            meta["operator"] = operator.name
        if "root" in aud_params:
            meta["root"] = int(pick("root"))
        nonstd_kw = any(kwargs[k] is not _defaults.get(k, None)
                        and kwargs[k] != _defaults.get(k, None)
                        for k in set(kwargs) - _STD_KW)
        if len(args) > lead or nonstd_kw:
            meta["nonstd"] = True
        return meta

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        rec = getattr(self, "_recovery", None)
        if rec is None:
            return fn(self, *args, **kwargs)
        # collective-boundary drain: a blocking collective
        # entered while nonblocking futures are outstanding waits them
        # out first, so the job-wide collective order stays the submit
        # order (no-op on the progression thread itself — inline
        # execution runs the blocking methods there)
        sched = getattr(self, "_async", None)
        if sched is not None:
            sched.drain_for_blocking()
        outermost = rec.enter()
        try:
            if not outermost:
                return fn(self, *args, **kwargs)
            # tuner boundary application: pending per-link
            # decisions (and the audit-trip revert) land HERE, before
            # any wire byte of this collective moves — decisions never
            # change mid-collective. One attribute check when idle.
            tun = self._tuner
            if tun is not None and tun.dirty:
                self._tuner_apply(tun)
            ordinal = self._progress_state[0] + 1
            self._progress_state = (ordinal, True)
            if self._faults is not None:
                # retried attempts keep the first attempt's ordinal
                # (on_collective runs once per CALL), so a one-shot
                # fault cannot re-fire into its own recovery
                self._faults.on_collective(ordinal, self._fault_kill)
            # the audit payload is extracted unconditionally (digest
            # records cover every collective); the SNAPSHOT payload
            # below keeps its own tighter rules
            payload_a = args[0] if args else kwargs.get(payload_name)
            audit = self._audit
            arec = None
            if audit is not None:
                arec = audit.begin(ordinal, fn.__name__, payload_a,
                                   _aud_meta(args, kwargs))
            payload = None
            if snapshot:
                # by position OR keyword: a kwarg call must not skip
                # the snapshot and silently retry on mutated input
                payload = payload_a
                if root_skip is not None:
                    ri, rdefault = root_skip
                    root = (args[ri] if len(args) > ri
                            else kwargs.get("root", rdefault))
                    if root != self._rank:
                        payload = None   # see _SNAPSHOT_ROOT_ONLY
            is_map = (fn.__name__.endswith("_map")
                      or fn.__name__ == "allreduce_map_multi")
            saved_box = []

            def preserve():
                saved = _preserve_payload(self, payload)
                # map collectives also pin the key-codec sizes: a torn
                # decision broadcast can leave the vocabulary grown on
                # SOME ranks only, and a retry negotiating novelty
                # against half-grown codecs would desync code tables
                # job-wide — truncating back to the (identical)
                # pre-attempt sizes restores the invariant
                sizes = ({k: c.size for k, c in self._map_codecs.items()}
                         if is_map else None)
                # published for the adoption manifest: a
                # replacement round's vocabulary export must ship the
                # pre-attempt state every survivor rolls back to, not
                # this attempt's tentative growth
                self._codec_pin = sizes
                saved_box.append(saved)
                return (saved, sizes)

            def restore(pair):
                saved, sizes = pair
                if sizes is not None:
                    for k, c in self._map_codecs.items():
                        c.truncate(sizes.get(k, 0))
                _restore_payload(payload, saved)
                if arec is None:
                    return
                # failed attempt's wire folds died in the drain on the
                # peer side too — carrying them into the record would
                # false-diverge every recovered seq
                audit.reset_wire()
                if payload is not None and saved is not None:
                    # the machine check for the snapshot-corruption
                    # class: the restored input must digest exactly as
                    # the original attempt's input did — anything else
                    # means the snapshot was mutated (shared mutable
                    # values, a buggy operator) and a retry would
                    # produce silently wrong 'recovered' results
                    h, _sig = audit_mod.digest_payload(payload)
                    if h != arec["in"]:
                        raise Mp4jError(
                            f"audit: restored retry snapshot of "
                            f"'{fn.__name__}' (collective #{ordinal}) "
                            f"digests {h:#018x}, original input was "
                            f"{arec['in']:#018x} — the snapshot was "
                            "corrupted (in-place operator mutating "
                            "shared values?); refusing to retry from "
                            "tainted input")

            try:
                try:
                    out = rec.run(
                        fn.__name__,
                        lambda: fn(self, *args, **kwargs),
                        preserve, restore)
                except BaseException as e:
                    if arec is not None:
                        audit.abandon(arec, e)
                    raise
                if arec is not None:
                    audit.commit(arec, payload_a)
                return out
            finally:
                self._progress_state = (ordinal, False)
                self._codec_pin = None
                # pooled snapshot buffers go back for the next call
                if saved_box and isinstance(saved_box[0], np.ndarray) \
                        and saved_box[0].base is not None:
                    self._give_buf(saved_box[0])
        finally:
            rec.exit()

    return wrapper


_RECOVERED_METHODS = tuple(
    m for m in trace.COLLECTIVE_METHODS if m != "barrier")
# barrier is excluded: it rides the control plane only — its failure
# modes ARE the recovery machinery's failure modes (dead master, dead
# rank), both already terminal.
for _name in _RECOVERED_METHODS:
    _fn = ProcessCommSlave.__dict__.get(_name)
    if _fn is not None and callable(_fn):
        setattr(ProcessCommSlave, _name,
                _recovered(_fn, snapshot=_name not in _SNAPSHOT_FREE))

# per-collective tracing (utils.trace; zero overhead when disabled) —
# wraps OUTSIDE the recovery layer (see comment above)
trace.instrument(ProcessCommSlave)
