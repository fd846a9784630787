"""Transport tuning knobs + size-aware collective algorithm selection.

A copy of ``ytk_mp4j_tpu/utils/tuning.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

Everything in this module is a PURE FUNCTION of job-wide call
parameters (payload size, rank count, env-configured thresholds) —
mp4j-lint R1/R8 territory: two ranks evaluating the same collective
call must derive the identical algorithm and chunk schedule, or they
would disagree about the wire protocol and deadlock. The env knobs are
therefore JOB-wide configuration: every rank of a job must run with the
same values (exactly like ``native_transport``).

Knobs (all validated where they are consumed; garbage raises
``Mp4jError`` at slave/channel setup, not mid-collective):

- ``MP4J_CHUNK_BYTES`` — pipeline chunk size for the chunked
  collective engine (default 1 MiB, measured on the bench host: the
  scratch-buffer pool already keeps receive pages warm, so sub-MiB
  chunks pay per-exchange poll/syscall overhead without buying more
  cache locality; 1 MiB leaves typical segments monolithic while
  bounding the merge granularity of multi-MB segments and sizing the
  streaming-compression pieces).
- ``MP4J_ALGO_SMALL_BYTES`` / ``MP4J_ALGO_LARGE_BYTES`` — the
  ``algo="auto"`` thresholds: payloads <= small take the binomial tree
  (latency-bound regime), payloads >= large take the pipelined ring
  (bandwidth-bound regime), in between recursive halving/doubling.
  Defaults are grounded in ``bench.py``'s ``socket_allreduce_sweep``
  (see BENCH JSON ``extra``).
- ``MP4J_SO_SNDBUF`` / ``MP4J_SO_RCVBUF`` — socket buffer sizes applied
  at channel setup (``transport/tcp.py``); unset keeps the kernel
  defaults.
- ``MP4J_SHM`` — the intra-host shared-memory transport
  (``transport/shm.py``): ``1`` (default) lets rendezvous negotiate a
  shm ring pair for every SAME-host peer pair (host fingerprints
  compared from the roster; cross-host pairs always keep TCP); ``0``
  forces TCP everywhere. JOB-wide like ``native_transport`` — the
  handshake carries the decision, but every rank must agree on whether
  to offer it.
- ``MP4J_SHM_RING_BYTES`` — bytes per DIRECTION of each shm peer
  pair's ring buffer (default 1 MiB, matching ``MP4J_CHUNK_BYTES`` so
  a pipeline chunk fits the ring in one pass). The
  rings carry BOTH planes: raw-plane transfers clearing
  ``SHM_RING_MIN_BYTES`` and framed/columnar-map payloads clearing
  ``MP4J_SHM_FRAME_MIN`` (the header-derived frame routing below) —
  not just the raw plane.
- ``MP4J_SHM_FRAME_MIN`` — frame-level ring routing threshold: a FRAMED payload (array frames, object frames,
  columnar-map columns, streamed-compression pieces) whose byte
  length — already known to both ends from the frame header / chunk
  length prefix — clears this value rides the shm ring instead of
  the TCP carrier. ``0`` disables frame routing (every framed byte
  keeps the carrier — the carrier-only wire layout). JOB-wide like
  ``native_transport``: the threshold IS the wire protocol for shm
  pairs, so every rank must agree.
- ``MP4J_HEARTBEAT_SECS`` — period of the slave->master telemetry
  heartbeat (``comm/process_comm.py``); ``0`` disables heartbeats.
- ``MP4J_SPAN_RING`` — capacity of the in-process span ring buffer
  (``obs/spans.py``); ``0`` disables span recording.
- ``MP4J_LOG_LEVEL`` — minimum level the master's log sink prints
  (``DEBUG``/``INFO``/``WARN``/``ERROR``).
- ``MP4J_MAP_COLUMNAR`` — socket map-collective wire plane: ``1``
  (default) ships numeric-operand maps as (codes, values) columns
  through the persistent key codec; ``0`` forces the pickled-dict
  reference path (``comm/process_comm.py``; README "Sparse map
  collectives").
- ``MP4J_MAX_RETRIES`` — how many epoch-fenced abort/retry rounds a
  failed collective may attempt before the job aborts terminally
  (``resilience/recovery.py``); ``0`` restores the reference's
  fail-stop behavior (first transport error is final).
- ``MP4J_RECONNECT_BACKOFF`` — base seconds of the capped exponential
  backoff used when re-dialing a dead peer channel during recovery.
- ``MP4J_DEAD_RANK_SECS`` — how stale a rank may go (no abort ack, no
  barrier arrival) before the master declares it dead and fans out a
  terminal abort (``comm/master.py``).
- ``MP4J_FAULT_PLAN`` — deterministic fault-injection plan for chaos
  testing (``resilience/faults.py``; empty disables injection).
- ``MP4J_METRICS`` — the live metrics plane (``obs/metrics.py``): ``1``
  (default) records latency/frame-size histograms and ships metric
  deltas on the heartbeat; ``0`` turns recording into a no-op (the
  bench A/B knob).
- ``MP4J_METRICS_PORT`` — the master's control-plane HTTP metrics
  endpoint (``comm/master.py``): unset/empty disables it, ``0`` binds
  an ephemeral port (``Master.metrics_port`` reports it), anything
  else binds that port.
- ``MP4J_METRICS_WINDOW_SECS`` — the sliding window the master derives
  rates (GB/s, collectives/s, keys/s) over from its ring of interval
  snapshots.
- ``MP4J_POSTMORTEM_DIR`` — flight-recorder directory
  (``obs/postmortem.py``): on any terminal abort every rank dumps a
  postmortem bundle here and the master writes a cluster manifest;
  empty disables the recorder.
- ``MP4J_AUDIT`` — the collective correctness auditing plane
  (``obs/audit.py``): ``off`` | ``digest`` (default: record per-
  collective input/output digests in a bounded ring, record-only) |
  ``verify`` (also ship digest records on the heartbeat and fold
  per-frame wire digests so the master can flag cross-rank
  divergences) | ``capture`` (verify + capture input payloads for
  offline ``mp4j-scope replay``). JOB-wide like ``native_transport``:
  cross-rank digest comparison is only meaningful when every rank
  computes digests the same way over the same schedule.
- ``MP4J_AUDIT_RING`` — capacity (records) of the per-rank audit
  record ring; bounds postmortem/replay coverage and, under
  ``capture``, the payload memory held per rank.
- ``MP4J_SINK`` / ``MP4J_SINK_DIR`` — the durable streaming telemetry
  sink (``obs/sink.py``): with ``MP4J_SINK_DIR`` set (and ``MP4J_SINK``
  not ``off``) every rank drains its span/metrics/audit/recovery rings
  into crc-framed append-only segment files under
  ``<dir>/rank_NNNN/`` on a background thread, so a multi-day job
  keeps full history on disk instead of ring tails
  (``mp4j-scope analyze`` / ``tail``). Unset dir disables the sink.
- ``MP4J_SINK_BYTES`` — PER-RANK disk budget for sink segments; the
  writer rotates segments and evicts the oldest whole segment when
  the rank's directory would exceed it (a job's total footprint is
  bounded by ``slave_num * MP4J_SINK_BYTES``).
- ``MP4J_SINK_FLUSH_SECS`` — period of the sink's background drain
  thread; each drain appends everything new in the source rings as
  frame-wise unbuffered writes, so a ``kill -9`` loses at most one
  flush interval of undrained telemetry plus the single frame being
  written (the torn tail the segment reader detects and reports).
- ``MP4J_ELASTIC`` — elastic-membership mode (
  ``resilience/membership.py``): ``off`` (default — a permanently dead
  rank is a job-wide ``Mp4jFatalError``, exactly the pre-elastic
  contract), ``replace`` (the master adopts a warm spare into the dead
  rank's id at the next epoch and the fenced retry continues
  bit-exactly), ``shrink`` (survivors renumber contiguously and
  continue at n-1 — reduction-only workloads), or ``grow`` (
  replacement-on-death PLUS roster EXPANSION — registered spares are
  adopted into NEW rank ids at an explicit app epoch boundary,
  ``ProcessCommSlave.resize_point()``, gated by ``MP4J_AUTOSCALE=act``).
  JOB-wide like ``native_transport``. CONFLICTS with
  ``MP4J_MAX_RETRIES=0``: the fenced retry IS the mechanism that
  re-runs the interrupted collective after a membership change, so
  fail-stop mode hard-rejects every elastic mode at setup (a
  validated-knob error, never a silent precedence).
- ``MP4J_SPARES`` — how many warm-spare registrations the master's
  rendezvous waits for before starting the job (spares registered
  later, mid-job, are accepted too); 0 (default) starts without any.
- ``MP4J_ADOPT_SECS`` — how long the master waits for an adopted
  spare's ack before declaring the spare dead and trying the next one
  (or going terminal when the pool is empty).
- ``MP4J_ASYNC`` — the nonblocking-collective scheduler (
  ``comm/progress.py``): ``1`` (default) runs ``i*`` submissions on
  the per-slave helper progression thread (interleaved raw-plane
  engine + coalescing + inline execution); ``0`` makes every ``i*``
  call execute EAGERLY on the caller's thread and return an
  already-resolved future — the bench A/B knob, and the frozen-leg
  pin (the shm/audit/sink precedent). A LOCAL execution-strategy
  knob: the wire bytes and their per-channel order are identical
  either way, so ranks need not agree.
- ``MP4J_COALESCE_USECS`` — the small-message coalescing window: ``iallreduce_map`` submissions arriving within this
  many microseconds fuse into ONE ``allreduce_map_multi`` negotiation
  + columnar frame train, de-fused on completion. The window extends
  the same window to the ARRAY plane: consecutive same-signature
  small ``iallreduce`` submissions fuse into one count-negotiated
  ``allreduce_array_multi`` exchange (tree schedule — the one their
  sizes resolve to individually, so fused == sequential bit-exact).
  ``0`` (default) disables fusion (every ``iallreduce_map`` runs the
  classic single-map plane, every small ``iallreduce`` its own tree
  walk). JOB-wide like ``native_transport``: whether a collective
  call uses the count-negotiating multi protocol or the classic one
  must match on every rank (the negotiated batch size then absorbs
  ragged coalescing depth).
- ``MP4J_OVERLAP`` — trainer-loop compute/communication overlap
  (``models/_base.py``): ``1`` submits each step's
  host-statistics exchange as nonblocking ``iallreduce`` /
  ``iallreduce_map`` futures and drains them at the NEXT step
  boundary (``wait_all``), so the progression thread drives the wire
  while the device runs step k+1; ``0`` (default) keeps today's
  blocking per-step exchange bit-for-bit. A LOCAL execution-strategy
  knob like ``MP4J_ASYNC``: submit order equals collective order on
  every rank either way, only the wait point moves, so ranks need
  not agree. Frozen bench legs pin it off (the shm/audit/sink/
  health/autoscale/tuner precedent).
- ``MP4J_MAX_OUTSTANDING`` — how many nonblocking collectives may be
  queued + in flight per slave before ``i*`` submission blocks
  (backpressure); also caps the engine batch and the coalescing
  fuse depth.
- ``MP4J_HEALTH`` — the streaming health plane (
  ``obs/health.py``): ``1``/``on`` (default) has every slave fold its
  span-ring delta into per-ordinal cells on the heartbeat and the
  master run the detector set (online critpath dominance, latency
  drift, storms, sink outages, backlog growth, heartbeat flapping,
  audit escalation) driving per-rank HEALTHY -> DEGRADED -> SUSPECT ->
  EVICT_RECOMMENDED verdicts; ``0``/``off`` disables both sides — the
  bench A/B knob and the frozen-leg pin (the shm/audit/sink
  precedent).
- ``MP4J_HEALTH_WINDOW`` — sliding window (attributed collective
  ordinals) the online dominator computes dominance shares over.
- ``MP4J_HEALTH_DOMINATOR_ORDINALS`` — consecutive slow ordinals one
  rank must gate before the engine recommends eviction (the ROADMAP
  autoscaler contract: "dominator for 500 consecutive ordinals should
  be evictable"); SUSPECT is forced at half this streak.
- ``MP4J_HEALTH_DRIFT_PCT`` — how far (percent) a rank's per-family
  latency must rise above its OWN rolling baseline — with the log2-
  histogram bucket shift confirming — before the drift detector fires.
- ``MP4J_AUTOSCALE`` — the closed-loop elastic autoscaler (
  ``resilience/autoscaler.py``): ``off`` (default — the master runs no
  controller, today's behavior bit-for-bit), ``observe`` (the
  controller runs, evaluates the health verdicts and LOGS every action
  it would take, but never acts), ``act`` (planned eviction of
  ``EVICT_RECOMMENDED`` ranks, spare auto-provisioning at pool
  exhaustion, and grow adoption at ``resize_point()`` boundaries all
  fire autonomously, behind the safety rails). Master-side only.
- ``MP4J_AUTOSCALE_COOLDOWN_SECS`` — minimum seconds between two
  autoscaler actions of the same kind; the anti-flap rail (a verdict
  that persists through the cooldown is a trend, not a blip).
- ``MP4J_AUTOSCALE_BUDGET`` — job-lifetime cap on autoscaler actions;
  a controller that wants action N+1 is oscillating, and a bounded
  actuator is strictly safer than an unbounded one.
- ``MP4J_PROVISION_CMD`` — operator hook command: when the warm-spare
  pool drains to zero under ``MP4J_AUTOSCALE=act``, the master runs
  this shell command (env ``MP4J_MASTER_HOST``/``MP4J_MASTER_PORT``
  point at the rendezvous listener) to spawn a fresh ``spare=True``
  process; empty disables the subprocess path (the
  ``Master(provision_hook=)`` constructor seam still works).
- ``MP4J_TUNER`` — the self-tuning data plane (
  ``utils/tuner.py``): ``off`` (static knobs only, the pre-tuner
  behavior bit-for-bit), ``observe`` (default: the policy core
  evaluates the rolling per-link stats every window and RECORDS the
  decisions it would make — telemetry, ``mp4j-scope tuner`` — but
  applies nothing), ``act`` (per-link chunk-size / compression /
  socket-buffer decisions apply at outermost-collective boundaries,
  and the master may demote a persistently wire-dominated host
  leader through a fenced topology update). A LOCAL
  execution-strategy knob for the per-link decisions (the framed
  wire format is receiver-auto-detected, so sender-side decisions
  never desync a pair) — but run every rank with the same value so
  the telemetry reads coherently.
- ``MP4J_TUNER_WINDOW_SECS`` — how often the tuner folds the rolling
  per-link stats into a decision window; hysteresis is counted in
  these windows (a decision changes only after
  ``tuner.SUSTAIN_WINDOWS`` consecutive windows agree).
- ``MP4J_FLEET_POLL_SECS`` / ``MP4J_FLEET_STALE_SECS`` /
  ``MP4J_FLEET_SINK_DIR`` — the cross-job fleet poller (
  ``obs/fleet.py`` behind ``mp4j-scope fleet``): sweep period, the
  seconds-without-a-scrape bound that degrades a job ``LIVE ->
  STALE`` (``GONE`` at 3x), and the durable fleet-history directory
  (crc-framed segments, ``mp4j-scope fleet-report``; empty disables
  it). SCRAPER-side knobs — they configure the observer machine, not
  the jobs, so no job-wide-agreement requirement applies.
- ``MP4J_SO_BUF_MAP`` — explicit PER-LINK socket buffer overrides:
  ``"peer:sndbuf[/rcvbuf],..."`` (e.g. ``"2:262144,3:524288/1048576"``)
  applies those buffer sizes to the TCP link with that peer rank at
  channel setup (dial side before ``connect()``, accept side after
  the handshake identifies the peer), overriding the job-wide
  ``MP4J_SO_{SND,RCV}BUF`` for that link; the applied values are
  recorded per link in ``comm.link_stats()``.
"""

from __future__ import annotations

import os

from ytk_mp4j_tpu_torch.exceptions import Mp4jError

DEFAULT_CHUNK_BYTES = 1024 * 1024
# Sweep-grounded (bench.py socket_allreduce_sweep on the bench host,
# BENCH JSON extra): the binomial tree wins the latency-bound regime up
# to ~256 KiB (~1.5x over RHD at 64 KiB); RHD wins the middle; from
# ~4 MiB the pipelined ring's uniform per-step segments edge out RHD's
# large first-round exchange (~1.15x at 8 MiB). Hosts with different
# core counts / NICs tune via env.
DEFAULT_ALGO_SMALL_BYTES = 256 * 1024
DEFAULT_ALGO_LARGE_BYTES = 4 * 1024 * 1024
# Shared-memory transport defaults: ring sized to one
# pipeline chunk so a chunked exchange streams through without an
# intermediate wait in the common case.
DEFAULT_SHM_RING_BYTES = 1024 * 1024
# The raw-plane ring threshold (centralized here by the
# R22 knob discipline): a raw transfer below this rides the shm pair's
# TCP carrier — the kernel's recv wakeup beats every user-space wait on
# an oversubscribed host (measured, see transport/shm.py) — and one at
# or above it streams through the ring in pieces. Part of the shm wire
# protocol: both ends derive the route from the same transfer size.
SHM_RING_MIN_BYTES = 256 * 1024
# Floor for ring capacity (the MP4J_SHM_RING_BYTES validator, the peer
# handshake's sanity check, and the piece-size clamp all share it): one
# frame header plus a compressed chunk length must always be
# ring-transitable.
SHM_RING_FLOOR = 4096
# Frame-level ring routing default: smaller than the raw
# plane's SHM_RING_MIN_BYTES because framed payloads (map value
# columns, compressed pieces) already paid the framing/serialize tax —
# the ring memcpy wins earlier there; the sync-byte wakeup still rides
# the carrier, so small frames keep the pure kernel path.
DEFAULT_SHM_FRAME_MIN = 64 * 1024
# Resilience defaults: recovery is ON by default — two
# epoch-fenced retry rounds per failed collective — because the fence
# itself is a flag check (~0 steady-state cost; the input-preservation
# copy is the only measurable term, see README "Fault tolerance").
# The dead-rank threshold is deliberately much larger than any
# per-collective timeout: declaring a slow rank dead is irreversible.
DEFAULT_MAX_RETRIES = 2
DEFAULT_RECONNECT_BACKOFF = 0.05
DEFAULT_DEAD_RANK_SECS = 120.0
# Telemetry defaults: a heartbeat is one ~300-byte control frame per
# rank per period (off the data plane entirely), and a span is one
# O(1) deque append — both default-on, both sized so the observability
# tax stays well under the <2% bench budget.
DEFAULT_HEARTBEAT_SECS = 0.5
DEFAULT_SPAN_RING = 65536
# Audit-plane defaults: digest-mode recording is default-on
# (one vectorized hash pass per collective input/output — the wire
# crc folds and heartbeat shipping only arm in verify/capture); the
# ring bounds postmortem/replay coverage at a fixed memory cost, like
# the span ring.
DEFAULT_AUDIT_MODE = "digest"
DEFAULT_AUDIT_RING = 1024
AUDIT_MODES = ("off", "digest", "verify", "capture")
# Durable-sink defaults: armed only when MP4J_SINK_DIR is
# set. 64 MiB per rank holds hours of span-level history at typical
# collective rates (one ~120 B span record per chunk/phase); the 1 s
# flush period bounds kill -9 telemetry loss to one interval while
# keeping the drain thread's duty cycle negligible.
DEFAULT_SINK_BYTES = 64 * 1024 * 1024
DEFAULT_SINK_FLUSH_SECS = 1.0
# Elastic-membership defaults: OFF by default — replacing
# or renumbering ranks is a semantic contract change the operator must
# opt into; the adoption deadline is generous (a spare only has to ack
# a control message, but a loaded host may schedule it late) while
# still far below MP4J_DEAD_RANK_SECS so a dead spare costs one
# deadline, not the whole recovery budget.
DEFAULT_ELASTIC_MODE = "off"
ELASTIC_MODES = ("off", "replace", "shrink", "grow")
DEFAULT_SPARES = 0
DEFAULT_ADOPT_SECS = 10.0
# Metrics-plane default: the window the master's rate ring
# covers. Heartbeats arrive every DEFAULT_HEARTBEAT_SECS, so 60 s keeps
# ~120 interval points per rank — enough for a stable GB/s readout,
# small enough that a stall shows within a minute.
DEFAULT_METRICS_WINDOW_SECS = 60.0

# Log-level ladder for the master's log sink (MP4J_LOG_LEVEL).
LOG_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "ERROR": 40}


def env_bytes(name: str, default: int, minimum: int = 1) -> int:
    """A byte-count knob from the environment, validated: an unset or
    empty var yields ``default``; anything else must parse as an int
    >= ``minimum`` (suffix-free; ``262144``, not ``256k``) or the
    caller's setup fails with a diagnosable Mp4jError instead of a
    mid-collective surprise."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        val = int(raw)
    except ValueError:
        raise Mp4jError(
            f"{name}={raw!r} is not an integer byte count") from None
    if val < minimum:
        raise Mp4jError(f"{name}={val} must be >= {minimum}")
    return val


def env_float(name: str, default: float, minimum: float = 0.0) -> float:
    """A float knob from the environment, validated like
    :func:`env_bytes`: unset/empty yields ``default``; anything else
    must parse as a float >= ``minimum`` or setup fails cleanly."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        val = float(raw)
    except ValueError:
        raise Mp4jError(f"{name}={raw!r} is not a number") from None
    if val < minimum:
        raise Mp4jError(f"{name}={val} must be >= {minimum}")
    return val


def env_int(name: str, default: int, minimum: int = 0) -> int:
    """A plain integer-count knob (retry budgets, not byte sizes) —
    same validation shape as :func:`env_bytes` with an honest
    diagnostic."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        val = int(raw)
    except ValueError:
        raise Mp4jError(
            f"{name}={raw!r} is not an integer") from None
    if val < minimum:
        raise Mp4jError(f"{name}={val} must be >= {minimum}")
    return val


def chunk_bytes() -> int:
    return env_bytes("MP4J_CHUNK_BYTES", DEFAULT_CHUNK_BYTES, minimum=64)


def heartbeat_secs() -> float:
    """Slave->master telemetry heartbeat period; 0 disables."""
    return env_float("MP4J_HEARTBEAT_SECS", DEFAULT_HEARTBEAT_SECS,
                     minimum=0.0)


def span_ring_capacity() -> int:
    """Capacity of the in-process span ring (obs.spans); 0 disables."""
    return env_bytes("MP4J_SPAN_RING", DEFAULT_SPAN_RING, minimum=0)


def log_level() -> str:
    """The master log sink's minimum level (``MP4J_LOG_LEVEL``),
    validated against :data:`LOG_LEVELS` — a typo'd level fails master
    setup cleanly instead of silently printing everything."""
    raw = os.environ.get("MP4J_LOG_LEVEL")
    if raw is None or raw.strip() == "":
        return "INFO"
    name = raw.strip().upper()
    if name not in LOG_LEVELS:
        raise Mp4jError(
            f"MP4J_LOG_LEVEL={raw!r} is not one of "
            f"{sorted(LOG_LEVELS)}")
    return name


def shm_enabled() -> bool:
    """Whether rendezvous may negotiate the shared-memory transport for
    same-host peer pairs (``MP4J_SHM``). JOB-wide like
    ``native_transport``: the dialer offers shm in the peer handshake
    and the accepter attaches, so every rank must run with the same
    value or a pair could disagree about its data plane."""
    raw = os.environ.get("MP4J_SHM")
    if raw is None or raw.strip() == "":
        return True
    val = raw.strip()
    if val not in ("0", "1"):
        raise Mp4jError(f"MP4J_SHM={raw!r} must be 0 or 1")
    return val == "1"


def shm_ring_bytes() -> int:
    """Bytes per direction of each shm peer pair's ring
    (``MP4J_SHM_RING_BYTES``). The rings carry the
    framed/columnar-map plane too (see :func:`shm_frame_min`), not
    just raw transfers. The floor (:data:`SHM_RING_FLOOR`) keeps one
    frame header plus a compressed chunk length always
    ring-transitable."""
    return env_bytes("MP4J_SHM_RING_BYTES", DEFAULT_SHM_RING_BYTES,
                     minimum=SHM_RING_FLOOR)


def shm_frame_min() -> int:
    """Frame-level ring routing threshold (``MP4J_SHM_FRAME_MIN``): a framed payload whose length — carried by the frame
    header / chunk length prefix, so both ends know it BEFORE any
    payload byte moves — clears this value rides the shm ring; ``0``
    disables frame routing (all framed bytes keep the TCP carrier,
    the carrier-only wire layout). JOB-wide like ``native_transport``:
    the threshold is part of the shm pair's wire protocol."""
    return env_bytes("MP4J_SHM_FRAME_MIN", DEFAULT_SHM_FRAME_MIN,
                     minimum=0)


def map_columnar_enabled() -> bool:
    """Whether numeric-operand socket map collectives default to the
    columnar (codes, values) wire plane (``MP4J_MAP_COLUMNAR``).
    JOB-wide, exactly like ``native_transport``: both ends of every
    exchange must agree on the plane, so every rank of a job must run
    with the same value (the per-call negotiation header then handles
    data-dependent fallback consistently)."""
    raw = os.environ.get("MP4J_MAP_COLUMNAR")
    if raw is None or raw.strip() == "":
        return True
    val = raw.strip()
    if val not in ("0", "1"):
        raise Mp4jError(
            f"MP4J_MAP_COLUMNAR={raw!r} must be 0 or 1")
    return val == "1"


def max_retries() -> int:
    """Epoch-fenced retry budget per failed collective
    (``MP4J_MAX_RETRIES``); 0 restores the reference's fail-stop."""
    return env_int("MP4J_MAX_RETRIES", DEFAULT_MAX_RETRIES, minimum=0)


def reconnect_backoff() -> float:
    """Base seconds of the capped exponential re-dial backoff
    (``MP4J_RECONNECT_BACKOFF``)."""
    return env_float("MP4J_RECONNECT_BACKOFF", DEFAULT_RECONNECT_BACKOFF,
                     minimum=0.0)


def dead_rank_secs(override=None) -> float:
    """Seconds of silence (missing abort ack / stalled barrier) before
    the master declares a rank dead and fans out a terminal abort
    (``MP4J_DEAD_RANK_SECS``); must be positive — a zero threshold
    would declare every rank dead at the first tick (master) and
    expire every recovery deadline instantly (slave). ``override`` is
    an explicit constructor arg taking the SAME validation as the env
    path, so master- and slave-side acceptance can never diverge;
    ``float('inf')`` is the documented disable idiom."""
    if override is None:
        return env_float("MP4J_DEAD_RANK_SECS", DEFAULT_DEAD_RANK_SECS,
                         minimum=0.001)
    val = float(override)
    if not val > 0:
        raise Mp4jError(
            f"dead_rank_secs={override} must be > 0 "
            f"(use float('inf') to disable the escalation)")
    return val


def metrics_enabled() -> bool:
    """Whether the metrics plane records (``MP4J_METRICS``): latency /
    frame-size histograms plus the heartbeat's metric deltas. Default
    on — recording is a lock + two integer bumps per event; ``0`` is
    the bench's A/B knob, turning every observe into a no-op."""
    raw = os.environ.get("MP4J_METRICS")
    if raw is None or raw.strip() == "":
        return True
    val = raw.strip()
    if val not in ("0", "1"):
        raise Mp4jError(f"MP4J_METRICS={raw!r} must be 0 or 1")
    return val == "1"


def metrics_port(override=None) -> int | None:
    """The master's HTTP metrics endpoint port (``MP4J_METRICS_PORT``).
    ``None`` (unset/empty) disables the endpoint; ``0`` binds an
    ephemeral port (read ``Master.metrics_port`` for the real one);
    otherwise must be a valid TCP port. ``override`` is the explicit
    ``Master(metrics_port=...)`` constructor value — it bypasses the
    env read but gets the SAME validation (one validator per knob, the
    knob discipline), so a typo'd port raises a clean ``Mp4jError``
    instead of a raw socket OverflowError at bind time."""
    if override is not None:
        raw = str(override)
    else:
        raw = os.environ.get("MP4J_METRICS_PORT")
        if raw is None or raw.strip() == "":
            return None
    try:
        val = int(raw)
    except (TypeError, ValueError):
        raise Mp4jError(
            f"MP4J_METRICS_PORT={raw!r} is not an integer port") from None
    if not 0 <= val <= 65535:
        raise Mp4jError(
            f"MP4J_METRICS_PORT={val} outside [0, 65535]")
    return val


def metrics_window_secs() -> float:
    """Sliding window (seconds) for the master's derived rates
    (``MP4J_METRICS_WINDOW_SECS``); must be positive — a zero window
    can never hold two interval snapshots, so every rate would read
    0."""
    return env_float("MP4J_METRICS_WINDOW_SECS",
                     DEFAULT_METRICS_WINDOW_SECS, minimum=0.001)


def postmortem_dir() -> str:
    """The flight-recorder directory (``MP4J_POSTMORTEM_DIR``); empty
    disables the recorder. Validated lightly here (it must not name an
    existing regular file — every rank is about to mkdir under it);
    creation happens lazily at dump time."""
    raw = os.environ.get("MP4J_POSTMORTEM_DIR", "").strip()
    if raw and os.path.isfile(raw):
        raise Mp4jError(
            f"MP4J_POSTMORTEM_DIR={raw!r} names an existing regular "
            "file, not a directory")
    return raw


def audit_mode(override=None) -> str:
    """The audit plane's mode (``MP4J_AUDIT``): one of
    :data:`AUDIT_MODES`. ``override`` is the explicit constructor arg
    (``ProcessCommSlave(audit=...)``) — it bypasses the env read but
    gets the SAME validation (one validator per knob, the knob
    discipline). JOB-wide: every rank must run the same mode or
    cross-rank digest comparison would flag healthy seqs."""
    if override is not None:
        raw = str(override)
    else:
        raw = os.environ.get("MP4J_AUDIT")
        if raw is None or raw.strip() == "":
            return DEFAULT_AUDIT_MODE
    name = raw.strip().lower()
    if name not in AUDIT_MODES:
        raise Mp4jError(
            f"MP4J_AUDIT={raw!r} is not one of {list(AUDIT_MODES)}")
    return name


def audit_ring() -> int:
    """Capacity (records) of the per-rank audit record ring
    (``MP4J_AUDIT_RING``); must be >= 1 — disabling the plane is
    ``MP4J_AUDIT=off``, not a zero ring."""
    return env_int("MP4J_AUDIT_RING", DEFAULT_AUDIT_RING, minimum=1)


def sink_enabled() -> bool:
    """Whether the durable telemetry sink may arm (``MP4J_SINK``).
    ``on``/``1`` (default) lets a set ``MP4J_SINK_DIR`` arm it;
    ``off``/``0`` pins it off regardless of the dir — the bench A/B
    knob, mirroring the shm/audit frozen-leg precedent."""
    raw = os.environ.get("MP4J_SINK")
    if raw is None or raw.strip() == "":
        return True
    val = raw.strip().lower()
    if val not in ("on", "off", "0", "1"):
        raise Mp4jError(
            f"MP4J_SINK={raw!r} must be one of on/off/0/1")
    return val in ("on", "1")


def sink_dir() -> str:
    """The durable sink's root directory (``MP4J_SINK_DIR``); empty
    disables the sink. Validated like ``MP4J_POSTMORTEM_DIR`` (must
    not name an existing regular file — every rank mkdirs under it);
    creation happens lazily at the first drain."""
    raw = os.environ.get("MP4J_SINK_DIR", "").strip()
    if raw and os.path.isfile(raw):
        raise Mp4jError(
            f"MP4J_SINK_DIR={raw!r} names an existing regular file, "
            "not a directory")
    return raw


def sink_bytes() -> int:
    """PER-RANK disk budget for sink segments (``MP4J_SINK_BYTES``).
    The floor keeps at least two rotatable segments alive — eviction
    removes whole segments and must never have to evict the one being
    written."""
    return env_bytes("MP4J_SINK_BYTES", DEFAULT_SINK_BYTES,
                     minimum=128 * 1024)


def sink_flush_secs() -> float:
    """Background drain period of the durable sink
    (``MP4J_SINK_FLUSH_SECS``); must be positive — the sink is
    disabled by unsetting ``MP4J_SINK_DIR`` (or ``MP4J_SINK=off``),
    not by a zero period."""
    return env_float("MP4J_SINK_FLUSH_SECS", DEFAULT_SINK_FLUSH_SECS,
                     minimum=0.01)


def elastic_mode(override=None, max_retries=None) -> str:
    """The elastic-membership mode (``MP4J_ELASTIC``): one of
    :data:`ELASTIC_MODES`. ``override`` is the explicit constructor arg
    (``Master(elastic=...)`` / ``ProcessCommSlave(elastic=...)``) — it
    bypasses the env read but gets the SAME validation (one validator
    per knob, the knob discipline). JOB-wide: the master drives the
    membership protocol, but every slave validates the same value so a
    misconfigured rank fails at setup, not mid-recovery.

    CONFLICT RULE: ``MP4J_MAX_RETRIES=0`` is
    the exact fail-stop reference contract — the first transport error
    is final and no abort round ever runs — while both elastic modes
    NEED the fenced retry to re-run the interrupted collective after a
    membership change. An elastic mode next to a zero retry budget is
    therefore a contradiction, and it raises here as a validated-knob
    error instead of one knob silently winning. ``max_retries`` is the
    caller's explicit budget (None reads ``MP4J_MAX_RETRIES``)."""
    if override is not None:
        raw = str(override)
    else:
        raw = os.environ.get("MP4J_ELASTIC")
        if raw is None or raw.strip() == "":
            raw = DEFAULT_ELASTIC_MODE
    name = raw.strip().lower()
    if name not in ELASTIC_MODES:
        raise Mp4jError(
            f"MP4J_ELASTIC={raw!r} is not one of {list(ELASTIC_MODES)}")
    if name != "off":
        budget = (max_retries if max_retries is not None
                  else env_int("MP4J_MAX_RETRIES", DEFAULT_MAX_RETRIES,
                               minimum=0))
        if budget == 0:
            raise Mp4jError(
                f"MP4J_ELASTIC={name} conflicts with MP4J_MAX_RETRIES=0: "
                "fail-stop mode disables the epoch-fenced retry that "
                "elastic membership re-runs the interrupted collective "
                "through; set MP4J_MAX_RETRIES>=1 or MP4J_ELASTIC=off")
    return name


def spares(override=None) -> int:
    """How many warm-spare registrations rendezvous waits for before
    the job starts (``MP4J_SPARES``); spares may also register mid-job.
    ``override`` is the explicit ``Master(spares=...)`` value, same
    validation as the env path."""
    if override is None:
        return env_int("MP4J_SPARES", DEFAULT_SPARES, minimum=0)
    val = int(override)
    if val < 0:
        raise Mp4jError(f"spares={override} must be >= 0")
    return val


def adopt_secs(override=None) -> float:
    """The spare-adoption deadline (``MP4J_ADOPT_SECS``): how long the
    master waits for an adopted spare's ack before trying the next
    spare; must be positive (a zero deadline would burn the whole pool
    before any spare could answer)."""
    if override is None:
        return env_float("MP4J_ADOPT_SECS", DEFAULT_ADOPT_SECS,
                         minimum=0.001)
    val = float(override)
    if not val > 0:
        raise Mp4jError(f"adopt_secs={override} must be > 0")
    return val


# Nonblocking-collective defaults: the scheduler is ON by
# default (a job that never calls i* pays nothing — the progression
# thread starts lazily); coalescing is opt-in (it changes the map wire
# protocol job-wide, so the default must be the classic plane); the
# outstanding cap bounds snapshot memory (each outstanding collective
# may hold one payload-sized retry snapshot).
DEFAULT_MAX_OUTSTANDING = 64


def async_enabled() -> bool:
    """Whether ``i*`` submissions run on the helper progression thread
    (``MP4J_ASYNC``); ``0`` = eager caller-thread execution returning
    resolved futures (the bench A/B knob). Local execution strategy —
    wire-identical either way."""
    raw = os.environ.get("MP4J_ASYNC")
    if raw is None or raw.strip() == "":
        return True
    val = raw.strip()
    if val not in ("0", "1"):
        raise Mp4jError(f"MP4J_ASYNC={raw!r} must be 0 or 1")
    return val == "1"


def coalesce_usecs() -> int:
    """The small-message coalescing window in MICROseconds
    (``MP4J_COALESCE_USECS``); 0 disables fusion. JOB-wide: selects
    between the classic and the count-negotiating multi map protocol,
    so every rank must agree."""
    return env_int("MP4J_COALESCE_USECS", 0, minimum=0)


def overlap_enabled() -> bool:
    """Whether the trainer epoch loops overlap each step's host
    statistics exchange with the next step's compute
    (``MP4J_OVERLAP``); ``0``/unset keeps the blocking per-step
    exchange. Local wait-point strategy — wire-identical either
    way (submit order == collective order on every rank)."""
    raw = os.environ.get("MP4J_OVERLAP")
    if raw is None or raw.strip() == "":
        return False
    val = raw.strip()
    if val not in ("0", "1"):
        raise Mp4jError(f"MP4J_OVERLAP={raw!r} must be 0 or 1")
    return val == "1"


def max_outstanding() -> int:
    """Outstanding-collective cap per slave (``MP4J_MAX_OUTSTANDING``);
    submission blocks past it. Must be >= 1 — disabling async is
    ``MP4J_ASYNC=0``, not a zero window."""
    return env_int("MP4J_MAX_OUTSTANDING", DEFAULT_MAX_OUTSTANDING,
                   minimum=1)


# Health-plane defaults: default-on like the metrics plane
# (the slave side is one span-ring delta fold per heartbeat, the
# master side a handful of dict updates per beat). The dominator
# eviction threshold is the ROADMAP's verbatim contract; the drift
# threshold is one full log2 histogram bucket (2x) so scheduler noise
# on microsecond collectives never reads as degradation.
DEFAULT_HEALTH_WINDOW = 64
DEFAULT_HEALTH_DOMINATOR_ORDINALS = 500
DEFAULT_HEALTH_DRIFT_PCT = 100.0


def health_enabled(override=None) -> bool:
    """Whether the streaming health plane runs (``MP4J_HEALTH``).
    ``override`` is the explicit constructor arg
    (``Master(health=...)`` / ``ProcessCommSlave(health=...)``) — it
    bypasses the env read but gets the SAME validation (one validator
    per knob, the knob discipline). JOB-wide in practice: a slave with
    it off simply never ships health deltas, so its dominator cells
    are missing and the master attributes nothing — run every rank
    with the same value."""
    if override is not None:
        return bool(override)
    raw = os.environ.get("MP4J_HEALTH")
    if raw is None or raw.strip() == "":
        return True
    val = raw.strip().lower()
    if val not in ("on", "off", "0", "1"):
        raise Mp4jError(
            f"MP4J_HEALTH={raw!r} must be one of on/off/0/1")
    return val in ("on", "1")


def health_window() -> int:
    """Sliding window, in attributed collective ordinals, for the
    online dominator's dominance shares (``MP4J_HEALTH_WINDOW``)."""
    return env_int("MP4J_HEALTH_WINDOW", DEFAULT_HEALTH_WINDOW,
                   minimum=4)


def health_dominator_ordinals() -> int:
    """Consecutive slow dominated ordinals before the engine
    recommends eviction (``MP4J_HEALTH_DOMINATOR_ORDINALS``); SUSPECT
    is forced at half this streak. Must be >= 2 — a single ordinal is
    noise, not a verdict."""
    return env_int("MP4J_HEALTH_DOMINATOR_ORDINALS",
                   DEFAULT_HEALTH_DOMINATOR_ORDINALS, minimum=2)


def health_drift_pct() -> float:
    """Percent above a rank's own latency baseline before the drift
    detector fires (``MP4J_HEALTH_DRIFT_PCT``); must be positive —
    disabling the plane is ``MP4J_HEALTH=0``, not a zero threshold."""
    return env_float("MP4J_HEALTH_DRIFT_PCT", DEFAULT_HEALTH_DRIFT_PCT,
                     minimum=1.0)


# Autoscaler defaults: OFF by default — acting on health
# verdicts is an operator opt-in on top of the elastic machinery. The
# cooldown is deliberately long relative to the health plane's
# detection latency (one action per verdict trend, never per fold);
# the budget bounds a flapping controller's lifetime damage.
AUTOSCALE_MODES = ("off", "observe", "act")
DEFAULT_AUTOSCALE_MODE = "off"
DEFAULT_AUTOSCALE_COOLDOWN_SECS = 30.0
DEFAULT_AUTOSCALE_BUDGET = 16


def autoscale_mode(override=None) -> str:
    """The autoscaler's mode (``MP4J_AUTOSCALE``): one of
    :data:`AUTOSCALE_MODES`. ``override`` is the explicit
    ``Master(autoscale=...)`` constructor value — same validation as
    the env path (one validator per knob, the knob discipline).
    Master-side only: slaves never read it."""
    if override is not None:
        raw = str(override)
    else:
        raw = os.environ.get("MP4J_AUTOSCALE")
        if raw is None or raw.strip() == "":
            return DEFAULT_AUTOSCALE_MODE
    name = raw.strip().lower()
    if name not in AUTOSCALE_MODES:
        raise Mp4jError(
            f"MP4J_AUTOSCALE={raw!r} is not one of "
            f"{list(AUTOSCALE_MODES)}")
    return name


def autoscale_cooldown_secs(override=None) -> float:
    """Minimum seconds between two autoscaler actions of one kind
    (``MP4J_AUTOSCALE_COOLDOWN_SECS``); >= 0 (0 is legal for tests —
    the budget and the one-action-in-flight rule still bound the
    controller)."""
    if override is None:
        return env_float("MP4J_AUTOSCALE_COOLDOWN_SECS",
                         DEFAULT_AUTOSCALE_COOLDOWN_SECS, minimum=0.0)
    val = float(override)
    if val < 0:
        raise Mp4jError(
            f"autoscale_cooldown={override} must be >= 0")
    return val


def autoscale_budget(override=None) -> int:
    """Job-lifetime autoscaler action cap (``MP4J_AUTOSCALE_BUDGET``);
    must be >= 1 — disabling the controller is ``MP4J_AUTOSCALE=off``,
    not a zero budget."""
    if override is None:
        return env_int("MP4J_AUTOSCALE_BUDGET",
                       DEFAULT_AUTOSCALE_BUDGET, minimum=1)
    val = int(override)
    if val < 1:
        raise Mp4jError(f"autoscale_budget={override} must be >= 1")
    return val


def provision_cmd() -> str:
    """The operator's spare-provisioning shell command
    (``MP4J_PROVISION_CMD``; '' disables the subprocess hook). Run by
    the master with ``MP4J_MASTER_HOST``/``MP4J_MASTER_PORT`` in the
    environment when the warm-spare pool drains to zero under
    ``MP4J_AUTOSCALE=act``."""
    return os.environ.get("MP4J_PROVISION_CMD", "").strip()


# Self-tuning data plane defaults: OBSERVE by default — the
# policy core runs and its would-be decisions are visible everywhere
# (telemetry, `mp4j-scope tuner`), but nothing changes until the
# operator opts into `act`; the window paces evidence collection (a
# decision needs SUSTAIN_WINDOWS consecutive agreeing windows, so the
# reaction time is window * sustain, deliberately slower than any
# single noisy interval).
TUNER_MODES = ("off", "observe", "act")
DEFAULT_TUNER_MODE = "observe"
DEFAULT_TUNER_WINDOW_SECS = 2.0


def tuner_mode(override=None) -> str:
    """The self-tuning data plane's mode (``MP4J_TUNER``): one of
    :data:`TUNER_MODES`. ``override`` is the explicit constructor arg
    (``ProcessCommSlave(tuner=...)`` / ``Master(tuner=...)``) — it
    bypasses the env read but gets the SAME validation (one validator
    per knob, the knob discipline)."""
    if override is not None:
        raw = str(override)
    else:
        raw = os.environ.get("MP4J_TUNER")
        if raw is None or raw.strip() == "":
            return DEFAULT_TUNER_MODE
    name = raw.strip().lower()
    if name not in TUNER_MODES:
        raise Mp4jError(
            f"MP4J_TUNER={raw!r} is not one of {list(TUNER_MODES)}")
    return name


def tuner_window_secs() -> float:
    """The tuner's decision-window period
    (``MP4J_TUNER_WINDOW_SECS``); must be positive — disabling the
    tuner is ``MP4J_TUNER=off``, not a zero window."""
    return env_float("MP4J_TUNER_WINDOW_SECS",
                     DEFAULT_TUNER_WINDOW_SECS, minimum=0.05)


# Serve-plane defaults: the micro-batcher holds the first
# request of a batch at most DEADLINE_MS before dispatching whatever
# has accumulated (tail latency bound), and never accumulates past
# MAX_BATCH (queueing bound). The cache rows/staleness knobs bound the
# frontend's hot-key row cache: CACHE_ROWS caps resident rows (LRU),
# STALE_VERSIONS is the published staleness bound — a cached row may
# lag the live table by at most that many model-version bumps before a
# lookup treats it as a miss. The load-following thresholds feed the
# autoscaler's observe-first serve policy (idle QPS below IDLE_QPS for
# IDLE_SECS proposes a shrink; QPS above BUSY_QPS proposes a grow).
DEFAULT_SERVE_DEADLINE_MS = 2.0
DEFAULT_SERVE_MAX_BATCH = 32
DEFAULT_SERVE_CACHE_ROWS = 100_000
DEFAULT_SERVE_STALE_VERSIONS = 0
DEFAULT_SERVE_IDLE_QPS = 1.0
DEFAULT_SERVE_BUSY_QPS = 1000.0
DEFAULT_SERVE_IDLE_SECS = 60.0


def serve_deadline_ms(override=None) -> float:
    """Micro-batch accumulation deadline in milliseconds
    (``MP4J_SERVE_DEADLINE_MS``): the longest the batcher may hold the
    OLDEST queued request before dispatching a partial batch. Must be
    positive — a zero deadline is the unbatched loop, spelled
    ``MP4J_SERVE_MAX_BATCH=1``. ``override`` is the explicit
    constructor value (``MicroBatcher(deadline_ms=...)``) — it bypasses
    the env read but gets the same validation."""
    if override is None:
        return env_float("MP4J_SERVE_DEADLINE_MS",
                         DEFAULT_SERVE_DEADLINE_MS, minimum=0.01)
    val = float(override)
    if val <= 0:
        raise Mp4jError(
            f"serve deadline_ms={override} must be positive")
    return val


def serve_max_batch(override=None) -> int:
    """Micro-batch size cap (``MP4J_SERVE_MAX_BATCH``): a full batch
    dispatches immediately without waiting out the deadline. ``1``
    IS the unbatched reference loop (the bench A/B arm)."""
    if override is None:
        return env_int("MP4J_SERVE_MAX_BATCH",
                       DEFAULT_SERVE_MAX_BATCH, minimum=1)
    val = int(override)
    if val < 1:
        raise Mp4jError(f"serve max_batch={override} must be >= 1")
    return val


def serve_cache_rows(override=None) -> int:
    """Hot-key row cache capacity in ROWS (``MP4J_SERVE_CACHE_ROWS``);
    ``0`` disables the cache (every request pulls its rows — the bench
    A/B knob for the cache figure)."""
    if override is None:
        return env_int("MP4J_SERVE_CACHE_ROWS",
                       DEFAULT_SERVE_CACHE_ROWS, minimum=0)
    val = int(override)
    if val < 0:
        raise Mp4jError(f"serve cache_rows={override} must be >= 0")
    return val


def serve_stale_versions(override=None) -> int:
    """The cache's published staleness bound
    (``MP4J_SERVE_STALE_VERSIONS``): a cached row whose stamp lags the
    live model version by MORE than this many bumps is treated as a
    miss (and counted ``serve/cache_stale``). ``0`` (default) means a
    version bump invalidates everything cached under older stamps."""
    if override is None:
        return env_int("MP4J_SERVE_STALE_VERSIONS",
                       DEFAULT_SERVE_STALE_VERSIONS, minimum=0)
    val = int(override)
    if val < 0:
        raise Mp4jError(
            f"serve stale_versions={override} must be >= 0")
    return val


def serve_idle_qps() -> float:
    """Load-following shrink threshold (``MP4J_SERVE_IDLE_QPS``):
    sustained serve QPS below this proposes releasing a serve rank
    (observe mode first)."""
    return env_float("MP4J_SERVE_IDLE_QPS", DEFAULT_SERVE_IDLE_QPS,
                     minimum=0.0)


def serve_busy_qps() -> float:
    """Load-following grow threshold (``MP4J_SERVE_BUSY_QPS``): serve
    QPS at or above this proposes growing the roster at the next
    ``resize_point()``. Must exceed the idle threshold — a crossed
    pair would flap."""
    idle = serve_idle_qps()
    val = env_float("MP4J_SERVE_BUSY_QPS", DEFAULT_SERVE_BUSY_QPS,
                    minimum=0.0)
    if val <= idle:
        raise Mp4jError(
            f"MP4J_SERVE_BUSY_QPS={val} must exceed "
            f"MP4J_SERVE_IDLE_QPS={idle}")
    return val


def serve_idle_secs() -> float:
    """How long serve QPS must stay below the idle threshold before
    the shrink proposal fires (``MP4J_SERVE_IDLE_SECS``) — sustained
    idleness, not one quiet window."""
    return env_float("MP4J_SERVE_IDLE_SECS", DEFAULT_SERVE_IDLE_SECS,
                     minimum=0.0)


def so_buf_map() -> dict[int, tuple[int, int]]:
    """Explicit per-link socket buffer overrides (``MP4J_SO_BUF_MAP``): ``"peer:sndbuf[/rcvbuf],..."`` parsed into
    ``{peer_rank: (sndbuf, rcvbuf)}`` (one size applies to both
    directions when no ``/rcvbuf`` is given). Validated here like
    every other knob — a malformed entry fails slave setup with the
    offending token named, never a mid-dial surprise."""
    raw = os.environ.get("MP4J_SO_BUF_MAP", "").strip()
    out: dict[int, tuple[int, int]] = {}
    if not raw:
        return out
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            rank_s, sizes = tok.split(":", 1)
            rank = int(rank_s)
            if "/" in sizes:
                snd_s, rcv_s = sizes.split("/", 1)
                snd, rcv = int(snd_s), int(rcv_s)
            else:
                snd = rcv = int(sizes)
        except ValueError:
            raise Mp4jError(
                f"MP4J_SO_BUF_MAP entry {tok!r} is not "
                "'peer:sndbuf[/rcvbuf]'") from None
        if rank < 0 or snd < 0 or rcv < 0:
            raise Mp4jError(
                f"MP4J_SO_BUF_MAP entry {tok!r} has a negative value")
        out[rank] = (snd, rcv)
    return out


# -- fleet observability (mp4j-fleet) ------------------------
# The cross-job fleet poller (obs/fleet.py) scrapes N job masters'
# /metrics.json + /health.json control surfaces on a cadence. These
# knobs configure the SCRAPER, not the jobs: they live on the machine
# running `mp4j-scope fleet`, so unlike the transport knobs above they
# carry no job-wide-agreement requirement.
DEFAULT_FLEET_POLL_SECS = 2.0
DEFAULT_FLEET_STALE_SECS = 10.0


def fleet_poll_secs() -> float:
    """Fleet poller sweep period (``MP4J_FLEET_POLL_SECS``); must be
    positive — the poller is stopped by exiting it, not by a zero
    period."""
    return env_float("MP4J_FLEET_POLL_SECS", DEFAULT_FLEET_POLL_SECS,
                     minimum=0.05)


def fleet_stale_secs() -> float:
    """Seconds without a successful scrape before a job's fleet state
    degrades ``LIVE -> STALE`` (``MP4J_FLEET_STALE_SECS``); ``GONE``
    follows at 3x this bound (obs.fleet.GONE_FACTOR). Must exceed the
    poll period in practice or every job flaps STALE between sweeps —
    the floor only guards nonsense values."""
    return env_float("MP4J_FLEET_STALE_SECS", DEFAULT_FLEET_STALE_SECS,
                     minimum=0.1)


def fleet_sink_dir() -> str:
    """The fleet poller's durable history directory
    (``MP4J_FLEET_SINK_DIR``); empty disables the fleet sink.
    Validated like ``MP4J_SINK_DIR`` (must not name an existing
    regular file); creation happens lazily at the first append."""
    raw = os.environ.get("MP4J_FLEET_SINK_DIR", "").strip()
    if raw and os.path.isfile(raw):
        raise Mp4jError(
            f"MP4J_FLEET_SINK_DIR={raw!r} names an existing regular "
            "file, not a directory")
    return raw


def fault_plan_spec() -> str:
    """The raw ``MP4J_FAULT_PLAN`` grammar string ('' disables
    injection); parsed and validated by
    :func:`ytk_mp4j_tpu_torch.resilience.faults.FaultPlan.parse`."""
    return os.environ.get("MP4J_FAULT_PLAN", "").strip()


def algo_thresholds() -> tuple[int, int]:
    """(small, large) byte thresholds for ``algo="auto"``; validated
    jointly: small must not exceed large or the medium regime would be
    empty in a surprising order-dependent way."""
    small = env_bytes("MP4J_ALGO_SMALL_BYTES", DEFAULT_ALGO_SMALL_BYTES,
                      minimum=0)
    large = env_bytes("MP4J_ALGO_LARGE_BYTES", DEFAULT_ALGO_LARGE_BYTES,
                      minimum=0)
    if small > large:
        raise Mp4jError(
            f"MP4J_ALGO_SMALL_BYTES={small} exceeds "
            f"MP4J_ALGO_LARGE_BYTES={large}")
    return small, large


def select_allreduce_algo(nbytes: int, n: int, small: int,
                          large: int) -> str:
    """The ``algo="auto"`` rule for allreduce: binomial tree for
    latency-bound small payloads, recursive halving/doubling for the
    middle, pipelined ring for bandwidth-bound large payloads. A pure
    function of (payload bytes, rank count, thresholds) — never of any
    rank-local state."""
    if n <= 2:
        # at n=2 RHD degenerates to the single optimal pairwise
        # exchange; tree/ring only add rounds
        return "rhd"
    if nbytes <= small:
        return "tree"
    if nbytes >= large:
        return "ring"
    return "rhd"


def select_twolevel(host_sizes: list[int]) -> bool:
    """Whether ``algo="auto"`` should take the topology-aware two-level
    schedule (intra-host reduce over shm -> one inter-host exchange per
    host leader -> intra-host broadcast): true exactly when there are
    MULTIPLE hosts and at least one host co-locates ranks — otherwise
    the flat schedule is already optimal (single host: every pair rides
    shm anyway; one rank per host: there is no intra level). A pure
    function of the roster-derived host grouping (identical on every
    rank — mp4j-lint R1/R8 discipline)."""
    return len(host_sizes) > 1 and any(s > 1 for s in host_sizes)


def select_partitioned_algo(nbytes: int, n: int, small: int,
                            large: int) -> str:
    """``algo="auto"`` for reduce_scatter / allgather: rooted binomial
    tree composition below the latency threshold, ring otherwise (the
    ring is both the medium and large choice — it is bandwidth-optimal
    and these collectives have no halving/doubling variant)."""
    if nbytes <= small and n > 2:
        return "tree"
    return "ring"


def chunk_ranges(total: int, itemsize: int,
                 chunk_bytes_: int) -> list[tuple[int, int]]:
    """Element ranges ``[(s, e), ...]`` splitting ``total`` elements
    into pipeline chunks of ~``chunk_bytes_`` bytes. Pure function of
    its arguments (mp4j-lint R8: a chunk schedule must never depend on
    rank-local state). ``total == 0`` yields no chunks."""
    if total <= 0:
        return []
    per = max(1, chunk_bytes_ // max(1, itemsize))
    return [(s, min(s + per, total)) for s in range(0, total, per)]
