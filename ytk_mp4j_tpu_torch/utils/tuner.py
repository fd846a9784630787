"""mp4j-tuner — the self-tuning data plane's policy core.

A copy of ``ytk_mp4j_tpu/utils/tuner.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

The repo's observability planes *measure* everything (per-link wire
seconds with transport attribution, critical-path dominators, content
digests) but until this module the transport *decided* statically: one
job-wide ``MP4J_CHUNK_BYTES``, compression fixed by the operand, host
leaders fixed by roster order. This module closes the observe→decide
loop with PURE FUNCTIONS over rolling stats windows — no sockets, no
threads, no clocks — so the whole decision surface is unit-testable
and replayable:

- :func:`decide_link` — per-link ``(chunk_bytes, compress)`` decisions
  from the link's windowed wire GB/s and observed compression ratio,
  with hysteresis (:data:`SUSTAIN_WINDOWS` consecutive agreeing
  windows before any change) so scheduler noise can never flap a
  knob;
- :func:`decide_leaders` — on a two-level
  topology, a host leader whose LINK persistently dominates the
  critical path (the health engine's online dominator rows, cause
  ``link->L over ...``) is demoted in favor of the next co-located
  rank; the master applies the override through a fenced topology
  update so every rank switches at the same collective boundary;
- :class:`LinkTuner` — the thin per-slave state holder: snapshot
  diffing, per-link hysteresis state, the pending-decision queue the
  slave drains at outermost-collective boundaries, and the audit
  trip (divergence ⇒ back to static defaults, adaptation frozen).

Safety argument (why per-link decisions cannot desync a pair):

- **compression** is receiver-auto-detected by frame tag on the
  framed plane (the only plane these decisions touch — the raw plane
  stays governed by the job-wide ``operand.compress``/``_raw_ok``
  rule), so a sender-side per-link choice is always decodable;
- **chunk size** shapes only the local exchange granularity of a
  byte-stream transport (TCP, or a frame-routed shm stream) — chunk
  boundaries never travel on the wire. Links with shm traffic are
  EXCLUDED from chunk decisions: there the raw plane's per-exchange
  ring/carrier routing makes the schedule part of the wire contract
  (mp4j-lint R8's reasoning, honored by construction);
- **application timing**: decisions queue and apply only at
  outermost-collective boundaries (the slave's recovery wrapper),
  never mid-collective — the same fence discipline the autoscaler
  uses.

Numeric thresholds for transport decisions live HERE or in
:mod:`ytk_mp4j_tpu_torch.utils.tuning` — nowhere else (mp4j-lint R22, the
knob-drift rule this PR adds).
"""

from __future__ import annotations

import threading

# -- policy constants (the sanctioned literal home, mp4j-lint R22) ----
# evidence floors: a window must move this much before it counts
MIN_WINDOW_BYTES = 256 * 1024
MIN_COMP_BYTES = 64 * 1024
# hysteresis: consecutive agreeing windows before a decision commits
SUSTAIN_WINDOWS = 3
# compression policy (probe/measure — see decide_link): the effective
# PAYLOAD throughput of a compressed stream is zlib-bound, so it says
# nothing about the raw link speed; the policy therefore PROBES
# (compress off for a sustained verdict), measures the plain link
# rate, and keeps whichever mode moves more payload per second.
KEEP_OFF_FACTOR = 1.2      # plain must beat compressed by 20% to stay
COMPRESS_ON_GBS = 0.08     # a link this slow + a good ratio: turn on
RATIO_GOOD = 2.0
EWMA_ALPHA = 0.5           # window-rate smoothing
# chunk policy bounds and triggers: adapt toward the link's observed
# BULK transfer size (booked by the collective engine per exchange),
# one doubling/halving per sustained verdict
CHUNK_MIN = 256 * 1024
CHUNK_MAX = 8 * 1024 * 1024
CHUNK_TARGET_DIV = 4       # target chunk ~ avg transfer / 4
# leader demotion: fraction of the recent dominator window one
# leader's LINK must gate (slow rows only) before demotion
LEADER_WINDOW = 16
LEADER_SHARE = 0.75
# socket-buffer policy: on a sustained-bulk tcp link whose
# applied sndbuf/rcvbuf sit below the observed bandwidth-delay
# product, raise them toward it — one doubling per sustained verdict,
# raise-only (shrinking buffers under load thrashes the kernel), and
# capped. RTT is not measured per link; SOCKBUF_RTT_S is the assumed
# in-flight window a bulk stream must cover (1 ms spans same-DC hops;
# loopback links simply never sustain a BDP above their buffers).
SOCKBUF_RTT_S = 1e-3
SOCKBUF_BULK_BYTES = 4 * 1024 * 1024   # window floor to call it bulk
SOCKBUF_MAX = 8 * 1024 * 1024


# -- roster topology (shared with comm + master) ----------------------
def host_groups(roster) -> list[list[int]]:
    """Rank groups sharing a host fingerprint, ordered by first
    appearance; each group ascending (``group[0]`` is the DEFAULT host
    leader — the smallest rank on that host). Fingerprint-less entries
    become singleton groups. Pure function of the shared roster — the
    one topology derivation the slave (`_set_roster`) and the master's
    tuner controller both use, so they can never disagree."""
    groups: dict[str, list[int]] = {}
    singles: list[list[int]] = []
    for rank, entry in enumerate(roster):
        fp = entry[2] if len(entry) > 2 else ""
        if fp:
            groups.setdefault(fp, []).append(rank)
        else:
            singles.append([rank])
    out = list(groups.values()) + singles
    out.sort(key=lambda g: g[0])
    return out


def leaders_for(groups: list[list[int]],
                overrides: dict[int, int] | None) -> list[int]:
    """The effective per-group leader list: the default (smallest
    rank) unless a validated override names another MEMBER of that
    group. Invalid overrides (stale group index, rank not in the
    group — e.g. after a membership change) fall back to the default,
    never to an arbitrary rank."""
    leaders = []
    for i, g in enumerate(groups):
        cand = (overrides or {}).get(i)
        leaders.append(cand if cand in g else g[0])
    return leaders


# -- per-link decision policy -----------------------------------------
def initial_state() -> dict:
    """One link's hysteresis state: the committed decision fields, the
    pending-proposal ladder, and the probe bookkeeping (smoothed
    payload rates per mode)."""
    return {"compress": None, "chunk_bytes": None,
            "pend_key": None, "pend_n": 0,
            "probing": False, "comp_gbs": None, "plain_gbs": None}


# the monotone accumulator keys a window diffs; anything else in a
# link snapshot (applied so_sndbuf/so_rcvbuf, the transport tag) is a
# FACT and passes through at its current value
_COUNTER_KEYS = frozenset({
    "bytes", "secs", "frames", "bytes_tcp", "bytes_shm",
    "comp_raw", "comp_wire", "comp_frames", "xfer_bytes", "xfers"})


def link_delta(cur: dict[int, dict], prev: dict[int, dict]
               ) -> dict[int, dict]:
    """Window = ``cur - prev`` per link over the monotone accumulator
    keys (:data:`_COUNTER_KEYS`); non-counter facts — applied socket
    buffer sizes, the transport tag — pass through from ``cur`` at
    their absolute values."""
    out: dict[int, dict] = {}
    for peer, entry in cur.items():
        base = prev.get(peer, {})
        delta = {}
        for k, v in entry.items():
            if k in _COUNTER_KEYS:
                delta[k] = v - base.get(k, 0)
            else:
                delta[k] = v
        if delta.get("bytes") or delta.get("comp_raw"):
            out[peer] = delta
    return out


def _ewma(old: float | None, new: float) -> float:
    return new if old is None else old + EWMA_ALPHA * (new - old)


def _proposals(delta: dict, state: dict, default_chunk: int) -> dict:
    """The raw (un-hysteresed) verdicts one window supports:
    ``{"compress": bool}`` and/or ``{"chunk_bytes": int}`` — empty
    when the evidence is insufficient or already matches. MUTATES
    ``state``'s rate bookkeeping (the caller owns the copy).

    Compression is a PROBE/MEASURE cycle because a compressed
    stream's wire seconds hide the raw link speed (the receiver's
    read blocks on the sender's zlib): while compressing, the policy
    records the effective PAYLOAD rate (raw bytes per wire second)
    and — lacking any plain-traffic baseline — proposes a probe
    (compress off). Once plain traffic flows it keeps whichever mode
    moved more payload per second: a loopback/shm-class link beats
    the zlib bound by an order of magnitude and stays uncompressed;
    a genuinely slow link loses the comparison and reverts within
    one window."""
    out: dict = {}
    bytes_ = float(delta.get("bytes") or 0)
    secs = float(delta.get("secs") or 0.0)
    comp_raw = float(delta.get("comp_raw") or 0)
    comp_wire = float(delta.get("comp_wire") or 0)
    cur = state.get("compress")
    # effective payload rate: compressed wire bytes count at their
    # RAW size (that is what the application actually moved)
    payload = bytes_ - comp_wire + comp_raw
    if secs > 0 and payload >= MIN_WINDOW_BYTES:
        pg = payload / secs / 1e9
        if comp_raw >= MIN_COMP_BYTES:
            state["comp_gbs"] = _ewma(state.get("comp_gbs"), pg)
            if comp_wire > 0:
                # remembered ratio: the re-enable rule below needs it
                # AFTER a committed compress=False has suppressed all
                # compressed evidence
                state["ratio"] = comp_raw / comp_wire
            if state.get("plain_gbs") is None and cur is None:
                # no plain baseline and no committed decision yet:
                # propose the probe. cur=False is excluded — in
                # observe mode nothing applies, so compressed
                # evidence keeps flowing after the commit and the
                # probe would re-commit (and re-log) forever
                out["compress"] = False
            elif (state.get("plain_gbs") is not None
                  and state["plain_gbs"] < COMPRESS_ON_GBS
                  and comp_wire > 0
                  and comp_raw / comp_wire >= RATIO_GOOD
                  and cur is not True):
                out["compress"] = True
        else:
            state["plain_gbs"] = _ewma(state.get("plain_gbs"), pg)
            comp_g = state.get("comp_gbs")
            if state.get("probing") and comp_g is not None:
                if pg >= comp_g * KEEP_OFF_FACTOR:
                    # probe verdict: the plain link wins — stay off
                    # (already committed off; just end the probe)
                    state["probing"] = False
                else:
                    # probe failed: the link is genuinely slow enough
                    # that compression paid — revert NOW (one window,
                    # not SUSTAIN: a failed probe must not linger)
                    state["probing"] = False
                    out["compress"] = True
                    out["_revert"] = True
            elif (cur is False
                  and pg < COMPRESS_ON_GBS
                  and (state.get("ratio") or 0.0) >= RATIO_GOOD):
                # a committed compress=False is not a life sentence:
                # the decision itself suppresses compressed evidence,
                # so re-enable from the REMEMBERED ratio when the
                # plain link degrades into the regime where the zlib
                # trade pays (normal SUSTAIN hysteresis applies)
                out["compress"] = True
    # chunk size: adapt toward the observed BULK transfer size —
    # EXCEPT on links with shm traffic, where the raw plane's
    # per-exchange ring/carrier routing makes the chunk schedule part
    # of the wire contract (see module docstring)
    if not delta.get("bytes_shm"):
        xfers = float(delta.get("xfers") or 0)
        xbytes = float(delta.get("xfer_bytes") or 0)
        cur_chunk = state.get("chunk_bytes") or default_chunk
        if xfers > 0 and xbytes >= MIN_WINDOW_BYTES:
            target = xbytes / xfers / CHUNK_TARGET_DIV
            if target >= cur_chunk * 2 and cur_chunk * 2 <= CHUNK_MAX:
                out["chunk_bytes"] = cur_chunk * 2
            elif target <= cur_chunk // 2 \
                    and cur_chunk // 2 >= CHUNK_MIN:
                out["chunk_bytes"] = cur_chunk // 2
    # socket buffers: a sustained-bulk tcp link whose applied buffers
    # sit below the observed bandwidth-delay product cannot keep its
    # pipe full — raise toward the BDP, one doubling per sustained
    # verdict, raise-only, capped (SOCKBUF_MAX). The applied sizes are
    # FACTS in the window (note_link re-reads them after every apply),
    # so the ladder converges and never flaps.
    if (delta.get("transport") == "tcp" and not delta.get("bytes_shm")
            and secs > 0 and bytes_ >= SOCKBUF_BULK_BYTES):
        bdp = bytes_ / secs * SOCKBUF_RTT_S
        for key in ("so_sndbuf", "so_rcvbuf"):
            cur_buf = int(delta.get(key) or 0)
            if cur_buf and cur_buf < SOCKBUF_MAX \
                    and bdp >= cur_buf * 2:
                out[key] = min(SOCKBUF_MAX, cur_buf * 2)
    return out


def decide_link(delta: dict, state: dict, default_chunk: int
                ) -> tuple[dict, dict | None]:
    """Fold one window into a link's hysteresis state; returns
    ``(new_state, decision_or_None)``. A decision only emerges after
    :data:`SUSTAIN_WINDOWS` consecutive windows propose the SAME
    change (the pending ladder resets on any disagreement) — except a
    failed compression probe, which reverts in ONE window — and the
    emitted decision is the link's full committed record
    ``{"compress": ..., "chunk_bytes": ...}``, idempotent to apply."""
    state = dict(state)
    props = _proposals(delta, state, default_chunk)
    revert_now = props.pop("_revert", False)
    if not props:
        state["pend_key"], state["pend_n"] = None, 0
        return state, None
    key = tuple(sorted(props.items()))
    if key == state.get("pend_key"):
        state["pend_n"] += 1
    else:
        state["pend_key"], state["pend_n"] = key, 1
    if not revert_now and state["pend_n"] < SUSTAIN_WINDOWS:
        return state, None
    state["pend_key"], state["pend_n"] = None, 0
    state.update(props)
    if props.get("compress") is False:
        # the commit that starts (or continues) the probe phase
        state["probing"] = state.get("plain_gbs") is None
    decision = {"compress": state["compress"],
                "chunk_bytes": state["chunk_bytes"]}
    for k in ("so_sndbuf", "so_rcvbuf"):
        if state.get(k):
            decision[k] = state[k]
    return state, decision


# -- leader demotion policy ----------------------------------------
def decide_leaders(rows: list[dict], groups: list[list[int]],
                   overrides: dict[int, int] | None,
                   window: int = LEADER_WINDOW,
                   share: float = LEADER_SHARE) -> dict[int, int] | None:
    """Consult the rolling critpath dominator rows (``{seq, dom,
    cause, slow}`` — the health engine's online attribution) and
    demote a host leader whose LINK persistently gates the critical
    path: in the last ``window`` attributed ordinals, SLOW rows whose
    cause is ``link->L ...`` with ``L`` the effective leader of a
    multi-member host group must hold at least ``share`` of the
    window. Returns the new override map (existing overrides
    preserved; the demoted group's leadership rotates to the next
    member, cyclically, so repeated demotions try every co-located
    rank) — or ``None`` when no demotion is warranted."""
    win = rows[-window:]
    if len(win) < window:
        return None
    leaders = leaders_for(groups, overrides)
    votes: dict[int, int] = {}
    for row in win:
        if not row.get("slow"):
            continue
        cause = str(row.get("cause") or "")
        if not cause.startswith("link->"):
            continue
        dom = int(row.get("dom", -1))
        # belt-and-braces: critpath constructs the cause as
        # f"link->{dominator}", so the named link target IS the
        # dominator — but the demotion predicate is "THIS rank's
        # link gates", so verify the name rather than trusting the
        # format never drifts
        target = cause[len("link->"):].split(" ", 1)[0]
        if not target.isdigit() or int(target) != dom:
            continue
        votes[dom] = votes.get(dom, 0) + 1
    for dom, n in sorted(votes.items(), key=lambda kv: -kv[1]):
        if n / len(win) < share:
            continue
        for gi, g in enumerate(groups):
            if leaders[gi] == dom and len(g) > 1:
                nxt = g[(g.index(dom) + 1) % len(g)]
                new = dict(overrides or {})
                new[gi] = nxt
                return new
    return None


# -- the per-slave state holder ---------------------------------------
class LinkTuner:
    """Per-slave tuner state around the pure policy core: snapshot
    diffing, per-link hysteresis, the pending-decision queue drained
    at outermost-collective boundaries, and the trip latch. Holds no
    sockets and no threads of its own — the slave's heartbeat thread
    calls :meth:`observe`, its collective thread calls
    :meth:`take_pending`; one lock arbitrates."""

    def __init__(self, mode: str, default_chunk: int,
                 so_buf_map: dict[int, tuple[int, int]] | None = None):
        self.mode = mode                      # "observe" | "act"
        self.default_chunk = int(default_chunk)
        self.so_buf_map = dict(so_buf_map or {})
        self.tripped: str | None = None       # why, once tripped
        self.decisions_total = 0              # committed (or would-be)
        self._lock = threading.Lock()
        self._prev: dict[int, dict] = {}
        self._states: dict[int, dict] = {}
        self._pending: dict[int, dict] = {}   # peer -> decision
        self._applied: dict[int, dict] = {}   # peer -> decision live
        self._revert = False                  # trip: clear at boundary

    # -- heartbeat side ------------------------------------------------
    def observe(self, links: dict[int, dict]) -> list[tuple[int, dict]]:
        """Fold one stats window; returns the decisions that COMMITTED
        this window (for logging/telemetry). In ``act`` mode they also
        queue for boundary application; in ``observe`` mode they are
        recorded only."""
        out: list[tuple[int, dict]] = []
        with self._lock:
            delta = link_delta(links, self._prev)
            self._prev = links
            if self.tripped is not None:
                return out
            for peer, d in delta.items():
                st = self._states.get(peer) or initial_state()
                st, decision = decide_link(d, st, self.default_chunk)
                self._states[peer] = st
                if decision is not None:
                    self.decisions_total += 1
                    out.append((peer, decision))
                    if self.mode == "act":
                        self._pending[peer] = decision
        return out

    # -- collective-boundary side --------------------------------------
    @property
    def dirty(self) -> bool:
        """Cheap hot-path check: anything to apply at this boundary?"""
        return bool(self._pending) or self._revert

    def take_pending(self) -> tuple[dict[int, dict], bool]:
        """Drain ``(decisions, revert_all)`` for boundary application;
        the applied map updates optimistically (the caller IS about to
        apply them)."""
        with self._lock:
            pending, self._pending = self._pending, {}
            revert, self._revert = self._revert, False
            if revert:
                self._applied.clear()
            self._applied.update(pending)
            return pending, revert

    def reset(self) -> None:
        """Membership change (replacement, shrink renumbering, grow):
        every per-link accumulator, hysteresis state and committed
        decision is evidence about the OLD rank numbering — a
        renumbered (or replaced) peer id must not inherit the old
        occupant's adaptation. The trip latch SURVIVES: a job whose
        data plane produced a divergence stays on static defaults
        through membership churn too."""
        with self._lock:
            self._prev = {}
            self._states.clear()
            self._pending.clear()
            self._applied.clear()
            self._revert = False

    # -- safety rails --------------------------------------------------
    def trip(self, why: str) -> None:
        """Audit divergence under adaptation: freeze the policy and
        schedule a revert to static defaults at the next boundary.
        Tripping is latched for the job's lifetime — a data plane that
        produced one cross-rank divergence has forfeited the benefit
        of the doubt."""
        with self._lock:
            if self.tripped is not None:
                return
            self.tripped = str(why)[:300]
            self._pending.clear()
            self._states.clear()
            self._revert = True

    def effective_compress(self, peer: int, requested: bool) -> bool:
        """The framed plane's per-link compression choice: the
        committed decision when one is live, else the operand's
        request. Lock-free read of an atomically swapped dict — the
        hot path pays one ``dict.get``."""
        d = self._applied.get(peer)
        if d is None or d.get("compress") is None:
            return requested
        return bool(d["compress"])

    def effective_chunk(self, peer: int, default: int) -> int:
        d = self._applied.get(peer)
        if d is None or not d.get("chunk_bytes"):
            return default
        return int(d["chunk_bytes"])

    def status(self) -> dict:
        """The telemetry document (heartbeat ``tuner`` field /
        ``mp4j-scope tuner``)."""
        with self._lock:
            return {
                "mode": self.mode,
                "tripped": self.tripped,
                "decisions_total": self.decisions_total,
                "pending": len(self._pending),
                "applied": {int(p): dict(d)
                            for p, d in self._applied.items()},
            }
