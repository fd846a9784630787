"""mp4j-autopilot — the closed-loop elastic autoscaler.

A copy of ``ytk_mp4j_tpu/resilience/autoscaler.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

The membership layer is the MECHANISM (adopt a warm spare into a rank
id, bit-exact) and the health plane is the DECISION substrate
(``Master.health_status()`` per-rank verdicts, with
``MP4J_HEALTH_DOMINATOR_ORDINALS`` driving ``EVICT_RECOMMENDED``).
This module is the ACTING side the ROADMAP names: a master-owned
controller that reads the verdicts and drives the membership machinery
— turning elastic membership from a failure-recovery feature into a
self-healing substrate. Four actions:

1. **Planned eviction / replace** (``evict_replace``): a rank the
   health plane marks ``EVICT_RECOMMENDED`` — but which is still
   *alive* — is proactively replaced at the next collective boundary:
   :meth:`Master.request_planned_evict` quiesces the job through the
   epoch-fenced abort round, adopts a spare into the slow rank's id
   via the existing manifest path, and releases the evicted rank with
   a clean :class:`~ytk_mp4j_tpu_torch.exceptions.Mp4jEvicted`.
2. **Spare auto-provisioning** (``provision``): when
   ``mp4j_spares_available`` hits 0 the operator hook fires —
   ``Master(provision_hook=)`` (a callable) or ``MP4J_PROVISION_CMD``
   (a shell command run with ``MP4J_MASTER_HOST``/``MP4J_MASTER_PORT``
   in its environment) — to spawn a fresh ``spare=True`` process.
3. **Grow** (``grow``): under ``MP4J_ELASTIC=grow`` the master adopts
   registered spares into NEW rank ids when every rank reaches an
   explicit app epoch boundary (``ProcessCommSlave.resize_point()``).
   The app paces this action; the controller only gates it
   (:meth:`Autoscaler.approve_grow`) behind the same safety rails.
4. **Safety rails** — the robustness heart, all enforced in
   :func:`gate` (a pure function, testable without sockets):
   per-action cooldowns (``MP4J_AUTOSCALE_COOLDOWN_SECS``), a
   job-lifetime action budget (``MP4J_AUTOSCALE_BUDGET``), ONE action
   in flight at a time, an audit-green precondition (no action while
   the cross-rank digest grid holds unresolved divergence), the
   ``MP4J_AUTOSCALE=off|observe|act`` ladder (``observe`` logs every
   would-be action without acting), and a **circuit breaker**: two
   consecutive failed actions (adoption timeout burning the pool,
   eviction/grow round abort, provision that never registers) trip the
   controller back to recommend-only with a structured alert —
   degraded advice is strictly safer than a flapping actuator.

It also does **load-following** over the serve plane
(:func:`decide_load`): ``serve_shrink`` when serve QPS stays under
``MP4J_SERVE_IDLE_QPS`` for ``MP4J_SERVE_IDLE_SECS`` straight,
``serve_grow`` (pace a spare in at the app's next ``resize_point()``)
when QPS crosses ``MP4J_SERVE_BUSY_QPS`` with spares registered. Both
ship OBSERVE-FIRST: they ride the gate (pacing) and the alert pipe,
and never the actuator — even under ``act`` — until the
recommendations prove out in the field.

The policy core — :func:`decide`, :func:`gate`, :func:`resolve_pending`
— is pure functions over ``health_status()`` / ``membership_status()``
/ ``audit_status()`` snapshots (the health-engine convention: tests
drive them without sockets). :class:`Autoscaler` is the thin stateful
shell: a control thread that samples the master's documents, runs the
policy, and executes — waking on an ``Event`` (mp4j-lint R18: a
sleeping controller could neither shut down promptly nor notice its
own trip).

Lock discipline: the controller NEVER holds its own lock while calling
into the master (the master's document methods take the master lock,
and the master renders :meth:`status` into its metrics document while
holding it — holding both in the other order would deadlock).

Every action (and every trip) lands everywhere at once, the repo
precedent: master log, the subject rank's recovery log and durable
sink (via the ``health_alert`` control push — ``mp4j-scope health``
timelines interleave actions with verdict transitions), Prometheus
(``mp4j_autoscale_actions_total{action}``, ``mp4j_autoscale_tripped``),
``mp4j-scope live``'s ``autoscale:`` head-line, and the postmortem
manifest's autoscaler section.
"""

from __future__ import annotations

import collections
import os
import socket
import subprocess
import threading
import time

from ytk_mp4j_tpu_torch.utils import tuning

# the controller's action vocabulary (the Prometheus `action` label).
# serve_shrink / serve_grow are the load-following pair:
# OBSERVE-FIRST by design — even under MP4J_AUTOSCALE=act they route
# through the alert pipe only, never the actuator, until the
# recommendations prove trustworthy in the field
ACTIONS = ("evict_replace", "provision", "grow",
           "serve_shrink", "serve_grow")

# how long a dispatched action may stay pending before it counts as
# FAILED, as a multiple of the adoption deadline (the slowest step an
# action waits on is a spare acking its adoption; one retry spare is
# in budget before the controller calls it)
_DEADLINE_ADOPTS = 2.5
_DEADLINE_FLOOR = 5.0


def _wall() -> float:
    # autoscaler events ride the same durable alert pipe as health
    # alerts and are rendered in cross-host timelines next to them
    # mp4j-lint: disable=R11 (artifact timestamp, not a duration)
    return time.time()


class ControllerState:
    """The controller's mutable ledger — plain fields so the pure
    policy functions can read it like a snapshot. Owned by
    :class:`Autoscaler` under its lock; tests build one directly."""

    def __init__(self):
        self.actions: dict[str, int] = {a: 0 for a in ACTIONS}
        self.observed: dict[str, int] = {a: 0 for a in ACTIONS}
        self.failures: dict[str, int] = {a: 0 for a in ACTIONS}
        self.retried: dict[str, int] = {a: 0 for a in ACTIONS}
        self.last_action: dict[str, float] = {}   # action -> mono ts
        self.budget_used = 0
        self.consecutive_failures = 0
        self.tripped = False
        self.tripped_why = ""
        # the ONE in-flight action: {"action", "rank"?, "since" (mono),
        # "deadline" (mono), "baseline" (membership counter snapshot)}
        self.pending: dict | None = None
        # monotonic instant the serve plane's QPS first dipped under
        # the idle threshold; None while busy (load-following hysteresis)
        self.serve_idle_since: float | None = None
        self.events: collections.deque = collections.deque(maxlen=64)


def audit_green(audit: dict | None) -> bool:
    """The audit-green precondition: the cross-rank digest grid holds
    ZERO divergences. A divergence means some rank's content is
    suspect — acting on membership while the data plane may be
    corrupt can launder corruption into a 'recovered' roster."""
    return not audit or int(audit.get("divergences", 0) or 0) == 0


def gate(state: ControllerState, now: float, action: str, *,
         cooldown_secs: float, budget: int,
         audit: dict | None) -> tuple[bool, str]:
    """Whether ``action`` may fire NOW — every safety rail in one pure
    function. Returns ``(allowed, reason)``; the reason names the
    specific rail so observe-mode logs read like a decision trace.
    The breaker is checked LAST: a tripped controller still runs the
    pacing rails (cooldown/pending/budget) so its recommend-only
    would-act trace stays paced instead of firing every tick."""
    if state.pending is not None:
        return False, (f"action '{state.pending.get('action')}' still "
                       "in flight (one at a time)")
    if state.budget_used >= budget:
        return False, (f"job-lifetime action budget exhausted "
                       f"({state.budget_used}/{budget})")
    last = state.last_action.get(action)
    if last is not None and now - last < cooldown_secs:
        return False, (f"cooldown: last '{action}' "
                       f"{now - last:.1f}s ago "
                       f"(< {cooldown_secs:.1f}s)")
    if not audit_green(audit):
        return False, ("audit divergence unresolved "
                       f"({int((audit or {}).get('divergences', 0))} "
                       "flagged) — no membership action while content "
                       "is suspect")
    if state.tripped:
        return False, ("circuit breaker tripped (recommend-only): "
                       + state.tripped_why)
    return True, ""


def decide(health: dict | None, membership: dict | None,
           *, provisionable: bool) -> list[dict]:
    """The policy core: what the controller WANTS to do, given the
    verdict and membership documents — before any safety rail. Pure
    function; the master's :meth:`request_planned_evict` re-validates
    everything under its lock (single source of truth), so a stale
    snapshot here costs a refused request, never a wrong action.

    Returns proposals ``[{"action", "rank"?, "why"}, ...]``, most
    urgent first. ONE eviction per tick (lowest recommended rank):
    serial actions keep every intermediate state observable."""
    out: list[dict] = []
    ms = membership or {}
    mode = ms.get("mode", "off")
    spares = int(ms.get("spares_available", 0) or 0)
    if mode in ("replace", "grow"):
        evict = sorted(int(r) for r in
                       (health or {}).get("evict_recommended") or ())
        if evict and spares >= 1:
            rank = evict[0]
            ev = ((health or {}).get("ranks") or {}).get(str(rank), {})
            out.append({
                "action": "evict_replace", "rank": rank,
                "why": (f"health verdict EVICT_RECOMMENDED: "
                        f"{ev.get('why') or 'sustained pressure'}")})
        if spares == 0 and provisionable:
            out.append({
                "action": "provision",
                "why": "warm-spare pool drained to 0"})
    return out


def decide_load(serve: dict | None, membership: dict | None,
                idle_since: float | None, now: float, *,
                idle_qps: float, busy_qps: float,
                idle_secs: float) -> tuple[list[dict], float | None]:
    """The load-following policy over the serve plane —
    pure, like :func:`decide`. Two proposals:

    - ``serve_shrink`` when the inference plane's QPS has stayed at or
      under ``idle_qps`` for ``idle_secs`` straight (the sustained-idle
      window is the hysteresis: a single quiet scrape proposes
      nothing);
    - ``serve_grow`` the moment QPS reaches ``busy_qps`` while warm
      spares are registered — growth happens at the app's next
      :meth:`resize_point`, so the proposal is the *recommendation to
      pace one in*, not an adoption.

    Returns ``(proposals, new_idle_since)``; the caller stores the
    second element back into :class:`ControllerState` — the function
    itself owns no clock and no state."""
    if not serve or not serve.get("active"):
        return [], None
    qps = float(serve.get("qps", 0.0) or 0.0)
    if qps >= busy_qps:
        out = []
        if int((membership or {}).get("spares_available", 0) or 0) > 0:
            out.append({
                "action": "serve_grow",
                "why": (f"serve QPS {qps:.1f} >= busy threshold "
                        f"{busy_qps:.1f} — pace a spare in at the "
                        "next resize_point()")})
        return out, None
    if qps > idle_qps:
        return [], None
    if idle_since is None:
        return [], now
    if now - idle_since >= idle_secs:
        return [{
            "action": "serve_shrink",
            "why": (f"serve QPS {qps:.1f} <= idle threshold "
                    f"{idle_qps:.1f} for {now - idle_since:.0f}s — "
                    "the replica set is over-provisioned")}], idle_since
    return [], idle_since


def resolve_pending(pending: dict, membership: dict | None,
                    now: float) -> tuple[str, str]:
    """Resolve the in-flight action against the latest membership
    document: ``("ok", detail)`` when the matching success event
    landed after dispatch, ``("failed", detail)`` on a matching abort
    event or a blown deadline, ``("pending", "")`` otherwise. Pure
    function of its inputs."""
    action = pending.get("action")
    since = float(pending.get("since", 0.0))
    for ev in reversed((membership or {}).get("events") or []):
        if float(ev.get("mono", 0.0)) < since:
            break
        kind = ev.get("kind")
        if action == "evict_replace":
            if (kind == "planned_evict"
                    and ev.get("rank") == pending.get("rank")):
                return "ok", (f"rank {ev.get('rank')} evicted and "
                              f"replaced from spare #{ev.get('spare')}"
                              f" @ epoch {ev.get('epoch')}")
            if (kind == "evict_abort"
                    and pending.get("rank") in (ev.get("ranks") or ())):
                return "failed", (f"eviction round aborted: "
                                  f"{ev.get('why')}")
            if (kind == "evict_fence_cancel"
                    and ev.get("rank") == pending.get("rank")):
                # the fence canceled before anything was torn down —
                # zero disruption, so this is a benign RETRY (budget
                # refunded), never a breaker failure
                return "retry", (f"eviction fence canceled: "
                                 f"{ev.get('why')}")
        elif action == "grow":
            if kind == "grow":
                return "ok", (f"grew by rank(s) {ev.get('ranks')} "
                              f"@ resize {ev.get('gen')}")
            if kind == "grow_abort":
                return "failed", f"grow aborted: {ev.get('why')}"
            if kind == "grow_cancel":
                # dropped before any adoption was dispatched: benign
                return "retry", f"grow canceled: {ev.get('why')}"
        elif action == "provision":
            if kind == "spare_registered":
                # the registration event, not the pool gauge: a
                # waiting membership round may claim the fresh spare
                # synchronously, so `spares_available` can stay 0
                # through a provision that succeeded
                return "ok", (f"spare #{ev.get('spare')} registered")
    if action == "provision":
        if int((membership or {}).get("spares_available", 0) or 0) > 0:
            return "ok", "a fresh spare registered"
    if now > float(pending.get("deadline", now)):
        return "failed", (f"'{action}' not confirmed within "
                          f"{now - since:.1f}s (adoption timeout / "
                          "spare never registered)")
    return "pending", ""


class Autoscaler:
    """The controller shell around the pure policy core. Owned by the
    master; one background thread, started from ``Master._serve`` and
    stopped by the master's stop event."""

    def __init__(self, master, *, mode: str,
                 cooldown_secs: float | None = None,
                 budget: int | None = None,
                 provision_hook=None,
                 provision_cmd: str | None = None,
                 tick_secs: float = 0.25):
        self._master = master
        self.mode = mode
        self.cooldown_secs = tuning.autoscale_cooldown_secs(
            cooldown_secs)
        self.budget = tuning.autoscale_budget(budget)
        self._provision_hook = provision_hook
        self._provision_cmd = (tuning.provision_cmd()
                               if provision_cmd is None
                               else str(provision_cmd))
        self._tick = max(0.05, min(float(tick_secs), 1.0))
        self._deadline_secs = max(
            _DEADLINE_FLOOR, _DEADLINE_ADOPTS * master._adopt_secs)
        # load-following thresholds, frozen at construction
        # like the cooldown/budget knobs
        self._serve_idle_qps = tuning.serve_idle_qps()
        self._serve_busy_qps = tuning.serve_busy_qps()
        self._serve_idle_secs = tuning.serve_idle_secs()
        self._lock = threading.Lock()
        self.state = ControllerState()
        self._alert_seq = 0
        # events minted under the controller lock, dispatched OUTSIDE
        # it (the master push path and status() render compose with
        # the master lock in both orders — dispatching while holding
        # the controller lock would complete a deadlock cycle)
        self._outbox: list[tuple[dict, str]] = []
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------
    def start(self, stop: threading.Event) -> "Autoscaler":
        with self._lock:
            self._stop = stop
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="mp4j-autoscaler")
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _loop(self) -> None:
        # snapshot the stop event once under the controller lock: it
        # is published by start() on the spawning thread and never
        # rebound afterwards
        with self._lock:
            stop = self._stop
        # Event.wait, never time.sleep (mp4j-lint R18): the master's
        # stop event ends the loop within one tick, and a trip takes
        # effect on the very next evaluation
        while not stop.wait(self._tick):
            try:
                self.tick()
            # the controller must outlive any single bad tick (a
            # half-shut-down master mid-sample, a hook raising): a
            # dead controller is a silent loss of the whole plane
            # mp4j-lint: disable=R5 (controller isolation; logged)
            except Exception as e:
                try:
                    self._master._log("M", "ERROR",
                                      f"autoscale: tick failed: {e!r}")
                except Exception:
                    pass

    # -- one evaluation -------------------------------------------------
    def tick(self) -> None:
        """Sample the decision substrate, resolve the in-flight
        action, and dispatch at most one new one. Public so tests can
        single-step the controller deterministically."""
        try:
            self._tick_once()
        finally:
            self._flush_events()

    def _tick_once(self) -> None:
        m = self._master
        health = m.health_status()
        membership = m.membership_status()
        audit = m.audit_status()
        now = time.monotonic()

        with self._lock:
            st = self.state
            if st.pending is not None:
                verdict, detail = resolve_pending(
                    st.pending, membership, now)
                if verdict != "pending":
                    self._settle_locked(verdict, detail, now)
        # load-following: sample the serve section and run
        # the pure policy; proposals route through the SAME gate (so a
        # persistent verdict is one line per cooldown) and then through
        # _observe UNCONDITIONALLY — serve actions ship observe-first,
        # even in act mode (module docstring / ACTIONS comment)
        serve_fn = getattr(m, "serve_status", None)
        serve = serve_fn() if serve_fn is not None else None
        with self._lock:
            idle_since = self.state.serve_idle_since
        load_props, idle_since = decide_load(
            serve, membership, idle_since, now,
            idle_qps=self._serve_idle_qps,
            busy_qps=self._serve_busy_qps,
            idle_secs=self._serve_idle_secs)
        with self._lock:
            self.state.serve_idle_since = idle_since
        for prop in load_props:
            with self._lock:
                allowed, _ = gate(
                    self.state, now, prop["action"],
                    cooldown_secs=self.cooldown_secs,
                    budget=self.budget, audit=audit)
            if allowed:
                self._observe(prop["action"], prop, now)
        provisionable = (self._provision_hook is not None
                         or bool(self._provision_cmd))
        for prop in decide(health, membership,
                           provisionable=provisionable):
            action = prop["action"]
            with self._lock:
                allowed, why_not = gate(
                    self.state, now, action,
                    cooldown_secs=self.cooldown_secs,
                    budget=self.budget, audit=audit)
                tripped = self.state.tripped
            if self.mode != "act" or tripped:
                # recommend-only (observe mode, or a tripped act
                # mode): log the would-be action through the full
                # alert pipe, paced by the SAME rails — a persistent
                # verdict is one line per cooldown, never per tick
                if allowed or why_not.startswith("circuit breaker"):
                    self._observe(action, prop, now)
                continue
            if not allowed:
                continue
            self._execute(action, prop, now)
            return          # one dispatch per tick, by design

    def _settle_locked(self, verdict: str, detail: str,
                       now: float) -> None:
        """Close the in-flight action (caller holds the lock); trips
        the breaker on the second consecutive failure."""
        st = self.state
        pending, st.pending = st.pending, None
        action = pending.get("action", "?")
        if verdict == "ok":
            st.consecutive_failures = 0
            self._emit_locked("action_ok", action,
                             rank=pending.get("rank"),
                             msg=detail, level="WARN")
            return
        if verdict == "retry":
            # nothing was disturbed (a canceled fence): refund the
            # budget and keep the cooldown stamp (pacing). The
            # per-action DISPATCH counter is NOT rolled back — it
            # feeds the Prometheus counter, which must stay monotone
            # (a 1 -> 0 step reads as a counter reset to rate());
            # the retried dict tells the two apart
            st.budget_used = max(0, st.budget_used - 1)
            st.retried[action] = st.retried.get(action, 0) + 1
            self._emit_locked("action_retry", action,
                             rank=pending.get("rank"), msg=detail,
                             level="WARN")
            return
        st.failures[action] = st.failures.get(action, 0) + 1
        st.consecutive_failures += 1
        self._emit_locked("action_failed", action,
                         rank=pending.get("rank"), msg=detail,
                         level="ERROR")
        if st.consecutive_failures >= 2 and not st.tripped:
            st.tripped = True
            st.tripped_why = (f"{st.consecutive_failures} consecutive "
                              f"failed action(s); last: {detail}")
            # the breaker alert is the structured headline: the
            # controller is now recommend-only for the job's lifetime
            self._emit_locked(
                "tripped", action, rank=pending.get("rank"),
                msg=("circuit breaker tripped -> recommend-only: "
                     + st.tripped_why),
                level="ERROR")

    def _observe(self, action: str, prop: dict,
                 now: float | None = None) -> None:
        """``observe`` mode (and a tripped ``act`` mode): log the
        would-be action through the full alert pipe, act on nothing.
        Stamps the cooldown like a real dispatch — a verdict that
        persists through the cooldown produces ONE line per window,
        not one per controller tick."""
        with self._lock:
            st = self.state
            st.observed[action] = st.observed.get(action, 0) + 1
            st.last_action[action] = (time.monotonic()
                                      if now is None else now)
            self._emit_locked(
                "would_act", action, rank=prop.get("rank"),
                msg=f"would {action}: {prop.get('why', '')}",
                level="WARN")

    def _execute(self, action: str, prop: dict, now: float) -> None:
        m = self._master
        if action == "evict_replace":
            rank = int(prop["rank"])
            if not m.request_planned_evict(rank, prop.get("why", "")):
                # refused (round open / spare died / rank gone since
                # the snapshot): not a failed action — the next tick
                # re-proposes from fresh documents
                return
            self._dispatched(action, prop, now, rank=rank)
        elif action == "provision":
            try:
                self._run_provision_hook()
            except Exception as e:
                # a hook that cannot even launch is an immediate
                # failure — there is nothing to wait for
                with self._lock:
                    self.state.actions[action] += 1
                    self.state.budget_used += 1
                    self.state.last_action[action] = now
                    self.state.pending = {
                        "action": action, "since": now,
                        "deadline": now}
                    self._settle_locked(
                        "failed", f"provision hook failed: {e!r}", now)
                return
            self._dispatched(action, prop, now)

    def _dispatched(self, action: str, prop: dict, now: float,
                    rank: int | None = None) -> None:
        with self._lock:
            st = self.state
            st.actions[action] = st.actions.get(action, 0) + 1
            st.budget_used += 1
            st.last_action[action] = now
            st.pending = {"action": action, "rank": rank,
                          "since": now,
                          "deadline": now + self._deadline_secs}
            self._emit_locked(
                "action", action, rank=rank,
                msg=f"{action}: {prop.get('why', '')}", level="WARN")

    def _run_provision_hook(self) -> None:
        """Fire the operator hook: the callable seam, else the
        ``MP4J_PROVISION_CMD`` subprocess (detached — the spawned
        process is expected to register as a spare, not to exit)."""
        if self._provision_hook is not None:
            self._provision_hook(self._master)
            return
        # advertise a REACHABLE master address: the explicit bind
        # host when the master has one, else this machine's hostname
        # (a provisioner spawning the spare on another host must not
        # be handed its own loopback)
        host = getattr(self._master, "host", "") or ""
        if not host or host == "0.0.0.0":
            try:
                host = socket.gethostname() or "127.0.0.1"
            except OSError:
                host = "127.0.0.1"
        env = {**os.environ,
               "MP4J_MASTER_HOST": host,
               "MP4J_MASTER_PORT": str(self._master.port)}
        subprocess.Popen(self._provision_cmd, shell=True, env=env,
                         start_new_session=True,
                         stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)

    # -- grow gating (called by the master at resize completion) --------
    def approve_grow(self, spares_available: int,
                     audit: dict | None) -> int:
        """How many spares a completed ``resize_point()`` round may
        adopt into new ranks: all available ones when the rails allow,
        0 otherwise. ``observe`` logs the would-be growth. Called by
        the master WITHOUT the master lock held (lock discipline in
        the module docstring); counts as a dispatched action — the
        master confirms it via the membership ``grow``/``grow_abort``
        event like every other action."""
        if spares_available <= 0:
            return 0
        now = time.monotonic()
        try:
            with self._lock:
                allowed, why_not = gate(
                    self.state, now, "grow",
                    cooldown_secs=self.cooldown_secs,
                    budget=self.budget, audit=audit)
            if not allowed:
                with self._lock:
                    self._emit_locked(
                        "skipped", "grow",
                        msg=f"grow skipped: {why_not}", level="WARN")
                return 0
            if self.mode != "act":
                self._observe("grow", {
                    "why": (f"adopt {spares_available} spare(s) into "
                            "new rank ids at this resize point")})
                return 0
            self._dispatched("grow", {
                "why": (f"adopting {spares_available} spare(s) into "
                        "new rank ids at a resize point")}, now)
            return spares_available
        finally:
            self._flush_events()

    # -- alerts + status ------------------------------------------------
    def _emit_locked(self, kind: str, action: str, *,
                     msg: str, rank: int | None = None,
                     level: str = "WARN") -> None:
        """Record + dispatch one structured autoscaler event (caller
        holds the controller lock). Events ride the health-alert
        control pipe so they land in the durable sink's ``alerts``
        records and interleave with verdict transitions in every
        timeline. Ids are NEGATIVE so they can never collide with the
        health engine's positive monotone ids in the dedup/sort."""
        self._alert_seq += 1
        ev = {"id": -self._alert_seq, "wall": _wall(),
              "kind": "autoscale", "event": kind, "action": action,
              "rank": rank, "mode": self.mode, "msg": msg}
        self.state.events.append(ev)
        self._outbox.append((ev, level))

    def _flush_events(self) -> None:
        """Dispatch every event minted since the last flush — called
        with the controller lock NOT held (lock discipline)."""
        with self._lock:
            out, self._outbox = self._outbox, []
        for ev, level in out:
            self._master._autoscale_event(ev, level=level)

    def status(self) -> dict:
        """The autoscaler document: ``mp4j-scope live``'s head-line,
        the metrics doc's ``cluster.autoscale`` section (Prometheus
        ``mp4j_autoscale_actions_total{action}`` /
        ``mp4j_autoscale_tripped``), and the postmortem manifest's
        autoscaler section. Plain JSON-ready values."""
        with self._lock:
            st = self.state
            return {
                "mode": self.mode,
                "tripped": st.tripped,
                "tripped_why": st.tripped_why,
                "actions": dict(st.actions),
                "observed": dict(st.observed),
                "failures": dict(st.failures),
                "retried": dict(st.retried),
                "consecutive_failures": st.consecutive_failures,
                "budget": {"limit": self.budget,
                           "used": st.budget_used},
                "cooldown_secs": self.cooldown_secs,
                "pending": (dict(st.pending)
                            if st.pending is not None else None),
                "events": [dict(e) for e in st.events],
            }
