"""mp4j-resilience: fault injection + epoch-fenced recovery.

A copy of ``ytk_mp4j_tpu/resilience/__init__.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

The reference is fail-stop (SURVEY.md section 5): no failure detection,
no retry, no way to even *test* failure behavior. This package is the
deliberate departure from that scope:

- :mod:`ytk_mp4j_tpu_torch.resilience.faults` — a deterministic, seedable
  fault plan (``MP4J_FAULT_PLAN``) hooked into the socket transport:
  delay sends, cut a peer connection mid-frame, slow a rank, or kill a
  slave at the Nth collective. The substrate for the chaos grid in
  ``tests/test_resilience.py`` and for exercising the recovery engine.
- :mod:`ytk_mp4j_tpu_torch.resilience.recovery` — the epoch-fenced
  abort/retry engine: on a transport failure the slave reports to the
  master over the control plane, the master broadcasts an abort round
  targeting ``epoch+1``, every rank tears down its peer channels (the
  drain — stale frames die with their connections, whose epoch is
  pinned at dial time), acks, and re-runs the failed collective from
  its preserved input once the master releases the round. Permanently
  dead ranks escalate to a terminal abort: every survivor raises the
  same clean ``Mp4jFatalError`` naming the dead rank — never a hang,
  never a partial result.
- :mod:`ytk_mp4j_tpu_torch.resilience.membership` — elastic membership: warm-spare replacement, degraded shrink, and the grow
  roster algebra; pure protocol functions + the master's spare pool
  and membership event log.
- :mod:`ytk_mp4j_tpu_torch.resilience.autoscaler` — mp4j-autopilot: the closed-loop controller that reads
  ``Master.health_status()`` verdicts and ACTS through the membership
  machinery — planned eviction, spare auto-provisioning, grow
  approval — behind cooldown/budget/audit-green/circuit-breaker
  safety rails (``MP4J_AUTOSCALE=off|observe|act``).
"""

from ytk_mp4j_tpu_torch.resilience.faults import (  # noqa: F401
    Fault, FaultInjector, FaultKill, FaultPlan)
from ytk_mp4j_tpu_torch.resilience.recovery import (  # noqa: F401
    RECOVERABLE, RecoveryManager)
