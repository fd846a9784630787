"""Rule catalogue for mp4j-lint — one module per rule.

| id | severity | hazard |
|----|----------|--------|
| R1 | error    | collective under a rank-dependent branch |
| R2 | warning  | unbounded socket/Channel recv/accept/sendall |
| R3 | error    | thread-group shared state outside the lock |
| R4 | error    | operand mismatch between paired segment transfers |
| R5 | error    | bare/swallowed exceptions in comm hot paths |
| R6 | warning  | leader returns an aliased slot (no _detach) |
| R7 | error    | mutable defaults / mutated module-level state |
| R8 | error    | chunk schedule derived from rank-local state |
| R9 | error    | pickled dict payload on a collective map path |
| R10 | error   | peer-channel I/O bypassing the epoch fence |
| R11 | error   | wall clock feeding duration/deadline arithmetic |
| R12 | error   | transport construction outside transport/ (SPI) |
| R13 | error   | raw-byte read of a possibly non-contiguous array |
| R14 | error   | telemetry artifact write skipping tmp+os.replace |
| R15 | error   | roster-derived topology cached in an attribute |
| R16 | error   | un-awaited CollectiveFuture crosses a boundary |
| R17 | error   | metric family missing from METRICS_DOC |
| R18 | error   | bare time.sleep() inside a while loop (control code) |
| R19 | error   | lock-order cycle (whole-program) |
| R20 | error   | blocking call under a held lock (whole-program) |
| R21 | error   | callback/dispatch under the minting lock (whole-program) |
| R22 | error   | transport-decision size literal outside tuning/tuner |
| R23 | error   | inconsistent lockset on a shared field (whole-program) |
| R24 | error   | resource leaked on an exception path (whole-program) |
| R25 | error   | thread started without join/daemon/stop (whole-program) |
| R26 | warning | in-loop i* submit awaited with no compute (overlap defeated) |
| R27 | warning | HTTP fetch without explicit timeout in obs/ scrape code |
| R28 | error   | serve-path wait without deadline / wall clock in serve/ |

R19-R21 and R23-R25 are
:class:`~ytk_mp4j_tpu_torch.analysis.engine.ProgramRule` instances: they
run once over the whole indexed path set (call graph + lock model +
race/resource models) instead of file by file.
"""

from __future__ import annotations

from ytk_mp4j_tpu_torch.analysis.rules.r1_rank_branch import (
    R1RankConditionalCollective)
from ytk_mp4j_tpu_torch.analysis.rules.r2_socket_timeout import (
    R2UnboundedSocketOp)
from ytk_mp4j_tpu_torch.analysis.rules.r3_lock_discipline import (
    R3SharedStateOutsideLock)
from ytk_mp4j_tpu_torch.analysis.rules.r4_operand_pairing import (
    R4OperandPairing)
from ytk_mp4j_tpu_torch.analysis.rules.r5_swallowed_exceptions import (
    R5SwallowedException)
from ytk_mp4j_tpu_torch.analysis.rules.r6_aliased_result import (
    R6AliasedLeaderResult)
from ytk_mp4j_tpu_torch.analysis.rules.r7_mutable_state import R7MutableState
from ytk_mp4j_tpu_torch.analysis.rules.r8_chunk_schedule import (
    R8RankLocalChunkSchedule)
from ytk_mp4j_tpu_torch.analysis.rules.r9_map_payload import (
    R9PickledMapPayload)
from ytk_mp4j_tpu_torch.analysis.rules.r10_epoch_fence import (
    R10EpochFenceBypass)
from ytk_mp4j_tpu_torch.analysis.rules.r11_wall_clock import (
    R11WallClockDuration)
from ytk_mp4j_tpu_torch.analysis.rules.r12_transport_spi import (
    R12TransportSpiBypass)
from ytk_mp4j_tpu_torch.analysis.rules.r13_digest_contiguity import (
    R13DigestContiguity)
from ytk_mp4j_tpu_torch.analysis.rules.r14_torn_write import R14TornWrite
from ytk_mp4j_tpu_torch.analysis.rules.r15_topology_cache import (
    R15TopologyCache)
from ytk_mp4j_tpu_torch.analysis.rules.r16_unawaited_future import (
    R16UnawaitedFuture)
from ytk_mp4j_tpu_torch.analysis.rules.r17_metric_doc import R17MetricDoc
from ytk_mp4j_tpu_torch.analysis.rules.r18_sleep_loop import R18SleepLoop
from ytk_mp4j_tpu_torch.analysis.rules.r19_lock_order import R19LockOrderCycle
from ytk_mp4j_tpu_torch.analysis.rules.r20_blocking_under_lock import (
    R20BlockingUnderLock)
from ytk_mp4j_tpu_torch.analysis.rules.r21_callback_under_lock import (
    R21CallbackUnderLock)
from ytk_mp4j_tpu_torch.analysis.rules.r22_knob_literal import R22KnobLiteral
from ytk_mp4j_tpu_torch.analysis.rules.r23_lockset_race import R23LocksetRace
from ytk_mp4j_tpu_torch.analysis.rules.r24_resource_leak import (
    R24ResourceLeak)
from ytk_mp4j_tpu_torch.analysis.rules.r25_thread_lifecycle import (
    R25ThreadLifecycle)
from ytk_mp4j_tpu_torch.analysis.rules.r26_immediate_await import (
    R26ImmediateAwait)
from ytk_mp4j_tpu_torch.analysis.rules.r27_http_timeout import (
    R27HttpNoTimeout)
from ytk_mp4j_tpu_torch.analysis.rules.r28_serve_deadline import (
    R28ServeDeadline)

ALL_RULES = [
    R1RankConditionalCollective,
    R2UnboundedSocketOp,
    R3SharedStateOutsideLock,
    R4OperandPairing,
    R5SwallowedException,
    R6AliasedLeaderResult,
    R7MutableState,
    R8RankLocalChunkSchedule,
    R9PickledMapPayload,
    R10EpochFenceBypass,
    R11WallClockDuration,
    R12TransportSpiBypass,
    R13DigestContiguity,
    R14TornWrite,
    R15TopologyCache,
    R16UnawaitedFuture,
    R17MetricDoc,
    R18SleepLoop,
    R19LockOrderCycle,
    R20BlockingUnderLock,
    R21CallbackUnderLock,
    R22KnobLiteral,
    R23LocksetRace,
    R24ResourceLeak,
    R25ThreadLifecycle,
    R26ImmediateAwait,
    R27HttpNoTimeout,
    R28ServeDeadline,
]

RULES_BY_ID = {cls.rule_id: cls for cls in ALL_RULES}


def get_rules(select=None):
    """Fresh rule instances; ``select`` is an iterable of rule ids."""
    if select is None:
        classes = ALL_RULES
    else:
        unknown = set(select) - set(RULES_BY_ID)
        if unknown:
            raise KeyError(f"unknown rule id(s): {sorted(unknown)}")
        classes = [RULES_BY_ID[s] for s in select]
    return [cls() for cls in classes]
