"""R18 — bare ``time.sleep()`` inside a ``while`` loop (comm/
resilience/obs control code).

The packages this rule covers run long-lived control loops: the
master's watchdog, the autoscaler controller, heartbeat and
sink drain threads, the progression scheduler. A loop that paces
itself with ``time.sleep()`` is deaf for the whole interval — it can
neither shut down promptly when the job ends (every sleeping thread
adds its full interval to shutdown latency) nor react to a state flip
it exists to watch (a circuit-breaker trip, a terminal abort, a stop
flag). The discipline is ``Event.wait(timeout)`` (or a ``Condition``
wait): same pacing, but the setter wakes the loop IMMEDIATELY — the
master's watchdog (``self._stop.wait(tick)``) and the autoscaler loop
are the house pattern.

Heuristic: a ``time.sleep(...)`` call lexically inside a ``while``
statement, in files under ``comm/``, ``resilience/`` or ``obs/``.
Nested function definitions reset the loop tracking (a closure's sleep
runs on its own schedule, not per-iteration of the enclosing loop).
Sanctioned sites — bounded micro-backoffs inside data-plane poll
loops that already observe the epoch fence, interactive CLI polls
whose only waker is the keyboard — carry baseline entries arguing
exactly that.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, attr_chain
from ytk_mp4j_tpu_torch.analysis.report import Severity

_MSG = ("time.sleep() inside a while loop: a sleeping control loop "
        "cannot shut down promptly or react to the state it watches "
        "(stop flags, breaker trips, terminal aborts) — pace the loop "
        "with Event.wait(timeout) / Condition.wait so the setter wakes "
        "it immediately (or baseline a bounded data-plane backoff)")


class R18SleepLoop(Rule):
    rule_id = "R18"
    severity = Severity.ERROR
    title = "bare time.sleep() inside a while loop"
    description = ("control loops in comm/resilience/obs must pace "
                   "with Event.wait(timeout), not time.sleep — a "
                   "sleeping controller can neither stop promptly "
                   "nor notice a trip")
    example = """\
import time

def watchdog(self):
    while not self._stop_flag:
        self._tick()
        time.sleep(0.5)         # deaf to the stop flag for 500 ms
"""

    def run(self, ctx):
        self._while_depth = 0
        return super().run(ctx)

    def visit_While(self, node):                # noqa: N802
        self._while_depth += 1
        try:
            self.generic_visit(node)
        finally:
            self._while_depth -= 1

    def _visit_func(self, node):
        # a nested def's body executes on its own schedule — the
        # enclosing loop's cadence does not apply to it
        saved, self._while_depth = self._while_depth, 0
        try:
            self.generic_visit_scoped(node)
        finally:
            self._while_depth = saved

    def visit_FunctionDef(self, node):          # noqa: N802
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node):     # noqa: N802
        self._visit_func(node)

    def visit_Call(self, node):                 # noqa: N802
        if (self._while_depth
                and self.ctx.in_dirs("comm", "resilience", "obs")
                and attr_chain(node.func) == ["time", "sleep"]):
            self.report(node, _MSG)
        self.generic_visit(node)
