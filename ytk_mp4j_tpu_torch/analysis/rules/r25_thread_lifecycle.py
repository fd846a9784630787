"""R25 — thread started without join/daemon/stop registration.

A non-daemon thread that nobody joins outlives ``close()``: it pins
the interpreter at exit, keeps sockets and segments alive past
teardown, and — in this package — keeps COLLECTING on a plane the
master already declared dead. Every sanctioned thread in the comm
stack is either daemonized at construction, joined at shutdown, or
parked in a registry some drain loop joins; this rule makes that the
checked invariant.

Accepted lifecycles: ``daemon=True`` (or ``t.daemon = True`` before
start), a ``join()``/``cancel()`` in the constructing function, or
storage in an attribute/list that ANY function in the program joins,
cancels or daemonizes (the whole-program registry). Handing the
thread to another call transfers the obligation and is accepted.
"""

from __future__ import annotations

from ytk_mp4j_tpu_torch.analysis.engine import ProgramRule
from ytk_mp4j_tpu_torch.analysis.report import Severity

_DIRS = ("comm", "resilience", "obs", "transport", "analysis")


class R25ThreadLifecycle(ProgramRule):
    rule_id = "R25"
    severity = Severity.ERROR
    title = "thread started without join/daemon/stop registration"
    description = ("a Thread/Timer is started with no shutdown "
                   "story: not daemonized, never joined/cancelled, "
                   "and not stored anywhere the program drains — it "
                   "outlives close() and pins interpreter exit")
    example = """\
import threading

class Pump:
    def start(self):
        self._t = threading.Thread(target=self._drain)
        self._t.start()

    def _drain(self):
        pass
"""

    def run_program(self, program):
        model = program.resources
        out = []
        seen = set()
        for tl in model.thread_leaks:
            segs = tl.path.split("/")
            if not any(p in segs for p in _DIRS):
                continue
            key = (tl.path, tl.lineno)
            if key in seen:
                continue
            seen.add(key)
            out.append(self.finding(
                tl.path, tl.lineno,
                f"thread has no shutdown story: {tl.detail} — "
                f"daemonize it at construction, join it at close, or "
                f"register it with a joined/cancelled registry",
                context=tl.func))
        return out
