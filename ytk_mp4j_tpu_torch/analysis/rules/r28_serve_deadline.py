"""R28 — serve-path wait without a deadline / wall clock in serve/.

The inference plane lives or dies by its tail latency: a
request admitted to the micro-batcher carries an end-to-end deadline
of a few MILLISECONDS (``MP4J_SERVE_DEADLINE_MS``), so any wait on the
serve path that can block forever converts one slow replica into an
unbounded p99 — the exact outage the chaos bench measures. Two shapes
fire, both restricted to ``serve/``:

- **unbounded wait**: a no-argument ``.wait()`` / ``.acquire()`` /
  ``.join()`` / ``.result()`` call. Every blocking point on the serve
  path must carry a ``timeout=`` (the batcher's idle wait, the
  future's result wait, the dispatch thread's close join) so a wedged
  collective surfaces as a counted timeout, not a hung frontend.
- **wall clock**: any ``time.time()`` (or bare ``time()`` under
  ``from time import time``) or ``datetime.now()`` /
  ``datetime.utcnow()`` call. R11 already rejects wall-clock
  *arithmetic* in comm/obs/transport; serve deadlines are so short
  that a single NTP slew exceeds the whole budget, so in ``serve/``
  the wall clock is banned outright — batch deadlines and latency
  observations must ride ``time.monotonic`` / ``time.perf_counter``.

Quiet shapes: a wait with any positional argument or a ``timeout=``
keyword (``fut.result(timeout)``, ``cv.wait(timeout=w)``,
``t.join(remaining)``), and string ``"".join(parts)`` — it takes an
argument, so the no-argument heuristic never sees it.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule
from ytk_mp4j_tpu_torch.analysis.report import Severity

# blocking methods that accept a timeout and block forever without one
_WAIT_ATTRS = ("wait", "acquire", "join", "result")


def _is_wall_call(node: ast.AST, bare: bool) -> bool:
    """``time.time()``; bare ``time()`` under ``from time import
    time``; ``datetime.now()`` / ``datetime.utcnow()`` on either the
    module or the class."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr == "time" and isinstance(f.value, ast.Name) \
                and f.value.id == "time":
            return True
        if f.attr in ("now", "utcnow"):
            base = f.value
            if isinstance(base, ast.Name) and base.id == "datetime":
                return True
            if isinstance(base, ast.Attribute) \
                    and base.attr == "datetime":
                return True
        return False
    return bare and isinstance(f, ast.Name) and f.id == "time"


class R28ServeDeadline(Rule):
    rule_id = "R28"
    severity = Severity.ERROR
    title = "serve-path wait without a deadline / wall clock in serve/"
    description = ("the serve path budgets milliseconds end to end: a "
                   "wait()/acquire()/join()/result() with no timeout "
                   "turns one slow replica into an unbounded p99, and "
                   "a wall-clock read (time.time / datetime.now) can "
                   "slew by more than the whole deadline — use "
                   "timeout= everywhere and time.monotonic for "
                   "deadlines")
    example_path = "ytk_mp4j_tpu_torch/serve/example.py"
    example = """\
import time

class Batcher:
    def flush(self):
        self._ready.wait()                  # can block forever
        deadline = time.time() + 0.002      # NTP slew > budget
"""

    _MSG_WAIT = ("unbounded {name}() on the serve path — pass a "
                 "timeout so a wedged replica surfaces as a counted "
                 "timeout, not a hung frontend")
    _MSG_WALL = ("wall clock on the serve path — serve deadlines are "
                 "milliseconds, smaller than an NTP slew; use "
                 "time.monotonic (deadlines) / time.perf_counter "
                 "(latency)")

    def run(self, ctx):
        self._bare = False
        return super().run(ctx)

    def visit_Module(self, node):               # noqa: N802
        if not self.ctx.in_dirs("serve"):
            return
        self._bare = any(
            isinstance(n, ast.ImportFrom) and n.module == "time"
            and any(alias.name == "time" for alias in n.names)
            for n in ast.walk(node))
        self.generic_visit(node)

    def visit_Call(self, node):                 # noqa: N802
        if _is_wall_call(node, self._bare):
            self.report(node, self._MSG_WALL)
        else:
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr in _WAIT_ATTRS
                    and not node.args
                    and not any(kw.arg == "timeout"
                                for kw in node.keywords)):
                self.report(node, self._MSG_WAIT.format(name=f.attr))
        self.generic_visit(node)
