"""R19 — lock-order cycle across the whole program.

Two code paths that acquire the same pair of locks in opposite orders
deadlock the first time their threads interleave — and in this package
the two acquisitions are usually in DIFFERENT functions, often
different modules (the master's telemetry fold vs the controller's
dispatch path), which is why eighteen per-file rules never saw the
class. The lock model builds the package-wide lock-order graph — an
edge ``A -> B`` for every witnessed "``B`` acquired while ``A`` held",
through ``with`` nesting and call chains alike — and R19 reports every
strongly connected component of size >= 2, with one witness chain per
direction.

The "master -> controller only" discipline (the autoscaler's module docstring)
stops being prose here: an autoscaler path that dispatched into the
master while holding the controller lock would close the cycle with
the master's ``status()`` path and fire this rule.

Same-lock re-entry through a call chain is R21's half of the job;
edges between two instances of one ``(class, attr)`` site share a
node, which is the conservative merge — an order violation between
any two instances violates the class's one discipline.
"""

from __future__ import annotations

from ytk_mp4j_tpu_torch.analysis.engine import ProgramRule
from ytk_mp4j_tpu_torch.analysis.report import Severity


class R19LockOrderCycle(ProgramRule):
    rule_id = "R19"
    severity = Severity.ERROR
    title = "lock-order cycle"
    description = ("two call paths acquire the same locks in opposite "
                   "orders (interprocedural): the first adversarial "
                   "interleaving deadlocks both threads — pick one "
                   "job-wide order per lock pair")
    example = """\
import threading

class Master:
    def __init__(self):
        self._lock = threading.Lock()
        self._ctl = Controller(self)

    def status(self):
        with self._lock:
            return self._ctl.snapshot()     # master -> controller

class Controller:
    def __init__(self, master):
        self._lock = threading.Lock()
        self._master = master

    def snapshot(self):
        with self._lock:
            return dict(vars(self))

    def dispatch(self, ev):
        with self._lock:
            self._master.status()           # controller -> master: cycle
"""

    def run_program(self, program):
        model = program.locks
        out = []
        for scc in model.cycles():
            members = set(scc)
            # witness edges inside the component, one per direction
            edges = [e for (s, d), e in sorted(model.edges.items())
                     if s in members and d in members]
            if not edges:
                continue
            names = ", ".join(model.locks[k].display for k in scc)
            witness = "; ".join(
                model.format_witness(e) for e in edges[:4])
            charge = edges[0]
            out.append(self.finding(
                charge.path, charge.lineno,
                f"lock-order cycle among [{names}]: opposite "
                f"acquisition orders observed — {witness}; every "
                f"thread pair running these paths can deadlock: pick "
                f"ONE job-wide order and move the minority "
                f"acquisition outside the held region (outbox "
                f"pattern) or re-order it",
                context=self._context_of(program, charge)))
        return out

    @staticmethod
    def _context_of(program, edge):
        # the charging frame's qualname: first name in the chain
        return edge.chain[0] if edge.chain else "<module>"
