"""R23 — inconsistent lockset on a shared field.

The Eraser discipline: every shared mutable field is protected by SOME
fixed lock held at every access. The race model enumerates thread
roots (``Thread(target=)``, ``Timer`` callbacks, registered hooks, the
public collective surface), propagates held-lock contexts along the
call graph, and records every field access with its lockset. A field
reachable from two roots with a write whose lockset shares nothing
with another root's access is a data race the next adversarial
interleaving can realize — torn progress tuples and eviction-race
segment loss were exactly this class.

The finding charges the WRITE witness (the fix site), names both
sites with their roots and locksets, and names the candidate lock —
the one most of the field's accesses already hold. Deliberate
lock-free publication (the shm ring head/tail indices, the poison
flag) carries reasoned baseline entries instead of a lock.
"""

from __future__ import annotations

from ytk_mp4j_tpu_torch.analysis.engine import ProgramRule
from ytk_mp4j_tpu_torch.analysis.report import Severity

_DIRS = ("comm", "resilience", "obs", "transport", "analysis")


def _in_dirs(path: str) -> bool:
    segs = path.split("/")
    return any(p in segs for p in _DIRS)


class R23LocksetRace(ProgramRule):
    rule_id = "R23"
    severity = Severity.ERROR
    title = "inconsistent lockset on a shared field"
    description = ("a field reachable from two thread roots is "
                   "written with a lockset sharing no lock with "
                   "another root's access: no lock orders the two "
                   "sites, so the next interleaving tears it — hold "
                   "the candidate lock at every access, or argue the "
                   "lock-free publication in a baseline entry")
    example = """\
import threading

class Plane:
    def __init__(self):
        self._lock = threading.Lock()
        self.state = "idle"
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()

    def _loop(self):
        self.state = "running"      # no lock held

    def status(self):
        with self._lock:
            return self.state       # reader holds _lock
"""

    def run_program(self, program):
        model = program.races
        out = []
        for fr in model.field_reports():
            if not fr.racy or fr.witness is None:
                continue
            w, o = fr.witness
            if not (_in_dirs(w.path) or _in_dirs(o.path)):
                continue
            cand = (f"candidate lock "
                    f"{model.locks.locks[fr.candidate].display}: take "
                    f"it at every access"
                    if fr.candidate is not None else
                    "no lock is ever held here: give the field one")
            out.append(self.finding(
                w.path, w.lineno,
                f"shared field {fr.display} has inconsistent "
                f"locksets: write at {w.path}:{w.lineno} ({w.func}, "
                f"{w.root}) holds [{model._names(w.lockset)}] vs "
                f"{'write' if o.write else 'read'} at "
                f"{o.path}:{o.lineno} ({o.func}, {o.root}) holds "
                f"[{model._names(o.lockset)}] — no common lock; "
                f"{cand}, or argue the lock-free publication in a "
                f"baseline entry",
                context=w.func))
        return out
