"""R20 — blocking call while holding a lock.

The class behind the heartbeat/ctl stalls: a thread that blocks on a
peer (socket recv/send, ``Event.wait``/``Condition.wait`` on a
DIFFERENT object, a thread ``join``, a subprocess, a collective
``wait()``) while holding a lock turns one slow peer into a stalled
PLANE — every other thread needing that lock now waits on the peer
too, and if the peer needs one of those threads to make progress the
job deadlocks. Per-function AST cannot see it: the lock is taken in
one function and the blocking call sits three frames deeper.

The lock model supplies both halves: per-call-site held-lock sets and
each callee's transitively reachable blocking operations (with one
witness chain). R20 charges the frame WHERE THE LOCK IS HELD — the
fix site — naming the lock, the operation, and the chain.

Exemptions by construction: a ``wait()``/``wait_for()`` on the held
condition itself RELEASES it for the duration (the house barrier
pattern) and is only charged against OTHER held locks. Deliberate
serialize-sends-under-a-dedicated-lock sites (``_master_send``) carry
baseline entries arguing the bound.
"""

from __future__ import annotations

from ytk_mp4j_tpu_torch.analysis.engine import ProgramRule
from ytk_mp4j_tpu_torch.analysis.report import Severity

_DIRS = ("comm", "resilience", "obs", "transport", "analysis")


class R20BlockingUnderLock(ProgramRule):
    rule_id = "R20"
    severity = Severity.ERROR
    title = "blocking call under a held lock"
    description = ("socket/channel I/O, waits on another object, "
                   "thread joins, subprocesses or collective wait() "
                   "reached while a lock is held (interprocedurally): "
                   "one slow peer stalls every thread that needs the "
                   "lock — move the blocking call outside the held "
                   "region")
    example = """\
import threading

class Slave:
    def __init__(self, chan):
        self._lock = threading.Lock()
        self._chan = chan

    def flush(self, obj):
        with self._lock:
            self._ship(obj)         # blocks a peer away, lock held

    def _ship(self, obj):
        self._chan.send_obj(obj)    # the blocking frame
"""

    def run_program(self, program):
        model = program.locks
        out = []
        seen = set()
        for fkey, s in sorted(model.summaries.items()):
            fi = s.func
            if not fi.module.ctx.in_dirs(*_DIRS):
                continue
            for b in s.blockers:
                for held in b.held:
                    self._charge(model, out, seen, fi, held,
                                 b.lineno, b.what, (fi.display,),
                                 b.recv_lock)
            for call in s.calls:
                if not call.held:
                    continue
                for ckey in call.callees:
                    blk = model.trans_blockers.get(ckey)
                    if not blk:
                        continue
                    for (terminal, recv_lock), ent in sorted(
                            blk.items(), key=lambda kv: kv[0][0]):
                        what = ent[2] if ent[0] == "direct" else ent[3]
                        tail, _ = model._chase(
                            model.trans_blockers, ckey,
                            (terminal, recv_lock))
                        for held in call.held:
                            self._charge(
                                model, out, seen, fi, held,
                                call.lineno, what,
                                (fi.display,) + tail, recv_lock)
        return out

    def _charge(self, model, out, seen, fi, held_lock, lineno, what,
                chain, recv_lock):
        if recv_lock is not None and recv_lock == held_lock:
            return      # wait on the held condition releases it
        key = (fi.key, held_lock, what, lineno)
        if key in seen:
            return
        seen.add(key)
        lock = model.locks[held_lock]
        via = (" via " + " -> ".join(chain) if len(chain) > 1 else "")
        out.append(self.finding(
            fi.path, lineno,
            f"blocking {what} reached while holding "
            f"{lock.display}{via}: one slow peer stalls every thread "
            f"that needs the lock — move the blocking call outside "
            f"the held region (mint under the lock, dispatch from an "
            f"outbox outside it)",
            context=fi.display))
