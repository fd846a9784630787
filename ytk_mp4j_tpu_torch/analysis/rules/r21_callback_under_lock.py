"""R21 — callback/dispatch under the minting lock.

The master's outbox discipline, machine-checked. Two shapes:

(a) **Hook under lock** — invoking a user-supplied callable
    (``*_hook`` / ``*_callback`` / ``*_cb``), directly or through a
    call chain, while any lock is held. A hook is arbitrary code: it
    can block, it can call back into the object that is holding the
    lock, and no review of THIS repo can bound it. Fire the hook
    after releasing (collect under the lock, dispatch from an outbox
    outside it — the autoscaler's ``_emit_locked``/``_flush_events``
    pair is the house pattern and the negative case).

(b) **Re-entrant dispatch** — a call chain started while holding a
    non-reentrant lock that RE-ACQUIRES that same lock (the
    controller holding its lock dispatching into the master, whose
    path calls ``controller.status()``, which takes the controller
    lock again: self-deadlock on a plain ``Lock``). R19 catches
    opposite-order PAIRS; this catches the same-lock loop. Edges
    between two instances of one ``(class, attr)`` site share a node,
    so a genuinely per-instance nesting needs a reasoned suppression
    stating the instance-order argument.
"""

from __future__ import annotations

from ytk_mp4j_tpu_torch.analysis.engine import ProgramRule
from ytk_mp4j_tpu_torch.analysis.report import Severity

_DIRS = ("comm", "resilience", "obs", "transport", "analysis")


class R21CallbackUnderLock(ProgramRule):
    rule_id = "R21"
    severity = Severity.ERROR
    title = "callback/dispatch under the minting lock"
    description = ("a hook/callback invoked, or the held lock "
                   "re-acquired through a call chain, while the lock "
                   "is held: arbitrary user code under a lock can "
                   "block or re-enter — mint events under the lock, "
                   "dispatch from an outbox outside it")
    example = """\
import threading

class Controller:
    def __init__(self, on_alert):
        self._lock = threading.Lock()
        self._on_alert = on_alert

    def settle(self, ev):
        with self._lock:
            self._events = [ev]
            self._alert_hook(ev)        # user code under the lock

    def _alert_hook(self, ev):
        self._on_alert(ev)
"""

    def run_program(self, program):
        model = program.locks
        out = []
        seen = set()
        for fkey, s in sorted(model.summaries.items()):
            fi = s.func
            if not fi.module.ctx.in_dirs(*_DIRS):
                continue
            for h in s.hooks:
                if h.held:
                    self._charge_hook(model, out, seen, fi, h.name,
                                      h.held, h.lineno, (fi.display,))
            for call in s.calls:
                if not call.held:
                    continue
                for ckey in call.callees:
                    hooks = model.trans_hooks.get(ckey)
                    if hooks:
                        for name in sorted(hooks):
                            tail, _ = model._chase(
                                model.trans_hooks, ckey, name)
                            self._charge_hook(
                                model, out, seen, fi, name, call.held,
                                call.lineno, (fi.display,) + tail)
        # (b) same-lock re-entry through a call chain
        for lockkey, edge in model.reentries:
            key = ("reentry", lockkey, edge.path, edge.lineno)
            if key in seen:
                continue
            seen.add(key)
            decl = model.locks[lockkey]
            out.append(self.finding(
                edge.path, edge.lineno,
                f"call chain re-acquires non-reentrant "
                f"{decl.display} while already holding it "
                f"(via {' -> '.join(edge.chain)}): self-deadlock on "
                f"the first execution — dispatch after releasing, or "
                f"argue the per-instance order in a suppression",
                context=edge.chain[0] if edge.chain else "<module>"))
        return out

    def _charge_hook(self, model, out, seen, fi, name, held, lineno,
                     chain):
        key = (fi.key, name, lineno)
        if key in seen:
            return
        seen.add(key)
        locks = ", ".join(sorted(model.locks[h].display for h in held))
        via = (" via " + " -> ".join(chain) if len(chain) > 1 else "")
        out.append(self.finding(
            fi.path, lineno,
            f"hook/callback '{name}' invoked{via} while holding "
            f"[{locks}]: arbitrary user code under a lock can block "
            f"the plane or re-enter it — collect under the lock, "
            f"dispatch from an outbox outside it",
            context=fi.display))
