"""R24 — resource leaked on an exception path.

The fd-reuse hardening pass, machine-checked: a socket, file, shm
segment, transport channel or bare ``acquire()`` whose release sits
AFTER a statement that can raise — with no ``try/finally``, no
``with``, and no ownership transfer between the acquire and that
edge — leaks exactly when the peer misbehaves, which is exactly when
the job can least afford a dangling fd or a stuck lock. The resource
model walks every function's paths and charges the ACQUIRE site (the
fix site), naming the first unprotected raising statement.

Ownership transfer ends this function's liability: returning the
resource, storing it in an attribute/registry (the
``_drain_dead_channels`` pattern owns what ``self._channels`` holds),
or passing it to another call. Straight-line code that never releases
at all is the degenerate case and is also charged.
"""

from __future__ import annotations

from ytk_mp4j_tpu_torch.analysis.engine import ProgramRule
from ytk_mp4j_tpu_torch.analysis.report import Severity

_DIRS = ("comm", "resilience", "obs", "transport", "analysis")


class R24ResourceLeak(ProgramRule):
    rule_id = "R24"
    severity = Severity.ERROR
    title = "resource leaked on an exception path"
    description = ("a socket/file/segment/channel/lock acquired here "
                   "is still unreleased when a later statement can "
                   "raise, and no try/finally, with-block or "
                   "ownership transfer covers that edge — the "
                   "exception leaks the fd (or wedges the lock)")
    example = """\
import socket

def probe(host):
    s = socket.create_connection((host, 9999))
    s.sendall(b"ping")          # raises -> fd leaked
    reply = s.recv(16)
    s.close()
    return reply
"""
    example_path = "ytk_mp4j_tpu_torch/comm/example.py"

    def run_program(self, program):
        model = program.resources
        out = []
        seen = set()
        for leak in model.leaks:
            segs = leak.path.split("/")
            if not any(p in segs for p in _DIRS):
                continue
            key = (leak.path, leak.lineno, leak.name)
            if key in seen:
                continue
            seen.add(key)
            if leak.kind == "lock":
                msg = (f"lock {leak.name} acquired outside 'with' is "
                       f"not released on the exception edge: "
                       f"{leak.risk_desc} can raise first — use "
                       f"'with', or release in a try/finally")
            else:
                msg = (f"{leak.kind} '{leak.name}' acquired here may "
                       f"leak: {leak.risk_desc} can raise before the "
                       f"release, and no try/finally, with-block or "
                       f"ownership transfer covers that edge — wrap "
                       f"the acquire in try/finally or hand the "
                       f"resource off first")
            out.append(self.finding(
                leak.path, leak.lineno, msg, context=leak.func))
        return out
