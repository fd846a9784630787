"""R10 — peer-channel I/O that bypasses the epoch-fence wrapper.

The recovery engine fences the peer data plane: every channel
acquisition on a collective path must go through the slave's
``_fenced(peer)`` wrapper, which raises while an abort round is in
flight (or when the running attempt is a zombie pinned to a stale
epoch) instead of letting the caller dial into — or keep writing to —
a torn-down epoch. A send/recv on a channel obtained straight from
``_channel(...)`` (or built bare from ``Channel(...)``/``connect(...)``)
skips that check: in the recovery window it can consume frames that
belong to the retry stream, the exact corruption the fence exists to
prevent.

Heuristic: inside a ``*CommSlave`` class in ``comm/``, flag a
channel-I/O method call (``send_array``/``recv_array``/
``recv_array_into``/``send_map_columns``/``recv_map_columns``/
``send_raw``/``recv_raw_into``/``send_obj``/``recv``) whose receiver
is ``self._channel(...)`` directly, or a local name bound from
``self._channel(...)`` / ``Channel(...)`` / ``connect(...)`` in the
same function. Receivers from ``self._fenced(...)`` — and the master
control channel, which has no epoch — are not flagged. The sanctioned
sites are the two peer-handshake exchanges (they *establish* a
channel's epoch, so the fence cannot apply yet): accepted in
baseline.toml.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, call_name
from ytk_mp4j_tpu_torch.analysis.report import Severity

# channel I/O surface (transport.channel.Channel)
_PEER_IO = frozenset({
    "send_array", "recv_array", "recv_array_into", "send_map_columns",
    "recv_map_columns", "send_raw", "recv_raw_into", "send_obj", "recv",
})

# expressions that produce an UNFENCED channel
_RAW_PRODUCERS = frozenset({"_channel", "Channel", "TcpChannel",
                            "ShmChannel", "connect"})


def _producer(expr: ast.AST) -> str | None:
    """``self._channel(...)`` / ``Channel(...)`` / ``connect(...)`` ->
    the producer name; None otherwise."""
    if isinstance(expr, ast.Call):
        name = call_name(expr)
        if name in _RAW_PRODUCERS:
            return name
    return None


def _raw_bound_names(fn: ast.AST) -> dict[str, str]:
    """Local names assigned from a raw channel producer in ``fn``
    (one level of data flow, like R9's dict tracking)."""
    out: dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            prod = _producer(node.value)
            if prod is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = prod
    return out


class R10EpochFenceBypass(Rule):
    rule_id = "R10"
    severity = Severity.ERROR
    title = "peer-channel I/O bypasses the epoch fence"
    description = ("a send_*/recv_* call runs on a channel obtained "
                   "outside the slave's _fenced() wrapper; during a "
                   "recovery round it can write into (or steal frames "
                   "from) the retry's stream — acquire peer channels "
                   "via _fenced(peer) on every data path")
    example = """\
class ProcessCommSlave:
    def _send(self, peer, data):
        ch = self._channel(peer)        # not _fenced(peer)
        ch.send_array(data)
"""

    def visit_ClassDef(self, node):             # noqa: N802
        if self.ctx.in_dirs("comm") and "CommSlave" in node.name:
            self.scope.append(node.name)
            try:
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.scope.append(item.name)
                        try:
                            self._scan(item)
                        finally:
                            self.scope.pop()
            finally:
                self.scope.pop()
            return
        self.generic_visit_scoped(node)

    def _scan(self, fn: ast.AST) -> None:
        bound = _raw_bound_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in _PEER_IO:
                continue
            recv = node.func.value
            prod = _producer(recv)
            if prod is None and isinstance(recv, ast.Name):
                prod = bound.get(recv.id)
            if prod is not None:
                self.report(node, (
                    f"{node.func.attr}() on a channel from {prod}() "
                    "bypasses the epoch fence; acquire the channel "
                    "via self._fenced(peer) so an in-flight abort "
                    "round (or a zombie attempt) cannot touch the "
                    "new epoch's stream"))
