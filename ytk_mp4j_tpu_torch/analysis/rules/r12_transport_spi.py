"""R12 — transport construction outside the transport SPI.

The socket code is split into a transport SPI: every concrete
channel (``TcpChannel``, ``ShmChannel``) and every raw ``socket.
socket(...)`` belongs inside ``transport/`` — the collectives, the
control plane and the observability layers all program against the
abstract :class:`~ytk_mp4j_tpu_torch.transport.channel.Channel` contract and
acquire channels through the owning slave's fenced accessors. A raw
socket or direct channel construction elsewhere bypasses everything
the SPI composes over the contract (epoch pinning, fault hooks,
transport-tagged stats, the invalidate/deferred-close discipline) and
quietly re-couples a caller to ONE transport — exactly the special-
casing the SPI exists to end.

Sanctioned sites carry baseline entries: the rendezvous surfaces
(master listen socket + registration channel, slave listen socket,
the accept loop's handshake channel) must construct over raw sockets
because they ARE the mechanism transports are negotiated over.

Heuristic: outside ``transport/`` (and outside ``analysis/`` — the
linter's own fixtures), flag

- any call whose terminal name is ``socket`` with a dotted receiver
  ending in ``socket`` (``socket.socket(...)``) or a bare ``socket``
  name imported from the socket module;
- any call to a name ending in ``Channel`` that matches the known
  concrete channels (``TcpChannel``, ``ShmChannel``) or the legacy
  bare ``Channel``.

``connect(...)`` (the transport package's own dialer factory) is NOT
flagged: it returns a fully-constructed SPI object and is the
sanctioned way to obtain an outbound channel.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import (
    Rule, call_name, receiver_chain)
from ytk_mp4j_tpu_torch.analysis.report import Severity

_CHANNEL_CTORS = frozenset({"Channel", "TcpChannel", "ShmChannel"})


class R12TransportSpiBypass(Rule):
    rule_id = "R12"
    severity = Severity.ERROR
    title = "transport construction outside transport/"
    description = ("raw socket.socket(...) or concrete Channel "
                   "construction outside the transport SPI bypasses "
                   "epoch pinning, fault hooks and transport-tagged "
                   "stats; acquire channels through the slave's "
                   "fenced accessors (or transport.connect)")
    example = """\
import socket

def open_side_channel(self):
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    return s                    # bypasses the Channel SPI
"""

    def visit_Call(self, node: ast.Call):       # noqa: N802
        if self.ctx.in_dirs("transport", "analysis"):
            return
        name = call_name(node)
        if name == "socket":
            recv = receiver_chain(node)
            # socket.socket(...) — or socket(...) where the bare name
            # came from the socket module is indistinguishable from a
            # user callable, so only the dotted form (the repo idiom)
            # is flagged
            if recv is not None and recv[-1] == "socket":
                self.report(node, (
                    "raw socket.socket(...) outside transport/: "
                    "socket construction belongs behind the Channel "
                    "SPI (transport.tcp / transport.shm); rendezvous "
                    "surfaces are the only baselined exception"))
        elif name in _CHANNEL_CTORS:
            self.report(node, (
                f"{name}(...) constructed outside transport/: "
                "collective/control code must program against the "
                "Channel contract and acquire peers through the "
                "fenced accessors (epoch pinning, fault hooks and "
                "transport-tagged stats all hang off the SPI)"))
        self.generic_visit(node)
