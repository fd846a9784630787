"""TCP transport — the reference socket plane behind the Channel SPI.

A copy of ``ytk_mp4j_tpu/transport/tcp.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

The reference frames messages over raw ``java.net.Socket`` streams with
Kryo for objects and raw ``DataOutputStream`` writes for primitive
arrays (SURVEY.md section 2 "Serialization" [U]). All framing lives in
the SPI base (:mod:`ytk_mp4j_tpu_torch.transport.channel`); this module
contributes only the socket primitives: timeout-translated
``sendall`` / ``recv_into`` loops, the ``connect()`` dialer, kernel
socket-buffer sizing, the graceful half-close discipline, and the
``invalidate()`` = shutdown-without-close teardown the recovery plane's
deferred fd release relies on.

Env knobs applied at channel setup (see :mod:`ytk_mp4j_tpu_torch.utils.tuning`
— JOB-wide settings, every rank must agree): ``MP4J_SO_SNDBUF`` /
``MP4J_SO_RCVBUF`` size the kernel socket buffers (unset keeps kernel
defaults); ``MP4J_CHUNK_BYTES`` sizes the streaming-compression chunks.
"""

from __future__ import annotations

import socket

from ytk_mp4j_tpu_torch.transport.channel import Channel
from ytk_mp4j_tpu_torch.utils import tuning
from ytk_mp4j_tpu_torch.exceptions import Mp4jError, Mp4jTransportError


def apply_socket_buf_sizes(sock: socket.socket,
                           so_bufs: tuple[int, int] | None = None
                           ) -> None:
    """Apply ``MP4J_SO_SNDBUF`` / ``MP4J_SO_RCVBUF`` (validated; unset
    keeps the kernel's autotuned defaults). ``so_bufs`` is a PER-LINK
    ``(sndbuf, rcvbuf)`` override (``MP4J_SO_BUF_MAP`` or a
    tuner decision) taking precedence over the job-wide knobs; 0 in
    either slot falls back to that direction's job-wide value. Must
    run BEFORE ``connect()`` on dialing sockets and before
    ``listen()`` on server sockets (accepted sockets inherit): TCP
    fixes the window-scale factor at the SYN/SYN-ACK from the buffer
    size at that moment, so a post-handshake resize cannot widen the
    advertised window."""
    for i, (env, opt) in enumerate(
            (("MP4J_SO_SNDBUF", socket.SO_SNDBUF),
             ("MP4J_SO_RCVBUF", socket.SO_RCVBUF))):
        size = tuning.env_bytes(env, 0, minimum=0)
        if so_bufs is not None and so_bufs[i] > 0:
            size = so_bufs[i]
        if size > 0:
            try:
                sock.setsockopt(socket.SOL_SOCKET, opt, size)
            except OSError as e:
                raise Mp4jError(f"{env}={size} rejected by the "
                                f"kernel: {e}") from None


def set_so_bufs(sock: socket.socket, snd: int | None,
                rcv: int | None) -> None:
    """Per-link buffer resize on a LIVE socket (the tuner's
    boundary application). Post-handshake, so it cannot widen the
    negotiated window scale — it still sizes the kernel's queue
    (useful shrinking, or growing within the scale factor)."""
    if snd:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, int(snd))
    if rcv:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, int(rcv))


def applied_buf_sizes(sock: socket.socket) -> tuple[int, int]:
    """The kernel's ACTUAL (sndbuf, rcvbuf) for this socket — what
    ``comm.link_stats()`` records per link (the kernel may round or
    double requested sizes, so the readback is the truth)."""
    return (sock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF),
            sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF))


def sendall_checked(sock: socket.socket, buf) -> None:
    """THE socket send loop (shared with the shm transport's carrier):
    a socket timeout surfaces as a transport error — a peer that stops
    draining must fail like a dead receiver, not as raw
    socket.timeout. Raw OSErrors propagate (the recovery engine treats
    them as recoverable transport failures)."""
    try:
        sock.sendall(buf)
    except socket.timeout:
        raise Mp4jTransportError(
            "send timed out (peer dead or not draining?)") from None


def recv_into_checked(sock: socket.socket, view: memoryview,
                      whom: str = "", what: str = "connection") -> None:
    """THE socket exact-fill loop (shared with the shm carrier):
    timeout-aware, fail-stop on EOF. ``what`` names the wire in
    diagnostics ("connection" / "shm carrier")."""
    n = len(view)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except socket.timeout:
            raise Mp4jTransportError(
                f"receive timed out with {n - got} bytes pending"
                f"{whom} (peer dead or stalled?)") from None
        if r == 0:
            raise Mp4jTransportError(
                f"peer closed {what} mid-message{whom} "
                f"({n - got}/{n} bytes short)")
        got += r


def drain_half_close(sock: socket.socket) -> None:
    """The graceful-close discipline (shared with the shm carrier):
    FIN after flushing our send queue, then a bounded drain of inbound
    bytes until the peer's FIN — a close with unread inbound data
    would otherwise turn into a TCP RST that discards our queued send
    bytes and truncates the peer's stream mid-message."""
    try:
        sock.shutdown(socket.SHUT_WR)
        sock.settimeout(1.0)
        while sock.recv(65536):
            pass
    except OSError:
        pass   # timeout/reset: the caller falls through to hard close


class TcpChannel(Channel):
    """The Channel SPI over one connected TCP (or UNIX-pair) socket."""

    transport = "tcp"

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.stats = None
        self.peer_rank = None
        self.faults = None
        self.epoch = 0
        self._chunk_bytes = tuning.chunk_bytes()
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP transport (e.g. a UNIX socketpair)
        # also applied here for non-TCP/odd sockets; for TCP the
        # load-bearing application happens BEFORE connect()/listen()
        # (see apply_socket_buf_sizes) — the window scale is fixed at
        # the handshake, so a post-connect resize cannot widen it
        apply_socket_buf_sizes(sock)

    # -- SPI primitives -------------------------------------------------
    def _io_send(self, buf) -> None:
        sendall_checked(self.sock, buf)

    def _io_recv_into(self, view: memoryview) -> None:
        recv_into_checked(self.sock, view, self._whom())

    def set_timeout(self, timeout: float | None) -> None:
        """Transfer timeout, both directions: receives AND sends (a
        peer that stops draining stalls sendall the same way a dead
        sender stalls recv). ``None`` (default) is the reference's
        fail-stop behavior — a dead peer blocks forever; a finite value
        turns that hang into a diagnosable Mp4jError."""
        self.sock.settimeout(timeout)

    def native_fd(self) -> int | None:
        return self.sock.fileno()

    # (the raw plane rides the base's send_raw/recv_raw_into, which
    # delegate to the _io primitives above — one socket loop to fix)

    # -- lifecycle ------------------------------------------------------
    def invalidate(self) -> None:
        """Shut the connection down WITHOUT releasing the fd. The
        recovery teardown runs on the control thread while the
        collective thread may sit inside the native poll loop on this
        channel's raw fd number: ``shutdown`` wakes that poller with
        EOF/HUP, but an immediate ``close`` would free the fd number
        for reuse — a re-dialed channel could then recycle it and the
        still-unwinding native call would poll (or read!) the wrong
        socket. The owner closes invalidated channels later, from the
        collective thread, once no native call can be in flight
        (:meth:`ProcessCommSlave._drain_dead_channels`)."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self, graceful: bool = False) -> None:
        """Close the channel. ``graceful`` half-closes first (FIN after
        flushing our send queue, then a bounded drain of inbound bytes
        until the peer's FIN): a rank finishing its LAST collective
        must not hard-close while a slower peer is still reading our
        buffered bytes — a close with unread inbound data turns into a
        TCP RST that discards our send queue and truncates the peer's
        stream mid-message. Recovery teardown keeps the abrupt default:
        there the hard cut IS the drain (stale frames must die)."""
        if graceful:
            drain_half_close(self.sock)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def connect(host: str, port: int, timeout: float | None = None,
            so_bufs: tuple[int, int] | None = None) -> TcpChannel:
    # buffer sizes must be in place before the TCP handshake (window
    # scale negotiation) — so no create_connection() shortcut here;
    # so_bufs is the per-link override
    err: Exception | None = None
    for family, socktype, proto, _, addr in socket.getaddrinfo(
            host, port, type=socket.SOCK_STREAM):
        sock = socket.socket(family, socktype, proto)
        try:
            apply_socket_buf_sizes(sock, so_bufs)
            sock.settimeout(timeout)
            sock.connect(addr)
            sock.settimeout(None)
            return TcpChannel(sock)
        except OSError as e:
            sock.close()
            err = e
    raise Mp4jTransportError(f"cannot connect to {host}:{port}: {err}")
