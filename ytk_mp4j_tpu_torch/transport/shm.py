"""Shared-memory intra-host transport behind the Channel SPI.

A copy of ``ytk_mp4j_tpu/transport/shm.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

Co-located slave PROCESSES were paying full TCP + frame-codec tax for
what can be a memcpy. This transport keeps the pair's rendezvous TCP
connection as a **carrier** (control, small transfers, synchronization,
liveness) and moves BULK raw payloads through two lock-free SPSC ring
buffers in a ``multiprocessing.shared_memory`` segment; the frame
codec, stats attribution, fault hooks and epoch fencing all ride the
SPI base unchanged.

Layout per segment (one per peer pair, created by the DIALER)::

    ring A header (64 B) | ring A data (ring_bytes)   dialer -> accepter
    ring B header (64 B) | ring B data (ring_bytes)   accepter -> dialer

Ring header: ``u64 head`` (total bytes written), ``u64 tail`` (total
bytes read), ``u32 poison``. Head/tail are monotone cursors (position =
cursor % capacity), single-writer each — the classic SPSC design
needing no lock: the writer only advances ``head`` after the bytes are
in place, the reader only advances ``tail`` after copying out. 8-byte
aligned loads/stores are atomic on every platform this repo targets.

**Hybrid routing** (the load-bearing design decision, measured on the
bench host): a raw transfer rides the ring only when its byte count
clears ``_RING_MIN``; smaller transfers — and the whole framed plane
(headers, objects, compressed streams, map columns) — ride the carrier
socket directly. Both ends derive the routing from the SAME transfer
size (raw sizes come from the collective's segment metadata; framed
traffic is a byte stream on one vehicle), so the split can never
desync. Rationale: a user-space ring must solve WAKEUP — and every
user-space discipline loses to the kernel's on an oversubscribed host.
Measured on the 1-core bench host: spin/yield ladders burn the peer's
whole scheduler quantum (4x slower than loopback TCP end to end);
select()-parked doorbells fix the median but keep multi-millisecond
scheduler tails (~7ms per small tree collective vs TCP's 1.1ms at the
same ~1.6 context switches — the wakee just isn't run). Small
transfers therefore belong ON the kernel path. Large transfers ride
the ring in **pieces**: the writer copies a piece into the ring and
sends ONE sync byte on the carrier; the reader blocks in a normal
kernel ``recv`` for the sync (TCP-grade wakeup), then copies the piece
straight into the destination array (the zero-copy receive: no staging
buffer). The carrier byte stream per direction is just
[small payloads | sync bytes] in protocol order — both ends agree on
every op, so the streams stay framed without any extra protocol.
Stats attribution: everything a ShmChannel moves — ring bytes AND its
carrier traffic — books under the ``shm`` transport tag; the carrier
is a component of this transport (like TCP's ACKs), not a separate
plane.

Poison/teardown: the header's POISON flag is this transport's
``invalidate()`` — visible to BOTH processes at once — and the carrier
shutdown that accompanies it wakes any blocked kernel recv with EOF,
exactly like a TCP teardown. The segment itself is only released
later, by the owner, from the collective thread
(``_drain_dead_channels``), mirroring the deferred-close discipline
that keeps fd/segment reuse out of still-unwinding operations.
Peer-death detection rides the carrier for free: a SIGKILLed peer's
socket closes and every blocked op errors out.

Knobs (README "Transport tuning"): ``MP4J_SHM`` gates the transport
(default on — rendezvous falls back to TCP for cross-host pairs
automatically); ``MP4J_SHM_RING_BYTES`` sizes each direction's ring.
Segment backing is ``memfd_create`` where available (see
:class:`Segment` — attached via ``/proc/<pid>/fd``, freed by the
kernel on the last close, so even a SIGKILLed job leaks nothing); the
``shm_open`` fallback names segments
``mp4j-<job>-<lo>x<hi>-e<epoch>-<nonce>`` in ``/dev/shm``, unlinked at
close by whichever side closes first (POSIX keeps the memory alive for
the other side's mapping) — there a SIGKILLed job can leak names until
reboot, greppable by prefix.
"""

from __future__ import annotations

import hashlib
import os
import secrets
import select
import socket
import struct
import time
import uuid

from multiprocessing import shared_memory

from ytk_mp4j_tpu_torch.transport.channel import Channel, _raw_view
from ytk_mp4j_tpu_torch.transport.tcp import (
    drain_half_close as tcp_drain_half_close,
    recv_into_checked as tcp_recv_into_checked,
    sendall_checked as tcp_sendall_checked,
)
from ytk_mp4j_tpu_torch.utils import tuning
from ytk_mp4j_tpu_torch.exceptions import Mp4jTransportError

_HDR_BYTES = 64              # one cache line per ring header
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_OFF_HEAD = 0
_OFF_TAIL = 8
_OFF_POISON = 16

# Hybrid routing thresholds (see module docstring). _RING_MIN is the
# smallest raw transfer that rides the ring (smaller ones take the
# carrier's kernel path, whose wakeup latency no user-space wait can
# match on an oversubscribed host); pieces are sized so the reader's
# first kernel wakeup arrives after a fraction of the transfer and the
# two sides stream in parallel through the ring. The value itself
# lives in utils.tuning (the R22 knob discipline: size
# literals feeding transport decisions are centralized there).
_RING_MIN = tuning.SHM_RING_MIN_BYTES
_POLL_SLEEP = 50e-6          # writer's ring-space poll (reader active)
_PARK_TICK = 0.05            # duplex select tick (poison/deadline checks)


def host_fingerprint() -> str:
    """An identifier two slave processes share IFF they can attach each
    other's shared-memory segments: the kernel boot id (same machine,
    same boot) plus the identity of the ``/dev/shm`` tmpfs instance
    (containers share a kernel but usually NOT a /dev/shm mount — the
    device/inode pair tells them apart). Falls back to hostname+MAC on
    systems without either. Rendezvous ships this in the roster; only
    pairs with EQUAL fingerprints negotiate shm."""
    parts = []
    try:
        with open("/proc/sys/kernel/random/boot_id") as fh:
            parts.append(fh.read().strip())
    except OSError:
        parts.append(f"{socket.gethostname()}-{uuid.getnode():x}")
    try:
        st = os.stat("/dev/shm")
        parts.append(f"{st.st_dev:x}.{st.st_ino:x}")
    except OSError:
        pass
    # memfd attach reopens /proc/<pid>/fd/<fd>, which needs a shared
    # PID namespace — containers on one kernel get distinct ns inodes
    try:
        parts.append(f"{os.stat('/proc/self/ns/pid').st_ino:x}")
    except OSError:
        pass
    return hashlib.blake2s("|".join(parts).encode(),
                           digest_size=8).hexdigest()


def segment_name(job: str, lo: int, hi: int, epoch: int) -> str:
    """Segment name for one peer pair: job id + (lo, hi) rank pair +
    epoch + a dialer-chosen nonce (the nonce rides the handshake, so
    the name never needs to be re-derived — a backoff re-dial at the
    same epoch simply mints a fresh segment)."""
    return (f"mp4j-{job}-{lo}x{hi}-e{epoch}-{secrets.token_hex(4)}")


class Segment:
    """One peer pair's shared mapping, behind a uniform handle.

    Preferred backing is ``memfd_create`` + ``mmap``: the attacher
    reopens the creator's fd through ``/proc/<pid>/fd/<fd>`` (the
    ``token`` that rides the peer handshake), the kernel frees the
    memory on the last close (a SIGKILLed job leaks NOTHING), and —
    decisive on this bench host — the mapping stays off the mounted
    ``/dev/shm`` tmpfs: a file mapped from that mount was measured to
    degrade the whole process's SOCKET latencies ~20x (4-proc tree
    exchange 0.10 -> 2.4 ms/iter with one dormant 64 KiB mapping;
    anonymous and memfd mappings are clean — some supervisor watches
    the mount). ``multiprocessing.shared_memory`` remains the fallback
    for kernels without memfd or /proc fd reopen.
    """

    def __init__(self, buf: memoryview, token, closer) -> None:
        self.buf = buf
        self.token = token          # handshake form; see module doc
        self._closer = closer

    def close(self) -> None:
        """Release the mapping (callers release ring views first)."""
        try:
            self.buf.release()
        except (BufferError, ValueError):
            pass
        try:
            self._closer()
        except (OSError, BufferError, ValueError):
            pass


def _memfd_supported() -> bool:
    """One-time probe: memfd + /proc/self/fd reopen + mmap."""
    try:
        fd = os.memfd_create("mp4j-probe")
    except (AttributeError, OSError):
        return False
    try:
        os.ftruncate(fd, 4096)
        ofd = os.open(f"/proc/{os.getpid()}/fd/{fd}", os.O_RDWR)
        os.close(ofd)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


_MEMFD_OK = _memfd_supported()


def _tracker_unregister(name: str) -> None:
    """Drop a segment from THIS process's resource tracker. The stdlib
    registers on BOTH create and attach (bpo-39959) into one per-
    process set, so exact register/unregister pairing is impossible
    when creator and attacher share a process (the thread-hosted test
    harness) — instead the transport owns cleanup outright: unregister
    immediately on create/attach and unlink via :func:`_unlink_quiet`,
    which never touches the tracker. Cost: a SIGKILLed process loses
    the tracker's exit-time sweep — the documented ``/dev/shm`` leak
    window, bounded by the greppable name prefix."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(f"/{name.lstrip('/')}",
                                    "shared_memory")
    # Not a data path: tracker bookkeeping only — a failed unregister
    # costs at worst a stale tracker entry at process exit, never a
    # byte of the collective; tracker internals vary across Pythons.
    # mp4j-lint: disable=R5 (best-effort resource-tracker bookkeeping)
    except Exception:   # pragma: no cover
        pass


def _unlink_quiet(seg_name: str) -> None:
    """Unlink the segment NAME (memory survives for open mappings);
    tracker-free (see :func:`_tracker_unregister`) and idempotent —
    both sides call this at close and the second call finds nothing."""
    try:
        shared_memory._posixshmem.shm_unlink(
            seg_name if seg_name.startswith("/") else "/" + seg_name)
    except (FileNotFoundError, OSError):
        pass


def create_segment(name: str, ring_bytes: int) -> Segment:
    """Create one peer pair's segment (two rings); dialer side. The
    returned handle's ``token`` rides the peer handshake and is all
    the accepter needs to attach."""
    size = 2 * (_HDR_BYTES + ring_bytes)
    if _MEMFD_OK:
        import mmap as mmap_mod

        fd = os.memfd_create(name)
        try:
            os.ftruncate(fd, size)
            mm = mmap_mod.mmap(fd, size)
        except OSError:
            os.close(fd)
            raise
        token = ("memfd", os.getpid(), fd, size)
        # fd stays open for the channel's lifetime: it IS the name the
        # attacher reopens through /proc; the kernel frees the memory
        # when the last of {creator fd+map, attacher map} closes

        def closer(fd=fd, mm=mm):
            mm.close()
            os.close(fd)

        return Segment(memoryview(mm), token, closer)
    seg = shared_memory.SharedMemory(name=name, create=True, size=size)
    _tracker_unregister(name)

    def closer(seg=seg, name=name):
        seg.close()
        _unlink_quiet(name)

    return Segment(seg.buf, ("shm", name), closer)


def attach_segment(token, timeout: float = 5.0) -> Segment:
    """Attach the dialer's segment (accepter side) from its handshake
    token. The creator creates BEFORE sending the handshake, so a miss
    is a narrow race at most — surfaced as a transport error (recovery
    treats it like any torn dial)."""
    if isinstance(token, tuple) and token and token[0] == "memfd":
        import mmap as mmap_mod

        _, pid, fd, size = token
        try:
            ofd = os.open(f"/proc/{pid}/fd/{fd}", os.O_RDWR)
        except OSError as e:
            raise Mp4jTransportError(
                f"cannot attach peer memfd segment (pid {pid} fd "
                f"{fd}): {e} — peer died mid-handshake, or the pid "
                "namespace is not shared (host fingerprint "
                "collision?)") from None
        try:
            mm = mmap_mod.mmap(ofd, size)
        finally:
            os.close(ofd)
        return Segment(memoryview(mm), token, mm.close)
    name = token[1] if isinstance(token, tuple) else str(token)
    deadline = time.monotonic() + timeout
    while True:
        try:
            seg = shared_memory.SharedMemory(name=name)
            _tracker_unregister(name)

            def closer(seg=seg, name=name):
                seg.close()
                _unlink_quiet(name)

            return Segment(seg.buf, ("shm", name), closer)
        except FileNotFoundError:
            if time.monotonic() > deadline:
                raise Mp4jTransportError(
                    f"shm segment {name!r} never appeared (peer died "
                    "mid-handshake, or /dev/shm is not shared — host "
                    "fingerprint collision?)") from None
            time.sleep(0.002)


class _Ring:
    """One direction of the channel: an SPSC byte ring over a slice of
    the shared segment. Each side constructs its own ``_Ring`` views;
    the roles (who writes, who reads) are fixed by the channel."""

    def __init__(self, buf: memoryview, base: int, cap: int):
        self._hdr = buf[base:base + _HDR_BYTES]
        self._data = buf[base + _HDR_BYTES:base + _HDR_BYTES + cap]
        self._cap = cap

    # cursor accessors (single 8-byte aligned load/store each)
    def _head(self) -> int:
        return _U64.unpack_from(self._hdr, _OFF_HEAD)[0]

    def _tail(self) -> int:
        return _U64.unpack_from(self._hdr, _OFF_TAIL)[0]

    def _set_head(self, v: int) -> None:
        _U64.pack_into(self._hdr, _OFF_HEAD, v)

    def _set_tail(self, v: int) -> None:
        _U64.pack_into(self._hdr, _OFF_TAIL, v)

    @property
    def poisoned(self) -> bool:
        return _U32.unpack_from(self._hdr, _OFF_POISON)[0] != 0

    def poison(self) -> None:
        _U32.pack_into(self._hdr, _OFF_POISON, 1)

    def release(self) -> None:
        """Drop the memoryview slices so the segment's mmap can close
        (an exported buffer would make SharedMemory.close raise)."""
        self._hdr.release()
        self._data.release()

    # -- data movement (bounded attempts; callers own waits) ------------
    def write_some(self, src: memoryview, off: int, limit: int) -> int:
        """ONE bounded copy attempt: move up to ``limit`` bytes of
        ``src[off:]`` into the ring (0 = full). Data lands before the
        head advances — the SPSC publication order."""
        cap, data = self._cap, self._data
        head = self._head()
        free = cap - (head - self._tail())
        if free <= 0:
            return 0
        take = min(free, limit, len(src) - off)
        pos = head % cap
        first = min(take, cap - pos)
        data[pos:pos + first] = src[off:off + first]
        if take > first:
            data[:take - first] = src[off + first:off + take]
        self._set_head(head + take)
        return take

    def read_exact(self, dst: memoryview, off: int, n: int) -> None:
        """Copy EXACTLY ``n`` available bytes into ``dst[off:]``
        DIRECTLY (the zero-copy receive — no staging buffer between
        the ring and the caller's array). The caller guarantees
        availability (a sync byte arrived for this piece)."""
        cap, data = self._cap, self._data
        tail = self._tail()
        pos = tail % cap
        first = min(n, cap - pos)
        dst[off:off + first] = data[pos:pos + first]
        if n > first:
            dst[off + first:off + n] = data[:n - first]
        self._set_tail(tail + n)


class ShmChannel(Channel):
    """The Channel SPI over one shared-memory segment (two rings) plus
    the pair's TCP carrier socket (framed plane, small raw transfers,
    ring sync bytes, liveness).

    ``owner`` marks the segment's creator (the dialer): ownership only
    decides who created; BOTH sides attempt the unlink at close (the
    first wins, POSIX keeps the memory mapped for the laggard), so a
    one-sided crash-free shutdown never leaks the name.
    """

    transport = "shm"

    def __init__(self, sock: socket.socket, seg: Segment,
                 ring_bytes: int, owner: bool):
        self.sock = sock
        self.stats = None
        self.peer_rank = None
        self.faults = None
        self.epoch = 0
        self._chunk_bytes = tuning.chunk_bytes()
        self._seg = seg
        self._owner = owner
        self._timeout: float | None = None
        self._closed = False
        # frame-level ring routing: framed payload units at
        # or above this threshold stream through the ring; 0 keeps the
        # whole framed plane on the carrier (the carrier-only layout)
        self._frame_min = tuning.shm_frame_min()
        self._tx_stream: dict | None = None
        self._rx_stream: dict | None = None
        # piece size: reader's first wakeup lands after a fraction of
        # a large transfer; half-ring keeps writer and reader streaming
        # in parallel through the same ring
        self._piece = max(ring_bytes // 2, tuning.SHM_RING_FLOOR)
        ring_a = _Ring(seg.buf, 0, ring_bytes)
        ring_b = _Ring(seg.buf, _HDR_BYTES + ring_bytes, ring_bytes)
        # ring A is dialer->accepter by convention
        self._tx, self._rx = (ring_a, ring_b) if owner else (ring_b,
                                                             ring_a)
        sock.settimeout(None)

    # -- carrier primitives (kernel path; shm-flavored diagnostics) -----
    def set_timeout(self, timeout: float | None) -> None:
        self._timeout = timeout
        try:
            self.sock.settimeout(timeout)
        except OSError:
            pass

    # carrier I/O rides THE shared socket loops (transport/tcp.py) —
    # one place to fix socket semantics for both transports; the only
    # shm flavor is the poison-aware EOF upgrade (an invalidated
    # channel must say so, not "peer closed"). The
    # framing layer's route hooks may arm a FRAME STREAM, steering a
    # payload unit's bytes through the ring while its header (and the
    # sync bytes) keep the carrier.
    def _io_send(self, buf) -> None:
        st = self._tx_stream
        if st is not None:
            # wire-ready byte buffers only: _send_all's callers pin
            # contiguity/dtype before framing (channel.py discipline)
            # mp4j-lint: disable=R13 (already-serialized frame bytes)
            view = memoryview(buf)
            if view.ndim != 1 or view.format != "B":
                view = view.cast("B")
            take = min(len(view), st["end"] - st["pos"])
            self._stream_send(view[:take], st)
            if take < len(view):
                tcp_sendall_checked(self.sock, view[take:])
            return
        tcp_sendall_checked(self.sock, buf)

    def _io_recv_into(self, view: memoryview) -> None:
        st = self._rx_stream
        if st is not None:
            take = min(len(view), st["end"] - st["pos"])
            self._stream_recv(view[:take], st)
            if take < len(view):
                self._carrier_recv_into(view[take:])
            return
        self._carrier_recv_into(view)

    def _carrier_recv_into(self, view: memoryview) -> None:
        try:
            tcp_recv_into_checked(self.sock, view, self._whom(),
                                  what="shm carrier")
        except Mp4jTransportError:
            if self._tx.poisoned or self._rx.poisoned:
                raise Mp4jTransportError(
                    f"shm channel invalidated{self._whom()} "
                    f"({len(view)} byte receive torn)") from None
            raise

    # -- frame-level ring routing ----------------------------
    # The framing layer announces each payload unit whose length the
    # peer already knows (frame header / chunk length prefix). Units
    # clearing MP4J_SHM_FRAME_MIN become a RING STREAM: the unit's
    # bytes move through the SPSC ring in the same piece schedule the
    # raw plane uses — a pure function of (unit length, ring size), so
    # both ends agree without 1:1 buffer pairing: the sender may write
    # in any granularity (u32 prefix, pickle header, array body) and
    # the receiver may read in any other (header peek, chunked fills);
    # the stream serves both against the shared piece/sync schedule.
    def _route_send(self, n: int) -> None:
        if 0 < self._frame_min <= n:
            self._check_poison("send")
            self._tx_stream = {"end": n, "pos": 0, "idx": 0,
                               "pieces": self._pieces(n),
                               "bound": 0}
            self._tx_stream["bound"] = self._tx_stream["pieces"][0]

    def _route_recv(self, n: int) -> None:
        if 0 < self._frame_min <= n:
            self._check_poison("recv")
            self._rx_stream = {"end": n, "pos": 0, "idx": 0,
                               "pieces": self._pieces(n),
                               "synced": 0}

    def _stream_send(self, src: memoryview, st: dict) -> None:
        """Move ``src`` into the tx ring as part of the armed frame
        stream, publishing one carrier sync byte per completed piece
        (the kernel-grade wakeup the reader blocks on)."""
        deadline = (None if self._timeout is None
                    else time.monotonic() + self._timeout)
        off, n = 0, len(src)
        while off < n:
            moved = self._tx.write_some(src, off, st["bound"] - st["pos"])
            if moved:
                off += moved
                st["pos"] += moved
                if st["pos"] == st["bound"]:
                    # piece complete -> ONE kernel wakeup; sync bytes
                    # bypass _io_send (the stream must not recurse)
                    tcp_sendall_checked(self.sock, b"\x01")
                    st["idx"] += 1
                    if st["idx"] < len(st["pieces"]):
                        st["bound"] += st["pieces"][st["idx"]]
                continue
            if self._tx.poisoned or self._rx.poisoned:
                self._raise_poisoned("send", n - off)
            if deadline is not None and time.monotonic() > deadline:
                raise Mp4jTransportError(
                    f"shm frame-stream send timed out with {n - off} "
                    f"bytes pending{self._whom()} (peer dead or "
                    "stalled?)")
            time.sleep(_POLL_SLEEP)
        if st["pos"] >= st["end"]:
            self._tx_stream = None
        if self.stats is not None and n:
            self.stats.add("wire_bytes_shm_ring", n)

    def _stream_recv(self, view: memoryview, st: dict) -> None:
        """Fill ``view`` from the rx ring's armed frame stream,
        blocking in a normal kernel recv for each piece's sync byte
        (TCP-grade wakeup) — after which the piece's bytes are
        GUARANTEED present in the ring."""
        sync = bytearray(1)
        off, n = 0, len(view)
        while off < n:
            if st["pos"] == st["synced"]:
                self._carrier_recv_into(memoryview(sync))
                if self._tx.poisoned or self._rx.poisoned:
                    self._raise_poisoned("recv", n - off)
                st["synced"] += st["pieces"][st["idx"]]
                st["idx"] += 1
            take = min(n - off, st["synced"] - st["pos"])
            self._rx.read_exact(view, off, take)
            off += take
            st["pos"] += take
        if st["pos"] >= st["end"]:
            self._rx_stream = None
        if self.stats is not None and n:
            self.stats.add("wire_bytes_shm_ring", n)

    # -- raw plane: hybrid ring/carrier routing -------------------------
    def _check_poison(self, op: str) -> None:
        """Fail FAST on a poisoned channel, not only when blocked: an
        invalidated ring may still have free space (writes) or stale
        bytes (reads), and letting an operation 'succeed' against a
        torn epoch is exactly what invalidate exists to prevent."""
        if self._tx.poisoned or self._rx.poisoned:
            raise Mp4jTransportError(
                f"shm channel invalidated{self._whom()} "
                f"(attempted {op} on a torn-down ring)")

    def _pieces(self, n: int) -> list[int]:
        """Piece sizes for an ``n``-byte ring transfer — a pure
        function of (n, ring size), so sender and receiver always
        agree on the sync-byte count."""
        p = self._piece
        return [min(p, n - off) for off in range(0, n, p)]

    def send_raw(self, arr) -> None:
        src = memoryview(_raw_view(arr)).cast("B")
        n = len(src)
        if n < _RING_MIN:
            self._io_send(src)
            return
        self._check_poison("send")
        deadline = (None if self._timeout is None
                    else time.monotonic() + self._timeout)
        off = 0
        for size in self._pieces(n):
            end = off + size
            while off < end:
                moved = self._tx.write_some(src, off, end - off)
                if moved:
                    off += moved
                    continue
                # ring full: the reader is behind but AWAKE (its sync
                # for the previous piece was sent) — a short poll is
                # cheap relative to the memcpy it waits on
                if self._tx.poisoned or self._rx.poisoned:
                    self._raise_poisoned("send", n - off)
                if deadline is not None and time.monotonic() > deadline:
                    raise Mp4jTransportError(
                        f"shm send timed out with {n - off} bytes "
                        f"pending{self._whom()} (peer dead or stalled?)")
                time.sleep(_POLL_SLEEP)
            # piece complete -> ONE kernel-grade wakeup on the carrier
            # (direct: sync bytes must never enter a frame stream)
            tcp_sendall_checked(self.sock, b"\x01")
        if self.stats is not None:
            self.stats.add("wire_bytes_shm_ring", n)

    def recv_raw_into(self, arr) -> None:
        dst = memoryview(_raw_view(arr)).cast("B")
        n = len(dst)
        if n < _RING_MIN:
            self._io_recv_into(dst)
            return
        self._check_poison("recv")
        sync = bytearray(1)
        off = 0
        for size in self._pieces(n):
            # block in a normal kernel recv for the piece's sync byte
            # (TCP-grade wakeup), then the piece is GUARANTEED present
            self._carrier_recv_into(memoryview(sync))
            if self._tx.poisoned or self._rx.poisoned:
                self._raise_poisoned("recv", n - off)
            self._rx.read_exact(dst, off, size)
            off += size
        if self.stats is not None:
            self.stats.add("wire_bytes_shm_ring", n)

    def _raise_poisoned(self, op: str, pending: int) -> None:
        raise Mp4jTransportError(
            f"shm ring poisoned mid-{op}{self._whom()} "
            f"({pending} bytes pending; channel invalidated)")

    # -- lifecycle ------------------------------------------------------
    def invalidate(self) -> None:
        """Poison both rings (shared state: the REMOTE side's blocked
        ring waits observe it too) and shut the carrier down — which
        wakes every blocked kernel recv/sync wait on BOTH ends with
        EOF, like a TCP teardown. The segment itself stays mapped —
        the owner frees it later via :meth:`close` from the collective
        thread (``_drain_dead_channels``), the same deferred-release
        discipline the TCP transport applies to fds."""
        try:
            self._tx.poison()
            self._rx.poison()
        except ValueError:
            pass    # already released by close
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self, graceful: bool = False) -> None:
        """Release the mapping and unlink the segment name. ``graceful``
        skips the poison: a finishing rank's final bytes live in the
        carrier/ring, and POSIX keeps the ring memory alive for the
        peer's mapping until it closes too; an abrupt close poisons
        first so a blocked peer errors instead of waiting on a
        corpse."""
        if self._closed:
            return
        self._closed = True
        if graceful:
            # the carrier carries REAL bytes (framed plane, small raw
            # transfers, ring syncs): the same half-close + bounded
            # drain as TCP, or closing with unread inbound data RSTs
            # away our queued final bytes under a slower peer
            tcp_drain_half_close(self.sock)
        else:
            try:
                self._tx.poison()
                self._rx.poison()
            except ValueError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._tx.release()
        self._rx.release()
        # memfd: the kernel frees the memory with the last close; shm
        # fallback: the Segment closer also unlinks the name (both
        # sides attempt it; the second finds nothing — no coordination
        # needed)
        self._seg.close()


def duplex_exchange(send_ch: ShmChannel | None, sarr,
                    recv_ch: ShmChannel | None, rarr) -> None:
    """Full-duplex raw exchange over shm channels in ONE thread — the
    shm analogue of the native C++ socket poll loop (a helper-thread
    send would ping-pong the GIL around user-space memcpys and pay a
    pool-future handoff per pipeline chunk). Interleaves the hybrid
    send/recv plans (ring pieces + carrier sync bytes, or small
    payloads on the carrier) against nonblocking carrier I/O, parking
    in ``select()`` only when NEITHER direction can move. ``send_ch``
    and ``recv_ch`` may be the same channel (partner exchange) or
    different (ring step); either side may be absent (None array)."""
    if sarr is None and rarr is None:
        return
    if sarr is None:
        recv_ch.recv_raw_into(rarr)
        return
    if rarr is None:
        send_ch.send_raw(sarr)
        return
    sv = memoryview(_raw_view(sarr)).cast("B")
    rv = memoryview(_raw_view(rarr)).cast("B")
    sn, rn = len(sv), len(rv)
    s_ring = sn >= _RING_MIN
    r_ring = rn >= _RING_MIN
    if s_ring:
        send_ch._check_poison("send")
    if r_ring:
        recv_ch._check_poison("recv")
    deadline = (None if send_ch._timeout is None
                else time.monotonic() + send_ch._timeout)
    # plans: sender side emits [pieces -> sync bytes] or raw payload
    # into the carrier; receiver side consumes the mirror stream
    s_pieces = send_ch._pieces(sn) if s_ring else []
    r_pieces = recv_ch._pieces(rn) if r_ring else []
    soff = roff = 0               # payload progress
    s_piece_end = (soff + s_pieces[0]) if s_pieces else 0
    s_piece_idx = 0
    s_sync_due = 0                # sync bytes owed to the carrier
    r_piece_idx = 0
    r_sync_got = 0                # sync bytes received, pieces unread
    ssock, rsock = send_ch.sock, recv_ch.sock
    ssock.setblocking(False)
    if rsock is not ssock:
        rsock.setblocking(False)
    try:
        while soff < sn or roff < rn or s_sync_due:
            progressed = False
            # 1) sender: ring pieces
            if s_ring and soff < sn:
                moved = send_ch._tx.write_some(sv, soff,
                                               s_piece_end - soff)
                if moved:
                    progressed = True
                    soff += moved
                    if soff == s_piece_end:
                        s_sync_due += 1
                        s_piece_idx += 1
                        if s_piece_idx < len(s_pieces):
                            s_piece_end += s_pieces[s_piece_idx]
            # 2) sender: carrier bytes (sync bytes, or the small
            #    payload itself)
            try:
                if s_sync_due:
                    sent = ssock.send(b"\x01" * s_sync_due)
                    if sent:
                        progressed = True
                        s_sync_due -= sent
                elif not s_ring and soff < sn:
                    sent = ssock.send(sv[soff:])
                    if sent:
                        progressed = True
                        soff += sent
            except (BlockingIOError, InterruptedError):
                pass
            except OSError as e:
                raise Mp4jTransportError(
                    f"shm carrier failed mid-send"
                    f"{send_ch._whom()}: {e}") from None
            # 3) receiver: carrier bytes (sync bytes or payload)
            if roff < rn:
                try:
                    if r_ring:
                        data = rsock.recv(len(r_pieces) - r_piece_idx
                                          - r_sync_got)
                        if data:
                            progressed = True
                            r_sync_got += len(data)
                        elif data == b"":
                            _eof(recv_ch, rn - roff)
                    else:
                        got = rsock.recv_into(rv[roff:], rn - roff)
                        if got:
                            progressed = True
                            roff += got
                        else:
                            _eof(recv_ch, rn - roff)
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError as e:
                    raise Mp4jTransportError(
                        f"shm carrier failed mid-receive"
                        f"{recv_ch._whom()}: {e}") from None
            # 4) receiver: drain synced ring pieces
            while r_sync_got:
                size = r_pieces[r_piece_idx]
                recv_ch._rx.read_exact(rv, roff, size)
                roff += size
                r_piece_idx += 1
                r_sync_got -= 1
                progressed = True
            if progressed:
                continue
            if (send_ch._tx.poisoned or send_ch._rx.poisoned
                    or recv_ch._tx.poisoned or recv_ch._rx.poisoned):
                raise Mp4jTransportError(
                    f"shm ring poisoned mid-exchange"
                    f"{send_ch._whom()} ({sn - soff + rn - roff} "
                    "bytes pending; channel invalidated)")
            if deadline is not None and time.monotonic() > deadline:
                raise Mp4jTransportError(
                    f"shm exchange timed out ({sn - soff} send / "
                    f"{rn - roff} recv bytes pending; peer dead "
                    "or stalled?)")
            # nothing moved: park until the peer's carrier traffic
            # (sync/payload/EOF) or until our carrier drains
            rlist = [rsock] if roff < rn else []
            wlist = [ssock] if (s_sync_due
                               or (not s_ring and soff < sn)) else []
            if not rlist and not wlist:
                # waiting on ring SPACE only (peer reader behind)
                time.sleep(_POLL_SLEEP)
                continue
            try:
                select.select(rlist, wlist, [], _PARK_TICK)
            except (OSError, ValueError):
                pass    # torn carrier: the next recv/send adjudicates
        ring_bytes_moved = (sn if s_ring else 0) + (rn if r_ring else 0)
        if ring_bytes_moved and send_ch.stats is not None:
            send_ch.stats.add("wire_bytes_shm_ring", ring_bytes_moved)
    finally:
        try:
            ssock.settimeout(send_ch._timeout)
            if rsock is not ssock:
                rsock.settimeout(recv_ch._timeout)
        except OSError:
            pass



def _eof(ch: ShmChannel, pending: int) -> None:
    if ch._tx.poisoned or ch._rx.poisoned:
        ch._raise_poisoned("exchange", pending)
    raise Mp4jTransportError(
        f"peer closed shm carrier mid-exchange{ch._whom()} "
        f"({pending} bytes pending; peer process dead?)")


# ----------------------------------------------------------------------
# engine-leg pumps: ONE DIRECTION of the async engine's
# chunk-granular shm schedule, nonblocking. The async raw engine
# (comm/progress.py) decouples an exchange into independent send/recv
# legs with per-(peer, direction) FIFO queues; these pumps give a shm
# leg the same incremental, never-blocking contract a nonblocking TCP
# socket gives a tcp leg — so shm-paired collectives can interleave on
# the engine instead of executing as one atomic blocking step.
#
# Wire contract: the per-direction byte streams are IDENTICAL to the
# blocking chunked exchange's. The leg's payload splits at the same
# chunk boundaries (`_chunk_for(peer)` element ranges, passed in as
# byte bounds), and each chunk routes exactly like one
# `_exchange_raw` step: below `_RING_MIN` the chunk's raw bytes ride
# the carrier; at or above, the chunk moves through the SPSC ring in
# the shared `_pieces` schedule with ONE carrier sync byte per
# completed piece. Chunks complete strictly in order — chunk k's
# carrier traffic (payload or sync bytes) fully precedes chunk k+1's,
# which is the per-direction stream order the blocking twin emits — so
# a mixed engine/blocking pair can never desync.
# ----------------------------------------------------------------------
class SendPump:
    """Nonblocking chunk-granular sender for one engine leg.

    ``pump()`` moves whatever can move RIGHT NOW (ring space, carrier
    writability) and returns the payload bytes shipped; ``done`` flips
    only once the payload AND every owed sync byte are flushed —
    retiring a leg with syncs pending would let the next leg on the
    same (peer, send) queue jump the carrier stream. The caller owns
    waits (select on ``want_carrier``, short ticks for ``ring_wait``)
    and stall deadlines."""

    __slots__ = ("ch", "view", "bounds", "ci", "off", "sync_due",
                 "ring", "pieces", "piece_idx", "piece_end")

    def __init__(self, ch: ShmChannel, view: memoryview,
                 bounds: list[tuple[int, int]]):
        self.ch = ch
        self.view = view
        self.bounds = bounds      # ascending byte (lo, hi) chunk bounds
        self.ci = -1
        self.off = 0              # payload bytes shipped (ring+carrier)
        self.sync_due = 0         # sync bytes owed to the carrier
        self.ring = False
        self.pieces: list[int] = []
        self.piece_idx = 0
        self.piece_end = 0
        self._next_chunk()

    def _next_chunk(self) -> None:
        self.ci += 1
        if self.ci >= len(self.bounds):
            return
        lo, hi = self.bounds[self.ci]
        self.ring = hi - lo >= _RING_MIN
        if self.ring:
            self.ch._check_poison("send")
            self.pieces = self.ch._pieces(hi - lo)
            self.piece_idx = 0
            self.piece_end = lo + self.pieces[0]

    @property
    def done(self) -> bool:
        return self.ci >= len(self.bounds) and self.sync_due == 0

    @property
    def want_carrier(self) -> bool:
        """Parking hint: carrier writability would unblock us."""
        return self.sync_due > 0 or (self.ci < len(self.bounds)
                                     and not self.ring)

    @property
    def ring_wait(self) -> bool:
        """Parking hint: blocked on ring SPACE only (peer reader
        behind) — nothing selectable; the caller should tick short."""
        return (self.sync_due == 0 and self.ci < len(self.bounds)
                and self.ring)

    def _flush_syncs(self) -> int:
        try:
            sent = self.ch.sock.send(b"\x01" * self.sync_due)
        except (BlockingIOError, InterruptedError):
            return 0
        except OSError as e:
            raise Mp4jTransportError(
                f"shm carrier failed mid-send{self.ch._whom()}: {e}"
            ) from None
        self.sync_due -= sent
        return sent

    def pump(self) -> int:
        ch = self.ch
        moved = 0
        while True:
            # owed sync bytes first: they precede every later chunk's
            # bytes in this direction's carrier stream
            if self.sync_due:
                if not self._flush_syncs():
                    if ch._tx.poisoned or ch._rx.poisoned:
                        ch._raise_poisoned(
                            "send", self.bounds[-1][1] - self.off)
                    return moved
                if self.sync_due:
                    return moved
                continue
            if self.ci >= len(self.bounds):
                return moved
            lo, hi = self.bounds[self.ci]
            if not self.ring:
                try:
                    sent = ch.sock.send(self.view[self.off:hi])
                except (BlockingIOError, InterruptedError):
                    return moved
                except OSError as e:
                    raise Mp4jTransportError(
                        f"shm carrier failed mid-send"
                        f"{ch._whom()}: {e}") from None
                if not sent:
                    return moved
                self.off += sent
                moved += sent
                if self.off >= hi:
                    self._next_chunk()
                continue
            if self.off >= hi and self.piece_idx >= len(self.pieces):
                # every piece written and synced: chunk complete
                if ch.stats is not None:
                    ch.stats.add("wire_bytes_shm_ring", hi - lo)
                self._next_chunk()
                continue
            w = ch._tx.write_some(self.view, self.off,
                                  self.piece_end - self.off)
            if not w:
                if ch._tx.poisoned or ch._rx.poisoned:
                    ch._raise_poisoned("send",
                                       self.bounds[-1][1] - self.off)
                return moved      # ring full: reader behind but awake
            self.off += w
            moved += w
            if self.off == self.piece_end:
                # piece complete -> ONE kernel-grade wakeup owed
                self.sync_due += 1
                self.piece_idx += 1
                if self.piece_idx < len(self.pieces):
                    self.piece_end += self.pieces[self.piece_idx]


class RecvPump:
    """Nonblocking chunk-granular receiver for one engine leg (the
    :class:`SendPump` mirror). Payload lands in ``view`` in ascending
    contiguous order — ring pieces copy straight into the destination
    (the zero-copy receive), so the caller can fold/merge the
    ``[prev, off)`` delta after every ``pump()``. Never reads past the
    current chunk's carrier traffic: a greedy read could swallow the
    NEXT chunk's raw payload along with this one's sync bytes."""

    __slots__ = ("ch", "view", "bounds", "ci", "off",
                 "ring", "pieces", "piece_idx", "sync_got")

    def __init__(self, ch: ShmChannel, view: memoryview,
                 bounds: list[tuple[int, int]]):
        self.ch = ch
        self.view = view
        self.bounds = bounds
        self.ci = -1
        self.off = 0              # payload bytes landed in view
        self.ring = False
        self.pieces: list[int] = []
        self.piece_idx = 0
        self.sync_got = 0         # synced pieces not yet drained
        self._next_chunk()

    def _next_chunk(self) -> None:
        self.ci += 1
        if self.ci >= len(self.bounds):
            return
        lo, hi = self.bounds[self.ci]
        self.ring = hi - lo >= _RING_MIN
        if self.ring:
            self.ch._check_poison("recv")
            self.pieces = self.ch._pieces(hi - lo)
            self.piece_idx = 0
            self.sync_got = 0

    @property
    def done(self) -> bool:
        return self.ci >= len(self.bounds)

    def pump(self) -> int:
        ch = self.ch
        moved = 0
        while True:
            if self.ci >= len(self.bounds):
                return moved
            lo, hi = self.bounds[self.ci]
            if not self.ring:
                try:
                    got = ch.sock.recv_into(self.view[self.off:hi],
                                            hi - self.off)
                except (BlockingIOError, InterruptedError):
                    return moved
                except OSError as e:
                    raise Mp4jTransportError(
                        f"shm carrier failed mid-receive"
                        f"{ch._whom()}: {e}") from None
                if got == 0:
                    _eof(ch, self.bounds[-1][1] - self.off)
                self.off += got
                moved += got
                if self.off >= hi:
                    self._next_chunk()
                continue
            # drain every synced ring piece straight into the view
            while self.sync_got:
                size = self.pieces[self.piece_idx]
                ch._rx.read_exact(self.view, self.off, size)
                self.off += size
                self.piece_idx += 1
                self.sync_got -= 1
                moved += size
            if self.off >= hi:
                if ch.stats is not None:
                    ch.stats.add("wire_bytes_shm_ring", hi - lo)
                self._next_chunk()
                continue
            # sync bytes: bounded to THIS chunk's remaining pieces
            want = len(self.pieces) - self.piece_idx - self.sync_got
            try:
                data = ch.sock.recv(want)
            except (BlockingIOError, InterruptedError):
                if ch._tx.poisoned or ch._rx.poisoned:
                    ch._raise_poisoned(
                        "recv", self.bounds[-1][1] - self.off)
                return moved
            except OSError as e:
                raise Mp4jTransportError(
                    f"shm carrier failed mid-receive"
                    f"{ch._whom()}: {e}") from None
            if not data:
                _eof(ch, self.bounds[-1][1] - self.off)
            self.sync_got += len(data)
