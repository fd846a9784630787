"""Transport SPI: the abstract ``Channel`` contract + shared framing.

A copy of ``ytk_mp4j_tpu/transport/channel.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

ytk-mp4j's design premise is that ONE comm API spans in-process
threads, co-located processes and cross-machine sockets. This module is
the seam that makes that true below the collective layer: a
:class:`Channel` is a framed, blocking, bidirectional, order-preserving
byte channel to one peer, and everything the collectives need — object
frames, array frames, paired columnar map frames, the unframed raw
plane, epoch pinning, fault hooks, stats attribution — is implemented
HERE, once, against two transport primitives:

- ``_io_send(buf)`` — blocking write of one buffer, honoring the
  channel's transfer timeout; raises ``Mp4jTransportError`` on a dead
  or stalled peer;
- ``_io_recv_into(view)`` — blocking exact fill of ``view``, same
  contract.

Concrete transports implement just those plus lifecycle
(``set_timeout`` / ``invalidate`` / ``close``):

- :mod:`ytk_mp4j_tpu_torch.transport.tcp` — the reference socket transport
  (framing over ``java.net.Socket`` streams in the reference, SURVEY.md
  section 2);
- :mod:`ytk_mp4j_tpu_torch.transport.shm` — the intra-host shared-memory
  ring transport: same frames, but the "wire" is a lock-free
  ring in a ``multiprocessing.shared_memory`` segment.

Faults, epoch fencing, stats/metrics attribution and recovery compose
as LAYERS over this contract instead of special cases per transport:
the fault injector hooks ride ``_send_all`` / ``_recv_into`` (shared),
``invalidate()`` has one meaning everywhere (wake every blocked
operation with a transport error WITHOUT releasing OS resources — the
owner frees them later, from the collective thread, mirroring the
deferred-close discipline of ``_drain_dead_channels``), and wire stats
carry the channel's ``transport`` tag (tcp|shm) so every byte is
attributable to the plane it rode.

Frame layout (identical on every transport): ``u8 tag | u64
payload_len | payload``. Numeric numpy arrays take the fast path (a
small dtype/shape header, then the raw buffer — no pickling; zero-copy
on receive into a preallocated array); everything else (maps, strings,
objects, control tuples) is pickled — pickle stands in for Kryo. Either
kind may be zlib-compressed on the wire (``compress=True`` on send; the
receiver auto-detects by frame tag). Compressed ARRAYS stream in
``MP4J_CHUNK_BYTES`` pieces (``TAG_ARRAY_ZC``) so the sender's zlib
work on chunk k+1 overlaps the transfer of chunk k; the chunk stream is
self-delimiting (``u32 clen | cbytes`` repeated, ``u32 0`` terminator),
so compressed sizes never need to be known up front.

SPI enforcement: constructing a concrete channel (or a raw
``socket.socket``) outside ``transport/`` is an mp4j-lint R12 error —
rendezvous code paths hold the only baselined exceptions.
"""

from __future__ import annotations

import abc
import pickle
import struct
import time
import zlib

import numpy as np

from ytk_mp4j_tpu_torch.utils import tuning
from ytk_mp4j_tpu_torch.exceptions import Mp4jError

TAG_OBJ = 0
TAG_ARRAY = 1
TAG_OBJ_Z = 2      # zlib-compressed pickle
TAG_ARRAY_Z = 3    # header pickle | zlib-compressed raw buffer
TAG_ARRAY_ZC = 4   # header pickle | streamed compressed chunks

_ZLEVEL = 1  # fast; the trade is wire bytes vs CPU, not ratio records

_HDR = struct.Struct("<BQ")
_U32 = struct.Struct("<I")


def _dtype_token(dt: np.dtype) -> str:
    """Wire name for a dtype. ``dt.str`` for standard numpy dtypes;
    extension float dtypes (ml_dtypes, kind 'V') go by NAME because
    their ``str`` ('<V2') decodes as raw void."""
    return dt.name if dt.kind == "V" else dt.str


def _raw_view(arr: np.ndarray):
    """The array's bytes as a buffer; extension dtypes lack buffer
    support, so reinterpret as uint8."""
    try:
        return memoryview(arr).cast("B")
    except (TypeError, ValueError):
        return arr.view(np.uint8)


class Channel(abc.ABC):
    """A framed, blocking, bidirectional message channel to one peer —
    THE transport contract (see the module docstring).

    ``stats`` (optional, set by the owning slave on peer channels) is a
    :class:`ytk_mp4j_tpu_torch.utils.stats.CommStats`; when present the
    channel books wire seconds/bytes and serialize (pickle/zlib)
    seconds into the current collective's bucket, tagged with this
    channel's ``transport``. ``peer_rank`` (likewise set by the owning
    slave) tags the booked wire spans with the remote rank, so a
    timeline span reads "wire recv<-2" instead of an anonymous
    transfer. ``faults`` is the resilience fault injector; ``epoch``
    the job-wide recovery epoch the channel was established in.
    """

    # class-level defaults so partially-constructed channels (tests
    # build bare instances around transport stand-ins) still frame
    stats = None
    peer_rank = None
    faults = None     # resilience.faults.FaultInjector on peer channels
    epoch = 0         # the job-wide epoch this channel was dialed in
    transport = "?"   # wire-plane tag for stats/metrics (tcp|shm)
    _chunk_bytes = tuning.DEFAULT_CHUNK_BYTES

    # -- transport primitives (the whole SPI surface) -------------------
    @abc.abstractmethod
    def _io_send(self, buf) -> None:
        """Blocking write of one buffer (bytes/memoryview), honoring
        the transfer timeout; ``Mp4jTransportError`` on a dead peer."""

    @abc.abstractmethod
    def _io_recv_into(self, view: memoryview) -> None:
        """Blocking exact fill of ``view``, honoring the transfer
        timeout; ``Mp4jTransportError`` on EOF/teardown/expiry."""

    @abc.abstractmethod
    def set_timeout(self, timeout: float | None) -> None:
        """Transfer timeout, both directions. ``None`` (default) is the
        reference's fail-stop behavior — a dead peer blocks forever; a
        finite value turns that hang into a diagnosable error."""

    @abc.abstractmethod
    def invalidate(self) -> None:
        """Tear the channel down WITHOUT releasing OS resources: every
        blocked (and future) operation on either end must fail with a
        transport error, but fds / shared segments stay allocated — the
        recovery teardown runs on the control thread while the
        collective thread may still sit inside an I/O primitive, and
        releasing a resource under a live operation lets a re-dial
        recycle it into the wrong exchange. The owner frees invalidated
        channels later, from the collective thread, once no operation
        can be in flight (``ProcessCommSlave._drain_dead_channels``)."""

    @abc.abstractmethod
    def close(self, graceful: bool = False) -> None:
        """Release the channel's resources. ``graceful`` flushes and
        drains first where the transport needs it (TCP must not RST a
        slower peer mid-read; the shm ring's bytes outlive the name, so
        graceful is free there)."""

    def native_fd(self) -> int | None:
        """The raw socket fd for the native C++ poll loop, or ``None``
        when this transport has no socket data plane (the caller falls
        back to the Python raw path, which is wire-identical)."""
        return None

    # -- frame-level route hooks -----------------------------
    # The framing layer announces, just before moving a payload unit
    # whose byte length the OTHER end already knows (it traveled in the
    # frame header or a chunk length prefix), how many bytes follow.
    # Transports with more than one wire (the shm ring + carrier pair)
    # override these to steer large units onto the fast plane; both
    # ends derive the same route from the same announced length, so
    # the split can never desync. Base/TCP: one wire, no-ops.
    def _route_send(self, n: int) -> None:
        pass

    def _route_recv(self, n: int) -> None:
        pass

    def set_chunk_bytes(self, n: int) -> None:
        """Per-link pipeline chunk size: sizes this
        channel's streamed-compression pieces and chunked framed
        receives. Receiver-local on a byte-stream transport — the
        peer never needs to agree — which is exactly why the tuner
        may adapt it per link."""
        self._chunk_bytes = max(64, int(n))

    def _audit(self):
        """The owning slave's audit ring when wire folds are armed
        (``MP4J_AUDIT=verify|capture``), else None — rides the stats
        attachment so every peer channel (tcp AND shm) gets per-frame
        wire digests for free, with transport attribution."""
        st = self.stats
        if st is not None:
            audit = st.audit
            if audit is not None and audit.wire_on:
                return audit
        return None

    # -- shared low level -----------------------------------------------
    def _send_all(self, *bufs: bytes | memoryview) -> None:
        t0 = time.perf_counter() if self.stats is not None else 0.0
        audit = self._audit()
        if audit is not None:
            # fold BEFORE any fault injection: the sender's record
            # must describe what it MEANT to send, so a flipped byte
            # below shows up as a sender/receiver digest mismatch
            audit.on_wire(self.peer_rank, "send", bufs, self.transport)
        for b in bufs:
            # per-buffer hook so an injected cut lands BETWEEN the
            # header and payload of one frame — a true mid-frame
            # tear, the hardest drain case for the receiver
            if self.faults is not None:
                self.faults.on_io(self, "send")
                # mp4j-lint: disable=R13 (length read, not a byte serialization)
                f = self.faults.take_corrupt(self, memoryview(b).nbytes)
                if f is not None:
                    from ytk_mp4j_tpu_torch.resilience import faults as _fm

                    b = _fm.corrupt_copy(b)
            self._io_send(b)
        if self.stats is not None:
            self.stats.add_wire(sum(len(b) for b in bufs), 0,
                                time.perf_counter() - t0, chunks=0,
                                peer=self.peer_rank,
                                transport=self.transport)

    def _whom(self) -> str:
        """Peer tag for error messages (empty off the peer plane)."""
        return f" (peer {self.peer_rank})" if self.peer_rank is not None \
            else ""

    def _recv_into(self, view: memoryview) -> None:
        """Fill ``view`` (timeout-aware, fail-stop on a closed peer);
        the building block of every framed receive."""
        t0 = time.perf_counter() if self.stats is not None else 0.0
        if self.faults is not None:
            self.faults.on_io(self, "recv")
        self._io_recv_into(view)
        audit = self._audit()
        if audit is not None:
            # fold AFTER the fill: the receiver's record describes
            # what actually arrived; crc composability makes the
            # chunked receive boundaries irrelevant vs the sender's
            # per-buffer folds
            audit.on_wire(self.peer_rank, "recv", (view,),
                          self.transport)
        if self.stats is not None:
            self.stats.add_wire(0, len(view), time.perf_counter() - t0,
                                chunks=0, peer=self.peer_rank,
                                transport=self.transport)

    def _recv_exact(self, n: int) -> bytearray:
        out = bytearray(n)
        self._recv_into(memoryview(out))
        return out

    def _recv_payload(self, n: int) -> np.ndarray:
        """Large-payload receive buffer: ``np.empty`` skips bytearray's
        zero-fill pass (a whole extra memory write per received MB)."""
        out = np.empty(n, np.uint8)
        self._recv_into(memoryview(out))
        return out

    def _add_serialize(self, t0: float) -> None:
        if self.stats is not None:
            self.stats.add("serialize_seconds", time.perf_counter() - t0)

    def _add_compress(self, raw: int, wire: int) -> None:
        """Book one compression outcome (raw payload bytes -> wire
        bytes) on this link's rolling stats — the observed-ratio
        evidence the tuner's per-link compression policy consumes."""
        if self.stats is not None and self.peer_rank is not None:
            self.stats.add_compress(self.peer_rank, raw, wire)

    # -- objects --------------------------------------------------------
    def send_obj(self, obj, compress: bool = False) -> None:
        t0 = time.perf_counter()
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        tag = TAG_OBJ
        if compress:
            raw_len = len(payload)
            payload = zlib.compress(payload, _ZLEVEL)
            tag = TAG_OBJ_Z
            self._add_compress(raw_len, len(payload))
        self._add_serialize(t0)
        # header first, then the payload as one announced route unit:
        # the header carries the payload length, so a multi-wire
        # transport (shm ring + carrier) steers the payload while both
        # ends agree on the route from the same number
        self._send_all(_HDR.pack(tag, len(payload)))
        self._route_send(len(payload))
        self._send_all(payload)

    # -- arrays (fast path) --------------------------------------------
    def send_array(self, arr: np.ndarray, compress: bool = False) -> None:
        t0 = time.perf_counter()
        arr = np.ascontiguousarray(arr)
        header = pickle.dumps((_dtype_token(arr.dtype), arr.shape))
        self._add_serialize(t0)
        if compress:
            return self._send_array_zc(arr, header)
        ln = len(header) + 4 + arr.nbytes
        self._send_all(_HDR.pack(TAG_ARRAY, ln))
        self._route_send(ln)
        self._send_all(
            struct.pack("<I", len(header)),
            header,
            _raw_view(arr),
        )

    def _send_array_zc(self, arr: np.ndarray, header: bytes) -> None:
        """Streamed compressed array send (TAG_ARRAY_ZC): compress in
        ``MP4J_CHUNK_BYTES`` pieces and put each on the wire as soon as
        it exists, so zlib work on chunk k+1 overlaps the transfer of
        chunk k (and the peer's inflate of chunk k). The declared frame
        payload covers only the header; the chunk stream is
        self-delimiting (u32 length prefixes, 0 terminator), so the
        total compressed size never needs to be known up front."""
        self._send_all(_HDR.pack(TAG_ARRAY_ZC, len(header) + 4))
        self._route_send(len(header) + 4)
        self._send_all(struct.pack("<I", len(header)), header)
        comp = zlib.compressobj(_ZLEVEL)
        view = memoryview(_raw_view(arr)).cast("B")
        step = self._chunk_bytes
        wire_total = 0

        def _ship(piece: bytes) -> None:
            # each compressed piece is its own announced route unit:
            # its length travels on the carrier ahead of it, so both
            # ends route it the same way
            self._send_all(_U32.pack(len(piece)))
            self._route_send(len(piece))
            self._send_all(piece)

        for off in range(0, len(view), step):
            t0 = time.perf_counter()
            piece = comp.compress(view[off:off + step])
            self._add_serialize(t0)
            if piece:
                wire_total += len(piece)
                _ship(piece)
        t0 = time.perf_counter()
        piece = comp.flush()
        self._add_serialize(t0)
        if piece:
            wire_total += len(piece)
            _ship(piece)
        self._send_all(_U32.pack(0))
        self._add_compress(len(view), wire_total)

    # -- paired columnar map frames ------------------------------------
    # The socket map plane's wire unit: a map travels as its
    # int32 code column followed by its value column, two back-to-back
    # array frames forming ONE protocol unit — the receiver always
    # drains both. Riding the array frames (rather than a pickled dict)
    # buys the columnar plane everything the framed path already has:
    # streaming compression (TAG_ARRAY_ZC), no-zero-fill receives, and
    # wire/serialize stats attribution.
    def send_map_columns(self, codes: np.ndarray, values: np.ndarray,
                         compress: bool = False) -> None:
        """Send one (codes, values) column pair. ``compress`` applies
        to the VALUE column only (codes are near-random int32s that
        zlib cannot help; the value column is the bulk of the bytes) —
        a fixed rule, so both ends derive the same wire format from the
        call's operand alone."""
        self.send_array(codes)
        self.send_array(values, compress=compress)

    def recv_map_columns(self) -> tuple[np.ndarray, np.ndarray]:
        """Receive one (codes, values) column pair (protocol-checked:
        a malformed pair is a wire violation, not a recoverable
        condition — both ends derive the pairing from the same
        collective call)."""
        codes = self.recv_array()
        values = self.recv_array()
        if (codes.dtype != np.int32 or codes.ndim != 1
                or values.shape[:1] != codes.shape):
            raise Mp4jError(
                f"malformed map column pair: codes {codes.dtype}"
                f"{codes.shape} vs values {values.shape} (operand "
                "disagreement between sender and receiver?)")
        return codes, values

    # -- raw (unframed) fast path --------------------------------------
    # Sizes never travel on the wire: both peers derive them from the
    # collective's segment metadata, like the reference's primitive
    # DataOutputStream fast path. Used by ProcessCommSlave's numeric
    # collectives (native poll loop when available, these when not).
    # No injector hook here: the raw plane hooks at EXCHANGE
    # granularity (_exchange_raw) so the native poll loop and these
    # fallbacks see identical fault schedules — a second hook here
    # would double-fire slow directives on fallback transports only.
    def send_raw(self, arr: np.ndarray) -> None:
        self._io_send(_raw_view(arr))

    def recv_raw_into(self, arr: np.ndarray) -> None:
        self._io_recv_into(memoryview(_raw_view(arr)))

    # -- unified receive ------------------------------------------------
    @staticmethod
    def _decode_dtype(dtype_str) -> np.dtype:
        try:
            return np.dtype(dtype_str)
        except TypeError:
            import ml_dtypes  # noqa: F401 - registers extension names

            return np.dtype(dtype_str)

    def _recv_zc_into(self, view: memoryview, itemsize: int = 1,
                      on_chunk=None) -> None:
        """Drain a TAG_ARRAY_ZC chunk stream, inflating into ``view``
        as compressed pieces arrive (decompress of chunk k overlaps the
        sender's compress+send of chunk k+1). ``on_chunk(lo, hi)``
        reports progress on ``itemsize``-aligned element boundaries so
        a merge callback only ever sees whole elements."""
        decomp = zlib.decompressobj()
        done = 0          # bytes written
        reported = 0      # elements handed to on_chunk
        chunks = 0

        def _write(piece: bytes):
            nonlocal done
            if done + len(piece) > len(view):
                raise Mp4jError(
                    "compressed stream inflates past the declared "
                    "array size (wire protocol violation)")
            view[done:done + len(piece)] = piece
            done += len(piece)

        def _report():
            nonlocal reported
            ready = done // itemsize
            if on_chunk is not None and ready > reported:
                on_chunk(reported, ready)
                reported = ready

        while True:
            (clen,) = _U32.unpack(bytes(self._recv_exact(4)))
            if clen == 0:
                break
            self._route_recv(clen)
            piece = self._recv_payload(clen)
            t0 = time.perf_counter()
            _write(decomp.decompress(piece))
            self._add_serialize(t0)
            chunks += 1
            _report()
        t0 = time.perf_counter()
        _write(decomp.flush())
        self._add_serialize(t0)
        if done != len(view):
            raise Mp4jError(
                f"compressed stream ended {len(view) - done} bytes "
                "short of the declared array size")
        if self.stats is not None and chunks:
            self.stats.add("chunks", chunks)
        _report()

    def recv(self):
        hdr = self._recv_exact(_HDR.size)
        tag, ln = _HDR.unpack(bytes(hdr))
        # the mirror of the send-side _route_send: the header told us
        # the payload length, so route the same unit the sender did
        if tag in (TAG_OBJ, TAG_OBJ_Z, TAG_ARRAY, TAG_ARRAY_Z,
                   TAG_ARRAY_ZC):
            self._route_recv(ln)
        if tag in (TAG_OBJ, TAG_OBJ_Z):
            payload = self._recv_exact(ln)
            t0 = time.perf_counter()
            if tag == TAG_OBJ_Z:
                payload = zlib.decompress(payload)
            out = pickle.loads(payload)
            self._add_serialize(t0)
            return out
        if tag in (TAG_ARRAY, TAG_ARRAY_Z, TAG_ARRAY_ZC):
            (hlen,) = struct.unpack("<I", bytes(self._recv_exact(4)))
            dtype_str, shape = pickle.loads(self._recv_exact(hlen))
            dt = self._decode_dtype(dtype_str)
            if tag == TAG_ARRAY_ZC:
                arr = np.empty(shape, dtype=dt)
                self._recv_zc_into(memoryview(_raw_view(arr)).cast("B"))
                return arr
            buf = self._recv_payload(ln - 4 - hlen)
            if tag == TAG_ARRAY_Z:
                t0 = time.perf_counter()
                # bytearray keeps the received array writable, like the
                # uncompressed path's recv_into buffer
                buf = bytearray(zlib.decompress(buf))
                self._add_serialize(t0)
            return np.frombuffer(buf, dtype=dt).reshape(shape)
        raise Mp4jError(f"unknown frame tag {tag}")

    def recv_array_into(self, out: np.ndarray, on_chunk=None) -> None:
        """Receive one array frame directly into ``out`` (a contiguous
        writable array of the exact dtype/size the sender framed — both
        ends derive it from the collective's segment metadata, so any
        mismatch is a wire-protocol violation, not a recoverable
        condition).

        ``on_chunk(lo, hi)`` (element range) fires as each
        ``MP4J_CHUNK_BYTES`` piece lands, so the caller's merge of
        chunk k runs cache-hot and overlaps the transfer of chunk k+1 —
        the framed path's half of the pipelined collective engine.
        Uncompressed frames are received in chunked pieces; compressed
        frames inflate piece-by-piece and report progress on element
        boundaries.
        """
        hdr = self._recv_exact(_HDR.size)
        tag, ln = _HDR.unpack(bytes(hdr))
        if tag not in (TAG_ARRAY, TAG_ARRAY_Z, TAG_ARRAY_ZC):
            raise Mp4jError(
                f"expected an array frame, got tag {tag} (operand "
                "disagreement between sender and receiver?)")
        self._route_recv(ln)
        (hlen,) = struct.unpack("<I", bytes(self._recv_exact(4)))
        dtype_str, shape = pickle.loads(self._recv_exact(hlen))
        dt = self._decode_dtype(dtype_str)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if dt != out.dtype or size != out.size:
            raise Mp4jError(
                f"array frame {dt}[{size}] does not match the expected "
                f"{out.dtype}[{out.size}] (segment metadata drift)")
        view = memoryview(_raw_view(out)).cast("B")
        itemsize = out.dtype.itemsize
        if tag == TAG_ARRAY:
            nbody = ln - 4 - hlen
            if nbody != len(view):
                raise Mp4jError(
                    f"array frame carries {nbody} bytes for a "
                    f"{len(view)}-byte destination")
            chunks = 0
            for lo, hi in tuning.chunk_ranges(out.size, itemsize,
                                              self._chunk_bytes):
                self._recv_into(view[lo * itemsize:hi * itemsize])
                chunks += 1
                if on_chunk is not None:
                    on_chunk(lo, hi)
            if self.stats is not None and chunks:
                self.stats.add("chunks", chunks)
            return
        if tag == TAG_ARRAY_Z:
            buf = self._recv_payload(ln - 4 - hlen)
            t0 = time.perf_counter()
            raw = zlib.decompress(buf)
            if len(raw) != len(view):
                raise Mp4jError(
                    f"compressed frame inflates to {len(raw)} bytes "
                    f"for a {len(view)}-byte destination (wire "
                    "protocol violation)")
            view[:] = raw
            self._add_serialize(t0)
            if self.stats is not None:
                self.stats.add("chunks", 1)
            if on_chunk is not None and out.size:
                on_chunk(0, out.size)
            return
        # TAG_ARRAY_ZC: shared streamed-inflate path (same protocol
        # enforcement as the generic recv)
        self._recv_zc_into(view, itemsize=itemsize, on_chunk=on_chunk)

    def recv_array(self) -> np.ndarray:
        out = self.recv()
        if not isinstance(out, np.ndarray):
            raise Mp4jError(f"expected array frame, got {type(out)}")
        return out
