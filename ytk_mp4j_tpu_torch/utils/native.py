"""Build and call the native hot loops of the socket plane and the libsvm
parser (the port of ``ytk_mp4j_tpu/utils/native.py``).

Three sources, copies of the reference's, build with ``g++`` into one
shared library with a plain C interface that ``ctypes`` loads:
``csrc/mp4j_native.cpp`` (the element-wise merge), ``csrc/mp4j_transport.cpp``
(the poll-driven raw data plane and the engine's multi-leg drivers) and
``csrc/mp4j_parse.cpp`` (the libsvm chunk parser). The library is
``ytk_mp4j_tpu_torch/csrc/build/libmp4j_native-<digest>.so``, the digest
covering the sources and the flags, so an edited source builds anew and
an unchanged one is reused (several processes may build at once: each
writes its own temporary file and renames it into place). Nothing builds
when the module is imported.

- :func:`reduce_into` -- ``acc = op(acc, src)`` element-wise, the socket
  plane's merge loop;
- :func:`sendrecv_raw` -- the full-duplex raw socket exchange under
  ``ProcessCommSlave``'s numeric collectives;
- :func:`progress_multi` / :func:`run_legs` -- the progression engine's
  native drivers (``comm/progress.py``);
- :func:`parse_libsvm_chunk` -- the parser under ``utils/libsvm.py``.

A failed build behaves two ways, each on purpose:

- the merge and the data plane take the reference's numpy and Python
  paths, whose wire format is the same; :data:`HAVE_NATIVE` says which
  is active (None until the first attempt);
- the parser raises :class:`~ytk_mp4j_tpu_torch.exceptions.Mp4jError`
  with the compiler's output (the reference falls back to its Python
  parser).

Divergences from the reference: the digest-named library under the
port's build directory (the reference compares modification times of a
fixed name), the raising parser, and ``Operator.kernel_code`` where the
reference reads ``native_code`` (the same ids).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ytk_mp4j_tpu_torch.exceptions import Mp4jError

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
SOURCES = (CSRC / "mp4j_native.cpp", CSRC / "mp4j_transport.cpp",
           CSRC / "mp4j_parse.cpp")
BUILD_DIR = CSRC / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native")

# Must match csrc/mp4j_native.cpp DType.
_DTYPE_CODES = {
    np.dtype(np.float64): 0,
    np.dtype(np.float32): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.int16): 4,
    np.dtype(np.int8): 5,
}

_lock = threading.Lock()
_lib = None
_build_error: Mp4jError | None = None
# Tri-state: None = not attempted, True = loaded, False = unavailable
# (the negative result is cached so the hot loop never retries the build).
HAVE_NATIVE: bool | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmp4j_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    ``Mp4jError`` with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise Mp4jError("no C++ compiler (g++) to build the native library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *FLAGS, *map(str, SOURCES), "-o",
                               str(tmp)], capture_output=True, text=True)
        if proc.returncode:
            names = ", ".join(s.name for s in SOURCES)
            raise Mp4jError(f"building {names} failed:\n"
                            f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(lib) -> None:
    lib.mp4j_reduce.restype = ctypes.c_int
    lib.mp4j_reduce.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.mp4j_sendrecv_raw.restype = ctypes.c_int
    lib.mp4j_sendrecv_raw.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.mp4j_progress_multi.restype = ctypes.c_int
    lib.mp4j_progress_multi.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int64,
    ]
    lib.mp4j_run_legs.restype = ctypes.c_int
    lib.mp4j_run_legs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64,
    ]
    lib.mp4j_parse_libsvm.restype = ctypes.c_int64
    lib.mp4j_parse_libsvm.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
    ]


def _load():
    """The library, or None where it does not build or load (the verdict
    is cached in :data:`HAVE_NATIVE`, the error in ``_build_error``)."""
    global _lib, HAVE_NATIVE, _build_error
    if HAVE_NATIVE is not None:  # lock-free fast path for the hot loop
        return _lib
    with _lock:
        if HAVE_NATIVE is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
        except (OSError, AttributeError, Mp4jError) as e:
            _build_error = e if isinstance(e, Mp4jError) else Mp4jError(
                f"loading the native library failed: {e}")
            HAVE_NATIVE = False
            return None
        _lib = lib
        HAVE_NATIVE = True
        return _lib


def load():
    """The library for the parser: raises where it does not build."""
    lib = _load()
    if lib is None:
        raise _build_error or Mp4jError("the native library is disabled")
    return lib


def reduce_into(operator, acc: np.ndarray, src: np.ndarray) -> None:
    """In-place ``acc[i] = operator(acc[i], src[i])``.

    Uses the C++ kernel for builtin operators on contiguous same-dtype
    buffers; numpy otherwise (user-defined operators always go through
    their ``np_fn``).
    """
    if acc.shape != src.shape:
        raise Mp4jError(f"shape mismatch {acc.shape} vs {src.shape}")
    lib = _load()
    if (
        lib is not None
        and operator.kernel_code is not None
        and acc.dtype == src.dtype
        and acc.dtype in _DTYPE_CODES
        and acc.flags.c_contiguous
        and src.flags.c_contiguous
        and acc.flags.writeable
    ):
        rc = lib.mp4j_reduce(
            _DTYPE_CODES[acc.dtype],
            operator.kernel_code,
            acc.ctypes.data_as(ctypes.c_void_p),
            src.ctypes.data_as(ctypes.c_void_p),
            acc.size,
        )
        if rc == 0:
            return
    np.copyto(acc, operator.np_fn(acc, src))


_RAW_ERRORS = {
    -1: "socket error during raw exchange",
    -2: "peer closed connection mid-message",
    -3: "raw exchange timed out (peer dead or stalled?)",
}


def _data_ptr(arr: np.ndarray | None):
    if arr is None or arr.size == 0:
        return None
    return ctypes.c_void_p(arr.ctypes.data)


def _nbytes(arr: np.ndarray | None) -> int:
    return 0 if arr is None else arr.nbytes


def sendrecv_raw(send_fd: int, recv_fd: int, sarr: np.ndarray | None,
                 rarr: np.ndarray | None, timeout: float | None) -> bool:
    """Full-duplex raw exchange via the native poll loop.

    ``sarr`` must be C-contiguous (or None); ``rarr`` must be a writable
    C-contiguous buffer (or None). Returns False when the native library
    is unavailable (caller falls back to the Python raw path); raises
    Mp4jError on wire failure. ``timeout=None`` blocks forever — the
    reference's fail-stop behavior.
    """
    lib = _load()
    if lib is None:
        return False
    # Round sub-millisecond (but positive) timeouts up to 1 ms so they
    # keep their "tiny grace period" meaning instead of degenerating to
    # an instant -3 failure; the framed path's socket timeout behaves
    # the same way for an instantly-ready peer.
    if timeout is None:
        timeout_ms = -1
    elif timeout <= 0:
        timeout_ms = 0
    else:
        timeout_ms = max(1, int(timeout * 1000))
    rc = lib.mp4j_sendrecv_raw(send_fd, recv_fd, _data_ptr(sarr),
                               _nbytes(sarr), _data_ptr(rarr),
                               _nbytes(rarr), timeout_ms)
    if rc != 0:
        raise Mp4jError(_RAW_ERRORS.get(rc, f"raw exchange failed ({rc})"))
    return True


def ensure_loaded() -> bool:
    """Force the one-time load/build attempt NOW, on the caller's
    thread, outside any lock the caller should be holding. The lazy
    ``_load()`` path may shell out to g++ (seconds) the first time —
    long-lived components that later consult the cached verdict from
    under their own locks (the progression scheduler's ``_full_ok``
    runs under its condition variable; mp4j-lint R20) call this at
    construction so the build can never run inside a held region."""
    return _load() is not None


def have_progress_multi() -> bool:
    """Whether the native multi-leg progress driver is available (the
    nonblocking scheduler falls back to its pure-Python pumps when
    not)."""
    return _load() is not None


def progress_multi(fds: np.ndarray, dirs: np.ndarray, bufs,
                   lens: np.ndarray, dones: np.ndarray,
                   status: np.ndarray, timeout: float) -> int:
    """Drive a set of runnable legs through ONE native poll loop
    (see ``csrc/mp4j_transport.cpp``).

    ``fds``/``dirs`` int32 arrays (dir 0=send, 1=recv), ``bufs`` a
    ``(ctypes.c_void_p * n)`` array of buffer pointers, ``lens`` int64,
    ``dones`` int64 IN-OUT progress, ``status`` int8 OUT. Sockets must
    already be nonblocking (the scheduler owns the mode for the
    batch). Returns the number of legs that newly completed, or 0 on a
    timeout tick (the caller polls the epoch fence and re-enters);
    raises on wire failure, naming the failing leg index."""
    lib = _load()
    n = int(fds.size)
    rc = lib.mp4j_progress_multi(
        ctypes.c_void_p(fds.ctypes.data),
        ctypes.c_void_p(dirs.ctypes.data),
        ctypes.cast(bufs, ctypes.c_void_p),
        ctypes.c_void_p(lens.ctypes.data),
        ctypes.c_void_p(dones.ctypes.data),
        ctypes.c_void_p(status.ctypes.data),
        n, max(1, int(timeout * 1000)))
    if rc < 0:
        bad = int(np.flatnonzero(status != 0)[0]) \
            if np.any(status != 0) else -1
        raise Mp4jError(
            f"{_RAW_ERRORS.get(rc, f'progress failed ({rc})')} "
            f"(leg {bad})")
    return rc


def run_legs(fds, dirs, bufs, lens, dones, gates, mdst, msrc, mdtype,
             mopcode, mcount, mchunk, melems, status, wake_fd: int,
             timeout: float) -> int:
    """Drive a whole engine batch's leg graph natively (see
    ``csrc/mp4j_transport.cpp mp4j_run_legs``). Reduce-merges run
    chunk-granularly as bytes land: ``mchunk`` is the per-leg merge
    step in elements (the tuner-adapted chunk schedule; 0 = whole
    buffer), ``melems`` the in-out merge cursor. Returns 1 (all legs
    complete), 0 (timeout tick — poll the fence and re-enter) or 2
    (``wake_fd`` readable — new submissions to admit); raises on wire
    failure. ``dones``/``melems`` are in-out, so the call is
    re-entrant."""
    lib = _load()
    rc = lib.mp4j_run_legs(
        ctypes.c_void_p(fds.ctypes.data),
        ctypes.c_void_p(dirs.ctypes.data),
        ctypes.cast(bufs, ctypes.c_void_p),
        ctypes.c_void_p(lens.ctypes.data),
        ctypes.c_void_p(dones.ctypes.data),
        ctypes.c_void_p(gates.ctypes.data),
        ctypes.cast(mdst, ctypes.c_void_p),
        ctypes.cast(msrc, ctypes.c_void_p),
        ctypes.c_void_p(mdtype.ctypes.data),
        ctypes.c_void_p(mopcode.ctypes.data),
        ctypes.c_void_p(mcount.ctypes.data),
        ctypes.c_void_p(mchunk.ctypes.data),
        ctypes.c_void_p(melems.ctypes.data),
        ctypes.c_void_p(status.ctypes.data),
        int(fds.size), wake_fd, max(1, int(timeout * 1000)))
    if rc < 0:
        bad = int(np.flatnonzero(status != 0)[0]) \
            if np.any(status != 0) else -1
        raise Mp4jError(
            f"{_RAW_ERRORS.get(rc, f'batch progress failed ({rc})')} "
            f"(leg {bad})")
    return rc


def reduce_opcode(operator, dtype) -> int | None:
    """The (dtype, operator) native codes for a batch merge spec, or
    None when this combination has no native kernel (the engine then
    keeps the per-leg path whose merges run through reduce_into's
    fallback).

    Reads the CACHED load verdict only — never triggers the build.
    The callers sit under the progression scheduler's condition
    variable, and the first ``_load()`` may compile the extension
    (``subprocess.run`` of g++, seconds): a build under that lock
    stalls every submit()/wait() on the scheduler for its duration
    (mp4j-lint R20, found by the whole-program pass). The scheduler
    forces the one-time attempt via :func:`ensure_loaded` at
    construction, so an unattempted verdict here means "no native
    kernels", exactly like a missing toolchain."""
    if not HAVE_NATIVE or _lib is None or operator.kernel_code is None:
        return None
    dt = np.dtype(dtype)
    if dt not in _DTYPE_CODES:
        return None
    return _DTYPE_CODES[dt], operator.kernel_code


def parse_libsvm_chunk(blob: bytes, n_rows: int, max_nnz: int):
    """One-pass native parse of ``n_rows`` newline-joined libsvm/libffm
    lines into padded ``(feats, fields, vals, y)`` arrays, the shape
    ``utils.libsvm.read_libsvm`` yields. Returns None when the strict
    scanner refuses the chunk (exotic-but-valid literals, or malformed
    lines): the caller replays it through the Python parser. Raises
    where the library does not build."""
    lib = load()
    feats = np.zeros((n_rows, max_nnz), np.int32)
    fields = np.zeros((n_rows, max_nnz), np.int32)
    vals = np.zeros((n_rows, max_nnz), np.float32)
    y = np.zeros(n_rows, np.float32)
    out_rows = ctypes.c_int64(0)
    rc = lib.mp4j_parse_libsvm(
        blob, len(blob), max_nnz, n_rows,
        feats.ctypes.data_as(ctypes.c_void_p),
        fields.ctypes.data_as(ctypes.c_void_p),
        vals.ctypes.data_as(ctypes.c_void_p),
        y.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(out_rows))
    if rc != 0 or out_rows.value != n_rows:
        return None
    return feats, fields, vals, y
