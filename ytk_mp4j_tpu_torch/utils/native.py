"""Build and call the native libsvm chunk parser (``csrc/mp4j_parse.cpp``,
a copy of the reference's).

The source compiles with ``g++`` at first use into a shared library with a
plain C interface that ``ctypes`` loads:
``ytk_mp4j_tpu_torch/csrc/build/libmp4j_parse-<digest>.so``, the digest
covering the source and the flags, so an edited source builds anew and an
unchanged one is reused (several processes may build at once: each
writes its own temporary file and renames it into place). Nothing builds
when the module is imported. A failed build raises
:class:`~ytk_mp4j_tpu_torch.exceptions.Mp4jError`; nothing falls back.
The reference builds this source together with its socket transport
(``ytk_mp4j_tpu/utils/native.py:52-66``); the port builds only the
parser.
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
SOURCE = PACKAGE_DIR / "csrc" / "mp4j_parse.cpp"
BUILD_DIR = PACKAGE_DIR / "csrc" / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmp4j_parse-{digest}.so"


def build() -> Path:
    """Compile the parser unless its library exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise Mp4jError("no C++ compiler (g++) to build the libsvm parser")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise Mp4jError(f"building {SOURCE.name} failed:\n"
                            f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The parser's library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mp4j_parse_libsvm.restype = ctypes.c_int64
            lib.mp4j_parse_libsvm.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
        return _lib


def parse_libsvm_chunk(blob: bytes, n_rows: int, max_nnz: int):
    """One-pass native parse of ``n_rows`` newline-joined libsvm/libffm
    lines into padded ``(feats, fields, vals, y)`` arrays, the shape
    ``utils.libsvm.read_libsvm`` yields. Returns None when the strict
    scanner refuses the chunk (exotic-but-valid literals, or malformed
    lines): the caller replays it through the Python parser."""
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
