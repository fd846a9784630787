"""Serve request/response wire framing.

A copy of ``ytk_mp4j_tpu/serve/framing.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

The external face of the serve plane: a compact little-endian binary
frame an edge proxy can speak without importing this package. One
request shape covers all four model families — three parallel arrays
(``ids``/``fields``/``vals``) whose meaning the family tag fixes:

- ``linear``: ids = feature indices, vals = feature values (fields
  unused, all zero);
- ``fm`` / ``ffm``: the padded-sparse instance triplet the trainers
  stage (``_stage_instances``): feature ids, field ids, values;
- ``gbdt``: ids = the binned feature vector (one bin per feature, in
  feature order; fields/vals unused).

Responses carry float64 predictions (length 1, or ``n_classes`` for
softmax families) plus a status byte — ``DEGRADED`` is a real,
deliverable outcome (a reduce-mode batch scored while a replacement
rank was still warming up), distinct from ``ERROR``.

Framing is PURE bytes <-> arrays: no sockets live here. The dispatch
plane rides the collective substrate's own channels; this module is
what a TCP/HTTP front door would wrap, and what the round-trip tests
pin so the layout cannot drift silently.
"""

from __future__ import annotations

import struct

import numpy as np

from ytk_mp4j_tpu_torch.exceptions import Mp4jError

FAMILIES = ("linear", "fm", "ffm", "gbdt")

STATUS_OK = 0
STATUS_ERROR = 1
STATUS_DEGRADED = 2

_REQ_MAGIC = b"Mq"
_RSP_MAGIC = b"Mr"
_VERSION = 1
# magic[2] ver u8 family u8 req_id u64 n u32
_REQ_HEAD = struct.Struct("<2sBBQI")
# magic[2] ver u8 status u8 req_id u64 n u32
_RSP_HEAD = struct.Struct("<2sBBQI")
# frame sanity bound: a request is a single instance, a response a
# single prediction vector — megabytes mean a corrupt length field,
# not a real payload
_MAX_ITEMS = 1 << 20


def encode_request(family: str, req_id: int, ids, fields=None,
                   vals=None) -> bytes:
    """One instance -> one request frame."""
    if family not in FAMILIES:
        raise Mp4jError(f"unknown serve family {family!r}")
    ids = np.ascontiguousarray(np.asarray(ids, np.int64))
    n = ids.shape[0]
    fields = (np.zeros(n, np.int32) if fields is None
              else np.ascontiguousarray(np.asarray(fields, np.int32)))
    vals = (np.zeros(n, np.float32) if vals is None
            else np.ascontiguousarray(np.asarray(vals, np.float32)))
    if fields.shape != (n,) or vals.shape != (n,):
        raise Mp4jError(
            f"request arrays must share length: ids[{n}], "
            f"fields{list(fields.shape)}, vals{list(vals.shape)}")
    head = _REQ_HEAD.pack(_REQ_MAGIC, _VERSION,
                          FAMILIES.index(family), int(req_id), n)
    return head + ids.tobytes() + fields.tobytes() + vals.tobytes()


def decode_request(buf: bytes):
    """Request frame -> ``(family, req_id, ids, fields, vals)``;
    raises ``Mp4jError`` on anything malformed (bad magic/version,
    truncated arrays, absurd lengths)."""
    if len(buf) < _REQ_HEAD.size:
        raise Mp4jError(f"request frame truncated at {len(buf)} bytes")
    magic, ver, fam, req_id, n = _REQ_HEAD.unpack_from(buf)
    if magic != _REQ_MAGIC or ver != _VERSION:
        raise Mp4jError(
            f"bad request frame header {magic!r} v{ver}")
    if fam >= len(FAMILIES) or n > _MAX_ITEMS:
        raise Mp4jError(f"bad request frame: family {fam}, n {n}")
    need = _REQ_HEAD.size + n * (8 + 4 + 4)
    if len(buf) != need:
        raise Mp4jError(
            f"request frame length {len(buf)} != expected {need}")
    off = _REQ_HEAD.size
    ids = np.frombuffer(buf, np.int64, n, off).copy()
    off += 8 * n
    fields = np.frombuffer(buf, np.int32, n, off).copy()
    off += 4 * n
    vals = np.frombuffer(buf, np.float32, n, off).copy()
    return FAMILIES[fam], req_id, ids, fields, vals


def encode_response(req_id: int, preds,
                    status: int = STATUS_OK) -> bytes:
    """One prediction vector -> one response frame."""
    if status not in (STATUS_OK, STATUS_ERROR, STATUS_DEGRADED):
        raise Mp4jError(f"bad response status {status}")
    preds = np.ascontiguousarray(
        np.atleast_1d(np.asarray(preds, np.float64)))
    head = _RSP_HEAD.pack(_RSP_MAGIC, _VERSION, status, int(req_id),
                          preds.shape[0])
    return head + preds.tobytes()


def decode_response(buf: bytes):
    """Response frame -> ``(req_id, preds, status)``."""
    if len(buf) < _RSP_HEAD.size:
        raise Mp4jError(
            f"response frame truncated at {len(buf)} bytes")
    magic, ver, status, req_id, n = _RSP_HEAD.unpack_from(buf)
    if magic != _RSP_MAGIC or ver != _VERSION:
        raise Mp4jError(
            f"bad response frame header {magic!r} v{ver}")
    if n > _MAX_ITEMS:
        raise Mp4jError(f"bad response frame: n {n}")
    need = _RSP_HEAD.size + 8 * n
    if len(buf) != need:
        raise Mp4jError(
            f"response frame length {len(buf)} != expected {need}")
    preds = np.frombuffer(buf, np.float64, n, _RSP_HEAD.size).copy()
    return req_id, preds, status
