"""Persistent key<->code vocabularies for the driver-mode map collectives
(a copy of ``ytk_mp4j_tpu/comm/keycodec.py``, numpy only; the port
imports nothing of the JAX package).

The original ``Map<K, V>`` path re-serializes whole maps with Kryo every
call (SURVEY.md section 3c). A real sparse-gradient stream has a
near-persistent vocabulary, so none of the key work need be per-call:
these codecs assign each distinct key a stable int32 code ONCE
(grow-only) and translate whole maps with vectorized numpy.

Two implementations, chosen by key type at first use:

- :class:`IntKeyCodec` — integer feature-id keys (the ytk-learn
  sparse-gradient shape). Keys never touch Python: encode is one
  ``np.fromiter`` + ``np.searchsorted`` against the sorted known-key
  table; growth merges the (pre-sorted) novelty in with one stable
  mergesort.
- :class:`ObjKeyCodec` — strings and other hashables. Encode is one
  C-level ``np.fromiter(map(dict.__getitem__, keys))`` pass; only NEW
  keys take the Python insert path, once ever.

Both cache ``meta.key_partition`` per code (the blake2b digest is by far
the most expensive per-key operation in the scatter family), and both
decode with one vectorized take from the code->key table.

Codes are dense in [0, size) and stay below ``ops.sparse.SENTINEL``.
"""

from __future__ import annotations

from operator import index as _as_index

import numpy as np

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops.sparse import SENTINEL


def kind_of(key) -> str:
    """``"int"`` or ``"obj"`` — the ONE key-kind rule every backend
    shares (bool is NOT an int key: it would collide with 0/1 while
    claiming the fast path)."""
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        return "int"
    return "obj"


def codec_for_kind(kind: str):
    """A fresh codec for a :func:`kind_of` kind."""
    return IntKeyCodec() if kind == "int" else ObjKeyCodec()


def codec_for_key(key):
    """A fresh codec suited to ``key``'s type."""
    return codec_for_kind(kind_of(key))


def pack_values(values, count: int, vshape, dtype) -> np.ndarray:
    """One vectorized map-values -> ``[count, *vshape]`` conversion,
    shared by the driver, multi-host, and socket map planes so their
    accept/reject behavior cannot drift: ragged mixes raise, and scalar
    vs shape-(1,) mixes raise rather than silently flattening.

    Three paths, cheapest first:

    - ``values`` already an ndarray: validated in place — no list()
      round-trip, no copy unless the dtype needs casting;
    - scalar ``vshape``: packed straight from the (re-iterable) values
      view with ``np.fromiter`` — no boxed-pointer list materialized.
      fromiter would silently FLATTEN a stray shape-(1,) array value
      (a NumPy deprecation), so that warning is promoted to the same
      Mp4jError the asarray path raises;
    - array-valued maps: the original list + asarray conversion.
    """
    vshape = tuple(vshape)
    want = (count,) + vshape
    dt = np.dtype(dtype)
    if isinstance(values, np.ndarray):
        if values.shape != want:
            raise Mp4jError(
                f"map values must share a shape; got {values.shape} "
                f"vs expected {want}")
        try:
            return values if values.dtype == dt else values.astype(dt)
        except (TypeError, ValueError) as e:
            raise Mp4jError(
                f"map values must be {dt}-castable: {e}") from None
    if vshape == ():
        import warnings

        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error", DeprecationWarning)
                return np.fromiter(values, dt, count)
        except (TypeError, ValueError, DeprecationWarning) as e:
            raise Mp4jError(
                f"map values must share shape {vshape} and be "
                f"{dt}-castable: {e}") from None
    try:
        v = np.asarray(list(values), dtype=dt)
    except (TypeError, ValueError) as e:
        raise Mp4jError(
            f"map values must share shape {vshape} and be "
            f"{dt}-castable: {e}") from None
    if v.shape != want:
        raise Mp4jError(
            f"map values must share a shape; got {v.shape} vs "
            f"expected {want}")
    return v


def pow2_bucket(x: int) -> int:
    """Smallest power of 2 >= x (x >= 1) — the shared bucket rule that
    bounds map-collective recompiles at O(log max-keys) programs on
    every backend (see ``gpu_comm._encode_maps``)."""
    return 1 << (x - 1).bit_length()


class _Partitions:
    """code -> rank cache, grown alongside the vocabulary. Placement is
    meta.key_partition on the ORIGINAL key (both backends must agree),
    computed once per (key, n). ``tail_keys(old)`` materializes only
    the keys for codes >= old — the cache-hit path does no
    per-vocabulary work at all."""

    def __init__(self):
        self._by_n: dict[int, np.ndarray] = {}

    def lookup(self, codes: np.ndarray, n: int, size: int,
               tail_keys) -> np.ndarray:
        arr = self._by_n.get(n)
        old = 0 if arr is None else arr.size
        if old < size:
            new = np.fromiter(
                (meta.key_partition(k, n) for k in tail_keys(old)),
                np.int32, size - old)
            arr = new if arr is None else np.concatenate([arr, new])
            self._by_n[n] = arr
        return arr[codes]

    def truncate(self, size: int) -> None:
        """Drop cached placements for codes >= ``size`` (vocabulary
        rollback, see the codecs' ``truncate``) — a re-grown code may
        map to a DIFFERENT key, so its cached rank would be wrong."""
        self._by_n = {n: a[:size] for n, a in self._by_n.items()}


class IntKeyCodec:
    """Grow-only int64 key <-> int32 code vocabulary (vectorized)."""

    def __init__(self):
        self._sorted = np.empty(0, np.int64)        # known keys, sorted
        self._sorted_codes = np.empty(0, np.int32)  # their codes
        self._by_code = np.empty(0, np.int64)       # code -> key
        self._partitions = _Partitions()

    @property
    def size(self) -> int:
        return self._by_code.size

    def _lookup(self, ks: np.ndarray) -> np.ndarray:
        """Codes for ``ks``; -1 where unknown."""
        if self._sorted.size == 0:
            return np.full(ks.size, -1, np.int32)
        pos = np.minimum(np.searchsorted(self._sorted, ks),
                         self._sorted.size - 1)
        return np.where(self._sorted[pos] == ks,
                        self._sorted_codes[pos], np.int32(-1))

    def encode(self, keys, count: int) -> np.ndarray:
        """int32 codes for ``keys`` (re-iterable, ``count`` long),
        assigning fresh codes to novel keys."""
        try:
            # operator.index is the exact-integer gate: floats (which
            # np.fromiter(..., int64) would silently TRUNCATE — 2.5
            # becoming key 2) raise TypeError, big ints stay exact
            ks = np.fromiter(map(_as_index, keys), np.int64, count)
        except (TypeError, ValueError, OverflowError) as e:
            raise Mp4jError(
                f"map keys must be homogeneous int64-representable "
                f"integers on this stream: {e}") from None
        codes = self._lookup(ks)
        miss = codes < 0
        if miss.any():
            new = np.unique(ks[miss])
            start = self._by_code.size
            if start + new.size >= int(SENTINEL):
                raise Mp4jError("key vocabulary overflows int32 codes")
            new_codes = np.arange(start, start + new.size, dtype=np.int32)
            self._by_code = np.concatenate([self._by_code, new])
            order = np.argsort(
                np.concatenate([self._sorted, new]), kind="stable")
            allk = np.concatenate([self._sorted, new])
            allc = np.concatenate([self._sorted_codes, new_codes])
            self._sorted, self._sorted_codes = allk[order], allc[order]
            codes = self._lookup(ks)
        return codes

    def decode(self, codes: np.ndarray) -> list:
        """Python-int keys for ``codes`` (one vectorized take)."""
        return self._by_code[codes].tolist()

    def novel(self, keys, count: int) -> list:
        """The subset of ``keys`` not yet in the vocabulary (insertion
        candidates for SPMD vocab synchronization — every member must
        grow its codec with the SAME keys in the same order)."""
        try:
            ks = np.fromiter(map(_as_index, keys), np.int64, count)
        except (TypeError, ValueError, OverflowError) as e:
            raise Mp4jError(
                f"map keys must be homogeneous int64-representable "
                f"integers on this stream: {e}") from None
        return ks[self._lookup(ks) < 0].tolist()

    def partition(self, codes: np.ndarray, n: int) -> np.ndarray:
        # tolist() -> python ints: key_partition hashes repr(key), and
        # repr(np.int64(5)) != repr(5) on numpy >= 2; only the NEW tail
        # is ever materialized (cache hits do no per-vocab work)
        return self._partitions.lookup(
            codes, n, self._by_code.size,
            lambda old: self._by_code[old:].tolist())

    def truncate(self, size: int) -> None:
        """Roll the vocabulary back to its first ``size`` codes — the
        epoch-fenced retry's codec restore: a failed map
        collective may have grown the codec on SOME ranks before the
        abort tore the decision broadcast, and re-running ``novel()``
        against the half-grown vocabulary would desynchronize code
        tables job-wide. Restoring every rank to the (identical)
        pre-attempt size re-establishes the invariant the retry's
        sync round then grows from."""
        if size >= self._by_code.size:
            return
        self._by_code = self._by_code[:size]
        keep = self._sorted_codes < size
        self._sorted = self._sorted[keep]
        self._sorted_codes = self._sorted_codes[keep]
        self._partitions.truncate(size)

    def export(self, size: int | None = None) -> list:
        """The first ``size`` keys in CODE order — the rank-replacement
        manifest's vocabulary payload. Code order is the
        load-bearing part: the joining spare rebuilds its tables with
        :meth:`import_keys`, and only an identical key->code assignment
        keeps the job-wide columnar invariant."""
        n = self._by_code.size if size is None else min(
            size, self._by_code.size)
        return self._by_code[:n].tolist()

    def import_keys(self, keys) -> None:
        """Rebuild an EMPTY codec from an exported key list, assigning
        code i to ``keys[i]`` — NOT ``encode`` (which orders a novel
        batch by sorted key, the per-call canonical rule, and would
        scramble a vocabulary grown over many calls)."""
        if self._by_code.size:
            raise Mp4jError("import_keys requires an empty codec")
        ks = np.asarray(list(keys), np.int64)
        if ks.size >= int(SENTINEL):
            raise Mp4jError("key vocabulary overflows int32 codes")
        self._by_code = ks
        codes = np.arange(ks.size, dtype=np.int32)
        order = np.argsort(ks, kind="stable")
        self._sorted = ks[order]
        self._sorted_codes = codes[order]


class ObjKeyCodec:
    """Grow-only hashable-key <-> int32 code vocabulary."""

    def __init__(self):
        self._code: dict = {}
        self._by_code: list = []
        self._arr: np.ndarray | None = None   # object array for decode
        self._partitions = _Partitions()

    @property
    def size(self) -> int:
        return len(self._by_code)

    def encode(self, keys, count: int) -> np.ndarray:
        code = self._code
        try:
            return np.fromiter(map(code.__getitem__, keys),
                               np.int32, count)
        except KeyError:
            pass
        except TypeError as e:
            raise Mp4jError(f"map keys must be hashable: {e}") from None
        start = len(self._by_code)
        # count the prospective insertions and raise BEFORE growing
        # (mirrors IntKeyCodec): a post-insert check would leave an
        # oversized vocabulary behind whose sentinel-colliding codes a
        # later all-known encode (the fast path above) happily returns
        try:
            novel = dict.fromkeys(k for k in keys if k not in code)
        except TypeError as e:
            raise Mp4jError(f"map keys must be hashable: {e}") from None
        if start + len(novel) >= int(SENTINEL):
            raise Mp4jError("key vocabulary overflows int32 codes")
        for k in novel:
            code[k] = len(self._by_code)
            self._by_code.append(k)
        if len(self._by_code) > start:
            self._arr = None   # decode table stale
        return np.fromiter(map(code.__getitem__, keys), np.int32, count)

    def decode(self, codes: np.ndarray) -> list:
        if self._arr is None or self._arr.size < len(self._by_code):
            arr = np.empty(len(self._by_code), object)
            arr[:] = self._by_code
            self._arr = arr
        return self._arr[codes].tolist()

    def novel(self, keys, count: int) -> list:
        """See :meth:`IntKeyCodec.novel`."""
        code = self._code
        return [k for k in keys if k not in code]

    def partition(self, codes: np.ndarray, n: int) -> np.ndarray:
        return self._partitions.lookup(
            codes, n, len(self._by_code),
            lambda old: self._by_code[old:])

    def truncate(self, size: int) -> None:
        """See :meth:`IntKeyCodec.truncate`."""
        if size >= len(self._by_code):
            return
        for k in self._by_code[size:]:
            del self._code[k]
        del self._by_code[size:]
        self._arr = None
        self._partitions.truncate(size)

    def export(self, size: int | None = None) -> list:
        """See :meth:`IntKeyCodec.export`."""
        n = len(self._by_code) if size is None else min(
            size, len(self._by_code))
        return list(self._by_code[:n])

    def import_keys(self, keys) -> None:
        """See :meth:`IntKeyCodec.import_keys` (insertion order IS code
        order for this codec)."""
        if self._by_code:
            raise Mp4jError("import_keys requires an empty codec")
        keys = list(keys)
        if len(keys) >= int(SENTINEL):
            raise Mp4jError("key vocabulary overflows int32 codes")
        self._by_code = keys
        self._code = {k: i for i, k in enumerate(keys)}
        self._arr = None
