"""Segment / partition metadata math.

The reference carries per-rank segment descriptors (``ArrayMetaData`` /
``MapMetaData``, SURVEY.md section 2, expected path ``meta/`` [U]) that
describe how an array range ``[from, to)`` is split across ranks for
reduce-scatter / scatter / gather, and how map keys are partitioned.

A copy of ``ytk_mp4j_tpu/meta.py`` (numpy-free, framework-free); the port
imports nothing of the JAX package. Both packages share
this partition math, so that differential tests compare
bit-identical segment layouts.

Block distribution rule: for ``n`` elements over ``p`` ranks, ranks
``0..(n % p - 1)`` get ``ceil(n / p)`` elements and the rest get
``floor(n / p)``, in rank order. This is the standard MPI block
distribution; the reference's exact rule is unverified (mount empty), so
this is a pinned free choice — documented here as the single source of
truth.
"""

from __future__ import annotations

from ytk_mp4j_tpu_torch.exceptions import Mp4jError


def partition_sizes(length: int, parts: int) -> list[int]:
    """Sizes of each rank's block for ``length`` elements over ``parts``."""
    if parts <= 0:
        raise Mp4jError(f"parts must be positive, got {parts}")
    if length < 0:
        raise Mp4jError(f"length must be non-negative, got {length}")
    base, rem = divmod(length, parts)
    return [base + 1 if r < rem else base for r in range(parts)]


def partition_range(lo: int, hi: int, parts: int) -> list[tuple[int, int]]:
    """Split ``[lo, hi)`` into ``parts`` contiguous blocks (block rule above).

    Returns a list of ``(start, end)`` half-open ranges, one per rank.
    Empty ranges (``start == end``) are legal when ``hi - lo < parts``.
    """
    if hi < lo:
        raise Mp4jError(f"invalid range [{lo}, {hi})")
    sizes = partition_sizes(hi - lo, parts)
    out = []
    start = lo
    for s in sizes:
        out.append((start, start + s))
        start += s
    return out


def owner_of(index: int, lo: int, hi: int, parts: int) -> int:
    """Rank owning ``index`` under ``partition_range(lo, hi, parts)``."""
    if not (lo <= index < hi):
        raise Mp4jError(f"index {index} outside [{lo}, {hi})")
    length = hi - lo
    base, rem = divmod(length, parts)
    off = index - lo
    cut = rem * (base + 1)
    if off < cut:
        return off // (base + 1)
    if base == 0:
        raise Mp4jError(f"index {index} beyond last non-empty block")
    return rem + (off - cut) // base


def key_partition(key, parts: int) -> int:
    """Stable hash partition of a map key across ranks.

    Used by scatter_map / reduce_scatter_map on BOTH backends so
    differential tests see identical key placement. Python's builtin
    ``hash`` is salted per-process (PYTHONHASHSEED), so a keyed-stable
    blake2b digest of the key's string form is used instead.

    Integral keys are canonicalized through ``__index__`` first:
    ``repr(np.int64(5))`` is ``"np.int64(5)"`` on numpy >= 2, which
    would place the same logical key differently than python ``5`` (and
    differently than the key codecs, which decode to python ints).
    bool is deliberately NOT canonicalized — it would collide with 0/1.
    """
    import hashlib

    if not isinstance(key, bool):
        try:
            key = key.__index__()
        except (AttributeError, TypeError):
            pass
    h = hashlib.blake2b(repr(key).encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "little") % parts


def check_partition_rank(p: int, parts: int, key) -> int:
    """Validate a user ``partitioner``'s placement. Shared by every
    backend's ``scatter_map`` so they agree on bad output: without
    this, a buggy partitioner returning -1 would silently wrap to the
    last rank via Python negative indexing on one backend and raise on
    another."""
    if not (0 <= p < parts):
        raise Mp4jError(
            f"partitioner placed key {key!r} on rank {p}, outside "
            f"[0, {parts})")
    return p


def padded_block(length: int, parts: int) -> int:
    """Per-rank block size when padding ``length`` up to a multiple of
    ``parts`` (the device path needs equal blocks per member)."""
    if parts <= 0:
        raise Mp4jError(f"parts must be positive, got {parts}")
    return -(-length // parts)
