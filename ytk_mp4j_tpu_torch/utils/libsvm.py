"""Streaming libsvm / libffm text reader (the port of
``ytk_mp4j_tpu/utils/libsvm.py``) -- the consumer-side ingestion path for
data that cannot be staged in memory (ytk-learn trains from libsvm-format
files; BASELINE.json configs[4] names a 1TB workload).

Formats, one instance per line:

    libsvm:  ``label feat:val feat:val ...``
    libffm:  ``label field:feat:val field:feat:val ...``

``read_libsvm`` yields fixed-width ``(feats, fields, vals, y)`` numpy
chunks of at most ``chunk_rows`` rows, each slot axis padded to
``max_nnz`` (padded slots carry value 0, the mask convention of
``FMTrainer``) — exactly the minibatch shape ``FMTrainer.fit_stream``
consumes, so ``fit_stream(read_libsvm(path, ...))`` trains end-to-end
without ever holding more than one chunk in memory.
"""

from __future__ import annotations

import numpy as np

from ytk_mp4j_tpu_torch.exceptions import Mp4jError


def parse_line(line: str, max_nnz: int, lineno: int):
    """One ``label [field:]feat:val ...`` line -> (y, feats, fields,
    vals) lists. Mixed 2- and 3-part tokens on one line are an error;
    more than ``max_nnz`` tokens are an error (silent truncation would
    quietly change the model)."""
    parts = line.split()
    try:
        y = float(parts[0])
    except ValueError:
        raise Mp4jError(
            f"line {lineno}: label {parts[0]!r} is not a number") from None
    if len(parts) - 1 > max_nnz:
        raise Mp4jError(
            f"line {lineno}: {len(parts) - 1} entries exceed "
            f"max_nnz={max_nnz}")
    feats, fields, vals = [], [], []
    width = None
    for tok in parts[1:]:
        pieces = tok.split(":")
        if width is None:
            width = len(pieces)
        if len(pieces) != width or width not in (2, 3):
            raise Mp4jError(
                f"line {lineno}: token {tok!r} is neither feat:val nor "
                "field:feat:val (or the line mixes the two)")
        try:
            if width == 2:
                feats.append(int(pieces[0]))
                fields.append(0)
                vals.append(float(pieces[1]))
            else:
                fields.append(int(pieces[0]))
                feats.append(int(pieces[1]))
                vals.append(float(pieces[2]))
        except ValueError:
            raise Mp4jError(
                f"line {lineno}: malformed token {tok!r}") from None
    return y, feats, fields, vals


# The fast path is the native one-pass C++ scanner (csrc/mp4j_parse.cpp
# via utils.native.parse_libsvm_chunk); parse_line stays as the semantic
# contract and the diagnostics/replay path.


def _parse_chunk_slow(lines, linenos, max_nnz: int):
    """Per-line replay of a chunk the native parser refused: raises the
    exact :func:`parse_line` error, or returns the parsed chunk when
    the lines are individually valid (e.g. exotic-but-valid literals
    like underscores, inf labels, or huge Python ints)."""
    n = len(lines)
    feats = np.zeros((n, max_nnz), np.int32)
    fields = np.zeros((n, max_nnz), np.int32)
    vals = np.zeros((n, max_nnz), np.float32)
    y = np.zeros(n, np.float32)
    for i, (ln, lno) in enumerate(zip(lines, linenos)):
        yv, f, fl, v = parse_line(ln, max_nnz, lno)
        y[i] = yv
        feats[i, : len(f)] = f
        fields[i, : len(fl)] = fl
        vals[i, : len(v)] = v
    return feats, fields, vals, y


def read_libsvm(path_or_lines, chunk_rows: int, max_nnz: int):
    """Stream a libsvm/libffm source in fixed-width numpy chunks.

    ``path_or_lines``: a file path or any iterable of text lines (an
    open file object streams without loading the file). Yields
    ``(feats [N, max_nnz] i32, fields [N, max_nnz] i32,
    vals [N, max_nnz] f32, y [N] f32)`` with ``N <= chunk_rows`` —
    feed directly to ``FMTrainer.fit_stream`` (pass
    ``batch_rows=chunk_rows`` so the short final chunk reuses the same
    compiled step).

    Parsing rides the native one-pass chunk scanner
    (``csrc/mp4j_parse.cpp``, built at first use; a failed build
    raises); chunks it refuses — malformed lines, over-long lines,
    exotic literals — replay per line through :func:`parse_line`, so
    error messages keep their exact line numbers and anything Python
    accepts still parses (slowly).
    """
    from ytk_mp4j_tpu_torch.utils import native

    if chunk_rows <= 0:
        raise Mp4jError(f"chunk_rows must be positive, got {chunk_rows}")

    def parse(buf, lnos):
        got = native.parse_libsvm_chunk(
            "\n".join(buf).encode(), len(buf), max_nnz)
        if got is None:
            return _parse_chunk_slow(buf, lnos, max_nnz)
        return got

    def chunks(lines):
        buf, lnos = [], []
        for lineno, line in enumerate(lines, 1):
            if not line.strip():
                continue
            buf.append(line)
            lnos.append(lineno)
            if len(buf) == chunk_rows:
                yield parse(buf, lnos)
                buf, lnos = [], []
        if buf:
            yield parse(buf, lnos)

    if isinstance(path_or_lines, str):
        def from_path():
            with open(path_or_lines) as fh:
                yield from chunks(fh)
        return from_path()
    return chunks(path_or_lines)


def dense_chunks(chunks, n_features: int):
    """Adapt :func:`read_libsvm`'s padded-sparse chunks to dense
    ``(x [N, F], y)`` pairs — the shape ``LinearTrainer.fit_stream``
    consumes (ytk-learn's linear family trains from the same libsvm
    text as FFM). Duplicate feature ids on one line ACCUMULATE (the
    additive convention of a sparse dot product); padded slots carry
    value 0 and add nothing. Feature ids must lie in [0, n_features).
    """
    for feats, fields, vals, y in chunks:
        if feats.size and (feats.min() < 0
                           or feats.max() >= n_features):
            raise Mp4jError(
                f"feature id out of range [0, {n_features}) in chunk")
        N = feats.shape[0]
        # bincount, not np.add.at: identical duplicate-accumulating
        # semantics at C speed (add.at is an unbuffered per-element
        # loop, ~10x slower on the ms-per-chunk host budget)
        flat = (np.arange(N, dtype=np.int64)[:, None]
                * n_features + feats).ravel()
        x = np.bincount(flat, weights=vals.ravel().astype(np.float64),
                        minlength=N * n_features)
        yield x.reshape(N, n_features).astype(np.float32), y
