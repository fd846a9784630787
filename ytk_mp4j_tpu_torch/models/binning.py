"""Quantile feature binning -- continuous features -> GBDT bin ids (the
port of ``ytk_mp4j_tpu/models/binning.py``).

ytk-learn's GBDT bins continuous features into <= 256 quantile buckets
before it builds histograms. Bin edges are fitted on the host from (a
row sample of) the data: the numpy code of the reference's ``fit``,
``local_sketch``, ``_weighted_sketch`` and ``merge_sketches`` is copied
here unchanged, so the edges are bitwise the reference's. The transform
runs on the device as the reference's comparison count, ``bin(x) =
#edges <= x`` (:func:`bin_ids`, the port of ``_transform_device:561``),
chunked by rows as the reference chunks it; its ids are bitwise the
reference's for any edges, NaN and +-inf included.

Intended divergences from the reference:

- ``transform`` returns an int32 tensor on the device (the reference
  returns numpy), and ``fit`` and ``transform`` also take a tensor, which
  stays on its device: ``fit`` copies only its row sample to the host;
- ``fit_distributed`` is not ported yet: it needs an SPMD comm exposing
  ``rank`` / ``slave_num`` / ``allgather_array``, which the port gets
  with the host planes or ``comm/distributed.py`` (ROADMAP queue 1,
  "Multi-process backend"). ``local_sketch`` and ``merge_sketches``, its two
  halves, are here.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ytk_mp4j_tpu_torch.device import make_device
from ytk_mp4j_tpu_torch.exceptions import Mp4jError


class FeatureSketch(NamedTuple):
    """One rank's distributed-fit contribution (see ``local_sketch``).

    values: [F, Q+1] quantile points ``[min, q_{1/Q}, ..., max]``.
    counts: [F] merge weights (full-shard non-NaN counts).
    finite: [F] 1.0 where the sketched rows hold any finite value.
    cdf:    [F, Q+1] the CDF ordinate of each value point. Equals the
            grid ``[0, 1/Q, ..., 1]`` for distinct-valued data; runs of
            TIED value points carry the shard's TRUE empirical CDF jump
            (left limit at the run start, right limit at the run end) so
            repeated values keep their mass through the merge.
    """

    values: np.ndarray
    counts: np.ndarray
    finite: np.ndarray
    cdf: np.ndarray


def _rows_f32(X):
    """X as float32 [N, F]: a tensor stays on its device, anything else
    becomes a numpy array."""
    X = (X.to(torch.float32) if isinstance(X, torch.Tensor)
         else np.asarray(X, np.float32))
    if X.ndim != 2:
        raise Mp4jError(f"X must be [N, F], got {tuple(X.shape)}")
    return X


def _host_rows(X, idx=None):
    """Rows ``idx`` (all when None) of :func:`_rows_f32`'s X as numpy: a
    tensor's rows are gathered on its device and only they are copied."""
    if isinstance(X, torch.Tensor):
        if idx is not None:
            X = X[torch.from_numpy(idx).to(X.device)]
        return X.cpu().numpy()
    return X if idx is None else X[idx]


def _check_weights(sample_weight, n_rows: int) -> np.ndarray:
    """Validate instance weights for the weighted sketch paths:
    [N] finite non-negative, not identically zero."""
    sw = np.asarray(sample_weight, np.float64)
    if sw.shape != (n_rows,):
        raise Mp4jError(
            f"sample_weight must be [N={n_rows}], got {sw.shape}")
    if not np.isfinite(sw).all() or (sw < 0).any():
        raise Mp4jError(
            "sample_weight must be finite and non-negative")
    if n_rows and not (sw > 0).any():
        raise Mp4jError("sample_weight sums to zero: no weighted mass "
                        "to fit quantiles from")
    return sw


def _sorted_weighted_col(col, w):
    """One feature column -> (sorted values, cumulative weights) with
    NaN and zero-weight rows dropped. Returns (None, None) when no
    weighted data remains."""
    m = ~np.isnan(col) & (w > 0)
    v, wv = col[m], w[m]
    if v.size == 0:
        return None, None
    o = np.argsort(v, kind="stable")
    return v[o], np.cumsum(wv[o])


def _wq_inverted_cdf(v_sorted, cw, qs):
    """Weighted quantiles, inverted-CDF convention: the smallest value
    whose weighted CDF reaches q (``np.quantile(...,
    method="inverted_cdf", weights=...)``; exact under ties, integer
    weights == row duplication)."""
    pos = np.searchsorted(cw, np.asarray(qs) * cw[-1], side="left")
    return v_sorted[np.minimum(pos, v_sorted.size - 1)]


def _cdf_limits(xp, fp, x):
    """Left and right limits of the piecewise-linear CDF through
    ``(xp, fp)`` -- duplicate ``xp`` entries form vertical jumps --
    evaluated at sorted points ``x``. Outside ``[xp[0], xp[-1]]`` the
    CDF is 0 / 1; with strictly increasing ``xp`` both limits reduce to
    ``np.interp(x, xp, fp, left=0, right=1)``."""
    E = xp.size
    iL = np.searchsorted(xp, x, side="left")
    iR = np.searchsorted(xp, x, side="right")
    present = iR > iL
    lo = np.clip(iR - 1, 0, E - 1)
    hi = np.clip(iR, 0, E - 1)
    x0, x1, y0, y1 = xp[lo], xp[hi], fp[lo], fp[hi]
    with np.errstate(invalid="ignore"):   # inf - inf at sentinel runs
        denom = x1 - x0
        ok = denom > 0
        t = np.where(ok, (x - x0) / np.where(ok, denom, 1.0), 0.0)
        # a segment anchored at -inf spans infinitely far left: every
        # finite x sits at its right end (inf/inf -> NaN otherwise)
        t = np.where(np.isnan(t), np.where(np.isneginf(x0), 1.0, 0.0), t)
    interp = y0 + t * (y1 - y0)
    interp = np.where(iR == 0, 0.0, np.where(iR == E, 1.0, interp))
    left = np.where(present, fp[np.clip(iL, 0, E - 1)], interp)
    right = np.where(present, fp[np.clip(iR - 1, 0, E - 1)], interp)
    return left, right


def bin_ids(X, edges, shift: bool = False):
    """The device transform: ``bin = #edges <= x`` for X [rows, F] f32
    and edges [F, E] f32 -> int32 [rows, F]. A comparison count, so it
    agrees with the reference for any edges (NaN x compares False
    everywhere: bin 0). With ``shift`` (the reserved missing bucket),
    finite values move up to [1, B) and NaN is the sole occupant of
    bin 0."""
    b = (X[:, :, None] >= edges[None, :, :]).sum(-1, dtype=torch.int32)
    if shift:
        b = torch.where(torch.isnan(X), 0, b + 1)
    return b


class QuantileBinner:
    """Per-feature quantile binning into ``n_bins`` buckets.

    fit: edges[f, j] = the (j+1)/Q quantile of feature f over Q-1
    internal edges, where Q = n_bins normally and Q = n_bins - 1 under
    ``missing_bucket`` (one bucket is reserved, see below).
    transform: bin = number of edges <= x -- in [0, n_bins) normally,
    shifted to [1, n_bins) under ``missing_bucket``.

    ``missing_bucket=True`` RESERVES bin 0 for missing values: finite
    values bin into [1, B) over B-2 internal edges and NaN maps to
    exactly bin 0 -- the convention ``GBDTConfig(missing_bin=True)``
    expects for learned-default-direction routing. (The default mode
    also sends NaN to bin 0, but shares it with the lowest quantile.)
    """

    def __init__(self, n_bins: int = 256, missing_bucket: bool = False):
        lo = 3 if missing_bucket else 2   # the bucket consumes one bin;
        if not lo <= n_bins <= 65536:     # 2 would leave zero edges
            raise Mp4jError(
                f"n_bins must be in [{lo}, 65536]"
                f"{' with missing_bucket' if missing_bucket else ''}, "
                f"got {n_bins}")
        self.n_bins = n_bins
        self.missing_bucket = missing_bucket
        # [F, B-1] f32 ([F, B-2] under missing_bucket)
        self.edges: np.ndarray | None = None

    def fit(self, X, sample: int | None = 1_000_000, seed: int = 0,
            sample_weight=None):
        """Fit per-feature quantile edges from (a row sample of) X, on
        the host. X may be numpy or a tensor; of a tensor only the
        sampled rows are copied to the host (the same rows the reference
        samples from the same seed).

        Missing values (NaN) are ignored when computing quantiles; at
        transform time they land in bin 0. A feature with no finite
        values at all cannot be binned and raises.

        ``sample_weight`` ([N] >= 0, optional): edges become WEIGHTED
        quantiles (inverted-CDF convention, matching
        ``np.quantile(method="inverted_cdf", weights=...)``; integer
        weights bin exactly like row duplication). ``None`` keeps numpy's
        default linear interpolation."""
        X = _rows_f32(X)
        sw = (None if sample_weight is None
              else _check_weights(sample_weight, X.shape[0]))
        idx = None
        if sample is not None and X.shape[0] > sample:
            idx = np.random.default_rng(seed).choice(
                X.shape[0], sample, replace=False)
            if sw is not None:
                sw = sw[idx]   # uniform row sample keeps weights unbiased
        X = _host_rows(X, idx)
        # a feature must have at least one finite value (of positive
        # weight, when weighted); inf sentinels are fine (they produce
        # inf edges, which compare like any other value at transform
        # time and land inf samples in the top bins)
        evid = (np.isfinite(X) if sw is None
                else np.isfinite(X) & (sw[:, None] > 0))
        bad = ~evid.any(axis=0)
        if bad.any():
            raise Mp4jError(
                f"features {np.flatnonzero(bad).tolist()} have no "
                "finite values to fit quantile edges from"
                + ("" if sw is None else " (zero-weight rows carry no "
                   "evidence)"))
        nb = self.n_bins - 1 if self.missing_bucket else self.n_bins
        qs = np.arange(1, nb) / nb
        if sw is not None:
            edges = np.empty((X.shape[1], nb - 1), np.float32)
            for f in range(X.shape[1]):
                v, cw = _sorted_weighted_col(X[:, f], sw)
                edges[f] = _wq_inverted_cdf(v, cw, qs)
            # inverted_cdf picks actual data values -- no inf-inf
            # interpolation, so no NaN repair is needed
            self.edges = edges
            return self
        with warnings.catch_warnings():
            # inf sentinels make nanquantile warn on inf-inf interpolation
            warnings.simplefilter("ignore", RuntimeWarning)
            edges = np.nanquantile(X, qs, axis=0).T.astype(np.float32)
        # quantiles straddling inf sentinels interpolate to NaN; an
        # edge of +inf keeps the edge vector ordered and is matched
        # only by x = +inf (x >= inf), which belongs in the top bins
        self.edges = np.where(np.isnan(edges), np.float32(np.inf), edges)
        return self

    def local_sketch(self, X_shard, sample: int | None = 1_000_000,
                     seed: int = 0, sample_weight=None) -> FeatureSketch:
        """Per-rank half of a distributed fit: a :class:`FeatureSketch`
        with this shard's quantile points ``[min, q_{1/Q}, ...,
        q_{(Q-1)/Q}, max]`` ([F, Q+1]), merge-weight counts [F] (f32),
        finite-value evidence [F] and the per-point CDF ordinates
        [F, Q+1]. A feature with no data on this shard yields NaN sketch
        rows and count 0 -- legal locally, resolved at merge.

        ``sample_weight`` ([N] >= 0, optional): quantile points become
        weighted quantiles (see :meth:`fit`), merge counts become
        per-feature weight totals, and the CDF ordinates carry the
        weighted empirical limits at every point."""
        X = _host_rows(_rows_f32(X_shard))
        sw = (None if sample_weight is None
              else _check_weights(sample_weight, X.shape[0]))
        # merge weight = the FULL shard's data count / weight total
        # (NaN = missing is excluded; inf sentinels are data, exactly
        # as in fit) -- taken before sampling
        if sw is None:
            counts = (~np.isnan(X)).sum(axis=0).astype(np.float32)
        else:
            counts = ((~np.isnan(X)) * sw[:, None]).sum(
                axis=0).astype(np.float32)
        if sample is not None and X.shape[0] > sample:
            idx = np.random.default_rng(seed).choice(
                X.shape[0], sample, replace=False)
            X = X[idx]
            if sw is not None:
                sw = sw[idx]
        if sw is not None:
            return self._weighted_sketch(X, sw, counts)
        # evidence comes from the rows actually sketched, mirroring
        # fit()'s sample-then-check order: if sampling dropped every
        # data row of a feature, the sketch row is all-NaN and must
        # carry no weight either, or it would feed NaN into the merge
        finite = np.isfinite(X).any(axis=0).astype(np.float32)
        counts = np.where((~np.isnan(X)).any(axis=0), counts,
                          np.float32(0.0))
        nb = self.n_bins - 1 if self.missing_bucket else self.n_bins
        qs = np.arange(1, nb) / nb
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            inner = np.nanquantile(X, qs, axis=0).T
            lo = np.nanmin(X, axis=0)
            hi = np.nanmax(X, axis=0)
        # same inf rule as fit(): quantiles straddling inf sentinels
        # interpolate to NaN; +inf keeps the sketch monotone
        inner = np.where(np.isnan(inner), np.inf, inner)
        sketch = np.concatenate(
            [lo[:, None], inner, hi[:, None]], axis=1).astype(np.float32)
        # CDF ordinates: grid everywhere, EXCEPT runs of tied sketch
        # values, which are widened to the shard's true empirical jump
        # -- [frac < v, frac <= v] -- so a value holding (say) 40% of the
        # mass carries 40% through the merge instead of the <= 1/Q the
        # grid can express. Distinct-valued data keeps the exact grid.
        E = sketch.shape[1]
        grid = (np.arange(E) / nb).astype(np.float32)
        cdfs = np.tile(grid, (X.shape[1], 1))
        for f in range(X.shape[1]):
            row = sketch[f]
            if np.isnan(row).any() or not (row[1:] == row[:-1]).any():
                continue
            col = X[:, f]
            col = np.sort(col[~np.isnan(col)])
            M = col.size
            j = 0
            while j < E:
                k = j
                while k + 1 < E and row[k + 1] == row[j]:
                    k += 1
                if k > j:
                    left = np.searchsorted(col, row[j], side="left") / M
                    right = np.searchsorted(col, row[j],
                                            side="right") / M
                    a = min(grid[j], left)
                    b = max(grid[k], right)
                    cdfs[f, j:k + 1] = np.linspace(a, b, k - j + 1)
                j = k + 1
            cdfs[f] = np.maximum.accumulate(np.clip(cdfs[f], 0.0, 1.0))
        return FeatureSketch(sketch, counts, finite, cdfs)

    def _weighted_sketch(self, X, sw, counts) -> FeatureSketch:
        """Weighted :meth:`local_sketch` body: per-feature weighted
        quantile points + weighted empirical CDF ordinates; tied runs are
        widened to their true weighted jump, like the unweighted path."""
        F = X.shape[1]
        nb = self.n_bins - 1 if self.missing_bucket else self.n_bins
        E = nb + 1
        qs = np.arange(1, nb) / nb
        grid = np.arange(E) / nb
        sketch = np.full((F, E), np.nan, np.float32)
        cdfs = np.tile(grid.astype(np.float32), (F, 1))
        finite = np.zeros(F, np.float32)
        counts = counts.astype(np.float32).copy()
        for f in range(F):
            v, cw = _sorted_weighted_col(X[:, f], sw)
            if v is None:
                # sampling (or zero weights) left no data: the sketch
                # row must carry no merge weight
                counts[f] = 0.0
                continue
            finite[f] = float(np.isfinite(v).any())
            inner = _wq_inverted_cdf(v, cw, qs)
            row = np.concatenate([[v[0]], inner,
                                  [v[-1]]]).astype(np.float32)
            sketch[f] = row
            W = cw[-1]
            cw0 = np.concatenate([[0.0], cw])
            left = cw0[np.searchsorted(v, row, side="left")] / W
            right = cw0[np.searchsorted(v, row, side="right")] / W
            out = np.empty(E)
            j = 0
            while j < E:
                k = j
                while k + 1 < E and row[k + 1] == row[j]:
                    k += 1
                if k > j:
                    a = min(grid[j], left[j])
                    b = max(grid[k], right[j])
                    out[j:k + 1] = np.linspace(a, b, k - j + 1)
                else:
                    out[j] = np.clip(grid[j], left[j], right[j])
                j = k + 1
            cdfs[f] = np.maximum.accumulate(np.clip(out, 0.0, 1.0))
        return FeatureSketch(sketch, counts, finite, cdfs)

    def merge_sketches(self, sketch_stack, counts_stack,
                       finite_stack=None, cdf_stack=None):
        """Merge per-rank sketches into fitted edges. Each rank's sketch
        is a piecewise-linear CDF through its (value, cdf) points -- the
        grid [0, 1/Q, ..., 1] when ``cdf_stack`` is omitted, the
        tie-aware ordinates of :class:`FeatureSketch` when given. The
        pooled CDF is the count-weighted average of the per-rank CDFs,
        evaluated (left AND right limits) at the union of all sketch
        values and inverted at the target quantiles. Exact when one rank
        holds all of a feature's distinct-valued data; O(1/Q) in quantile
        space across ranks. [R, F, Q+1] sketches + [R, F] counts (+
        [R, F, Q+1] cdf) -> self fitted.

        ``finite_stack`` ([R, F], optional): per-rank any-finite-value
        evidence; when given, a feature no rank has finite values for
        raises, as ``fit`` does. It is separate from the merge weight: an
        inf-only shard still carries its inf mass into the pooled CDF."""
        sketch_stack = np.asarray(sketch_stack, np.float32)
        counts_stack = np.asarray(counts_stack, np.float32)
        R, F, E = sketch_stack.shape
        nb = self.n_bins - 1 if self.missing_bucket else self.n_bins
        if E != nb + 1:
            raise Mp4jError(
                f"sketch has {E} points per feature; this binner needs "
                f"{nb + 1} (n_bins mismatch?)")
        no_data = (counts_stack <= 0).all(axis=0)
        if no_data.any():
            raise Mp4jError(
                f"features {np.flatnonzero(no_data).tolist()} have no "
                "non-missing values on any rank")
        if finite_stack is not None:
            no_finite = (np.asarray(finite_stack, np.float32)
                         <= 0).all(axis=0)
            if no_finite.any():
                raise Mp4jError(
                    f"features {np.flatnonzero(no_finite).tolist()} "
                    "have no finite values on any rank (all NaN/inf); "
                    "fit() refuses these too")
        grid = np.arange(E) / nb                     # [0, 1/Q, ..., 1]
        if cdf_stack is None:
            cdf_stack = np.broadcast_to(grid, sketch_stack.shape)
        else:
            cdf_stack = np.asarray(cdf_stack)
            if cdf_stack.shape != sketch_stack.shape:
                raise Mp4jError(
                    f"cdf stack shape {cdf_stack.shape} != sketch "
                    f"shape {sketch_stack.shape}")
            # ordinates ride the wire as float32; snap grid knots back
            # to their exact float64 values so the distinct-data
            # inversion stays bit-exact against fit()
            g32 = grid.astype(np.float32)
            cdf_stack = np.where(
                cdf_stack.astype(np.float32) == g32,
                grid, cdf_stack.astype(np.float64))
        qs = grid[1:-1]
        merged = np.empty((F, nb - 1), np.float32)
        for f in range(F):
            live = counts_stack[:, f] > 0
            w = counts_stack[live, f]
            w = w / w.sum()
            # pooled CDF limits at every distinct sketch value: the
            # count-weighted average of the per-rank CDFs' left/right
            # limits (jumps at tied points survive pooling)
            pts = np.unique(sketch_stack[live, f])
            pl = np.zeros(pts.shape)
            pr = np.zeros(pts.shape)
            for r_w, r_sk, r_cdf in zip(w, sketch_stack[live, f],
                                        cdf_stack[live, f]):
                lt, rt = _cdf_limits(r_sk, r_cdf, pts)
                pl += r_w * lt
                pr += r_w * rt
            # inversion polyline: (left, v), (right, v) per value --
            # vertical jump segments invert to exactly v
            inv_x = np.empty(2 * pts.size)
            inv_x[0::2] = pl
            inv_x[1::2] = pr
            merged[f] = np.interp(qs, inv_x, np.repeat(pts, 2))
        self.edges = np.where(np.isnan(merged), np.float32(np.inf),
                              merged)
        return self

    def transform(self, X, device=None):
        """Continuous [N, F] -> int32 bin ids in [0, n_bins), as a
        tensor on ``device`` (default: X's own device for a tensor, else
        ``cuda:0``), through :func:`bin_ids`.

        NaN inputs land in bin 0 (the missing bucket) -- unlike
        ``np.searchsorted``, which sorts NaN after every edge. Under
        ``missing_bucket`` finite values land in [1, n_bins) and bin 0 is
        EXACTLY the NaN set."""
        if self.edges is None:
            raise Mp4jError("binner is not fitted")
        if isinstance(X, torch.Tensor) and device is None:
            dev = X.device
        else:
            dev = make_device(device)
        X = _rows_f32(X)
        if X.shape[1] != self.edges.shape[0]:
            raise Mp4jError(
                f"X must be [N, {self.edges.shape[0]}], got "
                f"{tuple(X.shape)}")
        X = torch.as_tensor(X, device=dev)
        edges = torch.from_numpy(self.edges).to(dev)
        # the comparison count's [rows, F, B-1] intermediate is chunked by
        # rows as the reference chunks it, to ~64M elements
        fb = self.edges.shape[0] * max(1, self.edges.shape[1])
        chunk = max(1, (64 << 20) // fb)
        out = torch.empty(tuple(X.shape), dtype=torch.int32, device=dev)
        for s in range(0, X.shape[0], chunk):
            out[s:s + chunk] = bin_ids(X[s:s + chunk], edges,
                                       self.missing_bucket)
        return out

    def fit_transform(self, X, device=None, **kw):
        return self.fit(X, **kw).transform(X, device)
