"""The port's quantile binning (ytk_mp4j_tpu_torch/models/binning.py)
against the JAX package's (ytk_mp4j_tpu/models/binning.py), on the CPU.

The host code of the fit, the sketches and the merge is the reference's,
copied, so every edge is held BITWISE; so are the transform's bin ids
(the port's comparison count on a tensor against the reference's on a
jax array), NaN, +-inf and the missing bucket included. The cases mirror
tests/test_binning.py except those of ``fit_distributed`` and its socket
and thread backends, which the port does not have yet."""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # property tests need hypothesis
from hypothesis import given, settings, strategies as st  # noqa: E402

from ytk_mp4j_tpu.exceptions import Mp4jError as JaxMp4jError  # noqa: E402
from ytk_mp4j_tpu.models import binning as J  # noqa: E402
from ytk_mp4j_tpu_torch.exceptions import Mp4jError  # noqa: E402
from ytk_mp4j_tpu_torch.models import binning as T  # noqa: E402


def _pair(n_bins, missing_bucket=False):
    return (J.QuantileBinner(n_bins, missing_bucket=missing_bucket),
            T.QuantileBinner(n_bins, missing_bucket=missing_bucket))


def _ids(binner, X):
    """The port's transform of X on the CPU, as numpy."""
    out = binner.transform(X, device="cpu")
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


def _fit_both(X, n_bins, missing_bucket=False, **kw):
    """Both binners fitted on X; asserts bitwise-equal edges and ids."""
    jb, pb = _pair(n_bins, missing_bucket)
    jb.fit(X, **kw)
    pb.fit(X, **kw)
    assert pb.edges.dtype == jb.edges.dtype == np.float32
    np.testing.assert_array_equal(pb.edges, jb.edges)
    np.testing.assert_array_equal(_ids(pb, X), jb.transform(X))
    return jb, pb


def _sketch_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _merge_both(n_bins, shards, with_cdf=False, weights=None):
    """Sketch every shard and merge, in both packages; asserts bitwise
    sketches and edges. Returns the port's binner."""
    jb, pb = _pair(n_bins)
    weights = weights or [None] * len(shards)
    jsk = [jb.local_sketch(s, sample=None, sample_weight=w)
           for s, w in zip(shards, weights)]
    psk = [pb.local_sketch(s, sample=None, sample_weight=w)
           for s, w in zip(shards, weights)]
    for a, b in zip(jsk, psk):
        _sketch_equal(a, b)
    extra = {}
    for b, sk in ((jb, jsk), (pb, psk)):
        if with_cdf:
            extra = dict(finite_stack=np.stack([s.finite for s in sk]),
                         cdf_stack=np.stack([s.cdf for s in sk]))
        b.merge_sketches(np.stack([s.values for s in sk]),
                         np.stack([s.counts for s in sk]), **extra)
    np.testing.assert_array_equal(pb.edges, jb.edges)
    return pb


# ----------------------------------------------------------------------
# fit + transform
# ----------------------------------------------------------------------
def test_bins_match_searchsorted(rng):
    N, F, B = 5000, 4, 16
    X = rng.standard_normal((N, F)).astype(np.float32) * [1, 10, 0.1, 3]
    _, pb = _fit_both(X, B, sample=None)
    bins = _ids(pb, X)
    assert bins.min() >= 0 and bins.max() < B
    for f in range(F):
        want = np.searchsorted(pb.edges[f], X[:, f], side="right")
        np.testing.assert_array_equal(bins[:, f], want)
    np.testing.assert_array_equal(
        T.QuantileBinner(B).fit_transform(X, device="cpu",
                                          sample=None).numpy(), bins)


def test_bins_are_balanced(rng):
    N, B = 20_000, 8
    X = rng.standard_normal((N, 1)).astype(np.float32)
    _, pb = _fit_both(X, B, sample=None)
    counts = np.bincount(_ids(pb, X)[:, 0], minlength=B)
    assert counts.min() > 0.8 * N / B
    assert counts.max() < 1.2 * N / B


def test_errors():
    for bad in ((1, False), (2, True), (65537, False)):
        with pytest.raises(JaxMp4jError):
            J.QuantileBinner(*bad)
        with pytest.raises(Mp4jError):
            T.QuantileBinner(*bad)
    b = T.QuantileBinner(4)
    with pytest.raises(Mp4jError, match="not fitted"):
        b.transform(np.zeros((3, 2)), device="cpu")
    b.fit(np.random.default_rng(0).random((100, 2)), sample=None)
    for X in (np.zeros((3, 5)), np.zeros(3)):           # wrong F, not 2-D
        with pytest.raises(Mp4jError):
            b.transform(X, device="cpu")
        with pytest.raises(JaxMp4jError):
            J.QuantileBinner(4).fit(np.random.default_rng(0).random(
                (100, 2)), sample=None).transform(X)
    with pytest.raises(Mp4jError):
        T.QuantileBinner(4).fit(np.zeros(10), sample=None)


@pytest.mark.parametrize("missing_bucket", [False, True])
def test_nan_handling(rng, missing_bucket):
    """NaN rows land in bin 0, edges fit from finite values only, an
    all-NaN feature raises in both packages."""
    N, B = 4000, 8
    X = rng.standard_normal((N, 2)).astype(np.float32)
    X[::7, 0] = np.nan
    _, pb = _fit_both(X, B, missing_bucket, sample=None)
    bins = _ids(pb, X)
    assert (bins[::7, 0] == 0).all()
    if missing_bucket:
        assert (bins[~np.isnan(X)] >= 1).all()
    X_bad = X.copy()
    X_bad[:, 1] = np.nan
    with pytest.raises(JaxMp4jError):
        J.QuantileBinner(B, missing_bucket).fit(X_bad, sample=None)
    with pytest.raises(Mp4jError, match="no finite"):
        T.QuantileBinner(B, missing_bucket).fit(X_bad, sample=None)


@pytest.mark.parametrize("missing_bucket", [False, True])
@pytest.mark.parametrize("sentinels", ["+inf", "-inf", "both"])
def test_inf_sentinels_bitwise(rng, missing_bucket, sentinels):
    """inf sentinels are data: they fit, and they bin to the end bins;
    -inf runs can leave the edge vector out of order (NaN quantiles
    become +inf), where only a comparison count agrees with the
    reference."""
    N, B = 3000, 8
    X = rng.standard_normal((N, 2)).astype(np.float32)
    if sentinels in ("+inf", "both"):
        X[::3, 0] = np.inf
    if sentinels in ("-inf", "both"):
        X[1::2, 1] = -np.inf
    X[::11, 1] = np.nan
    _, pb = _fit_both(X, B, missing_bucket, sample=None)
    if sentinels != "-inf":
        assert (_ids(pb, X)[::3, 0] == B - 1).all()


@pytest.mark.parametrize("missing_bucket", [False, True])
def test_transform_chunks_bitwise(rng, missing_bucket):
    """Rows beyond one chunk (~64M compares: 256 rows at 4 x 65535
    edges) are binned chunk by chunk, as in the reference."""
    N, F, B = 1000, 4, 65536
    X = rng.standard_normal((N, F)).astype(np.float32)
    X[rng.random((N, F)) < 0.1] = np.nan
    _fit_both(X, B, missing_bucket, sample=None)


def test_fit_and_transform_take_tensors(rng):
    """A tensor stays on its device: fit copies only its row sample (the
    rows the reference samples with the same seed) to the host, and
    transform returns a tensor on the tensor's device."""
    X = rng.standard_normal((5000, 3)).astype(np.float32)
    X[::13, 2] = np.nan
    jb = J.QuantileBinner(16).fit(X, sample=700, seed=4)
    pb = T.QuantileBinner(16).fit(torch.from_numpy(X), sample=700, seed=4)
    np.testing.assert_array_equal(pb.edges, jb.edges)
    out = pb.transform(torch.from_numpy(X))
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), jb.transform(X))
    w = rng.uniform(0.1, 3.0, 5000)
    np.testing.assert_array_equal(
        T.QuantileBinner(16).fit(torch.from_numpy(X), sample=700, seed=4,
                                 sample_weight=w).edges,
        J.QuantileBinner(16).fit(X, sample=700, seed=4,
                                 sample_weight=w).edges)


def test_transform_runs_on_the_card_unless_asked(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = rng.standard_normal((100, 2)).astype(np.float32)
    b = T.QuantileBinner(4).fit(X, sample=None)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        b.transform(X)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        b.transform(torch.from_numpy(X), device="cuda")
    assert b.transform(X, device="cpu").shape == (100, 2)


def test_empty_input_transform(rng):
    b = T.QuantileBinner(4).fit(rng.random((50, 3)), sample=None)
    out = b.transform(np.zeros((0, 3), np.float32), device="cpu")
    assert out.shape == (0, 3) and out.dtype == torch.int32


# ----------------------------------------------------------------------
# sketches and their merge
# ----------------------------------------------------------------------
def _quantile_positions(X, edges):
    F = X.shape[1]
    pos = np.empty_like(edges)
    for f in range(F):
        col = np.sort(X[:, f][np.isfinite(X[:, f])])
        pos[f] = np.searchsorted(col, edges[f], side="right") / len(col)
    return pos


def test_merge_sketches_matches_single_host(rng):
    N, B = 40_000, 32
    X = np.stack([
        rng.standard_normal(N), rng.lognormal(0.0, 1.0, N),
        rng.uniform(-5, 5, N), rng.standard_normal(N) * 100 + 7,
        np.where(rng.random(N) < 0.3, np.nan, rng.standard_normal(N)),
    ], axis=1).astype(np.float32)
    cuts = [0, 4_000, 14_000, 27_000, N]
    shards = [X[cuts[i]:cuts[i + 1]] for i in range(4)]
    pb = _merge_both(B, shards)
    qs = np.arange(1, B) / B
    err = np.abs(_quantile_positions(X, pb.edges) - qs[None, :]).max()
    assert err < 2.0 / B, err


def test_merge_sketch_feature_missing_on_some_ranks(rng):
    B = 8
    col = rng.standard_normal(9_000).astype(np.float32)
    shards = []
    for r in range(3):
        s = np.empty((3_000, 2), np.float32)
        s[:, 0] = rng.standard_normal(3_000)
        s[:, 1] = np.nan if r != 1 else col[:3_000]
        shards.append(s)
    pb = _merge_both(B, shards)
    want = T.QuantileBinner(B).fit(shards[1][:, 1:2], sample=None).edges[0]
    np.testing.assert_allclose(pb.edges[1], want, rtol=1e-5, atol=1e-5)


def test_merge_sketch_errors_like_the_reference():
    cases = [
        (4, (np.full((2, 1, 5), np.nan, np.float32),
             np.zeros((2, 1), np.float32)), "no non-missing"),
        (8, (np.zeros((2, 1, 3), np.float32),
             np.ones((2, 1), np.float32)), "points per feature"),
        (4, (np.zeros((1, 1, 5), np.float32), np.ones((1, 1), np.float32),
             np.zeros((1, 1), np.float32)), "no finite"),
        (4, (np.zeros((1, 1, 5), np.float32), np.ones((1, 1), np.float32),
             None, np.zeros((1, 1, 4))), "cdf stack shape"),
    ]
    for B, args, msg in cases:
        with pytest.raises(JaxMp4jError, match=msg):
            J.QuantileBinner(B).merge_sketches(*args)
        with pytest.raises(Mp4jError, match=msg):
            T.QuantileBinner(B).merge_sketches(*args)


def test_all_inf_feature_raises_like_fit(rng):
    X = np.stack([rng.standard_normal(100).astype(np.float32),
                  np.full(100, np.inf, np.float32)], axis=1)
    with pytest.raises(Mp4jError, match="no finite"):
        T.QuantileBinner(8).fit(X, sample=None)
    sk = T.QuantileBinner(4).local_sketch(
        np.full((10, 1), np.inf, np.float32), sample=None)
    _sketch_equal(sk, J.QuantileBinner(4).local_sketch(
        np.full((10, 1), np.inf, np.float32), sample=None))
    assert sk.counts[0] == 10 and sk.finite[0] == 0.0
    with pytest.raises(Mp4jError, match="no finite"):
        T.QuantileBinner(4).merge_sketches(sk.values[None], sk.counts[None],
                                           np.zeros((1, 1), np.float32))


def test_sampling_drops_all_finite_rows_still_raises():
    N, S, seed = 10_000, 50, 0
    picked = set(np.random.default_rng(seed).choice(N, S, replace=False))
    free = [i for i in range(N) if i not in picked][:3]
    X = np.full((N, 2), np.nan, np.float32)
    X[:, 0] = np.random.default_rng(1).standard_normal(N)
    X[free, 1] = [1.0, 2.0, 3.0]
    with pytest.raises(Mp4jError, match="no finite"):
        T.QuantileBinner(8).fit(X, sample=S, seed=seed)
    with pytest.raises(Mp4jError, match="no finite"):
        T.QuantileBinner(8).fit(torch.from_numpy(X), sample=S, seed=seed)
    sk = T.QuantileBinner(8).local_sketch(X, sample=S, seed=seed)
    _sketch_equal(sk, J.QuantileBinner(8).local_sketch(X, sample=S,
                                                       seed=seed))
    assert sk.counts[1] == 0.0 and sk.finite[1] == 0.0
    assert sk.counts[0] == N and sk.finite[0] == 1.0


def test_mixed_inf_shard_keeps_inf_mass(rng):
    fin = rng.standard_normal((1000, 1)).astype(np.float32)
    inf = np.full((1000, 1), np.inf, np.float32)
    jb, pb = _pair(8)
    for b in (jb, pb):
        sk = [b.local_sketch(s, sample=None) for s in (fin, inf)]
        b.merge_sketches(np.stack([s.values for s in sk]),
                         np.stack([s.counts for s in sk]),
                         np.asarray([[1.0], [0.0]], np.float32))
    np.testing.assert_array_equal(pb.edges, jb.edges)
    assert np.isinf(pb.edges[0][-2:]).all()
    assert np.isfinite(pb.edges[0][:3]).all()


def test_local_sketch_weight_is_full_shard_count(rng):
    X_big = rng.standard_normal((10_000, 2)).astype(np.float32) + 5.0
    X_small = rng.standard_normal((1_000, 2)).astype(np.float32) - 5.0
    jb, pb = _pair(8)
    jsk = [jb.local_sketch(x, sample=500, seed=0) for x in (X_big, X_small)]
    psk = [pb.local_sketch(x, sample=500, seed=0) for x in (X_big, X_small)]
    for a, b in zip(jsk, psk):
        _sketch_equal(a, b)
    np.testing.assert_array_equal(psk[0].counts, [10_000, 10_000])
    for b, sk in ((jb, jsk), (pb, psk)):
        b.merge_sketches(np.stack([s.values for s in sk]),
                         np.stack([s.counts for s in sk]))
    np.testing.assert_array_equal(pb.edges, jb.edges)
    assert pb.edges[0][len(pb.edges[0]) // 2] > 3.0


def test_local_sketch_inf_sentinels(rng):
    col = np.concatenate([rng.standard_normal(1000).astype(np.float32),
                          np.full(300, np.inf, np.float32)])
    pb = _merge_both(8, [col[:, None]])
    want = T.QuantileBinner(8).fit(col[:, None], sample=None).edges[0]
    np.testing.assert_array_equal(np.isinf(pb.edges[0]), np.isinf(want))


@st.composite
def _shard_sets(draw):
    """1-5 shards, 1-3 features, varied sizes and scales, optional NaN
    contamination; every feature has data somewhere."""
    R = draw(st.integers(1, 5))
    F = draw(st.integers(1, 3))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    shards = []
    for _ in range(R):
        n = draw(st.integers(5, 400))
        s = (rng.standard_normal((n, F)) * draw(st.floats(0.1, 100.0))
             + draw(st.floats(-50.0, 50.0))).astype(np.float32)
        if draw(st.booleans()):
            s[rng.random((n, F)) < 0.2] = np.nan
        shards.append(s)
    data = np.concatenate(shards)
    for f in range(F):
        if np.isnan(data[:, f]).all():
            shards[0][:, f] = rng.standard_normal(len(shards[0]))
    return shards


@settings(max_examples=20, deadline=None)
@given(_shard_sets(), st.integers(3, 32), st.booleans())
def test_merge_bitwise_monotone_bounded(shards, B, with_cdf):
    pb = _merge_both(B, shards, with_cdf=with_cdf)
    data = np.concatenate(shards)
    for f in range(pb.edges.shape[0]):
        e = pb.edges[f]
        assert (e[1:] >= e[:-1]).all()
        col = data[:, f]
        col = col[~np.isnan(col)]
        assert e[0] >= col.min() - 1e-4 and e[-1] <= col.max() + 1e-4
    jb = J.QuantileBinner(B)
    jb.edges = pb.edges
    np.testing.assert_array_equal(_ids(pb, data), jb.transform(data))


@settings(max_examples=15, deadline=None)
@given(_shard_sets(), st.integers(3, 16))
def test_single_concatenated_shard_matches_fit(shards, B):
    data = np.concatenate(shards)
    pb = _merge_both(B, [data])
    want = T.QuantileBinner(B).fit(data, sample=None)
    np.testing.assert_allclose(pb.edges, want.edges, rtol=1e-5, atol=1e-5)


def test_tie_mass_rides_the_merge(rng):
    B, N = 8, 9_000
    col = np.where(rng.random(N) < 0.9, 0.0,
                   rng.uniform(1.0, 2.0, N)).astype(np.float32)
    shards = [col[i::3][:, None] for i in range(3)]
    pb = _merge_both(B, shards, with_cdf=True)
    np.testing.assert_array_equal(pb.edges[0], np.zeros(B - 1))


def test_merge_with_tied_values(rng):
    B = 8
    col = rng.integers(0, 5, 9_000).astype(np.float32)
    pb = _merge_both(B, [col[i::3][:, None] for i in range(3)])
    e = pb.edges[0]
    assert (e[1:] >= e[:-1]).all() and e[0] >= 0.0 and e[-1] <= 4.0
    out = _ids(pb, col[:, None])
    assert out.min() >= 0 and out.max() < B
    const = _merge_both(B, [np.full((600, 1), 7.0, np.float32)])
    assert len(np.unique(_ids(const, np.full((600, 1), 7.0,
                                             np.float32)))) == 1


# ----------------------------------------------------------------------
# weighted fits and sketches
# ----------------------------------------------------------------------
def test_fit_weighted_matches_reference_and_numpy(rng):
    N, F, B = 5_000, 3, 16
    X = np.stack([rng.standard_normal(N), rng.lognormal(0.0, 1.0, N),
                  rng.integers(0, 7, N).astype(np.float64)],
                 axis=1).astype(np.float32)
    w = rng.gamma(0.3, 2.0, N)
    _, pb = _fit_both(X, B, sample=None, sample_weight=w)
    qs = np.arange(1, B) / B
    for f in range(F):
        want = np.quantile(X[:, f].astype(np.float64), qs,
                           method="inverted_cdf", weights=w)
        np.testing.assert_allclose(pb.edges[f], want, rtol=1e-6, atol=1e-6)


def test_fit_weighted_integer_weights_equal_duplication(rng):
    X = rng.integers(0, 5, (800, 2)).astype(np.float32)
    k = rng.integers(1, 6, 800)
    _, pw = _fit_both(X, 8, sample=None, sample_weight=k.astype(np.float64))
    pd = T.QuantileBinner(8).fit(np.repeat(X, k, axis=0), sample=None,
                                 sample_weight=np.ones(int(k.sum())))
    np.testing.assert_array_equal(pw.edges, pd.edges)


def test_weighted_sketches_and_merges(rng):
    """A one-shard weighted merge equals the weighted fit; skewed
    per-shard weights and a value holding ~99% of the weight merge as in
    the reference."""
    X = rng.standard_normal((4_000, 2)).astype(np.float32)
    w = rng.gamma(1.0, 1.0, 4_000)
    pb = _merge_both(16, [X], with_cdf=True, weights=[w])
    want = T.QuantileBinner(16).fit(X, sample=None, sample_weight=w)
    np.testing.assert_allclose(pb.edges, want.edges, rtol=1e-5, atol=1e-5)
    shards = [rng.standard_normal((3_000, 1)).astype(np.float32) + r
              for r in range(3)]
    _merge_both(16, shards, with_cdf=True,
                weights=[np.full(3_000, 10.0 ** r) for r in range(3)])
    vals = rng.standard_normal((1_000, 1)).astype(np.float32)
    vals[0, 0] = 0.5
    heavy = np.ones(1_000)
    heavy[0] = 99_000.0
    pb2 = _merge_both(16, [vals[:500], vals[500:]], with_cdf=True,
                      weights=[heavy[:500], heavy[500:]])
    assert (pb2.edges[0] == np.float32(0.5)).all()


def test_weight_validation_errors(rng):
    X = rng.standard_normal((10, 2)).astype(np.float32)
    X2 = np.stack([np.arange(10, dtype=np.float32),
                   np.full(10, np.nan, np.float32)], axis=1)
    X2[:3, 1] = 1.0
    w0 = np.ones(10)
    w0[:3] = 0.0
    cases = [(X, np.ones(5), "sample_weight"),
             (X, -np.ones(10), "finite and non-negative"),
             (X, np.full(10, np.nan), "finite and non-negative"),
             (X, np.zeros(10), "sums to zero"),
             (X2, w0, "no finite")]
    for data, w, msg in cases:
        with pytest.raises(JaxMp4jError, match=msg):
            J.QuantileBinner(4).fit(data, sample_weight=w)
        with pytest.raises(Mp4jError, match=msg):
            T.QuantileBinner(4).fit(data, sample_weight=w)
        if msg != "no finite":       # local_sketch leaves that to the merge
            with pytest.raises(Mp4jError, match=msg):
                T.QuantileBinner(4).local_sketch(data, sample_weight=w)
