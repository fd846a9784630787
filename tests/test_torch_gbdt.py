"""The port's GBDT (ytk_mp4j_tpu_torch/models/gbdt.py) against the JAX
package's, on the CPU, with inputs made from a numpy seed.

Split choices and routing are held bitwise: identical histograms give
identical (feat, bin, dir), and routing is exact. Leaves and margins agree
to rtol = 1e-4, atol = 1e-5: the reference sums histograms and leaves
through hi/lo bf16 products (~2^-17 relative each), the port in f64/f32.
Where whole trees are compared, the data is chosen so that every node's
best gain clears its runner-up and the freeze threshold by a relative
margin (``_assert_clear_splits``), so that no legitimate near-tie can
flip a split between the two summation orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ytk_mp4j_tpu.exceptions import Mp4jError as JaxMp4jError
from ytk_mp4j_tpu.models import gbdt as J
from ytk_mp4j_tpu.parallel import make_mesh
from ytk_mp4j_tpu_torch import GBDTConfig, GBDTTrainer, trees_from_numpy
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models import gbdt as T

RTOL, ATOL = 1e-4, 1e-5
CLEAR_GAP = 5e-4      # relative margin every split decision must clear


def _data(loss, seed=0, N=2048, F=6, B=16):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    if loss == "squared":
        y = (bins[:, 0] / B + 0.3 * bins[:, 1] / B
             + 0.1 * rng.standard_normal(N)).astype(np.float32)
    elif loss == "logistic":
        y = (bins[:, 1] / B + 0.5 * bins[:, 3] / B
             + 0.3 * rng.standard_normal(N) > 0.75).astype(np.float32)
    else:
        s = (np.stack([bins[:, 0] / B, bins[:, 2] / B, np.full(N, 0.5)], 1)
             + 0.3 * rng.standard_normal((N, 3)))
        y = s.argmax(1).astype(np.int32)
    return bins, y


def _cfg_kwargs(loss, **kw):
    base = dict(n_features=6, n_bins=16, depth=3, learning_rate=0.3,
                n_trees=4, loss=loss, n_classes=3)
    base.update(kw)
    return base


def _per_class(trees, loss):
    """[(feat, bin, dir, leaf) numpy] for every tree of every round."""
    out = []
    for rnd in trees:
        for t in (rnd if loss == "softmax" else (rnd,)):
            out.append([np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a.numpy() for a in t])
    return out


def _assert_same_trees(jax_trees, port_trees, loss):
    a, b = _per_class(jax_trees, loss), _per_class(port_trees, loss)
    assert len(a) == len(b)
    for ja, pa in zip(a, b):
        for k in range(3):
            np.testing.assert_array_equal(pa[k], ja[k])
        np.testing.assert_allclose(pa[3], ja[3], rtol=RTOL, atol=ATOL)


def _grad_hess(cfg, margins, y):
    if cfg.loss == "softmax":
        p = torch.softmax(margins, 1)
        return [(p[:, c] - (y == c).float(), p[:, c] * (1 - p[:, c]))
                for c in range(cfg.n_classes)]
    if cfg.loss == "logistic":
        p = torch.sigmoid(margins)
        return [(p - y, p * (1 - p))]
    return [(margins - y, torch.ones_like(margins))]


def _assert_clear_splits(trainer, bins, y, trees):
    """Replay the port's trees level by level on full (not subtracted)
    histograms and assert that, in every node with samples, the best gain
    beats the next distinct gain and the freeze threshold by CLEAR_GAP
    relative. Equal gains are identical partitions (empty bins between
    them) and tie the same way in both packages."""
    cfg = trainer.cfg
    bins_t = torch.from_numpy(bins)
    y_t = torch.from_numpy(y)
    N = bins.shape[0]
    margins = torch.zeros((N, cfg.n_classes) if cfg.loss == "softmax"
                          else (N,))
    checked = 0
    for rnd in trees:
        per = rnd if cfg.loss == "softmax" else (rnd,)
        for (g, h), tree in zip(_grad_hess(cfg, margins, y_t), per):
            node = torch.zeros(N, dtype=torch.int32)
            start = 0
            for d in range(cfg.depth):
                n = 2 ** d
                hg, hh = T.build_histograms(bins_t, g.contiguous(),
                                            h.contiguous(), node, n, cfg)
                gain, _ = T.split_gains(hg, hh, cfg.reg_lambda, None,
                                        cfg.min_child_hessian,
                                        cfg._cat_mask(), cfg.missing_bin)
                counts = torch.bincount(node.long(), minlength=n)
                for k in range(n):
                    gk = gain[k].reshape(-1).double()
                    best = gk.max().item()
                    if counts[k] < 2 or best == float("-inf"):
                        continue
                    scale = max(abs(best), 1e-12)
                    below = gk[gk < best]
                    if below.numel():
                        assert best - below.max().item() > CLEAR_GAP * scale
                    assert abs(best - cfg.min_split_gain) > CLEAR_GAP * scale
                    checked += 1
                lvl = slice(start, start + n)
                node = T._route_samples(bins_t, node, tree[0][lvl],
                                        tree[1][lvl], tree[2][lvl],
                                        cfg._cat_mask(), cfg.missing_bin,
                                        cfg.n_bins)
                start += n
        margins = trainer._add_tree(margins, bins_t, rnd)
    assert checked > 0


def _jax_train(cfg_kw, bins, y, **kw):
    tr = J.GBDTTrainer(J.GBDTConfig(**cfg_kw), mesh=make_mesh(1))
    trees, margins = tr.train(bins, y, **kw)
    return tr, trees, margins


def _port_train(cfg_kw, bins, y, **kw):
    tr = GBDTTrainer(GBDTConfig(**cfg_kw), device="cpu")
    trees, margins = tr.train(bins, y, **kw)
    return tr, trees, margins.numpy()


# ----------------------------------------------------------------------
# config, histograms, splits, routing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bad", [
    dict(hist_mode="scatter"), dict(loss="hinge"),
    dict(loss="softmax", n_classes=1), dict(subsample=0.0),
    dict(colsample=1.5), dict(categorical_features=(True,)),
    dict(categorical_features=(3,), n_features=3),
    dict(categorical_features=("a",)),
])
def test_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(JaxMp4jError):
        J.GBDTConfig(**bad)
    with pytest.raises(Mp4jError):
        GBDTConfig(**bad)


def test_config_normalizes_categoricals_like_the_reference():
    kw = dict(n_features=4, categorical_features=[np.int64(2), 0])
    assert (GBDTConfig(**kw).categorical_features
            == J.GBDTConfig(**kw).categorical_features == (2, 0))
    np.testing.assert_array_equal(GBDTConfig(**kw)._cat_mask(),
                                  J.GBDTConfig(**kw)._cat_mask())


@pytest.mark.parametrize("mode", ["pallas", "matmul", "pair", "flat"])
def test_build_histograms_modes_match_reference(rng, mode):
    N, F, B, n = 1500, 6, 8, 4
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    g = rng.standard_normal(N).astype(np.float32)
    h = np.ones(N, np.float32)
    nid = rng.integers(0, n + 1, N).astype(np.int32)   # with sentinels
    kw = dict(n_features=F, n_bins=B, hist_mode=mode)
    want = J.build_histograms(jnp.array(bins), jnp.array(g), jnp.array(h),
                              jnp.array(nid), n, J.GBDTConfig(**kw))
    got = T.build_histograms(torch.from_numpy(bins), torch.from_numpy(g),
                             torch.from_numpy(h), torch.from_numpy(nid), n,
                             GBDTConfig(**kw))
    for k in range(2):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)


_SPLIT_CASES = {
    "plain": {},
    "lambda0": dict(reg_lambda=0.0),
    "missing": dict(missing_bin=True),
    "categorical": dict(cat_mask=np.array([False, True, False, True, False])),
    "missing+categorical": dict(missing_bin=True,
                                cat_mask=np.array([True, False, False,
                                                   False, True])),
    "feat_mask": dict(feat_mask=np.array([True, False, True, False, True])),
    "min_child": dict(min_child_hessian=6.0),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_best_splits_identical_on_identical_histograms(rng, case):
    n, F, B = 8, 5, 16
    hg = rng.standard_normal((n, F, B)).astype(np.float32)
    hh = rng.integers(0, 4, (n, F, B)).astype(np.float32)
    hg[hh == 0] = 0.0                                  # empty bins
    kw = dict(_SPLIT_CASES[case])
    lam = kw.pop("reg_lambda", 1.0)
    jkw = dict(kw)
    tkw = dict(kw)
    if "feat_mask" in kw:
        jkw["feat_mask"] = jnp.array(kw["feat_mask"])
        tkw["feat_mask"] = torch.from_numpy(kw["feat_mask"])
    want = J.best_splits(jnp.array(hg), jnp.array(hh), lam, **jkw)
    got = T.best_splits(torch.from_numpy(hg), torch.from_numpy(hh), lam,
                        **tkw)
    for k in (0, 1, 3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-6)


def test_best_splits_ties_go_to_the_first_maximum():
    hg = np.zeros((1, 3, 4), np.float32)
    hh = np.ones((1, 3, 4), np.float32)
    for f in (0, 2):                       # two identical best features
        hg[0, f] = [-5.0, -5.0, 5.0, 5.0]
    got = T.best_splits(torch.from_numpy(hg), torch.from_numpy(hh), 1.0)
    want = J.best_splits(jnp.array(hg), jnp.array(hh), 1.0)
    assert (int(got[0][0]), int(got[1][0])) == (0, 1)
    assert (int(got[0][0]), int(got[1][0])) == (int(want[0][0]),
                                                int(want[1][0]))


@pytest.mark.parametrize("missing_bin", [False, True])
@pytest.mark.parametrize("categorical", [False, True])
def test_route_samples_bitwise(rng, missing_bin, categorical):
    N, F, B, n = 500, 5, 8, 8
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    nid = rng.integers(0, n, N).astype(np.int32)
    feat = rng.integers(0, F, n).astype(np.int32)
    bin_ = rng.integers(0, B, n).astype(np.int32)
    bin_[0] = B - 1                                    # a frozen node
    dir_ = rng.integers(0, 2, n).astype(np.int32)
    cat = (np.array([True, False, True, False, False]) if categorical
           else None)
    want = J._route_samples(jnp.array(bins), jnp.array(nid),
                            jnp.array(feat), jnp.array(bin_), n,
                            jnp.array(dir_), cat, missing_bin, B)
    got = T._route_samples(torch.from_numpy(bins), torch.from_numpy(nid),
                           torch.from_numpy(feat), torch.from_numpy(bin_),
                           torch.from_numpy(dir_), cat, missing_bin, B)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# one boosting round and the whole trainer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_train_tree_shard_matches_reference(loss):
    bins, y = _data(loss)
    kw = _cfg_kwargs(loss)
    N = bins.shape[0]
    preds = np.zeros((N, 3) if loss == "softmax" else N, np.float32)
    want_p, want_t = J.train_tree_shard(jnp.array(bins), jnp.array(y),
                                        jnp.array(preds), J.GBDTConfig(**kw),
                                        interpret=True)
    got_p, got_t = T.train_tree_shard(torch.from_numpy(bins),
                                      torch.from_numpy(y),
                                      torch.from_numpy(preds),
                                      GBDTConfig(**kw))
    tr = GBDTTrainer(GBDTConfig(**kw), device="cpu")
    _assert_clear_splits(tr, bins, y, [got_t])
    _assert_same_trees([want_t], [got_t], loss)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_trainer_matches_reference(loss):
    bins, y = _data(loss)
    kw = _cfg_kwargs(loss)
    _, jt, jm = _jax_train(kw, bins, y)
    tr, pt, pm = _port_train(kw, bins, y)
    _assert_clear_splits(tr, bins, y, pt)
    _assert_same_trees(jt, pt, loss)
    np.testing.assert_allclose(pm, jm, rtol=RTOL, atol=ATOL)


def test_missing_and_categorical_trainer_matches_reference():
    rng = np.random.default_rng(0)
    N, F, B = 2048, 4, 8
    bins = rng.integers(1, B - 1, (N, F)).astype(np.int32)
    missing = rng.random(N) < 0.3
    bins[missing, 1] = 0
    y = ((bins[:, 0] == 3) * 1.5 + ((bins[:, 1] >= B // 2) | missing)
         + 0.3 * rng.standard_normal(N)).astype(np.float32)
    kw = dict(n_features=F, n_bins=B, depth=3, learning_rate=0.5, n_trees=3,
              missing_bin=True, categorical_features=(0,),
              min_split_gain=0.01)
    _, jt, jm = _jax_train(kw, bins, y)
    tr, pt, pm = _port_train(kw, bins, y)
    _assert_clear_splits(tr, bins, y, pt)
    _assert_same_trees(jt, pt, "squared")
    assert any((np.asarray(t[2]) > 0).any() for t in pt)   # a learned dir
    np.testing.assert_allclose(pm, jm, rtol=RTOL, atol=ATOL)


def test_sample_weight_matches_reference():
    bins, y = _data("squared")
    w = np.random.default_rng(1).uniform(0.2, 2.0, len(y)).astype(np.float32)
    kw = _cfg_kwargs("squared", n_trees=3)
    _, jt, jm = _jax_train(kw, bins, y, sample_weight=w)
    _, pt, pm = _port_train(kw, bins, y, sample_weight=w)
    _assert_same_trees(jt, pt, "squared")
    np.testing.assert_allclose(pm, jm, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("subsample,colsample", [
    (0.7, 1.0), (1.0, 0.5), (0.6, 0.6),
])
def test_sampling_masks_fed_to_both(subsample, colsample):
    """torch cannot reproduce jax.random's stream, so the port takes the
    reference's masks ready-made and must then grow the same tree."""
    bins, y = _data("squared")
    kw = _cfg_kwargs("squared", subsample=subsample, colsample=colsample)
    jcfg = J.GBDTConfig(**kw)
    key = jax.random.key(3)
    scale, fmask = J._sampling_masks(key, jcfg, len(y), None)
    masks = (None if scale is None else torch.from_numpy(np.array(scale)),
             None if fmask is None else torch.from_numpy(np.array(fmask)))
    preds = np.zeros(len(y), np.float32)
    want_p, want_t = J.train_tree_shard(jnp.array(bins), jnp.array(y),
                                        jnp.array(preds), jcfg,
                                        interpret=True, rng_key=key)
    got_p, got_t = T.train_tree_shard(torch.from_numpy(bins),
                                      torch.from_numpy(y),
                                      torch.from_numpy(preds),
                                      GBDTConfig(**kw), masks=masks)
    _assert_same_trees([want_t], [got_t], "squared")
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=RTOL, atol=ATOL)


def test_generator_masks_statistics():
    """The port's own draws: keep rates match the configured rates, kept
    samples are rescaled, at least one feature always survives and the
    rescued feature is uniform."""
    N, F = 200_000, 10
    cfg = GBDTConfig(n_features=F, subsample=0.3, colsample=0.5)
    gen = [torch.Generator().manual_seed(0)]
    scale, fmask = T._sampling_masks(gen, cfg, N, "cpu")
    kept = (scale > 0).double().mean().item()
    assert abs(kept - 0.3) < 5 * np.sqrt(0.3 * 0.7 / N)
    assert set(torch.unique(scale).tolist()) == {0.0, np.float32(1 / 0.3)}
    draws = 4000
    freq = torch.zeros(F)
    for _ in range(draws):
        freq += T._sampling_masks(gen, cfg, 1, "cpu")[1].float()
    sigma = np.sqrt(0.25 / draws)
    assert ((freq / draws - 0.5).abs() < 5 * sigma + 1e-3).all()

    rare = GBDTConfig(n_features=F, colsample=1e-6)
    rescued = torch.zeros(F)
    for _ in range(draws):
        m = T._sampling_masks(gen, rare, 1, "cpu")[1]
        assert int(m.sum()) == 1
        rescued += m.float()
    # uniform rescue: each feature ~ draws/F, 5 sigma
    sd = np.sqrt(draws * (1 / F) * (1 - 1 / F))
    assert ((rescued - draws / F).abs() < 5 * sd).all()

    a = T._sampling_masks([torch.Generator().manual_seed(7)], cfg, 100,
                          "cpu")
    b = T._sampling_masks([torch.Generator().manual_seed(7)], cfg, 100,
                          "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert T._sampling_masks(None, cfg, 100, "cpu") == (None, None)


def test_trainer_sampling_is_seeded_and_fits():
    bins, y = _data("squared")
    kw = _cfg_kwargs("squared", n_trees=6, subsample=0.7, colsample=0.7)
    _, _, a = _port_train(kw, bins, y, seed=0)
    _, _, b = _port_train(kw, bins, y, seed=0)
    _, _, c = _port_train(kw, bins, y, seed=1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert float(np.mean((a - y) ** 2)) < float(np.var(y)) * 0.5


# ----------------------------------------------------------------------
# predict, evaluation, importance, carrying trees across
# ----------------------------------------------------------------------
@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_jax_trees_served_by_port_predict(loss):
    bins, y = _data(loss)
    kw = _cfg_kwargs(loss)
    jtr, jt, _ = _jax_train(kw, bins, y)
    port = GBDTTrainer(GBDTConfig(**kw), device="cpu")
    trees = trees_from_numpy([tuple(tuple(np.asarray(a) for a in c)
                                    for c in r) if loss == "softmax"
                              else tuple(np.asarray(a) for a in r)
                              for r in jt], port.cfg, device="cpu")
    _assert_same_trees(jt, trees, loss)
    va, _ = _data(loss, seed=5, N=700)
    np.testing.assert_allclose(port.predict(va, trees).numpy(),
                               jtr.predict(va, jt), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.predict(va, trees, proba=True).numpy(),
                               jtr.predict(va, jt, proba=True),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.feature_importance(trees),
                                  jtr.feature_importance(jt))


@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_predict_reproduces_training_margins(loss):
    bins, y = _data(loss)
    tr, trees, margins = _port_train(_cfg_kwargs(loss), bins, y)
    np.testing.assert_array_equal(tr.predict(bins, trees).numpy(), margins)
    proba = tr.predict(bins, trees, proba=True).numpy()
    assert ((proba > 0) & (proba < 1)).all() or loss == "squared"
    if loss == "softmax":
        np.testing.assert_allclose(proba.sum(1), 1.0, rtol=1e-5)
    assert tr.predict(bins, []).abs().max().item() == 0.0


@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_eval_set_and_early_stopping_match_reference(loss):
    bins, y = _data(loss)
    va_bins, va_y = _data(loss, seed=9, N=512)
    kw = _cfg_kwargs(loss, n_trees=6)
    jtr, jt, _ = _jax_train(kw, bins, y, eval_set=(va_bins, va_y))
    ptr, pt, _ = _port_train(kw, bins, y, eval_set=(va_bins, va_y))
    assert len(ptr.eval_history_) == 6
    np.testing.assert_allclose(ptr.eval_history_, jtr.eval_history_,
                               rtol=1e-4)
    assert ptr.eval_history_[-1] < ptr.eval_history_[0]

    # pure-noise labels: stops early and truncates to the best round
    rng = np.random.default_rng(4)
    noise = (rng.standard_normal(len(y)).astype(np.float32)
             if loss == "squared" else y[rng.permutation(len(y))])
    va_noise = (rng.standard_normal(512).astype(np.float32)
                if loss == "squared" else va_y[rng.permutation(512)])
    stop = dict(eval_set=(va_bins, va_noise), early_stopping_rounds=2)
    jtr2, jt2, _ = _jax_train(kw, bins, noise, **stop)
    ptr2, pt2, pm2 = _port_train(kw, bins, noise, **stop)
    assert len(pt2) == len(jt2) < 6
    assert len(pt2) == int(np.argmin(ptr2.eval_history_)) + 1
    np.testing.assert_array_equal(ptr2.predict(bins, pt2).numpy(), pm2)
    with pytest.raises(Mp4jError):
        ptr2.train(bins, y, early_stopping_rounds=3)


def test_feature_importance_and_frozen_nodes():
    """An absurd min_split_gain freezes every node: no split counts."""
    bins, y = _data("squared")
    tr, trees, _ = _port_train(_cfg_kwargs("squared", min_split_gain=1e9),
                               bins, y)
    assert all((t[1] == 15).all() for t in trees)
    np.testing.assert_array_equal(tr.feature_importance(trees),
                                  np.zeros(6))
    tr, trees, _ = _port_train(_cfg_kwargs("squared"), bins, y)
    imp = tr.feature_importance(trees)
    assert imp.sum() == pytest.approx(1.0) and imp.argmax() in (0, 1)


def test_empty_leaf_nan_stays_isolated(rng):
    """reg_lambda=0 and an empty leaf give that leaf -0/0 = NaN; the
    gathers confine it to the rows that route there (none)."""
    N, F, B = 256, 3, 4
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=4, reg_lambda=0.0,
                     learning_rate=0.5)
    bins = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.int32))
    y = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    new_preds, tree = T.train_tree_shard(bins, y, torch.zeros(N), cfg)
    assert torch.isnan(tree[3]).any(), "test needs an empty leaf"
    assert torch.isfinite(new_preds).all()
    assert torch.isfinite(T.predict_tree(bins, tree, cfg)).all()


# ----------------------------------------------------------------------
# errors
# ----------------------------------------------------------------------
def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GBDTConfig(n_features=2, n_bins=4, depth=1)
    with pytest.raises(Mp4jError, match="device='cpu'"):
        GBDTTrainer(cfg)
    with pytest.raises(Mp4jError):
        GBDTTrainer(cfg, device="cuda")
    with pytest.raises(Mp4jError):
        trees_from_numpy([], cfg)
    assert GBDTTrainer(cfg, device="cpu").device == torch.device("cpu")


def test_bad_inputs_rejected(rng):
    cfg = GBDTConfig(n_features=3, n_bins=4, depth=2, n_trees=1,
                     loss="softmax", n_classes=3)
    tr = GBDTTrainer(cfg, device="cpu")
    bins = rng.integers(0, 4, (32, 3)).astype(np.int32)
    y = rng.integers(0, 3, 32).astype(np.int32)
    for bad_y in (np.full(32, 3, np.int32), np.full(32, -1, np.int32)):
        with pytest.raises(Mp4jError):
            tr.train(bins, bad_y)
    trees, _ = tr.train(bins, y)
    narrow = bins[:, :2]
    with pytest.raises(Mp4jError):
        tr.train(narrow, y)
    with pytest.raises(Mp4jError):
        tr.predict(narrow, trees)
    with pytest.raises(Mp4jError):
        tr.train(bins, y, eval_set=(narrow, y))
    with pytest.raises(Mp4jError):
        tr.train(bins, y, sample_weight=np.full(32, -1.0))
    with pytest.raises(Mp4jError):
        tr.train(bins, y, sample_weight=np.zeros(32))
    with pytest.raises(Mp4jError, match="y must be"):
        GBDTTrainer(GBDTConfig(n_features=3, n_bins=4, depth=2),
                    device="cpu").train(bins, np.zeros(1, np.float32))
    with pytest.raises(Mp4jError):
        tr.predict(bins.tolist()[0], trees)              # not [N, F]
    with pytest.raises(Mp4jError):
        trees_from_numpy([(np.zeros(2), np.zeros(3), np.zeros(3),
                           np.zeros(4))], GBDTConfig(depth=2), "cpu")
