"""The port's data-parallel GBDT (``GBDTTrainer`` over ``make_mesh`` /
``make_hier_mesh``, n members on one device) against the JAX package's
``GBDTTrainer`` on a mesh of the same shape, on the CPU, with inputs made
from a numpy seed.

N = 1001 does not split evenly, so every mesh pads with zero-weight
rows; both packages return the margins of the padded rows. Trees are held
bitwise (feat/bin/dir) on data whose splits clear every runner-up
(``_assert_clear_splits``); leaves and margins to rtol = 1e-4, atol =
1e-5, the tolerance of the reference's own distributed-vs-single test
(``tests/test_gbdt.py:357-413``): the reference sums histograms through
bf16 hi/lo products and ``psum``, the port in f64 per member and folds
the members in rank order."""

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu.models import gbdt as J
from ytk_mp4j_tpu.parallel import make_hier_mesh as jmake_hier_mesh
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models import gbdt as T
from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

from test_torch_gbdt import (ATOL, RTOL, _assert_clear_splits,
                             _assert_same_trees, _cfg_kwargs, _data)

N = 1001                      # uneven over 4 and 8 members: padding
SEED = 1                      # data whose splits all clear (see above)
MESHES = {
    "flat4": (lambda: jmake_mesh(4), lambda: make_mesh(4, "cpu")),
    "hier2x4": (lambda: jmake_hier_mesh(2, 4),
                lambda: make_hier_mesh(2, 4, "cpu")),
    "flat8": (lambda: jmake_mesh(8), lambda: make_mesh(8, "cpu")),
}


def _both(mesh, kw, bins, y, **train_kw):
    """(reference trainer, trees, margins), (port trainer, trees, margins
    as numpy) on the mesh ``mesh`` names."""
    jmesh, pmesh = MESHES[mesh]
    jtr = J.GBDTTrainer(J.GBDTConfig(**kw), mesh=jmesh())
    jt, jm = jtr.train(bins, y, **train_kw)
    ptr = GBDTTrainer(GBDTConfig(**kw), mesh=pmesh())
    pt, pm = ptr.train(bins, y, **train_kw)
    assert isinstance(pm, torch.Tensor)
    return (jtr, jt, np.asarray(jm)), (ptr, pt, pm.numpy())


@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_trainer_matches_reference(mesh, loss):
    bins, y = _data(loss, seed=SEED, N=N)
    kw = _cfg_kwargs(loss)
    (_, jt, jm), (ptr, pt, pm) = _both(mesh, kw, bins, y)
    _assert_clear_splits(ptr, bins, y, pt)
    _assert_same_trees(jt, pt, loss)
    n = ptr.n_shards
    assert pm.shape == jm.shape and pm.shape[0] == -(-N // n) * n
    np.testing.assert_allclose(pm, jm, rtol=RTOL, atol=ATOL)


def test_sample_weight_composes_with_padding():
    bins, y = _data("squared", seed=SEED, N=N)
    w = np.random.default_rng(1).uniform(0.2, 2.0, N).astype(np.float32)
    kw = _cfg_kwargs("squared", n_trees=3)
    (_, jt, jm), (ptr, pt, pm) = _both("flat4", kw, bins, y,
                                       sample_weight=w)
    _assert_same_trees(jt, pt, "squared")
    np.testing.assert_allclose(pm, jm, rtol=RTOL, atol=ATOL)
    # the padding rows weigh nothing: one member, no padding, same trees
    one = GBDTTrainer(GBDTConfig(**kw), device="cpu")
    ot, om = one.train(bins, y, sample_weight=w)
    _assert_same_trees(ot, pt, "squared")
    np.testing.assert_allclose(pm[:N], om.numpy(), rtol=1e-6, atol=1e-6)


def test_shard_data_pads_on_the_device_like_the_reference():
    bins, y = _data("squared", seed=SEED, N=N)
    w = np.random.default_rng(2).uniform(0.5, 1.5, N).astype(np.float32)
    kw = _cfg_kwargs("squared")
    tr = GBDTTrainer(GBDTConfig(**kw), mesh=make_mesh(4, "cpu"))
    dbins, dy, dpreds, dw = tr.shard_data(torch.from_numpy(bins),
                                          torch.from_numpy(y), w)
    want = J.GBDTTrainer(J.GBDTConfig(**kw), mesh=jmake_mesh(4)).shard_data(
        bins, y, sample_weight=w)
    for got, ref in zip((dbins, dy, dpreds, dw), want):
        ref = np.asarray(ref)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      ref.reshape((-1,) + ref.shape[2:]))
    assert dw.shape == (1004,) and not dw[N:].any()


def test_eval_set_and_early_stopping_over_a_mesh():
    bins, y = _data("logistic", seed=SEED, N=N)
    va_bins, va_y = _data("logistic", seed=9, N=512)
    kw = _cfg_kwargs("logistic", n_trees=6)
    (jtr, _, _), (ptr, _, _) = _both("hier2x4", kw, bins, y,
                                     eval_set=(va_bins, va_y))
    assert len(ptr.eval_history_) == 6
    np.testing.assert_allclose(ptr.eval_history_, jtr.eval_history_,
                               rtol=1e-4)
    # noise labels: both stop early at the same round
    rng = np.random.default_rng(4)
    stop = dict(eval_set=(va_bins, va_y[rng.permutation(512)]),
                early_stopping_rounds=2)
    noise = y[rng.permutation(N)]
    (jtr2, jt2, _), (ptr2, pt2, pm2) = _both("hier2x4", kw, bins, noise,
                                             **stop)
    assert len(pt2) == len(jt2) < 6
    assert len(pt2) == int(np.argmin(ptr2.eval_history_)) + 1
    np.testing.assert_array_equal(ptr2.predict(bins, pt2).numpy(), pm2[:N])


def test_feature_importance_and_predict_over_a_mesh():
    bins, y = _data("softmax", seed=SEED, N=N)
    kw = _cfg_kwargs("softmax")
    (jtr, jt, _), (ptr, pt, pm) = _both("flat8", kw, bins, y)
    np.testing.assert_array_equal(ptr.feature_importance(pt),
                                  jtr.feature_importance(jt))
    np.testing.assert_array_equal(ptr.predict(bins, pt).numpy(), pm[:N])
    np.testing.assert_allclose(ptr.predict(bins, pt, proba=True).numpy(),
                               jtr.predict(bins, jt, proba=True),
                               rtol=1e-4, atol=1e-5)
    served = T.trees_from_numpy([tuple(tuple(np.asarray(a) for a in c)
                                       for c in r) for r in jt],
                                ptr.cfg, device="cpu")
    np.testing.assert_allclose(ptr.predict(bins, served).numpy(),
                               jtr.predict(bins, jt), rtol=1e-6, atol=1e-6)


def test_member_sentinel_never_lands_in_another_member(monkeypatch):
    """Sibling subtraction sends right-child rows to the id n * n_half,
    outside every member's ids: at every level the members' folded
    histograms (and the leaf sums) equal one member's over all rows. The
    one-member sentinel n_half is member 1's first left child, so member
    0's right-child rows would be counted there."""
    bins, y = _data("squared", N=1000)
    cfg = GBDTConfig(**_cfg_kwargs("squared", depth=4))
    real = T._fold
    folded = {}
    for n in (1, 2, 4):
        calls = folded[n] = []
        monkeypatch.setattr(
            T, "_fold", lambda x, m, calls=calls: calls.append(real(x, m))
            or calls[-1])
        GBDTTrainer(cfg, mesh=make_mesh(n, "cpu")).train(bins, y,
                                                         n_trees=2)
    assert len(folded[1]) == 2 * (2 * cfg.depth + 2)
    for n in (2, 4):
        assert len(folded[n]) == len(folded[1])
        for one, many in zip(folded[1], folded[n]):
            torch.testing.assert_close(many, one, rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------------------
# the sampling contract
# ----------------------------------------------------------------------
def test_member_streams():
    """The feature mask comes from member 0's stream alone (the same on
    every member); each member's rows are kept by its own stream, and
    member 0's stream is the one-member stream of the same seed."""
    cfg = GBDTConfig(n_features=10, subsample=0.5, colsample=0.5)
    per, n = 100, 4
    scale, fmask = T._sampling_masks(T.member_generators(7, n, "cpu"), cfg,
                                     n * per, "cpu")
    lone = torch.Generator().manual_seed(7)
    one_scale, one_fmask = T._sampling_masks([lone], cfg, per, "cpu")
    assert torch.equal(fmask, one_fmask)
    assert torch.equal(scale[:per], one_scale)
    blocks = scale.reshape(n, per)
    for m, gen in enumerate(T.member_generators(7, n, "cpu")[1:], 1):
        want = (torch.rand(per, generator=gen) < 0.5).float() / 0.5
        assert torch.equal(blocks[m], want)
        assert not torch.equal(blocks[m], blocks[0])
    seeds = [g.initial_seed() for g in T.member_generators(7, n, "cpu")]
    assert seeds[0] == 7 and len(set(seeds)) == n


def test_one_member_draws_the_single_device_stream():
    """One member with a seed grows the trees of the single-device loop:
    one generator from the seed, one train_tree_shard a round."""
    bins, y = _data("squared")
    kw = _cfg_kwargs("squared", n_trees=4, subsample=0.7, colsample=0.6)
    trees, margins = GBDTTrainer(GBDTConfig(**kw), device="cpu").train(
        bins, y, seed=3)
    gen = torch.Generator().manual_seed(3)
    preds = torch.zeros(len(y))
    for tree in trees:
        preds, want = T.train_tree_shard(
            torch.from_numpy(bins), torch.from_numpy(y), preds,
            GBDTConfig(**kw), weights=torch.ones(len(y)), generators=[gen])
        for k in range(4):
            assert torch.equal(tree[k], want[k])
    assert torch.equal(margins, preds)


def test_sampled_trees_are_seeded_and_follow_rank_order():
    """Same seed -> same trees; another seed -> other trees; a (2, 2)
    mesh equals the flat 4-member mesh bitwise, because member (i, j) is
    rank 2i + j for its rows, its stream and its fold."""
    bins, y = _data("squared", seed=SEED, N=N)
    kw = _cfg_kwargs("squared", n_trees=4, subsample=0.7, colsample=0.7)

    def run(mesh, seed):
        return GBDTTrainer(GBDTConfig(**kw), mesh=mesh).train(bins, y,
                                                              seed=seed)

    t0, m0 = run(make_mesh(4, "cpu"), 0)
    t0b, m0b = run(make_mesh(4, "cpu"), 0)
    th, mh = run(make_hier_mesh(2, 2, "cpu"), 0)
    _, m1 = run(make_mesh(4, "cpu"), 1)
    assert torch.equal(m0, m0b) and torch.equal(m0, mh)
    for a, b in zip(t0, th):
        assert all(torch.equal(a[k], b[k]) for k in range(4))
    assert not torch.equal(m0, m1)
    assert float(((m0[:N] - torch.from_numpy(y)) ** 2).mean()) < float(
        np.var(y))


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
def test_make_hier_mesh_rank_order():
    m = make_hier_mesh(2, 4, "cpu")
    assert (m.n, m.shape, m.device) == (8, (2, 4), torch.device("cpu"))
    assert make_mesh(3, "cpu").shape == (3,)
    # the reference's (inter, intra) mesh lays its devices out row-major,
    # inter outermost: the port's flat rank i * intra + j
    ids = np.vectorize(lambda d: d.id)(jmake_hier_mesh(2, 4).devices)
    np.testing.assert_array_equal(ids, np.arange(8).reshape(2, 4))
    for bad in ((0, 2), (2, 0), (2.0, 2), (True, 2)):
        with pytest.raises(Mp4jError):
            make_hier_mesh(*bad, device="cpu")


def test_mesh_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GBDTConfig(n_features=2, n_bins=4, depth=1)
    for build in (lambda: make_mesh(4), lambda: make_hier_mesh(2, 2),
                  lambda: make_mesh(4, "cuda"),
                  lambda: GBDTTrainer(cfg, n_devices=4)):
        with pytest.raises(Mp4jError, match="no CUDA device"):
            build()
    with pytest.raises(Mp4jError, match="not both"):
        GBDTTrainer(cfg, mesh=make_mesh(2, "cpu"), device="cpu")
    tr = GBDTTrainer(cfg, n_devices=3, device="cpu")
    assert tr.n_shards == 3 and tr.device == torch.device("cpu")
