"""Models the two packages load from each other, and the raw-feature
consumer flow (``train_raw`` -> ``predict_raw``), on the CPU.

A model file is the reference's ``.npz`` (``repr(asdict(cfg))`` plus the
trees' arrays and the binner's edges); both ``GBDTConfig``s have the
same fields, so either package loads what the other saved. Loaded trees
and edges are held bitwise; predictions of the same trees to 1e-6 (the
two packages add the trees' f32 outputs in the same order, through jnp
and torch). ``train_raw`` is held against the reference's on a mesh of
the same shape: edges bitwise (the same host code on the same row
sample), trees bitwise, margins to the mesh tests' rtol = 1e-4, atol =
1e-5."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu.models import gbdt as J
from ytk_mp4j_tpu.models.binning import QuantileBinner as JBinner
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

from test_torch_gbdt import (ATOL, RTOL, _assert_clear_splits,
                             _assert_same_trees, _cfg_kwargs, _data)

LOSSES = ["squared", "logistic", "softmax"]


def _port(kw, n=2):
    return GBDTTrainer(GBDTConfig(**kw), mesh=make_mesh(n, "cpu"))


def _ref(kw, n=2):
    return J.GBDTTrainer(J.GBDTConfig(**kw), mesh=jmake_mesh(n))


@pytest.mark.parametrize("loss", LOSSES)
def test_port_saved_model_served_by_reference(tmp_path, loss):
    bins, y = _data(loss)
    kw = _cfg_kwargs(loss, missing_bin=True, categorical_features=(2,))
    tr = _port(kw)
    trees, _ = tr.train(bins, y)
    path = str(tmp_path / "port.model")            # no .npz suffix
    tr.save_model(path, trees)
    cfg, jtrees, binner = J.GBDTTrainer.load_model(path)
    assert asdict(cfg) == asdict(tr.cfg) and binner is None
    _assert_same_trees(jtrees, trees, loss)
    va, _ = _data(loss, seed=3, N=600)
    serve = J.GBDTTrainer(cfg, mesh=jmake_mesh(1))
    np.testing.assert_allclose(serve.predict(va, jtrees),
                               tr.predict(va, trees).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loss", LOSSES)
def test_reference_saved_model_served_by_port(tmp_path, loss):
    bins, y = _data(loss)
    kw = _cfg_kwargs(loss)
    jtr = _ref(kw)
    jtrees, _ = jtr.train(bins, y)
    X = np.random.default_rng(1).standard_normal((300, 6)).astype(np.float32)
    jbinner = JBinner(16).fit(X, sample=None)
    path = str(tmp_path / "ref.npz")
    jtr.save_model(path, jtrees, binner=jbinner)
    cfg, trees, binner = GBDTTrainer.load_model(path, device="cpu")
    assert asdict(cfg) == asdict(jtr.cfg)
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for rnd in trees
               for t in (rnd if loss == "softmax" else (rnd,)) for a in t)
    _assert_same_trees(jtrees, trees, loss)
    for got, want in zip(trees, jtrees):
        for g, w in zip(got if loss == "softmax" else (got,),
                        want if loss == "softmax" else (want,)):
            np.testing.assert_array_equal(g[3].numpy(), np.asarray(w[3]))
    assert isinstance(binner, QuantileBinner) and binner.n_bins == 16
    np.testing.assert_array_equal(binner.edges, jbinner.edges)
    va, _ = _data(loss, seed=3, N=600)
    port = GBDTTrainer(cfg, device="cpu")
    np.testing.assert_allclose(port.predict(va, trees).numpy(),
                               jtr.predict(va, jtrees), rtol=1e-6, atol=1e-6)


def test_load_model_without_dir_arrays(tmp_path, rng):
    """Models saved before default-direction support (feat/bin/leaf
    triples) load with all-left directions."""
    cfg = GBDTConfig(n_features=3, n_bins=8, depth=2, n_trees=1)
    tr = GBDTTrainer(cfg, device="cpu")
    bins = rng.integers(0, 8, (64, 3)).astype(np.int32)
    y = (bins[:, 0] / 8).astype(np.float32)
    trees, margins = tr.train(bins, y)
    path = str(tmp_path / "old.npz")
    tr.save_model(path, trees)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("dir_")}
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    cfg2, trees2, binner = GBDTTrainer.load_model(path, device="cpu")
    assert cfg2 == cfg and binner is None
    assert all(not t[2].any() for t in trees2)
    np.testing.assert_array_equal(tr.predict(bins, trees2).numpy(),
                                  margins.numpy())
    _, jtrees, _ = J.GBDTTrainer.load_model(path)
    _assert_same_trees(jtrees, trees2, "squared")


def test_load_model_defaults_to_the_card(tmp_path, monkeypatch):
    cfg = GBDTConfig(n_features=3, n_bins=8, depth=1)
    path = str(tmp_path / "m.npz")
    GBDTTrainer(cfg, device="cpu").save_model(path, [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        GBDTTrainer.load_model(path)


def test_coarser_binner_round_trip_exact_path(tmp_path, rng):
    """save_model honours the exact path and load_model rebuilds the
    binner's own granularity (8 bins feeding a 32-bin histogram)."""
    X = rng.standard_normal((200, 3)).astype(np.float32)
    binner = QuantileBinner(8).fit(X, sample=None)
    tr = GBDTTrainer(GBDTConfig(n_features=3, n_bins=32, depth=2,
                                n_trees=2), device="cpu")
    trees, _ = tr.train(binner.transform(X, device="cpu"), X[:, 0])
    path = str(tmp_path / "model.bin")
    tr.save_model(path, trees, binner=binner)
    for loaded in (GBDTTrainer.load_model(path, device="cpu")[2],
                   J.GBDTTrainer.load_model(path)[2]):
        assert loaded.n_bins == 8
        np.testing.assert_array_equal(loaded.edges, binner.edges)


def test_predict_proba_extreme_margins_no_overflow(rng):
    cfg = GBDTConfig(n_features=2, n_bins=4, depth=1, n_trees=1,
                     learning_rate=1000.0, loss="logistic")
    tr = GBDTTrainer(cfg, device="cpu")
    trees = [(torch.zeros(1, dtype=torch.int32),) * 3
             + (torch.tensor([-500.0, 500.0]),)]
    p = tr.predict(rng.integers(0, 4, (64, 2)).astype(np.int32), trees,
                   proba=True)
    assert torch.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()


# ----------------------------------------------------------------------
# raw features: train_raw -> predict_raw
# ----------------------------------------------------------------------
def _raw_data(N=1001, F=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F)).astype(np.float32)
    X[rng.random(N) < 0.2, 1] = np.nan
    y = (np.sin(2 * X[:, 0]) + np.where(np.isnan(X[:, 1]), 1.0, 0.0)
         + 0.1 * rng.standard_normal(N)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N)
    return X, y, w


@pytest.mark.parametrize("missing_bin", [False, True])
def test_train_raw_matches_reference(missing_bin):
    X, y, w = _raw_data()
    kw = dict(n_features=4, n_bins=16, depth=3, n_trees=3,
              learning_rate=0.3, missing_bin=missing_bin)
    args = dict(sample_weight=w, bin_sample=500, seed=2)
    jtr = _ref(kw, 4)
    jt, jm = jtr.train_raw(X, y, **args)
    tr = _port(kw, 4)
    pt, pm = tr.train_raw(torch.from_numpy(X), y, **args)
    np.testing.assert_array_equal(tr.binner_.edges, jtr.binner_.edges)
    bins = tr.binner_.transform(X, device="cpu").numpy()
    np.testing.assert_array_equal(bins, jtr.binner_.transform(X))
    _assert_clear_splits(tr, bins, y, pt)
    _assert_same_trees(jt, pt, "squared")
    np.testing.assert_allclose(pm.numpy(), jm, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tr.predict_raw(X, pt).numpy(),
                                  pm[:len(y)].numpy())
    np.testing.assert_allclose(tr.predict_raw(X, pt).numpy(),
                               jtr.predict_raw(X, jt), rtol=RTOL, atol=ATOL)


def test_train_raw_eval_set_and_prefitted_binner():
    X, y, _ = _raw_data()
    Xv, yv, _ = _raw_data(N=300, seed=5)
    kw = dict(n_features=4, n_bins=16, depth=3, n_trees=4, learning_rate=0.3)
    binner = QuantileBinner(16).fit(X, sample=None)
    edges = binner.edges.copy()
    tr = _port(kw, 4)
    tr.train_raw(X, y, eval_set=(Xv, yv), binner=binner)
    assert tr.binner_ is binner
    np.testing.assert_array_equal(binner.edges, edges)   # used as it is
    jtr = _ref(kw, 4)
    jb = JBinner(16)
    jb.edges = edges
    jtr.train_raw(X, y, eval_set=(Xv, yv), binner=jb)
    np.testing.assert_allclose(tr.eval_history_, jtr.eval_history_,
                               rtol=1e-4)


def test_train_raw_errors():
    X, y, _ = _raw_data(N=64)
    tr = _port(dict(n_features=4, n_bins=16, depth=2, n_trees=1))
    with pytest.raises(Mp4jError, match="exceeds"):
        tr.train_raw(X, y, binner=QuantileBinner(32))
    with pytest.raises(Mp4jError, match="missing_bucket"):
        tr.train_raw(X, y, binner=QuantileBinner(16, missing_bucket=True))
    with pytest.raises(Mp4jError, match="no fitted binner"):
        tr.predict_raw(X, [])
    trees, _ = tr.train_raw(X, y, binner=QuantileBinner(8))  # coarser: ok
    assert tr.predict_raw(X, trees).shape == (64,)


def test_raw_models_cross_both_ways(tmp_path):
    """A train_raw model saved by either package serves raw features in
    the other through the persisted binner."""
    X, y, _ = _raw_data()
    kw = dict(n_features=4, n_bins=16, depth=3, n_trees=3,
              learning_rate=0.3, missing_bin=True)
    tr = _port(kw)
    trees, _ = tr.train_raw(X, y)
    tr.save_model(str(tmp_path / "port.npz"), trees)
    cfg, jtrees, jbinner = J.GBDTTrainer.load_model(
        str(tmp_path / "port.npz"))
    serve = J.GBDTTrainer(cfg, mesh=jmake_mesh(1))
    serve.binner_ = jbinner
    np.testing.assert_allclose(serve.predict_raw(X, jtrees),
                               tr.predict_raw(X, trees).numpy(),
                               rtol=1e-6, atol=1e-6)

    jtr = _ref(kw)
    jt, _ = jtr.train_raw(X, y)
    jtr.save_model(str(tmp_path / "ref.npz"), jt)
    cfg2, trees2, binner2 = GBDTTrainer.load_model(
        str(tmp_path / "ref.npz"), device="cpu")
    port = GBDTTrainer(cfg2, device="cpu")
    port.binner_ = binner2
    assert binner2.missing_bucket and binner2.n_bins == 16
    np.testing.assert_allclose(port.predict_raw(X, trees2).numpy(),
                               jtr.predict_raw(X, jt), rtol=1e-6, atol=1e-6)
