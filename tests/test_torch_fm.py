"""The port's FM/FFM trainer (ytk_mp4j_tpu_torch/models/fm.py, n members on
the CPU) against the JAX package's ``FMTrainer`` on a mesh of the same
shape, over the cases of tests/test_fm.py, on inputs made by numpy from a
seed.

Both start from the same table (``init_params`` draws from numpy's
``default_rng`` in both, bitwise). Losses, tables and predictions agree
with the reference to rtol 1e-5, atol 1e-6 on every path: the port takes
one autograd pass over every member's rows where the reference sums
per-member gradients with ``psum``, so sums round in another order; the
reference's own cross-path checks use rtol 1e-4 to 1e-5. Within the
port, on the CPU, a stream of one full-batch chunk per epoch equals
``fit`` BITWISE (tests/test_fm.py:194), and a (2, 4) mesh equals the
flat 8-member mesh bitwise (the trainer reads only the member count).
"""

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu.models.fm import FMConfig as JFMConfig
from ytk_mp4j_tpu.models.fm import FMTrainer as JFMTrainer
from ytk_mp4j_tpu.parallel import make_hier_mesh as jmake_hier_mesh
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models import fm as F
from ytk_mp4j_tpu_torch.models.fm import (FMConfig, FMTrainer,
                                          params_from_numpy)
from ytk_mp4j_tpu_torch.ops import collectives as coll

from test_fm import make_sparse_classification

from test_torch_sparse import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

RTOL, ATOL = 1e-5, 1e-6
MESHES = {
    "flat1": (lambda: jmake_mesh(1), lambda: make_mesh(1, "cpu")),
    "flat4": (lambda: jmake_mesh(4), lambda: make_mesh(4, "cpu")),
    "flat8": (lambda: jmake_mesh(8), lambda: make_mesh(8, "cpu")),
    "hier2x4": (lambda: jmake_hier_mesh(2, 4),
                lambda: make_hier_mesh(2, 4, "cpu")),
}
PATHS = {   # name: FMTrainer keywords
    "dense": {},
    "sparse": {"sparse_grads": True},
    "sparse_cap": {"sparse_grads": True, "sparse_capacity": 48},
    "sharded": {"sparse_grads": True, "table_sharding": "sharded"},
}


def _cfg(model="ffm", **kw):
    base = dict(n_features=64, n_fields=4, k=4, max_nnz=4, model=model,
                learning_rate=0.3, init_scale=0.1)
    base.update(kw)
    return base


def _port(cfg, mesh="flat4", path="dense"):
    return FMTrainer(FMConfig(**cfg), mesh=MESHES[mesh][1](),
                     **PATHS[path])


def _ref(cfg, mesh="flat4", path="dense"):
    return JFMTrainer(JFMConfig(**cfg), mesh=MESHES[mesh][0](),
                      **PATHS[path])


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _bitwise(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(x), _np(y))


@pytest.mark.parametrize("model", ["fm", "ffm"])
def test_fits_interaction(model, rng):
    feats, fields, vals, y = make_sparse_classification(rng)
    cfg = FMConfig(**_cfg(model, k=8 if model == "fm" else 4,
                          learning_rate=0.5))
    tr = FMTrainer(cfg, mesh=make_mesh(8, "cpu"))
    params, losses = tr.fit(feats, fields, vals, y, n_steps=300, seed=1)
    assert losses[-1] < losses[0] * 0.5
    p = tr.predict(params, feats, fields, vals)
    assert isinstance(p, torch.Tensor)
    assert float(torch.mean(((p > 0.5) == torch.from_numpy(y > 0.5))
                            .float())) > 0.9


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("model", ["fm", "ffm"])
def test_matches_reference(model, path, rng):
    """Every gradient path on 4 members, N = 101 (padding), l2 on:
    losses, the table and predictions equal the reference's."""
    feats, fields, vals, y = make_sparse_classification(rng, n=101)
    cfg = _cfg(model, l2=1e-3)
    jtr, ptr = _ref(cfg, path=path), _port(cfg, path=path)
    jp, jl = jtr.fit(feats, fields, vals, y, n_steps=5, seed=2)
    pp, pl = ptr.fit(feats, fields, vals, y, n_steps=5, seed=2)
    assert pl.dtype == np.float32 and pl.shape == (5,)
    _close(pl, jl)
    _close(ptr.full_table(pp), jtr.full_table(jp))
    _close(pp[0], jp[0])
    _close(pp[1], jp[1])
    _close(ptr.predict(pp, feats, fields, vals),
           jtr.predict(jp, feats, fields, vals))


@pytest.mark.parametrize("mesh,path", [("flat1", "dense"),
                                       ("flat8", "sparse"),
                                       ("flat8", "sharded"),
                                       ("hier2x4", "sharded")])
def test_meshes_match_reference(mesh, path, rng):
    feats, fields, vals, y = make_sparse_classification(rng, n=96)
    cfg = _cfg("ffm")
    jtr, ptr = _ref(cfg, mesh, path), _port(cfg, mesh, path)
    jp, jl = jtr.fit(feats, fields, vals, y, n_steps=3, seed=3)
    pp, pl = ptr.fit(feats, fields, vals, y, n_steps=3, seed=3)
    _close(pl, jl)
    _close(ptr.full_table(pp), jtr.full_table(jp))


def test_init_params_equal_the_reference_bitwise():
    for model, path in (("fm", "dense"), ("ffm", "sparse"),
                        ("ffm", "sharded")):
        cfg = _cfg(model, n_features=61)
        jp = _ref(cfg, "flat8", path).init_params(seed=4)
        ptr = _port(cfg, "flat8", path)
        pp = ptr.init_params(seed=4)
        _bitwise(pp[:2], jp[:2])
        np.testing.assert_array_equal(_np(pp[2]), _np(jp[2]))
        assert pp[2].shape[0] == ptr.n_rows_padded if path == "sharded" \
            else pp[2].shape[0] == ptr.n_rows


@pytest.mark.parametrize("model", ["fm", "ffm"])
def test_distributed_matches_single_device(model, rng):
    feats, fields, vals, y = make_sparse_classification(rng, n=101)
    cfg = _cfg(model, l2=1e-3)
    pd, ld = _port(cfg, "flat8").fit(feats, fields, vals, y, n_steps=20,
                                     seed=2)
    ps, ls = _port(cfg, "flat1").fit(feats, fields, vals, y, n_steps=20,
                                     seed=2)
    np.testing.assert_allclose(ld, ls, rtol=1e-4, atol=1e-6)
    for a, b in zip(pd, ps):
        _close(a, b, rtol=1e-4)


@pytest.mark.parametrize("model", ["fm", "ffm"])
@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_sparse_grads_match_dense(model, l2, rng):
    """The sparse (row, grad) path updates like the dense gradient (with
    l2: the decay-then-add form against V - lr (gV/denom + l2 V))."""
    feats, fields, vals, y = make_sparse_classification(rng, n=96)
    cfg = _cfg(model, l2=l2)
    pdense, _ = _port(cfg).fit(feats, fields, vals, y, n_steps=10, seed=3)
    for path in ("sparse", "sharded"):
        psparse, _ = _port(cfg, path=path).fit(feats, fields, vals, y,
                                               n_steps=10, seed=3)
        for a, b in zip(pdense[:2], psparse[:2]):
            _close(a, b, rtol=1e-4)
        _close(pdense[2], psparse[2][:pdense[2].shape[0]], rtol=1e-4)


def test_sparse_capacity_below_the_union_drops_like_the_reference(rng):
    """A sparse_capacity below a member's unique rows drops the rows past
    it, as the reference's segment sum does -- the same table."""
    feats, fields, vals, y = make_sparse_classification(rng, n=64)
    cfg = _cfg("ffm")
    kw = {"sparse_grads": True, "sparse_capacity": 8}
    jtr = JFMTrainer(JFMConfig(**cfg), mesh=jmake_mesh(4), **kw)
    ptr = FMTrainer(FMConfig(**cfg), mesh=make_mesh(4, "cpu"), **kw)
    jp, jl = jtr.fit(feats, fields, vals, y, n_steps=2, seed=1)
    pp, pl = ptr.fit(feats, fields, vals, y, n_steps=2, seed=1)
    _close(pl, jl)
    _close(ptr.full_table(pp), jtr.full_table(jp))
    full, _ = _port(cfg, path="sparse").fit(feats, fields, vals, y,
                                            n_steps=2, seed=1)
    assert not np.allclose(ptr.full_table(pp), _np(full[2]))


def test_sparse_refit_larger_dataset(rng):
    """A refit with a bigger batch recomputes the sparse capacity (a
    stale smaller one would drop gradient rows)."""
    cfg = _cfg("fm", n_features=512, n_fields=2, k=2, max_nnz=2,
               learning_rate=0.5)
    small = make_sparse_classification(rng, n=8, vocab=512, n_fields=2,
                                       nnz=2)
    big = make_sparse_classification(rng, n=256, vocab=512, n_fields=2,
                                     nnz=2)
    tr = _port(cfg, path="sparse")
    tr.fit(*small, n_steps=1, seed=0)
    p_refit, _ = tr.fit(*big, n_steps=5, seed=0)
    p_fresh, _ = _port(cfg, path="sparse").fit(*big, n_steps=5, seed=0)
    _bitwise(p_refit, p_fresh)


def test_fit_leaves_the_callers_params_alone(rng):
    """The sparse steps write the table in place; fit copies the params
    it is given first."""
    feats, fields, vals, y = make_sparse_classification(rng, n=32)
    for path in ("sparse", "sharded"):
        tr = _port(_cfg("ffm"), path=path)
        p0 = tr.init_params(seed=0)
        before = [p.clone() for p in p0]
        tr.fit(feats, fields, vals, y, n_steps=2, params=p0)
        _bitwise(p0, before)


def test_config_validation():
    with pytest.raises(Mp4jError):
        FMConfig(n_features=8, model="deepfm")
    with pytest.raises(Mp4jError):
        FMConfig(n_features=8, model="ffm", n_fields=1)
    with pytest.raises(Mp4jError):
        FMConfig(n_features=8, loss="hinge")
    tr = FMTrainer(FMConfig(n_features=8, max_nnz=2),
                   mesh=make_mesh(2, "cpu"))
    with pytest.raises(Mp4jError, match="max_nnz|K<="):
        tr.fit(np.zeros((4, 3), np.int32), np.zeros((4, 3), np.int32),
               np.ones((4, 3), np.float32), np.zeros(4, np.float32),
               n_steps=1)
    with pytest.raises(Mp4jError, match="feature id"):
        tr.fit(np.full((4, 2), 99, np.int32), np.zeros((4, 2), np.int32),
               np.ones((4, 2), np.float32), np.zeros(4, np.float32),
               n_steps=1)
    ffm = FMTrainer(FMConfig(n_features=8, n_fields=2, max_nnz=2,
                             model="ffm"), mesh=make_mesh(2, "cpu"))
    with pytest.raises(Mp4jError, match="field id"):
        ffm.fit(np.zeros((4, 2), np.int32), np.full((4, 2), 2, np.int32),
                np.ones((4, 2), np.float32), np.zeros(4, np.float32),
                n_steps=1)
    with pytest.raises(Mp4jError, match="field id"):   # tensors too
        ffm.predict(ffm.init_params(), torch.zeros((4, 2), dtype=torch.int32),
                    torch.full((4, 2), -1, dtype=torch.int32),
                    torch.ones((4, 2)))


def test_eval_set_and_early_stopping(rng):
    n, NF, nf, K = 512, 64, 3, 4
    feats = rng.integers(0, NF, (n, K)).astype(np.int32)
    fields = rng.integers(0, nf, (n, K)).astype(np.int32)
    vals = np.ones((n, K), np.float32)
    y = (feats.min(1) < 8).astype(np.float32)
    va = (feats[:128], fields[:128], vals[:128], y[:128])
    cfg = _cfg("ffm", n_fields=nf, k=3, learning_rate=0.5, init_scale=0.01)
    tr = _port(cfg)
    params, losses = tr.fit(feats, fields, vals, y, n_steps=30,
                            eval_set=va)
    assert len(tr.eval_history_) == 30
    assert tr.eval_history_[-1] < tr.eval_history_[0]
    # the held-out history equals the reference's
    jtr = _ref(cfg)
    jtr.fit(feats, fields, vals, y, n_steps=30, eval_set=va)
    np.testing.assert_allclose(tr.eval_history_, jtr.eval_history_,
                               rtol=1e-5)

    y_noise = (rng.random(n) > 0.5).astype(np.float32)
    va_noise = (feats[:128], fields[:128], vals[:128],
                (rng.random(128) > 0.5).astype(np.float32))
    for path in ("dense", "sharded"):
        tr2 = _port(cfg, path=path)
        params2, losses2 = tr2.fit(feats, fields, vals, y_noise,
                                   n_steps=40, eval_set=va_noise,
                                   early_stopping_rounds=3)
        assert len(losses2) < 40
        best = int(np.argmin(tr2.eval_history_))
        assert len(losses2) == best + 1
        # the returned params reproduce the best round's metric
        assert tr2._eval_loss(params2, tr2._prep_eval(*va_noise)) == (
            pytest.approx(min(tr2.eval_history_), rel=1e-6))
    with pytest.raises(Mp4jError, match="eval_set"):
        tr2.fit(feats, fields, vals, y, n_steps=3, early_stopping_rounds=2)


@pytest.mark.parametrize("path", ["dense", "sharded"])
def test_model_files_load_in_both_packages(path, rng, tmp_path):
    """save_params writes the reference's .npz (table [n_rows, k]):
    each package loads the other's file and predicts the same."""
    feats, fields, vals, y = make_sparse_classification(rng, n=80)
    cfg = _cfg("ffm")
    ptr, jtr = _port(cfg, path=path), _ref(cfg, path=path)
    pp, _ = ptr.fit(feats, fields, vals, y, n_steps=3, seed=0)
    jp, _ = jtr.fit(feats, fields, vals, y, n_steps=3, seed=0)
    port_file = str(tmp_path / "port.npz")
    ref_file = str(tmp_path / "ref.npz")
    ptr.save_params(port_file, pp)
    jtr.save_params(ref_file, jp)
    # the port's file in the reference
    jcfg, jparams = JFMTrainer.load_params(port_file, JFMConfig)
    assert jparams[2].shape == (ptr.n_rows, cfg["k"])
    _close(JFMTrainer(jcfg, mesh=jmake_mesh(2)).predict(
        jparams, feats, fields, vals), ptr.predict(pp, feats, fields, vals),
        rtol=1e-6, atol=1e-7)
    # the reference's file in the port, at another member count
    pcfg, pparams = FMTrainer.load_params(ref_file, FMConfig)
    assert pcfg == FMConfig(**cfg)
    other = FMTrainer(pcfg, mesh=make_mesh(8, "cpu"), **PATHS[path])
    _close(other.predict(pparams, feats, fields, vals),
           jtr.predict(jp, feats, fields, vals), rtol=1e-6, atol=1e-7)
    _, l2 = other.fit(feats, fields, vals, y, n_steps=2, params=pparams)
    assert np.isfinite(l2).all()


@pytest.mark.parametrize("sharding", ["replicated", "sharded"])
def test_params_from_numpy(sharding, rng):
    feats, fields, vals, y = make_sparse_classification(rng, n=60,
                                                       vocab=61)
    feats = np.clip(feats, 0, 60)
    cfg = _cfg("fm", n_features=61)
    kw = {"sparse_grads": True, "table_sharding": sharding}
    jtr = JFMTrainer(JFMConfig(**cfg), mesh=jmake_mesh(8), **kw)
    jp, _ = jtr.fit(feats, fields, vals, y, n_steps=2, seed=1)
    host = (np.asarray(jp[0]), np.asarray(jp[1]), jtr.full_table(jp))
    mesh = make_mesh(8, "cpu")
    pp = params_from_numpy(host, FMConfig(**cfg), sharding, mesh)
    ptr = FMTrainer(FMConfig(**cfg), mesh=mesh, **kw)
    assert pp[2].shape == (ptr.n_rows_padded if sharding == "sharded"
                           else ptr.n_rows, cfg["k"])
    assert all(p.device.type == "cpu" for p in pp)
    np.testing.assert_array_equal(ptr.full_table(pp), host[2])
    _close(ptr.predict(pp, feats, fields, vals),
           jtr.predict(jp, feats, fields, vals), rtol=1e-6, atol=1e-7)
    with pytest.raises(Mp4jError, match="table"):
        params_from_numpy((host[0], host[1], host[2][:5]), FMConfig(**cfg),
                          mesh=mesh)


# ------------------------------------------------------------- streaming
@pytest.mark.parametrize("path", ["dense", "sparse", "sharded"])
def test_fit_stream_single_chunk_equals_fit_bitwise(path, rng):
    """The full dataset as one chunk per epoch runs the same steps as
    fit(n_steps=E): on the CPU, bitwise -- losses and params."""
    feats, fields, vals, y = make_sparse_classification(rng, n=101)
    cfg = _cfg("ffm", init_scale=0.05)
    E = 4
    p_fit, l_fit = _port(cfg, path=path).fit(feats, fields, vals, y,
                                             n_steps=E, seed=3)
    p_st, l_st = _port(cfg, path=path).fit_stream(
        ((feats, fields, vals, y) for _ in range(E)), seed=3)
    np.testing.assert_array_equal(l_st, l_fit)
    _bitwise(p_st, p_fit)


def test_fit_stream_matches_reference_stream(rng):
    """Uneven chunks (a short final chunk padded to batch_rows) against
    the reference's stream, replicated and sharded."""
    feats, fields, vals, y = make_sparse_classification(rng, n=128)
    cfg = _cfg("ffm", learning_rate=0.5)

    def chunks():
        for _ in range(2):
            for s in (slice(0, 80), slice(80, None)):
                yield feats[s], fields[s], vals[s], y[s]

    for path in ("sparse", "sharded"):
        jp, jl = _ref(cfg, path=path).fit_stream(chunks(), seed=5,
                                                 batch_rows=80)
        ptr = _port(cfg, path=path)
        pp, pl = ptr.fit_stream(chunks(), seed=5, batch_rows=80)
        assert pl.shape == (4,)
        _close(pl, jl)
        _close(ptr.full_table(pp), _np(jp[2])[:ptr.n_rows])
        # the serialized loop runs the same steps
        _, l0 = _port(cfg, path=path).fit_stream(chunks(), seed=5,
                                                 batch_rows=80,
                                                 max_in_flight=0)
        np.testing.assert_array_equal(l0, pl)


def test_fit_stream_multi_chunk_learns(rng):
    feats, fields, vals, y = make_sparse_classification(rng, n=230)
    cfg = _cfg("ffm", k=8, learning_rate=0.5)
    tr = _port(cfg, path="sparse")
    C, E = 64, 12

    def chunks():
        for _ in range(E):
            for s in range(0, 230, C):          # last chunk = 38 rows
                yield (feats[s:s + C], fields[s:s + C], vals[s:s + C],
                       y[s:s + C])

    params, losses = tr.fit_stream(chunks(), batch_rows=C)
    assert losses.shape == (E * 4,)
    em = losses.reshape(E, 4).mean(axis=1)
    assert (np.diff(em) < 0).all(), em
    preds = tr.predict(params, feats, fields, vals).numpy()
    assert np.mean((preds > 0.5) == (y > 0.5)) > 0.65


def test_fit_stream_batch_rows_rounding_and_oversized_chunk(rng):
    feats, fields, vals, y = make_sparse_classification(rng, n=100)
    tr = _port(_cfg("ffm"), "flat8", "sparse")
    _, losses = tr.fit_stream(iter([(feats, fields, vals, y)]),
                              batch_rows=100)   # rounded up to 104
    assert losses.shape == (1,) and np.isfinite(losses).all()
    tr2 = _port(_cfg("ffm"))
    with pytest.raises(Mp4jError, match="exceeds batch_rows"):
        tr2.fit_stream(iter([(feats, fields, vals, y)]), batch_rows=32)
    assert tr2.fit_stream(iter([]))[1].shape == (0,)


# -------------------------------------------------------- sharded table
@pytest.mark.parametrize("model", ["fm", "ffm"])
def test_sharded_table_matches_replicated(model, rng):
    feats, fields, vals, y = make_sparse_classification(rng, n=150)
    cfg = _cfg(model, learning_rate=0.5, l2=1e-3)
    rep = _port(cfg, "flat8", "sparse")
    p_rep, l_rep = rep.fit(feats, fields, vals, y, n_steps=5, seed=7)
    sh = _port(cfg, "flat8", "sharded")
    p_sh, l_sh = sh.fit(feats, fields, vals, y, n_steps=5, seed=7)
    np.testing.assert_allclose(l_sh, l_rep, rtol=1e-5, atol=1e-6)
    _close(sh.full_table(p_sh), p_rep[2])
    _close(sh.predict(p_sh, feats, fields, vals),
           rep.predict(p_rep, feats, fields, vals))


def test_sharded_table_uneven_rows(rng):
    """n_rows not divisible by the member count: the table pads, the
    padding rows stay zero, and results match replicated."""
    feats, fields, vals, y = make_sparse_classification(rng, n=90,
                                                       vocab=61)
    feats = np.clip(feats, 0, 60)
    cfg = _cfg("fm", n_features=61)
    rep = _port(cfg, "flat8", "sparse")
    p_rep, l_rep = rep.fit(feats, fields, vals, y, n_steps=3, seed=1)
    sh = _port(cfg, "flat8", "sharded")
    assert sh.n_rows_padded == 64 and sh.n_rows == 61
    p_sh, l_sh = sh.fit(feats, fields, vals, y, n_steps=3, seed=1)
    np.testing.assert_allclose(l_sh, l_rep, rtol=1e-5, atol=1e-6)
    _close(sh.full_table(p_sh), p_rep[2])
    assert not p_sh[2][61:].any()


def test_sharded_requires_sparse():
    cfg = FMConfig(n_features=8, n_fields=2, k=2, max_nnz=2, model="ffm")
    mesh = make_mesh(2, "cpu")
    with pytest.raises(Mp4jError, match="sparse_grads"):
        FMTrainer(cfg, mesh=mesh, table_sharding="sharded")
    with pytest.raises(Mp4jError, match="table_sharding"):
        FMTrainer(cfg, mesh=mesh, sparse_grads=True, table_sharding="bogus")
    with pytest.raises(Mp4jError, match="sparse_capacity"):
        FMTrainer(cfg, mesh=mesh, sparse_grads=True, sparse_capacity=128,
                  table_sharding="sharded")
    with pytest.raises(Mp4jError, match="sparse_capacity"):
        FMTrainer(cfg, mesh=mesh, sparse_capacity=128)


def test_hier_mesh_equals_flat_bitwise(rng):
    """The trainer reads only a mesh's member count: a (2, 4) mesh runs
    the flat 8-member steps."""
    feats, fields, vals, y = make_sparse_classification(rng, n=96)
    cfg = _cfg("ffm")
    p_f, l_f = _port(cfg, "flat8", "sharded").fit(feats, fields, vals, y,
                                                  n_steps=3, seed=3)
    p_h, l_h = _port(cfg, "hier2x4", "sharded").fit(feats, fields, vals, y,
                                                    n_steps=3, seed=3)
    np.testing.assert_array_equal(l_h, l_f)
    _bitwise(p_h, p_f)


def test_sample_weight_equals_duplication(rng):
    """Integer instance weights == row duplication, in fit and in
    weighted stream chunks, dense and sparse."""
    feats, fields, vals, y = make_sparse_classification(rng, n=40)
    k = rng.integers(1, 4, 40)
    dup = lambda a: np.repeat(a, k, axis=0)  # noqa: E731
    cfg = _cfg("ffm")
    for path in ("dense", "sparse"):
        _, l_w = _port(cfg, path=path).fit(feats, fields, vals, y,
                                           n_steps=3, seed=2,
                                           sample_weight=k.astype(np.float32))
        _, l_d = _port(cfg, path=path).fit(dup(feats), dup(fields),
                                           dup(vals), dup(y), n_steps=3,
                                           seed=2)
        np.testing.assert_allclose(l_w, l_d, rtol=1e-4, atol=1e-6)
    _, l_s = _port(cfg, path="sparse").fit_stream(
        ((feats, fields, vals, y, k.astype(np.float32)) for _ in range(3)),
        seed=2)
    np.testing.assert_array_equal(l_s, l_w)


def test_trainer_weight_validation(rng):
    feats, fields, vals, y = make_sparse_classification(rng, n=16)
    tr = _port(_cfg("ffm", k=2))
    for bad in (np.full(16, np.nan), -np.ones(16), np.zeros(16),
                np.ones(7)):
        with pytest.raises(Mp4jError, match="sample_weight"):
            tr.fit(feats, fields, vals, y, n_steps=1, sample_weight=bad)


def test_tensor_inputs_train_like_numpy(rng):
    """Tensors (as the card's callers hand them) stage without a host
    round trip and train exactly like numpy input."""
    data = make_sparse_classification(rng, n=64)
    cfg = _cfg("ffm")
    _, l_np = _port(cfg, path="sharded").fit(*data, n_steps=3)
    _, l_t = _port(cfg, path="sharded").fit(
        *(torch.from_numpy(a) for a in data), n_steps=3)
    np.testing.assert_array_equal(l_t, l_np)


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_empty_input_trains_like_the_reference(path):
    """N = 0: the reference's replicated paths train to loss 0, and so
    does the port (every path)."""
    z = (np.zeros((0, 4), np.int32), np.zeros((0, 4), np.int32),
         np.zeros((0, 4), np.float32), np.zeros(0, np.float32))
    cfg = _cfg("ffm")
    _, jl = _ref(cfg, path=path).fit(*z, n_steps=2)
    _, pl = _port(cfg, path=path).fit(*z, n_steps=2)
    np.testing.assert_array_equal(pl, jl)


def test_empty_input_sharded_reference_defect():
    """N = 0 with the sharded table: the reference raises a ValueError
    from a broadcast in its sharded step (a defect of the reference, not
    a fault of the port); the port trains, loss 0, table unchanged."""
    z = (np.zeros((0, 4), np.int32), np.zeros((0, 4), np.int32),
         np.zeros((0, 4), np.float32), np.zeros(0, np.float32))
    cfg = _cfg("ffm")
    with pytest.raises(ValueError, match="Incompatible shapes"):
        _ref(cfg, path="sharded").fit(*z, n_steps=2)
    tr = _port(cfg, path="sharded")
    p, pl = tr.fit(*z, n_steps=2, seed=0)
    np.testing.assert_array_equal(pl, [0.0, 0.0])
    _bitwise(p, tr.init_params(seed=0))


def test_all_to_all_and_owner_routed_fetch(rng):
    """all_to_all is the transpose of the member axes; the owner-routed
    fetch from a block-sharded table returns exactly V[rows]."""
    x = torch.arange(4 * 4 * 3).reshape(4, 4, 3)
    y = coll.all_to_all(x)
    for m in range(4):
        for j in range(4):
            assert torch.equal(y[j, m], x[m, j])
    with pytest.raises(Mp4jError, match="all_to_all"):
        coll.all_to_all(torch.zeros(4, 3))
    assert coll.flat_index(3, "cpu").tolist() == [0, 1, 2]
    V = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    gi = torch.from_numpy(rng.integers(0, 40, (4, 25)).astype(np.int32))
    E, owner, _ = F._fetch_rows_sharded(V.view(4, 10, 3), gi)
    assert torch.equal(E, V[gi.long()])
    assert torch.equal(owner, gi // 10)


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """With no CUDA and no device named, the trainers, the cluster and
    params_from_numpy raise; they never move to the CPU on their own."""
    from ytk_mp4j_tpu_torch import GpuCommCluster, LinearConfig, LinearTrainer
    from ytk_mp4j_tpu_torch.models.linear import (
        params_from_numpy as linear_params)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FMConfig(**_cfg("ffm"))
    for make in (lambda: FMTrainer(cfg),
                 lambda: FMTrainer(cfg, n_devices=4, sparse_grads=True),
                 lambda: LinearTrainer(LinearConfig(n_features=3)),
                 lambda: GpuCommCluster(4),
                 lambda: params_from_numpy((0.0, np.zeros(64),
                                            np.zeros((256, 4))), cfg),
                 lambda: linear_params((np.zeros(3), 0.0),
                                       LinearConfig(n_features=3))):
        with pytest.raises(Mp4jError, match="no CUDA device"):
            make()
