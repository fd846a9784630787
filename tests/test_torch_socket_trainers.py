"""The port's trainers with ``comm=`` over the port's socket plane.

Two ranks in threads, each a ``ProcessCommSlave`` of the port under the
port's ``Master``, mirror ``tests/test_trainer_overlap.py:34-135``:

- ``MP4J_OVERLAP=1`` equals ``0`` bit for bit for linear, FM and GBDT
  (parameters or margins, the local losses and the job-wide history),
  over TCP and over shared memory, with the progression thread and with
  the eager caller-thread scheduler;
- the port's histories equal the reference trainer's over the
  reference's slaves: the synced losses to rtol 1e-5 (the FM / linear
  tolerance of the port's other parity tests), GBDT's trees split for
  split with leaves and margins to rtol 1e-4, and its round history
  exactly;
- ``train_raw``'s ``fit_distributed`` over ``ProcessCommSlave`` gives
  edges bitwise the reference's over the reference's slaves.
"""

import numpy as np
import pytest
import torch

from test_torch_gbdt import ATOL, RTOL, _assert_same_trees
from test_torch_sparse import few_threads  # noqa: F401
from torch_socket_jobs import canon, run_pkg

pytestmark = pytest.mark.usefixtures("few_threads")

JOIN = 120.0


def _host(params):
    return [np.asarray(p.detach().cpu().numpy() if isinstance(
        p, torch.Tensor) else p).copy() for p in params]


def _np_trees(trees):
    """Trees as nested tuples of host arrays (either package's)."""
    return [tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                  for a in tree) for tree in trees]


def _leaves(tree):
    import jax

    return [np.asarray(x).copy() for x in jax.tree_util.tree_leaves(tree)]


def _linear_data(r):
    rng = np.random.default_rng(7 + r)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5, 0.0], np.float32)
         + 0.1 * rng.standard_normal(64)).astype(np.float32)
    return x, y


def _fm_data(r):
    rng = np.random.default_rng(11 + r)
    n, nnz = 48, 3
    feats = rng.integers(0, 32, (n, nnz)).astype(np.int32)
    fields = np.broadcast_to(np.arange(nnz, dtype=np.int32) % 2,
                             (n, nnz)).copy()
    vals = np.ones((n, nnz), np.float32)
    y = ((feats[:, 0] + feats[:, 1]) % 2).astype(np.float32)
    return feats, fields, vals, y


def _gbdt_data(r):
    rng = np.random.default_rng(13 + r)
    bins = rng.integers(0, 8, (96, 3)).astype(np.int32)
    y = (bins[:, 1] > 4).astype(np.float32)
    return bins, y


FM_CFG = dict(n_features=32, n_fields=2, k=2, max_nnz=3, model="fm",
              learning_rate=0.3, init_scale=0.1)
GBDT_CFG = dict(n_features=3, n_bins=8, depth=2, n_trees=3,
                learning_rate=0.5, loss="logistic")


# -- the port's families ------------------------------------------------
def _p_linear(slave, r, pkg):
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models.linear import LinearConfig, LinearTrainer

    cfg = LinearConfig(n_features=4, loss="squared", learning_rate=0.1)
    tr = LinearTrainer(cfg, mesh=make_mesh(1, "cpu"))
    params, losses = tr.fit(*_linear_data(r), n_steps=4, comm=slave)
    return _host(params) + [np.asarray(losses),
                            tr.sync_loss_history_.copy()]


def _p_fm(slave, r, pkg):
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer

    tr = FMTrainer(FMConfig(**FM_CFG), mesh=make_mesh(1, "cpu"))
    params, losses = tr.fit(*_fm_data(r), n_steps=4, seed=3, comm=slave)
    return _host(params) + [np.asarray(losses),
                            tr.sync_loss_history_.copy()]


def _p_gbdt(slave, r, pkg):
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

    tr = GBDTTrainer(GBDTConfig(**GBDT_CFG), mesh=make_mesh(1, "cpu"))
    trees, margins = tr.train(*_gbdt_data(r), seed=5, comm=slave)
    return [margins.cpu().numpy().copy(), tr.sync_round_history_,
            _np_trees(trees)]


# -- the reference's ----------------------------------------------------
def _r_linear(slave, r, pkg):
    from ytk_mp4j_tpu.models.linear import LinearConfig, LinearTrainer
    from ytk_mp4j_tpu.parallel import make_mesh

    cfg = LinearConfig(n_features=4, loss="squared", learning_rate=0.1)
    tr = LinearTrainer(cfg, mesh=make_mesh(1))
    params, losses = tr.fit(*_linear_data(r), n_steps=4, comm=slave)
    return _leaves(params) + [np.asarray(losses),
                              tr.sync_loss_history_.copy()]


def _r_fm(slave, r, pkg):
    from ytk_mp4j_tpu.models.fm import FMConfig, FMTrainer
    from ytk_mp4j_tpu.parallel import make_mesh

    tr = FMTrainer(FMConfig(**FM_CFG), mesh=make_mesh(1))
    params, losses = tr.fit(*_fm_data(r), n_steps=4, seed=3, comm=slave)
    return _leaves(params) + [np.asarray(losses),
                              tr.sync_loss_history_.copy()]


def _r_gbdt(slave, r, pkg):
    from ytk_mp4j_tpu.models.gbdt import GBDTConfig, GBDTTrainer
    from ytk_mp4j_tpu.parallel import make_mesh

    tr = GBDTTrainer(GBDTConfig(**GBDT_CFG), mesh=make_mesh(1))
    trees, margins = tr.train(*_gbdt_data(r), seed=5, comm=slave)
    return [np.asarray(margins).copy(), tr.sync_round_history_,
            _np_trees(trees)]


PORT = {"linear": _p_linear, "fm": _p_fm, "gbdt": _p_gbdt}
REF = {"linear": _r_linear, "fm": _r_fm, "gbdt": _r_gbdt}


def _run(monkeypatch, pkg, fn, overlap, **kw):
    monkeypatch.setenv("MP4J_OVERLAP", "1" if overlap else "0")
    try:
        return run_pkg(pkg, 2, fn, timeout=JOIN, **kw)
    finally:
        monkeypatch.delenv("MP4J_OVERLAP", raising=False)


@pytest.mark.parametrize("shm", [False, True])
@pytest.mark.parametrize("family", ["linear", "fm", "gbdt"])
def test_overlap_on_equals_off(family, shm, monkeypatch):
    off = _run(monkeypatch, "port", PORT[family], False, shm=shm)
    on = _run(monkeypatch, "port", PORT[family], True, shm=shm)
    assert canon(on) == canon(off)
    if family != "gbdt":
        mean = np.mean([res[-2].astype(np.float64) for res in off], axis=0)
        for res in off:
            np.testing.assert_allclose(res[-1], mean, rtol=1e-12)
    else:
        assert off[0][1] == [{"trees": 1.0}] * 3


@pytest.mark.parametrize("async_on", [True, False])
def test_overlap_with_either_scheduler(async_on, monkeypatch):
    kw = {"async_collectives": async_on}
    off = _run(monkeypatch, "port", _p_linear, False, **kw)
    on = _run(monkeypatch, "port", _p_linear, True, **kw)
    assert canon(on) == canon(off)


@pytest.mark.parametrize("family", ["linear", "fm"])
def test_histories_match_the_reference(family, monkeypatch):
    port = _run(monkeypatch, "port", PORT[family], True)
    ref = _run(monkeypatch, "ref", REF[family], True)
    for p, j in zip(port, ref):
        np.testing.assert_allclose(p[-1], j[-1], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(p[-2], j[-2], rtol=1e-5, atol=1e-7)
        for a, b in zip(p[:-2], j[:-2]):
            np.testing.assert_allclose(a.reshape(b.shape), b, rtol=1e-5,
                                       atol=1e-6)


def test_gbdt_matches_the_reference(monkeypatch):
    port = _run(monkeypatch, "port", _p_gbdt, True)
    ref = _run(monkeypatch, "ref", _r_gbdt, True)
    for p, j in zip(port, ref):
        _assert_same_trees(j[2], p[2], "logistic")
        np.testing.assert_allclose(p[0], j[0], rtol=RTOL, atol=ATOL)
        assert p[1] == j[1]


def _raw_data(r):
    rng = np.random.default_rng(40 + r)
    N = 1500
    X = np.stack([rng.standard_normal(N), rng.lognormal(0.0, 1.0, N),
                  rng.integers(0, 7, N).astype(np.float64)],
                 axis=1).astype(np.float32)
    X[rng.random(N) < 0.05, 0] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.2 * X[:, 2] > 0.5).astype(np.float32)
    return X, y


def _p_raw(slave, r, pkg):
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

    cfg = GBDTConfig(n_features=3, n_bins=16, depth=2, n_trees=2,
                     learning_rate=0.5, loss="logistic", missing_bin=True)
    tr = GBDTTrainer(cfg, mesh=make_mesh(1, "cpu"))
    trees, margins = tr.train_raw(*_raw_data(r), comm=slave)
    return [tr.binner_.edges.copy(), margins.cpu().numpy(),
            tr.sync_round_history_]


def _r_raw(slave, r, pkg):
    from ytk_mp4j_tpu.models.gbdt import GBDTConfig, GBDTTrainer
    from ytk_mp4j_tpu.parallel import make_mesh

    cfg = GBDTConfig(n_features=3, n_bins=16, depth=2, n_trees=2,
                     learning_rate=0.5, loss="logistic", missing_bin=True)
    tr = GBDTTrainer(cfg, mesh=make_mesh(1))
    trees, margins = tr.train_raw(*_raw_data(r), comm=slave)
    return [np.asarray(tr.binner_.edges).copy(), np.asarray(margins),
            tr.sync_round_history_]


@pytest.mark.parametrize("n", [2, 3])
def test_train_raw_edges_bitwise_the_reference(n, monkeypatch):
    monkeypatch.delenv("MP4J_OVERLAP", raising=False)
    port = run_pkg("port", n, _p_raw, timeout=JOIN)
    ref = run_pkg("ref", n, _r_raw, timeout=JOIN)
    for p, j in zip(port, ref):
        assert p[0].dtype == j[0].dtype and p[0].tobytes() == j[0].tobytes()
        assert p[0].tobytes() == port[0][0].tobytes()
        np.testing.assert_allclose(p[1], j[1], rtol=RTOL, atol=ATOL)
        assert p[2] == j[2]
