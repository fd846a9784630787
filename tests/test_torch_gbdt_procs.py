"""The port's GBDT over processes (``GBDTTrainer`` on
``comm.distributed.global_mesh`` / ``hier_global_mesh``) on the CPU, over
P = 2 and 3 gloo processes (``torch_dist_worker.run_job``).

Every process passes the same global arrays, stages only its members'
rows, and folds the histograms and leaf sums across the ranks in rank
order, so its trees and margins must equal a one-process ``make_mesh(n)``
of the port BIT FOR BIT; that one-process mesh is in turn held against the
JAX package's trainer on a mesh of the same shape, as
``test_torch_gbdt_mesh.py`` holds it (trees bitwise on data whose splits
clear every runner-up, leaves and margins to rtol 1e-4, atol 1e-5). N =
1001 does not split evenly over 2, 3, 4 or 6 members: every mesh pads."""

import pickle

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu.models import gbdt as J
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.models import gbdt as T
from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

from test_torch_gbdt import (ATOL, RTOL, _assert_clear_splits,
                             _assert_same_trees, _cfg_kwargs, _data)
from torch_dist_worker import run_job

WORLDS = (2, 3)
LOSSES = ("squared", "logistic", "softmax")
N = 1001
SEED = 1          # data whose splits all clear (test_torch_gbdt_mesh.py)


def _cases():
    cases = {}
    for loss in LOSSES:
        bins, y = _data(loss, seed=SEED, N=N)
        cases[loss] = dict(cfg=_cfg_kwargs(loss), bins=bins, y=y, train={},
                           intra=0)
    bins, y = _data("squared", seed=SEED, N=N)
    w = np.random.default_rng(1).uniform(0.2, 2.0, N).astype(np.float32)
    cases["hier"] = dict(cfg=_cfg_kwargs("squared"), bins=bins, y=y,
                         train={}, intra=2)
    cases["subsampled"] = dict(
        cfg=_cfg_kwargs("squared", subsample=0.7, colsample=0.75),
        bins=bins, y=y, train=dict(seed=5), intra=0)
    cases["hier_subsampled"] = dict(
        cfg=_cfg_kwargs("squared", subsample=0.6), bins=bins, y=y,
        train=dict(seed=9), intra=2)
    cases["weighted"] = dict(cfg=_cfg_kwargs("squared"), bins=bins, y=y,
                             train=dict(sample_weight=w), intra=0)
    # held-out labels flipped: the metric worsens from the first round on
    labels = (y > np.median(y)).astype(np.float32)
    cases["early_stop"] = dict(
        cfg=_cfg_kwargs("logistic", n_trees=8), bins=bins, y=labels,
        train=dict(eval_set=(bins[:200], 1.0 - labels[:200]),
                   early_stopping_rounds=2), intra=0)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{world: [rank results]} of the ``gbdt`` scenario, and the tmp dir."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"gbdt{world}")
        (tmp / f"gbdt_{world}").mkdir()
        with open(tmp / "gbdt_cases.pkl", "wb") as f:
            pickle.dump(CASES, f)
        out[world] = (run_job("gbdt", world, tmp), tmp / f"gbdt_{world}")
    return out


def _one_process(name, n):
    """The port's one-process trainer over n members on the same case."""
    case = CASES[name]
    tr = GBDTTrainer(GBDTConfig(**case["cfg"]), mesh=make_mesh(n, "cpu"))
    trees, margins = tr.train(case["bins"], case["y"], **case["train"])
    return tr, trees, margins.numpy()


def _flat(trees):
    out = []
    for rnd in trees:
        for t in (rnd if isinstance(rnd[0], tuple) else (rnd,)):
            out.extend(np.asarray(a.numpy() if isinstance(a, torch.Tensor)
                                  else a) for a in t)
    return out


def _assert_bitwise(got, trees, margins):
    a, b = _flat(got["trees"]), _flat(trees)
    assert len(a) == len(b)
    for x, z in zip(a, b):
        np.testing.assert_array_equal(x, z)
    np.testing.assert_array_equal(got["margins"], margins)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("loss", LOSSES)
def test_processes_equal_one_process_mesh(jobs, world, loss):
    _, trees, margins = _one_process(loss, world)
    for res in jobs[world][0]:
        assert res[loss]["shape"] == (world,) and res[loss]["n_local"] == 1
        _assert_bitwise(res[loss], trees, margins)
        assert res[loss]["margins"].shape[0] == -(-N // world) * world


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("loss", LOSSES)
def test_one_process_mesh_matches_reference(world, loss):
    """The one-process mesh that the processes must equal, held against
    the JAX package's trainer on a mesh of the same member count."""
    case = CASES[loss]
    tr, trees, margins = _one_process(loss, world)
    jt, jm = J.GBDTTrainer(J.GBDTConfig(**case["cfg"]),
                           mesh=jmake_mesh(world)).train(case["bins"],
                                                         case["y"])
    _assert_clear_splits(tr, case["bins"], case["y"], trees)
    _assert_same_trees(jt, trees, loss)
    np.testing.assert_allclose(margins, np.asarray(jm), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_hier_global_mesh_equals_flat_mesh(jobs, world):
    """(world, 2) over processes == a one-process flat mesh of 2 * world
    members == a one-process (world, 2) mesh, bit for bit."""
    _, trees, margins = _one_process("hier", 2 * world)
    case = CASES["hier"]
    th, mh = GBDTTrainer(GBDTConfig(**case["cfg"]), mesh=make_hier_mesh(
        world, 2, "cpu")).train(case["bins"], case["y"])
    _assert_bitwise({"trees": th, "margins": mh.numpy()}, trees, margins)
    for res in jobs[world][0]:
        assert res["hier"]["shape"] == (world, 2)
        assert res["hier"]["n_local"] == 2
        _assert_bitwise(res["hier"], trees, margins)


@pytest.mark.parametrize("world", WORLDS)
def test_folds_are_rank_order_folds_bitwise(jobs, world, monkeypatch):
    """Every folded histogram and leaf sum of a (world, 2) tree equals the
    one-process fold of 2 * world members bit for bit: every member's
    partial is gathered and folded in rank order, never each process's
    members first (((x0+x1)+(x2+x3)) is not (((x0+x1)+x2)+x3) in f32)."""
    real, folds = T._fold, []

    def record(x, m):
        out = real(x, m)
        folds.append(out.numpy())
        return out

    monkeypatch.setattr(T, "_fold", record)
    case = CASES["hier"]
    GBDTTrainer(GBDTConfig(**case["cfg"]), mesh=make_mesh(
        2 * world, "cpu")).train(case["bins"], case["y"], n_trees=1)
    assert len(folds) == 2 * case["cfg"]["depth"] + 2
    for res in jobs[world][0]:
        # over processes the g and h planes ride one gather: [k, 2, ...]
        assert 2 * len(res["hier_folds"]) == len(folds)
        for i, got in enumerate(res["hier_folds"]):
            np.testing.assert_array_equal(got[:, 0], folds[2 * i])
            np.testing.assert_array_equal(got[:, 1], folds[2 * i + 1])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,members", [("subsampled", 1),
                                          ("hier_subsampled", 2)])
def test_subsampled_trees_equal_one_process(jobs, world, name, members):
    """Each member draws from its global index's generator, and ranks
    without member 0 replay member 0's stream for the feature mask."""
    _, trees, margins = _one_process(name, members * world)
    for res in jobs[world][0]:
        _assert_bitwise(res[name], trees, margins)


@pytest.mark.parametrize("world", WORLDS)
def test_sample_weight_over_processes(jobs, world):
    _, trees, margins = _one_process("weighted", world)
    for res in jobs[world][0]:
        _assert_bitwise(res["weighted"], trees, margins)


@pytest.mark.parametrize("world", WORLDS)
def test_eval_set_and_early_stopping_on_every_rank(jobs, world):
    tr, trees, margins = _one_process("early_stop", world)
    assert len(trees) < CASES["early_stop"]["cfg"]["n_trees"]
    for res in jobs[world][0]:
        _assert_bitwise(res["early_stop"], trees, margins)
        assert res["early_stop"]["eval_history"] == tr.eval_history_


@pytest.mark.parametrize("world", WORLDS)
def test_train_comm_overlap_bit_exact(jobs, world):
    """``train(comm=)``: MP4J_OVERLAP=1 == 0 bit-exact, trees, margins and
    the synced round history (the shape of
    tests/test_trainer_overlap.py:67)."""
    for res in jobs[world][0]:
        off, on = res["overlap", "0"], res["overlap", "1"]
        _assert_bitwise(on, off["trees"], off["margins"])
        assert on["sync"] == off["sync"]
        assert len(off["sync"]) == CASES["squared"]["cfg"]["n_trees"]
        for rnd in off["sync"]:
            assert rnd["trees"] == 1.0        # mean of 1 over the ranks
            assert np.isfinite(rnd["metric"])
    # every rank evaluates the whole eval set: the same metric everywhere
    syncs = [res["overlap", "0"]["sync"] for res in jobs[world][0]]
    assert all(s == syncs[0] for s in syncs)


@pytest.mark.parametrize("world", WORLDS)
def test_rank0_model_file_loads_in_reference(jobs, world):
    results, out = jobs[world]
    for res in results:
        assert res["saved"] == ["model_rank0.npz"]   # only rank 0 wrote
    case = CASES["squared"]
    jcfg, jtrees, _ = J.GBDTTrainer.load_model(str(out / "model_rank0.npz"))
    assert jcfg == J.GBDTConfig(**case["cfg"])
    jm = J.GBDTTrainer(jcfg, mesh=jmake_mesh(1)).predict(case["bins"],
                                                         jtrees)
    tr, trees, _ = _one_process("squared", world)
    pm = tr.predict(case["bins"], trees).numpy()
    np.testing.assert_allclose(np.asarray(jm), pm, rtol=RTOL, atol=ATOL)


def test_absmax_bits_follow_the_kernel_rule():
    """The scale seed a process group agrees on: the bits of max|g| and
    max|h|, ordered as the kernel's first pass orders them (a NaN's bits
    above +inf); rows of no sign matter."""
    from ytk_mp4j_tpu_torch.ops import hist_kernel as hk

    def bits(x):
        return int(np.float32(x).view(np.int32))

    g = torch.tensor([1.5, -3.0, 0.25])
    h = torch.tensor([0.0, 2.0, -0.5])
    assert hk.absmax_bits(g, h).tolist() == [bits(3.0), bits(2.0)]
    g[0] = float("-inf")
    h[1] = float("nan")
    got = hk.absmax_bits(g, h).tolist()
    assert got[0] == bits(np.inf) and got[1] > bits(np.inf)
    empty = torch.zeros(0)
    assert hk.absmax_bits(empty, empty).tolist() == [0, 0]
    bins = torch.zeros((3, 2), dtype=torch.int32)
    ids = torch.zeros(3, dtype=torch.int32)
    g, h = torch.ones(3), torch.ones(3)
    with pytest.raises(Exception, match="absmax must be int32"):
        hk.histograms(bins, g, h, ids, 1, 2, 4,
                      absmax=torch.zeros(2, dtype=torch.int64))
    # the plain version needs no scale: the same sums either way
    a = hk.histograms(bins, g, h, ids, 1, 2, 4, hk.absmax_bits(g, h))
    b = hk.histograms(bins, g, h, ids, 1, 2, 4)
    assert all(torch.equal(x, z) for x, z in zip(a, b))


def test_every_trainer_accepts_a_process_mesh():
    """GBDT, FM and linear all train over processes: a mesh with a process
    group is taken as it is, its local members and their device with it
    (tests/test_torch_fm_procs.py and test_torch_linear_procs.py train
    them over gloo jobs)."""
    from ytk_mp4j_tpu_torch.device import Mesh
    from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer
    from ytk_mp4j_tpu_torch.models.linear import LinearConfig, LinearTrainer

    mesh = Mesh(4, torch.device("cpu"), (2, 2), object(), 2, 2)
    for tr in (GBDTTrainer(GBDTConfig(n_features=3), mesh=mesh),
               LinearTrainer(LinearConfig(n_features=3), mesh=mesh),
               FMTrainer(FMConfig(n_features=8, n_fields=2, k=2, max_nnz=2),
                         mesh=mesh, sparse_grads=True,
                         table_sharding="sharded")):
        assert tr.mesh is mesh and tr.group is mesh.group
        assert tr.n_shards == 4 and tr.device == mesh.device
        # this process's members are global members 2 and 3: rows
        # [2 * per, 4 * per) of the input, clipped to its N rows
        assert tr._row_span(10) == (3, 6, 10)
