"""The port's ``QuantileBinner.fit_distributed`` over ``DistributedComm``
(P = 2 and 3 gloo processes, ``torch_dist_worker.run_job``) against the
JAX package's ``fit_distributed`` over ``ThreadCommSlave.spawn_group(P)``
on the same shards: every rank's edges identical, and bitwise the
reference's (the shape of tests/test_binning.py:547), unweighted, weighted
(:688, :701) and with the missing bucket; a config mismatch raises on
every rank (:571); ``train_raw(comm=)`` fits its binner through
``fit_distributed`` (tests/test_gbdt.py:845)."""

import pickle

import numpy as np
import pytest

from ytk_mp4j_tpu.comm.thread_comm import ThreadCommSlave
from ytk_mp4j_tpu.models.binning import QuantileBinner as JBinner

from test_thread_comm import run_threads
from torch_dist_worker import run_job

WORLDS = (2, 3)
B = 16


def _data():
    rng = np.random.default_rng(5)
    N = 3_000
    X = np.stack([rng.standard_normal(N), rng.lognormal(0.0, 1.0, N),
                  rng.integers(0, 7, N).astype(np.float64)],
                 axis=1).astype(np.float32)
    X[rng.random(N) < 0.05, 0] = np.nan           # missing values
    w = rng.gamma(0.7, 1.0, N)
    cuts = {2: [0, 1_100, N], 3: [0, 600, 1_800, N]}   # uneven shards
    shards = {n: [X[a:b] for a, b in zip(c, c[1:])] for n, c in cuts.items()}
    weights = {n: [w[a:b] for a, b in zip(c, c[1:])] for n, c in cuts.items()}
    raw = np.random.default_rng(7)
    raw_X = raw.standard_normal((400, 6)).astype(np.float32)
    raw_y = (raw_X[:, 0] + 0.5 * raw_X[:, 1] > 0).astype(np.float32)
    return dict(shards=shards, weights=weights, n_bins=B, raw_X=raw_X,
                raw_y=raw_y)


DATA = _data()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"bin{world}")
        (tmp / f"binning_{world}").mkdir()
        with open(tmp / "binning_data.pkl", "wb") as f:
            pickle.dump(DATA, f)
        out[world] = run_job("binning", world, tmp)
    return out


def _reference(world, fn):
    """``fn(slave, rank)`` over the reference's thread comm, per rank."""
    return run_threads(ThreadCommSlave.spawn_group(world), fn)


def _ref_edges(world, weighted=False, missing=False, **kw):
    shards, ws = DATA["shards"][world], DATA["weights"][world]

    def fit(slave, r):
        return JBinner(B, missing_bucket=missing).fit_distributed(
            shards[r], slave, sample_weight=ws[r] if weighted else None,
            **kw).edges

    return _reference(world, fit)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind,weighted,missing", [
    ("edges", False, False), ("edges_weighted", True, False),
    ("edges_missing", False, True)])
def test_edges_identical_and_bitwise_the_references(jobs, world, kind,
                                                    weighted, missing):
    want = _ref_edges(world, weighted, missing, sample=None)
    for e in want[1:]:
        np.testing.assert_array_equal(e, want[0])
    for res in jobs[world]:
        assert res[kind].dtype == want[0].dtype
        np.testing.assert_array_equal(res[kind], want[0])


@pytest.mark.parametrize("world", WORLDS)
def test_config_mismatch_raises_on_every_rank(jobs, world):
    for res in jobs[world]:
        assert res["mismatch"] is not None and "mismatch" in res["mismatch"]


@pytest.mark.parametrize("world", WORLDS)
def test_train_raw_fits_through_fit_distributed(jobs, world):
    """Every rank holds the same raw rows: identical edges, equal to the
    reference's merge of the replicated sketch, and identical
    predictions; the round stats are synced (2 trees)."""
    b = JBinner(8)
    sk = b.local_sketch(DATA["raw_X"], sample=1_000_000, seed=2)
    b.merge_sketches(np.stack([sk.values] * world),
                     np.stack([sk.counts] * world),
                     np.stack([sk.finite] * world),
                     cdf_stack=np.stack([sk.cdf] * world))
    first = jobs[world][0]
    for res in jobs[world]:
        np.testing.assert_array_equal(res["train_raw_edges"], b.edges)
        np.testing.assert_array_equal(res["train_raw_predict"],
                                      first["train_raw_predict"])
        assert [d["trees"] for d in res["train_raw_sync"]] == [1.0, 1.0]


@pytest.mark.parametrize("world", WORLDS)
def test_weighted_train_raw_matches_reference_fit(jobs, world):
    """Per-rank weighted rows: the trainer's binner is the reference's
    weighted ``fit_distributed`` on the same shards, bit for bit."""
    want = _ref_edges(world, weighted=True, sample=1_000_000, seed=4)
    for res in jobs[world]:
        np.testing.assert_array_equal(res["train_raw_weighted_edges"],
                                      want[0])
