"""The port's linear trainer over processes (``LinearTrainer`` on
``comm.distributed.global_mesh`` / ``hier_global_mesh``) on the CPU, over
P = 2 and 3 gloo processes (``torch_dist_worker.run_job``).

Every process passes the same global arrays and stages only its members'
rows; each rank's (loss sum, weight sum, gw, gb) is folded across the
ranks in rank order and the step divides by the job's weight sum. So every
rank holds the same parameters bit for bit, and the runs equal the port's
one-process ``make_mesh(n)`` and the JAX package's trainer on
``make_mesh(n)`` to rtol 1e-5, atol 1e-7 (the folded sums round apart from
one autograd pass). Squared, logistic (from nonzero parameters: the
reference's gradient at a margin of 0 is wrong) and softmax, with
momentum, L1 and L2, sample weights, an eval set with early stopping, the
stream, ``predict``, ``params_from_numpy`` and ``fit(comm=)``. P processes
of one member each equal a list mesh of P CPU members bit for bit (the
same partials folded in the same rank order)."""

import pickle

import numpy as np
import pytest

from ytk_mp4j_tpu.models.linear import LinearConfig as JLinearConfig
from ytk_mp4j_tpu.models.linear import LinearTrainer as JLinearTrainer
from ytk_mp4j_tpu.parallel import make_hier_mesh as jmake_hier_mesh
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.models.linear import LinearConfig, LinearTrainer

from test_linear import make_regression
from test_torch_sparse import few_threads  # noqa: F401
from torch_dist_worker import run_job

pytestmark = pytest.mark.usefixtures("few_threads")

WORLDS = (2, 3)
RTOL, ATOL = 1e-5, 1e-7
N, F = 101, 5


def _cases():
    rng = np.random.default_rng(3)
    x, y, _ = make_regression(rng, n=N, d=F)
    base = dict(n_features=F, learning_rate=0.2, momentum=0.9, l1=0.01,
                l2=1e-3)
    labels = {"squared": y,
              "logistic": (y > np.median(y)).astype(np.float32),
              "softmax": np.digitize(y, np.quantile(y, [1 / 3, 2 / 3]))
              .astype(np.int32)}
    start = {"logistic": (rng.standard_normal(F).astype(np.float32) * 0.1,
                          np.float32(0.05))}
    w = rng.uniform(0.2, 2.0, N).astype(np.float32)
    cases = {}
    for loss, yl in labels.items():
        cfg = dict(base, loss=loss, n_classes=3)
        fit = dict(n_steps=10, params=start.get(loss))
        for intra, tag in ((0, ""), (2, "hier_")):
            cases[tag + loss] = dict(cfg=cfg, data=(x, yl), fit=fit,
                                     intra=intra)
        cases["weighted_" + loss] = dict(
            cfg=cfg, data=(x, yl), fit=dict(fit, sample_weight=w), intra=0)
    sq = cases["squared"]
    va = (x, rng.standard_normal(N).astype(np.float32))
    cases["eval"] = dict(cfg=sq["cfg"], data=sq["data"], intra=0,
                         fit=dict(n_steps=40, eval_set=va,
                                  early_stopping_rounds=3))
    cases["stream"] = dict(cfg=sq["cfg"], data=sq["data"], intra=0,
                           fit={}, chunks=[sq["data"]] * 10)
    cases["chunks"] = dict(
        cfg=sq["cfg"], data=sq["data"], intra=2, fit=dict(max_in_flight=0),
        chunks=[(x[i: i + 40], y[i: i + 40], w[i: i + 40])
                for i in (0, 40, 80)] * 2)
    # tests/test_trainer_overlap.py:36's data
    crng = np.random.default_rng(7)
    cx = crng.standard_normal((64, 4)).astype(np.float32)
    cy = cx @ np.array([1.0, -2.0, 0.5, 0.0], np.float32)
    comm_cases = {"linear": dict(
        cfg=dict(n_features=4, loss="squared", learning_rate=0.1),
        data=(cx, cy), fit=dict(n_steps=4),
        rank_data={r: (cx[r::3], cy[r::3]) for r in range(3)})}
    return {"fit": cases, "comm": comm_cases}


CASES = _cases()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{world: [rank results of the ``linear`` scenario]}."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"linear{world}")
        with open(tmp / "linear_cases.pkl", "wb") as f:
            pickle.dump(CASES, f)
        out[world] = run_job("linear", world, tmp)
    return out


def _members(name, world):
    return world * (CASES["fit"][name]["intra"] or 1)


def _one_process(name, n):
    case = CASES["fit"][name]
    intra = case["intra"]
    mesh = (make_hier_mesh(n // intra, intra, "cpu") if intra
            else make_mesh(n, "cpu"))
    tr = LinearTrainer(LinearConfig(**case["cfg"]), mesh=mesh)
    if case.get("chunks") is not None:
        params, losses = tr.fit_stream(iter(case["chunks"]), **case["fit"])
    else:
        params, losses = tr.fit(*case["data"], **case["fit"])
    return tr, params, losses


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES["fit"]))
def test_processes_match_one_process_mesh(jobs, world, name):
    """Losses, parameters, predictions and the eval history against
    ``make_mesh(n)``; everything bitwise equal on every rank."""
    results = jobs[world]
    first = results[0][name]
    for res in results[1:]:
        for a, b in zip(res[name]["params"], first["params"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(res[name]["losses"], first["losses"])
        np.testing.assert_array_equal(res[name]["predict"],
                                      first["predict"])
        assert res[name]["eval_history"] == first["eval_history"]
    tr, params, losses = _one_process(name, _members(name, world))
    assert first["losses"].shape == losses.shape
    _close(first["losses"], losses)
    for a, b in zip(first["params"], params):
        _close(a, b)
    _close(first["predict"], tr.predict(params, CASES["fit"][name]["data"]
                                        [0]))
    np.testing.assert_allclose(first["eval_history"], tr.eval_history_,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["squared", "logistic", "softmax",
                                  "hier_softmax", "weighted_squared",
                                  "eval"])
def test_processes_match_reference(jobs, world, name):
    case = CASES["fit"][name]
    n = _members(name, world)
    intra = case["intra"]
    jmesh = jmake_hier_mesh(n // intra, intra) if intra else jmake_mesh(n)
    jtr = JLinearTrainer(JLinearConfig(**case["cfg"]), mesh=jmesh)
    jp, jl = jtr.fit(*case["data"], **case["fit"])
    got = jobs[world][0][name]
    _close(got["losses"], jl)
    _close(got["params"][0], np.asarray(jp[0]))
    _close(got["params"][1], np.asarray(jp[1]))
    np.testing.assert_allclose(got["eval_history"], jtr.eval_history_,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_stream_of_full_batches_equals_fit_bitwise(jobs, world):
    for res in jobs[world]:
        np.testing.assert_array_equal(res["stream"]["losses"],
                                      res["squared"]["losses"])
        for a, b in zip(res["stream"]["params"], res["squared"]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_early_stopping_on_every_rank(jobs, world):
    got = jobs[world][0]["eval"]
    assert len(got["losses"]) < 40
    assert len(got["losses"]) == int(np.argmin(got["eval_history"])) + 1


@pytest.mark.parametrize("world", WORLDS)
def test_fit_comm_overlap_bit_exact(jobs, world):
    """``fit(comm=)``: MP4J_OVERLAP=1 == 0 bit for bit, and
    ``sync_loss_history_`` is the mean of the ranks' losses."""
    results = jobs[world]
    for where in ("rank", "global"):
        key0 = ("comm", "linear", where, "0")
        key1 = ("comm", "linear", where, "1")
        for res in results:
            off, on = res[key0], res[key1]
            for a, b in zip(off["params"], on["params"]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(off["losses"], on["losses"])
            np.testing.assert_array_equal(off["sync"], on["sync"])
            assert off["sync"].shape == (4,)
        mean = np.mean([res[key0]["losses"].astype(np.float64)
                        for res in results], axis=0)
        for res in results:
            np.testing.assert_allclose(res[key0]["sync"], mean, rtol=1e-12)
    rank_losses = [res["comm", "linear", "rank", "0"]["losses"]
                   for res in results]
    assert not np.array_equal(rank_losses[0], rank_losses[1])


def test_sync_history_without_a_comm_is_the_local_losses():
    """As the reference's exchanger keeps them: each step's own loss, f64,
    every step run (early stopping does not cut it)."""
    case = CASES["fit"]["eval"]
    tr = LinearTrainer(LinearConfig(**case["cfg"]), mesh=make_mesh(2, "cpu"))
    _, losses = tr.fit(*case["data"], **case["fit"])
    assert tr.sync_loss_history_.dtype == np.float64
    n_run = len(tr.eval_history_)
    assert len(tr.sync_loss_history_) == n_run > len(losses)
    np.testing.assert_array_equal(tr.sync_loss_history_[:len(losses)],
                                  losses.astype(np.float64))
    jtr = JLinearTrainer(JLinearConfig(**case["cfg"]), mesh=jmake_mesh(2))
    jtr.fit(*case["data"], **case["fit"])
    assert len(jtr.sync_loss_history_) == n_run


@pytest.mark.parametrize("world", WORLDS)
def test_params_from_numpy_on_a_process_mesh(jobs, world):
    for res in jobs[world]:
        for a, b in zip(res["from_numpy"], res["squared"]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["squared", "logistic", "softmax",
                                  "weighted_softmax", "eval", "stream"])
def test_processes_equal_a_cpu_list_bitwise(jobs, world, name):
    """P processes of one member each and a list mesh of P members on the
    CPU fold the same partials in the same rank order: the same bits."""
    case = CASES["fit"][name]
    tr = LinearTrainer(LinearConfig(**case["cfg"]),
                       mesh=make_mesh(world, devices=["cpu"] * world))
    if case.get("chunks") is not None:
        params, losses = tr.fit_stream(iter(case["chunks"]), **case["fit"])
    else:
        params, losses = tr.fit(*case["data"], **case["fit"])
    got = jobs[world][0][name]
    np.testing.assert_array_equal(got["losses"], losses)
    for a, b in zip(got["params"], params):
        np.testing.assert_array_equal(a, b.numpy())
    assert got["eval_history"] == tr.eval_history_
