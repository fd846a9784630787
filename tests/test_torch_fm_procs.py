"""The port's FM/FFM trainer over processes (``FMTrainer`` on
``comm.distributed.global_mesh`` / ``hier_global_mesh``) on the CPU, over
P = 2 and 3 gloo processes (``torch_dist_worker.run_job``), on the dense,
sparse and sharded-table paths.

Every process passes the same global arrays and stages only its members'
rows. Each rank's weighted loss sum, weight sum and the gradients of w0
and w are folded across the ranks in rank order and the step divides by
the job's weight sum; the dense table gradient is all-reduced, the sparse
slots gathered in rank order, and the sharded table's rows fetched from
and returned to their owners by an all-to-all with split sizes. So:

- every rank holds the replicated parameters bit for bit, and the same
  gathered table and predictions;
- the runs equal the port's one-process ``make_mesh(n)`` of the same
  member count to rtol 1e-5, atol 1e-7 (the folded sums of w0, w and the
  loss round apart from one autograd pass), and the first step's table of
  the sparse and sharded paths bit for bit (a slot's gradient is its
  instance's alone);
- the runs equal the JAX package's trainer on ``make_mesh(n)`` to the same
  tolerance;
- on the sparse and sharded paths, P processes of one member each equal a
  list mesh of P CPU members (``make_mesh(P, devices=["cpu"] * P)``) bit
  for bit.

The module also holds ``fit(comm=)`` (blocking == overlapped, bit for
bit), rank 0's model file, ``params_from_numpy`` on a process mesh, and
checkdist's FFM and dense-plane checks with a fault planted in each."""

import pickle

import numpy as np
import pytest

from ytk_mp4j_tpu.models.fm import FMConfig as JFMConfig
from ytk_mp4j_tpu.models.fm import FMTrainer as JFMTrainer
from ytk_mp4j_tpu.parallel import make_hier_mesh as jmake_hier_mesh
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer

from test_fm import make_sparse_classification
from test_torch_sparse import few_threads  # noqa: F401
from torch_dist_worker import run_job

pytestmark = pytest.mark.usefixtures("few_threads")

WORLDS = (2, 3)
RTOL, ATOL = 1e-5, 1e-7
N = 101                      # pads over 2, 3, 4 and 6 members
PATHS = {"dense": {},
         "sparse": {"sparse_grads": True},
         "sparse_cap": {"sparse_grads": True, "sparse_capacity": 48},
         "sharded": {"sparse_grads": True, "table_sharding": "sharded"}}
REFERENCE_CASES = ("ffm_dense", "ffm_sparse", "ffm_sharded",
                   "fm_sparse_cap", "hier_sharded", "weighted_eval_sharded")


def _cfg(model="ffm", **kw):
    base = dict(n_features=64, n_fields=4, k=4, max_nnz=4, model=model,
                learning_rate=0.3, init_scale=0.1, l2=1e-3)
    base.update(kw)
    return base


def _cases():
    rng = np.random.default_rng(5)
    data = make_sparse_classification(rng, n=N)
    fit = dict(n_steps=5, seed=2)
    cases = {}
    for model in ("fm", "ffm"):
        for path in PATHS:
            cases[f"{model}_{path}"] = dict(cfg=_cfg(model), path=path,
                                            data=data, fit=fit, intra=0)
    for path in ("dense", "sparse", "sharded"):
        cases[f"hier_{path}"] = dict(cfg=_cfg(), path=path, data=data,
                                     fit=fit, intra=2)
        cases[f"stream_{path}"] = dict(cfg=_cfg(), path=path, data=data,
                                       fit=dict(seed=2), intra=0,
                                       chunks=[data] * fit["n_steps"])
    for path in ("sparse", "sharded"):
        cases[f"first_{path}"] = dict(cfg=_cfg(), path=path, data=data,
                                      fit=dict(n_steps=1, seed=2), intra=0)
        cases[f"chunks_{path}"] = dict(
            cfg=_cfg(), path=path, data=data, fit=dict(seed=2), intra=0,
            chunks=[tuple(a[i: i + 40] for a in data)
                    for i in (0, 40, 80)] * 2)
    # sample weights, an eval set of noise labels, early stopping
    w = rng.uniform(0.2, 2.0, N).astype(np.float32)
    va = data[:3] + ((rng.random(N) > 0.5).astype(np.float32),)
    for path in ("sparse", "sharded"):
        cases[f"weighted_eval_{path}"] = dict(
            cfg=_cfg(), path=path, data=data, intra=0,
            fit=dict(n_steps=40, seed=2, sample_weight=w, eval_set=va,
                     early_stopping_rounds=3))
    for case in cases.values():
        case["path"] = PATHS[case["path"]]
    # tests/test_trainer_overlap.py:48's data
    crng = np.random.default_rng(11)
    feats = crng.integers(0, 32, (48, 3)).astype(np.int32)
    comm_data = (feats, np.broadcast_to(np.arange(3, dtype=np.int32) % 2,
                                        (48, 3)).copy(),
                 np.ones((48, 3), np.float32),
                 ((feats[:, 0] + feats[:, 1]) % 2).astype(np.float32))
    comm_cases = {"fm": dict(
        cfg=dict(n_features=32, n_fields=2, k=2, max_nnz=3, model="fm",
                 learning_rate=0.3, init_scale=0.1),
        path={}, data=comm_data, fit=dict(n_steps=4, seed=3),
        rank_data={r: tuple(a[r::3] for a in comm_data) for r in range(3)})}
    host = FMTrainer(FMConfig(**_cfg()), mesh=make_mesh(1, "cpu")).fit(
        *data, n_steps=2, seed=7)[0]
    save = dict(cfg=_cfg(), path=PATHS["sharded"], data=data,
                fit=dict(n_steps=3, seed=4),
                host_params=tuple(p.numpy() for p in host))
    return {"fit": cases, "comm": comm_cases, "save": save}


CASES = _cases()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{world: ([rank results of the ``fm`` scenario], out dir, [rank
    results of the ``checks`` scenario])}."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"fm{world}")
        with open(tmp / "fm_cases.pkl", "wb") as f:
            pickle.dump(CASES, f)
        out[world] = (run_job("fm", world, tmp), tmp / f"fm_{world}",
                      run_job("checks", world, tmp))
    return out


def _members(name, world):
    return world * (CASES["fit"][name]["intra"] or 1)


def _one_process(name, n):
    """The port's one-process trainer over n members on the same case."""
    case = CASES["fit"][name]
    intra = case["intra"]
    mesh = (make_hier_mesh(n // intra, intra, "cpu") if intra
            else make_mesh(n, "cpu"))
    tr = FMTrainer(FMConfig(**case["cfg"]), mesh=mesh, **case["path"])
    if case.get("chunks") is not None:
        params, losses = tr.fit_stream(iter(case["chunks"]), **case["fit"])
    else:
        params, losses = tr.fit(*case["data"], **case["fit"])
    return tr, params, losses


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _same_on_every_rank(results, name):
    """Replicated parameters, the gathered table and predictions: the
    same bits on every rank."""
    first = results[0][name]
    sharded = CASES["fit"][name]["path"].get("table_sharding")
    for res in results[1:]:
        got = res[name]
        replicated = got["params"] if not sharded else got["params"][:2]
        for a, b in zip(replicated, first["params"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["table"], first["table"])
        np.testing.assert_array_equal(got["predict"], first["predict"])
        np.testing.assert_array_equal(got["losses"], first["losses"])
        assert got["eval_history"] == first["eval_history"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES["fit"]))
def test_processes_match_one_process_mesh(jobs, world, name):
    """Losses, w0, w, the gathered table, predictions and the eval history
    against ``make_mesh(n)``; the replicated parameters bitwise on every
    rank."""
    results = jobs[world][0]
    tr, params, losses = _one_process(name, _members(name, world))
    _same_on_every_rank(results, name)
    got = results[0][name]
    assert got["losses"].shape == losses.shape
    _close(got["losses"], losses)
    _close(got["params"][0], params[0])
    _close(got["params"][1], params[1])
    _close(got["table"], tr.full_table(params))
    _close(got["predict"], tr.predict(params, *CASES["fit"][name]["data"]
                                      [:3]))
    np.testing.assert_allclose(got["eval_history"], tr.eval_history_,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_processes_match_reference(jobs, world, name):
    """The JAX package's trainer on a one-process mesh of the same member
    count (and shape), from the same table: losses, the table and the
    eval history."""
    case = CASES["fit"][name]
    n = _members(name, world)
    intra = case["intra"]
    jmesh = jmake_hier_mesh(n // intra, intra) if intra else jmake_mesh(n)
    jtr = JFMTrainer(JFMConfig(**case["cfg"]), mesh=jmesh, **case["path"])
    jp, jl = jtr.fit(*case["data"], **case["fit"])
    got = jobs[world][0][0][name]
    _close(got["losses"], jl)
    _close(got["table"], jtr.full_table(jp))
    _close(got["params"][1], np.asarray(jp[1]))
    np.testing.assert_allclose(got["eval_history"], jtr.eval_history_,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("path", ["sparse", "sharded"])
def test_first_step_table_bitwise_one_process(jobs, world, path):
    """One step: the same slot gradients added in the same order as on
    one process, so the table is the one-process table bit for bit."""
    tr, params, _ = _one_process(f"first_{path}", world)
    for res in jobs[world][0]:
        np.testing.assert_array_equal(res[f"first_{path}"]["table"],
                                      tr.full_table(params))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("path", ["dense", "sparse", "sharded"])
def test_stream_of_full_batches_equals_fit_bitwise(jobs, world, path):
    """Over processes too, one full-batch chunk a step runs the steps of
    ``fit``: losses, parameters and table bit for bit."""
    for res in jobs[world][0]:
        st, ft = res[f"stream_{path}"], res[f"ffm_{path}"]
        np.testing.assert_array_equal(st["losses"], ft["losses"])
        for a, b in zip(st["params"], ft["params"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(st["table"], ft["table"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_blocks_and_padding(jobs, world):
    """Each process holds its members' blocks, and the gathered table
    equals the replicated run's to rtol 1e-5 (the reference's sharded ==
    replicated equality)."""
    n_rows = 64 * 4
    for name, members in (("ffm_sharded", world), ("hier_sharded",
                                                   2 * world)):
        B = -(-n_rows // members)
        for res in jobs[world][0]:
            got = res[name]
            assert got["params"][2].shape == (got["n_local"] * B, 4)
            assert got["table"].shape == (n_rows, 4)
            _close(got["table"], res[name.replace("sharded", "sparse")]
                   ["table"])
            _close(got["losses"], res[name.replace("sharded", "sparse")]
                   ["losses"])


@pytest.mark.parametrize("world", WORLDS)
def test_early_stopping_on_every_rank(jobs, world):
    for path in ("sparse", "sharded"):
        got = jobs[world][0][0][f"weighted_eval_{path}"]
        assert len(got["losses"]) < 40
        assert len(got["losses"]) == int(np.argmin(got["eval_history"])) + 1


@pytest.mark.parametrize("world", WORLDS)
def test_fit_comm_overlap_bit_exact(jobs, world):
    """``fit(comm=)``: MP4J_OVERLAP=1 == 0 bit for bit (params, losses and
    the synced history, the shape of tests/test_trainer_overlap.py:105);
    the history is the mean of the ranks' losses -- over the ranks' own
    rows, and over the processes, where every rank's loss is the job's."""
    results = jobs[world][0]
    for where in ("rank", "global"):
        key0, key1 = ("comm", "fm", where, "0"), ("comm", "fm", where, "1")
        for res in results:
            off, on = res[key0], res[key1]
            for a, b in zip(off["params"], on["params"]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(off["losses"], on["losses"])
            np.testing.assert_array_equal(off["sync"], on["sync"])
            assert off["sync"].dtype == np.float64
        mean = np.mean([res[key0]["losses"].astype(np.float64)
                        for res in results], axis=0)
        for res in results:
            np.testing.assert_allclose(res[key0]["sync"], mean, rtol=1e-12)
    for res in results:
        np.testing.assert_array_equal(
            res["comm", "fm", "global", "0"]["sync"],
            res["comm", "fm", "global", "0"]["losses"].astype(np.float64))


@pytest.mark.parametrize("world", WORLDS)
def test_save_params_once_and_the_reference_loads_it(jobs, world):
    """Every rank saves the sharded table: only rank 0 writes, the
    gathered table, which the reference's ``load_params`` reads."""
    results, out, _ = jobs[world]
    for res in results:
        assert res["saved"] == ["fm_rank0.npz"]
    jcfg, jparams = JFMTrainer.load_params(str(out / "fm_rank0.npz"),
                                           JFMConfig)
    assert jcfg == JFMConfig(**CASES["save"]["cfg"])
    np.testing.assert_array_equal(np.asarray(jparams[2]),
                                  results[0]["save_table"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("intra", [0, 2])
def test_params_from_numpy_takes_its_blocks(jobs, world, intra):
    case = CASES["save"]
    host = case["host_params"]
    members = world * (intra or 1)
    B = -(-host[2].shape[0] // members)
    padded = np.concatenate([host[2], np.zeros((B * members
                                                - host[2].shape[0], 4),
                                               np.float32)])
    one = FMTrainer(FMConfig(**case["cfg"]), mesh=make_mesh(1, "cpu"))
    want = one.predict(host, *case["data"][:3]).numpy()
    for r, res in enumerate(jobs[world][0]):
        got = res["from_numpy", intra]
        local = intra or 1
        np.testing.assert_array_equal(
            got["block"], padded[r * local * B: (r + 1) * local * B])
        np.testing.assert_array_equal(got["table"], host[2])
        _close(got["predict"], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("check", ["ffm", "round4", "dense_plane"])
def test_checkdist_checks_pass_and_catch_planted_faults(jobs, world, check):
    """``check_ffm_global_mesh``, ``check_ffm_round4_global_mesh`` and
    ``check_dense_plane_timing`` find nothing, and each fails on every
    rank with its fault planted: a per-rank denominator, gradient rows
    never returned to their owners, a host fold of one rank's row."""
    for res in jobs[world][2]:
        assert res[check] == 0
        assert res["planted", check] >= 1



@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["ffm_sparse", "fm_sparse_cap",
                                  "ffm_sharded", "stream_sharded",
                                  "weighted_eval_sparse",
                                  "weighted_eval_sharded"])
def test_processes_equal_a_cpu_list_bitwise(jobs, world, name):
    """P processes of one member each and a list mesh of P members on the
    CPU fold the same partials (loss, weight sum, w0's and w's gradients)
    in the same rank order and add the same slot rows into the table in
    the same order: the same bits (the dense path's table gradient takes
    the backend's all-reduce over processes, in its own order)."""
    case = CASES["fit"][name]
    tr = FMTrainer(FMConfig(**case["cfg"]),
                   mesh=make_mesh(world, devices=["cpu"] * world),
                   **case["path"])
    if case.get("chunks") is not None:
        params, losses = tr.fit_stream(iter(case["chunks"]), **case["fit"])
    else:
        params, losses = tr.fit(*case["data"], **case["fit"])
    got = jobs[world][0][0][name]
    np.testing.assert_array_equal(got["losses"], losses)
    np.testing.assert_array_equal(got["table"], tr.full_table(params))
    for a, b in zip(got["params"][:2], params[:2]):
        np.testing.assert_array_equal(a, b.numpy())
    assert got["eval_history"] == tr.eval_history_
