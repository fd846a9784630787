"""Multi-process jobs of the port's ``torch.distributed`` plane for the
tests (``test_torch_distributed.py``, ``test_torch_gbdt_procs.py``,
``test_torch_binning_dist.py``).

:func:`run_job` starts ``world`` fresh interpreters (``subprocess``, never a
fork) that meet through a ``file://`` store under the caller's temporary
directory -- no port, so parallel test workers never collide -- and run
one scenario of this module each. Each rank pickles its results into
``out/rank_<r>.pkl``; :func:`run_job` returns them in rank order. A job
that overruns its deadline is killed, every process of it, and raises.

This module imports torch, numpy and the port only: the workers run no
JAX, and the reference side of each comparison runs in the test process.

    python tests/torch_dist_worker.py SCENARIO STORE WORLD RANK OUT
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT_S = 180.0
LENGTH = 37                   # dense payload, uneven over 2 and 3 ranks
SEED_BASE = 3000


def absmax(a, b):
    """The custom operator of the dense grid: the larger magnitude, the
    first on a tie."""
    return np.where(np.abs(a) >= np.abs(b), a, b)


def uneven_ranges(world: int):
    """Rank q owns q + 1 elements, from offset 2."""
    out, off = [], 2
    for q in range(world):
        out.append((off, off + q + 1))
        off += q + 1
    return out


def run_procs(argv_of, world: int, env=None,
              timeout: float = JOB_TIMEOUT_S) -> list:
    """Start ``world`` processes, rank r running ``argv_of(r)`` from the
    repo root, and wait for all of them; returns their outputs. Raises
    with every rank's output when a rank fails, and kills every rank when
    the deadline passes."""
    full_env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    full_env.update(env or {})
    procs = [subprocess.Popen(argv_of(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=full_env,
                              cwd=REPO) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
                .decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"{world} processes passed their {timeout} s "
                           f"deadline: {argv_of(0)}")
    if any(p.returncode for p in procs):
        text = "\n".join(f"--- rank {r} (exit {p.returncode})\n{log}"
                         for r, (p, log) in enumerate(zip(procs, logs)))
        raise RuntimeError(f"{argv_of(0)} over {world} processes failed:"
                           f"\n{text}")
    return logs


def run_job(scenario: str, world: int, tmp: Path, env=None,
            timeout: float = JOB_TIMEOUT_S) -> list:
    """Run ``scenario`` over ``world`` CPU processes; their results in
    rank order."""
    tmp = Path(tmp)
    out = tmp / f"{scenario}_{world}"
    out.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store_{scenario}_{world}"
    run_procs(lambda r: [sys.executable, __file__, scenario, str(store),
                         str(world), str(r), str(out)], world, env, timeout)
    results = []
    for r in range(world):
        with open(out / f"rank_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ----------------------------------------------------------------------
# scenarios: each takes (comm, out dir) and returns a picklable dict
# ----------------------------------------------------------------------
def scenario_comm(comm, out: Path) -> dict:
    """The dense family over the operand x operator grid, ranges, the
    gather family, the i* futures, the map family and its error paths,
    and close's aggregated code."""
    from ytk_mp4j_tpu_torch.check._oracle import rank_data
    from ytk_mp4j_tpu_torch.exceptions import Mp4jError
    from ytk_mp4j_tpu_torch.operands import Operands
    from ytk_mp4j_tpu_torch.operators import Operator, Operators

    r, n = comm.rank, comm.slave_num
    custom = Operator.custom("ABSMAX", absmax, 0)
    ops = {"SUM": Operators.SUM, "MAX": Operators.MAX, "MIN": Operators.MIN,
           "PROD": Operators.PROD, "CUSTOM": custom}
    res: dict = {}
    for operand in (Operands.DOUBLE, Operands.FLOAT, Operands.INT,
                    Operands.LONG):
        mine = rank_data(r, LENGTH, operand, SEED_BASE)
        name = operand.name
        for op_name, op in ops.items():
            res["allreduce", name, op_name] = comm.allreduce_array(
                mine.copy(), operand, op)
            res["reduce", name, op_name] = comm.reduce_array(
                mine.copy(), operand, op, root=n - 1)
            res["reduce_scatter", name, op_name] = comm.reduce_scatter_array(
                mine.copy(), operand, op)
            res["reduce_scatter_uneven", name, op_name] = (
                comm.reduce_scatter_array(mine.copy(), operand, op,
                                          ranges=uneven_ranges(n)))
        res["allreduce_range", name] = comm.allreduce_array(
            mine.copy(), operand, Operators.SUM, from_=5, to=LENGTH - 3)
        res["reduce_range", name] = comm.reduce_array(
            mine.copy(), operand, Operators.MAX, root=0, from_=3, to=11)
        res["broadcast", name] = comm.broadcast_array(
            mine.copy(), operand, root=n - 1)
        res["broadcast_range", name] = comm.broadcast_array(
            mine.copy(), operand, root=0, from_=4, to=9)
        res["allgather", name] = comm.allgather_array(mine.copy(), operand)
        res["gather", name] = comm.gather_array(mine.copy(), operand, root=0)
        res["scatter", name] = comm.scatter_array(mine.copy(), operand,
                                                  root=n - 1)
        uneven = uneven_ranges(n)
        res["allgather_uneven", name] = comm.allgather_array(
            mine.copy(), operand, ranges=uneven)
        res["gather_uneven", name] = comm.gather_array(
            mine.copy(), operand, root=n - 1, ranges=uneven)
        res["scatter_uneven", name] = comm.scatter_array(
            mine.copy(), operand, root=0, ranges=uneven)
        # the i* twins: resolved futures equal to the blocking calls
        res["i", "allreduce", name] = comm.iallreduce(
            mine.copy(), operand, Operators.SUM).wait()
        res["i", "reduce_scatter", name] = comm.ireduce_scatter(
            mine.copy(), operand, Operators.MAX).wait()
        res["i", "allgather", name] = comm.iallgather(
            mine.copy(), operand).wait()
        res["i", "gather", name] = comm.igather(
            mine.copy(), operand, root=0).wait()
    fut = comm.iallreduce(np.zeros(3, np.float32), Operands.DOUBLE)
    res["i", "failure"] = type(fut.exception()).__name__
    comm.wait_all()

    # the map family
    def keyed(q):
        return {f"k{(q + j) % (n + 1)}": float(q * 10 + j) for j in range(3)}

    def run_map(method, d, *args, **kw):
        getattr(comm, method)(d, *args, **kw)
        return d

    res["map", "allreduce_sum"] = run_map("allreduce_map", keyed(r))
    res["map", "allreduce_max"] = run_map(
        "allreduce_map", keyed(r), Operands.DOUBLE, Operators.MAX)
    res["map", "allreduce_prod"] = run_map(
        "allreduce_map", keyed(r), Operands.DOUBLE, Operators.PROD)
    res["map", "reduce"] = run_map("reduce_map", keyed(r), root=n - 1)
    res["map", "reduce_scatter"] = run_map("reduce_scatter_map", keyed(r))
    res["map", "allgather"] = run_map("allgather_map", {f"r{r}": float(r)})
    res["map", "gather"] = run_map("gather_map", {f"r{r}": float(r)},
                                   root=0)
    res["map", "broadcast"] = run_map("broadcast_map", keyed(r), root=n - 1)
    res["map", "scatter"] = run_map(
        "scatter_map", {f"s{j}": float(j) for j in range(9)} if r == 0
        else {}, root=0)
    res["map", "vector"] = run_map(
        "allreduce_map", {k: np.full(3, v, np.float32)
                          for k, v in keyed(r).items()}, Operands.FLOAT)
    res["map", "int_values"] = run_map(
        "allreduce_map", {k: int(v) for k, v in keyed(r).items()},
        Operands.LONG)
    res["map", "custom"] = run_map(
        "allreduce_map", {k: (1.0 + v) * (-1.0 if r % 2 else 1.0)
                          for k, v in keyed(r).items()}, Operands.DOUBLE,
        Operator.custom("ABSMAX_HOST",
                        lambda a, b: a if abs(a) > abs(b) else b, 0.0))
    res["map", "object"] = run_map(
        "allreduce_map", {"s": f"<{r}>", f"only{r}": [r]},
        Operands.STRING, Operator.custom("CONCAT", lambda a, b: a + b, ""))
    res["map", "empty_rank"] = run_map(
        "allreduce_map", {} if r == 0 else {7 * r: 1.0})
    # a drifting int vocabulary: only novel keys travel
    for step in range(3):
        res["map", "drift", step] = run_map(
            "allreduce_map", {int(r * 5 + j + 3 * step): float(r * 10 + j)
                              for j in range(4)})
    res["codec_size"] = comm._codecs_by_kind["int"].size
    res["map", "iallreduce"] = comm.iallreduce_map(keyed(r)).wait()
    comm.reset_map_vocabularies()
    res["codecs_after_reset"] = len(comm._codecs_by_kind)
    res["map", "after_reset"] = run_map("allreduce_map", keyed(r))

    # faults raise on EVERY rank, and the comm stays usable
    def error_of(fn):
        try:
            fn()
        except Mp4jError as e:
            return str(e)
        return None

    res["err", "mixed_kinds"] = error_of(lambda: comm.allreduce_map(
        {1: 1.0} if r == 0 else {"a": 1.0}))
    res["err", "vshape"] = error_of(lambda: comm.allreduce_map(
        {"v": np.zeros(2 + (r == 0))}, Operands.DOUBLE))
    res["err", "bad_value"] = error_of(lambda: comm.allreduce_map(
        {"x": "not a number" if r == n - 1 else 1.0}))
    res["err", "duplicate"] = error_of(lambda: comm.allgather_map(
        {"dup": float(r)}))
    res["map", "after_errors"] = run_map("allreduce_map", keyed(r))
    # the trainers' per-step stats exchange, blocking and overlapped
    from ytk_mp4j_tpu_torch.models._base import StepStatsExchanger

    for overlap in (False, True):
        ex = StepStatsExchanger(comm, overlap=overlap)
        for step in range(3):
            ex.submit(np.array([r + step, 1.0]))
            ex.submit_map({"loss": float(r * step), f"r{r}": 1.0})
        ex.drain()
        res["stats", overlap] = (ex.mean_history(), ex.mean_map_history())
    comm.close(r)
    res["final_code"] = comm.final_code
    return res


def _gbdt_trainer(cfg_kw, mesh):
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

    return GBDTTrainer(GBDTConfig(**cfg_kw), mesh=mesh)


def _numpy_trees(trees):
    return [tuple(tuple(a.cpu().numpy() for a in t) for t in rnd)
            if isinstance(rnd[0], tuple) else tuple(a.cpu().numpy()
                                                     for a in rnd)
            for rnd in trees]


def scenario_gbdt(comm, out: Path) -> dict:
    """GBDT over every process on the data and configs the test process
    wrote (``gbdt_cases.pkl``): trees and margins of each case, the eval
    history, ``train(comm=)`` under MP4J_OVERLAP=0 and 1, and rank 0's
    model file."""
    from ytk_mp4j_tpu_torch.comm.distributed import (global_mesh,
                                                     hier_global_mesh)

    with open(out.parent / "gbdt_cases.pkl", "rb") as f:
        cases = pickle.load(f)
    res: dict = {}
    for name, case in cases.items():
        mesh = (hier_global_mesh(case["intra"], "cpu") if case["intra"]
                else global_mesh("cpu"))
        tr = _gbdt_trainer(case["cfg"], mesh)
        trees, margins = tr.train(case["bins"], case["y"], **case["train"])
        res[name] = {"trees": _numpy_trees(trees),
                     "margins": margins.numpy(),
                     "eval_history": list(tr.eval_history_),
                     "shape": mesh.shape, "n_local": mesh.n_local}
    # the folded sums themselves (histograms, then leaf sums), one tree on
    # the (world, 2) mesh: the rank order holds bit for bit
    from ytk_mp4j_tpu_torch.models import gbdt

    real, folds = gbdt._fold_across, []

    def record(*args):
        out = real(*args)
        folds.append(out.numpy())
        return out

    gbdt._fold_across = record
    try:
        case = cases["hier"]
        _gbdt_trainer(case["cfg"], hier_global_mesh(2, "cpu")).train(
            case["bins"], case["y"], n_trees=1)
    finally:
        gbdt._fold_across = real
    res["hier_folds"] = folds
    # train(comm=): the round stats synced over the comm, overlap off/on
    case = cases["squared"]
    for flag in ("0", "1"):
        os.environ["MP4J_OVERLAP"] = flag
        tr = _gbdt_trainer(case["cfg"], global_mesh("cpu"))
        trees, margins = tr.train(case["bins"], case["y"], comm=comm,
                                  eval_set=(case["bins"][:64],
                                            case["y"][:64]))
        res["overlap", flag] = {"trees": _numpy_trees(trees),
                                "margins": margins.numpy(),
                                "sync": tr.sync_round_history_}
    # every rank saves; only rank 0 writes
    tr = _gbdt_trainer(case["cfg"], global_mesh("cpu"))
    trees, _ = tr.train(case["bins"], case["y"])
    tr.save_model(str(out / f"model_rank{comm.rank}.npz"), trees)
    comm.barrier()                      # every rank's save has returned
    res["saved"] = sorted(p.name for p in out.glob("model_rank*.npz"))
    comm.close(0)
    return res


def scenario_binning(comm, out: Path) -> dict:
    """``fit_distributed`` on the shards the test process wrote
    (``binning_data.pkl``): unweighted and weighted edges, a config
    mismatch, and ``train_raw(comm=)`` on replicated and on per-rank
    weighted data."""
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.exceptions import Mp4jError
    from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

    with open(out.parent / "binning_data.pkl", "rb") as f:
        data = pickle.load(f)
    r, n = comm.rank, comm.slave_num
    shard = data["shards"][n][r]
    w = data["weights"][n][r]
    B = data["n_bins"]
    res = {
        "edges": QuantileBinner(B).fit_distributed(
            shard, comm, sample=None).edges,
        "edges_weighted": QuantileBinner(B).fit_distributed(
            shard, comm, sample=None, sample_weight=w).edges,
        "edges_missing": QuantileBinner(B, missing_bucket=True)
        .fit_distributed(shard, comm, sample=None).edges,
    }
    try:
        QuantileBinner(8 if r == 0 else 16).fit_distributed(
            shard, comm, sample=None)
        res["mismatch"] = None
    except Mp4jError as e:
        res["mismatch"] = str(e)
    X, y = data["raw_X"], data["raw_y"]
    cfg = GBDTConfig(n_features=X.shape[1], n_bins=8, depth=2, n_trees=2,
                     learning_rate=0.5)
    tr = GBDTTrainer(cfg, mesh=make_mesh(1, "cpu"))
    trees, _ = tr.train_raw(X, y, seed=2, comm=comm)
    res["train_raw_edges"] = tr.binner_.edges
    res["train_raw_predict"] = tr.predict_raw(X[:16], trees).numpy()
    res["train_raw_sync"] = tr.sync_round_history_
    ys = (shard[:, 0] > 0).astype(np.float32)
    cfg_w = GBDTConfig(n_features=shard.shape[1], n_bins=B, depth=2,
                       n_trees=2, learning_rate=0.5)
    tw = GBDTTrainer(cfg_w, mesh=make_mesh(1, "cpu"))
    tw.train_raw(shard, ys, seed=4, comm=comm, sample_weight=w)
    res["train_raw_weighted_edges"] = tw.binner_.edges
    comm.close(0)
    return res


SCENARIOS = {"comm": scenario_comm, "gbdt": scenario_gbdt,
             "binning": scenario_binning}


def main(argv) -> int:
    scenario, store, world, rank, out = argv
    import torch

    from ytk_mp4j_tpu_torch.comm.distributed import init_distributed

    torch.set_num_threads(1)
    comm = init_distributed(num_processes=int(world), process_id=int(rank),
                            init_method=f"file://{store}", device="cpu",
                            timeout=JOB_TIMEOUT_S / 2)
    out = Path(out)
    res = SCENARIOS[scenario](comm, out)
    with open(out / f"rank_{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
