"""The port's multi-process plane (``ytk_mp4j_tpu_torch/comm/distributed.py``)
against the numpy oracle and the JAX package's ``DistributedComm``, on the
CPU.

The 1-rank fallback and the backend rules run in this process. The
collectives run in real jobs of P = 2 and 3 processes over gloo
(``torch_dist_worker.run_job``: fresh interpreters, a ``file://`` store
under the test's temporary directory, a deadline that kills every rank):
one job per world size, whose results many tests assert. Tolerances are
``checkdist.check``'s: exact for integer operands, rtol 1e-5 for floats
(the backend all-reduce sums in its own order; every other path folds in
rank order, as the oracle does)."""

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu.comm.distributed import DistributedComm as JaxComm
from ytk_mp4j_tpu.operands import Operands as JOperands
from ytk_mp4j_tpu.operators import Operators as JOperators
from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.check._oracle import expected_reduce, rank_data
from ytk_mp4j_tpu_torch.comm import distributed as D
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators

from torch_dist_worker import (LENGTH, SEED_BASE, absmax, run_job,
                               uneven_ranges)

WORLDS = (2, 3)
OPERANDS = ("DOUBLE", "FLOAT", "INT", "LONG")
OPERATORS = ("SUM", "MAX", "MIN", "PROD", "CUSTOM")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{world: [rank results]} of the ``comm`` scenario."""
    tmp = tmp_path_factory.mktemp("dist")
    return {w: run_job("comm", w, tmp) for w in WORLDS}


def _inputs(world, operand):
    op = getattr(Operands, operand)
    return [rank_data(q, LENGTH, op, SEED_BASE) for q in range(world)]


def _reduce(alls, op_name):
    if op_name == "CUSTOM":
        acc = alls[0].copy()
        for a in alls[1:]:
            acc = absmax(acc, a)
        return acc
    return expected_reduce(alls, op_name)


def _same(got, want, operand):
    if np.dtype(getattr(Operands, operand).dtype).kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# in this process: the 1-rank comm and the backend rules
# ----------------------------------------------------------------------
def test_single_rank_fallback_matches_reference():
    """Without a process group both packages' comms are one rank and every
    collective leaves its buffer as it was."""
    port, ref = D.DistributedComm("cpu"), JaxComm()
    assert (port.rank, port.slave_num) == (ref.rank, ref.slave_num) == (0, 1)
    assert port.backend is None
    base = np.arange(7, dtype=np.float64)
    for method, args in (("allreduce_array", (Operators.SUM,)),
                         ("reduce_array", (Operators.MAX,)),
                         ("broadcast_array", ()),
                         ("reduce_scatter_array", (Operators.PROD,)),
                         ("allgather_array", ()), ("gather_array", ()),
                         ("scatter_array", ())):
        a, b = base.copy(), base.copy()
        getattr(port, method)(a, Operands.DOUBLE, *args)
        jargs = tuple(getattr(JOperators, x.name) for x in args)
        getattr(ref, method)(b, JOperands.DOUBLE, *jargs)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, base)
    d, e = {"a": 1.0, 3: 2.0}, {"a": 1.0, 3: 2.0}
    port.allreduce_map(d)
    ref.allreduce_map(e)
    assert d == e == {"a": 1.0, 3: 2.0}
    assert port.iallreduce(base.copy(), Operands.DOUBLE).wait().tolist() == \
        base.tolist()
    port.barrier()
    port.close(3)
    ref.close(3)
    assert port.final_code == ref.final_code == 3
    with pytest.raises(Mp4jError, match="closed"):
        port.allreduce_array(base.copy(), Operands.DOUBLE)


def test_backend_rules():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert D.resolve_backend(cpu, None) == "gloo"
    assert D.resolve_backend(cuda, None) == "nccl"
    assert D.resolve_backend(cuda, "gloo") == "gloo"  # only when asked
    assert D.resolve_backend(cuda, "nccl") == "nccl"
    with pytest.raises(Mp4jError, match="NCCL needs a CUDA device"):
        D.resolve_backend(cpu, "nccl")
    with pytest.raises(Mp4jError, match="backend must be one of"):
        D.resolve_backend(cpu, "mpi")


def test_init_refuses_before_any_rendezvous(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(Mp4jError, match="NCCL needs a CUDA device"):
        D.init_distributed(num_processes=2, process_id=0, init_method=store,
                           backend="nccl", device="cpu")
    with pytest.raises(Mp4jError, match="not both"):
        D.init_distributed("localhost:1", 2, 0, init_method=store,
                           device="cpu")
    with pytest.raises(Mp4jError, match="num_processes and process_id"):
        D.init_distributed(init_method=store, process_id=0, device="cpu")
    with pytest.raises(Mp4jError, match="outside"):
        D.init_distributed(num_processes=2, process_id=2, init_method=store,
                           device="cpu")
    assert not D.initialized()
    assert not (tmp_path / "store").exists()


def test_init_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        D.init_distributed()
    comm = D.init_distributed(device="cpu")
    assert (comm.rank, comm.slave_num, comm.device.type) == (0, 1, "cpu")


def test_comm_default_device_is_the_card(monkeypatch):
    """``DistributedComm()`` takes the current CUDA device, as the other
    entry points do: without CUDA it raises unless given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        D.DistributedComm()
    assert D.DistributedComm("cpu").device == torch.device("cpu")


def test_global_mesh_without_a_job_is_one_process():
    assert D.global_mesh("cpu") == make_mesh(1, "cpu")
    m = D.hier_global_mesh(2, "cpu")
    assert (m.n, m.shape, m.group, m.first, m.n_local) == (2, (1, 2), None,
                                                          0, 2)
    with pytest.raises(Mp4jError, match="intra"):
        D.hier_global_mesh(0, "cpu")


# ----------------------------------------------------------------------
# P gloo processes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op_name", OPERATORS)
@pytest.mark.parametrize("operand", OPERANDS)
def test_allreduce_matches_oracle(jobs, world, operand, op_name):
    alls = _inputs(world, operand)
    want = _reduce(alls, op_name)
    for res in jobs[world]:
        _same(res["allreduce", operand, op_name], want, operand)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op_name", OPERATORS)
@pytest.mark.parametrize("operand", OPERANDS)
def test_reduce_writes_only_the_root(jobs, world, operand, op_name):
    alls = _inputs(world, operand)
    want = _reduce(alls, op_name)
    for r, res in enumerate(jobs[world]):
        got = res["reduce", operand, op_name]
        if r == world - 1:
            _same(got, want, operand)
        else:
            np.testing.assert_array_equal(got, alls[r])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op_name", OPERATORS)
@pytest.mark.parametrize("operand", OPERANDS)
def test_reduce_scatter_even_and_uneven(jobs, world, operand, op_name):
    alls = _inputs(world, operand)
    want = _reduce(alls, op_name)
    for kind, ranges in (("reduce_scatter",
                          meta.partition_range(0, LENGTH, world)),
                         ("reduce_scatter_uneven", uneven_ranges(world))):
        for r, res in enumerate(jobs[world]):
            got = res[kind, operand, op_name]
            s, e = ranges[r]
            _same(got[s:e], want[s:e], operand)
            outside = np.ones(LENGTH, bool)
            outside[s:e] = False
            np.testing.assert_array_equal(got[outside], alls[r][outside])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("operand", OPERANDS)
def test_ranges_touch_only_their_span(jobs, world, operand):
    alls = _inputs(world, operand)
    for r, res in enumerate(jobs[world]):
        got = res["allreduce_range", operand]
        _same(got[5:-3], expected_reduce(alls, "SUM")[5:-3], operand)
        np.testing.assert_array_equal(got[:5], alls[r][:5])
        np.testing.assert_array_equal(got[-3:], alls[r][-3:])
        got = res["reduce_range", operand]
        want = alls[r].copy()
        if r == 0:
            want[3:11] = expected_reduce(alls, "MAX")[3:11]
        np.testing.assert_array_equal(got, want)
        got = res["broadcast_range", operand]
        want = alls[r].copy()
        want[4:9] = alls[0][4:9]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("operand", OPERANDS)
def test_gather_family(jobs, world, operand):
    alls = _inputs(world, operand)
    for ranges, suffix, groot, sroot in (
            (meta.partition_range(0, LENGTH, world), "", 0, world - 1),
            (uneven_ranges(world), "_uneven", world - 1, 0)):
        full = alls[0].copy()
        for q, (s, e) in enumerate(ranges):
            full[s:e] = alls[q][s:e]
        for r, res in enumerate(jobs[world]):
            got = res["allgather" + suffix, operand]
            for q, (s, e) in enumerate(ranges):
                np.testing.assert_array_equal(got[s:e], alls[q][s:e])
            got = res["gather" + suffix, operand]
            if r == groot:
                for q, (s, e) in enumerate(ranges):
                    np.testing.assert_array_equal(got[s:e], alls[q][s:e])
            else:
                np.testing.assert_array_equal(got, alls[r])
            got = res["scatter" + suffix, operand]
            s, e = ranges[r]
            want = alls[r].copy()
            want[s:e] = alls[sroot][s:e]
            np.testing.assert_array_equal(got, want)
        for res in jobs[world]:
            np.testing.assert_array_equal(res["broadcast", operand],
                                          alls[world - 1])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("operand", OPERANDS)
def test_futures_equal_blocking_twins(jobs, world, operand):
    for res in jobs[world]:
        np.testing.assert_array_equal(res["i", "allreduce", operand],
                                      res["allreduce", operand, "SUM"])
        np.testing.assert_array_equal(res["i", "reduce_scatter", operand],
                                      res["reduce_scatter", operand, "MAX"])
        np.testing.assert_array_equal(res["i", "allgather", operand],
                                      res["allgather", operand])
        np.testing.assert_array_equal(res["i", "gather", operand],
                                      res["gather", operand])
        assert res["i", "failure"] == "Mp4jError"   # delivered at wait()


def _keyed(q, world):
    return {f"k{(q + j) % (world + 1)}": float(q * 10 + j) for j in range(3)}


def _merge(maps, fn):
    out: dict = {}
    for m in maps:
        for k, v in m.items():
            out[k] = fn(out[k], v) if k in out else v
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_map_reductions(jobs, world):
    maps = [_keyed(q, world) for q in range(world)]
    sums = _merge(maps, lambda a, b: a + b)
    for r, res in enumerate(jobs[world]):
        assert res["map", "allreduce_sum"] == sums
        assert res["map", "allreduce_max"] == _merge(maps, max)
        assert res["map", "allreduce_prod"] == _merge(maps,
                                                      lambda a, b: a * b)
        assert res["map", "reduce"] == (sums if r == world - 1 else maps[r])
        assert res["map", "reduce_scatter"] == {
            k: v for k, v in sums.items() if meta.key_partition(k, world) == r}
        assert res["map", "int_values"] == {k: int(v)
                                            for k, v in sums.items()}
        got = res["map", "vector"]
        assert got.keys() == sums.keys()
        for k, v in sums.items():
            np.testing.assert_allclose(got[k], np.full(3, v, np.float32),
                                       rtol=1e-6)
        assert res["map", "iallreduce"] == sums
        assert res["map", "after_reset"] == sums
        assert res["codecs_after_reset"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_map_placement_family(jobs, world):
    everyone = {f"r{q}": float(q) for q in range(world)}
    src = {f"s{j}": float(j) for j in range(9)}
    for r, res in enumerate(jobs[world]):
        assert res["map", "allgather"] == everyone
        assert res["map", "gather"] == (everyone if r == 0
                                        else {f"r{r}": float(r)})
        assert res["map", "broadcast"] == _keyed(world - 1, world)
        assert res["map", "scatter"] == {
            k: v for k, v in src.items() if meta.key_partition(k, world) == r}


@pytest.mark.parametrize("world", WORLDS)
def test_map_object_values_and_custom_operators(jobs, world):
    plus = [{k: (1.0 + v) * (-1.0 if q % 2 else 1.0)
             for k, v in _keyed(q, world).items()} for q in range(world)]
    want_abs = _merge(plus, lambda a, b: a if abs(a) > abs(b) else b)
    want_obj = dict({"s": "".join(f"<{q}>" for q in range(world))},
                    **{f"only{q}": [q] for q in range(world)})
    for res in jobs[world]:
        assert res["map", "custom"] == want_abs
        assert res["map", "object"] == want_obj


@pytest.mark.parametrize("world", WORLDS)
def test_map_drifting_keys_share_one_vocabulary(jobs, world):
    seen = {7 * q for q in range(1, world)}
    for step in range(3):
        maps = [{int(q * 5 + j + 3 * step): float(q * 10 + j)
                 for j in range(4)} for q in range(world)]
        want = _merge(maps, lambda a, b: a + b)
        seen |= want.keys()
        for res in jobs[world]:
            assert res["map", "drift", step] == want
    for res in jobs[world]:
        assert res["map", "empty_rank"] == {7 * q: 1.0
                                            for q in range(1, world)}
        assert res["codec_size"] == len(seen)


@pytest.mark.parametrize("world", WORLDS)
def test_map_faults_raise_on_every_rank(jobs, world):
    for res in jobs[world]:
        assert "key kinds differ" in res["err", "mixed_kinds"]
        assert "share a shape" in res["err", "vshape"]
        assert "invalid on some rank" in res["err", "bad_value"]
        assert "duplicate key 'dup'" in res["err", "duplicate"]
        # and the comm still works afterwards
        assert res["map", "after_errors"] == _merge(
            [_keyed(q, world) for q in range(world)], lambda a, b: a + b)


@pytest.mark.parametrize("world", WORLDS)
def test_step_stats_exchanger_blocking_equals_overlap(jobs, world):
    """``StepStatsExchanger``: the job-wide means of every step, the same
    under ``overlap`` (the eager i* twins) as blocking."""
    want = np.array([[sum(q + s for q in range(world)) / world, 1.0]
                     for s in range(3)])
    want_maps = [dict({"loss": sum(q * s for q in range(world)) / world},
                      **{f"r{q}": 1.0 / world for q in range(world)})
                 for s in range(3)]
    for res in jobs[world]:
        for overlap in (False, True):
            arrays, maps = res["stats", overlap]
            np.testing.assert_allclose(arrays, want, rtol=1e-12)
            assert maps == want_maps
        np.testing.assert_array_equal(res["stats", True][0],
                                      res["stats", False][0])


@pytest.mark.parametrize("world", WORLDS)
def test_close_aggregates_the_codes(jobs, world):
    # rank r closes with code r: every rank learns the job's worst
    assert [res["final_code"] for res in jobs[world]] == [world - 1] * world
