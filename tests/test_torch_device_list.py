"""The list form of the port's mesh (``make_mesh(n, devices=...)``: member
m a tensor of its own on ``devices[m]``, the reference's one member a
device) on the CPU, with ``devices=["cpu"] * n``, where every kernel
computes its plain version.

- The mesh against the reference's ``make_mesh`` / ``make_hier_mesh`` on
  the rig's 8 virtual CPU devices, and its refusals.
- Every ``ops/collectives`` function and the ``ops/ring`` schedules,
  list against packed: BITWISE (both fold in rank order on one device).
- The ring kernels' plain version over a list against the reference's
  Pallas ring kernels in interpret mode: BITWISE, as
  ``tests/test_torch_ring_kernel.py`` holds the packed form.
- ``GpuCommCluster(mesh=<list mesh>)`` against the packed cluster
  (bitwise) and against ``TpuCommCluster(mesh=make_mesh(n))`` for the
  dense and nonblocking families under every algo, at the tolerances of
  ``tests/test_torch_collectives.py`` (f32 SUM under ``xla``: rtol 1e-5,
  atol 1e-6; bitwise elsewhere), and the map family bitwise both
  (``tests/test_torch_list_trainers.py`` holds every method).
- ``GBDTTrainer`` over a list mesh: trees and margins bitwise the packed
  mesh's, and against the reference's ``make_mesh(4)`` as
  ``tests/test_torch_gbdt_mesh.py`` holds the packed form (trees equal,
  leaves and margins to rtol 1e-4, atol 1e-5).
- ``FMTrainer`` and ``LinearTrainer`` take a list mesh
  (``tests/test_torch_list_trainers.py`` holds them against the
  reference).
- ``checkgpu --devices``: the reference's 618 check names at n = 8, the
  packed battery's names, every part over the list.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch

import jax

from test_torch_map_collectives import assert_same_maps
from test_torch_gbdt import (ATOL, RTOL, _assert_clear_splits,
                             _assert_same_trees, _cfg_kwargs, _data)
from test_torch_ring_kernel import _jax
from ytk_mp4j_tpu.comm.tpu_comm import TpuCommCluster
from ytk_mp4j_tpu.models import gbdt as J
from ytk_mp4j_tpu.operands import Operands as JOperands
from ytk_mp4j_tpu.operators import Operators as JOperators
from ytk_mp4j_tpu.parallel import make_hier_mesh as jmake_hier_mesh
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch import GpuCommCluster, Operands, Operators
from ytk_mp4j_tpu_torch.check import checkgpu
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer
from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer
from ytk_mp4j_tpu_torch.models.linear import LinearConfig, LinearTrainer
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import ring as ring_ops
from ytk_mp4j_tpu_torch.ops import ring_kernel as rk

CPU = torch.device("cpu")
MEMBERS = (1, 2, 3, 4, 8)
OPS = ("SUM", "MAX", "MIN", "PROD")
DTYPES = (torch.float32, torch.float64, torch.int32)


def cpus(n):
    return ["cpu"] * n


def _members(rng, n, length, dt):
    """[n, length] seeded member rows of ``dt`` (small integers for the
    integer type, so PROD stays exact), and the same rows as a list."""
    if dt.is_floating_point:
        x = torch.from_numpy(rng.standard_normal((n, length))).to(dt)
    else:
        x = torch.from_numpy(rng.integers(-3, 4, (n, length))).to(dt)
    return x, [x[r].clone() for r in range(n)]


def _same(packed, listed):
    """A packed [n, ...] result and a list result, bitwise."""
    assert isinstance(listed, list) and len(listed) == len(packed)
    for r, t in enumerate(listed):
        assert t.device == CPU and t.dtype == packed.dtype
        assert torch.equal(t, packed[r]), r


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", MEMBERS)
def test_list_mesh_matches_the_reference_mesh(n):
    m = make_mesh(n, devices=cpus(8))
    ref = jmake_mesh(n, devices=jax.devices("cpu"))
    assert m.n == ref.devices.size == n and m.shape == (n,)
    assert m.devices == (CPU,) * n and m.device == CPU and m.is_list
    # member r is the reference's r-th device of the list it was given
    np.testing.assert_array_equal(
        np.vectorize(lambda d: d.id)(ref.devices), np.arange(n))


def test_list_hier_mesh_matches_the_reference_mesh():
    m = make_hier_mesh(2, 2, devices=cpus(4))
    ref = jmake_hier_mesh(2, 2, devices=jax.devices("cpu"))
    assert (m.n, m.shape, m.devices) == (4, (2, 2), (CPU,) * 4)
    assert tuple(ref.devices.shape) == m.shape
    np.testing.assert_array_equal(
        np.vectorize(lambda d: d.id)(ref.devices).reshape(-1), np.arange(4))
    assert not make_hier_mesh(2, 2, "cpu").is_list


def test_list_mesh_refusals(monkeypatch):
    with pytest.raises(Mp4jError, match="not both"):
        make_mesh(2, "cpu", devices=cpus(2))
    with pytest.raises(Mp4jError, match="from 3 devices"):
        make_mesh(4, devices=cpus(3))
    with pytest.raises(Mp4jError, match="from 1 devices"):
        make_hier_mesh(2, 2, devices=cpus(1))
    with pytest.raises(Mp4jError, match="list of devices"):
        make_mesh(2, devices="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        make_mesh(2, devices=["cpu", "cuda:7"])
    with pytest.raises(Mp4jError, match="no CUDA device"):
        make_mesh(1, devices=["cuda:7"])
    # the default stays one member on cuda:0, never the visible cards
    with pytest.raises(Mp4jError, match="no CUDA device"):
        make_mesh(2)


def test_list_mesh_is_cuda_or_cpu_not_both(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(Mp4jError, match="not both"):
        make_mesh(2, devices=["cpu", "cuda:0"])
    with pytest.raises(Mp4jError, match="cuda:7 requested"):
        make_mesh(2, devices=["cuda:0", "cuda:7"])


# ----------------------------------------------------------------------
# ops/collectives and ops/ring: the list against the packed form
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("n", MEMBERS)
def test_reductions_list_equal_packed(n, dt):
    rng = np.random.default_rng(10 + n)
    x, xs = _members(rng, n, 4 * n, dt)
    for name in OPS:
        op = Operators.by_name(name)
        once = coll.reduce_all(xs, op)
        assert once.device == CPU and torch.equal(once,
                                                  coll.reduce_all(x, op))
        _same(coll.allreduce(x, op), coll.allreduce(xs, op))
        _same(coll.reduce(x, op, n - 1), coll.reduce(xs, op, n - 1))
        _same(coll.reduce_scatter(x, op), coll.reduce_scatter(xs, op))


@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("n", MEMBERS)
def test_data_movement_list_equal_packed(n, dt):
    rng = np.random.default_rng(20 + n)
    x, xs = _members(rng, n, 2 * n, dt)
    for root in {0, n - 1}:
        _same(coll.broadcast(x, root), coll.broadcast(xs, root))
        _same(coll.scatter(x, root), coll.scatter(xs, root))
        _same(coll.gather(x, root), coll.gather(xs, root))
    for tiled in (True, False):
        _same(coll.allgather(x, tiled), coll.allgather(xs, tiled))
    blocks = x.reshape(n, n, 2)
    _same(coll.all_to_all(blocks), coll.all_to_all(list(blocks)))
    ranks = coll.flat_index(n, [CPU] * n)
    assert [int(r) for r in ranks] == coll.flat_index(n, CPU).tolist()
    coll.barrier([CPU] * n)


def test_custom_operator_takes_the_pairwise_tree_over_a_list():
    rng = np.random.default_rng(3)
    x, xs = _members(rng, 5, 7, torch.float64)
    custom = Operators.by_name("SUM").__class__.custom(
        "ABSMAX", lambda a, b: np.maximum(np.abs(a), np.abs(b)), 0.0,
        torch_fn=lambda a, b: torch.maximum(a.abs(), b.abs()))
    _same(coll.allreduce(x, custom), coll.allreduce(xs, custom))


def test_list_collective_refusals():
    with pytest.raises(Mp4jError, match="one shape"):
        coll.allreduce([torch.zeros(3), torch.zeros(4)])
    with pytest.raises(Mp4jError, match="n >= 1"):
        coll.reduce_all([])
    with pytest.raises(Mp4jError, match="not divisible"):
        coll.reduce_scatter([torch.zeros(5)] * 2)
    with pytest.raises(Mp4jError, match="all_to_all"):
        coll.all_to_all([torch.zeros(3, 2)] * 2)


@pytest.mark.parametrize("op", ["SUM", "MAX", "PROD"])
@pytest.mark.parametrize("n", MEMBERS)
def test_ring_schedules_list_equal_packed(n, op):
    rng = np.random.default_rng(30 + n)
    x, xs = _members(rng, n, 3 * n, torch.float32)
    operator = Operators.by_name(op)
    _same(ring_ops.ring_reduce_scatter(x, operator),
          ring_ops.ring_reduce_scatter(xs, operator))
    _same(ring_ops.ring_allgather(x), ring_ops.ring_allgather(xs))
    _same(ring_ops.ring_allreduce(x, operator),
          ring_ops.ring_allreduce(xs, operator))


# ----------------------------------------------------------------------
# the ring kernels' plain version over a list
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
@pytest.mark.parametrize("n", MEMBERS)
def test_ring_kernel_list_equals_packed(n, dt, bidir):
    rng = np.random.default_rng(40 + n)
    x, xs = _members(rng, n, 2 * n * 3 + 1, dt)
    for name in OPS:
        op = Operators.by_name(name)
        _same(rk.ring_allreduce_kernel(x, op, bidir, force_kernel=True),
              rk.ring_allreduce_kernel(xs, op, bidir, force_kernel=True))
        y, ys = x[:, :2 * n * 3], [t[:2 * n * 3] for t in xs]
        _same(rk.ring_reduce_scatter_kernel(y, op, bidir, force_kernel=True),
              rk.ring_reduce_scatter_kernel(ys, op, bidir,
                                            force_kernel=True))
    z, zs = x[:, :6], [t[:6] for t in xs]
    _same(rk.ring_allgather_kernel(z, bidir, force_kernel=True),
          rk.ring_allgather_kernel(zs, bidir, force_kernel=True))
    _same(rk.ring_allreduce_reference(x, bidirectional=bidir),
          rk.ring_allreduce_reference(xs, bidirectional=bidir))


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter",
                                  "allgather"])
@pytest.mark.parametrize("n", [3, 4])
def test_ring_kernel_list_matches_the_reference_kernel(n, mode, bidir):
    L = {"allreduce": 2 * n * 5 + 3, "reduce_scatter": 2 * n * 4,
         "allgather": 8}[mode]
    data = np.random.default_rng(50 + n).standard_normal(
        (n, L)).astype(np.float32)
    want = _jax(mode, n, data, "SUM", bidir)
    xs = [torch.from_numpy(data[r].copy()) for r in range(n)]
    fn = {"allreduce": rk.ring_allreduce_kernel,
          "reduce_scatter": rk.ring_reduce_scatter_kernel}.get(mode)
    got = (fn(xs, Operators.SUM, bidir) if fn is not None
           else rk.ring_allgather_kernel(xs, bidir))
    assert isinstance(got, list) and len(got) == n
    np.testing.assert_array_equal(np.stack([t.numpy() for t in got]),
                                  want.reshape(n, -1))


def test_ring_kernel_list_refusals():
    with pytest.raises(Mp4jError, match="share a length"):
        rk.ring_allreduce_kernel([torch.zeros(4), torch.zeros(5)])
    with pytest.raises(Mp4jError, match=r"list of n >= 1 \[L\]"):
        rk.ring_allreduce_kernel([torch.zeros(2, 2)] * 2)
    with pytest.raises(Mp4jError, match="custom operator"):
        custom = Operators.SUM.__class__.custom(
            "C", lambda a, b: a + b, 0.0, torch_fn=lambda a, b: a + b)
        rk.ring_allreduce_kernel([torch.zeros(4)] * 2, custom)
    one = [torch.arange(4.0)]
    out = rk.ring_allreduce_kernel(one)
    assert out == one and out is not one


# ----------------------------------------------------------------------
# GpuCommCluster over a list mesh
# ----------------------------------------------------------------------
ALGOS = ("auto", "xla", "ring", "rdma")
OPERANDS = (Operands.FLOAT, Operands.DOUBLE, Operands.INT)


def _inputs(n, length, operand, seed):
    rng = np.random.default_rng(seed)
    if operand.dtype.kind == "f":
        return [rng.standard_normal(length).astype(operand.dtype)
                for _ in range(n)]
    return [rng.integers(-50, 50, length).astype(operand.dtype)
            for _ in range(n)]


def _run(cl, method, arrs, operand, *args, **kw):
    got = [a.copy() for a in arrs]
    getattr(cl, method)(got, operand, *args, **kw)
    return got


def _run_ref(ref, method, arrs, operand, *args, **kw):
    args = [getattr(JOperators, a.name) if hasattr(a, "torch_fn") else a
            for a in args]
    got = [a.copy() for a in arrs]
    getattr(ref, method)(got, getattr(JOperands, operand.name), *args, **kw)
    return got


def _close(got, want, operand, exact):
    for a, b in zip(got, want):
        if exact or operand.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
        elif operand.dtype.itemsize == 4:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def clusters():
    """{n: (list cluster, packed cluster, the reference's cluster)}."""
    return {n: (GpuCommCluster(mesh=make_mesh(n, devices=cpus(n))),
                GpuCommCluster(n, device="cpu"),
                TpuCommCluster(mesh=jmake_mesh(n)))
            for n in (3, 4, 8)}


@pytest.mark.parametrize("operand", OPERANDS, ids=lambda o: o.name)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("n", [3, 4, 8])
def test_cluster_dense_family_over_a_list(clusters, n, algo, operand):
    lst, packed, ref = clusters[n]
    arrs = _inputs(n, 61, operand, 60 + n)
    for op in (Operators.SUM, Operators.MAX, Operators.PROD):
        for method, kw in (("allreduce_array", dict(algo=algo)),
                           ("reduce_scatter_array", dict(algo=algo))):
            got = _run(lst, method, arrs, operand, op, **kw)
            for a, b in zip(got, _run(packed, method, arrs, operand, op,
                                      **kw)):
                np.testing.assert_array_equal(a, b)
            exact = op.name != "SUM" or algo in ("ring", "rdma")
            _close(got, _run_ref(ref, method, arrs, operand, op, **kw),
                   operand, exact)
    for method, kw in (("allgather_array", dict(algo=algo)),
                       ("broadcast_array", dict(root=n - 1)),
                       ("gather_array", dict(root=1)),
                       ("scatter_array", dict(root=0))):
        got = _run(lst, method, arrs, operand, **kw)
        for a, b in zip(got, _run(packed, method, arrs, operand, **kw)):
            np.testing.assert_array_equal(a, b)
        _close(got, _run_ref(ref, method, arrs, operand, **kw), operand, True)
    got = _run(lst, "reduce_array", arrs, operand, Operators.MIN, root=2)
    _close(got, _run_ref(ref, "reduce_array", arrs, operand, Operators.MIN,
                         root=2), operand, True)


@pytest.mark.parametrize("algo", ALGOS)
def test_cluster_subrange_and_2d_over_a_list(clusters, algo):
    lst, packed, ref = clusters[4]
    arrs = _inputs(4, 50, Operands.DOUBLE, 7)
    got = _run(lst, "allreduce_array", arrs, Operands.DOUBLE,
               Operators.MAX, from_=5, to=33, algo=algo)
    _close(got, _run_ref(ref, "allreduce_array", arrs, Operands.DOUBLE,
                         Operators.MAX, from_=5, to=33, algo=algo),
           Operands.DOUBLE, True)
    two_d = [a.reshape(5, 10) for a in arrs]
    got = _run(lst, "allreduce_array", two_d, Operands.DOUBLE,
               Operators.SUM, algo=algo)
    for a, b in zip(got, _run(packed, "allreduce_array", two_d,
                              Operands.DOUBLE, Operators.SUM, algo=algo)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo", ALGOS)
def test_cluster_nonblocking_family_over_a_list(clusters, algo):
    lst, _, ref = clusters[4]
    arrs = _inputs(4, 40, Operands.FLOAT, 8)
    got = [a.copy() for a in arrs]
    lst.iallreduce(got, Operands.FLOAT, Operators.MAX, algo=algo).wait()
    want = _run_ref(ref, "allreduce_array", arrs, Operands.FLOAT,
                    Operators.MAX, algo=algo)
    _close(got, want, Operands.FLOAT, True)
    for method, twin, args in (
            ("ireduce_scatter", "reduce_scatter_array", (Operators.MIN,)),
            ("iallgather", "allgather_array", ()),
            ("igather", "gather_array", ())):
        got = [a.copy() for a in arrs]
        getattr(lst, method)(got, Operands.FLOAT, *args).wait()
        _close(got, _run_ref(ref, twin, arrs, Operands.FLOAT, *args),
               Operands.FLOAT, True)
    lst.wait_all()
    lst.barrier()


@pytest.mark.parametrize("n", [3, 4, 8])
def test_cluster_map_family_over_a_list(clusters, n):
    """Every map method over the list cluster: bitwise the packed
    cluster's and the reference's post-state."""
    lst, packed, ref = clusters[n]
    rng = np.random.default_rng(40 + n)
    maps = [{f"k{int(k)}": float(rng.standard_normal())
             for k in rng.integers(0, 3 * n, 6)} for _ in range(n)]
    disjoint = [{f"r{r}:{i}": float(r + i) for i in range(3)}
                for r in range(n)]
    for method, src, kw in (
            ("allreduce_map", maps, dict(operator=Operators.MAX)),
            ("reduce_map", maps, dict(root=n - 1)),
            ("reduce_scatter_map", maps, {}),
            ("allgather_map", disjoint, {}),
            ("gather_map", disjoint, dict(root=1)),
            ("broadcast_map", maps, dict(root=2)),
            ("scatter_map", maps, dict(root=0))):
        got = [[dict(m) for m in src] for _ in range(3)]
        jkw = dict(kw)
        if "operator" in jkw:
            jkw["operator"] = JOperators.MAX
        getattr(lst, method)(got[0], Operands.DOUBLE, **kw)
        getattr(packed, method)(got[1], Operands.DOUBLE, **kw)
        getattr(ref, method)(got[2], JOperands.DOUBLE, **jkw)
        assert_same_maps(got[0], got[1])
        assert_same_maps(got[0], got[2])
    got = [dict(m) for m in maps]
    lst.iallreduce_map(got, Operands.DOUBLE).wait()
    want = [dict(m) for m in maps]
    packed.allreduce_map_async(want, Operands.DOUBLE).result()
    assert_same_maps(got, want)


def test_cluster_mesh_arguments():
    cl = GpuCommCluster(mesh=make_hier_mesh(2, 2, devices=cpus(4)))
    assert cl.n == cl.slave_num == 4 and cl.device == CPU
    assert GpuCommCluster(4, mesh=make_mesh(4, devices=cpus(4))).n == 4
    assert GpuCommCluster(mesh=make_mesh(3, "cpu")).n == 3
    with pytest.raises(Mp4jError, match="not both"):
        GpuCommCluster(3, mesh=make_mesh(4, devices=cpus(4)))
    with pytest.raises(Mp4jError, match="not both"):
        GpuCommCluster(device="cpu", mesh=make_mesh(4, devices=cpus(4)))


# ----------------------------------------------------------------------
# GBDT over a list mesh
# ----------------------------------------------------------------------
N = 1001                      # uneven over 4 members: padding
SEED = 1                      # data whose splits all clear


def _trees_equal(a, b, loss):
    for ra, rb in zip(a, b):
        ra = ra if loss == "softmax" else (ra,)
        rb = rb if loss == "softmax" else (rb,)
        for ta, tb in zip(ra, rb):
            assert all(torch.equal(ta[k], tb[k]) for k in range(4))


@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
@pytest.mark.parametrize("mesh", ["flat4", "hier2x2"])
def test_gbdt_list_equals_packed_and_the_reference(mesh, loss):
    bins, y = _data(loss, seed=SEED, N=N)
    kw = _cfg_kwargs(loss)
    lst, packed = {
        "flat4": (make_mesh(4, devices=cpus(4)), make_mesh(4, "cpu")),
        "hier2x2": (make_hier_mesh(2, 2, devices=cpus(4)),
                    make_hier_mesh(2, 2, "cpu"))}[mesh]
    ptr = GBDTTrainer(GBDTConfig(**kw), mesh=lst)
    pt, pm = ptr.train(bins, y)
    qt, qm = GBDTTrainer(GBDTConfig(**kw), mesh=packed).train(bins, y)
    assert pm.shape == qm.shape == (1004,) + qm.shape[1:]
    assert torch.equal(pm, qm)
    _trees_equal(pt, qt, loss)
    jt, jm = J.GBDTTrainer(J.GBDTConfig(**kw),
                           mesh=jmake_mesh(4)).train(bins, y)
    _assert_clear_splits(ptr, bins, y, pt)
    _assert_same_trees(jt, pt, loss)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=RTOL,
                               atol=ATOL)


def test_gbdt_list_subsampled_draws_the_packed_masks():
    bins, y = _data("squared", seed=SEED, N=N)
    kw = _cfg_kwargs("squared", n_trees=4, subsample=0.7, colsample=0.6)
    w = np.random.default_rng(5).uniform(0.5, 1.5, N).astype(np.float32)
    lt, lm = GBDTTrainer(GBDTConfig(**kw),
                         mesh=make_mesh(4, devices=cpus(4))).train(
        bins, y, seed=3, sample_weight=w)
    pt, pm = GBDTTrainer(GBDTConfig(**kw), mesh=make_mesh(4, "cpu")).train(
        bins, y, seed=3, sample_weight=w)
    assert torch.equal(lm, pm)
    _trees_equal(lt, pt, "squared")
    _, other = GBDTTrainer(GBDTConfig(**kw),
                           mesh=make_mesh(4, devices=cpus(4))).train(
        bins, y, seed=4, sample_weight=w)
    assert not torch.equal(lm, other)


def test_gbdt_list_shard_data_places_members():
    bins, y = _data("squared", seed=SEED, N=N)
    tr = GBDTTrainer(GBDTConfig(**_cfg_kwargs("squared")),
                     mesh=make_mesh(4, devices=cpus(4)))
    dbins, dy, dpreds, dw = tr.shard_data(bins, y)
    packed = GBDTTrainer(GBDTConfig(**_cfg_kwargs("squared")),
                         mesh=make_mesh(4, "cpu")).shard_data(bins, y)
    for got, want in zip((dbins, dy, dpreds, dw), packed):
        assert isinstance(got, list) and len(got) == 4
        assert all(t.shape[0] == 251 and t.device == CPU for t in got)
        assert torch.equal(torch.cat(got), want)
    assert not dw[3][-3:].any() and dw[3][-4] == 1


def test_gbdt_list_train_raw_predict_and_eval_set():
    rng = np.random.default_rng(6)
    X = rng.standard_normal((N, 6)).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.standard_normal(N)).astype(np.float32)
    cfg = GBDTConfig(n_features=6, n_bins=16, depth=3, n_trees=3)
    va = (X[:200], y[:200])
    lst = GBDTTrainer(cfg, mesh=make_mesh(4, devices=cpus(4)))
    lt, lm = lst.train_raw(X, y, eval_set=va)
    pk = GBDTTrainer(cfg, mesh=make_mesh(4, "cpu"))
    pt, pm = pk.train_raw(X, y, eval_set=va)
    assert torch.equal(lm, pm)
    _trees_equal(lt, pt, "squared")
    assert lst.eval_history_ == pk.eval_history_
    assert torch.equal(lst.predict_raw(X, lt), pk.predict_raw(X, pt))
    np.testing.assert_array_equal(lst.predict_raw(X, lt).numpy(),
                                  lm[:N].numpy())


@pytest.mark.parametrize("trainer", ["fm_dense", "fm_sparse", "fm_sharded",
                                     "linear"])
def test_fm_and_linear_take_a_list_mesh(trainer):
    """Member m's rows go to its device as a tensor of its own; ``fit``
    returns member 0's parameters (the blocks for the sharded table) and
    equals the packed mesh's to rtol 1e-5."""
    rng = np.random.default_rng(9)
    feats = rng.integers(0, 8, (21, 2)).astype(np.int32)
    data = (feats, np.tile(np.arange(2, dtype=np.int32), (21, 1)),
            np.ones((21, 2), np.float32),
            (feats[:, 0] > 3).astype(np.float32))
    kw = {"fm_dense": {}, "fm_sparse": dict(sparse_grads=True),
          "fm_sharded": dict(sparse_grads=True,
                             table_sharding="sharded")}.get(trainer)

    def make(mesh):
        if kw is None:
            return LinearTrainer(LinearConfig(n_features=2), mesh=mesh)
        return FMTrainer(FMConfig(n_features=8, n_fields=2, k=2, max_nnz=2,
                                  model="ffm"), mesh=mesh, **kw)

    args = ((feats / 8).astype(np.float32), data[3]) if kw is None else data
    lst = make(make_mesh(3, devices=cpus(3)))
    shards = lst.shard_data(*args)
    assert all(isinstance(a, list) and len(a) == 3 for a in shards)
    assert all(t.shape[0] == 7 and t.device == CPU for a in shards
               for t in a)
    lp, ll = lst.fit(*args, n_steps=3)
    pp, pl = make(make_mesh(3, "cpu")).fit(*args, n_steps=3)
    np.testing.assert_allclose(ll, pl, rtol=1e-5, atol=1e-6)
    assert len(lst.replicas_) == 3
    if trainer == "fm_sharded":
        assert [b.shape[0] for b in lp[2]] == [6, 6, 6]
        np.testing.assert_allclose(lst.full_table(lp), pp[2][:16].numpy(),
                                   rtol=1e-5, atol=1e-6)
    else:
        for a, b in zip(lp, pp):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)


# ----------------------------------------------------------------------
# checkgpu over a list mesh
# ----------------------------------------------------------------------
def test_checkgpu_over_a_cpu_list_runs_the_reference_battery(tmp_path):
    from ytk_mp4j_tpu.check import checktpu

    out = tmp_path / "checkgpu.json"
    rc = checkgpu.main(["--devices", ",".join(cpus(8)), "--cpu-mesh-n",
                        "0", "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert got["ok"] and got["failures"] == [] and got["error"] is None
    assert got["n_members"] == 8 and got["devices"] == cpus(8)
    names = []
    orig = checktpu.Tally.expect

    def expect(self, name, got_, want, exact):
        names.append(name)
        return orig(self, name, got_, want, exact)

    checktpu.Tally.expect = expect
    try:
        ref = checktpu._run_battery(8, devices=jax.devices("cpu")[:8])
    finally:
        checktpu.Tally.expect = orig
    assert ref["ok"] and got["passed"] == ref["passed"] == 618
    assert Counter(got["checks"]) == Counter(names)
    assert "packed_parts" not in got
    # every part runs over the list: the packed battery's names
    packed = checkgpu._run_battery(8, device="cpu")
    assert packed["ok"] and got["checks"] == packed["checks"]
