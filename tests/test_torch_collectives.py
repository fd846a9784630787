"""The port's dense collective plane (ytk_mp4j_tpu_torch: GpuCommCluster,
ops/collectives.py, ops/ring.py, operators, operands, meta, make_mesh)
against the JAX package's TpuCommCluster on the 8-device CPU mesh, over
the cases of tests/test_tpu_collectives.py:40-329, tests/test_operators.py
and tests/test_meta.py. The port runs with device="cpu"; every input is
made by numpy from a seed and handed to both.

Tolerances: results are BITWISE equal wherever both sides fold in the
same order or the operator is exact -- integers, MAX/MIN, PROD (both
fold the same pairwise tree), every algo="ring"/"rdma" result (same ring
schedule), and bf16 on small integers. f32/f64 SUM under algo="xla" is
the reference's psum against the port's rank-order fold: rtol 1e-5,
atol 1e-6 (the reference test's own) for f32, 1e-12 for f64; bf16 PROD
of values up to 3^8 rounds at other steps: rtol 2^-7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from helpers import expected_reduce, make_inputs
from ytk_mp4j_tpu import meta as jmeta
from ytk_mp4j_tpu.comm.tpu_comm import TpuCommCluster
from ytk_mp4j_tpu.operands import Operands as JOperands
from ytk_mp4j_tpu.operators import Operator as JOperator
from ytk_mp4j_tpu.operators import Operators as JOperators
from ytk_mp4j_tpu.ops import ring as jring
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch import (GpuCommCluster, Operand, Operands, Operator,
                                Operators, meta)
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operands import to_numpy, to_tensor
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import ring as ring_ops

OPS = ["SUM", "PROD", "MAX", "MIN"]
ALGOS = ["xla", "ring", "rdma"]


@pytest.fixture(scope="module")
def cluster():
    return GpuCommCluster(8, device="cpu")


@pytest.fixture(scope="module")
def cluster5():
    return GpuCommCluster(5, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return TpuCommCluster()


@pytest.fixture(scope="module")
def ref5():
    return TpuCommCluster(5)


def _joperand(operand):
    return getattr(JOperands, operand.name)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def assert_match(got, want, operand, op="SUM", algo="ring"):
    """Bitwise unless the fold orders legitimately differ (module doc)."""
    kind = operand.dtype.kind
    if kind == "f" and op == "SUM" and algo == "xla":
        tol = (dict(rtol=1e-5, atol=1e-6) if operand.dtype.itemsize == 4
               else dict(rtol=1e-12, atol=1e-12))
        np.testing.assert_allclose(got, want, **tol)
    elif kind == "V" and op == "PROD":
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=2 ** -7)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


def both(port, refc, method, arrs, operand, *args, **kw):
    """Run ``method`` on copies of ``arrs`` (layout kept) in both drivers."""
    a = [x.copy(order="K") for x in arrs]
    b = [x.copy(order="K") for x in arrs]
    getattr(port, method)(a, operand, *args, **kw)
    jargs = [_jop(x.name) if isinstance(x, Operator) else x for x in args]
    getattr(refc, method)(b, _joperand(operand), *jargs, **kw)
    return a, b


def _jop(name):
    return getattr(JOperators, name)


# ---- the driver, mirrored from tests/test_tpu_collectives.py ------------
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("operand", Operands.NUMERIC, ids=lambda o: o.name)
def test_allreduce_all_types(cluster, ref, operand, op, rng):
    arrs = make_inputs(cluster.n, 100, operand, rng)
    want = expected_reduce(arrs, op)
    a, b = both(cluster, ref, "allreduce_array", arrs, operand,
                Operators.by_name(op))
    for x, y in zip(a, b):
        assert_match(x, y, operand, op, "xla")
        if operand.dtype.kind == "i":
            np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("op", ["SUM", "MAX"])
@pytest.mark.parametrize("operand", [Operands.FLOAT, Operands.DOUBLE,
                                     Operands.INT, Operands.BYTE],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("algo", ["ring", "rdma"])
def test_allreduce_algos_match_reference_algos(cluster, ref, algo, operand,
                                               op, rng):
    """The port's ring schedule and ring kernel fold as the reference's
    ppermute ring and Pallas kernel do: bitwise."""
    arrs = make_inputs(cluster.n, 37, operand, rng)       # 37: pads
    a = [x.copy() for x in arrs]
    b = [x.copy() for x in arrs]
    cluster.allreduce_array(a, operand, Operators.by_name(op), algo=algo)
    ref.allreduce_array(b, _joperand(operand), _jop(op), algo=algo)
    for x, y in zip(a, b):
        assert_match(x, y, operand, op, algo)


@pytest.mark.parametrize("algo", ALGOS)
def test_allreduce_subrange(cluster, ref, algo, rng):
    operand = Operands.DOUBLE
    arrs = make_inputs(cluster.n, 50, operand, rng)
    a, b = both(cluster, ref, "allreduce_array", arrs, operand,
                Operators.SUM, from_=10, to=30, algo=algo)
    for x, y, o in zip(a, b, arrs):
        assert_match(x, y, operand, "SUM", algo)
        np.testing.assert_array_equal(x[:10], o[:10])
        np.testing.assert_array_equal(x[30:], o[30:])


@pytest.mark.parametrize("algo", ALGOS)
def test_allreduce_empty_range(cluster, algo, rng):
    arrs = make_inputs(cluster.n, 10, Operands.FLOAT, rng)
    orig = [a.copy() for a in arrs]
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM, from_=4,
                            to=4, algo=algo)
    for a, o in zip(arrs, orig):
        np.testing.assert_array_equal(a, o)


@pytest.mark.parametrize("algo", ALGOS)
def test_allreduce_nonpow2(cluster5, ref5, algo, rng):
    operand = Operands.DOUBLE
    arrs = make_inputs(5, 33, operand, rng)
    a, b = both(cluster5, ref5, "allreduce_array", arrs, operand,
                Operators.SUM, algo=algo)
    want = expected_reduce(arrs, "SUM")
    for x, y in zip(a, b):
        assert_match(x, y, operand, "SUM", algo)
        np.testing.assert_allclose(x, want)


@pytest.mark.parametrize("root", [0, 3])
def test_reduce(cluster, ref, root, rng):
    operand = Operands.DOUBLE
    arrs = make_inputs(cluster.n, 40, operand, rng)
    a, b = both(cluster, ref, "reduce_array", arrs, operand, Operators.SUM,
                root=root)
    assert_match(a[root], b[root], operand, "SUM", "xla")
    for r in range(cluster.n):
        if r != root:
            np.testing.assert_array_equal(a[r], arrs[r])


@pytest.mark.parametrize("root", [0, 2])
def test_broadcast(cluster, ref, root, rng):
    operand = Operands.FLOAT
    arrs = make_inputs(cluster.n, 31, operand, rng)
    a, b = both(cluster, ref, "broadcast_array", arrs, operand, root=root)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, arrs[root])


def test_broadcast_subrange(cluster, ref, rng):
    operand = Operands.INT
    arrs = make_inputs(cluster.n, 20, operand, rng)
    a, b = both(cluster, ref, "broadcast_array", arrs, operand, root=1,
                from_=5, to=15)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("algo", ALGOS)
def test_allgather(cluster, ref, algo, rng):
    operand = Operands.DOUBLE
    arrs = make_inputs(cluster.n, 45, operand, rng)   # uneven over 8
    a, b = both(cluster, ref, "allgather_array", arrs, operand, algo=algo)
    want = np.zeros(45)
    for r, (s, e) in enumerate(meta.partition_range(0, 45, cluster.n)):
        want[s:e] = arrs[r][s:e]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, want)


def test_gather(cluster, ref, rng):
    operand = Operands.LONG
    arrs = make_inputs(cluster.n, 37, operand, rng)
    a, b = both(cluster, ref, "gather_array", arrs, operand, root=2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_scatter(cluster, ref, rng):
    operand = Operands.FLOAT
    arrs = make_inputs(cluster.n, 43, operand, rng)
    a, b = both(cluster, ref, "scatter_array", arrs, operand, root=1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("op", ["SUM", "MAX", "PROD"])
def test_reduce_scatter(cluster, ref, op, algo, rng):
    operand = Operands.DOUBLE
    arrs = make_inputs(cluster.n, 53, operand, rng)   # uneven
    a, b = both(cluster, ref, "reduce_scatter_array", arrs, operand,
                Operators.by_name(op), algo=algo)
    want = expected_reduce(arrs, op)
    for r, (s, e) in enumerate(meta.partition_range(0, 53, cluster.n)):
        assert_match(a[r], b[r], operand, op, algo)
        np.testing.assert_allclose(a[r][s:e], want[s:e], rtol=1e-12)


@pytest.mark.parametrize("algo", ALGOS)
def test_segment_collectives_take_uneven_ranges(cluster5, ref5, algo, rng):
    """Explicit uneven ranges (one empty) through reduce-scatter and
    allgather at n=5."""
    operand = Operands.FLOAT
    ranges = [(0, 7), (7, 7), (7, 20), (20, 21), (21, 30)]
    arrs = make_inputs(5, 30, operand, rng)
    for method, args in (("reduce_scatter_array", (Operators.SUM,)),
                         ("allgather_array", ())):
        a = [x.copy() for x in arrs]
        b = [x.copy() for x in arrs]
        getattr(cluster5, method)(a, operand, *args, ranges=ranges,
                                  algo=algo)
        jargs = (JOperators.SUM,) if args else ()
        getattr(ref5, method)(b, JOperands.FLOAT, *jargs, ranges=ranges,
                              algo=algo)
        for x, y in zip(a, b):
            assert_match(x, y, operand, "SUM", algo)


@pytest.mark.parametrize("algo", ["xla", "ring"])
def test_custom_operator_allreduce(cluster, ref, algo, rng):
    absmax = Operator.custom(
        "ABSMAX", lambda x, y: torch.where(x.abs() >= y.abs(), x, y), 0.0)
    jabsmax = JOperator.custom(
        "ABSMAX", lambda x, y: jnp.where(jnp.abs(x) >= jnp.abs(y), x, y),
        0.0)
    operand = Operands.DOUBLE
    arrs = make_inputs(cluster.n, 64, operand, rng)
    a = [x.copy() for x in arrs]
    b = [x.copy() for x in arrs]
    cluster.allreduce_array(a, operand, absmax, algo=algo)
    ref.allreduce_array(b, JOperands.DOUBLE, jabsmax, algo=algo)
    stacked = np.stack(arrs)
    want = stacked[np.abs(stacked).argmax(0), np.arange(64)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, want)


def test_custom_operator_under_rdma_names_the_ring_algo(cluster, rng):
    """Intended divergence (the reference interprets the custom op inside
    its kernel; the CUDA kernel cannot run a Python function)."""
    absmax = Operator.custom(
        "ABSMAX", lambda x, y: torch.where(x.abs() >= y.abs(), x, y), 0.0)
    arrs = make_inputs(cluster.n, 8, Operands.DOUBLE, rng)
    orig = [a.copy() for a in arrs]
    with pytest.raises(Mp4jError, match='algo="ring"'):
        cluster.allreduce_array(arrs, Operands.DOUBLE, absmax, algo="rdma")
    for a, o in zip(arrs, orig):
        np.testing.assert_array_equal(a, o)


@pytest.mark.parametrize("operand", [Operands.STRING,
                                     Operands.OBJECT_OPERAND()],
                         ids=lambda o: o.name)
def test_host_only_operand_rejected(cluster, operand):
    with pytest.raises(Mp4jError, match="host-only"):
        cluster.allreduce_array([None] * cluster.n, operand, Operators.SUM)


def test_barrier(cluster):
    cluster.barrier()  # must simply complete


def test_wrong_rank_count(cluster):
    with pytest.raises(Mp4jError):
        cluster.allreduce_array([np.zeros(3, np.float32)] * (cluster.n - 1),
                                Operands.FLOAT, Operators.SUM)


def test_buffers_must_be_numpy_of_the_operand(cluster):
    with pytest.raises(Mp4jError, match="numpy"):
        cluster.allreduce_array([[0.0, 1.0]] * cluster.n, Operands.DOUBLE)
    with pytest.raises(Mp4jError, match="does not match"):
        cluster.allreduce_array([np.zeros(3)] * cluster.n, Operands.FLOAT)
    with pytest.raises(Mp4jError, match="share a shape"):
        cluster.allreduce_array([np.zeros(3)] * (cluster.n - 1)
                                + [np.zeros(4)], Operands.DOUBLE)


def test_range_checks(cluster, rng):
    arrs = make_inputs(cluster.n, 10, Operands.FLOAT, rng)
    with pytest.raises(Mp4jError, match="out of bounds"):
        cluster.allreduce_array(arrs, Operands.FLOAT, from_=4, to=11)
    with pytest.raises(Mp4jError, match="1-D"):
        cluster.allreduce_array([np.zeros((2, 2), np.float32)] * cluster.n,
                                Operands.FLOAT, from_=1, to=2)
    with pytest.raises(Mp4jError, match="contiguous"):
        cluster.allgather_array(
            arrs, Operands.FLOAT,
            ranges=[(0, 1), (2, 3)] + [(3, 3)] * (cluster.n - 2))
    with pytest.raises(Mp4jError, match="need 8 ranges"):
        cluster.reduce_scatter_array(arrs, Operands.FLOAT,
                                     ranges=[(0, 10)])


@pytest.mark.parametrize("bad_root", [-1, 99])
def test_bad_root_rejected(cluster, bad_root, rng):
    arrs = make_inputs(cluster.n, 5, Operands.FLOAT, rng)
    orig = [a.copy() for a in arrs]
    for call in (
        lambda: cluster.broadcast_array(arrs, Operands.FLOAT, root=bad_root),
        lambda: cluster.reduce_array(arrs, Operands.FLOAT, Operators.SUM,
                                     root=bad_root),
        lambda: cluster.gather_array(arrs, Operands.FLOAT, root=bad_root),
        lambda: cluster.scatter_array(arrs, Operands.FLOAT, root=bad_root),
    ):
        with pytest.raises(Mp4jError):
            call()
    for a, o in zip(arrs, orig):
        np.testing.assert_array_equal(a, o)


def test_noncontiguous_2d_allreduce(cluster, ref, rng):
    """Fortran-ordered 2-D inputs still receive results (copyto path)."""
    arrs = [np.asfortranarray(rng.standard_normal((4, 3)))
            for _ in range(cluster.n)]
    a, b = both(cluster, ref, "allreduce_array", arrs, Operands.DOUBLE,
                Operators.SUM)
    for x, y in zip(a, b):
        assert x.flags.f_contiguous
        np.testing.assert_allclose(x, y, rtol=1e-12)


@pytest.mark.parametrize("algo", ["ring", "rdma"])
def test_allreduce_algo_equivalence(cluster, algo, rng):
    operand = Operands.FLOAT
    for op_name in ("SUM", "MAX"):
        arrs = make_inputs(cluster.n, 37, operand, rng)   # 37: pads
        want = [a.copy() for a in arrs]
        cluster.allreduce_array(want, operand, Operators.by_name(op_name))
        got = [a.copy() for a in arrs]
        cluster.allreduce_array(got, operand, Operators.by_name(op_name),
                                algo=algo)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("algo", ["ring", "rdma"])
def test_reduce_scatter_algo_equivalence(cluster, algo, rng):
    operand = Operands.FLOAT
    arrs = make_inputs(cluster.n, 41, operand, rng)
    want = [a.copy() for a in arrs]
    cluster.reduce_scatter_array(want, operand, Operators.SUM)
    got = [a.copy() for a in arrs]
    cluster.reduce_scatter_array(got, operand, Operators.SUM, algo=algo)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("algo", ["ring", "rdma"])
def test_allgather_algo_equivalence(cluster, algo, rng):
    operand = Operands.FLOAT
    arrs = make_inputs(cluster.n, 29, operand, rng)
    want = [a.copy() for a in arrs]
    cluster.allgather_array(want, operand)
    got = [a.copy() for a in arrs]
    cluster.allgather_array(got, operand, algo=algo)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_algo_validation(cluster, rng):
    arrs = make_inputs(cluster.n, 8, Operands.FLOAT, rng)
    with pytest.raises(Mp4jError, match="algo must be"):
        cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM,
                                algo="bogus")
    a = [x.copy() for x in arrs]
    b = [x.copy() for x in arrs]
    cluster.allreduce_array(a, Operands.FLOAT, algo="auto")
    cluster.allreduce_array(b, Operands.FLOAT, algo="xla")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_cluster_device_is_cuda_unless_asked(monkeypatch):
    assert GpuCommCluster(3, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        GpuCommCluster(3)
    with pytest.raises(Mp4jError, match="n >= 1"):
        GpuCommCluster(0, device="cpu")


# ---- the functional layer and the ring schedule --------------------------
def _jax_per_member(fn, n, data):
    @jax.jit
    def f(x):
        return jax.shard_map(lambda v: fn(v[0])[None], mesh=jmake_mesh(n),
                             in_specs=P("mp4j"), out_specs=P("mp4j"),
                             check_vma=False)(x)
    return np.asarray(f(jnp.asarray(data)))


@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("op", ["SUM", "PROD", "MAX"])
def test_ring_schedule_matches_reference(n, op, rng):
    """ops/ring.py against the reference's ppermute ring: bitwise."""
    data = rng.standard_normal((n, 3 * n)).astype(np.float32)
    x = torch.from_numpy(data)
    port_op, jop = Operators.by_name(op), _jop(op)
    np.testing.assert_array_equal(
        ring_ops.ring_reduce_scatter(x, port_op).numpy(),
        _jax_per_member(lambda v: jring.ring_reduce_scatter(v, jop, "mp4j"),
                        n, data))
    np.testing.assert_array_equal(
        ring_ops.ring_allreduce(x, port_op).numpy(),
        _jax_per_member(lambda v: jring.ring_allreduce(v, jop, "mp4j"), n,
                        data))
    np.testing.assert_array_equal(
        ring_ops.ring_allgather(x).numpy(),
        _jax_per_member(lambda v: jring.ring_allgather(v, "mp4j"), n, data))


def test_ring_schedule_rejects_indivisible():
    with pytest.raises(Mp4jError, match="divisible"):
        ring_ops.ring_reduce_scatter(torch.ones(3, 7))


@pytest.mark.parametrize("n", [1, 4, 5])
def test_functional_collectives(n, rng):
    data = rng.standard_normal((n, 2 * n)).astype(np.float64)
    x = torch.from_numpy(data)
    want = data.sum(0)
    for row in coll.allreduce(x).numpy():
        np.testing.assert_allclose(row, want, rtol=1e-12)
    np.testing.assert_allclose(coll.reduce(x, root=n - 1)[n - 1].numpy(),
                               want, rtol=1e-12)
    for row in coll.broadcast(x, root=n - 1).numpy():
        np.testing.assert_array_equal(row, data[n - 1])
    for row in coll.allgather(x).numpy():
        np.testing.assert_array_equal(row, data.reshape(-1))
    assert coll.allgather(x, tiled=False).shape == (n, n, 2 * n)
    np.testing.assert_array_equal(coll.gather(x)[0].numpy(),
                                  data.reshape(-1))
    np.testing.assert_array_equal(coll.scatter(x, root=0).numpy(),
                                  data[0].reshape(n, 2))
    np.testing.assert_allclose(coll.reduce_scatter(x).numpy(),
                               want.reshape(n, 2), rtol=1e-12)
    coll.barrier("cpu")


def test_functional_tree_order_matches_reference(rng):
    """PROD folds the reference's pairwise tree: bitwise at n = 5, where
    the tree and a left fold differ."""
    data = (rng.standard_normal((5, 64)) * 3).astype(np.float32)
    got = coll.allreduce(torch.from_numpy(data), Operators.PROD)[0].numpy()
    from ytk_mp4j_tpu.ops import collectives as jcoll
    want = _jax_per_member(lambda v: jcoll.allreduce(v, JOperators.PROD,
                                                     "mp4j"), 5, data)[0]
    np.testing.assert_array_equal(got, want)
    assert coll.NATIVE == {"SUM", "MAX", "MIN"}


def test_functional_block_checks():
    with pytest.raises(Mp4jError, match="divisible"):
        coll.scatter(torch.ones(3, 4))
    with pytest.raises(Mp4jError, match="divisible"):
        coll.reduce_scatter(torch.ones(3, 4))


def test_make_mesh():
    m = make_mesh(4, "cpu")
    assert m.n == 4 and m.device == torch.device("cpu")
    for bad in (0, -1, 2.0):
        with pytest.raises(Mp4jError):
            make_mesh(bad, "cpu")


# ---- core types, mirrored from tests/test_operators.py and test_meta.py --
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("operand", Operands.NUMERIC, ids=lambda o: o.name)
def test_identity_equals_reference(op, operand):
    port = Operators.by_name(op).identity(operand.dtype)
    want = _jop(op).identity(operand.dtype)
    assert port.dtype == want.dtype
    np.testing.assert_array_equal(_bits(np.asarray(port)),
                                  _bits(np.asarray(want)))
    # the torch-dtype form is the same number
    t = Operators.by_name(op).identity(operand.torch_dtype)
    assert float(np.asarray(want).astype(np.float64)) == float(t)
    x = np.array([3, 1, 2], dtype=operand.dtype)
    np.testing.assert_array_equal(
        Operators.by_name(op).np_fn(np.full_like(x, port), x), x)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("operand", Operands.NUMERIC, ids=lambda o: o.name)
def test_torch_fn_matches_numpy(op, operand, rng):
    """torch_fn keeps the dtype (wrap, bf16 rounding) and equals np_fn."""
    if operand.dtype.kind in "fV":
        a = rng.standard_normal(257).astype(operand.dtype)
        b = rng.standard_normal(257).astype(operand.dtype)
    else:
        a = rng.integers(-120, 120, 257).astype(operand.dtype)
        b = rng.integers(-120, 120, 257).astype(operand.dtype)
    o = Operators.by_name(op)
    got = to_numpy(o.torch_fn(to_tensor(a, "cpu"), to_tensor(b, "cpu")))
    want = o.np_fn(a, b)
    assert got.dtype == operand.dtype
    if operand.dtype.kind == "V":     # numpy's bf16 ufuncs round once too
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=2 ** -7)
    else:
        np.testing.assert_array_equal(got, want)


def test_custom_operator():
    absmax = Operator.custom(
        "ABSMAX", lambda x, y: np.where(np.abs(x) >= np.abs(y), x, y), 0.0)
    a = np.array([-5.0, 1.0, 2.0])
    b = np.array([3.0, -4.0, -1.0])
    np.testing.assert_array_equal(absmax(a, b), [-5.0, -4.0, 2.0])
    assert not absmax.is_builtin and absmax.kernel_code is None
    assert absmax.identity(np.float64) == 0.0
    assert all(Operators.by_name(o).is_builtin for o in OPS)


def test_by_name():
    assert Operators.by_name("sum") is Operators.SUM
    with pytest.raises(Mp4jError):
        Operators.by_name("nope")


def test_operands_match_reference():
    assert [o.name for o in Operands.NUMERIC] == [
        o.name for o in JOperands.NUMERIC]
    for o in Operands.NUMERIC:
        assert o.dtype == _joperand(o).dtype
        assert Operands.by_dtype(o.dtype) is o
        assert o.is_numeric
    for name in ("DOUBLE", "FLOAT", "INT", "LONG", "SHORT", "BYTE",
                 "STRING"):
        assert getattr(Operands, f"{name}_OPERAND")() is getattr(Operands,
                                                                 name)
    assert not Operands.OBJECT_OPERAND().is_numeric
    with pytest.raises(Mp4jError):
        Operands.by_dtype(np.complex64)
    with pytest.raises(Mp4jError, match="no dense-array form"):
        Operands.STRING.check_array(np.zeros(2))
    with pytest.raises(Mp4jError, match="no device dtype"):
        Operands.STRING.torch_dtype
    assert isinstance(Operands.FLOAT, Operand)


@pytest.mark.parametrize("operand", Operands.NUMERIC, ids=lambda o: o.name)
def test_to_tensor_round_trip(operand, rng):
    a = (rng.standard_normal(9) * 50).astype(operand.dtype)
    t = to_tensor(a, "cpu")
    assert t.dtype == operand.torch_dtype
    back = to_numpy(t)
    assert back.dtype == operand.dtype
    np.testing.assert_array_equal(_bits(back), _bits(a))


def test_meta_matches_reference():
    for length in (0, 1, 7, 16, 101):
        for parts in (1, 2, 3, 5, 8):
            assert meta.partition_sizes(length, parts) == \
                jmeta.partition_sizes(length, parts)
            assert meta.partition_range(5, 5 + length, parts) == \
                jmeta.partition_range(5, 5 + length, parts)
            assert meta.padded_block(length, parts) == \
                jmeta.padded_block(length, parts)
            for i in range(length):
                assert meta.owner_of(i, 0, length, parts) == \
                    jmeta.owner_of(i, 0, length, parts)
    for key in (0, 5, -3, 2 ** 40, np.int64(7), "w5", ("a", 1), True):
        for parts in (2, 3, 7):
            assert meta.key_partition(key, parts) == \
                jmeta.key_partition(key, parts)
    assert meta.check_partition_rank(2, 3, "k") == 2


@pytest.mark.parametrize("call", [
    lambda: meta.partition_sizes(4, 0),
    lambda: meta.partition_sizes(-1, 2),
    lambda: meta.partition_range(5, 4, 2),
    lambda: meta.owner_of(10, 0, 10, 2),
    lambda: meta.check_partition_rank(-1, 3, "k"),
    lambda: meta.padded_block(4, 0),
])
def test_meta_errors(call):
    with pytest.raises(Mp4jError):
        call()
