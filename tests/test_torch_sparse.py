"""The port's sparse collectives (ytk_mp4j_tpu_torch/ops/sparse.py) against
the JAX package's (ytk_mp4j_tpu/ops/sparse.py) on the same member
buffers, over the cases of tests/test_sparse_ops.py. The reference runs
under ``shard_map`` on the 8-device CPU mesh of tests/conftest.py; the
port takes the members as the rows of ``[n, L, ...]`` tensors on the CPU.
Inputs are made by numpy from a seed and handed to both.

Every comparison is BITWISE (NaN equal to NaN): both sides concatenate
the members in rank order, sort stably and fold each segment in stream
order -- SUM, PROD, MAX, MIN, the custom operator's scan, integer and
float operands alike.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ytk_mp4j_tpu import meta as jmeta
from ytk_mp4j_tpu.operators import Operator as JOperator
from ytk_mp4j_tpu.operators import Operators as JOperators
from ytk_mp4j_tpu.ops import sparse as jsp
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu.utils.compat import shard_map
from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.ops import sparse as sp

OPS = ["SUM", "PROD", "MAX", "MIN"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """One intra-op thread for the module: the port's test shapes are
    tiny, and a pool of threads per xdist worker costs more in wake-ups
    than it computes (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _absmax_j(a, b):
    return jnp.where(jnp.abs(a) >= jnp.abs(b), a, b)


def _absmax_t(a, b):
    return torch.where(torch.abs(a) >= torch.abs(b), a, b)


def _ops(name):
    """(reference operator, port operator) of one name; "ABSMAX" is a
    custom operator, "MAX*" a custom operator NAMED like the builtin."""
    if name == "ABSMAX":
        return (JOperator.custom("ABSMAX", _absmax_j, 0.0),
                Operator.custom("ABSMAX", _absmax_t, 0.0))
    if name == "MAX*":
        return (JOperator.custom("MAX", _absmax_j, 0.0),
                Operator.custom("MAX", _absmax_t, 0.0))
    return JOperators.by_name(name), Operators.by_name(name)


def _stage(per_rank, vshape=(), dtype=np.float64, fill=0.0):
    """Per-rank (idx list, val list) -> SENTINEL-padded [n, L] buffers."""
    n = len(per_rank)
    L = max(1, max(len(i) for i, _ in per_rank))
    idx = np.full((n, L), sp.SENTINEL, dtype=np.int32)
    val = np.full((n, L) + vshape, fill, dtype=dtype)
    for r, (ii, vv) in enumerate(per_rank):
        for j, (i, v) in enumerate(zip(ii, vv)):
            idx[r, j] = i
            val[r, j] = v
    return idx, val


def _random_per_rank(rng, n, size, lo=1, hi=None, dtype=np.float64):
    per_rank = []
    for r in range(n):
        k = int(rng.integers(lo, hi or size))
        ii = sorted(rng.choice(size, k, replace=False).tolist())
        if np.dtype(dtype).kind == "f":
            vv = rng.standard_normal(k).astype(dtype).tolist()
        else:
            vv = rng.integers(-1000, 1000, k).tolist()
        per_rank.append((ii, vv))
    return per_rank


def _ref(fn, idx, val, replicated=True):
    """Run a reference member form ``fn(i, v)`` under shard_map over
    ``len(idx)`` devices; replicated outputs come back once, per-member
    outputs as [n, ...]."""
    mesh = jmake_mesh(idx.shape[0])
    out = P(None) if replicated else P("mp4j")

    @jax.jit
    @partial(shard_map, mesh=mesh, check_vma=False,
             in_specs=(P("mp4j"), P("mp4j")), out_specs=(out, out))
    def f(i, v):
        oi, ov = fn(i[0], v[0])
        return (oi, ov) if replicated else (oi[None], ov[None])

    return tuple(np.asarray(a) for a in f(idx, val))


def _port(idx, val):
    return torch.from_numpy(idx), torch.from_numpy(val)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _allreduce_both(idx, val, capacity, name):
    jop, op = _ops(name)
    want = _ref(lambda i, v: jsp.sparse_allreduce(i, v, capacity, jop,
                                                  "mp4j"), idx, val)
    oi, ov = sp.sparse_allreduce(*_port(idx, val), capacity, op)
    n = idx.shape[0]
    assert oi.shape == (n, capacity)
    for r in range(n):                     # every member holds the union
        _same(oi[r], want[0])
        _same(ov[r], want[1])
    return oi[0].numpy(), ov[0].numpy()


def test_sparse_allreduce_sum_union():
    per_rank = [([1, 5, 9], [1.0, 2.0, 3.0]),
                ([5, 7], [10.0, 20.0]),
                ([1, 9, 11], [100.0, 200.0, 300.0])]
    oi, ov = _allreduce_both(*_stage(per_rank), 8, "SUM")
    got = {int(i): float(v) for i, v in zip(oi, ov) if i != sp.SENTINEL}
    assert got == {1: 101.0, 5: 12.0, 7: 20.0, 9: 203.0, 11: 300.0}


def test_sparse_allreduce_exact_capacity():
    """The union fills capacity exactly: the SENTINEL segment's id equals
    capacity and must be dropped, not folded into the last slot."""
    per_rank = [([0, 1], [1.0, 2.0]), ([2, 3], [3.0, 4.0])]
    idx, val = _stage(per_rank)
    idx = np.concatenate([idx, np.full((2, 1), sp.SENTINEL, np.int32)], 1)
    val = np.concatenate([val, np.full((2, 1), 7.0)], 1)   # not identity
    oi, ov = _allreduce_both(idx, val, 4, "SUM")
    np.testing.assert_array_equal(oi, [0, 1, 2, 3])
    np.testing.assert_array_equal(ov, [1.0, 2.0, 3.0, 4.0])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_sparse_allreduce_operators_bitwise(op, n, rng):
    """Random unions over n members, capacity above and below the union
    (a capacity below it drops the runs past it, as the reference)."""
    per_rank = _random_per_rank(rng, n, 40)
    idx, val = _stage(per_rank, fill=float(
        JOperators.by_name(op).identity(np.float64)))
    union = len({i for ii, _ in per_rank for i in ii})
    for capacity in (64, max(1, union - 3)):
        _allreduce_both(idx, val, capacity, op)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_sparse_allreduce_dtypes_bitwise(op, dtype, rng):
    per_rank = _random_per_rank(rng, 4, 30, dtype=dtype)
    idx, val = _stage(per_rank, dtype=dtype, fill=JOperators.by_name(
        op).identity(np.dtype(dtype)))
    _allreduce_both(idx, val, 32, op)


def test_sparse_allreduce_float_sum_duplicate_heavy_bitwise(rng):
    """Many duplicates of a few keys: float SUM folds each segment in
    stream order on both sides, so the sums agree bitwise."""
    n, L = 8, 2000
    idx = rng.integers(0, 17, (n, L)).astype(np.int32)
    val = rng.standard_normal((n, L)).astype(np.float32)
    _allreduce_both(idx, val, 32, "SUM")


@pytest.mark.parametrize("name", ["ABSMAX", "MAX*"])
def test_sparse_allreduce_custom_operator(name):
    """A custom operator runs its own function through the generic
    segment reduction -- also when it is NAMED like a builtin."""
    per_rank = [([0, 2], [-5.0, 1.0]), ([0, 2], [3.0, -4.0]),
                ([7], [2.0])]
    oi, ov = _allreduce_both(*_stage(per_rank), 4, name)
    got = {int(i): float(v) for i, v in zip(oi, ov) if i != sp.SENTINEL}
    assert got == {0: -5.0, 2: -4.0, 7: 2.0}


def test_sparse_allreduce_custom_operator_random_bitwise(rng):
    per_rank = _random_per_rank(rng, 5, 25)
    _allreduce_both(*_stage(per_rank), 32, "ABSMAX")


@pytest.mark.parametrize("W", [2, jsp._MAX_SORT_PAYLOAD_COLS + 5])
def test_sparse_allreduce_vector_values(W, rng):
    """N-d values; past the reference's sort-payload cutoff its wide
    rows take argsort + gather, which orders them the same way."""
    per_rank = [([3], [rng.standard_normal(W)]),
                ([3, 1], [rng.standard_normal(W), rng.standard_normal(W)]),
                ([2, 3, 9], list(rng.standard_normal((3, W))))]
    idx, val = _stage(per_rank, vshape=(W,))
    for op in OPS:
        _allreduce_both(idx, val, 8, op)


def test_block_owner_matches_meta_and_reference():
    for size, n in ((10, 3), (8, 8), (7, 8), (100, 4), (5, 2)):
        codes = np.arange(size, dtype=np.int32)
        got = sp.block_owner(torch.from_numpy(codes), size, n).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jsp.block_owner(jnp.asarray(codes), size, n)))
        np.testing.assert_array_equal(
            got, [meta.owner_of(i, 0, size, n) for i in range(size)])
    codes = torch.tensor([sp.SENTINEL, -1, 10], dtype=torch.int32)
    np.testing.assert_array_equal(sp.block_owner(codes, 10, 4), [4, 4, 4])


@pytest.mark.parametrize("n,size,capacity", [(4, 20, 32), (8, 13, 16),
                                             (3, 7, 8)])
def test_sparse_reduce_scatter_matches_reference(n, size, capacity, rng):
    """Each member keeps exactly its block-owned share of the reduced
    union, packed ascending -- the reference's buffers bitwise."""
    per_rank = []
    for r in range(n):
        k = int(rng.integers(1, size))
        ii = sorted(rng.choice(size, k, replace=False).tolist())
        per_rank.append((ii, [float(r * 100 + i) for i in ii]))
    idx, val = _stage(per_rank)
    want = _ref(lambda i, v: jsp.sparse_reduce_scatter(
        i, v, capacity, size, JOperators.SUM, "mp4j"), idx, val,
        replicated=False)
    oi, ov = sp.sparse_reduce_scatter(*_port(idx, val), capacity, size)
    _same(oi, want[0])
    _same(ov, want[1])
    seen = {}
    for r in range(n):
        live = oi[r] != sp.SENTINEL
        for c in oi[r][live].tolist():
            assert jmeta.owner_of(c, 0, size, n) == r
            assert c not in seen
            seen[c] = r
    assert len(seen) == len({i for ii, _ in per_rank for i in ii})


def test_sparse_allgather_matches_reference():
    per_rank = [([5, 9], [1.0, 2.0]),
                ([1], [3.0]),
                ([5, 7], [4.0, 5.0])]   # 5 duplicates across members
    idx, val = _stage(per_rank)
    want = _ref(lambda i, v: jsp.sparse_allgather(i, v, "mp4j"), idx, val)
    oi, ov = sp.sparse_allgather(*_port(idx, val))
    assert oi.shape == (3, 6)
    for r in range(3):
        _same(oi[r], want[0])
        _same(ov[r], want[1])
    live = oi[0] != sp.SENTINEL
    pairs = list(zip(oi[0][live].tolist(), ov[0][live].tolist()))
    assert pairs == [(1, 3.0), (5, 1.0), (5, 4.0), (7, 5.0), (9, 2.0)]


def test_sparse_allgather_then_reduce_is_allreduce(rng):
    """The documented composition: allgather + segment_reduce_sorted ==
    sparse_allreduce, bitwise."""
    idx, val = _stage(_random_per_rank(rng, 4, 20))
    gi, gv = sp.sparse_allgather(*_port(idx, val))
    oi, ov = sp.segment_reduce_sorted(gi[0], gv[0], 16, Operators.SUM)
    ai, av = sp.sparse_allreduce(*_port(idx, val), 16)
    _same(oi, ai[0].numpy())
    _same(ov, av[0].numpy())


def test_sparse_to_dense_matches_reference():
    idx = np.array([0, 3, sp.SENTINEL, 9], dtype=np.int32)
    val = np.array([1.5, 2.5, 99.0, 7.0])
    for op in ("SUM", "MAX"):
        jop, pop = _ops(op)
        want = np.asarray(jsp.sparse_to_dense(jnp.asarray(idx),
                                              jnp.asarray(val), 5, jop))
        _same(sp.sparse_to_dense(*_port(idx, val), 5, pop), want)
    # member buffers [n, L] give one dense vector each
    idx2 = np.array([[0, 3], [4, sp.SENTINEL]], dtype=np.int32)
    val2 = np.array([[[1.0, 2.0], [3.0, 4.0]], [[5.0, 6.0], [8.0, 9.0]]])
    got = sp.sparse_to_dense(*_port(idx2, val2), 5)
    assert got.shape == (2, 5, 2)
    for r in range(2):
        _same(got[r], np.asarray(jsp.sparse_to_dense(
            jnp.asarray(idx2[r]), jnp.asarray(val2[r]), 5)))


def test_pad_to():
    idx = np.array([4, 2], dtype=np.int32)
    val = np.array([1.0, 2.0])
    pi, pv = sp.pad_to(*_port(idx, val), 5, Operators.PROD)
    ji, jv = jsp.pad_to(jnp.asarray(idx), jnp.asarray(val), 5,
                        JOperators.PROD)
    _same(pi, np.asarray(ji))
    _same(pv, np.asarray(jv))
    assert int(pi[4]) == sp.SENTINEL and float(pv[3]) == 1.0
    with pytest.raises(ValueError):
        sp.pad_to(*_port(idx, val), 1)


@pytest.mark.parametrize("W", [0, 1, 3, jsp._MAX_SORT_PAYLOAD_COLS + 2])
def test_sort_by_key_matches_reference(W, rng):
    """Stable: equal keys keep their order, payload rows follow them --
    through the reference's sort network and its wide-row fallback."""
    L = 64
    idx = rng.integers(0, 30, L).astype(np.int32)
    val = (rng.standard_normal(L) if W == 0
           else rng.standard_normal((L, W))).astype(np.float32)
    si, sv = sp.sort_by_key(*_port(idx, val))
    ji, jv = jax.jit(jsp.sort_by_key)(jnp.asarray(idx), jnp.asarray(val))
    _same(si, np.asarray(ji))
    _same(sv, np.asarray(jv))
    order = np.argsort(idx, kind="stable")
    _same(sv, val[order])


@pytest.mark.parametrize("op", OPS)
def test_segment_reduce_sorted_empty_segments_take_identity(op, rng):
    """A capacity past the union: the slots after it hold SENTINEL and
    the operator's identity (segment_max/min give it for an empty
    segment), as the reference's."""
    idx = np.sort(rng.integers(0, 6, 12)).astype(np.int32)
    for dtype in (np.float64, np.int32):
        val = (rng.standard_normal(12) * 10).astype(dtype)
        jop, pop = _ops(op)
        oi, ov = sp.segment_reduce_sorted(*_port(idx, val), 10, pop)
        ji, jv = jsp.segment_reduce_sorted(jnp.asarray(idx),
                                           jnp.asarray(val), 10, jop)
        _same(oi, np.asarray(ji))
        _same(ov, np.asarray(jv))
        tail = oi.numpy() == sp.SENTINEL
        assert tail.sum() == 10 - len(np.unique(idx))
        assert (ov.numpy()[tail] == pop.identity(np.dtype(dtype))).all()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.float64, np.int32])
def test_numpy_twins_match_reference(op, dtype, rng):
    """The host twins are copies: the same merges bitwise."""
    ufunc = Operators.by_name(op).np_fn
    ca = np.unique(rng.integers(0, 50, 20)).astype(np.int32)
    cb = np.unique(rng.integers(0, 50, 25)).astype(np.int32)
    va = (rng.standard_normal(ca.size) * 5).astype(dtype)
    vb = (rng.standard_normal(cb.size) * 5).astype(dtype)
    got = sp.np_merge_sorted_columns(ca, va, cb, vb, ufunc)
    want = jsp.np_merge_sorted_columns(ca, va, cb, vb, ufunc)
    for g, w in zip(got, want):
        _same(g, w)
    codes = np.concatenate([ca, cb])
    vals = np.concatenate([va, vb])
    for g, w in zip(sp.np_sort_columns(codes, vals),
                    jsp.np_sort_columns(codes, vals)):
        _same(g, w)
    empty = np.zeros(0, np.int32)
    for g, w in zip(sp.np_segment_reduce_sorted(empty, empty, ufunc),
                    jsp.np_segment_reduce_sorted(empty, empty, ufunc)):
        _same(g, w)


def test_sentinel_is_the_reference_s():
    assert sp.SENTINEL == int(jsp.SENTINEL) == np.iinfo(np.int32).max
