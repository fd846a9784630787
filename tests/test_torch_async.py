"""The nonblocking family of the port's ``GpuCommCluster`` (n members on
the CPU), mirroring tests/test_async.py:249 ``test_tpu_backend_conformance``.

``iallreduce`` / ``ireduce_scatter`` / ``iallgather`` / ``igather`` run
their blocking twin at once and return resolved futures: the in-place
results equal the twin's bit for bit, over DOUBLE / FLOAT / INT / LONG x
SUM / MAX / MIN / PROD. ``iallreduce_map`` is a ``DeferredFuture`` over
``allreduce_map_async``: not ``done()`` before ``wait()``, the blocking
twin's post-state after it. ``wait_all`` has nothing to drain. The futures
themselves (``completed_future``, ``DeferredFuture``) are held against the
reference's."""

import numpy as np
import pytest

from ytk_mp4j_tpu.comm import progress as jprogress
from ytk_mp4j_tpu_torch import GpuCommCluster, Operands, Operators
from ytk_mp4j_tpu_torch.comm import progress
from ytk_mp4j_tpu_torch.exceptions import Mp4jError

OPERANDS = (Operands.DOUBLE, Operands.FLOAT, Operands.INT, Operands.LONG)
OPS = (Operators.SUM, Operators.MAX, Operators.MIN, Operators.PROD)
TWINS = {"iallreduce": "allreduce_array",
         "ireduce_scatter": "reduce_scatter_array",
         "iallgather": "allgather_array", "igather": "gather_array"}


def _inputs(n, length, operand, rng):
    if np.dtype(operand.dtype).kind == "f":
        return [rng.standard_normal(length).astype(operand.dtype)
                for _ in range(n)]
    # values in {1, 2}: PROD over the members stays within every int width
    return [rng.integers(1, 3, length).astype(operand.dtype)
            for _ in range(n)]


def _run(cluster, name, arrs, operand, op):
    args = (arrs, operand) if name in ("iallgather", "igather",
                                       "allgather_array",
                                       "gather_array") else (arrs, operand,
                                                             op)
    return getattr(cluster, name)(*args)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(TWINS))
def test_dense_futures_equal_blocking_twins_bitwise(n, name):
    cluster = GpuCommCluster(n, device="cpu")
    rng = np.random.default_rng(11)
    for operand in OPERANDS:
        for op in OPS:
            data = _inputs(n, 400 + n, operand, rng)
            want = [d.copy() for d in data]
            _run(cluster, TWINS[name], want, operand, op)
            got = [d.copy() for d in data]
            fut = _run(cluster, name, got, operand, op)
            assert fut.done() and fut.op == TWINS[name]
            # the twin's result: the members' own arrays, written in place
            assert all(a is b for a, b in zip(fut.wait(), got))
            for r in range(n):
                np.testing.assert_array_equal(got[r], want[r])
            if name in ("iallgather", "igather"):
                break                          # no operator
    cluster.wait_all()


@pytest.mark.parametrize("n", [2, 3, 4])
def test_iallreduce_map_defers_until_wait(n):
    cluster = GpuCommCluster(n, device="cpu")
    maps_w = [{k: np.float64(r + k) for k in range(30 + r)}
              for r in range(n)]
    maps_g = [dict(m) for m in maps_w]
    cluster.allreduce_map(maps_w, Operands.DOUBLE, Operators.SUM)
    fut = cluster.iallreduce_map(maps_g, Operands.DOUBLE, Operators.SUM)
    assert isinstance(fut, progress.DeferredFuture)
    assert not fut.done()                      # the decode waits for wait()
    got = fut.wait()
    assert all(a is b for a, b in zip(got, maps_g))
    assert fut.done() and maps_g == maps_w
    assert fut.wait() is got                   # resolved once
    cluster.wait_all()
    # chained: every future resolves to its own maps
    chains = [[{k * (c + 1): 1.0 for k in range(8)} for _ in range(n)]
              for c in range(3)]
    futs = [cluster.iallreduce_map(m) for m in chains]
    for c, f in enumerate(futs):
        assert f.wait()[0] == {k * (c + 1): float(n) for k in range(8)}


def test_future_failures_are_delivered_at_wait():
    cluster = GpuCommCluster(2, device="cpu")
    fut = cluster.iallreduce([np.zeros(3, np.float32)], Operands.FLOAT)
    assert fut.done()
    assert isinstance(fut.exception(), Mp4jError)
    with pytest.raises(Mp4jError):
        fut.wait()
    # a map is encoded when it is posted, as the reference's is: a bad
    # value raises at the call
    with pytest.raises(Mp4jError, match="castable"):
        cluster.iallreduce_map([{"a": 1.0}, {"b": "x"}], Operands.DOUBLE)


def test_futures_match_the_reference():
    """``completed_future`` and ``DeferredFuture`` behave as the
    reference's: a resolved value, and a function run once at the first
    wait, its failure re-raised."""
    for mod in (progress, jprogress):
        done = mod.completed_future("allreduce_array", 7)
        assert done.done() and done.wait() == 7
        assert done.op == "allreduce_array"
        calls = []
        lazy = mod.DeferredFuture("allreduce_map",
                                  lambda: calls.append(1) or len(calls))
        assert not lazy.done() and calls == []
        assert lazy.result() == 1 and lazy.wait() == 1 and calls == [1]

        def boom():
            raise ValueError("no")

        failing = mod.DeferredFuture("allreduce_map", boom)
        assert isinstance(failing.exception(), ValueError)
        with pytest.raises(ValueError):
            failing.wait()
