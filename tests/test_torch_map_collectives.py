"""The port's map collectives (``GpuCommCluster.*_map``, n members on the
CPU) against the JAX package's ``TpuCommCluster`` on the 8-device CPU
mesh, over the device-path cases of tests/test_map_collectives.py and
tests/test_keycodec.py, on the same dicts made by numpy from a seed.

Tolerances: against a host dict merge, the reference's own (rtol 1e-9,
1e-12 for int keys); against the reference's results, BITWISE -- both
concatenate the members' (code, value) buffers in rank order, sort stably
and fold each key's values in that order. bf16 sums of small integers are
exact. The reference's ``cl._jits`` growth cases are about JAX compiles
and have no counterpart.
"""

import numpy as np
import pytest

from ytk_mp4j_tpu.comm.tpu_comm import TpuCommCluster
from ytk_mp4j_tpu.operands import Operands as JOperands
from ytk_mp4j_tpu.operators import Operators as JOperators
from ytk_mp4j_tpu_torch import GpuCommCluster, Operands, Operators, meta
from ytk_mp4j_tpu_torch.exceptions import Mp4jError

from test_torch_sparse import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

OPS = ["SUM", "PROD", "MAX", "MIN"]
MESHES = [1, 3, 4, 8]


@pytest.fixture(scope="module")
def cluster():
    return GpuCommCluster(4, device="cpu")


@pytest.fixture(scope="module")
def clusters():
    """(reference, port) clusters per member count, built once."""
    return {n: (TpuCommCluster(n), GpuCommCluster(n, device="cpu"))
            for n in MESHES}


def make_maps(n, rng, n_keys=20, fill=0.6, int_keys=False):
    keys = (list(range(0, 3 * n_keys, 3)) if int_keys
            else [f"feat:{i}" for i in range(n_keys)])
    maps = []
    for _ in range(n):
        maps.append({k: float(rng.standard_normal()) for k in keys
                     if rng.random() < fill})
    return maps


def expected_map_reduce(maps, op_name):
    ref = {"SUM": np.add, "PROD": np.multiply, "MAX": np.maximum,
           "MIN": np.minimum}[op_name]
    out = {}
    for m in maps:
        for k, v in m.items():
            out[k] = ref(out[k], v) if k in out else v
    return {k: float(v) for k, v in out.items()}


def assert_map_close(got, want, rtol=1e-9):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol)


def assert_same_maps(got, want):
    """Bitwise: the same keys, values of the same dtype and bits."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), (k, a, b)


def _both(clusters, n, method, maps, operand="DOUBLE", op=None, **kw):
    """Run one map collective on copies of ``maps`` in both packages
    (operand and operator by name); returns (reference maps, port
    maps)."""
    jcl, pcl = clusters[n]
    jm = [dict(m) for m in maps]
    pm = [dict(m) for m in maps]
    jargs = [getattr(JOperands, operand)]
    pargs = [getattr(Operands, operand)]
    if op is not None:
        jargs.append(JOperators.by_name(op))
        pargs.append(Operators.by_name(op))
    getattr(jcl, method)(jm, *jargs, **kw)
    getattr(pcl, method)(pm, *pargs, **kw)
    return jm, pm


# ------------------------------------------------------------ allreduce
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", MESHES)
def test_allreduce_map_matches_reference(clusters, op, n, rng):
    maps = make_maps(n, rng)
    want = expected_map_reduce(maps, op)
    jm, pm = _both(clusters, n, "allreduce_map", maps, op=op)
    for m in pm:
        assert_map_close(m, want)
    assert_same_maps(pm, jm)


@pytest.mark.parametrize("operand", ["FLOAT", "INT", "LONG"])
@pytest.mark.parametrize("op", ["SUM", "MAX"])
def test_allreduce_map_operands(clusters, operand, op, rng):
    """FLOAT, INT and LONG values, int keys (the ytk-learn gradient
    shape): bitwise equal to the reference."""
    dt = getattr(Operands, operand).dtype
    maps = [{int(k): (dt.type(v) if dt.kind == "f" else int(v))
             for k, v in zip(rng.integers(0, 400, 120),
                             rng.integers(-50, 50, 120))}
            for _ in range(4)]
    jm, pm = _both(clusters, 4, "allreduce_map", maps, operand, op)
    want = expected_map_reduce(maps, op)
    for m in pm:
        assert_map_close(m, want, rtol=1e-12)
        assert all(type(k) is int for k in m)
    assert_same_maps(pm, jm)


def test_allreduce_map_async_matches_sync(cluster, rng):
    """allreduce_map_async + result() leaves the maps in the synchronous
    post-state; chained dispatches stay independent; result() is
    idempotent; all-empty maps resolve to all-empty."""
    maps_a = make_maps(4, rng)
    maps_b = make_maps(4, rng, n_keys=35)
    sync_a = [dict(m) for m in maps_a]
    cluster.allreduce_map(sync_a, Operands.DOUBLE, Operators.SUM)
    want_b = expected_map_reduce(maps_b, "SUM")
    ha = cluster.allreduce_map_async(maps_a, Operands.DOUBLE, Operators.SUM)
    hb = cluster.allreduce_map_async(maps_b, Operands.DOUBLE, Operators.SUM)
    got_b = hb.result()
    got_a = ha.result()
    assert got_a is maps_a and got_b is maps_b   # in-place semantics
    assert_same_maps(maps_a, sync_a)
    for m in maps_b:
        assert_map_close(m, want_b)
    ha.result()
    assert_same_maps(maps_a, sync_a)
    empty = [{} for _ in range(4)]
    assert cluster.allreduce_map_async(empty).result() is empty
    assert all(m == {} for m in empty)


def test_reduce_map(clusters, rng):
    maps = make_maps(4, rng)
    want = expected_map_reduce(maps, "SUM")
    jm, pm = _both(clusters, 4, "reduce_map", maps, op="SUM",
                   root=2)
    assert_map_close(pm[2], want)
    for r in (0, 1, 3):
        assert pm[r] == maps[r]
    assert_same_maps(pm, jm)


@pytest.mark.parametrize("n", MESHES)
def test_reduce_scatter_map(clusters, n, rng):
    maps = make_maps(n, rng, n_keys=30)
    want = expected_map_reduce(maps, "SUM")
    jm, pm = _both(clusters, n, "reduce_scatter_map", maps,
                   op="SUM")
    seen = {}
    for r, m in enumerate(pm):
        for k, v in m.items():
            assert meta.key_partition(k, n) == r
            seen[k] = v
    assert_map_close(seen, want)
    assert_same_maps(pm, jm)


def test_allgather_map(clusters):
    maps = [{f"k{r}:{i}": float(i) for i in range(3)} for r in range(4)]
    union = {}
    for m in maps:
        union.update(m)
    jm, pm = _both(clusters, 4, "allgather_map", maps)
    for m in pm:
        assert m == union
    assert pm == jm


def test_allgather_map_dup_rejected(cluster):
    maps = [{"same": 1.0} for _ in range(4)]
    with pytest.raises(Mp4jError, match="duplicate key 'same'"):
        cluster.allgather_map(maps, Operands.DOUBLE)


def test_gather_scatter_broadcast_map(clusters):
    maps = [{f"k{r}:{i}": float(r * 10 + i) for i in range(2)}
            for r in range(4)]
    union = {}
    for m in maps:
        union.update(m)
    jm, gm = _both(clusters, 4, "gather_map", maps, root=1)
    assert gm[1] == union and gm[0] == maps[0] and gm == jm
    jm, bm = _both(clusters, 4, "broadcast_map", maps, root=3)
    assert all(m == maps[3] for m in bm) and bm == jm
    jm, sm = _both(clusters, 4, "scatter_map", maps, root=0)
    rebuilt = {}
    for r, m in enumerate(sm):
        for k, v in m.items():
            assert meta.key_partition(k, 4) == r
            rebuilt[k] = v
    assert rebuilt == maps[0] and sm == jm


def test_scatter_map_partitioner_override(cluster):
    N, T = 4, 2
    src = {f"k{i}": float(i) for i in range(12)}
    maps = [dict(src)] + [{"junk": 0.0} for _ in range(3)]
    cluster.scatter_map(maps, Operands.DOUBLE, root=0,
                        partitioner=lambda k: meta.key_partition(k, N) // T)
    rebuilt = {}
    for r, m in enumerate(maps):
        for k, v in m.items():
            assert meta.key_partition(k, N) // T == r
            rebuilt[k] = v
    assert rebuilt == src
    bad = [dict(src)] + [{} for _ in range(3)]
    with pytest.raises(Mp4jError, match="outside"):
        cluster.scatter_map(bad, Operands.DOUBLE, root=0,
                            partitioner=lambda k: 99)


def test_map_vector_values(clusters):
    maps = [{"a": np.array([1.0, 2.0]), "b": np.array([1.0, 1.0])},
            {"a": np.array([10.0, 20.0])},
            {"c": np.array([5.0, 5.0])},
            {}]
    jm, pm = _both(clusters, 4, "allreduce_map", maps, op="SUM")
    for m in pm:
        np.testing.assert_allclose(m["a"], [11.0, 22.0])
        np.testing.assert_allclose(m["b"], [1.0, 1.0])
        np.testing.assert_allclose(m["c"], [5.0, 5.0])
    assert_same_maps(pm, jm)


def test_map_bfloat16_values(clusters):
    """BFLOAT16 map values merge on the device path (small-int sums are
    exact in bf16) and come back as bf16 scalars, as the reference's."""
    maps = [{f"w{i}": float(i + r) for i in range(20)} for r in range(4)]
    want = {f"w{i}": sum(float(i + r) for r in range(4))
            for i in range(20)}
    jm, pm = _both(clusters, 4, "allreduce_map", maps, "BFLOAT16",
                   "SUM")
    for m in pm:
        assert set(m) == set(want)
        for k in want:
            assert float(m[k]) == want[k]
    assert_same_maps(pm, jm)


def test_empty_maps(cluster):
    maps = [{} for _ in range(4)]
    cluster.allreduce_map(maps, Operands.DOUBLE, Operators.SUM)
    assert all(m == {} for m in maps)
    for method in ("reduce_map", "reduce_scatter_map"):
        getattr(cluster, method)(maps, Operands.DOUBLE, Operators.SUM)
        assert all(m == {} for m in maps)


def test_mixed_value_shapes_rejected(cluster):
    maps = [{"a": 1.0}, {"b": np.ones(3)}, {}, {}]
    with pytest.raises(Mp4jError):
        cluster.allreduce_map(maps, Operands.DOUBLE, Operators.SUM)
    maps = [{"a": 1.0}, {"a": np.ones(1)}, {}, {}]
    with pytest.raises(Mp4jError, match="share"):
        cluster.allreduce_map(maps, Operands.DOUBLE, Operators.SUM)


def test_mixed_key_kinds_in_one_call_raise(cluster):
    with pytest.raises(Mp4jError):
        cluster.allreduce_map([{1: 1.0}, {"a": 1.0}, {}, {}],
                              Operands.DOUBLE, Operators.SUM)


def test_map_error_paths(cluster):
    with pytest.raises(Mp4jError, match="expected 4 per-rank maps"):
        cluster.allreduce_map([{}, {}], Operands.DOUBLE)
    with pytest.raises(Mp4jError, match="must be dicts"):
        cluster.allreduce_map([{}, {}, {}, [1.0]], Operands.DOUBLE)
    with pytest.raises(Mp4jError, match="host-only"):
        cluster.allreduce_map([{} for _ in range(4)], Operands.STRING)
    for method in ("reduce_map", "gather_map", "broadcast_map",
                   "scatter_map"):
        with pytest.raises(Mp4jError, match="root 4 out of range"):
            getattr(cluster, method)([{} for _ in range(4)],
                                     Operands.DOUBLE, root=4)


def test_drifting_key_counts(clusters, rng):
    """Key counts that drift from call to call (power-of-2 slot and
    capacity buckets on one cluster): every call equals a host merge and
    the reference."""
    for step in range(8):
        maps = make_maps(4, rng, n_keys=30 + 23 * step, fill=0.7)
        want = expected_map_reduce(maps, "SUM")
        jm, pm = _both(clusters, 4, "allreduce_map", maps, op="SUM")
        for m in pm:
            assert_map_close(m, want)
        assert_same_maps(pm, jm)


def test_reset_map_vocabularies():
    cl = GpuCommCluster(4, device="cpu")
    maps = [{f"epoch0:{i}": 1.0 for i in range(50)} for _ in range(4)]
    cl.allreduce_map(maps, Operands.DOUBLE, Operators.SUM)
    assert cl._codecs["obj"].size == 50
    cl.reset_map_vocabularies()
    assert "obj" not in cl._codecs
    maps = [{f"epoch1:{i}": 1.0 for i in range(30)} for _ in range(4)]
    cl.allreduce_map(maps, Operands.DOUBLE, Operators.SUM)
    assert cl._codecs["obj"].size == 30        # only live keys
    assert maps[0] == {f"epoch1:{i}": 4.0 for i in range(30)}
