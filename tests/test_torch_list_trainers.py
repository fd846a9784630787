"""The rest of the port over a list mesh (``make_mesh(n, devices=...)``:
member m a tensor of its own on ``devices[m]``, the reference's one member
a chip) on the CPU, with ``devices=["cpu"] * n``, where every member shares
the one device and so its storage: what would alias there, aliases here.

- ``ops.sparse``'s list form: BITWISE the packed form (both concatenate
  the members in rank order on one device, sort stably and fold in stream
  order) and the reference's ``ops/sparse.py`` under ``shard_map`` on
  ``make_mesh(n)`` (BITWISE, as ``tests/test_torch_sparse.py``), n in
  {1, 2, 3, 4}.
- The map family over ``GpuCommCluster(mesh=<list mesh>)``: BITWISE the
  packed cluster and ``TpuCommCluster(mesh=make_mesh(n))``, the host merge
  to rtol 1e-9 (``tests/test_torch_map_collectives.py``'s tolerances).
- ``FMTrainer`` (dense, sparse, sparse with a capacity, sharded; FM and
  FFM) and ``LinearTrainer`` (squared, logistic, softmax): losses and
  parameters against the reference's trainer on ``make_mesh(n)`` to rtol
  1e-5, atol 1e-6 (``tests/test_torch_fm.py`` / ``test_torch_linear.py``),
  against the packed port to rtol 1e-5, atol 1e-6 (the list folds each
  member's sums in rank order where the packed form takes one autograd
  pass over every member's rows: a rounding question); every member's
  replica bitwise member 0's; two runs bitwise; ``fit_stream`` of one
  full-batch chunk a step bitwise ``fit``.
- ``entry.dryrun(n, devices=...)`` for n = 4 (hierarchical) and 3 (flat).
"""

import threading

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu.comm.tpu_comm import TpuCommCluster
from ytk_mp4j_tpu.models.fm import FMConfig as JFMConfig
from ytk_mp4j_tpu.models.fm import FMTrainer as JFMTrainer
from ytk_mp4j_tpu.models.linear import LinearConfig as JLinearConfig
from ytk_mp4j_tpu.models.linear import LinearTrainer as JLinearTrainer
from ytk_mp4j_tpu.operators import Operators as JOperators
from ytk_mp4j_tpu.ops import sparse as jsp
from ytk_mp4j_tpu.parallel import make_hier_mesh as jmake_hier_mesh
from ytk_mp4j_tpu.parallel import make_mesh as jmake_mesh
from ytk_mp4j_tpu_torch import GpuCommCluster, Operands, Operators, entry
from ytk_mp4j_tpu_torch.comm.thread_comm import ThreadCommSlave
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models import fm as F
from ytk_mp4j_tpu_torch.models import linear as L
from ytk_mp4j_tpu_torch.ops import sparse as sp

from test_fm import make_sparse_classification
from test_linear import make_regression
from test_torch_map_collectives import (assert_map_close, assert_same_maps,
                                        expected_map_reduce, make_maps)
from test_torch_sparse import (_ops, _random_per_rank, _ref, _same, _stage,
                               few_threads)  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
OPS = ["SUM", "PROD", "MAX", "MIN"]


def cpus(n):
    return ["cpu"] * n


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ----------------------------------------------------------------------
# ops.sparse over member lists
# ----------------------------------------------------------------------
def _lists(idx, val):
    return ([torch.from_numpy(i.copy()) for i in idx],
            [torch.from_numpy(v.copy()) for v in val])


def _rows_are(listed, packed):
    """A list result: n tensors on the CPU, bitwise the packed rows."""
    assert isinstance(listed, list) and len(listed) == packed.shape[0]
    for r, t in enumerate(listed):
        assert t.device == CPU
        _same(t, _np(packed[r]))


@pytest.mark.parametrize("op", OPS + ["ABSMAX"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sparse_allreduce_list_bitwise(op, n, rng):
    """Capacities above and below the union; against the packed form and
    the reference's union, bitwise."""
    jop, pop = _ops(op)
    fill = 0.0 if op == "ABSMAX" else float(jop.identity(np.float64))
    per_rank = _random_per_rank(rng, n, 40)
    idx, val = _stage(per_rank, fill=fill)
    union = len({i for ii, _ in per_rank for i in ii})
    for capacity in (64, max(1, union - 3)):
        got = sp.sparse_allreduce(*_lists(idx, val), capacity, pop)
        packed = sp.sparse_allreduce(torch.from_numpy(idx),
                                     torch.from_numpy(val), capacity, pop)
        want = _ref(lambda i, v: jsp.sparse_allreduce(i, v, capacity, jop,
                                                      "mp4j"), idx, val)
        for g, p, w in zip(got, packed, want):
            _rows_are(g, p)
            for t in g:
                _same(t, w)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sparse_allreduce_list_vector_and_integer_values(n, rng):
    per_rank = [(sorted(rng.choice(20, int(rng.integers(1, 8)),
                                   replace=False).tolist()), None)
                for _ in range(n)]
    per_rank = [(ii, list(rng.standard_normal((len(ii), 3))))
                for ii, _ in per_rank]
    idx, val = _stage(per_rank, vshape=(3,), dtype=np.float32)
    got = sp.sparse_allreduce(*_lists(idx, val), 16)
    want = _ref(lambda i, v: jsp.sparse_allreduce(i, v, 16,
                                                  JOperators.SUM, "mp4j"),
                idx, val)
    for g, w in zip(got, want):
        for t in g:
            _same(t, w)
    ints = _stage(_random_per_rank(rng, n, 30, dtype=np.int64),
                  dtype=np.int64)
    got = sp.sparse_allreduce(*_lists(*ints), 32, Operators.MAX)
    packed = sp.sparse_allreduce(*map(torch.from_numpy, ints), 32,
                                 Operators.MAX)
    for g, p in zip(got, packed):
        _rows_are(g, p)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sparse_reduce_scatter_list_bitwise(n, rng):
    """Member m's share is computed on member m's device: its block-owned
    keys, the packed form's row m and the reference's, bitwise."""
    size, capacity = 20, 32
    per_rank = []
    for r in range(n):
        ii = sorted(rng.choice(size, int(rng.integers(1, size)),
                               replace=False).tolist())
        per_rank.append((ii, [float(r * 100 + i) for i in ii]))
    idx, val = _stage(per_rank)
    oi, ov = sp.sparse_reduce_scatter(*_lists(idx, val), capacity, size)
    pi, pv = sp.sparse_reduce_scatter(torch.from_numpy(idx),
                                      torch.from_numpy(val), capacity, size)
    want = _ref(lambda i, v: jsp.sparse_reduce_scatter(
        i, v, capacity, size, JOperators.SUM, "mp4j"), idx, val,
        replicated=False)
    _rows_are(oi, pi)
    _rows_are(ov, pv)
    _same(torch.stack(oi), want[0])
    _same(torch.stack(ov), want[1])


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sparse_allgather_and_to_dense_list_bitwise(n, rng):
    idx, val = _stage(_random_per_rank(rng, n, 15))
    gi, gv = sp.sparse_allgather(*_lists(idx, val))
    packed = sp.sparse_allgather(torch.from_numpy(idx),
                                 torch.from_numpy(val))
    want = _ref(lambda i, v: jsp.sparse_allgather(i, v, "mp4j"), idx, val)
    for g, p, w in zip((gi, gv), packed, want):
        _rows_are(g, p)
        _same(g[0], w)
    dense = sp.sparse_to_dense(*_lists(idx, val), 15, Operators.MAX)
    _rows_are(dense, sp.sparse_to_dense(torch.from_numpy(idx),
                                        torch.from_numpy(val), 15,
                                        Operators.MAX))
    for r in range(n):
        _same(dense[r], np.asarray(jsp.sparse_to_dense(
            idx[r], val[r], 15, JOperators.MAX)))


def test_sparse_list_of_unequal_members_raises():
    idx = [torch.zeros(3, dtype=torch.int32), torch.zeros(4,
                                                          dtype=torch.int32)]
    val = [torch.zeros(3), torch.zeros(4)]
    with pytest.raises(Mp4jError, match="one shape"):
        sp.sparse_allreduce(idx, val, 4)


# ----------------------------------------------------------------------
# the map family over GpuCommCluster(mesh=<list mesh>)
# ----------------------------------------------------------------------
MAP_MESHES = [1, 3, 4, 8]


@pytest.fixture(scope="module")
def clusters():
    """{n: (the reference's cluster, the list cluster, the packed one)}."""
    return {n: (TpuCommCluster(mesh=jmake_mesh(n)),
                GpuCommCluster(mesh=make_mesh(n, devices=cpus(n))),
                GpuCommCluster(n, device="cpu"))
            for n in MAP_MESHES}


def _three(clusters, n, method, maps, operand="DOUBLE", op=None, **kw):
    """One map collective on copies of ``maps`` through the reference's,
    the list and the packed cluster; the list's maps bitwise the other
    two's. Returns the list cluster's maps."""
    out = []
    for pkg, cl in zip(("ref", "list", "packed"), clusters[n]):
        ms = [dict(m) for m in maps]
        if pkg == "ref":
            from ytk_mp4j_tpu.operands import Operands as JOperands
            args = [getattr(JOperands, operand)]
            if op is not None:
                args.append(JOperators.by_name(op))
        else:
            args = [getattr(Operands, operand)]
            if op is not None:
                args.append(Operators.by_name(op))
        getattr(cl, method)(ms, *args, **kw)
        out.append(ms)
    assert_same_maps(out[1], out[0])
    assert_same_maps(out[1], out[2])
    return out[1]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", MAP_MESHES)
def test_allreduce_map_over_a_list(clusters, op, n, rng):
    maps = make_maps(n, rng)
    for m in _three(clusters, n, "allreduce_map", maps, op=op):
        assert_map_close(m, expected_map_reduce(maps, op))


@pytest.mark.parametrize("operand", ["FLOAT", "INT", "LONG"])
@pytest.mark.parametrize("op", ["SUM", "MAX"])
def test_allreduce_map_operands_over_a_list(clusters, operand, op, rng):
    dt = getattr(Operands, operand).dtype
    maps = [{int(k): (dt.type(v) if dt.kind == "f" else int(v))
             for k, v in zip(rng.integers(0, 400, 120),
                             rng.integers(-50, 50, 120))}
            for _ in range(4)]
    for m in _three(clusters, 4, "allreduce_map", maps, operand, op):
        assert_map_close(m, expected_map_reduce(maps, op), rtol=1e-12)


def test_allreduce_map_async_and_iallreduce_over_a_list(clusters, rng):
    """The async handle and ``iallreduce_map`` leave the synchronous
    post-state (the packed cluster's, bitwise); chained handles stay
    independent; all-empty maps resolve to all-empty."""
    _, lst, packed = clusters[4]
    maps_a, maps_b = make_maps(4, rng), make_maps(4, rng, n_keys=35)
    sync_a, sync_b = [dict(m) for m in maps_a], [dict(m) for m in maps_b]
    packed.allreduce_map(sync_a, Operands.DOUBLE, Operators.SUM)
    packed.allreduce_map(sync_b, Operands.DOUBLE, Operators.MAX)
    ha = lst.allreduce_map_async(maps_a, Operands.DOUBLE, Operators.SUM)
    fb = lst.iallreduce_map(maps_b, Operands.DOUBLE, Operators.MAX)
    fb.wait()
    assert ha.result() is maps_a
    assert_same_maps(maps_a, sync_a)
    assert_same_maps(maps_b, sync_b)
    empty = [{} for _ in range(4)]
    assert lst.allreduce_map_async(empty).result() is empty
    assert all(m == {} for m in empty)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_reduce_and_reduce_scatter_map_over_a_list(clusters, n, rng):
    from ytk_mp4j_tpu_torch import meta

    maps = make_maps(n, rng, n_keys=30)
    want = expected_map_reduce(maps, "SUM")
    got = _three(clusters, n, "reduce_map", maps, op="SUM", root=n - 1)
    assert_map_close(got[n - 1], want)
    assert all(got[r] == maps[r] for r in range(n - 1))
    seen = {}
    for r, m in enumerate(_three(clusters, n, "reduce_scatter_map", maps,
                                 op="PROD")):
        for k, v in m.items():
            assert meta.key_partition(k, n) == r
            seen[k] = v
    assert_map_close(seen, expected_map_reduce(maps, "PROD"))


def test_gather_family_over_a_list(clusters):
    maps = [{f"k{r}:{i}": float(r * 10 + i) for i in range(3)}
            for r in range(4)]
    union = {}
    for m in maps:
        union.update(m)
    assert all(m == union for m in _three(clusters, 4, "allgather_map",
                                          maps))
    assert _three(clusters, 4, "gather_map", maps, root=1)[1] == union
    assert all(m == maps[3] for m in _three(clusters, 4, "broadcast_map",
                                            maps, root=3))
    rebuilt = {}
    for m in _three(clusters, 4, "scatter_map", maps, root=0):
        rebuilt.update(m)
    assert rebuilt == maps[0]
    with pytest.raises(Mp4jError, match="duplicate key"):
        clusters[4][1].allgather_map([{"same": 1.0}] * 4)


def test_map_vector_bf16_empty_and_drifting_over_a_list(clusters, rng):
    vec = [{"a": np.array([1.0, 2.0]), "b": np.array([1.0, 1.0])},
           {"a": np.array([10.0, 20.0])}, {"c": np.array([5.0, 5.0])}, {}]
    got = _three(clusters, 4, "allreduce_map", vec, op="SUM")
    np.testing.assert_allclose(got[0]["a"], [11.0, 22.0])
    bf = [{f"w{i}": float(i + r) for i in range(20)} for r in range(4)]
    for m in _three(clusters, 4, "allreduce_map", bf, "BFLOAT16", "SUM"):
        assert all(float(m[f"w{i}"]) == sum(i + r for r in range(4))
                   for i in range(20))
    for method in ("allreduce_map", "reduce_map", "reduce_scatter_map"):
        assert all(m == {} for m in _three(
            clusters, 4, method, [{} for _ in range(4)], op="SUM"))
    for step in range(4):
        maps = make_maps(4, rng, n_keys=30 + 23 * step, fill=0.7)
        for m in _three(clusters, 4, "allreduce_map", maps, op="SUM"):
            assert_map_close(m, expected_map_reduce(maps, "SUM"))


# ----------------------------------------------------------------------
# FM/FFM over a list mesh
# ----------------------------------------------------------------------
FM_PATHS = {"dense": {},
            "sparse": {"sparse_grads": True},
            "sparse_cap": {"sparse_grads": True, "sparse_capacity": 48},
            "sharded": {"sparse_grads": True, "table_sharding": "sharded"}}
LIST_MESHES = {   # name: (reference mesh, list mesh, packed mesh)
    "flat4": (lambda: jmake_mesh(4), lambda: make_mesh(4, devices=cpus(4)),
              lambda: make_mesh(4, "cpu")),
    "flat3": (lambda: jmake_mesh(3), lambda: make_mesh(3, devices=cpus(3)),
              lambda: make_mesh(3, "cpu")),
    "hier2x2": (lambda: jmake_hier_mesh(2, 2),
                lambda: make_hier_mesh(2, 2, devices=cpus(4)),
                lambda: make_hier_mesh(2, 2, "cpu")),
}


def _fm_cfg(model="ffm", **kw):
    base = dict(n_features=64, n_fields=4, k=4, max_nnz=4, model=model,
                learning_rate=0.3, init_scale=0.1, l2=1e-3)
    base.update(kw)
    return base


def _fm(cfg, mesh="flat4", path="dense", which=1):
    """The list (which=1) or packed (2) port trainer, or the reference's
    (0)."""
    if which == 0:
        return JFMTrainer(JFMConfig(**cfg), mesh=LIST_MESHES[mesh][0](),
                          **FM_PATHS[path])
    return F.FMTrainer(F.FMConfig(**cfg), mesh=LIST_MESHES[mesh][which](),
                       **FM_PATHS[path])


def _replicas_equal(tr):
    """Every member's replicated parameters bitwise member 0's (w0 and w
    only where the table is sharded); every tensor on the member's
    device and of its own storage."""
    first = tr.replicas_[0]
    k = 2 if tr.table_sharding == "sharded" else 3
    ptrs = set()
    for m, d in zip(tr.replicas_, tr.mesh.devices):
        for a, b in zip(m[:k], first[:k]):
            assert a.device == d and torch.equal(a, b)
        ptrs.add(m[2].data_ptr())
    assert len(ptrs) == len(tr.replicas_)


@pytest.mark.parametrize("path", sorted(FM_PATHS))
@pytest.mark.parametrize("model", ["fm", "ffm"])
def test_fm_list_matches_reference_and_packed(model, path, rng):
    """Every gradient path on 4 members, N = 101 (padding), l2 on."""
    data = make_sparse_classification(rng, n=101)
    cfg = _fm_cfg(model)
    jtr, ltr, ptr = (_fm(cfg, path=path, which=w) for w in (0, 1, 2))
    jp, jl = jtr.fit(*data, n_steps=5, seed=2)
    lp, ll = ltr.fit(*data, n_steps=5, seed=2)
    pp, pl = ptr.fit(*data, n_steps=5, seed=2)
    assert ll.dtype == np.float32 and ll.shape == (5,)
    _close(ll, jl)
    _close(ll, pl)
    table = ltr.full_table(lp)
    _close(table, jtr.full_table(jp))
    _close(table, ptr.full_table(pp))
    for a, b in zip(lp[:2], jp[:2]):
        _close(a, b)
    _replicas_equal(ltr)
    if path == "sharded":
        assert isinstance(lp[2], list) and len(lp[2]) == 4
        assert all(b.shape == (ltr.n_rows_padded // 4, 4) for b in lp[2])
    else:
        assert lp[2].shape == (ltr.n_rows, 4)
    _close(ltr.predict(lp, *data[:3]), jtr.predict(jp, *data[:3]))


@pytest.mark.parametrize("mesh,path", [("flat3", "dense"),
                                       ("flat3", "sharded"),
                                       ("hier2x2", "sparse"),
                                       ("hier2x2", "sharded")])
def test_fm_list_meshes_match_reference(mesh, path, rng):
    data = make_sparse_classification(rng, n=96)
    cfg = _fm_cfg()
    jp, jl = _fm(cfg, mesh, path, 0).fit(*data, n_steps=3, seed=3)
    ltr = _fm(cfg, mesh, path)
    lp, ll = ltr.fit(*data, n_steps=3, seed=3)
    _close(ll, jl)
    _close(ltr.full_table(lp), _fm(cfg, mesh, path, 0).full_table(jp))


@pytest.mark.parametrize("path", ["dense", "sparse", "sharded"])
def test_fm_list_repeatable_and_stream_equals_fit(path, rng):
    """Two runs bitwise; one full-batch chunk a step through the
    double-buffered stream bitwise ``fit``."""
    data = make_sparse_classification(rng, n=101)
    cfg = _fm_cfg()
    runs = [_fm(cfg, path=path).fit(*data, n_steps=4, seed=2)
            for _ in range(2)]
    tr = _fm(cfg, path=path)
    sp_, sl = tr.fit_stream((data for _ in range(4)), seed=2)
    for params, losses in runs[1:] + [(sp_, sl)]:
        np.testing.assert_array_equal(losses, runs[0][1])
        np.testing.assert_array_equal(tr.full_table(params),
                                      tr.full_table(runs[0][0]))
        for a, b in zip(params[:2], runs[0][0][:2]):
            assert torch.equal(a, b)
    _replicas_equal(tr)


@pytest.mark.parametrize("path", ["dense", "sparse", "sharded"])
def test_fm_list_step_on_repeated_devices_does_not_alias(path, rng):
    """The members' parameters share one device: a step from the
    trainer's own placement must equal a step from replicas that are
    deep copies, so no member's update lands in another's storage."""
    data = make_sparse_classification(rng, n=64)
    tr = _fm(_fm_cfg(), path=path)
    batch = tr.shard_data(*data)
    step = tr._step(int(batch[0][0].shape[0]) * tr.cfg.max_nnz)
    placed = tr._place_params(tr.init_params(seed=1))
    copies = [tuple(t.clone() for t in m) for m in placed]
    got, gl = step(placed, batch)
    want, wl = step(copies, batch)
    assert torch.equal(gl, wl)
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("path", ["sparse", "sharded"])
def test_fm_list_weights_eval_set_and_early_stopping(path, rng):
    data = make_sparse_classification(rng, n=101)
    w = rng.uniform(0.2, 2.0, 101).astype(np.float32)
    va = data[:3] + ((rng.random(101) > 0.5).astype(np.float32),)
    kw = dict(n_steps=40, seed=2, sample_weight=w, eval_set=va,
              early_stopping_rounds=3)
    cfg = _fm_cfg()
    jtr, ltr, ptr = (_fm(cfg, path=path, which=k) for k in (0, 1, 2))
    jp, jl = jtr.fit(*data, **kw)
    lp, ll = ltr.fit(*data, **kw)
    _, pl = ptr.fit(*data, **kw)
    assert len(ll) < 40 and len(ll) == len(jl) == len(pl)
    _close(ll, jl)
    _close(ltr.eval_history_, jtr.eval_history_)
    _close(ltr.eval_history_, ptr.eval_history_)
    _close(ltr.full_table(lp), jtr.full_table(jp))
    _replicas_equal(ltr)


@pytest.mark.parametrize("sharding", ["replicated", "sharded"])
def test_fm_list_params_files_and_both_packages(sharding, rng, tmp_path):
    """``params_from_numpy`` on a list mesh gives what ``fit`` returns
    there; ``fit(params=)`` takes it, the reference's numpy arrays and a
    packed trainer's whole table alike; the saved file loads in the
    reference."""
    data = make_sparse_classification(rng, n=96)
    cfg = _fm_cfg()
    path = "sharded" if sharding == "sharded" else "sparse"
    jtr = _fm(cfg, path=path, which=0)
    jp, _ = jtr.fit(*data, n_steps=2, seed=5)
    jnp_params = tuple(np.asarray(p) for p in jp)
    mesh = make_mesh(4, devices=cpus(4))
    staged = F.params_from_numpy(jnp_params, F.FMConfig(**cfg), sharding,
                                 mesh)
    ltr = _fm(cfg, path=path)
    if sharding == "sharded":
        assert isinstance(staged[2], list) and len(staged[2]) == 4
    np.testing.assert_array_equal(ltr.full_table(staged),
                                  jtr.full_table(jp))
    outs = [ltr.fit(*data, n_steps=2, params=p)
            for p in (staged, jnp_params)]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    jp2, jl2 = jtr.fit(*data, n_steps=2, params=jp)
    _close(outs[0][1], jl2)
    # the caller's parameters are copied, never written to
    np.testing.assert_array_equal(ltr.full_table(staged),
                                  jtr.full_table(jp))
    f = str(tmp_path / "fm_list.npz")
    ltr.save_params(f, outs[0][0])
    jcfg, loaded = JFMTrainer.load_params(f, JFMConfig)
    _close(loaded[2], jtr.full_table(jp2))
    assert jcfg == JFMConfig(**cfg)


def test_fold_members_folds_in_rank_order():
    """One partial a member, summed in rank order (as ``_base.
    fold_across`` folds one a process), in the partials' shapes, on every
    member."""
    from ytk_mp4j_tpu_torch.models._base import fold_members

    parts = [(torch.tensor(float(r) + 0.1), torch.arange(3.0) * (r + 1))
             for r in range(3)]
    folded = fold_members(parts)
    assert len(folded) == 3
    want = (parts[0][0] + parts[1][0] + parts[2][0],
            parts[0][1] + parts[1][1] + parts[2][1])
    for f in folded:
        assert all(torch.equal(a, b) for a, b in zip(f, want))


# ----------------------------------------------------------------------
# linear over a list mesh
# ----------------------------------------------------------------------
def _linear_case(loss, rng, n=501):
    x, y, _ = make_regression(rng, n=n, d=5)
    kw = dict(n_features=5, loss=loss, learning_rate=0.2, momentum=0.9,
              l1=0.01, l2=1e-3)
    params = None
    if loss == "logistic":
        y = (y > np.median(y)).astype(np.float32)
        params = (rng.standard_normal(5).astype(np.float32) * 0.1,
                  np.float32(0.05))
    elif loss == "softmax":
        y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.int32)
        kw["n_classes"] = 3
    return kw, x, y, params


@pytest.mark.parametrize("mesh", ["flat4", "flat3", "hier2x2"])
@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_linear_list_matches_reference_and_packed(loss, mesh, rng):
    kw, x, y, params = _linear_case(loss, rng)
    jm, lm, pm = LIST_MESHES[mesh]
    jp, jl = JLinearTrainer(JLinearConfig(**kw), mesh=jm()).fit(
        x, y, n_steps=20, params=params)
    ltr = L.LinearTrainer(L.LinearConfig(**kw), mesh=lm())
    lp, ll = ltr.fit(x, y, n_steps=20, params=params)
    pp, pl = L.LinearTrainer(L.LinearConfig(**kw), mesh=pm()).fit(
        x, y, n_steps=20, params=params)
    _close(ll, jl)
    _close(ll, pl)
    for a, b, c in zip(lp, jp, pp):
        _close(a, b)
        _close(a, c)
    first = ltr.replicas_[0]
    for m in ltr.replicas_:
        assert all(torch.equal(a, b) for a, b in zip(m, first))
    jtr = JLinearTrainer(JLinearConfig(**kw), mesh=jmake_mesh(1))
    _close(ltr.predict(lp, x), jtr.predict(jp, x))


@pytest.mark.parametrize("loss", ["squared", "softmax"])
def test_linear_list_repeatable_stream_weights_and_eval(loss, rng):
    kw, x, y, _ = _linear_case(loss, rng, n=203)
    cfg = L.LinearConfig(**kw)
    mesh = make_mesh(4, devices=cpus(4))
    runs = [L.LinearTrainer(cfg, mesh=mesh).fit(x, y, n_steps=6)
            for _ in range(2)]
    tr = L.LinearTrainer(cfg, mesh=mesh)
    sp_, sl = tr.fit_stream(((x, y) for _ in range(6)))
    for params, losses in (runs[1], (sp_, sl)):
        np.testing.assert_array_equal(losses, runs[0][1])
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0][0]))
    w = rng.uniform(0.2, 2.0, len(y)).astype(np.float32)
    va = (x[:50], y[:50])
    fit = dict(n_steps=30, sample_weight=w, eval_set=va,
               early_stopping_rounds=2)
    jtr = JLinearTrainer(JLinearConfig(**kw), mesh=jmake_mesh(4))
    jp, jl = jtr.fit(x, y, **fit)
    ltr = L.LinearTrainer(cfg, mesh=mesh)
    lp, ll = ltr.fit(x, y, **fit)
    assert len(ll) == len(jl)
    _close(ll, jl)
    _close(ltr.eval_history_, jtr.eval_history_)
    _close(lp[0], jp[0])


def test_linear_list_params_from_numpy(rng):
    kw, x, y, params = _linear_case("logistic", rng, n=101)
    mesh = make_mesh(4, devices=cpus(4))
    staged = L.params_from_numpy(params, L.LinearConfig(**kw), mesh)
    assert all(p.device == CPU for p in staged)
    a = L.LinearTrainer(L.LinearConfig(**kw), mesh=mesh).fit(
        x, y, n_steps=3, params=staged)
    b = L.LinearTrainer(L.LinearConfig(**kw), mesh=mesh).fit(
        x, y, n_steps=3, params=params)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(staged[0].numpy(), params[0])


def test_fit_comm_over_a_list_mesh():
    """``fit(comm=)`` on list meshes: each of 2 thread slaves trains its
    own data over its own list of 2 members; the losses are those of a
    run without a comm, and ``sync_loss_history_`` is the slaves' mean."""
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((40, 4)).astype(np.float32) for _ in range(2)]
    ys = [x @ np.array([1.0, -2.0, 0.5, 0.0], np.float32) for x in xs]
    cfg = L.LinearConfig(n_features=4, loss="squared", learning_rate=0.1)
    results = [None, None]

    def worker(slave):
        tr = L.LinearTrainer(cfg, mesh=make_mesh(2, devices=cpus(2)))
        _, losses = tr.fit(xs[slave.rank], ys[slave.rank], n_steps=4,
                           comm=slave)
        results[slave.rank] = (losses, tr.sync_loss_history_.copy())

    threads = [threading.Thread(target=worker, args=(s,), daemon=True)
               for s in ThreadCommSlave.spawn_group(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for r in range(2):
        _, alone = L.LinearTrainer(cfg, mesh=make_mesh(
            2, devices=cpus(2))).fit(xs[r], ys[r], n_steps=4)
        np.testing.assert_array_equal(results[r][0], alone)
        np.testing.assert_allclose(
            results[r][1], (results[0][0].astype(np.float64)
                            + results[1][0]) / 2, rtol=1e-12)


# ----------------------------------------------------------------------
# the multi-chip dry run over a list
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [4, 3])
def test_dryrun_over_a_cpu_list(n):
    entry.dryrun(n, devices=cpus(n))


def test_dryrun_list_refusals():
    with pytest.raises(Mp4jError, match="not both"):
        entry.dryrun(2, device="cpu", devices=cpus(2))
    with pytest.raises(Mp4jError, match="from 1 devices"):
        entry.dryrun(2, devices=cpus(1))
