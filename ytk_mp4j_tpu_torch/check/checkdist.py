"""Distributed correctness check program: the multi-process plane (the
port of ``ytk_mp4j_tpu/check/checkdist.py``).

One ``main()`` per PROCESS joins a ``torch.distributed`` job
(``comm.distributed.init_distributed``), then checks

1. :class:`DistributedComm`'s dense and map collectives against the numpy
   oracle (``check``);
2. the fold over processes: every process's member rows gathered and
   folded in rank order over ``global_mesh`` and ``hier_global_mesh``
   (``check_global_mesh``);
3. GBDT over every process (``check_gbdt_global_mesh``): trees and
   margins BITWISE equal to a one-process ``make_mesh(P)`` on the same
   data -- the port folds histograms and leaf sums in rank order across
   the ranks, so the reference's looser test (training MSE within 10 %)
   is strengthened -- on the flat mesh, ``hier_global_mesh(2)`` and with
   subsampling;
4. FFM over every process (``check_ffm_global_mesh``): the sparse path
   over ``global_mesh`` against a one-process ``make_mesh(P)`` (rtol
   1e-5) and the reference's looser bar (a local dense run's last loss
   within 1e-3), the dense path beside it, and every rank's replicated
   parameters bitwise equal;
5. the sharded table over every process (``check_ffm_round4_global_mesh``):
   its losses against ``make_mesh(P)``'s sharded run and the replicated
   run, the collective ``predict`` against a local scorer on the gathered
   table, and ``fit_stream`` replicated and sharded against ``fit``;
6. distributed quantile binning, including a weighted ``train_raw(comm=)``
   (``check_binning_dist``);
7. the dense plane's backend all-reduce against the allgather and the
   host fold in rank order (``check_dense_plane_timing``): equal to rtol
   1e-5, both timed and logged.

The job-wide verdict is the largest exit code of any rank
(``DistributedComm.close``). Launch 2 processes on the CPU, through a
file store (a path that does not exist yet)::

    for i in 0 1; do
        python -m ytk_mp4j_tpu_torch.check.checkdist \\
            --init-method file:///tmp/mp4j_store --num-processes 2 \\
            --process-id $i --device cpu &
    done

On one card, several ranks take gloo (``--backend gloo --device
cuda:0``): NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import argparse
import sys
import traceback

import numpy as np
import torch


def check(comm, length: int = 97) -> int:
    """The dense and map families against the numpy oracle: exact for
    integer operands, rtol 1e-5 for floats."""
    from ytk_mp4j_tpu_torch import meta
    from ytk_mp4j_tpu_torch.check._oracle import expected_reduce, rank_data
    from ytk_mp4j_tpu_torch.operands import Operands
    from ytk_mp4j_tpu_torch.operators import Operator, Operators

    n, r = comm.slave_num, comm.rank
    fails = 0

    def expect(name, ok):
        nonlocal fails
        if not ok:
            fails += 1
            comm.error(f"{name} MISMATCH")

    # a host-only custom operator (Python on each element pair): the
    # allgather path with a fold in rank order
    absmax = Operator.custom(
        "ABSMAX", lambda a, b: np.where(np.abs(a) >= np.abs(b), a, b), 0)
    for operand in (Operands.DOUBLE, Operands.FLOAT, Operands.INT,
                    Operands.LONG):
        exact = operand.dtype.kind != "f"
        alls = [rank_data(q, length, operand, 3000) for q in range(n)]
        ranges = meta.partition_range(0, length, n)

        def close(a, b):
            return (np.array_equal(a, b) if exact
                    else np.allclose(a, b, rtol=1e-5, atol=1e-6))

        for op_name in ("SUM", "MAX", "MIN", "PROD"):
            op = Operators.by_name(op_name)
            want = expected_reduce(alls, op_name)
            arr = alls[r].copy()
            comm.allreduce_array(arr, operand, op)
            expect(f"allreduce/{operand.name}/{op_name}", close(arr, want))
        want = alls[0].copy()
        for a in alls[1:]:
            want = absmax.np_fn(want, a)
        arr = alls[r].copy()
        comm.allreduce_array(arr, operand, absmax)
        expect(f"allreduce/{operand.name}/custom", np.array_equal(arr, want))
        # a sub-range: only [5, length - 3) changes
        want = expected_reduce(alls, "SUM")
        arr = alls[r].copy()
        comm.allreduce_array(arr, operand, Operators.SUM, from_=5,
                             to=length - 3)
        expect(f"allreduce_range/{operand.name}",
               close(arr[5:-3], want[5:-3])
               and np.array_equal(arr[:5], alls[r][:5])
               and np.array_equal(arr[-3:], alls[r][-3:]))
        # rooted + segment family
        arr = alls[r].copy()
        comm.reduce_array(arr, operand, Operators.SUM, root=0)
        expect(f"reduce/{operand.name}",
               close(arr, want) if r == 0 else np.array_equal(arr, alls[r]))
        arr = alls[r].copy()
        comm.broadcast_array(arr, operand, root=n - 1)
        expect(f"broadcast/{operand.name}", np.array_equal(arr, alls[n - 1]))
        for op_name in ("SUM", "MAX", "PROD"):
            op = Operators.by_name(op_name)
            want_op = expected_reduce(alls, op_name)
            arr = alls[r].copy()
            comm.reduce_scatter_array(arr, operand, op)
            s, e = ranges[r]
            expect(f"reduce_scatter/{operand.name}/{op_name}",
                   close(arr[s:e], want_op[s:e]))
        arr = alls[r].copy()
        comm.allgather_array(arr, operand)
        want_g = np.concatenate(
            [alls[q][s:e] for q, (s, e) in enumerate(ranges)])
        expect(f"allgather/{operand.name}", np.array_equal(arr, want_g))
        arr = alls[r].copy()
        comm.gather_array(arr, operand, root=0)
        expect(f"gather/{operand.name}",
               np.array_equal(arr, want_g) if r == 0
               else np.array_equal(arr, alls[r]))
        arr = alls[r].copy()
        comm.scatter_array(arr, operand, root=0)
        s, e = ranges[r]
        expect(f"scatter/{operand.name}",
               np.array_equal(arr[s:e], alls[0][s:e]))
        # uneven ranges: rank q owns q + 1 elements from offset 2
        uneven, off = [], 2
        for q in range(n):
            uneven.append((off, off + q + 1))
            off += q + 1
        arr = alls[r].copy()
        comm.allgather_array(arr, operand, ranges=uneven)
        expect(f"allgather_uneven/{operand.name}", all(
            np.array_equal(arr[s:e], alls[q][s:e])
            for q, (s, e) in enumerate(uneven)))
        arr = alls[r].copy()
        comm.reduce_scatter_array(arr, operand, Operators.SUM,
                                  ranges=uneven)
        s, e = uneven[r]
        expect(f"reduce_scatter_uneven/{operand.name}",
               close(arr[s:e], want[s:e]))
        comm.barrier()

    # map collectives
    maps = [{f"k{(q + j) % (n + 1)}": float(q * 10 + j) for j in range(3)}
            for q in range(n)]
    want_merged: dict = {}
    for m in maps:
        for k, v in m.items():
            want_merged[k] = want_merged.get(k, 0.0) + v
    d = dict(maps[r])
    comm.allreduce_map(d, Operands.DOUBLE, Operators.SUM)
    expect("allreduce_map", d == want_merged)
    d = {f"r{r}": float(r)}
    comm.allgather_map(d, Operands.DOUBLE)
    expect("allgather_map", d == {f"r{q}": float(q) for q in range(n)})
    d = {f"r{r}": float(r)}
    comm.gather_map(d, Operands.DOUBLE, root=0)
    expect("gather_map", d == ({f"r{q}": float(q) for q in range(n)}
                               if r == 0 else {f"r{r}": float(r)}))
    d = dict(maps[r])
    comm.broadcast_map(d, Operands.DOUBLE, root=n - 1)
    expect("broadcast_map", d == maps[n - 1])
    d = dict(want_merged) if r == 0 else {}
    comm.scatter_map(d, Operands.DOUBLE, root=0)
    expect("scatter_map", d == {k: v for k, v in want_merged.items()
                                if meta.key_partition(k, n) == r})
    d = dict(maps[r])
    comm.reduce_scatter_map(d, Operands.DOUBLE, Operators.SUM)
    expect("reduce_scatter_map",
           d == {k: v for k, v in want_merged.items()
                 if meta.key_partition(k, n) == r})
    # int-keyed maps with a DRIFTING vocabulary: the synchronized codecs
    # keep codes identical across processes, only novel keys travel
    for step in range(3):
        imaps = [{int(q * 5 + j + 3 * step): float(q * 10 + j)
                  for j in range(4)} for q in range(n)]
        want: dict = {}
        for m in imaps:
            for k, v in m.items():
                want[k] = want.get(k, 0.0) + v
        d = dict(imaps[r])
        comm.allreduce_map(d, Operands.DOUBLE, Operators.SUM)
        expect(f"allreduce_map_int/{step}", d == want)
        d = dict(imaps[r])
        comm.reduce_scatter_map(d, Operands.DOUBLE, Operators.SUM)
        expect(f"reduce_scatter_map_int/{step}",
               d == {k: v for k, v in want.items()
                     if meta.key_partition(k, n) == r})
    d = dict(maps[r])
    comm.reduce_map(d, Operands.DOUBLE, Operators.SUM, root=n - 1)
    expect("reduce_map", d == (want_merged if r == n - 1 else maps[r]))
    d = dict(maps[r])
    want_max: dict = {}
    for m in maps:
        for k, v in m.items():
            want_max[k] = max(want_max.get(k, -np.inf), v)
    comm.allreduce_map(d, Operands.DOUBLE, Operators.MAX)
    expect("allreduce_map_max", d == want_max)
    # vector values on the device plane
    d = {k: np.full(3, v, np.float32) for k, v in maps[r].items()}
    comm.allreduce_map(d, Operands.FLOAT, Operators.SUM)
    expect("allreduce_map_vector", d.keys() == want_merged.keys() and all(
        np.allclose(d[k], np.full(3, v, np.float32))
        for k, v in want_merged.items()))
    # vocabulary reset is collective: every rank resets at the same point
    comm.reset_map_vocabularies()
    d = dict(maps[r])
    comm.allreduce_map(d, Operands.DOUBLE, Operators.SUM)
    expect("allreduce_map_after_reset", d == want_merged)
    # a host-only custom operator routes numeric maps onto the pickled
    # plane; object values too
    host_abs = Operator.custom(
        "ABSMAX_HOST", lambda a, b: a if abs(a) > abs(b) else b, 0.0)
    plus = [{k: (1.0 + v) * (-1.0 if q % 2 else 1.0)
             for k, v in maps[q].items()} for q in range(n)]
    want_abs: dict = {}
    for m in plus:
        for k, v in m.items():
            want_abs[k] = (v if k not in want_abs
                           or abs(v) > abs(want_abs[k]) else want_abs[k])
    d = dict(plus[r])
    comm.allreduce_map(d, Operands.DOUBLE, host_abs)
    expect("allreduce_map_custom_host", d == want_abs)
    concat = Operator.custom("CONCAT", lambda a, b: a + b, "")
    d = {"s": f"<{r}>", f"only{r}": "x"}
    comm.allreduce_map(d, Operands.STRING, concat)
    expect("allreduce_map_object",
           d == dict({"s": "".join(f"<{q}>" for q in range(n))},
                     **{f"only{q}": "x" for q in range(n)}))
    return fails


def check_global_mesh(comm) -> int:
    """The fold over processes: each process's members hold rows of their
    global member index; gathered in rank order and folded, every rank
    holds sum(range(D)) -- on ``global_mesh`` and ``hier_global_mesh(2)``."""
    from ytk_mp4j_tpu_torch.comm.distributed import (all_gather_rows,
                                                     global_mesh,
                                                     hier_global_mesh)
    from ytk_mp4j_tpu_torch.ops import collectives as coll

    fails = 0
    for mesh in (global_mesh(comm.device), hier_global_mesh(2, comm.device)):
        local = torch.stack([
            torch.full((8,), float(mesh.first + j), device=mesh.device)
            for j in range(mesh.n_local)])
        rows = all_gather_rows(local, mesh.group).reshape(mesh.n, 8)
        got = coll.reduce_all(rows)
        want = float(sum(range(mesh.n)))
        order = rows[:, 0].cpu().tolist() == [float(m)
                                               for m in range(mesh.n)]
        if not (order and bool((got == want).all())):
            comm.error(f"global-mesh fold MISMATCH on {mesh.shape}: "
                       f"{got.cpu().tolist()} != {want}")
            fails += 1
    return fails


def gbdt_data(rows: int, F: int = 4, B: int = 16, seed: int = 1234):
    """The same seeded data on every rank."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (rows, F)).astype(np.int32)
    y = (np.sin(bins[:, 1]) + 0.1 * rng.standard_normal(rows)).astype(
        np.float32)
    return bins, y


def same_trees(a, b) -> bool:
    """Two ensembles equal bit for bit (feat, bin, dir and leaves)."""
    return len(a) == len(b) and all(
        torch.equal(x.cpu(), z.cpu()) for ta, tb in zip(a, b)
        for x, z in zip(ta, tb))


def check_gbdt_global_mesh(comm, rows: int = 512) -> int:
    """GBDT over every process must equal a one-process ``make_mesh(D)``
    on the same data bit for bit (trees and margins): on the flat global
    mesh with an eval set, on ``hier_global_mesh(2)`` against
    ``make_mesh(2 * P)``, and with row and feature subsampling."""
    from ytk_mp4j_tpu_torch.comm.distributed import (global_mesh,
                                                     hier_global_mesh)
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

    fails = 0
    bins, y = gbdt_data(rows)
    base = dict(n_features=4, n_bins=16, depth=3, learning_rate=0.3,
                n_trees=2)
    dev = comm.device
    cases = (("flat", global_mesh(dev), {}, True),
             ("hier", hier_global_mesh(2, dev), {}, False),
             ("subsampled", global_mesh(dev),
              dict(subsample=0.7, colsample=0.75), False))
    for name, mesh, extra, with_eval in cases:
        cfg = GBDTConfig(**base, **extra)
        kw = dict(seed=3)
        if with_eval:
            kw["eval_set"] = (bins[:64], y[:64])
        dist_tr = GBDTTrainer(cfg, mesh=mesh)
        trees_d, preds_d = dist_tr.train(bins, y, **kw)
        one = GBDTTrainer(cfg, mesh=make_mesh(mesh.n, dev))
        trees_s, preds_s = one.train(bins, y, **kw)
        if not (same_trees(trees_d, trees_s)
                and torch.equal(preds_d.cpu(), preds_s.cpu())):
            comm.error(f"gbdt global-mesh ({name}) MISMATCH against "
                       f"make_mesh({mesh.n})")
            fails += 1
        if with_eval and not (
                dist_tr.eval_history_ == one.eval_history_
                and len(dist_tr.eval_history_) == cfg.n_trees
                and all(np.isfinite(m) for m in dist_tr.eval_history_)):
            comm.error("gbdt eval history MISMATCH")
            fails += 1
    return fails


def ffm_data(N: int, F: int, seed: int, K: int = 3, nf: int = 3):
    """The same seeded padded-sparse FFM data on every rank."""
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, F, (N, K)).astype(np.int32)
    fields = rng.integers(0, nf, (N, K)).astype(np.int32)
    vals = rng.random((N, K)).astype(np.float32)
    y = (rng.random(N) > 0.5).astype(np.float32)
    return feats, fields, vals, y


def identical_across_ranks(tensors, group) -> bool:
    """Whether every rank holds the same bits of ``tensors``."""
    from ytk_mp4j_tpu_torch.comm.distributed import all_gather_rows

    flat = torch.cat([torch.as_tensor(t).reshape(-1).float()
                      for t in tensors])
    if group is None:
        return True
    rows = all_gather_rows(flat, group)
    return all(torch.equal(rows[0], q) for q in rows[1:])


def _close(a, b, rtol, atol) -> bool:
    return (bool(np.isfinite(a).all())
            and np.allclose(a, b, rtol=rtol, atol=atol))


def check_ffm_global_mesh(comm) -> int:
    """The sparse-gradient consumer over every process: FFM whose slots
    are gathered from every rank must train to the losses of a one-process
    ``make_mesh(P)`` (rtol 1e-5; the reference's bar, a local dense run's
    last loss within 1e-3, is kept), the dense path over the processes
    to the same losses (rtol 1e-4), and every rank must hold the same
    replicated parameters, bit for bit."""
    from ytk_mp4j_tpu_torch.comm.distributed import global_mesh
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer

    fails = 0
    dev = comm.device
    feats, fields, vals, y = data = ffm_data(256, 500, 77)
    cfg = FMConfig(model="ffm", n_features=500, n_fields=3, k=3,
                   max_nnz=3, learning_rate=0.2, l2=1e-4, init_scale=0.1)
    mesh = global_mesh(dev)
    runs = {}
    for name, m, kw in (("sparse", mesh, dict(sparse_grads=True)),
                        ("dense", mesh, {}),
                        ("one", make_mesh(mesh.n, dev),
                         dict(sparse_grads=True)),
                        ("local_dense", make_mesh(1, dev), {})):
        runs[name] = FMTrainer(cfg, mesh=m, **kw).fit(*data, n_steps=6,
                                                     seed=5)
    ls, lo = runs["sparse"][1], runs["one"][1]
    if not (_close(ls, lo, 1e-5, 1e-7)
            and _close(runs["dense"][1], ls, 1e-4, 1e-6)
            and np.isfinite(runs["local_dense"][1][-1])
            and abs(ls[-1] - runs["local_dense"][1][-1]) <= 1e-3):
        comm.error(f"ffm global-mesh MISMATCH: sparse {ls} vs "
                   f"make_mesh({mesh.n}) {lo}, dense {runs['dense'][1]}, "
                   f"dense-local {runs['local_dense'][1][-1]}")
        fails += 1
    for name in ("sparse", "dense"):
        if not identical_across_ranks(runs[name][0], mesh.group):
            comm.error(f"ffm {name} parameters DIFFER across ranks")
            fails += 1
    return fails


def check_ffm_round4_global_mesh(comm) -> int:
    """The sharded table and the stream over every process: the sharded
    run's losses equal ``make_mesh(P)``'s sharded run (rtol 1e-5) and the
    replicated run over the processes (rtol 1e-4, the reference's bar);
    the collective sharded ``predict`` equals a local scorer on the
    gathered table; ``fit_stream`` of one full-batch chunk a step equals
    ``fit``, replicated and sharded (rtol 1e-5)."""
    from ytk_mp4j_tpu_torch.comm.distributed import global_mesh
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer

    fails = 0
    dev = comm.device
    feats, fields, vals, y = data = ffm_data(192, 300, 42)
    cfg = FMConfig(model="ffm", n_features=300, n_fields=3, k=3,
                   max_nnz=3, learning_rate=0.2, init_scale=0.1)
    mesh = global_mesh(dev)
    sharded = dict(sparse_grads=True, table_sharding="sharded")
    rep = FMTrainer(cfg, mesh=mesh, sparse_grads=True)
    _, l_rep = rep.fit(*data, n_steps=3, seed=11)
    sh = FMTrainer(cfg, mesh=mesh, **sharded)
    p_sh, l_sh = sh.fit(*data, n_steps=3, seed=11)
    _, l_one = FMTrainer(cfg, mesh=make_mesh(mesh.n, dev), **sharded).fit(
        *data, n_steps=3, seed=11)
    if not (_close(l_sh, l_one, 1e-5, 1e-7)
            and _close(l_sh, l_rep, 1e-4, 1e-6)):
        comm.error(f"sharded-table global-mesh MISMATCH: {l_sh} vs "
                   f"make_mesh({mesh.n}) {l_one}, replicated {l_rep}")
        fails += 1
    # the sharded predict is a collective: every rank scores its members'
    # rows, and every rank gets all of them
    got = sh.predict(p_sh, feats, fields, vals).cpu().numpy()
    local = FMTrainer(cfg, mesh=make_mesh(1, dev))
    want = local.predict((p_sh[0], p_sh[1], sh.full_table(p_sh)), feats,
                         fields, vals).cpu().numpy()
    if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
        comm.error("sharded predict global-mesh MISMATCH")
        fails += 1
    for name, tr in (("replicated", rep), ("sharded", sh)):
        _, l_stream = tr.fit_stream((data for _ in range(3)), seed=11)
        if not _close(l_stream, l_rep if tr is rep else l_sh, 1e-5, 1e-7):
            comm.error(f"{name} fit_stream global-mesh MISMATCH: "
                       f"{l_stream}")
            fails += 1
    return fails


def check_binning_dist(comm) -> int:
    """Distributed quantile binning: each process sketches its own shard,
    ONE allgather merges the sketches, and every rank must end with (a)
    identical edges and (b) edges within 2/Q of the exact quantile
    positions of the pooled data; then ``train_raw(comm=)`` with weighted
    rows must fit the same binner as a standalone weighted
    ``fit_distributed``."""
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer
    from ytk_mp4j_tpu_torch.operands import Operands

    fails = 0
    rng = np.random.default_rng(99)             # same data everywhere
    N, F, B = 6_000, 3, 16
    X = np.stack([rng.standard_normal(N),
                  rng.lognormal(0.0, 1.0, N),
                  rng.uniform(-2, 9, N)], axis=1).astype(np.float32)
    shards = np.array_split(X, comm.slave_num)
    binner = QuantileBinner(B).fit_distributed(
        shards[comm.rank], comm, sample=None)

    def identical_across_ranks(edges) -> bool:
        flat = edges.ravel().astype(np.float32)
        buf = np.zeros(comm.slave_num * flat.size, np.float32)
        buf[comm.rank * flat.size: (comm.rank + 1) * flat.size] = flat
        comm.allgather_array(buf, Operands.FLOAT)
        rows = buf.reshape(comm.slave_num, flat.size)
        return all(np.array_equal(rows[0], q) for q in rows[1:])

    if not identical_across_ranks(binner.edges):
        comm.error("binning edges DIFFER across ranks")
        fails += 1
    qs = np.arange(1, B) / B
    err = 0.0
    for f in range(F):
        col = np.sort(X[:, f])
        pos = np.searchsorted(col, binner.edges[f], side="right") / N
        err = max(err, float(np.abs(pos - qs).max()))
    if err > 2.0 / B:
        comm.error(f"binning quantile error {err:.4f} > {2.0 / B:.4f}")
        fails += 1

    # the trainer's own distributed fit, weighted: rank-dependent data,
    # job-identical edges
    Xr = shards[comm.rank]
    yr = (Xr[:, 0] > 0).astype(np.float32)
    wr = 1.0 + (np.arange(Xr.shape[0]) % 3).astype(np.float64)
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=2, n_trees=2,
                     learning_rate=0.5)
    tr = GBDTTrainer(cfg, mesh=make_mesh(1, comm.device))
    trees, _ = tr.train_raw(Xr, yr, seed=4, comm=comm, sample_weight=wr)
    if not identical_across_ranks(tr.binner_.edges):
        comm.error("train_raw distributed binning DIFFERS across ranks")
        fails += 1
    standalone = QuantileBinner(B).fit_distributed(
        Xr, comm, sample=1_000_000, seed=4, sample_weight=wr)
    if not np.array_equal(tr.binner_.edges, standalone.edges):
        comm.error("train_raw binner != standalone weighted "
                   "fit_distributed")
        fails += 1
    if not bool(torch.isfinite(tr.predict_raw(X[:64], trees)).all()):
        comm.error("train_raw predict_raw produced non-finite values")
        fails += 1
    return fails


def check_dense_plane_timing(comm, elems: int = 1 << 20) -> int:
    """The dense plane two ways on the same buffer: the backend all-reduce
    (``allreduce_array``) against the allgather and the host fold in rank
    order (``_allgather_rows`` + ``_reduce_rows``). Equality is asserted
    (rtol 1e-5: the backend sums in its own order); both are timed on
    the host clock, after a warm-up, and logged."""
    import time

    from ytk_mp4j_tpu_torch.operands import Operands
    from ytk_mp4j_tpu_torch.operators import Operators

    rng = np.random.default_rng(7 + comm.rank)
    base = rng.standard_normal(elems).astype(np.float32)
    reps = 3
    comm.allreduce_array(base.copy(), Operands.FLOAT, Operators.SUM)
    comm._reduce_rows(comm._allgather_rows(base.copy()), Operators.SUM)

    comm.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        dev = base.copy()
        comm.allreduce_array(dev, Operands.FLOAT, Operators.SUM)
    t_dev = (time.perf_counter() - t0) / reps

    comm.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        host = comm._reduce_rows(comm._allgather_rows(base.copy()),
                                 Operators.SUM)
    t_host = (time.perf_counter() - t0) / reps

    fails = 0
    if not np.allclose(dev, host, rtol=1e-5, atol=1e-5):
        comm.error("dense-plane all-reduce vs allgather and fold MISMATCH")
        fails += 1
    comm.info(f"dense plane {elems} f32 x {comm.slave_num} ranks "
              f"({comm.backend}): all-reduce {t_dev * 1e3:.3f} ms, "
              f"allgather + fold {t_host * 1e3:.3f} ms "
              f"({t_host / max(t_dev, 1e-9):.2f}x)")
    return fails


def run_checks(comm, length: int = 97, gbdt_rows: int = 512) -> int:
    """Every check of this program, in the reference's order; returns the
    failure count."""
    fails = check(comm, length)
    fails += check_global_mesh(comm)
    fails += check_gbdt_global_mesh(comm, gbdt_rows)
    fails += check_ffm_global_mesh(comm)
    fails += check_ffm_round4_global_mesh(comm)
    fails += check_binning_dist(comm)
    fails += check_dense_plane_timing(comm)
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed URL, e.g. file:///path")
    ap.add_argument("--coordinator", default=None, help="host:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--device", default=None,
                    help="cpu or cuda:k (default cuda:0)")
    ap.add_argument("--length", type=int, default=97)
    ap.add_argument("--gbdt-rows", type=int, default=512)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    from ytk_mp4j_tpu_torch.comm.distributed import init_distributed

    comm = init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        init_method=args.init_method, backend=args.backend,
        device=args.device, timeout=args.timeout)
    try:
        fails = run_checks(comm, args.length, args.gbdt_rows)
        comm.info(f"checkdist done ({comm.backend} on {comm.device}): "
                  f"{fails} failures")
        comm.close(0 if fails == 0 else 1)
        # the job-wide verdict: every process reports the aggregate
        return comm.final_code
    except Exception:
        traceback.print_exc()
        return 2


if __name__ == "__main__":
    sys.exit(main())
