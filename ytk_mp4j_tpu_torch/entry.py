"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

- :func:`entry` returns one GBDT boosting round (histograms + split +
  route + leaf update) with example arguments on one device, as the
  reference's ``entry`` returns a jittable step;
- :func:`dryrun` runs, over n members, the whole of the reference's
  ``dryrun_multichip``, in its order: data-parallel GBDT over a
  hierarchical mesh (flat where n is odd), the missing-bucket and
  categorical configuration, ``train_raw`` -> ``predict_raw``, the map
  allreduce and the dense allreduce under every algo (the reference's
  ring step is ``algo="ring"``'s schedule) through ``GpuCommCluster(mesh=
  mesh)``, as the reference's ``TpuCommCluster(mesh=mesh)``, FFM with
  sparse gradients over a flat mesh -- replicated, then with the sharded
  table, whose losses must equal the replicated ones at rtol 1e-4, then
  streamed one full batch a chunk, replicated and sharded, equal to the
  full batch at rtol 1e-5 -- and the softmax linear model. The members
  are packed on one device, or, given ``devices``, one a list entry (a
  list mesh: the reference's members are chips).

Both run on ``cuda:0`` unless given ``device="cpu"`` (or CPU
``devices``).
"""

from __future__ import annotations

import numpy as np
import torch

from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster
from ytk_mp4j_tpu_torch.device import make_device, make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer
from ytk_mp4j_tpu_torch.models.gbdt import (GBDTConfig, GBDTTrainer,
                                            train_tree_shard)
from ytk_mp4j_tpu_torch.models.linear import LinearConfig, LinearTrainer
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators


def _tiny_data(n=2048, f=28, b=256, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, (n, f)).astype(np.int32)
    y = (bins[:, 0] / b + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return bins, y


def entry(device=None):
    """(fn, example_args): one boosting round at F = 28, B = 256, depth
    4 on 2048 rows; ``fn(*example_args)`` returns the new margins."""
    dev = make_device(device)
    cfg = GBDTConfig(n_features=28, n_bins=256, depth=4)
    bins, y = _tiny_data()

    def fn(bins, y, preds):
        new_preds, _ = train_tree_shard(bins, y, preds, cfg)
        return new_preds

    return fn, tuple(torch.from_numpy(a).to(dev)
                     for a in (bins, y, np.zeros_like(y)))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise Mp4jError(f"dryrun: {what}")


def dryrun(n_devices: int, device=None, devices=None) -> None:
    """Train over n members and drive the collectives once; raises
    Mp4jError on any wrong result. ``devices`` (at least n entries,
    repeats allowed) runs every step over a list mesh, member m on
    ``devices[m]``; without it the members are packed on ``device``."""
    # two-level inter x intra mesh where n is even, else flat
    mesh = (make_hier_mesh(n_devices // 2, 2, device, devices)
            if n_devices % 2 == 0
            else make_mesh(n_devices, device, devices))

    bins, y = _tiny_data(n=64 * n_devices, f=8, b=32)
    cfg = GBDTConfig(n_features=8, n_bins=32, depth=3, n_trees=1)
    _, preds = GBDTTrainer(cfg, mesh=mesh).train(bins, y, n_trees=1)
    _check(bool(torch.isfinite(preds).all()), "GBDT margins not finite")

    # the data-handling graph: reserved missing bucket with learned
    # default direction + a categorical equality-split feature
    cfg2 = GBDTConfig(n_features=8, n_bins=32, depth=2, n_trees=1,
                      missing_bin=True, categorical_features=(3,))
    bins2 = bins.copy()
    bins2[::3, 0] = 0                     # missing bucket rows
    _, preds2 = GBDTTrainer(cfg2, mesh=mesh).train(bins2, y, n_trees=1)
    _check(bool(torch.isfinite(preds2).all()),
           "missing/categorical margins not finite")

    # raw continuous features -> weighted quantile binning -> the same
    # mesh's training
    rng = np.random.default_rng(5)
    Xr = rng.standard_normal((64 * n_devices, 8)).astype(np.float32)
    yr = (Xr[:, 0] > 0).astype(np.float32)
    tr3 = GBDTTrainer(GBDTConfig(n_features=8, n_bins=32, depth=2,
                                 n_trees=1), mesh=mesh)
    trees3, _ = tr3.train_raw(Xr, yr, sample_weight=np.ones(Xr.shape[0]))
    _check(bool(torch.isfinite(tr3.predict_raw(Xr, trees3)).all()),
           "predict_raw not finite")

    # the sparse-map allreduce over the same members
    cluster = GpuCommCluster(mesh=mesh)
    maps = [{f"w:{r % 3}": float(r)} for r in range(n_devices)]
    cluster.allreduce_map(maps, Operands.FLOAT, Operators.SUM)
    want_map = {f"w:{j}": float(sum(range(j, n_devices, 3)))
                for j in range(min(3, n_devices))}
    _check(all(m == want_map for m in maps), "map allreduce")

    # the dense allreduce under every schedule
    want = sum(range(n_devices))
    for algo in ("xla", "ring", "rdma"):
        arrs = [np.full(16, float(r), np.float32) for r in range(n_devices)]
        cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM,
                                algo=algo)
        _check(all(float(a[0]) == want for a in arrs),
               f"allreduce under {algo}")

    _dryrun_fm_linear(make_mesh(n_devices, device, devices))


def _dryrun_fm_linear(mesh) -> None:
    """FFM's sparse step over a flat mesh -- replicated, sharded,
    streamed -- and the softmax linear step, on the reference's data."""
    n = mesh.n
    rng = np.random.default_rng(0)
    fcfg = FMConfig(model="ffm", n_features=64, n_fields=2, k=2,
                    max_nnz=2, learning_rate=0.1)
    Nf = 8 * n
    feats = rng.integers(0, 64, (Nf, 2)).astype(np.int32)
    fields = np.tile(np.arange(2, dtype=np.int32), (Nf, 1))
    vals = rng.standard_normal((Nf, 2)).astype(np.float32)
    yf = rng.integers(0, 2, Nf).astype(np.float32)
    _, flosses = FMTrainer(fcfg, mesh=mesh, sparse_grads=True).fit(
        feats, fields, vals, yf, n_steps=2)
    _check(bool(np.isfinite(flosses).all()), "FFM losses not finite")
    sharded = FMTrainer(fcfg, mesh=mesh, sparse_grads=True,
                        table_sharding="sharded")
    _, slosses = sharded.fit(feats, fields, vals, yf, n_steps=2)
    _check(np.allclose(slosses, flosses, rtol=1e-4, atol=1e-6),
           "sharded FFM losses != replicated")
    for tr in (FMTrainer(fcfg, mesh=mesh, sparse_grads=True), sharded):
        _, stream = tr.fit_stream((feats, fields, vals, yf)
                                  for _ in range(2))
        _check(np.allclose(stream, flosses, rtol=1e-5, atol=1e-7),
               f"{tr.table_sharding} FFM stream != full batch")

    lcfg = LinearConfig(n_features=4, loss="softmax", n_classes=3,
                        learning_rate=0.3)
    xl = rng.standard_normal((8 * n, 4)).astype(np.float32)
    yl = rng.integers(0, 3, 8 * n).astype(np.int32)
    _, llosses = LinearTrainer(lcfg, mesh=mesh).fit(xl, yl, n_steps=2)
    _check(bool(np.isfinite(llosses).all()), "linear losses not finite")
