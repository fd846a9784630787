"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

- :func:`entry` returns one GBDT boosting round (histograms + split +
  route + leaf update) with example arguments on one device, as the
  reference's ``entry`` returns a jittable step;
- :func:`dryrun` runs, over n members on one device, the parts of the
  reference's ``dryrun_multichip`` the port has: data-parallel GBDT over
  a hierarchical mesh (flat where n is odd), the missing-bucket and
  categorical configuration, ``train_raw`` -> ``predict_raw``, and the
  dense allreduce under every algo. The map allreduce, FM and linear
  models are not ported yet (ROADMAP queue 1, items 7 and 9).

Both run on ``cuda:0`` unless given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster
from ytk_mp4j_tpu_torch.device import make_device, make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models.gbdt import (GBDTConfig, GBDTTrainer,
                                            train_tree_shard)
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


def dryrun(n_devices: int, device=None) -> None:
    """Train over n members and drive the dense collectives once; raises
    Mp4jError on any wrong result."""
    # two-level inter x intra mesh where n is even, else flat
    mesh = (make_hier_mesh(n_devices // 2, 2, device) if n_devices % 2 == 0
            else make_mesh(n_devices, device))

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

    # the dense allreduce under every schedule
    cluster = GpuCommCluster(n_devices, mesh.device)
    want = sum(range(n_devices))
    for algo in ("xla", "ring", "rdma"):
        arrs = [np.full(16, float(r), np.float32) for r in range(n_devices)]
        cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM,
                                algo=algo)
        _check(all(float(a[0]) == want for a in arrs),
               f"allreduce under {algo}")
