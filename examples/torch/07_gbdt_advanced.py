"""Advanced GBDT consumer flow: multiclass softmax objective,
validation-driven early stopping, stochastic boosting, instance
weights, feature importance, and model persistence -- the full
ytk-learn-style workflow over the members of one card (the mirror of
``examples/07_gbdt_advanced.py``).

    python examples/torch/07_gbdt_advanced.py [--device cpu] [--n 8]

Row and feature subsampling draw from per-member ``torch.Generator``
streams, not the reference's ``jax.random`` keys, so the kept rounds and
the accuracies differ from the reference's printout; the asserted bars
are the reference's.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()
mesh = make_mesh(args.n, args.device)
dev = mesh.device

rng = np.random.default_rng(0)
N, F, B, C = 30_000, 10, 64, 3
X = rng.standard_normal((N, F)).astype(np.float32)
y = (np.digitize(X[:, 4], [-0.5, 0.5])).astype(np.int32)  # 3 classes
w = np.ones(N, np.float32)

binner = QuantileBinner(B).fit(X[: N - 5000])
bins_tr = binner.transform(X[: N - 5000], dev)
bins_va = binner.transform(X[N - 5000:], dev)

cfg = GBDTConfig(n_features=F, n_bins=B, depth=4, n_trees=30,
                 learning_rate=0.3, loss="softmax", n_classes=C,
                 subsample=0.9, colsample=0.9, min_split_gain=1e-6)
trainer = GBDTTrainer(cfg, mesh=mesh)
trees, _ = trainer.train(
    bins_tr, y[: N - 5000], sample_weight=w[: N - 5000],
    eval_set=(bins_va, y[N - 5000:]), early_stopping_rounds=5)

proba = trainer.predict(bins_va, trees, proba=True).cpu().numpy()
acc = float((proba.argmax(1) == y[N - 5000:]).mean())
imp = trainer.feature_importance(trees)
print(f"rounds kept: {len(trees)} (history {len(trainer.eval_history_)})")
print(f"holdout acc: {acc:.3f}; top feature: {int(imp.argmax())} "
      f"({imp.max():.0%} of splits)")
assert acc > 0.9 and imp.argmax() == 4

with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "gbdt_multiclass.npz")
    trainer.save_model(path, trees, binner=binner)
    cfg2, trees2, binner2 = GBDTTrainer.load_model(path, dev)
serve = GBDTTrainer(cfg2, device=dev)
np.testing.assert_allclose(
    serve.predict(binner2.transform(X[N - 5000:], dev), trees2,
                  proba=True).cpu().numpy(),
    proba, rtol=1e-5)
print("saved, reloaded, and served identically")

# -- missing values + categorical features (ytk-learn data handling) --
# NaN-laden continuous features: missing_bucket reserves bin 0 for NaN
# and the trainer LEARNS each split's default direction. Feature 9 is a
# TRUE categorical: its small integer codes are placed directly as bin
# ids (in [1, B-2] -- bin 0 is the missing bucket, bin B-1 the freeze
# sentinel), NOT quantile-binned; equality splits ("code == c goes
# right") need real category codes, not ordered quantile buckets.
Xm = X.copy()
Xm[rng.random(N) < 0.25, 2] = np.nan
codes = rng.integers(0, 6, N)                 # 6 categories
ym = ((np.isnan(Xm[:, 2]) | (Xm[:, 2] > 0.8))
      & (codes == 2)).astype(np.float32)
# distributed-style fit under missing_bucket: NaN rows are excluded
# from each shard's sketch (per-feature finite counts weight the merge)
mbinner = QuantileBinner(B, missing_bucket=True)
msk = [mbinner.local_sketch(s) for s in np.array_split(Xm, 3)]
mbinner.merge_sketches(np.stack([s.values for s in msk]),
                       np.stack([s.counts for s in msk]))
mbins = mbinner.transform(Xm, dev).clone()      # writable copy
mbins[:, 9] = torch.from_numpy(codes + 1).to(mbins)  # codes -> bins [1, 6]
mcfg = GBDTConfig(n_features=F, n_bins=B, depth=4, n_trees=20,
                  learning_rate=0.3, loss="logistic",
                  missing_bin=True, categorical_features=(9,))
mtr = GBDTTrainer(mcfg, mesh=mesh)
mtrees, _ = mtr.train(mbins, ym)
mproba = mtr.predict(mbins, mtrees, proba=True).cpu().numpy()
macc = float(((mproba > 0.5) == ym).mean())
print(f"missing+categorical acc: {macc:.3f}")
assert macc > 0.95
