"""Instance-weighted training across the consumer families (the mirror
of ``examples/11_weighted_training.py``).

ytk-learn weights examples end to end; here the SAME weight vector
flows through (a) the quantile sketch -- weighted bins via the
inverted-CDF convention, where integer weights behave exactly like
physically duplicated rows -- (b) GBDT boosting gradients via the
one-call train_raw (histograms on the hand-written CUDA kernel), and (c)
the FM/linear weighted-mean steps.

    python examples/torch/11_weighted_training.py [--device cpu] [--n 8]
"""
import argparse

import numpy as np

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer
from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer
from ytk_mp4j_tpu_torch.models.linear import LinearConfig, LinearTrainer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()
mesh = make_mesh(args.n, args.device)

rng = np.random.default_rng(0)
N, F = 4_000, 6
X = rng.standard_normal((N, F)).astype(np.float32)
y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
# upweight the positive class 3x (the classic imbalance treatment)
w = np.where(y > 0, 3.0, 1.0).astype(np.float32)

# (a) weighted quantile bins: integer weights == row duplication
b_w = QuantileBinner(16).fit(X, sample_weight=w)
b_dup = QuantileBinner(16).fit(
    np.repeat(X, w.astype(np.int64), axis=0),
    sample_weight=np.ones(int(w.sum())))
np.testing.assert_array_equal(b_w.edges, b_dup.edges)
print("weighted bins == duplicated-row bins")

# (b) one-call weighted GBDT: the weights reach the sketch AND the
# boosting gradients; the fitted binner rides save_model
cfg = GBDTConfig(n_features=F, n_bins=16, depth=4, n_trees=5,
                 loss="logistic", learning_rate=0.3)
tr = GBDTTrainer(cfg, mesh=mesh)
trees, _ = tr.train_raw(X, y, sample_weight=w)
proba = tr.predict_raw(X, trees, proba=True).cpu().numpy()
recall = float(np.mean((proba[y > 0] > 0.5)))
print(f"gbdt weighted positive-class recall: {recall:.3f}")
assert recall > 0.9

# (c) the linear family: same vector, same semantics
ltr = LinearTrainer(LinearConfig(n_features=F, loss="logistic",
                                 learning_rate=0.5), mesh=mesh)
params, losses = ltr.fit(X, y, n_steps=60, sample_weight=w)
lrecall = float(np.mean(ltr.predict(params, X).cpu().numpy()[y > 0] > 0.5))
print(f"linear weighted positive-class recall: {lrecall:.3f}")
assert lrecall > 0.9

# (d) FM: integer weights == duplicated rows, loss-for-loss (the
# weighted-mean step normalizes by the weight sum)
feats = rng.integers(0, 32, (256, 2)).astype(np.int32)
fm_fields = np.broadcast_to(np.arange(2, dtype=np.int32),
                            (256, 2)).copy()
vals = np.ones((256, 2), np.float32)
yf = rng.integers(0, 2, 256).astype(np.float32)
k = rng.integers(1, 4, 256)
fcfg = FMConfig(n_features=32, n_fields=2, k=4, max_nnz=2, model="ffm",
                learning_rate=0.3, init_scale=0.1)
_, l_w = FMTrainer(fcfg, mesh=mesh).fit(
    feats, fm_fields, vals, yf, n_steps=3, seed=1,
    sample_weight=k.astype(np.float32))
d = lambda a: np.repeat(a, k, axis=0)  # noqa: E731
_, l_d = FMTrainer(fcfg, mesh=mesh).fit(d(feats), d(fm_fields), d(vals),
                                        d(yf), n_steps=3, seed=1)
np.testing.assert_allclose(l_w, l_d, rtol=1e-4, atol=1e-6)
print("ffm weighted losses == duplicated-row losses")
