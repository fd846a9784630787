"""End-to-end consumer: data-parallel GBDT, the main workload (the mirror
of ``examples/05_gbdt_train.py``). Continuous features are
quantile-binned, samples shard over the ``--n`` members of one card,
each level's histograms are built by the hand-written CUDA histogram
kernel (its plain version on the CPU) and folded across the members, and
ensemble predict runs on the card.

    python examples/torch/05_gbdt_train.py [--device cpu] [--n 8]
"""
import argparse

import numpy as np

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()
mesh = make_mesh(args.n, args.device)

rng = np.random.default_rng(0)
N, F, B = 20_000, 8, 32
X = rng.standard_normal((N, F)).astype(np.float32)
y = ((X[:, 0] > 0).astype(np.float32)
     + 0.1 * rng.standard_normal(N).astype(np.float32))

# The one-call consumer path (ytk-learn shape): RAW continuous
# features in, the trainer quantile-bins internally (train_raw) and
# keeps the fitted binner for serving. On a multi-process job, pass
# ``comm=`` and the binner fits DISTRIBUTED (each rank sketches its
# own shard, one allgather merges -- check/checkdist.py runs that).
cfg = GBDTConfig(n_features=F, n_bins=B, depth=4, n_trees=5,
                 learning_rate=0.3)
trainer = GBDTTrainer(cfg, mesh=mesh)   # n members, data-parallel
trees, train_preds = trainer.train_raw(X, y)

preds = trainer.predict_raw(X, trees).cpu().numpy()   # ensemble inference
mse0 = float(np.mean(y ** 2))
mse = float(np.mean((preds - y) ** 2))
print(f"mse: {mse0:.4f} -> {mse:.4f} after {len(trees)} trees")
assert mse < mse0

# the manual wiring underneath: the sketch/merge pair is what
# fit_distributed runs per rank on a multi-process job (edges are the
# merge's 2/Q-approximation of train_raw's exact local fit)
binner = QuantileBinner(B)
sketches = [binner.local_sketch(s) for s in np.array_split(X, 4)]
binner.merge_sketches(np.stack([s.values for s in sketches]),
                      np.stack([s.counts for s in sketches]))
bins = binner.transform(X, mesh.device)
manual_preds = GBDTTrainer(cfg, mesh=mesh).train(bins, y)[1]
assert manual_preds.isfinite().all()
