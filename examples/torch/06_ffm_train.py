"""FFM consumer: field-aware factorization machine with the sparse
embedding-gradient exchange (the Criteo-shaped workload; the mirror of
``examples/06_ffm_train.py``); train, persist, and serve.

    python examples/torch/06_ffm_train.py [--device cpu] [--n 8]
"""
import argparse
import os
import tempfile

import numpy as np

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()
mesh = make_mesh(args.n, args.device)

rng = np.random.default_rng(0)
N, NF, NFIELDS, K = 20_000, 1000, 4, 6
feats = rng.integers(0, NF, (N, K)).astype(np.int32)
fields = rng.integers(0, NFIELDS, (N, K)).astype(np.int32)
vals = np.ones((N, K), np.float32)
y = (feats.min(1) < NF // 10).astype(np.float32)

cfg = FMConfig(model="ffm", n_features=NF, n_fields=NFIELDS, k=4,
               max_nnz=K, learning_rate=0.5)
trainer = FMTrainer(cfg, mesh=mesh, sparse_grads=True)  # sparse exchange
params, losses = trainer.fit(feats, fields, vals, y, n_steps=100)
print(f"logloss: {losses[0]:.4f} -> {losses[-1]:.4f}")
assert losses[-1] < losses[0]

with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "ffm_model.npz")
    trainer.save_params(path, params)
    cfg2, params2 = FMTrainer.load_params(path, FMConfig)
serve = FMTrainer(cfg2, device=mesh.device)
p = serve.predict(params2, feats[:5], fields[:5], vals[:5]).cpu().numpy()
print("served probs:", np.round(p, 3))
