"""The linear model family end-to-end: regression, binary logistic,
and ytk-learn's multiclass_linear analogue (softmax) -- each step's
gradient folded across the members of one card, with eval-set early
stopping and params persistence (the mirror of
``examples/09_linear_families.py``).

    python examples/torch/09_linear_families.py [--device cpu] [--n 8]
"""
import argparse
import os
import tempfile

import numpy as np

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.models.linear import LinearConfig, LinearTrainer
from ytk_mp4j_tpu_torch.utils.libsvm import dense_chunks, read_libsvm

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()
mesh = make_mesh(args.n, args.device)

rng = np.random.default_rng(0)
N, F = 6_000, 6

# -- regression -------------------------------------------------------
w_true = rng.standard_normal(F).astype(np.float32)
X = rng.standard_normal((N, F)).astype(np.float32)
y = X @ w_true + 0.05 * rng.standard_normal(N).astype(np.float32)
reg = LinearTrainer(LinearConfig(n_features=F, loss="squared",
                                 learning_rate=0.3, momentum=0.9),
                    mesh=mesh)
params, losses = reg.fit(X, y, n_steps=60)
werr = np.abs(params[0].cpu().numpy() - w_true).max()
print(f"squared: loss {losses[0]:.3f} -> {losses[-1]:.4f}, "
      f"|w - w_true| = {werr:.3f}")
assert losses[-1] < 0.01

# -- binary logistic with L1 sparsity ---------------------------------
# only features 0 and 1 are informative; the proximal L1 shrink must
# zero (most of) the other four
yb = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
logit = LinearTrainer(LinearConfig(n_features=F, loss="logistic",
                                   learning_rate=0.5, l1=3e-2), mesh=mesh)
params, losses = logit.fit(X, yb, n_steps=80)
acc = ((logit.predict(params, X).cpu().numpy() > 0.5) == yb).mean()
nnz = int((params[0].abs() > 1e-6).sum())
print(f"logistic: acc {acc:.3f}, {nnz}/{F} nonzero weights (L1)")
assert acc > 0.9 and nnz < F

# -- multiclass softmax with early stopping ---------------------------
C = 3
centers = rng.standard_normal((C, F)).astype(np.float32) * 2.5
yc = rng.integers(0, C, N).astype(np.int32)
Xc = centers[yc] + rng.standard_normal((N, F)).astype(np.float32)
mc = LinearTrainer(LinearConfig(n_features=F, loss="softmax", n_classes=C,
                                learning_rate=0.5, momentum=0.9),
                   mesh=mesh)
params, losses = mc.fit(Xc[:5000], yc[:5000], n_steps=150,
                        eval_set=(Xc[5000:], yc[5000:]),
                        early_stopping_rounds=8)
proba = mc.predict(params, Xc[5000:]).cpu().numpy()
acc = (proba.argmax(1) == yc[5000:]).mean()
print(f"softmax: {len(losses)} rounds kept "
      f"(eval history {len(mc.eval_history_)}), holdout acc {acc:.3f}")
assert acc > 0.9
np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)

# -- persistence: save, reload, serve identically ---------------------
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "mc_linear.npz")
    mc.save_params(path, params)
    cfg2, params2 = LinearTrainer.load_params(path, LinearConfig)
serve = LinearTrainer(cfg2, n_devices=1, device=mesh.device)
np.testing.assert_allclose(serve.predict(params2, Xc[5000:]).cpu().numpy(),
                           proba, rtol=1e-6)
print("saved, reloaded, and served identically")

# -- streaming: the same libsvm text the FFM family consumes ----------
lines = [f"{int(yb[i])} " + " ".join(f"{j}:{X[i, j]:.4f}"
                                     for j in range(F))
         for i in range(2000)]
streamer = LinearTrainer(LinearConfig(n_features=F, loss="logistic",
                                      learning_rate=0.5), mesh=mesh)
sparams = None
for _ in range(6):   # 6 epochs, chunked, double-buffered
    sparams, slosses = streamer.fit_stream(
        dense_chunks(read_libsvm(iter(lines), chunk_rows=500,
                                 max_nnz=F), F),
        params=sparams, batch_rows=500)
sacc = ((streamer.predict(sparams, X[:2000]).cpu().numpy() > 0.5)
        == (yb[:2000] > 0.5)).mean()
print(f"streamed logistic from libsvm text: acc {sacc:.3f}")
assert sacc > 0.9
