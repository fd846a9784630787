"""Streaming FFM ingestion -- the Criteo-scale consumer flow: a
libffm-format text file streamed chunk by chunk through
``FMTrainer.fit_stream`` (one step per chunk, never more than one chunk
in host memory), checked against the in-memory fit on the same data (the
mirror of ``examples/10_ffm_streaming.py``).

Text parses through the native C++ chunk scanner (csrc/mp4j_parse.cpp),
chunk k+1 stages through pinned memory while the device runs step k
(``fit_stream`` double-buffers; ``max_in_flight=0`` would serialize), and
with ``table_sharding="sharded"`` the same loop shards the vocabulary
over the members.

    python examples/torch/10_ffm_streaming.py [--device cpu] [--n 8]
"""
import argparse
import os
import tempfile

import numpy as np

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.models.fm import FMConfig, FMTrainer
from ytk_mp4j_tpu_torch.utils.libsvm import read_libsvm

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()
mesh = make_mesh(args.n, args.device)

rng = np.random.default_rng(0)
N, VOCAB, FIELDS, NNZ = 4_000, 512, 4, 4
feats = np.stack([rng.integers(f * (VOCAB // FIELDS),
                               (f + 1) * (VOCAB // FIELDS), N)
                  for f in range(NNZ)], axis=1).astype(np.int32)
fields = np.broadcast_to(np.arange(NNZ, dtype=np.int32) % FIELDS,
                         (N, NNZ)).copy()
vals = np.ones((N, NNZ), np.float32)
y = ((feats[:, 0] + feats[:, 1]) % 2).astype(np.float32)

cfg = FMConfig(n_features=VOCAB, n_fields=FIELDS, k=8, max_nnz=NNZ,
               model="ffm", learning_rate=0.5, init_scale=0.1)
CHUNK = 1_000

with tempfile.TemporaryDirectory() as tmp:
    # write the libffm file the way ytk-learn would consume it
    path = os.path.join(tmp, "train.ffm")
    with open(path, "w") as fh:
        for i in range(N):
            toks = " ".join(f"{fields[i, j]}:{feats[i, j]}:{vals[i, j]:.1f}"
                            for j in range(NNZ))
            fh.write(f"{y[i]:.0f} {toks}\n")

    # stream: 3 passes over the file, one optimizer step per chunk
    streamer = FMTrainer(cfg, mesh=mesh, sparse_grads=True)
    params = streamer.init_params(seed=1)
    stream_losses = []
    for epoch in range(3):
        params, losses = streamer.fit_stream(
            read_libsvm(path, chunk_rows=CHUNK, max_nnz=NNZ),
            params=params, batch_rows=CHUNK)
        stream_losses.extend(losses.tolist())
        print(f"epoch {epoch}: mean chunk loss {losses.mean():.4f}")

# reference: the same data fit in memory
memory = FMTrainer(cfg, mesh=mesh, sparse_grads=True)
mem_params, mem_losses = memory.fit(feats, fields, vals, y, n_steps=12,
                                    seed=1)

acc = float(np.mean(
    (streamer.predict(params, feats, fields, vals).cpu().numpy() > 0.5)
    == (y > 0.5)))
print(f"stream final loss {stream_losses[-1]:.4f} "
      f"(in-memory {mem_losses[-1]:.4f}), train acc {acc:.3f}")
assert stream_losses[-1] < stream_losses[0]
