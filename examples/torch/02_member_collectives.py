"""The functional layer: collectives inside your own step function (the
mirror of ``examples/02_in_jit_collectives.py``).

Where the reference writes a ``shard_map`` body that calls ``psum``, the
port holds the members of ``device.make_mesh(n)`` as the rows of one
``[n, ...]`` tensor on one device and calls ``ops.collectives`` on it:
no host round-trips between your compute and the collective.

    python examples/torch/02_member_collectives.py [--device cpu] [--n 8]
"""
import argparse

import numpy as np
import torch

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.operators import Operators
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import sparse as sparse_ops

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()

mesh = make_mesh(args.n, args.device)   # n members on one device
n = mesh.n


def train_step(x):
    grad = torch.sin(x) * 2.0                   # your compute, [n, 8]
    return coll.allreduce(grad, Operators.SUM)  # members folded in order


x = torch.ones((n, 8), dtype=torch.float32, device=mesh.device)
print("dense:", train_step(x)[0, :3].cpu().numpy())


# sparse allreduce over members: static-capacity (index, value) buffers
def sparse_step(idx, val):
    return sparse_ops.sparse_allreduce(idx, val, capacity=8,
                                       operator=Operators.SUM)


idx = np.full((n, 4), sparse_ops.SENTINEL, np.int32)
val = np.zeros((n, 4), np.float32)
for r in range(n):
    idx[r, 0] = r % 3          # each rank touches one "key code"
    val[r, 0] = float(r + 1)
oi, ov = sparse_step(torch.from_numpy(idx).to(mesh.device),
                     torch.from_numpy(val).to(mesh.device))
# every member holds the same union: print member 0's
print("sparse:", oi[0].cpu().numpy()[:3], ov[0].cpu().numpy()[:3])
