"""The transport schedules, side by side (the mirror of
``examples/08_ring_transports.py``).

The same allreduce runs as (1) the members folded in rank order, (2) a
ring of neighbour sends scheduled as torch ops, (3) the hand-written
CUDA ring kernel that owns the transport itself (one thread-block
cluster a ring: peer stores into the neighbour's slots, credit
backpressure; its plain version on the CPU), and (4) the bidirectional
variant that rings the buffer's halves in opposite directions --
selectable per call on the driver API and callable on your own member
tensors.

    python examples/torch/08_ring_transports.py [--device cpu] [--n 8]
"""
import argparse

import numpy as np
import torch

from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import ring, ring_kernel

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()

cluster = GpuCommCluster(args.n, args.device)
n = cluster.slave_num
print(f"{n} rank(s)")

# -- driver API: same call, three schedules, identical results --------
# analytic ground truth, not a self-comparison: sum_r (r+1) * iota
want = np.arange(1000, dtype=np.float32) * (n * (n + 1) / 2)
for algo in ("xla", "ring", "rdma"):
    arrs = [np.arange(1000, dtype=np.float32) * (r + 1) for r in range(n)]
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM, algo=algo)
    assert np.allclose(arrs[0], want, rtol=1e-5)
    print(f"algo={algo:4s}: ok (first elems {arrs[0][:3]})")

# -- functional layer: the same schedules on your member tensors ------
mesh = make_mesh(n, args.device)
data = np.tile(np.arange(n, dtype=np.float32)[:, None], (1, 16 * n))


def four_ways(x):
    a = coll.allreduce(x, Operators.SUM)
    b = ring.ring_allreduce(x, Operators.SUM)
    c = ring_kernel.ring_allreduce_kernel(x, Operators.SUM)
    # both directions of every member's links busy at once
    d = ring_kernel.ring_allreduce_kernel(x, Operators.SUM,
                                          bidirectional=True)
    return a, b, c, d


a, b, c, d = four_ways(torch.from_numpy(data).to(mesh.device))
want = data.sum(0)
for name, out in (("member fold", a), ("ring of sends", b),
                  ("ring kernel", c), ("ring kernel bidirectional", d)):
    assert np.allclose(out[0].cpu().numpy(), want, rtol=1e-5)
    print(f"member tensors {name}: ok")
print("all transports agree")
