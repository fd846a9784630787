"""Device-path collectives with GpuCommCluster (the mirror of
``examples/01_tpu_cluster.py``).

n collective members on one card (``--n``, default 8: the reference's
8-device rig), or on the CPU with ``--device cpu``:

    python examples/torch/01_gpu_cluster.py            # cuda:0
    python examples/torch/01_gpu_cluster.py --device cpu

The dense allreduce runs ``algo="rdma"``, the hand-written CUDA ring
kernel (its plain version on the CPU); the reference's default schedule
gives the same sums.
"""
import argparse

import numpy as np
import torch

from ytk_mp4j_tpu_torch import trace, trace_collectives
from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operator, Operators

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=8)
args = ap.parse_args()

cluster = GpuCommCluster(args.n, args.device)  # GpuCommCluster(5) works too
n = cluster.slave_num
print(f"{n} rank(s)")

with trace_collectives():
    # dense allreduce, in place across per-rank buffers, on the ring kernel
    arrs = [np.full(1 << 16, float(r + 1), np.float32) for r in range(n)]
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM,
                            algo="rdma")
    assert arrs[0][0] == sum(range(1, n + 1))

    # sub-range semantics (the reference's [from, to))
    arrs = [np.arange(10, dtype=np.float32) for _ in range(n)]
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM,
                            from_=2, to=6)

    # reduce-scatter + allgather over per-rank segments
    arrs = [np.ones(13, np.float32) * (r + 1) for r in range(n)]
    cluster.reduce_scatter_array(arrs, Operands.FLOAT, Operators.SUM)
    cluster.allgather_array(arrs, Operands.FLOAT)

    # sparse Map<K, V> operands (keys on host, values on device)
    maps = [{f"w:{r % 3}": np.ones(4, np.float32) * r} for r in range(n)]
    cluster.allreduce_map(maps, Operands.FLOAT, Operators.SUM)

    # pipelined map allreduce: chain dispatches, resolve later -- the
    # deferred handles overlap host encodes with device work
    step1 = [{r: 1.0} for r in range(n)]
    step2 = [{r + 1: 2.0} for r in range(n)]
    h1 = cluster.allreduce_map_async(step1, Operands.FLOAT,
                                     Operators.SUM)
    h2 = cluster.allreduce_map_async(step2, Operands.FLOAT,
                                     Operators.SUM)
    h1.result(), h2.result()                 # mutates in place, like
    assert len(step1[0]) == n                # the sync call

    # user-defined operator: on the device the reduction runs on tensors,
    # so write it with torch ops (it also runs on host numpy inputs
    # through ``fn``)
    absmax = Operator.custom(
        "ABSMAX",
        lambda x, y: np.where(np.abs(x) >= np.abs(y), x, y), 0.0,
        torch_fn=lambda x, y: torch.where(x.abs() >= y.abs(), x, y))
    arrs = [np.full(8, float(r - 1), np.float32) for r in range(n)]
    cluster.allreduce_array(arrs, Operands.FLOAT, absmax)

print(trace.format_summary())
