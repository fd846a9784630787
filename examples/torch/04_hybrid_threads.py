"""Hybrid process x thread nesting (the reference's ThreadCommSlave; the
mirror of ``examples/04_hybrid_threads.py``): threads reduce through
shared memory, thread 0 runs the process-level collective, results fan
back out. Here: one process, 4 threads (pass master args to spawn_group
to join a multi-process job).

Each thread computes its payload on the device (``--device``, default
``cuda``); the thread plane carries it as host memory.

    python examples/torch/04_hybrid_threads.py [--device cpu]
"""
import argparse
import threading

import torch

from ytk_mp4j_tpu_torch.comm.thread_comm import ThreadCommSlave
from ytk_mp4j_tpu_torch.device import make_device
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = make_device(args.device)

T = 4
slaves = ThreadCommSlave.spawn_group(T)  # standalone thread group


def thread_main(slave):
    r = slave.rank
    arr = torch.full((100,), float(r), dtype=torch.float32,
                     device=dev).cpu().numpy()
    slave.allreduce_array(arr, Operands.FLOAT, Operators.SUM)
    assert arr[0] == sum(range(T))

    slave.thread_barrier()               # the reference's threadBarrier()

    d = {f"k{r}": float(r)}
    slave.allgather_map(d, Operands.DOUBLE)
    assert len(d) == T

    slave.close(0)
    return arr


threads = [threading.Thread(target=thread_main, args=(s,)) for s in slaves]
for t in threads:
    t.start()
for t in threads:
    t.join()
print("hybrid group done")
