"""The socket plane: a self-contained master + 4 slaves job on loopback
TCP (the mirror of ``examples/03_socket_job.py``; in threads here, in
production each slave is its own process pointed at the master's
host:port, see README).

Each slave computes its payload on the device (``--device``, default
``cuda``) and the socket plane carries it as host memory.

    python examples/torch/03_socket_job.py [--device cpu]
"""
import argparse
import threading

import numpy as np
import torch

from ytk_mp4j_tpu_torch.comm.master import Master
from ytk_mp4j_tpu_torch.comm.process_comm import ProcessCommSlave
from ytk_mp4j_tpu_torch.device import make_device
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = make_device(args.device)

N = 4
master = Master(N, timeout=30.0).serve_in_thread()


def slave_main():
    s = ProcessCommSlave("127.0.0.1", master.port, timeout=30.0)
    s.info(f"slave {s.rank}/{s.slave_num} up")

    # size-aware allreduce (default algo="auto": tree / recursive
    # halving / pipelined ring by payload size; README Transport tuning)
    grad = torch.full((1000,), float(s.rank + 1), dtype=torch.float64,
                      device=dev)
    arr = grad.cpu().numpy()
    s.allreduce_array(arr, Operands.DOUBLE, Operators.SUM)
    assert arr[0] == sum(range(1, N + 1))
    grad.copy_(torch.from_numpy(arr))        # back onto the device

    # compressed operand: zlib on the wire for compressible payloads
    zeros = np.zeros(100_000)
    s.allreduce_array(zeros, Operands.compressed(Operands.DOUBLE),
                      Operators.SUM)

    # sparse map allreduce (pickle standing in for Kryo)
    d = {f"grad:{s.rank % 2}": float(s.rank)}
    s.allreduce_map(d, Operands.DOUBLE, Operators.SUM)

    s.barrier()
    s.info(f"done: {sorted(d.items())}")
    s.close(0)


threads = [threading.Thread(target=slave_main) for _ in range(N)]
for t in threads:
    t.start()
for t in threads:
    t.join()
master.join()
print("job exit code:", master.final_code)
