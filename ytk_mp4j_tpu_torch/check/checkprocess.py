"""Distributed correctness check program — process (socket) level.

A copy of ``ytk_mp4j_tpu/check/checkprocess.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

Mirrors the reference's ``check/`` strategy (SURVEY.md section 4): a
``main()`` run as N real slave processes against a master, executing
every dense collective on seeded data and comparing with locally-computed
expected values. Exit code 0 iff all checks pass on this rank.

Launch (one master + N slaves, loopback):

    python -m ytk_mp4j_tpu_torch.comm.master --port 9999 --slaves 4 &
    for i in 0 1 2 3; do
        python -m ytk_mp4j_tpu_torch.check.checkprocess --master localhost:9999 &
    done
"""

from __future__ import annotations

import argparse
import sys
import traceback

import numpy as np

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.check._oracle import expected_reduce, rank_data
from ytk_mp4j_tpu_torch.comm.process_comm import ProcessCommSlave
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators

SEED_BASE = 1000


def all_rank_data(n, length, operand):
    return [rank_data(r, length, operand, SEED_BASE) for r in range(n)]


def check(slave: ProcessCommSlave, length: int = 257) -> int:
    """Run the battery; returns number of failures."""
    n, r = slave.slave_num, slave.rank
    fails = 0

    def expect(name, got, want, exact):
        nonlocal fails
        ok = (np.array_equal(got, want) if exact
              else np.allclose(got, want, rtol=1e-5, atol=1e-6))
        if not ok:
            fails += 1
            slave.error(f"{name} MISMATCH")

    for operand in (Operands.DOUBLE, Operands.FLOAT, Operands.INT,
                    Operands.LONG):
        exact = operand.dtype.kind != "f"
        for op_name in ("SUM", "PROD", "MAX", "MIN"):
            op = Operators.by_name(op_name)
            alls = all_rank_data(n, length, operand)
            # allreduce
            arr = alls[r].copy()
            slave.allreduce_array(arr, operand, op)
            expect(f"allreduce/{operand.name}/{op_name}", arr,
                   expected_reduce(alls, op_name), exact)
            # reduce (root 0)
            arr = alls[r].copy()
            slave.reduce_array(arr, operand, op, root=0)
            if r == 0:
                expect(f"reduce/{operand.name}/{op_name}", arr,
                       expected_reduce(alls, op_name), exact)
            # reduce_scatter
            arr = alls[r].copy()
            ranges = meta.partition_range(0, length, n)
            slave.reduce_scatter_array(arr, operand, op)
            s, e = ranges[r]
            expect(f"reduce_scatter/{operand.name}/{op_name}", arr[s:e],
                   expected_reduce(alls, op_name)[s:e], exact)
        # broadcast (root 1 if exists)
        root = 1 % n
        alls = all_rank_data(n, length, operand)
        arr = alls[r].copy()
        slave.broadcast_array(arr, operand, root=root)
        expect(f"broadcast/{operand.name}", arr, alls[root], True)
        # allgather
        ranges = meta.partition_range(0, length, n)
        arr = alls[r].copy()
        slave.allgather_array(arr, operand)
        want = np.concatenate([alls[q][s:e] for q, (s, e) in enumerate(ranges)])
        expect(f"allgather/{operand.name}", arr, want, True)
        # gather (root 0)
        arr = alls[r].copy()
        slave.gather_array(arr, operand, root=0)
        if r == 0:
            expect(f"gather/{operand.name}", arr, want, True)
        # scatter (root 0)
        arr = alls[r].copy()
        slave.scatter_array(arr, operand, root=0)
        s, e = ranges[r]
        expect(f"scatter/{operand.name}", arr[s:e], alls[0][s:e], True)
        slave.barrier()
    # sub-range allreduce
    operand = Operands.DOUBLE
    alls = all_rank_data(n, 64, operand)
    arr = alls[r].copy()
    slave.allreduce_array(arr, operand, Operators.SUM, from_=10, to=50)
    want = alls[r].copy()
    want[10:50] = expected_reduce(alls, "SUM")[10:50]
    expect("allreduce/subrange", arr, want, False)
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--master", required=True, help="host:port")
    ap.add_argument("--length", type=int, default=257)
    args = ap.parse_args(argv)
    host, port = args.master.rsplit(":", 1)
    slave = ProcessCommSlave(host, int(port))
    try:
        fails = check(slave, args.length)
        slave.info(f"check done: {fails} failures")
        slave.close(0 if fails == 0 else 1)
        return 0 if fails == 0 else 1
    except Exception:
        traceback.print_exc()
        slave.close(2)
        return 2


if __name__ == "__main__":
    sys.exit(main())
