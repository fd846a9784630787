"""Distributed correctness check program — thread (hybrid) level.

A copy of ``ytk_mp4j_tpu/check/checkthread.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

The thread-family counterpart of ``checkprocess`` (the reference ships
separate checkprocess/checkthread program families, SURVEY.md section 4):
one ``main()`` per PROCESS spawns ``--threads`` ThreadCommSlave endpoints
(joining a master when ``--master`` is given — the hybrid process x
thread job of SURVEY.md section 3d), runs every dense and map collective
on seeded per-global-rank data concurrently from all threads, and
compares with locally-computed expected values. Exit code 0 iff all
checks pass in this process.

Launch (2 processes x 3 threads, loopback):

    python -m ytk_mp4j_tpu_torch.comm.master --port 9999 --slaves 2 &
    for i in 0 1; do
        python -m ytk_mp4j_tpu_torch.check.checkthread \
            --master localhost:9999 --threads 3 &
    done

Standalone (pure-thread job, no master):

    python -m ytk_mp4j_tpu_torch.check.checkthread --threads 4
"""

from __future__ import annotations

import argparse
import sys
import threading
import traceback

import numpy as np

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.check._oracle import expected_reduce, rank_data
from ytk_mp4j_tpu_torch.comm.thread_comm import ThreadCommSlave
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators

SEED_BASE = 2000


def rank_map(rank: int, n: int) -> dict:
    # overlapping keys across ranks so merges are exercised
    return {f"k{(rank + j) % (n + 2)}": float(rank * 10 + j)
            for j in range(3)}


def check(slave: ThreadCommSlave, length: int = 129) -> int:
    """Run the battery on one thread endpoint; returns failure count."""
    n, r = slave.slave_num, slave.rank
    fails = 0

    def expect(name, ok):
        nonlocal fails
        if not ok:
            fails += 1
            slave.error(f"{name} MISMATCH")

    def expect_arr(name, got, want, exact):
        expect(name, np.array_equal(got, want) if exact
               else np.allclose(got, want, rtol=1e-5, atol=1e-6))

    for operand in (Operands.DOUBLE, Operands.FLOAT, Operands.INT):
        exact = operand.dtype.kind != "f"
        alls = [rank_data(q, length, operand, SEED_BASE) for q in range(n)]
        ranges = meta.partition_range(0, length, n)
        for op_name in ("SUM", "MAX"):
            op = Operators.by_name(op_name)
            want = expected_reduce(alls, op_name)
            # allreduce
            arr = alls[r].copy()
            slave.allreduce_array(arr, operand, op)
            expect_arr(f"allreduce/{operand.name}/{op_name}", arr, want,
                       exact)
            # reduce into global rank 1 (crosses thread AND process
            # boundaries whenever they exist)
            root = 1 % n
            arr = alls[r].copy()
            slave.reduce_array(arr, operand, op, root=root)
            if r == root:
                expect_arr(f"reduce/{operand.name}/{op_name}", arr, want,
                           exact)
            # reduce_scatter: my global-rank segment
            arr = alls[r].copy()
            slave.reduce_scatter_array(arr, operand, op)
            s, e = ranges[r]
            expect_arr(f"reduce_scatter/{operand.name}/{op_name}",
                       arr[s:e], want[s:e], exact)
        # broadcast from the last global rank
        root = n - 1
        arr = alls[r].copy()
        slave.broadcast_array(arr, operand, root=root)
        expect_arr(f"broadcast/{operand.name}", arr, alls[root], True)
        # allgather of per-global-rank segments
        arr = alls[r].copy()
        slave.allgather_array(arr, operand)
        want = np.concatenate(
            [alls[q][s:e] for q, (s, e) in enumerate(ranges)])
        expect_arr(f"allgather/{operand.name}", arr, want, True)
        # gather to global rank 0
        arr = alls[r].copy()
        slave.gather_array(arr, operand, root=0)
        if r == 0:
            expect_arr(f"gather/{operand.name}", arr, want, True)
        # scatter from global rank 0
        arr = alls[r].copy()
        slave.scatter_array(arr, operand, root=0)
        s, e = ranges[r]
        expect_arr(f"scatter/{operand.name}", arr[s:e], alls[0][s:e], True)
        slave.barrier()

    # map collectives (the reference's sparse Map family, SURVEY.md 3c)
    maps = [rank_map(q, n) for q in range(n)]
    want_merged: dict = {}
    for m in maps:
        for k, v in m.items():
            want_merged[k] = want_merged.get(k, 0.0) + v
    d = dict(maps[r])
    slave.allreduce_map(d, Operands.DOUBLE, Operators.SUM)
    expect("allreduce_map", d == want_merged)

    d = dict(maps[r])
    slave.reduce_map(d, Operands.DOUBLE, Operators.SUM, root=0)
    if r == 0:
        expect("reduce_map", d == want_merged)

    d = dict(maps[0]) if r == 0 else {}
    slave.broadcast_map(d, Operands.DOUBLE, root=0)
    expect("broadcast_map", d == maps[0])

    # disjoint per-rank keys for gather/allgather
    d = {f"r{r}": float(r)}
    slave.allgather_map(d, Operands.DOUBLE)
    expect("allgather_map",
           d == {f"r{q}": float(q) for q in range(n)})

    d = dict(maps[r])
    slave.reduce_scatter_map(d, Operands.DOUBLE, Operators.SUM)
    expect("reduce_scatter_map",
           d == {k: v for k, v in want_merged.items()
                 if meta.key_partition(k, n) == r})

    # thread-only synchronization primitive
    slave.thread_barrier()
    slave.barrier()
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--master", default=None,
                    help="host:port (omit for a standalone thread group)")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--length", type=int, default=129)
    args = ap.parse_args(argv)
    if args.master is not None:
        host, port = args.master.rsplit(":", 1)
        slaves = ThreadCommSlave.spawn_group(args.threads, host, int(port))
    else:
        slaves = ThreadCommSlave.spawn_group(args.threads)

    fails = [0] * args.threads
    errors: list[BaseException] = []

    def worker(t: int):
        try:
            fails[t] = check(slaves[t], args.length)
            slaves[t].info(f"check done: {fails[t]} failures")
            slaves[t].close(0 if fails[t] == 0 else 1)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)
            slaves[t].close(2)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(args.threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    if errors:
        traceback.print_exception(errors[0])
        return 2
    if any(th.is_alive() for th in threads):
        print("checkthread: worker hung", file=sys.stderr)
        return 3
    return 0 if sum(fails) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
