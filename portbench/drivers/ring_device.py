"""Dense ring collectives on device tensors, a closed loop of calls.

Each item of the loop is ``ops.ring_kernel.ring_reduce_scatter_kernel``
over the members' packed inputs, then ``ring_allgather_kernel`` over its
result (together an allreduce): the path ``GpuCommCluster(algo="rdma")``
takes once its arrays are staged. Each call is timed on the host clock
from its start to a synchronised end. Set-up makes the inputs on the
device from the seed and warms up with two items (the second while the
first's outputs are still held, as a judged item's are in the window).

Judged (``reference/ring.py``): one item of the window drawn from the
seed; its reduce-scatter against the float64 sum of the inputs, its
allgather against its reduce-scatter's rows, bitwise.

Traffic: ``members``, ``length`` (a member's input, elements),
``dtype``, ``checked_items``.
"""

from __future__ import annotations

import time
import types

import torch

from portbench import roofline
from portbench.reference import ring as ref
from portbench.sampling import Reservoir, generator


def setup(ctx):
    from ytk_mp4j_tpu_torch.ops import ring_kernel

    tr = ctx.traffic
    dev = torch.device(ctx.device)
    st = types.SimpleNamespace(ctx=ctx, rk=ring_kernel, n=tr["members"],
                               length=tr["length"], dtype=tr["dtype"])
    gen = generator(ctx.seed, dev)
    st.x = torch.randn((st.n, st.length), generator=gen, device=dev,
                       dtype=getattr(torch, st.dtype))
    st.sample = Reservoir(tr["checked_items"], ctx.seed)
    st.calls, st.call_s, st.bus = [], [], 0.0
    held = _item(st)                      # warm-up: two items, the first
    _item(st)                             # held while the second runs
    del held
    st.calls, st.call_s, st.bus = [], [], 0.0
    return st


def _sync(st):
    if st.x.device.type == "cuda":
        torch.cuda.synchronize(st.x.device)


def _call(st, mode, fn, arg, length):
    t = time.perf_counter()
    out = fn(arg)
    _sync(st)
    st.call_s.append(time.perf_counter() - t)
    st.calls.append((mode, st.n, length, st.dtype))
    st.bus += roofline.bus_bytes(mode, st.n, length, st.dtype)
    return out


def _item(st):
    rs = _call(st, "reduce_scatter", st.rk.ring_reduce_scatter_kernel, st.x,
               st.length)
    ag = _call(st, "allgather", st.rk.ring_allgather_kernel, rs,
               st.length // st.n)
    return rs, ag


def step(st):
    slot = st.sample.slot()
    out = _item(st)
    if slot is not None:
        st.sample.items[slot] = out


def drain(st):
    _sync(st)


def record(st):
    return {"calls": len(st.call_s), "call_s": list(st.call_s),
            "bus_bytes": st.bus}


class _Probe:
    def __init__(self, st):
        self.st = st

    def begin(self):
        self.first = len(self.st.calls)

    def end(self):
        return {"calls": self.st.calls[self.first:]}


def probe(st):
    return _Probe(st)


def traced_items(st, items):
    return {"ring_calls": items["calls"]}


def check(st):
    attempted = len(st.call_s)
    kept = st.sample.kept()
    worst = {"rs_err": 0.0, "ag_mismatch": 0.0}
    limits, failed = st.ctx.limits, 0
    for rs, ag in kept:
        nums = judge(st.x, rs, ag)
        failed += any(v > limits[k] for k, v in nums.items())
        worst = {k: max(worst[k], nums[k]) for k in worst}
    return attempted, failed, {k: (v, limits[k]) for k, v in worst.items()}


def judge(x, rs, ag):
    """rs_err: the reduce-scatter's worst element against the exact sum;
    ag_mismatch: elements of the allgather that differ from the
    reduce-scatter's rows laid end to end."""
    n, length = x.shape
    if tuple(rs.shape) != (n, length // n) or tuple(ag.shape) != (n, length):
        return {"rs_err": float("inf"), "ag_mismatch": float("inf")}
    rs_err = ref.worst_gap(rs.reshape(-1), x)
    flat = rs.reshape(-1)
    mismatch = sum(int((ag[r] != flat).sum().item()) for r in range(n))
    return {"rs_err": rs_err, "ag_mismatch": float(mismatch)}


def control(ctx):
    """The numbers of the control: ``reference.ring.control_sum`` (one
    precision below the operand's) in the program's place."""
    tr = ctx.traffic
    n, length = tr["members"], tr["length"]
    x = torch.randn((n, length), generator=generator(ctx.seed, ctx.device),
                    device=ctx.device, dtype=getattr(torch, tr["dtype"]))
    rs = ref.control_sum(x).reshape(n, length // n)
    return [judge(x, rs, rs.reshape(1, -1).expand(n, -1))]
