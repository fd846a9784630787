"""Device-path correctness check: the counterpart of
``ytk_mp4j_tpu/check/checktpu.py`` for the port.

Exercises every collective x operator x device operand on both device
families of the port --

- ``GpuCommCluster`` (driver mode, host buffers in and out), and
- ``ops.collectives`` / ``ops.ring`` / ``ops.sparse`` on ``[n, L]`` member
  tensors (the functional path the trainers call) --

against numpy oracles (``check/_oracle.py``), with the reference's check
names, ``Tally`` and tolerances (floats to rtol 1e-4 / atol 1e-5, integers
exactly). On a CUDA device a third section runs both ring kernels
(``ops/ring_kernel``: one direction and two, allreduce / reduce-scatter /
allgather, ``force_kernel=True``) launched on the card, at n members (the
cluster path for n <= 8) and at one member (zero ring steps: the launch,
the slots and the exit barrier alone).

    python -m ytk_mp4j_tpu_torch.check.checkgpu [--n 8] [--out f.json]
    python -m ytk_mp4j_tpu_torch.check.checkgpu --device cpu --cpu-mesh-n 0
    python -m ytk_mp4j_tpu_torch.check.checkgpu --devices cuda:0,cuda:0

``--devices`` (a comma-separated list; ``--n`` defaults to its length)
runs the battery over a list mesh, member r on its r-th entry, as the
reference's ``_run_battery(n, devices=)``: ``GpuCommCluster(mesh=
make_mesh(n, devices=...))`` with its map family, the functional and
sparse collectives on member lists and the ring kernels launched a
member at a time; the CPU section then runs over a CPU list too. Every
part runs over the list: the check names and counts are the packed
battery's (618 at n = 8).

Divergences from the reference: without ``--devices`` the n members of
a section are rows of one tensor on one device (``device.make_mesh(n)``),
so ``--n`` (default 8) counts members, not devices, and n > 1 executes
cross-member semantics on one card; ``--device`` (default ``cuda``) picks the device, and without
CUDA the default exits non-zero with ``Mp4jError``'s message -- the CPU
runs only when asked; DOUBLE and LONG always run (there is no x64
switch); the CPU section (``--cpu-mesh-n``, default 8) runs the same
battery on ``device="cpu"``, where every function computes its plain
version; the native-reduce probe is the port's static table
(``ops.collectives.NATIVE``).

Exit code 0 iff every check passes; the artifact records the device,
the member count and, per section, the pass count, the failures and how
many times each named check ran.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from collections import Counter

import numpy as np
import torch

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.check._oracle import expected_reduce, rank_data
from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster
from ytk_mp4j_tpu_torch.device import make_device, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import ring
from ytk_mp4j_tpu_torch.ops import sparse as sparse_ops

SEED_BASE = 4200
OPS = ("SUM", "MAX", "MIN", "PROD")
DEFAULT_N = 8
# elements a chunk in the ring kernels' hardware section: one f32 tile of
# the reference's compiled kernel (its ``min_chunk_elems(float32)``), a
# multiple of the card's 16-byte granule in both directions
HW_CHUNK = 1024
OPERANDS = (Operands.FLOAT, Operands.INT, Operands.SHORT, Operands.BYTE,
            Operands.DOUBLE, Operands.LONG)


class Tally:
    def __init__(self):
        self.passed = 0
        self.failures: list[str] = []
        self.names: list[str] = []

    def expect(self, name: str, got, want, exact: bool):
        self.names.append(name)
        ok = (np.array_equal(got, want) if exact
              else np.allclose(got, want, rtol=1e-4, atol=1e-5))
        if ok:
            self.passed += 1
        else:
            self.failures.append(name)
            print(f"FAIL {name}", file=sys.stderr)


def _host(x) -> np.ndarray:
    return x.detach().to("cpu").numpy()


def _list(x, devices):
    """``[n, ...]`` host or device rows as a member list on ``devices``."""
    return [torch.as_tensor(x[r]).to(d) for r, d in enumerate(devices)]


def _rows(res):
    """A packed result or a member list, as host rows."""
    if isinstance(res, list):
        return np.stack([_host(t) for t in res])
    return _host(res)


def check_cluster(t: Tally, n: int, length: int = 192, device=None,
                  devices=None):
    """Driver mode: all 7 dense collectives x operators + map family."""
    if devices is None:
        cluster = GpuCommCluster(n, device=device)
    else:
        cluster = GpuCommCluster(mesh=make_mesh(n, devices=devices))
    for operand in OPERANDS:
        exact = operand.dtype.kind != "f"
        alls = [rank_data(r, length, operand, SEED_BASE) for r in range(n)]
        for op_name in OPS:
            op = Operators.by_name(op_name)
            arrs = [a.copy() for a in alls]
            cluster.allreduce_array(arrs, operand, op)
            want = expected_reduce(alls, op_name)
            for r in range(n):
                t.expect(f"cluster/allreduce/{operand.name}/{op_name}",
                         arrs[r], want, exact)
            arrs = [a.copy() for a in alls]
            cluster.reduce_array(arrs, operand, op, root=n - 1)
            t.expect(f"cluster/reduce/{operand.name}/{op_name}",
                     arrs[n - 1], want, exact)
            arrs = [a.copy() for a in alls]
            cluster.reduce_scatter_array(arrs, operand, op)
            for r, (s, e) in enumerate(meta.partition_range(0, length, n)):
                t.expect(f"cluster/reduce_scatter/{operand.name}/{op_name}",
                         arrs[r][s:e], want[s:e], exact)
        root = 1 % n
        arrs = [a.copy() for a in alls]
        cluster.broadcast_array(arrs, operand, root=root)
        for r in range(n):
            t.expect(f"cluster/broadcast/{operand.name}", arrs[r],
                     alls[root], True)
        ranges = meta.partition_range(0, length, n)
        want_cat = np.concatenate(
            [alls[q][s:e] for q, (s, e) in enumerate(ranges)])
        arrs = [a.copy() for a in alls]
        cluster.allgather_array(arrs, operand)
        for r in range(n):
            t.expect(f"cluster/allgather/{operand.name}", arrs[r],
                     want_cat, True)
        arrs = [a.copy() for a in alls]
        cluster.gather_array(arrs, operand, root=0)
        t.expect(f"cluster/gather/{operand.name}", arrs[0], want_cat, True)
        arrs = [a.copy() for a in alls]
        cluster.scatter_array(arrs, operand, root=0)
        for r, (s, e) in enumerate(ranges):
            t.expect(f"cluster/scatter/{operand.name}", arrs[r][s:e],
                     alls[0][s:e], True)
    # sparse map family (values ride the device)
    for op_name in OPS:
        op = Operators.by_name(op_name)
        maps = [{f"k{j}": float(r + j + 1) for j in range(r + 1)}
                for r in range(n)]
        want: dict = {}
        for m in maps:
            for k, v in m.items():
                want[k] = op.np_fn(want[k], v) if k in want else v
        cluster.allreduce_map(maps, Operands.FLOAT, op)
        for m in maps:
            t.expect(f"cluster/allreduce_map/{op_name}",
                     np.array([m.get(k, np.nan) for k in sorted(want)]),
                     np.array([want[k] for k in sorted(want)]), False)
    cluster.barrier()


def check_functional(t: Tally, n: int, length: int = 64, device=None,
                     devices=None):
    """The functional path: collectives on ``[n, L]`` member tensors (or
    member lists, given ``devices``)."""
    dev = make_device(device if devices is None else devices[0])
    length = ((length + n - 1) // n) * n  # reduce_scatter/ring need n | L
    alls = [np.random.default_rng(SEED_BASE + r)
            .standard_normal(length).astype(np.float32) for r in range(n)]
    stacked = np.stack(alls)  # [n, L]
    x = torch.from_numpy(stacked).to(dev)
    # the members' sparse buffers: two keys a member, disjoint
    idx_np = np.stack([np.array([r, n + r], np.int32) for r in range(n)])
    val_np = np.stack([np.array([1.0, 2.0], np.float32) for r in range(n)])
    idx, val = torch.from_numpy(idx_np).to(dev), torch.from_numpy(
        val_np).to(dev)
    if devices is not None:
        members = make_mesh(n, devices=devices).devices
        x = _list(stacked, members)
        idx, val = _list(idx_np, members), _list(val_np, members)
    custom = Operator.custom(
        "ABSMAX", lambda a, b: np.maximum(np.abs(a), np.abs(b)), 0.0,
        torch_fn=lambda a, b: torch.maximum(torch.abs(a), torch.abs(b)))

    cases = {
        "allreduce_sum": (lambda: coll.allreduce(x, Operators.SUM),
                          lambda: expected_reduce(alls, "SUM")[None]
                          .repeat(n, 0)),
        "allreduce_max": (lambda: coll.allreduce(x, Operators.MAX),
                          lambda: expected_reduce(alls, "MAX")[None]
                          .repeat(n, 0)),
        "allreduce_min": (lambda: coll.allreduce(x, Operators.MIN),
                          lambda: expected_reduce(alls, "MIN")[None]
                          .repeat(n, 0)),
        "allreduce_prod": (lambda: coll.allreduce(x, Operators.PROD),
                           lambda: expected_reduce(alls, "PROD")[None]
                           .repeat(n, 0)),
        # a singleton reduction applies the binary op n-1 = 0 times, so a
        # non-idempotent custom op returns the input unchanged at n=1
        "allreduce_custom": (lambda: coll.allreduce(x, custom),
                             lambda: (stacked if n == 1 else
                                      np.abs(stacked).max(0)[None]
                                      .repeat(n, 0))),
        "broadcast": (lambda: coll.broadcast(x, 0),
                      lambda: stacked[0][None].repeat(n, 0)),
        "reduce_scatter": (
            lambda: coll.reduce_scatter(x, Operators.SUM),
            lambda: expected_reduce(alls, "SUM").reshape(n, -1)),
        "ring_allreduce": (
            lambda: ring.ring_allreduce(x, Operators.SUM),
            lambda: expected_reduce(alls, "SUM")[None].repeat(n, 0)),
    }
    for name, (body, want) in cases.items():
        got = _rows(body()).reshape(n, -1)
        t.expect(f"functional/{name}", got, want().reshape(n, -1), False)
    # allgather replicates: every member holds every member's row
    t.expect("functional/allgather", _rows(coll.allgather(x, tiled=True)),
             stacked.reshape(1, -1).repeat(n, 0), False)
    # sparse allreduce on device
    oi, ov = sparse_ops.sparse_allreduce(idx, val, 2 * n, Operators.SUM)
    got = {int(i): float(v) for i, v in zip(_host(oi[0]), _host(ov[0]))
           if i != sparse_ops.SENTINEL}
    want = {r: 1.0 for r in range(n)}
    want.update({n + r: 2.0 for r in range(n)})
    t.expect("functional/sparse_allreduce",
             np.array(sorted(got.items())), np.array(sorted(want.items())),
             False)
    # sparse reduce-scatter: each member keeps its block-owned share
    size = 2 * n
    oi, ov = sparse_ops.sparse_reduce_scatter(idx, val, 2 * n, size,
                                              Operators.SUM)
    oi, ov = _rows(oi), _rows(ov)
    got_rs = {}
    for r in range(n):
        for i, v in zip(oi[r], ov[r]):
            if i != sparse_ops.SENTINEL:
                t.expect("functional/sparse_reduce_scatter/owner",
                         meta.owner_of(int(i), 0, size, n), r, True)
                got_rs[int(i)] = float(v)
    t.expect("functional/sparse_reduce_scatter",
             np.array(sorted(got_rs.items())),
             np.array(sorted(want.items())), False)
    # sparse allgather: disjoint-union pairs, sorted, duplicates kept
    oi, ov = (_host(a[0]) for a in sparse_ops.sparse_allgather(idx, val))
    live = oi != sparse_ops.SENTINEL
    t.expect("functional/sparse_allgather",
             np.array(sorted(zip(oi[live], ov[live]))),
             np.array(sorted((int(i), float(v))
                             for row_i, row_v in zip(idx_np, val_np)
                             for i, v in zip(row_i, row_v))), False)


def check_ring_kernels_hw(t: Tally, n: int, device=None, devices=None):
    """Launch both ring kernels -- all three collectives, one direction
    and two -- on the card, with ``force_kernel=True`` (at n = 1 that
    launches zero ring steps: the launch, the slots and the exit barrier;
    at n > 1 the full ring, on the cluster path for n <= 8; given
    ``devices``, one launch a member)."""
    from ytk_mp4j_tpu_torch.ops import ring_kernel as rk

    dev = make_device(device if devices is None else devices[0])
    L = 2 * HW_CHUNK * n
    alls = [np.random.default_rng(SEED_BASE + 77 + r)
            .standard_normal(L).astype(np.float32) for r in range(n)]
    stacked = np.stack(alls)
    want_sum = expected_reduce(alls, "SUM")
    shards = stacked[:, : L // n]        # per-member allgather input
    x = torch.from_numpy(stacked).to(dev)
    xs = torch.from_numpy(np.ascontiguousarray(shards)).to(dev)
    if devices is not None:
        members = make_mesh(n, devices=devices).devices
        x, xs = _list(stacked, members), _list(shards, members)

    for bidir in (False, True):
        tag = "bidir" if bidir else "uni"
        got = _rows(rk.ring_allreduce_kernel(
            x, Operators.SUM, bidirectional=bidir, force_kernel=True))
        t.expect(f"ring_kernel_hw/allreduce/{tag}", got,
                 want_sum[None].repeat(n, 0), False)
        got = _rows(rk.ring_reduce_scatter_kernel(
            x, Operators.SUM, bidirectional=bidir, force_kernel=True))
        t.expect(f"ring_kernel_hw/reduce_scatter/{tag}",
                 got.reshape(-1), want_sum, False)
        got = _rows(rk.ring_allgather_kernel(
            xs, bidirectional=bidir, force_kernel=True))
        t.expect(f"ring_kernel_hw/allgather/{tag}", got,
                 shards.reshape(-1)[None].repeat(n, 0), False)


def _section(checks, n: int, device, devices=None) -> dict:
    t = Tally()
    section: dict = {"n_members": n}
    if devices is not None:
        section["devices"] = [str(d) for d in devices[:n]]
    try:
        for check in checks:
            if devices is None:
                check(t, n, device=device)
            else:
                check(t, n, devices=devices)
        section["error"] = None
    except Exception:
        traceback.print_exc()
        section["error"] = traceback.format_exc(limit=3)
    section["passed"] = t.passed
    section["failures"] = t.failures
    section["checks"] = dict(Counter(t.names))
    section["ok"] = section["error"] is None and not t.failures
    return section


def _run_battery(n: int, device=None, devices=None) -> dict:
    """The battery at n members: packed on ``device``, or one member a
    ``devices`` entry (a list mesh), as the reference's
    ``_run_battery(n, devices=)``."""
    return _section((check_cluster, check_functional), n, device, devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    ap.add_argument("--n", type=int, default=None,
                    help="members (default 8, or the --devices count)")
    ap.add_argument("--cpu-mesh-n", type=int, default=8,
                    help="members of the CPU execution section "
                         "(0 disables)")
    ap.add_argument("--device", default="cuda",
                    help="cuda, cuda:k or cpu (default cuda)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated member devices: a list mesh, "
                         "member r on entry r (repeats allowed); --n "
                         "defaults to their count")
    args = ap.parse_args(argv)
    devices = (None if args.devices is None
               else [d.strip() for d in args.devices.split(",")])
    n = args.n or (DEFAULT_N if devices is None else len(devices))
    try:
        if devices is None:
            dev = make_device(args.device)
        else:
            dev = make_mesh(n, devices=devices).device
    except Mp4jError as e:
        print(f"checkgpu: {e}", file=sys.stderr)
        return 2
    result = {
        "platform": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "n_members": n,
        "native_reduce": sorted(coll.NATIVE),
    }
    if devices is not None:
        result["devices"] = devices[:n]
    if n == 1:
        result["identity_caveat"] = (
            "every collective over one member is an identity; this "
            "section proves the device runs each call, NOT cross-member "
            "semantics -- see the cpu_mesh section, or pass --n > 1")
    result.update(_run_battery(n, device=dev, devices=devices))

    if dev.type == "cuda":
        # the ring kernels launched on the card, at n members and at one
        hw = {}
        for m in sorted({n, 1}, reverse=True):
            sec = _section((check_ring_kernels_hw,), m, dev, devices)
            if m == 1:
                sec["caveat"] = (
                    "n=1 runs ZERO ring steps: the launch, the slots and "
                    "the exit barrier execute on the card, NOT cross-"
                    "member traffic")
            hw[f"n{m}"] = sec
        result["ring_kernel_hw"] = hw
        result["ok"] = result["ok"] and all(s["ok"] for s in hw.values())

    if args.cpu_mesh_n and dev.type == "cpu" and n >= args.cpu_mesh_n:
        # the main section already ran this battery on the CPU at this
        # width or wider
        result["cpu_mesh"] = {"skipped": True,
                              "reason": "main section ran on cpu"}
    elif args.cpu_mesh_n:
        section = _run_battery(
            args.cpu_mesh_n, device="cpu",
            devices=None if devices is None else ["cpu"] * args.cpu_mesh_n)
        section["platform"] = "cpu"
        result["cpu_mesh"] = section

    cm = result.get("cpu_mesh")
    result["ok"] = result["ok"] and (
        cm is None or cm.get("skipped", False) or cm["ok"])
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
