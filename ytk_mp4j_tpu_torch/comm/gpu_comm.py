"""The device collective driver: the port of ``TpuCommCluster``
(``ytk_mp4j_tpu/comm/tpu_comm.py:95-526``, ``:854``), dense family.

A single-controller driver over n members
(:func:`~ytk_mp4j_tpu_torch.device.make_mesh`): collective methods take
a list of n per-rank numpy arrays, stage them onto the device as the rows
of one tensor, run the collective and write the results back IN PLACE
into the per-rank arrays, the reference's buffer semantics. Sub-ranges
``[from, to)`` and uneven per-rank ``ranges`` are packed on the host into
equal blocks padded with the operator's identity.

``GpuCommCluster(mesh=make_mesh(n, devices=[...]))`` takes a list mesh,
as the reference's ``TpuCommCluster(mesh=)`` takes a mesh over devices:
rank r's block is staged on member r's device, the dense and nonblocking
families run the list form of their collective (bitwise the packed
form's), and each rank's result is read from its member's device. The
map family stages rank r's ``(code, value)`` buffer on member r's device
and reduces the union through the list form of ``ops.sparse`` (on member
0's device, bitwise the packed form's).

``algo`` selects the schedule: ``"xla"`` (the default; ``"auto"`` resolves
to it) reduces in rank order through ``ops.collectives`` -- its NCCL form
across cards comes with the multi-GPU slice; ``"ring"`` runs the
``ops.ring`` schedule as torch ops; ``"rdma"`` launches the hand-written
CUDA ring kernel (``ops.ring_kernel``), whose plain version runs on the
CPU. All three give the same results.

Divergences from the reference, intended:

- 8-byte operands need no switch (the reference needs jax x64);
- under ``algo="rdma"`` a custom operator raises ``Mp4jError`` naming
  ``algo="ring"``: the kernel cannot run a Python function.

Every collective method is traced as the reference's (``utils.trace.
instrument``, ``tpu_comm.py:869``): inside ``trace_collectives()`` the
outermost call records one ``GpuCommCluster.<method>`` row with the
payload bytes of its first argument, so a composed collective
(``allgather_map``) records once.

The nonblocking family (the reference's ``tpu_comm.py:806-852``) needs no
progression thread: ``iallreduce`` / ``ireduce_scatter`` / ``iallgather``
/ ``igather`` run their blocking twin at once (its in-place write-back
included) and return a resolved future; ``iallreduce_map`` is a
``DeferredFuture`` over :meth:`allreduce_map_async`, whose device work and
copy to pinned memory are in flight when it returns, and it stays
unresolved until ``wait()``; ``wait_all`` has nothing to drain.

The map family (``allreduce_map`` ... ``scatter_map``, the reference's
``tpu_comm.py:526-800``) keeps the keys on the host, coded by one
persistent codec per key kind (``comm.keycodec``), and moves the values
through the device as ``(code, value)`` member tensors reduced by
``ops.sparse.sparse_allreduce``. ``allreduce_map_async`` copies the
union's values into pinned host memory behind a CUDA event; the
handle's ``result()`` waits on that event.
"""

from __future__ import annotations

import numpy as np
import torch

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.comm import keycodec
from ytk_mp4j_tpu_torch.comm import progress as progress_mod
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operands import Operand, Operands, to_numpy, \
    to_tensor
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import ring as ring_ops
from ytk_mp4j_tpu_torch.ops import ring_kernel
from ytk_mp4j_tpu_torch.ops import sparse as sparse_ops
from ytk_mp4j_tpu_torch.utils import trace


class PendingMap:
    """Deferred result of :meth:`GpuCommCluster.allreduce_map_async`.

    The device reduction and the copy of its values into pinned host
    memory are queued when this handle exists; :meth:`result` waits on
    the copy's CUDA event, decodes, and writes the merged map into every
    rank's dict (the synchronous call's post-state). Idempotent."""

    def __init__(self, codec, codes, host_vals, event, maps):
        self._codec = codec
        self._codes = codes
        self._vals = host_vals
        self._event = event
        self._maps = maps
        self._done = False

    def result(self):
        if not self._done:
            if self._codec is not None:
                if self._event is not None:
                    self._event.synchronize()
                merged = GpuCommCluster._decode_union(
                    self._codec, self._codes, to_numpy(self._vals))
                for m in self._maps:
                    m.clear()
                    m.update(merged)
                self._vals = None
            self._done = True
        return self._maps


class GpuCommCluster:
    """Collectives over ``n`` members on one device (``cuda:0`` unless
    ``device`` names another, or the CPU; one member without ``n``), or
    over the members of ``mesh`` (``device.make_mesh`` /
    ``make_hier_mesh``, packed or a list mesh)."""

    _ALGOS = ("auto", "xla", "ring", "rdma")

    def __init__(self, n: int | None = None, device=None, mesh=None):
        if mesh is None:
            mesh = make_mesh(1 if n is None else n, device)
        elif device is not None or (n is not None and n != mesh.n):
            raise Mp4jError(f"give a mesh, or n and device, not both (n={n}"
                            f", device={device}, a mesh of {mesh.n})")
        elif mesh.group is not None:
            raise Mp4jError("GpuCommCluster drives the members of one "
                            "process; a mesh over processes takes "
                            "comm.distributed.DistributedComm")
        self.mesh = mesh
        self.n = self.mesh.n
        self.device = self.mesh.device
        # persistent key<->code vocabularies of the map collectives
        # (grow-only, one per key kind -- see comm.keycodec)
        self._codecs: dict[str, object] = {}

    @property
    def slave_num(self) -> int:
        return self.n

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _check_operand(self, operand: Operand):
        if not operand.is_numeric:
            raise Mp4jError(
                f"{operand.name} operands are host-only; the device "
                "collectives take numeric operands")

    def _check_root(self, root: int):
        if not (0 <= root < self.n):
            raise Mp4jError(f"root {root} out of range [0, {self.n})")

    def _check_algo(self, algo: str) -> str:
        if algo not in self._ALGOS:
            raise Mp4jError(f"algo must be one of {self._ALGOS}, "
                            f"got {algo!r}")
        return "xla" if algo == "auto" else algo

    def _norm_arrays(self, arrs, operand: Operand, lo: int, hi: int | None):
        if len(arrs) != self.n:
            raise Mp4jError(f"expected {self.n} per-rank arrays, got "
                            f"{len(arrs)}")
        for a in arrs:
            if not isinstance(a, np.ndarray):
                raise Mp4jError(
                    "per-rank buffers must be numpy arrays (results are "
                    f"written back in place); got {type(a).__name__}")
        out = [operand.check_array(a) for a in arrs]
        shape0 = out[0].shape
        for a in out:
            if a.shape != shape0:
                raise Mp4jError("per-rank arrays must share a shape")
        full = shape0[0] if out[0].ndim == 1 else out[0].size
        if hi is None:
            hi = full
        if (lo != 0 or hi != full) and out[0].ndim != 1:
            raise Mp4jError("[from, to) ranges require 1-D arrays")
        if not (0 <= lo <= hi <= full):
            raise Mp4jError(f"range [{lo}, {hi}) out of bounds")
        return out, lo, hi

    def _stack(self, blocks):
        """Per-rank equal blocks as the rows of one device tensor; on a
        list mesh, as a list: rank r's block on member r's device."""
        if self.mesh.is_list:
            return [to_tensor(b, d) for b, d in zip(blocks,
                                                    self.mesh.devices)]
        return to_tensor(np.stack(blocks, axis=0), self.device)

    @staticmethod
    def _rows(res):
        """Each rank's result on the host: the rows of a packed result, or
        each member's tensor of a list, read from its device."""
        if isinstance(res, list):
            return [to_numpy(t) for t in res]
        return to_numpy(res)

    @staticmethod
    def _write_back(arrs, rows, lo, hi, ranks):
        for r in ranks:
            a = arrs[r]
            if a.ndim == 1:
                a[lo:hi] = rows[r]
            else:
                np.copyto(a, rows[r].reshape(a.shape))

    @staticmethod
    def _pad_row(v, length: int, operator: Operator):
        """Members ``v`` [n, L] (or a list of n [L]) padded with the
        identity to ``length``."""
        if isinstance(v, list):
            return [GpuCommCluster._pad_row(t[None], length, operator)[0]
                    for t in v]
        if length == v.shape[1]:
            return v
        fill = torch.full((v.shape[0], length - v.shape[1]),
                          operator.identity(v.dtype), dtype=v.dtype,
                          device=v.device)
        return torch.cat([v, fill], dim=1)

    # ------------------------------------------------------------------
    # dense collectives
    # ------------------------------------------------------------------
    def allreduce_array(self, arrs, operand: Operand = Operands.FLOAT,
                        operator: Operator = Operators.SUM,
                        from_: int = 0, to: int | None = None,
                        algo: str = "xla"):
        """Element-wise reduce ``arr[from_:to]`` across ranks, in place."""
        self._check_operand(operand)
        algo = self._check_algo(algo)
        arrs, lo, hi = self._norm_arrays(arrs, operand, from_, to)
        if hi == lo:
            return arrs
        flat = [a[lo:hi] if a.ndim == 1 else a.reshape(-1) for a in arrs]
        x = self._stack(flat)
        L = flat[0].shape[0]
        if algo == "xla":
            res = coll.allreduce(x, operator)
        elif algo == "rdma":
            res = ring_kernel.ring_allreduce_kernel(x, operator)
        else:
            padL = meta.padded_block(L, self.n) * self.n
            res = ring_ops.ring_allreduce(self._pad_row(x, padL, operator),
                                          operator)
            res = ([t[:L] for t in res] if isinstance(res, list)
                   else res[:, :L])
        self._write_back(arrs, self._rows(res), lo, hi, range(self.n))
        return arrs

    def reduce_array(self, arrs, operand: Operand = Operands.FLOAT,
                     operator: Operator = Operators.SUM, root: int = 0,
                     from_: int = 0, to: int | None = None):
        """Reduce into ``root``'s array; other ranks' buffers unchanged."""
        self._check_operand(operand)
        self._check_root(root)
        arrs, lo, hi = self._norm_arrays(arrs, operand, from_, to)
        if hi == lo:
            return arrs
        flat = [a[lo:hi] if a.ndim == 1 else a.reshape(-1) for a in arrs]
        res = coll.reduce(self._stack(flat), operator, root)
        self._write_back(arrs, {root: to_numpy(res[root])}, lo, hi, [root])
        return arrs

    def broadcast_array(self, arrs, operand: Operand = Operands.FLOAT,
                        root: int = 0, from_: int = 0, to: int | None = None):
        """Copy ``root``'s ``arr[from_:to]`` into every rank's array."""
        self._check_operand(operand)
        self._check_root(root)
        arrs, lo, hi = self._norm_arrays(arrs, operand, from_, to)
        if hi == lo:
            return arrs
        flat = [a[lo:hi] if a.ndim == 1 else a.reshape(-1) for a in arrs]
        res = coll.broadcast(self._stack(flat), root)
        self._write_back(arrs, self._rows(res), lo, hi, range(self.n))
        return arrs

    # -- segment family: ``ranges`` gives each rank's owned segment of a
    # common full-length array (default: meta.partition_range)
    def _norm_ranges(self, arrs, ranges):
        L = arrs[0].shape[0]
        if ranges is None:
            ranges = meta.partition_range(0, L, self.n)
        if len(ranges) != self.n:
            raise Mp4jError(f"need {self.n} ranges, got {len(ranges)}")
        prev = None
        for (s, e) in ranges:
            if not (0 <= s <= e <= L):
                raise Mp4jError(f"range ({s}, {e}) out of bounds for {L}")
            if prev is not None and s != prev:
                raise Mp4jError("ranges must be contiguous in rank order")
            prev = e
        return ranges

    def _run_segment_gather(self, arrs, operand: Operand, ranges,
                            algo: str = "xla"):
        """Pad each rank's segment to the largest, gather on the device,
        return the [n, B] result every member holds."""
        if arrs[0].ndim != 1:
            raise Mp4jError("segment collectives require 1-D arrays")
        algo = self._check_algo(algo)
        ranges = self._norm_ranges(arrs, ranges)
        B = max(1, max(e - s for s, e in ranges))
        if algo == "rdma":
            B = ring_kernel.round_up_chunk(B, operand.torch_dtype,
                                           self.device)
        blocks = []
        for r, (s, e) in enumerate(ranges):
            b = np.zeros(B, dtype=operand.dtype)
            b[: e - s] = arrs[r][s:e]
            blocks.append(b)
        x = self._stack(blocks)
        if algo == "xla":
            y = coll.allgather(x)
        elif algo == "rdma":
            y = ring_kernel.ring_allgather_kernel(x)
        else:
            y = ring_ops.ring_allgather(x)
        return to_numpy(y[0]).reshape(self.n, B), ranges

    def allgather_array(self, arrs, operand: Operand = Operands.FLOAT,
                        ranges=None, algo: str = "xla"):
        """Each rank owns ``arr[ranges[rank]]``; afterwards every rank's
        array holds all segments."""
        self._check_operand(operand)
        arrs, _, _ = self._norm_arrays(arrs, operand, 0, None)
        res, ranges = self._run_segment_gather(arrs, operand, ranges, algo)
        for a in arrs:
            for r, (s, e) in enumerate(ranges):
                a[s:e] = res[r, : e - s]
        return arrs

    def gather_array(self, arrs, operand: Operand = Operands.FLOAT,
                     root: int = 0, ranges=None):
        """Root's array receives every rank's segment; others unchanged."""
        self._check_operand(operand)
        self._check_root(root)
        arrs, _, _ = self._norm_arrays(arrs, operand, 0, None)
        res, ranges = self._run_segment_gather(arrs, operand, ranges)
        a = arrs[root]
        for r, (s, e) in enumerate(ranges):
            a[s:e] = res[r, : e - s]
        return arrs

    def scatter_array(self, arrs, operand: Operand = Operands.FLOAT,
                      root: int = 0, ranges=None):
        """Rank r receives segment ``ranges[r]`` of ``root``'s array. Every
        rank's buffer is on the host, so this is a host copy, as in the
        reference."""
        self._check_operand(operand)
        self._check_root(root)
        arrs, _, _ = self._norm_arrays(arrs, operand, 0, None)
        if arrs[0].ndim != 1:
            raise Mp4jError("segment collectives require 1-D arrays")
        ranges = self._norm_ranges(arrs, ranges)
        src = arrs[root]
        for r, (s, e) in enumerate(ranges):
            if r != root:
                arrs[r][s:e] = src[s:e]
        return arrs

    def reduce_scatter_array(self, arrs, operand: Operand = Operands.FLOAT,
                             operator: Operator = Operators.SUM, ranges=None,
                             algo: str = "xla"):
        """Every rank contributes its full array; rank r ends with segment
        ``ranges[r]`` of the element-wise reduction (other positions
        unchanged)."""
        self._check_operand(operand)
        algo = self._check_algo(algo)
        arrs, _, _ = self._norm_arrays(arrs, operand, 0, None)
        if arrs[0].ndim != 1:
            raise Mp4jError("segment collectives require 1-D arrays")
        ranges = self._norm_ranges(arrs, ranges)
        lo, hi = ranges[0][0], ranges[-1][1]
        B = meta.padded_block(hi - lo, self.n)
        if algo == "rdma":
            B = ring_kernel.round_up_chunk(B, operand.torch_dtype,
                                           self.device)
        x = self._pad_row(self._stack([a[lo:hi] for a in arrs]),
                          self.n * B, operator)
        if algo == "xla":
            y = coll.reduce_scatter(x, operator)
        elif algo == "rdma":
            y = ring_kernel.ring_reduce_scatter_kernel(x, operator)
        else:
            # the ring leaves member r with chunk (r + 1) % n; one more
            # hop right restores block r at rank r
            y = ring_ops.ring_reduce_scatter(x, operator)
            y = ([y[r - 1] for r in range(self.n)] if isinstance(y, list)
                 else torch.roll(y, 1, 0))
        full = np.concatenate(
            [np.reshape(r, -1) for r in self._rows(y)])[: hi - lo]
        for r, (s, e) in enumerate(ranges):
            arrs[r][s:e] = full[s - lo: e - lo]
        return arrs

    # ------------------------------------------------------------------
    # sparse map collectives: keys stay on the host, values ride the
    # device as (code, value) member tensors through ops.sparse; each
    # rank's dict is mutated in place, as the reference's maps
    # ------------------------------------------------------------------
    def _norm_maps(self, maps, operand: Operand):
        if len(maps) != self.n:
            raise Mp4jError(f"expected {self.n} per-rank maps, got "
                            f"{len(maps)}")
        for m in maps:
            if not isinstance(m, dict):
                raise Mp4jError(
                    f"per-rank operands must be dicts, got "
                    f"{type(m).__name__}")
        self._check_operand(operand)
        return maps

    def _encode_maps(self, maps, operand: Operand, operator: Operator):
        """Pack each rank's entries into SENTINEL-padded (code, value)
        host buffers of one power-of-2 length through the cluster's
        persistent codec. Returns ``(codec, idx, val, cap)`` with ``cap``
        an upper bound on the union's unique codes, or None when every
        map is empty."""
        total = sum(len(m) for m in maps)
        if total == 0:
            return None
        for m in maps:
            if m:
                k0 = next(iter(m))
                vshape = np.shape(m[k0])
                break
        kind = keycodec.kind_of(k0)
        codec = self._codecs.get(kind)
        if codec is None:
            codec = self._codecs[kind] = keycodec.codec_for_kind(kind)
        # a power-of-2 slot count, as the reference's (whose compiled
        # programs are keyed on it); padding is SENTINEL / identity
        Lmax = keycodec.pow2_bucket(max(len(m) for m in maps))
        ident = operator.identity(operand.dtype)
        idx = np.full((self.n, Lmax), sparse_ops.SENTINEL, dtype=np.int32)
        val = np.full((self.n, Lmax) + vshape, ident, dtype=operand.dtype)
        for r, m in enumerate(maps):
            c = len(m)
            if c == 0:
                continue
            idx[r, :c] = codec.encode(m.keys(), c)
            val[r, :c] = keycodec.pack_values(m.values(), c, vshape,
                                              operand.dtype)
        # every key of this call is in the vocabulary, so the union's
        # unique-code count is bounded by both
        return codec, idx, val, min(codec.size, total)

    @staticmethod
    def _decode_union(codec, codes, vals: np.ndarray) -> dict:
        """Host-known union codes + the union's values (host) -> one
        merged dict."""
        return dict(zip(codec.decode(codes), list(vals[: codes.size])))

    def _device_sparse_allreduce(self, idx, val, capacity, operator):
        """The union's values on the device, [capacity, ...]: every
        member holds the same union, so member 0's is returned (on a list
        mesh, on member 0's device, where the union was reduced)."""
        capacity = keycodec.pow2_bucket(capacity)
        _oi, ov = sparse_ops.sparse_allreduce(
            self._stack(idx), self._stack(val), capacity, operator)
        return ov[0]

    @staticmethod
    def _union_codes(idx: np.ndarray) -> np.ndarray:
        """The union's code list, on the host: ``segment_reduce_sorted``
        packs unique codes ascending with SENTINEL padding at the end --
        ``np.unique`` of the staged buffers minus the sentinel -- so the
        device's codes need no fetch."""
        codes = np.unique(idx)
        if codes.size and codes[-1] == sparse_ops.SENTINEL:
            codes = codes[:-1]
        return codes

    def _reduced_union(self, maps, operand: Operand, operator: Operator):
        """(codec, union codes, union values on the host) of the maps, or
        None when every map is empty."""
        enc = self._encode_maps(maps, operand, operator)
        if enc is None:
            return None
        codec, idx, val, cap = enc
        codes = self._union_codes(idx)
        ov = self._device_sparse_allreduce(idx, val, cap, operator)
        return codec, codes, to_numpy(ov[: codes.size])

    def allreduce_map(self, maps, operand: Operand = Operands.DOUBLE,
                      operator: Operator = Operators.SUM):
        """Key-union reduce: every rank's dict becomes the union of all
        keys with shared keys reduced by ``operator``."""
        maps = self._norm_maps(maps, operand)
        got = self._reduced_union(maps, operand, operator)
        if got is None:
            return maps
        merged = self._decode_union(*got)
        for m in maps:
            m.clear()
            m.update(merged)
        return maps

    def allreduce_map_async(self, maps,
                            operand: Operand = Operands.DOUBLE,
                            operator: Operator = Operators.SUM
                            ) -> PendingMap:
        """:meth:`allreduce_map` without the wait: the device reduction
        and a non-blocking copy of the union's values into pinned host
        memory are queued behind a CUDA event, and the returned handle's
        ``result()`` waits on it, decodes and mutates the maps. Chained
        calls overlap their host encodes with the device's work. The
        input dicts must not change between the call and ``result()``."""
        maps = self._norm_maps(maps, operand)
        enc = self._encode_maps(maps, operand, operator)
        if enc is None:
            return PendingMap(None, None, None, None, maps)
        codec, idx, val, cap = enc
        codes = self._union_codes(idx)
        ov = self._device_sparse_allreduce(idx, val, cap, operator)
        ov = ov[: codes.size]
        event = None
        if ov.device.type == "cuda":
            # the copy runs on the current stream of the device that
            # holds the union (member 0's), whichever device is current:
            # the event goes there too
            host = torch.empty(ov.shape, dtype=ov.dtype, pin_memory=True)
            host.copy_(ov, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(ov.device))
            ov = host
        return PendingMap(codec, codes, ov, event, maps)

    def reduce_map(self, maps, operand: Operand = Operands.DOUBLE,
                   operator: Operator = Operators.SUM, root: int = 0):
        """Key-union reduce into ``root``'s dict; others unchanged."""
        self._check_root(root)
        maps = self._norm_maps(maps, operand)
        got = self._reduced_union(maps, operand, operator)
        if got is None:
            return maps
        maps[root].clear()
        maps[root].update(self._decode_union(*got))
        return maps

    def reduce_scatter_map(self, maps, operand: Operand = Operands.DOUBLE,
                           operator: Operator = Operators.SUM):
        """Key-union reduce, then each rank keeps the keys hashing to it
        (``meta.key_partition``, the placement of every backend; the
        codec caches it per code)."""
        maps = self._norm_maps(maps, operand)
        got = self._reduced_union(maps, operand, operator)
        if got is None:
            return maps
        codec, codes, vals = got
        parts = codec.partition(codes, self.n)
        for r, m in enumerate(maps):
            mine = parts == r
            m.clear()
            m.update(zip(codec.decode(codes[mine]), list(vals[mine])))
        return maps

    def allgather_map(self, maps, operand: Operand = Operands.DOUBLE):
        """Disjoint union: every rank's dict becomes the union of all
        ranks' entries. Duplicate keys raise (ambiguous without an
        operator)."""
        self.gather_map(maps, operand, root=0)
        return self.broadcast_map(maps, operand, root=0)

    def gather_map(self, maps, operand: Operand = Operands.DOUBLE,
                   root: int = 0):
        """Disjoint union into ``root``'s dict; others unchanged. A
        duplicate key raises naming the key and both owner ranks."""
        self._check_root(root)
        maps = self._norm_maps(maps, operand)
        total = sum(len(m) for m in maps)
        union: dict = {}
        for m in maps:
            union.update(m)
        if len(union) != total:
            seen: dict = {}
            for r, m in enumerate(maps):
                for k in m:
                    if k in seen:
                        raise Mp4jError(
                            f"gather_map: duplicate key {k!r} owned by "
                            f"ranks {seen[k]} and {r}; use reduce_map "
                            f"to combine")
                    seen[k] = r
        maps[root].clear()
        maps[root].update(union)
        return maps

    def broadcast_map(self, maps, operand: Operand = Operands.DOUBLE,
                      root: int = 0):
        """Every rank's dict becomes a copy of ``root``'s."""
        self._check_root(root)
        maps = self._norm_maps(maps, operand)
        src = dict(maps[root])
        for r, m in enumerate(maps):
            if r != root:
                m.clear()
                m.update(src)
        return maps

    def scatter_map(self, maps, operand: Operand = Operands.DOUBLE,
                    root: int = 0, partitioner=None):
        """Rank r receives the subset of ``root``'s entries whose keys
        hash to r (``meta.key_partition``); ``partitioner(key) -> rank``
        overrides the placement."""
        self._check_root(root)
        maps = self._norm_maps(maps, operand)
        if partitioner is None:
            partitioner = lambda k: meta.key_partition(k, self.n)  # noqa: E731
        src = dict(maps[root])
        shares: list[dict] = [{} for _ in range(self.n)]
        for k, v in src.items():
            shares[meta.check_partition_rank(partitioner(k), self.n,
                                             k)][k] = v
        for r, m in enumerate(maps):
            m.clear()
            m.update(shares[r])
        return maps

    def reset_map_vocabularies(self) -> None:
        """Drop the persistent key<->code vocabularies (and their cached
        partitions): on a long-lived cluster whose key space churns they
        grow without bound. The next map collective rebuilds from the
        live keys."""
        self._codecs.clear()

    # -- nonblocking twins ---------------------------------------------
    def iallreduce(self, arrs, operand: Operand = Operands.FLOAT,
                   operator: Operator = Operators.SUM,
                   from_: int = 0, to: int | None = None,
                   algo: str = "auto"):
        """Eager nonblocking :meth:`allreduce_array` (resolved future)."""
        return progress_mod.eager_future(
            self, "allreduce_array", arrs, operand, operator,
            from_=from_, to=to, algo=algo)

    def ireduce_scatter(self, arrs, operand: Operand = Operands.FLOAT,
                        operator: Operator = Operators.SUM,
                        ranges=None):
        """Eager nonblocking :meth:`reduce_scatter_array`."""
        return progress_mod.eager_future(
            self, "reduce_scatter_array", arrs, operand, operator,
            ranges=ranges)

    def iallgather(self, arrs, operand: Operand = Operands.FLOAT,
                   ranges=None):
        """Eager nonblocking :meth:`allgather_array`."""
        return progress_mod.eager_future(
            self, "allgather_array", arrs, operand, ranges=ranges)

    def igather(self, arrs, operand: Operand = Operands.FLOAT,
                root: int = 0, ranges=None):
        """Eager nonblocking :meth:`gather_array`."""
        return progress_mod.eager_future(
            self, "gather_array", arrs, operand, root=root, ranges=ranges)

    def iallreduce_map(self, maps, operand: Operand = Operands.DOUBLE,
                       operator: Operator = Operators.SUM):
        """Nonblocking :meth:`allreduce_map` over
        :meth:`allreduce_map_async`: the device reduction and the copy to
        pinned memory are queued when this returns; ``wait()`` waits on
        the copy, decodes and mutates the maps (the blocking twin's
        post-state)."""
        pending = self.allreduce_map_async(maps, operand, operator)
        return progress_mod.DeferredFuture("allreduce_map", pending.result)

    def wait_all(self, timeout: float | None = None) -> None:
        """Collective-boundary drain: the dense twins are eager and
        ``iallreduce_map`` resolves at its ``wait()``, so there is nothing
        to drain; kept for portable code."""

    def barrier(self):
        """Wait until every member's queued work is done."""
        coll.barrier(list(self.mesh.devices) if self.mesh.is_list
                     else self.device)


# per-collective tracing (utils.trace; no cost beyond a flag test when
# disabled)
trace.instrument(GpuCommCluster)
