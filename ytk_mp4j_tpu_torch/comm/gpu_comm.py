"""The device collective driver: the port of ``TpuCommCluster``
(``ytk_mp4j_tpu/comm/tpu_comm.py:95-526``, ``:854``), dense family.

A single-controller driver over n members on one device
(:func:`~ytk_mp4j_tpu_torch.device.make_mesh`): collective methods take
a list of n per-rank numpy arrays, stage them onto the device as the rows
of one tensor, run the collective and write the results back IN PLACE
into the per-rank arrays, the reference's buffer semantics. Sub-ranges
``[from, to)`` and uneven per-rank ``ranges`` are packed on the host into
equal blocks padded with the operator's identity.

``algo`` selects the schedule: ``"xla"`` (the default; ``"auto"`` resolves
to it) reduces in rank order through ``ops.collectives`` -- its NCCL form
across cards comes with the multi-GPU slice; ``"ring"`` runs the
``ops.ring`` schedule as torch ops; ``"rdma"`` launches the hand-written
CUDA ring kernel (``ops.ring_kernel``), whose plain version runs on the
CPU. All three give the same results.

Divergences from the reference, intended:

- 8-byte operands need no switch (the reference needs jax x64);
- under ``algo="rdma"`` a custom operator raises ``Mp4jError`` naming
  ``algo="ring"``: the kernel cannot run a Python function;
- the map family, the ``i*`` futures and tracing are not ported yet
  (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operands import Operand, Operands, to_numpy, \
    to_tensor
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import ring as ring_ops
from ytk_mp4j_tpu_torch.ops import ring_kernel


class GpuCommCluster:
    """Collectives over ``n`` members on one device (``cuda:0`` unless
    ``device`` names another, or the CPU)."""

    _ALGOS = ("auto", "xla", "ring", "rdma")

    def __init__(self, n: int, device=None):
        self.mesh = make_mesh(n, device)
        self.n = self.mesh.n
        self.device = self.mesh.device

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

    def _stack(self, blocks) -> torch.Tensor:
        """Per-rank equal blocks as the rows of one device tensor."""
        return to_tensor(np.stack(blocks, axis=0), self.device)

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
        """Members ``v`` [n, L] padded with the identity to ``length``."""
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
        L = x.shape[1]
        if algo == "xla":
            res = coll.allreduce(x, operator)
        elif algo == "rdma":
            res = ring_kernel.ring_allreduce_kernel(x, operator)
        else:
            padL = meta.padded_block(L, self.n) * self.n
            res = ring_ops.ring_allreduce(self._pad_row(x, padL, operator),
                                          operator)[:, :L]
        self._write_back(arrs, to_numpy(res), lo, hi, range(self.n))
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
        self._write_back(arrs, to_numpy(res), lo, hi, range(self.n))
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
            y = torch.roll(ring_ops.ring_reduce_scatter(x, operator), 1, 0)
        full = to_numpy(y).reshape(-1)[: hi - lo]
        for r, (s, e) in enumerate(ranges):
            arrs[r][s:e] = full[s - lo: e - lo]
        return arrs

    def barrier(self):
        """Wait until every member's queued work is done."""
        coll.barrier(self.device)
