"""One level of GBDT row routing, and the next level's histogram ids.

``route`` is the wrapper of the hand-written CUDA kernel in
``ops/csrc/route_kernel.cu``, which replaces no Pallas kernel: the JAX
package routes a level in XLA (``ytk_mp4j_tpu/models/gbdt.py:348``,
``_route_samples``), and the port's first routing was about nine ATen
launches a level, with six more for the next level's histogram ids.
``route_reference`` is their plain PyTorch version, with the same
contract.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel (one launch a call, none for zero rows) or raises.
Each launch adds one to ``route.launches``. A row whose node id or whose
node's feature is out of range is refused: on the CPU the plain
version's indexing raises, and the kernel flags it, which the wrapper
reads back (one wait for the card) unless the caller vouches for its
tables with ``check=False``.

What bounds the kernel on an H100: each row's node id read, its one bin
read, which costs the 32-byte sector holding it, and its one or two ids
written -- about 0.48 GB at 11M rows, or ~0.14 ms a level at 3.35 TB/s.
The design (a grid the size of what the card holds, several rows' bin
loads in flight a thread) is
described in the source. Its outputs are integers, so they equal the
plain version's bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import _build

_MAX_IDS = 1 << 31      # ids are int32


def route_reference(bins, node_ids, feat, bin_, dir_=None, cat_mask=None,
                    missing_bin: bool = False, n_bins: int | None = None,
                    n_members: int | None = None):
    """One level of row routing: ``node_ids * 2 + go_right``, where
    ``go_right`` is ``bins[i, feat[n]] > bin_[n]`` for numeric features,
    ``== bin_[n]`` for categorical ones (``cat_mask``, [F] bool; never at
    the freeze sentinel ``n_bins - 1``), and the node's learned default
    direction ``dir_`` for the missing bucket (bin 0) under
    ``missing_bin``. node_ids must lie in [0, len(feat)). The gathers are
    exact, and a non-finite table entry reaches only the rows that select
    it.

    With ``n_members`` (the rows being that many members' equal blocks,
    in order) also returns the next level's histogram ids: a row sent
    left to child ``2k`` has id ``member * len(feat) + k``, a row sent
    right the sentinel ``n_members * len(feat)``. Returns the next node
    ids, or (next node ids, histogram ids); int32 [N]."""
    idx = node_ids.long()
    nf = feat[idx]
    nb = bin_[idx]
    v = bins.gather(1, nf.long().unsqueeze(1)).squeeze(1)
    go_right = v > nb
    if missing_bin:
        go_right = torch.where(v == 0, dir_[idx] > 0, go_right)
    if cat_mask is not None:
        # is this sample's node split on a categorical feature?
        node_cat = torch.as_tensor(cat_mask, device=bins.device)[feat.long()]
        go_right = torch.where(node_cat[idx], (v == nb) & (nb != n_bins - 1),
                               go_right)
    nxt = node_ids * 2 + go_right.to(torch.int32)
    if n_members is None:
        return nxt
    k = feat.shape[0]
    N = node_ids.shape[0]
    left = nxt // 2
    if n_members > 1:
        member = torch.arange(N, dtype=torch.int32,
                              device=bins.device) // max(1, N // n_members)
        left = left + member * k
    return nxt, torch.where(nxt % 2 == 0, left, n_members * k)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("route_kernel")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mp4j_route_launch.argtypes = [p, ll, ll, p, p, p, p, p, i, i, i, i,
                                      p, p, ll, i, p, p]
    lib.mp4j_route_launch.restype = ctypes.c_int
    lib.mp4j_error_string.argtypes = [ctypes.c_int]
    lib.mp4j_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(bins, node_ids, feat, bin_, dir_, cat, missing_bin,
                  n_bins, n_members):
    if bins.ndim != 2 or bins.dtype != torch.int32 or (
            bins.shape[1] > 1 and bins.stride(1) != 1):
        raise Mp4jError(f"bins must be int32 [N, F] with unit column "
                        f"stride, got {bins.dtype} {tuple(bins.shape)} "
                        f"strides {bins.stride()}")
    N, F = bins.shape
    n_nodes = feat.shape[0] if feat.ndim == 1 else -1
    tables = [("node_ids", node_ids, N), ("feat", feat, n_nodes),
              ("bin_", bin_, n_nodes)]
    if missing_bin:
        if dir_ is None:
            raise Mp4jError("missing_bin routing needs dir_")
        tables.append(("dir_", dir_, n_nodes))
    for name, t, n in tables:
        if t.dtype != torch.int32 or t.ndim != 1 or t.shape[0] != n:
            raise Mp4jError(f"{name} must be int32 [{n}], got {t.dtype} "
                            f"{tuple(t.shape)}")
    if cat is not None:
        if n_bins is None:
            raise Mp4jError("categorical routing needs n_bins")
        tables.append(("cat_mask", cat, F))
        if cat.dtype != torch.bool or tuple(cat.shape) != (F,):
            raise Mp4jError(f"cat_mask must be bool [F={F}], got "
                            f"{cat.dtype} {tuple(cat.shape)}")
    for name, t, _ in tables:
        if t.device != bins.device:
            raise Mp4jError(f"{name} is on {t.device}, bins on "
                            f"{bins.device}")
        if not t.is_contiguous():
            raise Mp4jError(f"{name} must be contiguous")
    if n_nodes < 1 or 2 * n_nodes >= _MAX_IDS:
        raise Mp4jError(f"no routing for {n_nodes} nodes")
    if n_members is not None:
        if n_members < 1 or N % n_members:
            raise Mp4jError(f"{N} rows do not split into {n_members} "
                            "members")
        if n_members * n_nodes >= _MAX_IDS:
            raise Mp4jError(f"{n_members} members x {n_nodes} nodes pass "
                            "the int32 ids")


def route(bins, node_ids, feat, bin_, dir_=None, cat_mask=None,
          missing_bin: bool = False, n_bins: int | None = None,
          n_members: int | None = None, check: bool = True):
    """:func:`route_reference`'s contract: the next node ids, or with
    ``n_members`` (next node ids, histogram ids). bins: [N, F] int32 (rows
    may be a strided view, columns contiguous); node_ids: int32 [N];
    feat, bin_ and dir_ (read under ``missing_bin`` only): int32
    [n_nodes]; cat_mask: [F] bool (a tensor on the rows' device, or
    numpy). CPU tensors take the plain version; CUDA tensors launch the
    kernel, whose ids equal the plain version's. A row whose node id or
    whose node's feature is out of range raises Mp4jError, after a wait
    for the launch. ``check=False`` skips that wait, for a caller whose
    tables are in range by construction: such a row then goes nowhere
    (next id -1, histogram id the sentinel), and is out of range again on
    the next level, so a chain of levels is checked by its last."""
    dev = bins.device
    if dev.type == "cpu":
        return route_reference(bins, node_ids, feat, bin_, dir_, cat_mask,
                               missing_bin, n_bins, n_members)
    if dev.type != "cuda":
        raise Mp4jError(f"route runs on cpu or cuda tensors, not {dev}")
    cat = (None if cat_mask is None
           else torch.as_tensor(cat_mask, dtype=torch.bool, device=dev))
    _check_inputs(bins, node_ids, feat, bin_, dir_, cat, missing_bin,
                  n_bins, n_members)
    N = bins.shape[0]
    out = torch.empty((1 if n_members is None else 2, N), dtype=torch.int32,
                      device=dev)
    if N:
        lib = _library()
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        members = n_members or 1
        bad = (torch.zeros(1, dtype=torch.int32, device=dev) if check
               else None)
        with torch.cuda.device(index):
            rc = lib.mp4j_route_launch(
                bins.data_ptr(), bins.stride(0), N, node_ids.data_ptr(),
                feat.data_ptr(), bin_.data_ptr(),
                dir_.data_ptr() if missing_bin else None,
                None if cat is None else cat.data_ptr(), feat.shape[0],
                bins.shape[1], 0 if n_bins is None else n_bins,
                int(missing_bin), out[0].data_ptr(),
                None if n_members is None else out[1].data_ptr(),
                N // members, members,
                None if bad is None else bad.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise Mp4jError(
                f"route launch failed: {lib.mp4j_error_string(rc).decode()}")
        route.launches += 1
        if bad is not None and bad.item():
            raise Mp4jError("route: a row's node id, or its node's "
                            "feature, is out of range")
    return out[0] if n_members is None else (out[0], out[1])


route.launches = 0
