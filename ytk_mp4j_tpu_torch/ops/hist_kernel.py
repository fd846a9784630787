"""(node x feature x bin) gradient/hessian histograms: the GBDT hot op.

``histograms`` is the wrapper of the hand-written CUDA kernel in
``ops/csrc/hist_kernel.cu``, which replaces the Pallas TPU kernel
``ytk_mp4j_tpu/ops/hist_kernel.py:70`` (``_hist_kernel``, called through
``pallas_histograms:106``). ``histograms_reference`` is its plain
PyTorch version, with the same contract.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. Each launch adds one to
``histograms.launches``, its geometry's ``cell_groups`` (the passes its
blocks make over their records) to ``histograms.row_passes``, and the
16-byte pieces of a row (quads) that one record loads over all those
passes (:func:`kernel_group_quads`) to ``histograms.row_quads``, on the
host, with no wait for the card.

Where one node's F * B cells take several groups (wide rows), each pass
loads only the quads that hold its group's features, so a record's bins
are read about once in all: at F = 968, B = 256, 31 groups of 32
features load the row's 242 quads once. With one group, as at F = 28, a
pass loads the whole row.

What bounds the kernel on an H100: the bytes of every node id and of the
in-range rows' bins, g and h -- at most N * (4F + 12), about 1.36 GB at
N = 11M, F = 28, or ~0.41 ms at 3.35 TB/s; its adds are shared-memory
atomics, whose rate is the second limit. The design (rows sorted into one
run per list of nodes, or read in place where one list holds every row;
one row's record a thread; each value quantised once; exact sums in two
32-bit words a cell; a grid the size of what the card holds) and its
fixed-point sums, which make two launches on the same inputs bitwise
equal, are described in the source. :func:`launch_geometry` is its work
split, and :func:`block_work` says which records and cells each block
owns.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import _build

THREADS = 1024          # threads a histogram block (kThreads)
QUANT_BITS = 28         # |q| <= 2^QUANT_BITS (kQuantBits in the source)
_CELL_BYTES = 16        # two 32-bit words a cell, for g and for h
# Shared memory a block's cells may take: one node of 28 x 256 cells (112
# KiB), not two (224 KiB), which leave the L1 cache too little room for
# the rows' loads (H100: 0.40-0.43 ms a level against 0.58-0.68 ms).
_SMEM_CELLS = 128 * 1024
_MAX_ROWS = 1 << 31     # rows index as int32; N * 2^QUANT_BITS < 2^63
_MAX_CELLS = 1 << 31    # n_nodes * F * B cells index as int32


class Geometry(NamedTuple):
    """The kernel's work split. Nodes form ``lists`` lists of
    ``nodes_per_list`` nodes; the in-range rows' records are sorted into
    one run per list, unless one list holds every row. Each of the
    ``blocks`` blocks takes a contiguous share of the records (of the
    rows, where they are read in place) and, for each of the
    ``cell_groups`` groups of ``cells_per_block`` cells of a list, adds
    them into that group's cells."""
    n_nodes: int
    nodes_per_list: int
    lists: int
    cells_per_block: int
    cell_groups: int
    blocks: int
    total_cells: int
    smem_bytes: int


def flat_cells(bins, node_ids, n_nodes: int, B: int):
    """(cells, keep): the flat output cell ``node*F*B + f*B + bin`` of
    every in-range (row, feature) pair, in row-major order, and the
    [N*F] bool mask of those pairs. Ids outside ``[0, n_nodes)`` and bins
    outside ``[0, B)`` are dropped."""
    F = bins.shape[1]
    keep = (((node_ids >= 0) & (node_ids < n_nodes))[:, None]
            & (bins >= 0) & (bins < B)).reshape(-1)
    cells = (node_ids.long()[:, None] * (F * B)
             + torch.arange(F, device=bins.device) * B
             + bins.long()).reshape(-1)[keep]
    return cells, keep


def histograms_reference(bins, g, h, node_ids, n_nodes: int, F: int,
                         B: int):
    """Plain version: :func:`flat_cells` and ``index_add_``.

    Sums in float64 and rounds once to float32, so it is an accurate
    oracle. Returns (hist_g, hist_h), each ``[n_nodes, F, B]`` f32. A
    non-finite g or h reaches only the bins its row touches (the kernel
    makes the whole plane NaN)."""
    cells, keep = flat_cells(bins, node_ids, n_nodes, B)

    def one(v):
        acc = torch.zeros(n_nodes * F * B, dtype=torch.float64,
                          device=bins.device)
        acc.index_add_(0, cells, v.double()[:, None].expand(-1, F)
                       .reshape(-1)[keep])
        return acc.float().reshape(n_nodes, F, B)

    return one(g), one(h)


def launch_geometry(N: int, F: int, B: int, n_nodes: int, smem_limit: int,
                    resident) -> Geometry:
    """The work split for one call. ``smem_limit``: shared memory a block
    may opt in to; ``resident(cells_per_block)``: blocks the card holds at
    once at that size. A list is as many whole nodes' F * B cells as fit
    a block (one node, in groups of cells, where one does not); the grid
    is what the card holds, never more blocks than rows."""
    if N < 1 or F < 1 or B < 1 or n_nodes < 1:
        raise Mp4jError(f"no geometry for N={N} F={F} B={B} "
                        f"n_nodes={n_nodes}")
    budget = min(smem_limit, _SMEM_CELLS) // _CELL_BYTES
    if budget < 1:
        raise Mp4jError(f"{smem_limit} bytes of shared memory hold no cell")
    fb = F * B
    npl = max(1, min(n_nodes, budget // fb))
    cpb = min(npl * fb, budget)
    groups = -(-npl * fb // cpb)
    blocks = max(1, min(N, resident(cpb)))
    return Geometry(n_nodes, npl, -(-n_nodes // npl), cpb, groups, blocks,
                    n_nodes * fb, _CELL_BYTES * cpb)


def group_quads(geo: Geometry, F: int, B: int):
    """[(q_lo, q_hi)], one a cell group: the 16-byte pieces (quads, four
    features each) of a row that the kernel loads in that group, those
    holding the features its cells belong to. With one node a list, group
    ``s`` is the node's cells ``[s * cpb, (s + 1) * cpb)``, features
    ``[s * cpb // B, ceil((s + 1) * cpb / B))``; a list of several nodes
    is one group of whole rows. A model of the kernel's rule
    (:func:`kernel_group_quads`) for the tests, which hold the two
    equal on the card."""
    if geo.nodes_per_list > 1:
        return [(0, -(-F // 4))]
    cpb, w = geo.cells_per_block, 4 * B
    return [(s * cpb // w, -(-min(F * B, (s + 1) * cpb) // w))
            for s in range(geo.cell_groups)]


def block_work(geo: Geometry, block: int, records: int):
    """(records, cell ranges) that block ``block`` owns when there are
    ``records`` records: the kernel's own rule, for the tests. The cell
    ranges, one a group, are offsets from the first cell of a list."""
    list_cells = geo.total_cells // geo.n_nodes * geo.nodes_per_list
    return (range(records * block // geo.blocks,
                  records * (block + 1) // geo.blocks),
            [(s * geo.cells_per_block,
              min((s + 1) * geo.cells_per_block, list_cells))
             for s in range(geo.cell_groups)])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("hist_kernel")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mp4j_hist_launch.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, i,
                                     i, p, p, p, p, p, p, p, p]
    pi = ctypes.POINTER(ctypes.c_int)
    lib.mp4j_hist_smem_limit.argtypes = [pi]
    lib.mp4j_hist_blocks_per_sm.argtypes = [i, pi]
    lib.mp4j_hist_group_quads.argtypes = [i, i, i, i, i, pi]
    for fn in (lib.mp4j_hist_launch, lib.mp4j_hist_smem_limit,
               lib.mp4j_hist_blocks_per_sm, lib.mp4j_hist_threads,
               lib.mp4j_hist_quant_bits, lib.mp4j_hist_group_quads):
        fn.restype = ctypes.c_int
    lib.mp4j_error_string.argtypes = [ctypes.c_int]
    lib.mp4j_error_string.restype = ctypes.c_char_p
    if (lib.mp4j_hist_threads(), lib.mp4j_hist_quant_bits()) != (
            THREADS, QUANT_BITS):
        raise Mp4jError("hist_kernel.cu and ops/hist_kernel.py disagree on "
                        "kThreads / kQuantBits")
    return lib


def _query(fn, *args) -> int:
    """One int from a C query of the current device, or Mp4jError."""
    out = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(out))
    if rc != 0:
        raise Mp4jError(
            f"hist kernel query failed: "
            f"{_library().mp4j_error_string(rc).decode()}")
    return out.value


@functools.cache
def _smem_limit(index: int) -> int:
    with torch.cuda.device(index):
        return _query(_library().mp4j_hist_smem_limit)


@functools.cache
def _resident(index: int, cells_per_block: int) -> int:
    """Blocks card ``index`` holds at once at ``cells_per_block``."""
    with torch.cuda.device(index):
        per_sm = _query(_library().mp4j_hist_blocks_per_sm, cells_per_block)
    if per_sm < 1:
        raise Mp4jError(
            f"no block of {cells_per_block} histogram cells fits an SM")
    return per_sm * torch.cuda.get_device_properties(
        index).multi_processor_count


@functools.cache
def kernel_group_quads(geo: Geometry, F: int, B: int) -> tuple:
    """((q_lo, q_hi), ...), one a cell group: the quads of a row the kernel
    loads in that group, by its own rule (``group_quad_range`` in the
    source, compiled for the host). Needs the built library."""
    out = (ctypes.c_int * (2 * geo.cell_groups))()
    _library().mp4j_hist_group_quads(F, B, geo.nodes_per_list,
                                     geo.cells_per_block, geo.cell_groups,
                                     out)
    return tuple(zip(out[0::2], out[1::2]))


def _check_inputs(bins, g, h, node_ids, n_nodes: int, F: int, B: int):
    if F < 1 or B < 1 or n_nodes < 0:
        raise Mp4jError(
            f"need F >= 1, B >= 1, n_nodes >= 0; got F={F} B={B} "
            f"n_nodes={n_nodes}")
    if bins.dtype != torch.int32 or bins.ndim != 2 or bins.shape[1] != F:
        raise Mp4jError(
            f"bins must be int32 [N, F={F}], got {bins.dtype} "
            f"{tuple(bins.shape)}")
    N = bins.shape[0]
    for name, t, dt in (("g", g, torch.float32), ("h", h, torch.float32),
                        ("node_ids", node_ids, torch.int32)):
        if t.dtype != dt or tuple(t.shape) != (N,):
            raise Mp4jError(
                f"{name} must be {dt} [N={N}], got {t.dtype} "
                f"{tuple(t.shape)}")
    for name, t in (("bins", bins), ("g", g), ("h", h),
                    ("node_ids", node_ids)):
        if t.device != bins.device:
            raise Mp4jError(
                f"{name} is on {t.device}, bins on {bins.device}")
        if not t.is_contiguous():
            raise Mp4jError(f"{name} must be contiguous")


def absmax_bits(g, h):
    """[2] int32: the bits of max|g| and max|h| over every row, as the
    kernel's first pass takes them (the bits of a non-negative float
    order as the float does; a NaN's above +inf)."""
    if g.numel() == 0:
        return torch.zeros(2, dtype=torch.int32, device=g.device)
    return torch.stack([(v.contiguous().view(torch.int32) & 0x7FFFFFFF).max()
                        for v in (g, h)])


def histograms(bins, g, h, node_ids, n_nodes: int, F: int, B: int,
               absmax=None):
    """Per-(node, feature, bin) gradient/hessian sums.

    bins: [N, F] int32; g, h: [N] f32; node_ids: [N] int32 -- ids outside
    [0, n_nodes) and bins outside [0, B) contribute nothing (the GBDT
    sibling subtraction passes a sentinel id for right-child rows); rows
    with g == h == 0 leave exact zeros. Returns (hist_g, hist_h):
    [n_nodes, F, B] f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel (none when N == 0).

    ``absmax`` ([2] int32 on the device, :func:`absmax_bits` of a larger
    set of rows that holds these) seeds the kernel's max|g| and max|h|,
    so that its fixed-point scale is that set's: the rows' sums are then
    bitwise those of one call over the whole set (the GBDT trainer over
    processes passes the job's). The plain version sums exactly in f64
    and needs no scale."""
    _check_inputs(bins, g, h, node_ids, n_nodes, F, B)
    if absmax is not None and (absmax.dtype != torch.int32
                               or tuple(absmax.shape) != (2,)
                               or absmax.device != bins.device):
        raise Mp4jError(
            f"absmax must be int32 [2] on {bins.device}, got "
            f"{absmax.dtype} {tuple(absmax.shape)} on {absmax.device}")
    dev = bins.device
    if dev.type == "cpu":
        return histograms_reference(bins, g, h, node_ids, n_nodes, F, B)
    if dev.type != "cuda":
        raise Mp4jError(f"histograms runs on cpu or cuda tensors, not {dev}")
    N = bins.shape[0]
    if N == 0 or n_nodes == 0:
        return (torch.zeros((n_nodes, F, B), dtype=torch.float32, device=dev),
                torch.zeros((n_nodes, F, B), dtype=torch.float32, device=dev))
    if N >= _MAX_ROWS or n_nodes * F * B >= _MAX_CELLS:
        raise Mp4jError(
            f"histogram of N={N} rows and {n_nodes * F * B} cells is beyond "
            f"the kernel's limits ({_MAX_ROWS} rows, {_MAX_CELLS} cells)")
    if bins.data_ptr() % 16:
        bins = bins.clone()          # the kernel reads 16-byte vectors
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        geo = launch_geometry(N, F, B, n_nodes, _smem_limit(index),
                              functools.partial(_resident, index))
        # one zeroed buffer: acc [2, cells], counts and cursor [lists],
        # flags (two uint32)
        lists, total = geo.lists, geo.total_cells
        zero = torch.zeros(2 * total + 2 * lists + 1, dtype=torch.int64,
                           device=dev)
        acc, counts, cursor, flags = zero.split([2 * total, lists, lists, 1])
        if absmax is not None:   # the first pass's atomicMax keeps the seed
            flags.view(torch.int32).copy_(absmax)
        offsets = torch.empty(lists + 1, dtype=torch.int64, device=dev)
        recs = torch.empty((N, 4), dtype=torch.int32, device=dev)
        out = torch.empty((2, n_nodes, F, B), dtype=torch.float32,
                          device=dev)
        rc = lib.mp4j_hist_launch(
            bins.data_ptr(), g.data_ptr(), h.data_ptr(), node_ids.data_ptr(),
            N, F, B, n_nodes, geo.nodes_per_list, geo.lists,
            geo.cells_per_block, geo.cell_groups, geo.blocks,
            flags.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
            cursor.data_ptr(), recs.data_ptr(), acc.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise Mp4jError(
            f"hist kernel launch failed: {lib.mp4j_error_string(rc).decode()}")
    histograms.launches += 1
    histograms.row_passes += geo.cell_groups
    histograms.row_quads += sum(
        hi - lo for lo, hi in kernel_group_quads(geo, F, B))
    return out[0], out[1]


histograms.launches = 0
histograms.row_passes = 0
histograms.row_quads = 0
