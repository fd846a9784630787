"""(node x feature x bin) gradient/hessian histograms: the GBDT hot op.

``histograms`` is the wrapper of the hand-written CUDA kernel in
``ops/csrc/hist_kernel.cu``, which replaces the Pallas TPU kernel
``ytk_mp4j_tpu/ops/hist_kernel.py:70`` (``_hist_kernel``, called through
``pallas_histograms:106``). ``histograms_reference`` is its plain
PyTorch version, with the same contract.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. Each launch adds one to
``histograms.launches``.

What bounds the kernel on an H100: one level reads every row once,
N * (4F + 12) bytes -- about 1.36 GB at N = 11M, F = 28, or ~0.41 ms at
3.35 TB/s; its adds are far below the card's rate. The design (private
shared-memory histograms per block, one block per feature and row range,
the F blocks of one row range scheduled together so the rows come from
DRAM about once) and its 64-bit fixed-point sums, which make two launches
on the same inputs bitwise equal, are described in the source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import _build

_THREADS = 256          # threads a block (kThreads in the source)
_MAX_CELLS = 8192       # (node, bin) cells a block holds: 16 B each, 128 KiB
_BLOCKS_PER_SM = 8      # row blocks are sized for about this many per SM
_MAX_GRID_YZ = 65535


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


def launch_geometry(N: int, F: int, B: int, n_nodes: int, n_sm: int):
    """(rows_per_block, row_blocks, cells_per_block, cell_groups) of the
    kernel's grid (F, row_blocks, cell_groups): enough row blocks for
    about ``_BLOCKS_PER_SM`` blocks an SM, and the n_nodes * B cells of a
    feature cut into groups that fit shared memory."""
    cells = n_nodes * B
    cells_per_block = min(cells, _MAX_CELLS)
    cell_groups = -(-cells // cells_per_block)
    if cell_groups > _MAX_GRID_YZ:
        raise Mp4jError(
            f"histogram of {n_nodes} nodes x {B} bins needs {cell_groups} "
            f"cell groups, over the grid limit {_MAX_GRID_YZ}")
    target = _BLOCKS_PER_SM * n_sm
    row_blocks = max(1, min(-(-target // (F * cell_groups)),
                            -(-N // _THREADS), _MAX_GRID_YZ))
    rows_per_block = -(-N // row_blocks)
    row_blocks = -(-N // rows_per_block)
    return rows_per_block, row_blocks, cells_per_block, cell_groups


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("hist_kernel")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mp4j_hist_launch.argtypes = [p, p, p, p, ll, i, i, i, ll, i, i, i,
                                     i, p, p, p, p]
    lib.mp4j_hist_launch.restype = ctypes.c_int
    lib.mp4j_error_string.argtypes = [ctypes.c_int]
    lib.mp4j_error_string.restype = ctypes.c_char_p
    return lib


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


def histograms(bins, g, h, node_ids, n_nodes: int, F: int, B: int):
    """Per-(node, feature, bin) gradient/hessian sums.

    bins: [N, F] int32; g, h: [N] f32; node_ids: [N] int32 -- ids outside
    [0, n_nodes) and bins outside [0, B) contribute nothing (the GBDT
    sibling subtraction passes a sentinel id for right-child rows); rows
    with g == h == 0 leave exact zeros. Returns (hist_g, hist_h):
    [n_nodes, F, B] f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel (none when N == 0)."""
    _check_inputs(bins, g, h, node_ids, n_nodes, F, B)
    dev = bins.device
    if dev.type == "cpu":
        return histograms_reference(bins, g, h, node_ids, n_nodes, F, B)
    if dev.type != "cuda":
        raise Mp4jError(f"histograms runs on cpu or cuda tensors, not {dev}")
    N = bins.shape[0]
    if N == 0 or n_nodes == 0:
        return (torch.zeros((n_nodes, F, B), dtype=torch.float32, device=dev),
                torch.zeros((n_nodes, F, B), dtype=torch.float32, device=dev))
    lib = _library()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_per_block, row_blocks, cells_per_block, cell_groups = (
        launch_geometry(N, F, B, n_nodes, n_sm))
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    acc = torch.zeros(2 * n_nodes * F * B, dtype=torch.int64, device=dev)
    out = torch.empty((2, n_nodes, F, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mp4j_hist_launch(
            bins.data_ptr(), g.data_ptr(), h.data_ptr(), node_ids.data_ptr(),
            N, F, B, n_nodes, rows_per_block, row_blocks, cells_per_block,
            cell_groups, (N - 1).bit_length(), flags.data_ptr(),
            acc.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise Mp4jError(
            f"hist kernel launch failed: {lib.mp4j_error_string(rc).decode()}")
    histograms.launches += 1
    return out[0], out[1]


histograms.launches = 0
