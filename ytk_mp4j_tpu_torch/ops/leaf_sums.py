"""Per-leaf float64 sums of g and h: the GBDT leaf sums.

``leaf_sums`` is the wrapper of the hand-written CUDA kernel in
``ops/csrc/leaf_sums.cu``, which replaces no Pallas kernel: the JAX
package's ``_onehot_segment_sum2`` (``ytk_mp4j_tpu/models/gbdt.py:332``)
is an MXU product, and the port's first leaf sums were two ATen float64
``index_add`` calls whose global atomics on a few hundred addresses were
contended and landed in another order each run. ``leaf_sums_reference``
is their plain PyTorch version, with the same contract.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. Each call that launches adds one to
``leaf_sums.launches``.

What bounds the kernel on an H100: each row's node id, g and h read once,
N * 12 bytes -- 132 MB at N = 11M, ~0.039 ms at 3.35 TB/s. The design
(each block a tile of one member's rows; private float64 copies of the
leaves' sums in shared memory, a thread's or a warp's; the copies and
then the tiles folded in a fixed order) is described in the source.
:func:`launch_geometry` is its work split, chosen from the leaves and
the rows a member holds, and :func:`fixed_order_sums` repeats its adds
in their order: every sum is the same whichever call, card or process
computes a member's rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import _build

THREADS = 64            # threads of a sum block at most (kMaxThreads)
WARP = 32
FOLD_THREADS = 128      # threads of a fold block (kFoldThreads)
ROWS_PER_THREAD = 256   # rows a thread takes a tile, at the least
ROWS_PER_LEAF = 16      # rows a tile holds a leaf (its partials, 16 B a
                        # leaf, a twelfth of its rows' bytes) ...
MIN_BLOCKS = 512        # ... where a member still makes this many blocks
_SLOT_BYTES = 16        # a float64 g and h copy of one leaf's sums
# Shared memory the copies of a sum block may take: at 64 leaves x 64
# threads, three blocks an SM
_SMEM_SLOTS = 64 * 1024
_MAX_GRID_YZ = 65535    # the grid's members and groups
_MAX_CELLS = 1 << 30    # 2 * n_members * n_leaves fold blocks


class Geometry(NamedTuple):
    """The kernel's work split. Each member's ``per`` rows form ``tiles``
    tiles of ``tile_rows`` rows, one block of ``threads`` threads each,
    row r of a tile (from its start) going to thread r mod ``threads``.
    The block holds ``copies`` private copies of the leaves' sums, one a
    ``lanes`` threads (1: a thread each; WARP: a warp each, its lanes
    adding in lane order) of ``leaves_per_group`` leaves: the leaves
    form ``groups`` groups, a block a (tile, member, group)."""
    threads: int
    lanes: int
    copies: int
    leaves_per_group: int
    groups: int
    tile_rows: int
    tiles: int
    smem_bytes: int


def launch_geometry(per: int, n_leaves: int) -> Geometry:
    """The work split for members of ``per`` rows and ``n_leaves``
    leaves: a copy a thread where THREADS copies fit the budget; else a
    copy a warp, as many warps (up to THREADS threads) as copies fit,
    and groups of as many leaves as one copy a block then leaves room
    for. A tile holds ROWS_PER_THREAD rows a thread, or more where
    ROWS_PER_LEAF rows a leaf are more and a member still makes
    MIN_BLOCKS blocks, tiles times groups (whole rows a thread)."""
    if per < 0 or n_leaves < 1:
        raise Mp4jError(f"no geometry for per={per} n_leaves={n_leaves}")
    leaf_bytes = n_leaves * _SLOT_BYTES
    if THREADS * leaf_bytes <= _SMEM_SLOTS:
        threads, lanes = THREADS, 1
    else:
        lanes = WARP
        threads = WARP * max(1, min(THREADS // WARP,
                                    _SMEM_SLOTS // leaf_bytes))
    copies = threads // lanes
    lpg = min(n_leaves, _SMEM_SLOTS // (copies * _SLOT_BYTES))
    groups = -(-n_leaves // lpg)
    rows = min(ROWS_PER_LEAF * n_leaves, -(-per * groups // MIN_BLOCKS))
    tile_rows = threads * max(ROWS_PER_THREAD, -(-rows // threads))
    return Geometry(threads, lanes, copies, lpg, groups, tile_rows,
                    -(-per // tile_rows), lpg * copies * _SLOT_BYTES)


def _member_cells(node_ids, n_leaves: int, n_members: int):
    """Each row's output cell ``m * n_leaves + id``, and a mask of the rows
    whose id lies in ``[0, n_leaves)``."""
    N = node_ids.shape[0]
    keep = (node_ids >= 0) & (node_ids < n_leaves)
    cells = node_ids.long()
    if n_members > 1:
        member = torch.arange(N, device=node_ids.device) // (N // n_members)
        cells = cells + member * n_leaves
    return cells, keep


def leaf_sums_reference(g, h, node_ids, n_leaves: int, n_members: int = 1):
    """Plain version: float64 ``index_add`` in row order; out-of-range
    rows go to a cell past the end, which is dropped. Returns (sum_g,
    sum_h), each ``[n_members * n_leaves]`` f64."""
    cells, keep = _member_cells(node_ids, n_leaves, n_members)
    n_cells = n_members * n_leaves
    idx = torch.where(keep, cells, n_cells)
    zeros = torch.zeros(n_cells + 1, dtype=torch.float64, device=g.device)
    return (zeros.index_add(0, idx, g.double())[:n_cells],
            zeros.index_add(0, idx, h.double())[:n_cells])


def _halve(x):
    """Fold the last dimension (a power of two) by halving: slot c +=
    slot c + s for s = n/2, ..., 1, as the kernel folds its threads."""
    while x.shape[-1] > 1:
        s = x.shape[-1] // 2
        x = x[..., :s] + x[..., s:]
    return x[..., 0]


def fixed_order_sums(g, h, node_ids, n_leaves: int, n_members: int = 1):
    """The kernel's adds in the kernel's order, in PyTorch (float64), for
    the tests: bitwise the kernel's sums. Copy c of a tile adds, in row
    order, the tile's rows whose position from the tile's start, modulo
    the block's threads, lies in ``[c * lanes, (c + 1) * lanes)``; the
    copies are folded by halving; fold thread t adds the tiles t, t +
    FOLD_THREADS, ... in turn, and the fold threads are folded by
    halving. Groups change which leaves a block holds, never an add's
    place, so the model has none. Returns what :func:`leaf_sums`
    returns."""
    N = g.shape[0]
    per = N // n_members
    geo = launch_geometry(per, n_leaves)
    C, T, R, W = geo.copies, geo.tile_rows, geo.tiles, geo.lanes
    M, L = n_members, n_leaves
    pad = R * T - per
    cells, keep = _member_cells(node_ids, n_leaves, 1)
    leaf = torch.where(keep, cells, 0)
    # an out-of-range or padding row adds +0.0 to leaf 0: a slot is never
    # -0.0 (it starts at +0.0), so that add changes nothing
    vals = torch.stack([torch.where(keep, v.double(), 0.0) for v in (g, h)])

    def grid(x):            # [..., N] -> [..., M, R, C, a copy's rows]
        x = x.reshape(x.shape[:-1] + (M, per))
        x = torch.nn.functional.pad(x, (0, pad))
        x = x.reshape(x.shape[:-1] + (R, T // (C * W), C, W))
        return x.transpose(-3, -2).flatten(-2)

    leaf, vals = grid(leaf), grid(vals)
    slots = torch.zeros(2, M, R, L, C, dtype=torch.float64,
                        device=g.device)
    m, r, c = torch.meshgrid(*(torch.arange(n, device=g.device)
                               for n in (M, R, C)), indexing="ij")
    # a copy's j-th row, j past the rows of the fullest tile: padding only
    for j in range(-(-min(per, T) // (C * W)) * W):
        # each copy takes one row a turn: one add each
        flat = (((m * R + r) * L + leaf[..., j]) * C + c).reshape(-1)
        slots.view(2, -1).index_add_(1, flat, vals[..., j].reshape(2, -1))
    tiles = _halve(slots).permute(0, 1, 3, 2)             # [2, M, L, R]
    K = -(-R // FOLD_THREADS)
    tiles = torch.nn.functional.pad(tiles, (0, K * FOLD_THREADS - R))
    tiles = tiles.reshape(2, M, L, K, FOLD_THREADS)
    acc = torch.zeros(2, M, L, FOLD_THREADS, dtype=torch.float64,
                      device=g.device)
    for k in range(K):
        acc = acc + tiles[..., k, :]
    out = _halve(acc).reshape(2, M * L)
    return out[0], out[1]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("leaf_sums")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mp4j_leaf_sums_launch.argtypes = [p, p, p, ll, i, i, i, i, i, i,
                                          i, ll, ll, p, p, p]
    for fn in (lib.mp4j_leaf_sums_launch, lib.mp4j_leaf_max_threads,
               lib.mp4j_leaf_fold_threads):
        fn.restype = ctypes.c_int
    lib.mp4j_error_string.argtypes = [ctypes.c_int]
    lib.mp4j_error_string.restype = ctypes.c_char_p
    if (lib.mp4j_leaf_max_threads(), lib.mp4j_leaf_fold_threads()) != (
            THREADS, FOLD_THREADS):
        raise Mp4jError("leaf_sums.cu and ops/leaf_sums.py disagree on "
                        "kMaxThreads / kFoldThreads")
    return lib


def _check_inputs(g, h, node_ids, n_leaves: int, n_members: int):
    if n_leaves < 1 or n_members < 1:
        raise Mp4jError(f"need n_leaves >= 1, n_members >= 1; got "
                        f"n_leaves={n_leaves} n_members={n_members}")
    if g.ndim != 1:
        raise Mp4jError(f"g must be [N], got {tuple(g.shape)}")
    N = g.shape[0]
    for name, t, dt in (("g", g, torch.float32), ("h", h, torch.float32),
                        ("node_ids", node_ids, torch.int32)):
        if t.dtype != dt or tuple(t.shape) != (N,):
            raise Mp4jError(
                f"{name} must be {dt} [N={N}], got {t.dtype} "
                f"{tuple(t.shape)}")
        if t.device != g.device:
            raise Mp4jError(f"{name} is on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise Mp4jError(f"{name} must be contiguous")
    if N % n_members:
        raise Mp4jError(f"{N} rows do not split into {n_members} members")


def leaf_sums(g, h, node_ids, n_leaves: int, n_members: int = 1):
    """Per-(member, leaf) sums of g and h in float64.

    g, h: [N] f32; node_ids: [N] int32, member-local leaf ids -- member m
    holds rows ``[m * per, (m + 1) * per)``, per = N / n_members, and
    ids outside [0, n_leaves) contribute nothing. Returns (sum_g, sum_h),
    each ``[n_members * n_leaves]`` f64, member m's leaf l at ``m *
    n_leaves + l``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (none when N == 0), whose sums are bitwise the same
    for a member's rows in any call."""
    _check_inputs(g, h, node_ids, n_leaves, n_members)
    dev = g.device
    if dev.type == "cpu":
        return leaf_sums_reference(g, h, node_ids, n_leaves, n_members)
    if dev.type != "cuda":
        raise Mp4jError(f"leaf_sums runs on cpu or cuda tensors, not {dev}")
    n_cells = n_members * n_leaves
    per = g.shape[0] // n_members
    if per == 0:
        out = torch.zeros((2, n_cells), dtype=torch.float64, device=dev)
        return out[0], out[1]
    geo = launch_geometry(per, n_leaves)
    if max(n_members, geo.groups) > _MAX_GRID_YZ or n_cells > _MAX_CELLS:
        raise Mp4jError(
            f"leaf sums of {n_members} members x {n_leaves} leaves are "
            f"beyond the kernel's limits ({_MAX_GRID_YZ} members and "
            f"groups of leaves, {_MAX_CELLS} cells)")
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        partial = torch.empty(2 * n_cells * geo.tiles, dtype=torch.float64,
                              device=dev)
        out = torch.empty((2, n_cells), dtype=torch.float64, device=dev)
        rc = lib.mp4j_leaf_sums_launch(
            g.data_ptr(), h.data_ptr(), node_ids.data_ptr(), per, n_members,
            n_leaves, geo.threads, int(geo.lanes == WARP),
            geo.copies.bit_length() - 1, geo.leaves_per_group, geo.groups,
            geo.tile_rows, geo.tiles, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise Mp4jError(
            f"leaf sums launch failed: {lib.mp4j_error_string(rc).decode()}")
    leaf_sums.launches += 1
    return out[0], out[1]


leaf_sums.launches = 0
