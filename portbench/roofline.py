"""The yardstick's arithmetic: the card's peaks, the least bytes each
measured operation needs, and the bus bytes of a collective.

Frozen here so that a change to the program cannot change what it is
measured against. Each count is of what the inputs need, at the least
width their values need, each input byte read once and each output byte
written once, whatever the program reads again or stores wider.

Origins: ``ring_bound_ms`` is ``chip_smoke.py``'s ``ring_bound_ms``;
``hist_level_bytes`` is ``chip_smoke.py``'s ``level_bound_ms`` with each
value at its least width (a bin of 256 values at one byte, a node id at
one byte while the ids fit one, where the program stores int32 for both).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the card's 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
F64_OPS_PER_S = 34e12          # float64 outside the tensor cores

_ITEM_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "int64": 8,
               "int32": 4, "int16": 2, "int8": 1}
_OPS_PER_S = {"float64": F64_OPS_PER_S}


def value_bytes(n_values: int) -> int:
    """Least whole bytes that hold one of ``n_values`` distinct values."""
    if n_values < 1:
        raise ValueError(f"no width holds {n_values} values")
    width, cap = 1, 256
    while n_values > cap:
        width, cap = width + 1, cap * 256
    return width


def least_seconds(moved_bytes: float, ops: float = 0.0,
                  ops_per_s: float = F32_OPS_PER_S) -> float:
    """The larger of the bytes at the HBM rate and the ops at ``ops_per_s``."""
    return max(moved_bytes / HBM_BYTES_PER_S, ops / ops_per_s)


# ----------------------------------------------------------------------
# GBDT
# ----------------------------------------------------------------------
def tree_bytes(n_rows: int, n_features: int, n_bins: int, depth: int) -> float:
    """Least bytes of one boosting round: every row's bins and its g and h
    (4 bytes each) at level 0, then at each later level at least the
    smaller child's rows, at most half of them."""
    row = n_features * value_bytes(n_bins) + 8
    return n_rows * row * (1 + (depth - 1) / 2)


def tree_seconds(n_rows: int, n_features: int, n_bins: int,
                 depth: int) -> float:
    """Least time of one boosting round on one card: its bytes bound it;
    the adds (two a row and feature a level) are far fewer at 67 TFLOP/s."""
    adds = 2 * n_rows * n_features * depth
    return least_seconds(tree_bytes(n_rows, n_features, n_bins, depth), adds)


def hist_level_bytes(n_rows: int, n_valid: int, n_nodes: int,
                     n_features: int, n_bins: int) -> int:
    """Least bytes of one histogram call: every row's node id (the
    sentinel included), the bins, g and h of the ``n_valid`` rows whose
    id is in range, each read once, and both output planes of
    ``n_nodes`` x F x B f32 cells, each written once."""
    ids = n_rows * value_bytes(n_nodes + 1)
    rows = n_valid * (n_features * value_bytes(n_bins) + 8)
    out = 2 * n_nodes * n_features * n_bins * 4
    return ids + rows + out


def hist_level_seconds(n_rows: int, n_valid: int, n_nodes: int,
                       n_features: int, n_bins: int) -> float:
    """Least time of one histogram call: its bytes against its adds (two
    a valid row and feature) at the f32 rate."""
    return least_seconds(
        hist_level_bytes(n_rows, n_valid, n_nodes, n_features, n_bins),
        2 * n_valid * n_features)


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def ring_bytes(mode: str, n: int, length: int, dtype: str) -> int:
    """Least bytes of one collective over ``n`` members packed on one
    card: ``length`` is a member's input (reduce-scatter, allreduce) or
    shard (allgather) in elements."""
    moved = {"allreduce": 2 * n * length,
             "reduce_scatter": n * length + length,
             "allgather": n * length + n * n * length}[mode]
    return moved * _ITEM_BYTES[dtype]


def ring_seconds(mode: str, n: int, length: int, dtype: str) -> float:
    """Least time of one collective: its bytes against its folds."""
    ops = 0 if mode == "allgather" else (n - 1) * length
    return least_seconds(ring_bytes(mode, n, length, dtype), ops,
                         _OPS_PER_S.get(dtype, F32_OPS_PER_S))


def bus_bytes(mode: str, n: int, length: int, dtype: str) -> float:
    """nccl-tests' bus bytes of one call: allreduce 2(n-1)/n of a rank's
    buffer, reduce-scatter (n-1)/n of a rank's input, allgather (n-1)/n
    of a rank's output. ``length`` as in :func:`ring_bytes`."""
    item = _ITEM_BYTES[dtype]
    if mode == "allreduce":
        return 2 * (n - 1) / n * length * item
    if mode == "reduce_scatter":
        return (n - 1) / n * length * item
    if mode == "allgather":
        return (n - 1) / n * n * length * item
    raise ValueError(f"no bus bytes for {mode!r}")
