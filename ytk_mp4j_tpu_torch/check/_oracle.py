"""Numpy-oracle helpers for the check programs (a copy of
``ytk_mp4j_tpu/check/_oracle.py``): every rank regenerates every rank's
input and computes the expected result locally."""

from __future__ import annotations

import numpy as np

NP_REF = {"SUM": np.add, "PROD": np.multiply, "MAX": np.maximum,
          "MIN": np.minimum}


def rank_data(rank: int, length: int, operand, seed_base: int) -> np.ndarray:
    """Deterministic per-rank input (every rank can regenerate every
    other rank's data to compute expectations locally)."""
    rng = np.random.default_rng(seed_base + rank)
    if operand.dtype.kind == "f":
        return rng.standard_normal(length).astype(operand.dtype)
    return rng.integers(1, 4, length).astype(operand.dtype)


def expected_reduce(arrs, op_name: str) -> np.ndarray:
    out = arrs[0].copy()
    for a in arrs[1:]:
        out = NP_REF[op_name](out, a)
    return out
