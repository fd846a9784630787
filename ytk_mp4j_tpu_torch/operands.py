"""Operands: the element type of what is communicated (the port of
``ytk_mp4j_tpu/operands.py``).

Numeric operands map to numpy dtypes at the host API and to torch dtypes
on the device. ``STRING`` and ``OBJECT`` operands are host-only: they
have no dense-array form, and the device collectives reject them.

``BFLOAT16`` exists only where ``ml_dtypes`` imports (numpy has no bf16
of its own), as in the reference; every other operand needs numpy
alone. :func:`to_tensor` and :func:`to_numpy` move host arrays to and
from the device, bf16 included (as its 16 bits).

Divergence from the reference: 8-byte operands need no switch here
(the reference rejects them unless ``jax_enable_x64`` is on).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError

_TORCH_DTYPES = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
}

try:
    import ml_dtypes as _mld

    _BF16 = np.dtype(_mld.bfloat16)
    _TORCH_DTYPES[_BF16] = torch.bfloat16
except ImportError:  # the card's machine has no ml_dtypes
    _BF16 = None


@dataclass(frozen=True)
class Operand:
    name: str
    dtype: np.dtype | None  # None => host-only (STRING / OBJECT)
    # optional user codec for OBJECT operands: (dumps, loads) over bytes
    dumps: Callable[[Any], bytes] | None = None
    loads: Callable[[bytes], Any] | None = None

    @property
    def is_numeric(self) -> bool:
        return self.dtype is not None

    @property
    def torch_dtype(self) -> torch.dtype:
        if not self.is_numeric:
            raise Mp4jError(f"{self.name} operand has no device dtype")
        return _TORCH_DTYPES[self.dtype]

    def check_array(self, arr) -> np.ndarray:
        """Validate a host array for this operand."""
        if not self.is_numeric:
            raise Mp4jError(f"{self.name} operand has no dense-array form")
        a = np.asarray(arr)
        if a.dtype != self.dtype:
            raise Mp4jError(
                f"array dtype {a.dtype} does not match operand {self.name} "
                f"({self.dtype})")
        return a

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Operand({self.name})"


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (bf16 through its bits)."""
    a = np.ascontiguousarray(a)
    if _BF16 is not None and a.dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array (bf16 as ``ml_dtypes.bfloat16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if _BF16 is None:
            raise Mp4jError("bf16 to numpy needs ml_dtypes")
        return t.view(torch.int16).numpy().view(_BF16)
    return t.numpy()


class Operands:
    """Factory namespace mirroring the reference's ``Operands``."""

    DOUBLE = Operand("DOUBLE", np.dtype(np.float64))
    FLOAT = Operand("FLOAT", np.dtype(np.float32))
    INT = Operand("INT", np.dtype(np.int32))
    LONG = Operand("LONG", np.dtype(np.int64))
    SHORT = Operand("SHORT", np.dtype(np.int16))
    BYTE = Operand("BYTE", np.dtype(np.int8))
    STRING = Operand("STRING", None)
    BFLOAT16 = Operand("BFLOAT16", _BF16) if _BF16 is not None else None

    @staticmethod
    def DOUBLE_OPERAND() -> Operand:
        return Operands.DOUBLE

    @staticmethod
    def FLOAT_OPERAND() -> Operand:
        return Operands.FLOAT

    @staticmethod
    def INT_OPERAND() -> Operand:
        return Operands.INT

    @staticmethod
    def LONG_OPERAND() -> Operand:
        return Operands.LONG

    @staticmethod
    def SHORT_OPERAND() -> Operand:
        return Operands.SHORT

    @staticmethod
    def BYTE_OPERAND() -> Operand:
        return Operands.BYTE

    @staticmethod
    def STRING_OPERAND() -> Operand:
        return Operands.STRING

    @staticmethod
    def OBJECT_OPERAND(dumps=None, loads=None) -> Operand:
        """Generic object operand with an optional user codec."""
        return Operand("OBJECT", None, dumps=dumps, loads=loads)

    NUMERIC = tuple(op for op in (DOUBLE, FLOAT, INT, LONG, SHORT, BYTE,
                                  BFLOAT16) if op is not None)

    @classmethod
    def by_dtype(cls, dtype) -> Operand:
        dt = np.dtype(dtype)
        for op in cls.NUMERIC:
            if op.dtype == dt:
                return op
        raise Mp4jError(f"no operand for dtype {dt}")
