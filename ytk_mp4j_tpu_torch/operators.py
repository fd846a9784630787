"""Reduction operators (the port of ``ytk_mp4j_tpu/operators.py:42-152``).

An :class:`Operator` is dtype-generic: the element type lives on the
:class:`~ytk_mp4j_tpu_torch.operands.Operand`. Each operator carries

- ``np_fn``    -- a numpy binary (host arrays),
- ``torch_fn`` -- a torch binary on tensors of one dtype; the result keeps
  that dtype, so narrow integers wrap and bf16 rounds at every step, as
  the reference's ``jnp_fn`` does,
- ``identity(dtype)`` -- the identity element, used for padding so that
  padded lanes never change a result,
- ``kernel_code`` -- the operator's code in the CUDA ring kernels
  (``ops/csrc/ring_cluster.cu``, ``ops/csrc/ring_kernel.cu``), or None
  for a custom operator, which the kernels cannot run.

``identity`` takes a numpy dtype (a 0-d numpy scalar comes back, as in
the reference) or a torch dtype (a Python number comes back). The
identities equal the reference's for every dtype; bf16's MAX/MIN
identities come from ``torch.finfo`` (the reference reads
``ml_dtypes.finfo``: the same values).

User-defined operators: ``Operator.custom(name, fn, identity)`` with one
binary ``fn`` that works on numpy arrays and torch tensors alike (the two
share the ufunc surface for most element-wise functions), or a separate
``torch_fn``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError

# kernel_code ids must match the op codes of ops/csrc/ring_cluster.cu and
# ops/csrc/ring_kernel.cu.
_SUM, _PROD, _MAX, _MIN = 0, 1, 2, 3


def _finfo(dt):
    """torch.finfo of a floating torch dtype or of the numpy bfloat16."""
    if isinstance(dt, torch.dtype):
        return torch.finfo(dt)
    if dt.kind == "V" and dt.itemsize == 2:      # ml_dtypes.bfloat16
        return torch.finfo(torch.bfloat16)
    raise Mp4jError(f"no identity for dtype {dt}")


def _is_float(dt) -> bool:
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    return dt.kind in "fV"


def _iinfo(dt):
    return torch.iinfo(dt) if isinstance(dt, torch.dtype) else np.iinfo(dt)


def _sum_identity(dt):
    return 0


def _prod_identity(dt):
    return 1


def _is_bf16(dt) -> bool:
    return dt == torch.bfloat16 if isinstance(dt, torch.dtype) \
        else dt.kind == "V"


def _max_identity(dt):
    if _is_bf16(dt):
        return float(_finfo(dt).min)    # as the reference: finite, not -inf
    if _is_float(dt):
        return -float("inf")
    return int(_iinfo(dt).min)


def _min_identity(dt):
    if _is_bf16(dt):
        return float(_finfo(dt).max)
    if _is_float(dt):
        return float("inf")
    return int(_iinfo(dt).max)


@dataclass(frozen=True)
class Operator:
    name: str
    np_fn: Callable[[Any, Any], Any]
    torch_fn: Callable[[Any, Any], Any]
    _identity: Callable[[Any], Any]
    kernel_code: int | None = None

    def identity(self, dtype) -> Any:
        """The identity element: a 0-d numpy scalar of a numpy ``dtype``,
        a Python number for a torch dtype."""
        if isinstance(dtype, torch.dtype):
            return self._identity(dtype)
        dt = np.dtype(dtype)
        return np.asarray(self._identity(dt), dtype=dt)[()]

    @property
    def is_builtin(self) -> bool:
        return self.kernel_code is not None

    def __call__(self, a, b):
        return self.np_fn(a, b)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Operator({self.name})"

    @staticmethod
    def custom(name: str, fn: Callable[[Any, Any], Any], identity: Any,
               torch_fn: Callable[[Any, Any], Any] | None = None
               ) -> "Operator":
        """A user-defined commutative, associative reduction. ``fn``
        takes two arrays and returns their element-wise reduction;
        ``identity`` satisfies ``fn(identity, x) == x`` and pads."""
        return Operator(name=name, np_fn=fn,
                        torch_fn=torch_fn if torch_fn is not None else fn,
                        _identity=lambda dt, _i=identity: _i,
                        kernel_code=None)


class Operators:
    """Namespace of the builtin operators."""

    SUM = Operator("SUM", np.add, torch.add, _sum_identity, _SUM)
    PROD = Operator("PROD", np.multiply, torch.mul, _prod_identity, _PROD)
    MAX = Operator("MAX", np.maximum, torch.maximum, _max_identity, _MAX)
    MIN = Operator("MIN", np.minimum, torch.minimum, _min_identity, _MIN)

    _ALL: dict[str, Operator] = {}

    @classmethod
    def by_name(cls, name: str) -> Operator:
        try:
            return cls._ALL[name.upper()]
        except KeyError:
            raise Mp4jError(f"unknown operator {name!r}") from None


Operators._ALL = {op.name: op for op in (Operators.SUM, Operators.PROD,
                                         Operators.MAX, Operators.MIN)}
