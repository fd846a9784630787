"""Plain reference of the dense SUM collectives, and the comparison that
judges what the program returned.

Plain PyTorch; it imports nothing of the program. The exact
answer of a member-wise SUM is worked out in float64 from the inputs the
benchmark made; a result is judged element by element against it, each
gap over the sum of the magnitudes that element adds up (the most that
any order of the adds can move it, in units of the type's rounding), so
that an element whose sum lies near 0 is held no looser and no tighter
than any other.

:func:`control_sum` is the same sum computed one precision below the
operand's (float32 for float64, bfloat16 for float32), in the program's
place.
"""

from __future__ import annotations

import torch

_CONTROL = {torch.float64: torch.float32, torch.float32: torch.bfloat16}
COL_BLOCK = 1 << 25      # columns a block takes, to bound memory


def worst_gap(got, x):
    """Worst ``|got - sum| / sum(|x_i|)`` over the columns of the members
    ``x`` [n, L], ``got`` [L] being their results; inf where ``got``
    holds a NaN."""
    worst = 0.0
    for a in range(0, x.shape[1], COL_BLOCK):
        b = min(x.shape[1], a + COL_BLOCK)
        xs = x[:, a:b].to(torch.float64)
        want = xs.sum(0)
        mag = xs.abs().sum(0).clamp(min=torch.finfo(torch.float64).tiny)
        m = ((got[a:b].to(torch.float64) - want).abs() / mag).max().item()
        if m != m:
            return float("inf")
        worst = max(worst, m)
    return worst


def control_sum(x):
    """The SUM over rows computed one precision below ``x``'s (inputs and
    result rounded to it, adds in float32), returned in ``x``'s type."""
    low = _CONTROL[x.dtype]
    return x.to(low).to(torch.float32).sum(0).to(low).to(x.dtype)
