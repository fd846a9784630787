"""Seeds and the sample of a window's answers that a run judges."""

from __future__ import annotations

import random

import torch


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` (any whole
    number: it is taken modulo 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    return gen


class Reservoir:
    """A uniform sample of ``k`` of a window's items, drawn from the seed.
    :meth:`slot` is asked before item i runs (the draw depends only on i),
    so that a driver copies only what a sampled item leaves behind."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.items = [None] * k

    def slot(self):
        """The slot the next item takes, or None where it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None

    def kept(self) -> list:
        return [x for x in self.items if x is not None]
