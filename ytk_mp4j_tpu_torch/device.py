"""Where the port runs: the counterpart of ``parallel/mesh.py``
(``make_mesh:29``, ``make_hier_mesh:46``), on one device.

Every entry point resolves its ``device`` argument here. With none it
takes ``cuda:0``; where CUDA is absent that is an error, never a quiet
move to the CPU. The CPU runs only when the caller names it (the tests
do). :func:`make_mesh` places n collective members on that one device;
rank r is row r of the members' ``[n, ...]`` tensors, the reference's
``flat_index`` on a flat axis. :func:`make_hier_mesh` gives the same
members an ``(inter, intra)`` shape; ranks stay row-major with inter
outermost, so member ``(i, j)`` is rank ``i * intra + j`` and a
reduction over every member folds them in that flat order, as the
reference's ``psum`` over the ``(inter, intra)`` axes tuple.

A mesh over several processes (``comm.distributed.global_mesh`` /
``hier_global_mesh``) also holds the ``torch.distributed`` process group:
each process holds the members ``[first, first + local)`` on its one
device, and the members of all processes form the mesh in rank order.
On a one-process mesh ``group`` is None and every member is local. The
device list for members on several cards of one process comes with a
later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError


def make_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; ``"cpu"``, ``"cuda"`` or ``"cuda:k"`` (or a
    ``torch.device``) as given. Raises Mp4jError for a CUDA device when
    CUDA is absent, and for any other device type."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise Mp4jError(f"the port runs on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        raise Mp4jError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise Mp4jError(
            f"cuda:{index} requested, {torch.cuda.device_count()} visible")
    return torch.device("cuda", index)


class Mesh(NamedTuple):
    """n members in a flat ``(n,)`` or ``(inter, intra)`` shape; this
    process holds members ``[first, first + n_local)`` on ``device``.
    ``group`` is the process group of a mesh over several processes,
    None on a one-process mesh (every member local)."""

    n: int
    device: torch.device
    shape: tuple
    group: object = None
    first: int = 0
    local: int | None = None

    @property
    def n_local(self) -> int:
        """Members held by this process."""
        return self.n if self.local is None else self.local


def _check_count(n, what: str, unit: str = "") -> None:
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise Mp4jError(f"a mesh needs {what} >= 1{unit}, got {n!r}")


def make_mesh(n: int, device=None) -> Mesh:
    """n >= 1 members on :func:`make_device` ``(device)``."""
    _check_count(n, "n", " members")
    return Mesh(n, make_device(device), (n,))


def make_hier_mesh(inter: int, intra: int, device=None) -> Mesh:
    """``inter * intra`` members on :func:`make_device` ``(device)`` in
    the reference's process x thread nesting; member ``(i, j)`` is rank
    ``i * intra + j``."""
    _check_count(inter, "inter")
    _check_count(intra, "intra")
    return Mesh(inter * intra, make_device(device), (inter, intra))
