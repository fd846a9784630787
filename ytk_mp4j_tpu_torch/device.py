"""Where the port runs: the counterpart of ``parallel/mesh.py``
(``make_mesh:29``, ``make_hier_mesh:46``).

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
On a one-process mesh ``group`` is None and every member is local.

Two forms of a one-process mesh, beside each other:

- **packed** (``make_mesh(n, device)``): the n members are the rows of
  one ``[n, ...]`` tensor on one device;
- **list** (``make_mesh(n, devices=[...])``, the reference's own meaning
  of ``devices``): member m lives on ``devices[m]`` as a tensor of its
  own, one member a list entry, in one process. Entries may repeat: a
  list that names ``cuda:0`` n times runs the list form's whole code
  path on one card (n member tensors, n launches, peer pointers), and
  ``["cpu"] * n`` runs it on the CPU. Every entry goes through
  :func:`make_device`, so an entry naming a card that is not there
  raises; nothing moves to the CPU or folds a list onto one card.

The default stays one member on ``cuda:0``, never every visible card.
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
    None on a one-process mesh (every member local).

    ``devices`` is None for the packed form. For the list form it is the
    tuple of the n members' devices (``torch.device``), member m on
    ``devices[m]``, and ``device`` is member 0's: where a trainer keeps
    what the members share (trees, gathered margins, predictions) and
    where the list-form collectives fold."""

    n: int
    device: torch.device
    shape: tuple
    group: object = None
    first: int = 0
    local: int | None = None
    devices: tuple | None = None

    @property
    def n_local(self) -> int:
        """Members held by this process."""
        return self.n if self.local is None else self.local

    @property
    def is_list(self) -> bool:
        """Whether each member is a tensor of its own (the list form)."""
        return self.devices is not None


def _check_count(n, what: str, unit: str = "") -> None:
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise Mp4jError(f"a mesh needs {what} >= 1{unit}, got {n!r}")


def _member_devices(n: int, device, devices):
    """(member 0's device, the list form's devices or None)."""
    if devices is None:
        return make_device(device), None
    if device is not None:
        raise Mp4jError("give device (the packed form) or devices (the "
                        "list form), not both")
    if isinstance(devices, (str, torch.device)) or not hasattr(
            devices, "__len__"):
        raise Mp4jError(f"devices must be a list of devices, got "
                        f"{devices!r}")
    if len(devices) < n:
        raise Mp4jError(f"cannot build a mesh of {n} members from "
                        f"{len(devices)} devices")
    devs = tuple(make_device(d) for d in list(devices)[:n])
    if len({d.type for d in devs}) > 1:
        raise Mp4jError(f"a list mesh lies on CUDA devices or on the CPU, "
                        f"not both: {[str(d) for d in devs]}")
    return devs[0], devs


def make_mesh(n: int, device=None, devices=None) -> Mesh:
    """n >= 1 members: packed on :func:`make_device` ``(device)``, or,
    given ``devices`` (at least n entries, repeats allowed), member m on
    ``make_device(devices[m])``."""
    _check_count(n, "n", " members")
    dev, devs = _member_devices(n, device, devices)
    return Mesh(n, dev, (n,), devices=devs)


def make_hier_mesh(inter: int, intra: int, device=None,
                   devices=None) -> Mesh:
    """``inter * intra`` members in the reference's process x thread
    nesting, packed on :func:`make_device` ``(device)`` or one a
    ``devices`` entry (as :func:`make_mesh`); member ``(i, j)`` is rank
    ``i * intra + j``."""
    _check_count(inter, "inter")
    _check_count(intra, "intra")
    dev, devs = _member_devices(inter * intra, device, devices)
    return Mesh(inter * intra, dev, (inter, intra), devices=devs)
