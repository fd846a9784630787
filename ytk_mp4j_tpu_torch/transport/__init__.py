"""Transport SPI package: the abstract :class:`Channel` contract plus
the concrete transports — TCP (:mod:`.tcp`) and intra-host shared
memory (:mod:`.shm`). Constructing a concrete channel (or a raw
socket) outside this package is an mp4j-lint R12 violation; rendezvous
holds the only baselined sites.

A copy of ``ytk_mp4j_tpu/transport/__init__.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.
"""

from ytk_mp4j_tpu_torch.transport.channel import Channel
from ytk_mp4j_tpu_torch.transport.shm import ShmChannel
from ytk_mp4j_tpu_torch.transport.tcp import TcpChannel, connect

__all__ = ["Channel", "TcpChannel", "ShmChannel", "connect"]
