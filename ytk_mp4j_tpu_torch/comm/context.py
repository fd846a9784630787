"""The per-rank comm contract (the port of ``ytk_mp4j_tpu/comm/context.py``,
``CommSlave:26``): rank and size, the collectives, ``barrier``,
``info`` / ``error`` and ``close(code)``.

Backends of the port:

- :class:`~ytk_mp4j_tpu_torch.comm.gpu_comm.GpuCommCluster`, a
  single-controller cluster over n members of one device;
- :class:`~ytk_mp4j_tpu_torch.comm.distributed.DistributedComm`, one rank
  a process, over ``torch.distributed``;
- the socket plane: ``comm.process_comm.ProcessCommSlave`` (one rank a
  process, over the TCP and shared-memory transports, with a
  ``comm.master.Master`` for rendezvous) and
  ``comm.thread_comm.ThreadCommSlave`` (thread ranks nested over a
  process slave, or a standalone thread group). They override ``info``
  / ``error`` to forward to the master's console.
"""

from __future__ import annotations

import abc
import sys
import time


class CommSlave(abc.ABC):
    """Per-rank communication endpoint."""

    @property
    @abc.abstractmethod
    def rank(self) -> int: ...

    @property
    @abc.abstractmethod
    def slave_num(self) -> int: ...

    @abc.abstractmethod
    def barrier(self) -> None: ...

    @abc.abstractmethod
    def close(self, code: int = 0) -> None: ...

    def reset_map_vocabularies(self) -> None:
        """Drop any persistent map key<->code vocabularies. No-op on
        backends without codecs, so periodic-reset code is portable
        across the contract; the device backends override. COLLECTIVE in
        effect where state exists: every rank must call it at the same
        program point."""

    # -- logging: local stderr with a rank prefix
    def info(self, msg: str) -> None:
        print(self._fmt("INFO", msg), file=sys.stderr, flush=True)

    def error(self, msg: str) -> None:
        print(self._fmt("ERROR", msg), file=sys.stderr, flush=True)

    def _fmt(self, level: str, msg: str) -> str:
        ts = time.strftime("%H:%M:%S")
        return f"[{ts}][rank {self.rank}/{self.slave_num}][{level}] {msg}"
