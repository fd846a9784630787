"""Socket-plane jobs over either package, for the parity tests.

``PKGS["ref"]`` and ``PKGS["port"]`` name the JAX package's and the
port's socket plane (``Master``, ``ProcessCommSlave``, ``ThreadCommSlave``,
the operands and operators). :func:`run_job` starts one package's master
and n slave threads, each of any package, as ``tests/helpers.py``
``run_slaves`` does; ``run_threads`` (from ``tests/test_thread_comm.py``)
runs a thread group; :func:`canon` turns results into comparable values
that keep every bit.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np

from test_thread_comm import run_threads  # noqa: F401 (re-exported)

import ytk_mp4j_tpu.comm.master as r_master
import ytk_mp4j_tpu.comm.process_comm as r_pc
import ytk_mp4j_tpu.comm.thread_comm as r_tc
import ytk_mp4j_tpu.operands as r_operands
import ytk_mp4j_tpu.operators as r_operators
import ytk_mp4j_tpu_torch.comm.master as p_master
import ytk_mp4j_tpu_torch.comm.process_comm as p_pc
import ytk_mp4j_tpu_torch.comm.thread_comm as p_tc
import ytk_mp4j_tpu_torch.operands as p_operands
import ytk_mp4j_tpu_torch.operators as p_operators

PKGS = {
    "ref": SimpleNamespace(
        Master=r_master.Master, Slave=r_pc.ProcessCommSlave,
        Thread=r_tc.ThreadCommSlave, Operands=r_operands.Operands,
        Operators=r_operators.Operators, Operator=r_operators.Operator),
    "port": SimpleNamespace(
        Master=p_master.Master, Slave=p_pc.ProcessCommSlave,
        Thread=p_tc.ThreadCommSlave, Operands=p_operands.Operands,
        Operators=p_operators.Operators, Operator=p_operators.Operator),
}

NUMERIC = ("DOUBLE", "FLOAT", "INT", "LONG", "SHORT", "BYTE", "BFLOAT16")
JOIN = 60.0


def run_job(master_pkg: str, slave_pkgs, fn, timeout: float = JOIN,
            **slave_kwargs) -> list:
    """A master of ``master_pkg`` and one slave thread per entry of
    ``slave_pkgs``; ``fn(slave, rank, pkg)`` runs on each. Returns the
    results by rank; raises the first slave error; asserts the master's
    exit code is 0."""
    n = len(slave_pkgs)
    master = PKGS[master_pkg].Master(n, timeout=timeout).serve_in_thread()
    results = [None] * n
    errors = []

    def worker(pkg):
        slave = None
        try:
            slave = pkg.Slave("127.0.0.1", master.port, timeout=timeout,
                              **slave_kwargs)
            results[slave.rank] = fn(slave, slave.rank, pkg)
            slave.close(0)
        except Exception as e:
            errors.append(e)
            if slave is not None:
                try:
                    slave.close(1)
                except Exception:
                    pass

    threads = [threading.Thread(target=worker, args=(PKGS[p],), daemon=True)
               for p in slave_pkgs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "slave thread hung"
    if errors:
        raise errors[0]
    master.join(timeout)
    assert master.final_code == 0
    return results


def run_pkg(pkg: str, n: int, fn, **kw) -> list:
    """A job of one package: its master and n of its slaves."""
    return run_job(pkg, [pkg] * n, fn, **kw)


def rank_array(rank: int, length: int, dtype, seed: int = 0) -> np.ndarray:
    """Seeded data of one rank: normal floats, integers in [1, 4)."""
    rng = np.random.default_rng(seed * 1000 + rank)
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        return rng.integers(1, 4, length).astype(dt)
    return rng.standard_normal(length).astype(np.float32).astype(dt)


def canon(x):
    """A comparable form of a result that keeps every bit: arrays and
    numpy scalars as (dtype, shape, bytes); dicts as sorted items."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.dtype.name, x.shape,
                np.ascontiguousarray(x).tobytes())
    if isinstance(x, np.generic):
        return ("np", x.dtype.name, x.tobytes())
    if isinstance(x, dict):
        return ("dict", sorted(((repr(k), canon(v)) for k, v in x.items()),
                               key=lambda kv: kv[0]))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [canon(v) for v in x])
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(v) for v in x))
    return ("py", type(x).__name__, repr(x))
