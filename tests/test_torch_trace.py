"""Per-collective tracing on the port's device planes, mirrored from
``tests/test_trace.py``.

The device cases run on ``GpuCommCluster(2, device="cpu")``, whose rows
are named ``GpuCommCluster.<method>`` where the reference's say
``TpuCommCluster.<method>``; payload bytes are the reference's (a list of
two 1024-element f32 arrays is 8192 bytes). The socket and thread cases
of that file run in ``tests/test_torch_socket_parity.py``. The
``utils/trace`` cases run on the port's module, the profiler window on
``torch.profiler``. One case traces ``DistributedComm`` in a gloo job of
one rank that meets through a file store under ``tmp_path``; one holds the
port's rows against the reference's ``TpuCommCluster(2)`` on the same
calls, name for name (the class prefix mapped) and byte for byte.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ytk_mp4j_tpu_torch import trace, trace_collectives
from ytk_mp4j_tpu_torch.comm.distributed import DistributedComm, \
    init_distributed
from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators


def _cluster(n=2):
    return GpuCommCluster(n, device="cpu")


def test_disabled_records_nothing():
    trace.clear()
    cluster = _cluster()
    arrs = [np.ones(8, np.float32) for _ in range(2)]
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM)
    assert trace.events() == []


def test_device_path_traced():
    cluster = _cluster()
    arrs = [np.ones(1024, np.float32) for _ in range(2)]
    with trace_collectives():
        cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM)
        cluster.broadcast_array(arrs, Operands.FLOAT, root=0)
    ev = trace.events()
    assert [(e[0], e[2]) for e in ev] == [
        ("GpuCommCluster.allreduce_array", 8192),
        ("GpuCommCluster.broadcast_array", 8192)]
    for name, sec, nb in ev:
        assert sec > 0
    # tracing stops outside the scope
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM)
    assert len(trace.events()) == len(ev)


@pytest.mark.parametrize("algo", ["xla", "ring", "rdma"])
def test_device_path_traced_under_every_algo(algo):
    cluster = _cluster(4)
    arrs = [np.full(1024, r, np.float32) for r in range(4)]
    with trace_collectives():
        cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM,
                                algo=algo)
    assert [(e[0], e[2]) for e in trace.events()] == [
        ("GpuCommCluster.allreduce_array", 4 * 4096)]
    assert all((a == 6.0).all() for a in arrs)


def test_composed_collectives_record_once():
    """allgather_map composes other collectives internally; only the
    outermost call may record (no phantom rows, no double counting)."""
    cluster = _cluster()
    maps = [{"a": 1.0}, {"b": 2.0}]
    with trace_collectives():
        cluster.allgather_map(maps, Operands.DOUBLE)
    names = [e[0] for e in trace.events()]
    assert names == ["GpuCommCluster.allgather_map"]


def test_nonblocking_twin_records_its_blocking_row():
    cluster = _cluster()
    arrs = [np.ones(1024, np.float32) for _ in range(2)]
    with trace_collectives():
        cluster.iallreduce(arrs, Operands.FLOAT, Operators.SUM).wait()
    assert [(e[0], e[2]) for e in trace.events()] == [
        ("GpuCommCluster.allreduce_array", 8192)]


def test_profiler_scope_cannot_nest(tmp_path):
    with trace_collectives():
        pass  # plain scopes nest fine (covered below)
    outer = trace_collectives(profile_dir=str(tmp_path / "p1"))
    inner = trace_collectives(profile_dir=str(tmp_path / "p2"))
    with outer:
        with pytest.raises(RuntimeError):
            inner.__enter__()
    # the failed inner scope must not have corrupted the depth/profiler
    # bookkeeping: a fresh profiler scope works
    with trace_collectives(profile_dir=str(tmp_path / "p3")):
        pass
    assert trace.events() == []
    # the torch.profiler window wrote its trace where it was asked
    assert list((tmp_path / "p1").glob("*.json"))
    assert list((tmp_path / "p3").glob("*.json"))


def test_summary_percentiles():
    """One straggling call must be visible behind a healthy mean."""
    trace.clear()
    with trace_collectives():
        for sec in (0.01,) * 9 + (1.0,):
            trace.record("x.allreduce", sec, 100)
    a = trace.summary()["x.allreduce"]
    assert a["calls"] == 10
    assert a["p50"] == 0.01
    assert a["p95"] == 1.0
    assert a["max"] == 1.0
    header, *rows = trace.format_summary().splitlines()
    assert "p50ms" in header and "p95ms" in header and "maxms" in header
    assert "1000.000" in rows[0]  # the 1 s straggler, in ms
    trace.clear()


def test_payload_bytes_dedup_and_scalars():
    """Views sharing one base buffer count once per distinct base;
    non-numeric scalars count 0, not a phantom 8; a tensor counts its
    elements times their size."""
    base = np.zeros(100, np.float64)
    assert trace._payload_bytes(
        {"a": base[:50], "b": base[50:]}) == base[:50].nbytes
    assert trace._payload_bytes([base, base]) == base.nbytes
    other = np.zeros(10, np.float32)
    assert trace._payload_bytes([base, other]) == base.nbytes + other.nbytes
    assert trace._payload_bytes(base[:10]) == 80
    assert trace._payload_bytes(3) == 8
    assert trace._payload_bytes(np.float32(1.0)) == 4
    assert trace._payload_bytes(None) == 0
    assert trace._payload_bytes(np.str_("abc")) == 0
    assert trace._payload_bytes({"k": None}) == 0
    assert trace._payload_bytes(object()) == 0
    assert trace._payload_bytes(torch.zeros(3, 5, dtype=torch.float64)) \
        == 120
    assert trace._payload_bytes([torch.zeros(4, dtype=torch.int16)]) == 8


def test_nested_scopes():
    trace.clear()
    cluster = _cluster()
    with trace_collectives():
        with trace_collectives(clear=False):
            cluster.barrier()
        cluster.barrier()  # outer scope still active
    assert len([e for e in trace.events()
                if e[0] == "GpuCommCluster.barrier"]) == 2
    cluster.barrier()
    assert len([e for e in trace.events()
                if e[0] == "GpuCommCluster.barrier"]) == 2


def test_distributed_comm_traced_at_world_one(tmp_path):
    assert not dist.is_initialized()
    comm = init_distributed(num_processes=1, process_id=0,
                            init_method=f"file://{tmp_path / 'store'}",
                            device="cpu")
    try:
        assert isinstance(comm, DistributedComm) and dist.is_initialized()
        arr = np.ones(1024, np.float32)
        with trace_collectives():
            comm.allreduce_array(arr, Operands.FLOAT, Operators.SUM)
            comm.allgather_map({"a": 1.0}, Operands.DOUBLE)
        assert [(e[0], e[2]) for e in trace.events()] == [
            ("DistributedComm.allreduce_array", 4096),
            ("DistributedComm.allgather_map", 8)]
        assert (arr == 1.0).all()
        comm.close(0)
    finally:
        dist.destroy_process_group()


def _calls(cluster, Operands, Operators):
    """The same collectives on the same inputs, on either package."""
    n = 2
    arrs = [np.full(1024, r + 1, np.float32) for r in range(n)]
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM)
    cluster.broadcast_array(arrs, Operands.FLOAT, root=0)
    rs = [np.arange(16, dtype=np.float64) * (r + 1) for r in range(n)]
    cluster.reduce_scatter_array(rs, Operands.DOUBLE, Operators.SUM)
    cluster.allgather_array(rs, Operands.DOUBLE)
    maps = [{f"k{r}": float(r), "s": 1.0} for r in range(n)]
    cluster.allreduce_map(maps, Operands.DOUBLE, Operators.SUM)
    cluster.allgather_map([{"a": 1.0}, {"b": 2.0}], Operands.DOUBLE)
    cluster.barrier()


def test_rows_match_the_reference():
    from ytk_mp4j_tpu import operands as ref_operands
    from ytk_mp4j_tpu import operators as ref_operators
    from ytk_mp4j_tpu.comm.tpu_comm import TpuCommCluster
    from ytk_mp4j_tpu.utils import trace as ref_trace

    with ref_trace.trace_collectives():
        _calls(TpuCommCluster(2), ref_operands.Operands,
               ref_operators.Operators)
    ref = [(name.replace("TpuCommCluster.", "GpuCommCluster.", 1), nb)
           for name, _sec, nb in ref_trace.events()]
    with trace_collectives():
        _calls(_cluster(), Operands, Operators)
    port = [(name, nb) for name, _sec, nb in trace.events()]
    assert len(ref) == 7
    assert port == ref
