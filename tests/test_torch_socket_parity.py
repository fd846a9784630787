"""The port's socket plane against the JAX package's, bitwise.

The same seeded rank data go through a job of the reference (its
``Master`` and ``ProcessCommSlave`` threads, as ``tests/helpers.py``
``run_slaves`` does) and through the same job on the port. The schedules
and fold orders are the same code, so every result must be equal bit for
bit: every algo of the dense allreduce for n in {2, 3, 5}, the four
operators and every numeric operand; the rest of the dense and map
families; STRING, OBJECT, compressed and bf16 operands; the raw and
framed data planes, TCP and shared memory; ``ThreadCommSlave`` standalone
and over process slaves. A mixed job (port and reference slaves under
either package's master) shows that the wire format is the reference's.

Also here, because their reference files import ``comm.tpu_comm`` at
module level and cannot run through ``tests/torch_redirect.py``: the
socket-plane cases of ``tests/test_trace.py``,
``tests/test_compress_bf16.py`` and ``tests/test_string_object_operands.py``;
and the check programs and the master's command line in child
interpreters of the port.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_socket_jobs import (NUMERIC, PKGS, canon, rank_array, run_job,
                               run_pkg, run_threads)
from ytk_mp4j_tpu_torch.comm.master import Master
from ytk_mp4j_tpu_torch.comm.thread_comm import ThreadCommSlave
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.utils import native, trace

REPO = Path(__file__).resolve().parents[1]
OPS = ("SUM", "PROD", "MAX", "MIN")


def _both(n, fn, **kw):
    """The job on the reference and on the port; asserts bitwise
    equality and returns the port's results."""
    ref = run_pkg("ref", n, fn, **kw)
    port = run_pkg("port", n, fn, **kw)
    assert canon(port) == canon(ref)
    return port


# ----------------------------------------------------------------------
# the dense family
# ----------------------------------------------------------------------
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("algo", ["rhd", "ring", "tree", "auto"])
def test_allreduce_array_every_operand(algo, n, op):
    def fn(slave, r, pkg):
        out = []
        for name in NUMERIC:
            operand = getattr(pkg.Operands, name)
            a = rank_array(r, 301, operand.dtype, seed=n)
            slave.allreduce_array(a, operand, getattr(pkg.Operators, op),
                                  algo=algo)
            out.append(a)
        b = rank_array(r, 64, np.float64, seed=7)
        slave.allreduce_array(b, pkg.Operands.DOUBLE,
                              getattr(pkg.Operators, op), from_=5, to=50,
                              algo=algo)
        out.append(b[5:50])
        return out

    port = _both(n, fn)
    # every rank holds the same bits
    assert all(canon(p) == canon(port[0]) for p in port)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_dense_family(n):
    def fn(slave, r, pkg):
        O, P = pkg.Operands, pkg.Operators
        out = []
        rs = rank_array(r, 1000, np.float64, seed=1)
        slave.reduce_scatter_array(rs, O.DOUBLE, P.SUM)
        out.append(rs)
        cuts = np.linspace(0, 997, n + 1).astype(int)
        ranges = [(int(cuts[i]), int(cuts[i + 1])) for i in range(n)]
        rs2 = rank_array(r, 997, np.float32, seed=2)
        slave.reduce_scatter_array(rs2, O.FLOAT, P.MAX, ranges=ranges,
                                   algo="ring")
        out.append(rs2)
        ag = rank_array(r, 517, np.float32, seed=3)
        slave.allgather_array(ag, O.FLOAT)
        out.append(ag)
        ag2 = rank_array(r, 517, np.int64, seed=4)
        slave.allgather_array(ag2, O.LONG, algo="ring")
        out.append(ag2)
        bc = rank_array(r, 333, np.int32, seed=5)
        slave.broadcast_array(bc, O.INT, root=n - 1)
        out.append(bc)
        rd = rank_array(r, 250, np.int64, seed=6)
        slave.reduce_array(rd, O.LONG, P.MAX, root=1 % n)
        out.append(rd)
        rd2 = rank_array(r, 250, np.float64, seed=7)
        slave.reduce_array(rd2, O.DOUBLE, P.SUM, root=0, from_=3, to=200)
        out.append(rd2)
        ga = rank_array(r, 101, np.float64, seed=8)
        slave.gather_array(ga, O.DOUBLE, root=0)
        out.append(ga)
        sc = rank_array(r, 101, np.int16, seed=9)
        slave.scatter_array(sc, O.SHORT, root=n - 1)
        out.append(sc)
        return out

    _both(n, fn)


def _int_map(r, seed, m=300):
    rng = np.random.default_rng(seed * 100 + r)
    keys = rng.choice(2000, m, replace=False)
    return {int(k): np.float64(rng.standard_normal()) for k in keys}


def _str_map(r, seed, m=120, dt=np.float32):
    rng = np.random.default_rng(seed * 100 + r)
    keys = rng.choice(400, m, replace=False)
    return {f"k{k}": dt(rng.standard_normal()) for k in keys}


@pytest.mark.parametrize("columnar", [True, False])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_map_family(n, columnar):
    def fn(slave, r, pkg):
        O, P = pkg.Operands, pkg.Operators
        out = []
        d = _int_map(r, 1)
        slave.allreduce_map(d, O.DOUBLE, P.SUM)
        out.append(d)
        d = _str_map(r, 2)
        slave.allreduce_map(d, O.FLOAT, P.MAX)
        out.append(d)
        d = {f"v{k}": rank_array(r * 10 + k, 3, np.float64) for k in
             range(r, r + 20)}
        slave.allreduce_map(d, O.DOUBLE, P.SUM)
        out.append(d)
        d = _int_map(r, 3)
        slave.reduce_scatter_map(d, O.DOUBLE, P.SUM)
        out.append(d)
        d = {r * 1000 + k: np.int32(k) for k in range(50)}
        slave.allgather_map(d, O.INT)
        out.append(d)
        d = _str_map(r, 4, dt=np.float64)
        slave.broadcast_map(d, O.DOUBLE, root=n - 1)
        out.append(d)
        d = _int_map(r, 5)
        slave.reduce_map(d, O.DOUBLE, P.MIN, root=1 % n)
        out.append(d)
        d = {f"g{r}-{k}": np.float64(k) for k in range(30)}
        slave.gather_map(d, O.DOUBLE, root=0)
        out.append(d)
        d = _int_map(r, 6) if r == 0 else {}
        slave.scatter_map(d, O.DOUBLE, root=0)
        out.append(d)
        return out

    _both(n, fn, map_columnar=columnar)


# ----------------------------------------------------------------------
# STRING, OBJECT, compressed and bf16 operands (the socket-plane cases
# of tests/test_string_object_operands.py and tests/test_compress_bf16.py)
# ----------------------------------------------------------------------
def _concat(pkg):
    return pkg.Operator.custom("CONCAT", lambda a, b: a + b, "")


@pytest.mark.parametrize("n", [3, 4])
def test_string_and_object_operands(n):
    def fn(slave, r, pkg):
        O = pkg.Operands
        out = []
        arr = [f"r{r}a", f"r{r}b", f"r{r}c", f"r{r}d"]
        slave.allreduce_array(arr, O.STRING, _concat(pkg))
        out.append(arr)
        arr = [f"s{r}-{i}" for i in range(8)]
        slave.broadcast_array(arr, O.STRING, root=n - 1)
        out.append(arr)
        arr = [f"s{r}-{i}" for i in range(8)]
        slave.allgather_array(arr, O.STRING)
        out.append(arr)
        union = pkg.Operator.custom("UNION", lambda a, b: a | b, frozenset())
        arr = [{f"x{r}"}, {f"y{r}"}]
        slave.reduce_array(arr, O.OBJECT_OPERAND(), union, root=0)
        out.append(arr)
        d = {f"k{r}": f"v{r}", "shared": f"<{r}>"}
        slave.allreduce_map(d, O.STRING, _concat(pkg))
        out.append(d)
        return out

    port = _both(n, fn)
    assert port[0][0] == ["".join(f"r{q}{c}" for q in range(n))
                          for c in "abcd"]
    assert port[0][3] == [{f"x{q}" for q in range(n)},
                          {f"y{q}" for q in range(n)}]


@pytest.mark.parametrize("algo", ["rhd", "ring", "tree"])
def test_compressed_and_bf16_operands(algo):
    n = 3

    def fn(slave, r, pkg):
        O, P = pkg.Operands, pkg.Operators
        operand = O.compressed(O.DOUBLE)
        assert operand.compress and operand.dtype == np.float64
        a = rank_array(r, 5700, np.float64, seed=3)
        slave.allreduce_array(a, operand, P.SUM, algo=algo)
        z = np.zeros(20_000, np.float64) + r     # compressible
        slave.allreduce_array(z, operand, P.SUM, algo=algo)
        d = {f"k{r % 2}": float(r)}
        slave.allreduce_map(d, operand, P.SUM)
        dt = O.BFLOAT16.dtype
        b = np.full(33, float(2 ** r), dt)
        slave.allreduce_array(b, O.BFLOAT16, P.MAX, algo=algo)
        c = rank_array(r, 257, dt, seed=4)
        slave.allreduce_array(c, O.BFLOAT16, P.SUM, algo=algo)
        return [a, z, d, b, c]

    port = _both(n, fn)
    for a, z, d, b, c in port:
        assert d == {"k0": 2.0, "k1": 1.0}
        np.testing.assert_array_equal(b.astype(np.float32), 4.0)
        np.testing.assert_array_equal(z, 3.0)


def test_compressed_operand_on_the_device_cluster_is_ignored():
    """GpuCommCluster ignores ``compress``, as the reference's device
    cluster does: the same result as the plain operand."""
    from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster

    cl = GpuCommCluster(3, device="cpu")
    arrs = [rank_array(r, 40, np.float64) for r in range(3)]
    plain = [a.copy() for a in arrs]
    cl.allreduce_array(arrs, Operands.compressed(Operands.DOUBLE),
                       Operators.SUM)
    cl.allreduce_array(plain, Operands.DOUBLE, Operators.SUM)
    for a, b in zip(arrs, plain):
        assert a.tobytes() == b.tobytes()


# ----------------------------------------------------------------------
# data planes and transports
# ----------------------------------------------------------------------
def _plane_job(slave, r, pkg):
    O, P = pkg.Operands, pkg.Operators
    out = []
    for algo in ("rhd", "ring"):
        a = rank_array(r, 20_000, np.float32, seed=11)
        slave.allreduce_array(a, O.FLOAT, P.SUM, algo=algo)
        out.append(a)
    rs = rank_array(r, 9_999, np.float64, seed=12)
    slave.reduce_scatter_array(rs, O.DOUBLE, P.SUM)
    out.append(rs)
    ag = rank_array(r, 9_999, np.int32, seed=13)
    slave.allgather_array(ag, O.INT)
    out.append(ag)
    d = _int_map(r, 14, m=500)
    slave.allreduce_map(d, O.DOUBLE, P.SUM)
    out.append(d)
    return out


@pytest.mark.parametrize("shm", [True, False])
@pytest.mark.parametrize("native_transport", [True, False])
@pytest.mark.parametrize("n", [3, 4])
def test_data_planes_and_transports(n, native_transport, shm):
    kw = dict(native_transport=native_transport, shm=shm)
    port = _both(n, _plane_job, **kw)
    base = run_pkg("port", n, _plane_job)
    assert canon(port) == canon(base)


def test_numpy_fallback_is_wire_identical(monkeypatch):
    """With the native library disabled, the merge and the raw plane
    take the numpy and Python paths: the same bits as the native job."""
    native._load()
    assert native.HAVE_NATIVE
    want = run_pkg("port", 5, _plane_job)
    monkeypatch.setattr(native, "HAVE_NATIVE", False)
    monkeypatch.setattr(native, "_lib", None)
    got = run_pkg("port", 5, _plane_job)
    assert canon(got) == canon(want)


def test_failed_build_falls_back_but_the_parser_raises(monkeypatch,
                                                       tmp_path):
    """No compiler: HAVE_NATIVE turns False and reduce_into computes with
    numpy, while the libsvm parser raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "HAVE_NATIVE", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native._load() is None and native.HAVE_NATIVE is False
    assert native.reduce_opcode(Operators.SUM, np.float32) is None
    acc = np.arange(5, dtype=np.float32)
    native.reduce_into(Operators.MAX, acc, np.full(5, 2.5, np.float32))
    np.testing.assert_array_equal(acc, [2.5, 2.5, 2.5, 3, 4])
    with pytest.raises(Mp4jError, match="no C\\+\\+ compiler"):
        native.parse_libsvm_chunk(b"1 0:1.0", 1, 1)


def test_merge_reads_the_kernel_code():
    assert [native.reduce_opcode(op, np.float64) for op in
            (Operators.SUM, Operators.PROD, Operators.MAX,
             Operators.MIN)] == [(0, 0), (0, 1), (0, 2), (0, 3)]
    custom = Operator.custom("ABSMAX", np.maximum, 0.0)
    assert native.reduce_opcode(custom, np.float64) is None


# ----------------------------------------------------------------------
# the thread plane
# ----------------------------------------------------------------------
def _thread_job(pkg):
    O, P = pkg.Operands, pkg.Operators

    def fn(s, r):
        return _thread_collectives(s, r, O, P)

    return fn


def _thread_collectives(s, r, O, P):
    out = []
    a = rank_array(r, 777, np.float32, seed=21)
    s.allreduce_array(a, O.FLOAT, P.SUM)
    out.append(a)
    b = rank_array(r, 777, np.float64, seed=22)
    s.allreduce_array(b, O.DOUBLE, P.MAX)
    out.append(b)
    c = rank_array(r, 500, np.float64, seed=23)
    s.reduce_scatter_array(c, O.DOUBLE, P.SUM)
    out.append(c)
    g = rank_array(r, 500, np.int32, seed=24)
    s.allgather_array(g, O.INT)
    out.append(g)
    bc = rank_array(r, 90, np.float64, seed=25)
    s.broadcast_array(bc, O.DOUBLE, root=s.slave_num - 1)
    out.append(bc)
    d = _int_map(r, 26)
    s.allreduce_map(d, O.DOUBLE, P.SUM)
    out.append(d)
    return out


@pytest.mark.parametrize("threads", [2, 3, 4])
def test_thread_comm_standalone(threads):
    ref = run_threads(PKGS["ref"].Thread.spawn_group(threads),
                      _thread_job(PKGS["ref"]))
    port = run_threads(PKGS["port"].Thread.spawn_group(threads),
                       _thread_job(PKGS["port"]))
    assert canon(port) == canon(ref)


def _hybrid(pkg_name, procs=2, threads=2):
    pkg = PKGS[pkg_name]
    master = pkg.Master(procs, timeout=60.0).serve_in_thread()
    results = {}
    errors = []

    def process():
        try:
            group = pkg.Thread.spawn_group(threads, "127.0.0.1",
                                           master.port)
            for s, res in zip(group, run_threads(group, _thread_job(pkg))):
                results[s.rank] = res
            for s in group:
                s.close(0)
        except Exception as e:
            errors.append(e)

    ts = [threading.Thread(target=process, daemon=True)
          for _ in range(procs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
        assert not t.is_alive(), "hybrid process hung"
    if errors:
        raise errors[0]
    master.join(60)
    assert master.final_code == 0
    return [results[r] for r in sorted(results)]


def test_thread_comm_hybrid_over_process_slaves():
    ref = _hybrid("ref")
    port = _hybrid("port")
    assert len(port) == 4
    assert canon(port) == canon(ref)


# ----------------------------------------------------------------------
# one job with slaves of both packages, under either master
# ----------------------------------------------------------------------
def _mixed_job(slave, r, pkg):
    O, P = pkg.Operands, pkg.Operators
    out = []
    for algo in ("rhd", "ring", "tree"):
        a = rank_array(r, 3001, np.float32, seed=31)
        slave.allreduce_array(a, O.FLOAT, P.SUM, algo=algo)
        out.append(a)
    b = rank_array(r, 257, np.int64, seed=32)
    slave.allreduce_array(b, O.LONG, P.MAX)
    out.append(b)
    c = rank_array(r, 4000, np.float64, seed=33)
    slave.allreduce_array(c, O.compressed(O.DOUBLE), P.SUM)
    out.append(c)
    d = _int_map(r, 34)
    slave.allreduce_map(d, O.DOUBLE, P.SUM)
    out.append(d)
    e = _str_map(r, 35)
    slave.reduce_scatter_map(e, O.FLOAT, P.SUM)
    out.append(e)
    s = [f"r{r}-{i}" for i in range(6)]
    slave.allreduce_array(s, O.STRING, _concat(pkg))
    out.append(s)
    g = rank_array(r, 100, np.float64, seed=36)
    slave.gather_array(g, O.DOUBLE, root=2)
    out.append(g)
    slave.barrier()
    return out


@pytest.mark.parametrize("shm", [True, False])
def test_mixed_packages_under_either_master(shm):
    pkgs = ["port", "port", "ref"]
    under_ref = run_job("ref", pkgs, _mixed_job, shm=shm)
    under_port = run_job("port", pkgs, _mixed_job, shm=shm)
    all_ref = run_pkg("ref", 3, _mixed_job, shm=shm)
    assert canon(under_ref) == canon(under_port) == canon(all_ref)


# ----------------------------------------------------------------------
# tracing (the socket-plane cases of tests/test_trace.py)
# ----------------------------------------------------------------------
def test_socket_path_traced_and_summary():
    with trace.trace_collectives():
        def fn(slave, r, pkg):
            arr = np.full(256, float(r))
            slave.allreduce_array(arr, pkg.Operands.DOUBLE)
            slave.allreduce_array(arr, pkg.Operands.DOUBLE)
            return arr

        run_pkg("port", 2, fn)
    a = trace.summary()["ProcessCommSlave.allreduce_array"]
    assert a["calls"] == 4 and a["bytes"] == 4 * 256 * 8
    assert a["gb_per_s"] > 0
    assert "ProcessCommSlave.allreduce_array" in trace.format_summary()


def test_thread_path_traced():
    slaves = ThreadCommSlave.spawn_group(2)
    with trace.trace_collectives():
        run_threads(slaves, lambda s, r: s.allreduce_map(
            {"a": 1.0}, Operands.DOUBLE, Operators.SUM))
    names = [e[0] for e in trace.events()]
    assert names.count("ThreadCommSlave.allreduce_map") == 2


def test_payload_bytes_counts_tensors():
    t = torch.zeros(10, 3, dtype=torch.float64)
    assert trace._payload_bytes(t) == 240
    assert trace._payload_bytes([t, torch.zeros(4, dtype=torch.bfloat16)]) \
        == 248
    assert trace._payload_bytes({"a": np.zeros(5, np.float32), "t": t}) \
        == 260


def test_profile_window_is_torch_profiler(tmp_path):
    """``profile_dir`` opens a torch.profiler window whose trace lands
    in the directory; a second profiler scope cannot nest."""
    with trace.trace_collectives(profile_dir=str(tmp_path / "p")):
        torch.ones(8).sum()
        with pytest.raises(RuntimeError, match="cannot nest"):
            trace.trace_collectives(profile_dir=str(tmp_path / "q")
                                    ).__enter__()
    assert list((tmp_path / "p").glob("*.json*"))
    with trace.trace_collectives(profile_dir=str(tmp_path / "r")):
        pass
    assert trace.trace_collectives._profiler_owner is None


# ----------------------------------------------------------------------
# child interpreters of the port: the master's command line and the check
# programs (the reference's subprocess cases run the reference)
# ----------------------------------------------------------------------
def _env():
    return dict(os.environ, PYTHONPATH=str(REPO))


def test_master_cli_and_checkprocess_in_processes():
    master = subprocess.Popen(
        [sys.executable, "-m", "ytk_mp4j_tpu_torch.comm.master", "--port",
         "0", "--slaves", "3", "--timeout", "120"], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = master.stderr.readline()
        assert "listening on port" in line, line
        port = int(line.split("port")[1].split()[0])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ytk_mp4j_tpu_torch.check.checkprocess",
             "--master", f"127.0.0.1:{port}", "--length", "65"], cwd=REPO,
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for _ in range(3)]
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"checkprocess failed:\n{out}\n{err}"
        assert master.wait(timeout=60) == 0
    finally:
        master.kill()
        master.communicate()


def test_checkthread_hybrid_in_processes():
    master = Master(2, timeout=120.0).serve_in_thread()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ytk_mp4j_tpu_torch.check.checkthread",
         "--master", f"127.0.0.1:{master.port}", "--threads", "2",
         "--length", "53"], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"checkthread failed:\n{out}\n{err}"
    master.join(10)
    assert master.final_code == 0
