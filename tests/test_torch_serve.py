"""The serve plane and the device check suites of the port, held against
the JAX package on the CPU.

- Each family's servable (linear, FM, FFM, GBDT under logistic, squared
  and softmax) built by both packages from the same parameters: rows,
  ``predict_sharded`` / ``partial_margins`` + ``link`` bitwise equal. GBDT
  trees cross between the packages through their model files, both ways.
- The serve grid of ``tests/test_serve.py`` (4 families x {tcp, shm} x
  n in {2, 4}) over the port's ``ProcessCommSlave``: bitwise the
  reference servable's sequential oracle, GBDT included.
- The chaos leg of ``bench.py``'s ``bench_serve_chaos``, small: 3 forked
  ranks serving GBDT over the reduce plane, rank 1 killed mid-stream, a
  warm spare adopted under ``elastic="replace"``.
- ``check.checkgpu`` on the CPU against the reference's ``checktpu``
  battery at n = 8 (same check names, same pass count) and its refusal
  without a device; ``check.checkaot`` without ``nvcc`` and with stand-in
  compilers.

Tolerances: every serve comparison is bitwise (``assert_array_equal``)
but the chaos leg's, which holds the answers before the kill to the
single-rank oracle at rtol 1e-12 (each rank sums its own trees, the
reduce adds the ranks' partials); the servables' margins against the
port trainers' ``predict`` (f32 sums against the servables' f64) to rtol
1e-5 / atol 1e-6.
"""

import json
import multiprocessing as mp
import os
import queue
import textwrap
import time
from collections import Counter

import numpy as np
import pytest
import torch

from torch_socket_jobs import run_pkg
from ytk_mp4j_tpu.models import fm as r_fm
from ytk_mp4j_tpu.models import gbdt as r_gbdt
from ytk_mp4j_tpu.models import linear as r_linear
from ytk_mp4j_tpu_torch.check import checkaot, checkgpu
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models import fm as p_fm
from ytk_mp4j_tpu_torch.models import gbdt as p_gbdt
from ytk_mp4j_tpu_torch.models import linear as p_linear
from ytk_mp4j_tpu_torch.ops import _build
from ytk_mp4j_tpu_torch.serve import ServeFrontend, serve_worker

CPU = torch.device("cpu")


def _pull_requests(n_rows, nnz, n_fields, n_reqs=12, seed=11):
    """Requests of the pull families: repeated hot ids, tail ids and
    zero-valued (padded) slots, as ``tests/test_serve.py`` draws them."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_reqs):
        ids = rng.choice(n_rows, size=nnz, replace=False)
        fields = (np.arange(nnz) % n_fields).astype(np.int32)
        vals = rng.standard_normal(nnz).astype(np.float32)
        vals[rng.random(nnz) < 0.2] = 0.0
        reqs.append((ids.astype(np.int64), fields, vals))
    return reqs


def _rowmap(servable):
    ids = np.arange(servable.n_rows, dtype=np.int64)
    mat = servable.rows(ids)
    return {int(i): mat[j] for j, i in enumerate(ids)}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# each family's servable against the reference's
# ----------------------------------------------------------------------
def _linear_params(loss, seed=1):
    rng = np.random.default_rng(seed)
    D, C = 24, 3
    if loss == "softmax":
        w = rng.standard_normal((D, C)).astype(np.float32)
        b = rng.standard_normal(C).astype(np.float32)
    else:
        w = rng.standard_normal(D).astype(np.float32)
        b = np.float32(0.3)
    return w, b


@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_linear_servable_matches_reference(loss):
    w, b = _linear_params(loss)
    r_cfg = r_linear.LinearConfig(n_features=24, loss=loss, n_classes=3)
    p_cfg = p_linear.LinearConfig(n_features=24, loss=loss, n_classes=3)
    ref = r_linear.servable((w, b), r_cfg)
    port = p_linear.servable((w, b), p_cfg)
    # tensors (the trainer's form) give the same servable as numpy
    from_tensors = p_linear.servable(
        (torch.from_numpy(w), torch.as_tensor(b)), p_cfg)
    reqs = _pull_requests(24, 6, 1)
    ids = np.arange(24)
    np.testing.assert_array_equal(port.rows(ids), ref.rows(ids))
    for req in reqs:
        np.testing.assert_array_equal(port.row_ids(req), ref.row_ids(req))
    rowmap = _rowmap(ref)
    want = ref.predict_sharded(reqs, rowmap)
    _same(port.predict_sharded(reqs, rowmap), want)
    _same(from_tensors.predict_sharded(reqs, rowmap), want)
    # a row nobody owns scores as zeros in both packages
    del rowmap[int(reqs[0][0][0])]
    _same(port.predict_sharded(reqs, rowmap),
          ref.predict_sharded(reqs, rowmap))
    assert (port.kind, port.family, port.resp_width, port.row_width) == \
        (ref.kind, ref.family, ref.resp_width, ref.row_width)


def _fm_params(model, loss, seed=2):
    rng = np.random.default_rng(seed)
    nf = 3 if model == "ffm" else 1
    w0 = np.float32(-0.2)
    w = rng.standard_normal(24).astype(np.float32)
    V = (0.1 * rng.standard_normal((24 * nf, 4))).astype(np.float32)
    kw = dict(n_features=24, n_fields=nf, k=4, max_nnz=6, model=model,
              loss=loss)
    return (w0, w, V), kw


@pytest.mark.parametrize("model", ["fm", "ffm"])
@pytest.mark.parametrize("loss", ["logistic", "squared"])
def test_fm_servable_matches_reference(model, loss):
    params, kw = _fm_params(model, loss)
    ref = r_fm.servable(params, r_fm.FMConfig(**kw))
    port = p_fm.servable(params, p_fm.FMConfig(**kw))
    from_tensors = p_fm.servable(
        tuple(torch.as_tensor(a) for a in params), p_fm.FMConfig(**kw))
    reqs = _pull_requests(24, 6, kw["n_fields"])
    ids = np.arange(24)
    np.testing.assert_array_equal(port.rows(ids), ref.rows(ids))
    rowmap = _rowmap(ref)
    want = ref.predict_sharded(reqs, rowmap)
    _same(port.predict_sharded(reqs, rowmap), want)
    _same(from_tensors.predict_sharded(reqs, rowmap), want)
    del rowmap[int(reqs[1][0][0])]
    _same(port.predict_sharded(reqs, rowmap),
          ref.predict_sharded(reqs, rowmap))
    assert (port.kind, port.family, port.row_width) == \
        (ref.kind, ref.family, ref.row_width)


def test_fm_servable_cuts_a_padded_sharded_table():
    """A sharded trainer's table on one process carries padding rows up
    to a multiple of the member count; the servable cuts them (the
    reference's ``V[:n_features * nf]``) and equals one built from
    ``full_table``. A process's blocks alone are refused."""
    cfg = p_fm.FMConfig(n_features=25, n_fields=3, k=4, max_nnz=6,
                        model="ffm")
    tr = p_fm.FMTrainer(cfg, mesh=make_mesh(4, CPU), sparse_grads=True,
                        table_sharding="sharded")
    params = tr.init_params(seed=3)
    assert params[2].shape[0] == tr.n_rows_padded > 75
    a = p_fm.servable(params, cfg)
    b = p_fm.servable((params[0], params[1], tr.full_table(params)), cfg)
    reqs = _pull_requests(25, 6, 3)
    _same(a.predict_sharded(reqs, _rowmap(a)),
          b.predict_sharded(reqs, _rowmap(b)))
    with pytest.raises(Mp4jError, match="full_table"):
        p_fm.servable((params[0], params[1], params[2][:40]), cfg)


# -- GBDT: trees across the two packages' model files ----------------------
_GBDT_CFGS = {
    "logistic": dict(loss="logistic"),
    "squared": dict(loss="squared"),
    "softmax": dict(loss="softmax", n_classes=3),
    "missing_cat": dict(loss="logistic", missing_bin=True,
                        categorical_features=(2,)),
}


def _gbdt_data(kind, n=256, seed=3):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 8, (n, 5)).astype(np.int32)
    if kind == "softmax":
        y = (bins[:, 0] % 3).astype(np.float32)
    elif kind == "squared":
        y = (bins[:, 0] / 8 + 0.1 * bins[:, 3]).astype(np.float32)
    else:
        y = (bins[:, 0] > 3).astype(np.float32)
    return bins, y


def _gbdt_kw(kind):
    return dict(n_features=5, n_bins=8, depth=3, n_trees=4,
                hist_mode="flat", **_GBDT_CFGS[kind])


def _gbdt_requests(n_reqs=24, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 8, 5).astype(np.int64) for _ in range(n_reqs)]


def _ref_gbdt(kind):
    from ytk_mp4j_tpu.parallel import make_mesh as r_make_mesh

    cfg = r_gbdt.GBDTConfig(**_gbdt_kw(kind))
    bins, y = _gbdt_data(kind)
    tr = r_gbdt.GBDTTrainer(cfg, mesh=r_make_mesh(1))
    trees, _ = tr.train(bins, y)
    return tr, trees


def _held_bitwise(port, ref, reqs):
    bins = np.stack(reqs)
    for rank, size in ((0, 1), (0, 2), (1, 2), (2, 3)):
        got = port.partial_margins(bins, rank, size)
        want = ref.partial_margins(bins, rank, size)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    m = ref.partial_margins(bins, 0, 1)
    _same(port.link(m), ref.link(m))
    assert (port.kind, port.family, port.req_width, port.resp_width) == \
        (ref.kind, ref.family, ref.req_width, ref.resp_width)


@pytest.mark.parametrize("kind", sorted(_GBDT_CFGS))
def test_gbdt_servable_reference_trees_through_model_file(kind, tmp_path):
    """The reference trains and saves; the port loads the file (trees as
    tensors on the CPU) and serves them bitwise as the reference serves
    its own trees."""
    tr, trees = _ref_gbdt(kind)
    path = str(tmp_path / "m.npz")
    tr.save_model(path, trees)
    cfg, p_trees, _ = p_gbdt.GBDTTrainer.load_model(path, device="cpu")
    assert isinstance(p_trees[0][0] if kind != "softmax"
                      else p_trees[0][0][0], torch.Tensor)
    _held_bitwise(p_gbdt.servable(p_trees, cfg),
                  r_gbdt.servable(trees, tr.cfg), _gbdt_requests())


@pytest.mark.parametrize("kind", sorted(_GBDT_CFGS))
def test_gbdt_servable_port_trees_through_model_file(kind, tmp_path):
    """The port trains on the CPU and saves; the reference loads the file
    and serves it bitwise as the port serves its own tensor trees. The
    servable's margins match the trainer's ``predict`` (f32 against the
    servable's f64 accumulation) to rtol 1e-5 / atol 1e-6."""
    cfg = p_gbdt.GBDTConfig(**_gbdt_kw(kind))
    bins, y = _gbdt_data(kind)
    tr = p_gbdt.GBDTTrainer(cfg, device="cpu")
    trees, _ = tr.train(bins, y)
    path = str(tmp_path / "m.npz")
    tr.save_model(path, trees)
    r_cfg, r_trees, _ = r_gbdt.GBDTTrainer.load_model(path)
    port = p_gbdt.servable(trees, cfg)
    reqs = _gbdt_requests()
    _held_bitwise(port, r_gbdt.servable(r_trees, r_cfg), reqs)
    req_bins = np.stack(reqs)
    want = tr.predict(req_bins.astype(np.int32), trees).numpy()
    got = port.partial_margins(req_bins, 0, 1)
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------------------------
# the serve grid over the port's socket plane
# ----------------------------------------------------------------------
def _grid_pair(family):
    """(port servable, reference servable) on the same parameters."""
    if family == "linear":
        w, b = _linear_params("logistic", seed=7)
        kw = dict(n_features=24, loss="logistic")
        return (p_linear.servable((w, b), p_linear.LinearConfig(**kw)),
                r_linear.servable((w, b), r_linear.LinearConfig(**kw)))
    if family in ("fm", "ffm"):
        params, kw = _fm_params(family, "logistic", seed=8)
        return (p_fm.servable(params, p_fm.FMConfig(**kw)),
                r_fm.servable(params, r_fm.FMConfig(**kw)))
    cfg = p_gbdt.GBDTConfig(**_gbdt_kw("logistic"))
    bins, y = _gbdt_data("logistic")
    trees, _ = p_gbdt.GBDTTrainer(cfg, device="cpu").train(bins, y)
    r_trees = [tuple(t.numpy() for t in tree) for tree in trees]
    return (p_gbdt.servable(trees, cfg),
            r_gbdt.servable(r_trees, r_gbdt.GBDTConfig(**_gbdt_kw(
                "logistic"))))


def _grid_requests(servable):
    if servable.kind == "reduce":
        return _gbdt_requests(10)
    nf = getattr(servable.cfg, "n_fields", 1)
    return _pull_requests(servable.n_rows, 6, nf, n_reqs=10)


def _sequential_oracle(ref, reqs):
    """The reference servable scoring one process's requests in order --
    the sequential oracle of ``tests/test_serve.py``."""
    if ref.kind == "pull":
        return ref.predict_sharded(reqs, _rowmap(ref))
    return ref.link(ref.partial_margins(np.stack(reqs), 0, 1))


@pytest.mark.parametrize("family", ["ffm", "fm", "gbdt", "linear"])
@pytest.mark.parametrize("shm", [False, True], ids=["tcp", "shm"])
@pytest.mark.parametrize("n", [2, 4])
def test_port_serve_grid_bitwise_the_reference_oracle(family, shm, n):
    port, ref = _grid_pair(family)
    reqs = _grid_requests(port)
    want = _sequential_oracle(ref, reqs)

    def fn(slave, rank, _pkg):
        if rank != 0:
            return serve_worker(slave, port, max_batch=8)
        fe = ServeFrontend(slave, port, deadline_ms=50.0, max_batch=8)
        try:
            futs = [fe.submit(r) for r in reqs]
            return [f.wait(30.0) for f in futs]
        finally:
            fe.close()

    results = run_pkg("port", n, fn, shm=shm)
    _same(results[0], want)
    for r in range(1, n):
        assert results[r]["rounds"] >= 1


# ----------------------------------------------------------------------
# chaos: a serving rank killed mid-stream, a warm spare adopted
# ----------------------------------------------------------------------
CHAOS_PROCS = 3
CHAOS_REQS = 24
CHAOS_JOIN_S = 120.0


def _chaos_servable():
    """``bench.py``'s ``_serve_gbdt_servable``, smaller: random
    level-ordered trees in the trainer's layout (numpy only, so the
    forked ranks touch no torch state)."""
    rng = np.random.default_rng(5)
    cfg = p_gbdt.GBDTConfig(n_features=16, n_bins=16, depth=4, n_trees=8,
                            loss="logistic", hist_mode="flat")
    trees = [(rng.integers(0, 16, 15).astype(np.int32),
              rng.integers(1, 15, 15).astype(np.int32),
              np.zeros(15, np.int32),
              (0.1 * rng.standard_normal(16)).astype(np.float32))
             for _ in range(8)]
    return p_gbdt.servable(trees, cfg)


def test_chaos_kill_mid_stream_with_a_warm_spare():
    """Every request is delivered, at least one batch is delivered
    degraded, and the adopted spare answers at least one round. The
    answers before the kill are the single-rank oracle's to rtol 1e-12
    (the f64 sum regrouped by rank)."""
    from ytk_mp4j_tpu_torch.comm.master import Master
    from ytk_mp4j_tpu_torch.comm.process_comm import ProcessCommSlave
    from ytk_mp4j_tpu_torch.resilience.faults import FaultKill

    servable = _chaos_servable()
    rng = np.random.default_rng(3)
    requests = [rng.integers(0, 16, 16).astype(np.int64)
                for _ in range(CHAOS_REQS)]
    want = servable.link(servable.partial_margins(np.stack(requests), 0, 1))
    ctx = mp.get_context("fork")
    master = Master(CHAOS_PROCS, timeout=60.0, elastic="replace", spares=1,
                    adopt_secs=15.0, health=False,
                    autoscale="off").serve_in_thread()
    q = ctx.Queue()
    kw = dict(timeout=60.0, elastic="replace", dead_rank_secs=60.0,
              health=False, shm=False, audit="off", sink_dir="")

    def worker():
        try:
            slave = ProcessCommSlave(
                "127.0.0.1", master.port,
                fault_plan=f"kill:rank=1:nth={CHAOS_REQS}", **kw)
            rank = slave.rank
            try:
                if rank == 0:
                    fe = ServeFrontend(slave, servable, deadline_ms=5.0,
                                       max_batch=1)
                    got = [fe.predict(r, timeout=60.0) for r in requests]
                    res = {"got": got, "degraded": fe.degraded_batches}
                    fe.close()
                else:
                    res = serve_worker(slave, servable, max_batch=1)
            except FaultKill:
                q.put(("killed", rank, None))
                return
            q.put(("ok", slave.rank, res))
            slave.close(0)
        except Exception as e:  # surfaced through the queue
            q.put(("err", -1, repr(e)))

    def spare():
        try:
            sp = ProcessCommSlave("127.0.0.1", master.port, spare=True,
                                  **kw)
            res = serve_worker(sp, servable, max_batch=1)
            q.put(("ok", sp.rank, res))
            sp.close(0)
        except Exception as e:
            q.put(("err", -1, repr(e)))

    ps = [ctx.Process(target=worker, daemon=True)
          for _ in range(CHAOS_PROCS)]
    ps.append(ctx.Process(target=spare, daemon=True))
    for p in ps:
        p.start()
    results, killed = {}, []
    deadline = time.monotonic() + CHAOS_JOIN_S
    try:
        while len(results) + len(killed) < len(ps):
            assert time.monotonic() < deadline, (results, killed)
            try:
                kind, rank, payload = q.get(timeout=1.0)
            except queue.Empty:
                continue
            assert kind != "err", payload
            if kind == "killed":
                killed.append(rank)
            else:
                results[rank] = payload
    finally:
        for p in ps:
            p.join(10.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
    master.join(10.0)
    assert killed == [1]
    assert sorted(results) == list(range(CHAOS_PROCS))
    fe = results[0]
    assert len(fe["got"]) == CHAOS_REQS
    assert all(np.isfinite(g).all() and g.shape == (1,) for g in fe["got"])
    assert fe["degraded"] >= 1
    assert results[1]["rounds"] >= 1            # the spare, as rank 1
    # before the kill every rank contributed: the single-rank oracle's
    # f64 sum regrouped by rank
    clean = CHAOS_REQS // 2 - 2
    np.testing.assert_allclose(np.concatenate(fe["got"][:clean]),
                               np.concatenate(want[:clean]), rtol=1e-12,
                               atol=1e-12)


# ----------------------------------------------------------------------
# the device check suites
# ----------------------------------------------------------------------
def _reference_battery(n):
    """The reference's ``checktpu._run_battery(n)`` on the rig's CPU
    devices, recording every check name it runs."""
    import jax

    from ytk_mp4j_tpu.check import checktpu

    names = []
    orig = checktpu.Tally.expect

    def expect(self, name, got, want, exact):
        names.append(name)
        return orig(self, name, got, want, exact)

    checktpu.Tally.expect = expect
    try:
        sec = checktpu._run_battery(n, devices=jax.devices("cpu")[:n])
    finally:
        checktpu.Tally.expect = orig
    return sec, Counter(names)


def test_checkgpu_cpu_matches_the_reference_battery(tmp_path):
    out = tmp_path / "checkgpu.json"
    rc = checkgpu.main(["--device", "cpu", "--n", "8", "--cpu-mesh-n", "0",
                        "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert got["ok"] and got["failures"] == [] and got["error"] is None
    assert got["platform"] == "cpu" and got["n_members"] == 8
    assert "ring_kernel_hw" not in got and "cpu_mesh" not in got
    ref, names = _reference_battery(8)
    assert ref["ok"], ref
    assert got["passed"] == ref["passed"]
    assert Counter(got["checks"]) == names


def test_checkgpu_runs_the_cpu_section_beside_a_narrower_one(tmp_path):
    out = tmp_path / "c.json"
    assert checkgpu.main(["--device", "cpu", "--n", "2", "--out",
                          str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["n_members"] == 2 and got["cpu_mesh"]["ok"]
    assert got["cpu_mesh"]["n_members"] == 8


def test_checkgpu_without_a_device_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert checkgpu.main([]) != 0
    err = capsys.readouterr()
    assert "pass device='cpu'" in err.err
    assert '"ok"' not in err.out


def test_checkgpu_counts_a_planted_failure(monkeypatch):
    """A collective that returns a wrong answer fails the check it
    reaches and the exit code."""
    from ytk_mp4j_tpu_torch.ops import collectives as coll

    real = coll.broadcast
    monkeypatch.setattr(coll, "broadcast", lambda x, root=0: real(x, 1))
    assert checkgpu.main(["--device", "cpu", "--n", "4",
                          "--cpu-mesh-n", "0"]) == 1


def test_checkaot_without_nvcc(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    out = tmp_path / "aot.json"
    assert checkaot.main(["--out", str(out)]) == 2
    got = json.loads(out.read_text())
    assert got["nvcc"] is None and "nvcc not found" in got["reason"]
    assert got["ok"] is False and got["programs"] == {}


def _stand_in_nvcc(tmp_path, body):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n" + textwrap.dedent(body))
    nvcc.chmod(0o755)
    return nvcc


def _first_on_path(monkeypatch, nvcc):
    monkeypatch.setenv("PATH", os.pathsep.join(
        [str(nvcc.parent), os.environ.get("PATH", "")]))


def test_checkaot_compiles_every_source_with_the_build_flags(monkeypatch,
                                                             tmp_path):
    """A stand-in compiler that records its arguments and prints ptxas'
    report: every source of ``_build.sources()`` is compiled with the
    build's flags plus ``-Xptxas -v``, and the report is parsed."""
    log = tmp_path / "args"
    nvcc = _stand_in_nvcc(tmp_path, f"""
        if [ "$1" = "--version" ]; then echo "release 12.9"; exit 0; fi
        echo "$@" >> {log}
        cat <<'X'
        ptxas info    : Compiling entry function '_Z11ring_kernelILi1EEvPv' for 'sm_90a'
        ptxas info    : Function properties for _Z11ring_kernelILi1EEvPv
            16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
        ptxas info    : Used 72 registers, used 1 barriers, 2048 bytes smem, 400 bytes cmem[0]
        X
    """)
    _first_on_path(monkeypatch, nvcc)
    out = tmp_path / "aot.json"
    assert checkaot.main(["--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["ok"] and sorted(got["programs"]) == _build.sources()
    for rec in got["programs"].values():
        assert rec["ok"]
        (k,) = rec["kernels"].values()
        assert k == {"kernel": "ring_kernel", "arch": "sm_90a",
                     "registers": 72, "smem_bytes": 2048,
                     "stack_bytes": 16, "spill_stores": 8,
                     "spill_loads": 4}
    lines = log.read_text().splitlines()
    assert len(lines) == len(_build.sources())
    for line in lines:
        assert "-Xptxas -v" in line
        assert " ".join(_build.NVCC_FLAGS) in line


@pytest.mark.parametrize("mangled,name", [
    ("_Z11hist_kernelPKiPKfS2_", "hist_kernel"),
    ("_ZN47_GLOBAL__N__2ea51737_14_hist_kernel_cu_8a0bd83c15finalize_kernel"
     "EPKyxPKjPf", "finalize_kernel"),
    ("_ZN48_GLOBAL__N__721ddb7e_15_ring_cluster_cu_3db846f412ring_cluster"
     "I13__nv_bfloat16Li3ELi2EEEvNS_6ParamsE", "ring_cluster"),
    ("plain_c_name", "plain_c_name"),
])
def test_checkaot_names_a_kernel_by_its_own_identifier(mangled, name):
    """ptxas reports entries by mangled name; the kernel sources keep
    theirs in an anonymous namespace (the names as nvcc 12.9 mangled
    them for sm_90a)."""
    assert checkaot.kernel_name(mangled) == name


def test_checkaot_reports_a_failed_compile(monkeypatch, tmp_path):
    nvcc = _stand_in_nvcc(tmp_path, """
        if [ "$1" = "--version" ]; then echo "release 12.9"; exit 0; fi
        echo "error: bad kernel"; exit 1
    """)
    _first_on_path(monkeypatch, nvcc)
    out = tmp_path / "aot.json"
    assert checkaot.main(["--out", str(out)]) == 1
    got = json.loads(out.read_text())
    assert not got["ok"]
    assert all(not p["ok"] and "bad kernel" in p["error"]
               for p in got["programs"].values())
