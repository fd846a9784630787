"""Package-level checks of the PyTorch port (ytk_mp4j_tpu_torch): it
imports neither jax nor the JAX package, resolves its device without a
silent move to the CPU, builds its kernels only where nvcc exists, and
chip_smoke.py refuses to run without a card."""

import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import ytk_mp4j_tpu_torch
from ytk_mp4j_tpu_torch.device import make_device
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "ytk_mp4j_tpu_torch"

_BLOCKER = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "ytk_mp4j_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
""")


def _run(code, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO, **kw)


def test_imports_and_trains_with_jax_blocked():
    code = _BLOCKER + textwrap.dedent("""
        import numpy as np
        import ytk_mp4j_tpu_torch as p
        rng = np.random.default_rng(0)
        bins = rng.integers(0, 8, (256, 3)).astype(np.int32)
        y = (bins[:, 0] / 8).astype(np.float32)
        cfg = p.GBDTConfig(n_features=3, n_bins=8, depth=2, n_trees=1)
        trees, m = p.GBDTTrainer(cfg, device="cpu").train(bins, y)
        assert len(trees) == 1 and m.shape == (256,)
        cl = p.GpuCommCluster(3, device="cpu")
        for algo in ("xla", "ring", "rdma"):
            arrs = [np.full(5, r, np.float64) for r in range(3)]
            cl.allreduce_array(arrs, p.Operands.DOUBLE, algo=algo)
            assert all((a == 3.0).all() for a in arrs), algo
        from ytk_mp4j_tpu_torch import entry
        from ytk_mp4j_tpu_torch.models import binning
        X = rng.standard_normal((256, 3)).astype(np.float32)
        assert binning.QuantileBinner(8).fit(X).transform(
            X, device="cpu").shape == (256, 3)
        entry.dryrun(4, device="cpu")
        import threading
        from ytk_mp4j_tpu_torch import obs, resilience, transport
        from ytk_mp4j_tpu_torch.comm.master import Master
        from ytk_mp4j_tpu_torch.comm.process_comm import ProcessCommSlave
        from ytk_mp4j_tpu_torch.comm.thread_comm import ThreadCommSlave
        from ytk_mp4j_tpu_torch.obs import cli
        assert transport.TcpChannel and resilience.FaultPlan and cli.main
        m = Master(2, timeout=60).serve_in_thread()
        out = {}
        def slave():
            s = ProcessCommSlave("127.0.0.1", m.port, timeout=60)
            a = np.full(7, s.rank + 1.0)
            s.allreduce_array(a, p.Operands.DOUBLE, p.Operators.SUM)
            out[s.rank] = a
            s.close(0)
        ts = [threading.Thread(target=slave) for _ in range(2)]
        [t.start() for t in ts]
        [t.join(60) for t in ts]
        m.join(60)
        assert m.final_code == 0 and all((out[r] == 3.0).all()
                                         for r in (0, 1)), out
        group = ThreadCommSlave.spawn_group(1)
        group[0].allreduce_map({"k": 1.0}, p.Operands.DOUBLE)
        from ytk_mp4j_tpu_torch.models import linear
        from ytk_mp4j_tpu_torch.serve import ServeFrontend, framing
        lin = linear.servable((np.ones(4, np.float32), np.float32(0)),
                              p.LinearConfig(n_features=4))
        req = framing.decode_request(framing.encode_request(
            "linear", 1, [1, 2], None, [1.0, 2.0]))[2:]
        m = Master(1, timeout=60).serve_in_thread()
        s = ProcessCommSlave("127.0.0.1", m.port, timeout=60)
        fe = ServeFrontend(s, lin, deadline_ms=1.0)
        assert fe.predict((req[0], req[1], req[2]), timeout=60)[0] == 3.0
        fe.close()
        s.close(0)
        m.join(60)
        import importlib, pkgutil
        for mod in pkgutil.walk_packages(p.__path__, "ytk_mp4j_tpu_torch."):
            if not mod.name.endswith(".__main__"):   # runs a command line
                importlib.import_module(mod.name)
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "ytk_mp4j_tpu")]
        assert not bad, bad
        print("ok")
    """)
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_no_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ytk_mp4j_tpu)\b"
                     r"(?!_torch)", re.M)
    examples = sorted((REPO / "examples" / "torch").glob("*.py"))
    assert len(examples) == 11
    files = (sorted(PKG.rglob("*.py"))
             + [REPO / "chip_smoke.py", REPO / "ring_turns.py"] + examples)
    assert len(files) >= 15
    for name in ("operators.py", "operands.py", "meta.py",
                 "comm/gpu_comm.py", "ops/ring.py", "ops/collectives.py",
                 "ops/ring_kernel.py", "models/binning.py", "entry.py",
                 "ops/sparse.py", "comm/keycodec.py", "models/fm.py",
                 "models/linear.py", "utils/libsvm.py", "utils/native.py",
                 "comm/distributed.py", "comm/context.py",
                 "comm/progress.py", "check/checkdist.py",
                 "check/_oracle.py", "utils/tuning.py",
                 "comm/process_comm.py", "comm/master.py",
                 "comm/thread_comm.py", "transport/__init__.py",
                 "transport/channel.py", "transport/tcp.py",
                 "transport/shm.py", "obs/__init__.py", "obs/cli.py",
                 "obs/spans.py", "obs/metrics.py", "obs/critpath.py",
                 "obs/health.py", "obs/telemetry.py", "obs/postmortem.py",
                 "obs/sink.py", "obs/audit.py", "obs/fleet.py",
                 "obs/benchdiff.py", "resilience/__init__.py",
                 "resilience/faults.py", "resilience/membership.py",
                 "resilience/recovery.py", "resilience/autoscaler.py",
                 "utils/stats.py", "utils/trace.py", "utils/tuner.py",
                 "check/checkthread.py", "check/checkprocess.py",
                 "check/checkgpu.py", "check/checkaot.py",
                 "serve/__init__.py", "serve/batcher.py", "serve/cache.py",
                 "serve/dispatcher.py", "serve/framing.py",
                 "analysis/__init__.py", "analysis/cli.py",
                 "analysis/callgraph.py", "analysis/engine.py",
                 "analysis/baseline.py", "analysis/rules/__init__.py",
                 "analysis/rules/r17_metric_doc.py"):
        assert PKG / name in files, name
    for path in files:
        assert not pat.search(path.read_text()), path


def test_exports():
    assert sorted(ytk_mp4j_tpu_torch.__all__) == [
        "FMConfig", "FMTrainer", "GBDTConfig", "GBDTTrainer",
        "GpuCommCluster", "LinearConfig", "LinearTrainer", "Mp4jError",
        "Operand", "Operands", "Operator", "Operators", "meta", "trace",
        "trace_collectives", "trees_from_numpy"]
    for name in ytk_mp4j_tpu_torch.__all__:
        assert getattr(ytk_mp4j_tpu_torch, name)


@pytest.mark.parametrize("arg", ["cpu", torch.device("cpu")])
def test_make_device_cpu_when_asked(arg):
    assert make_device(arg) == torch.device("cpu")


@pytest.mark.parametrize("arg", [None, "cuda", "cuda:0"])
def test_make_device_without_cuda_raises(monkeypatch, arg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        make_device(arg)


def test_make_device_refuses_other_types():
    with pytest.raises(Mp4jError, match="cuda or cpu"):
        make_device("meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A CUDA-less machine: loading a kernel raises, nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(Mp4jError, match="nvcc not found"):
        _build.find_nvcc()
    for name in ("hist_kernel", "ring_kernel"):
        with pytest.raises(Mp4jError, match="nvcc not found"):
            _build.load(name)


def test_build_flags_and_paths():
    assert {"hist_kernel", "ring_kernel"} <= set(_build.sources())
    path = _build.library_path("hist_kernel")
    assert path.parent == PKG / "csrc" / "build"
    assert re.fullmatch(r"libhist_kernel-[0-9a-f]{12}\.so", path.name)
    cmd = _build.nvcc_command("nvcc", "hist_kernel", path)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("ops/csrc/hist_kernel.cu")
    with pytest.raises(Mp4jError):
        _build.library_path("no_such_kernel")
    ignored = (REPO / ".gitignore").read_text().split()
    assert "ytk_mp4j_tpu_torch/csrc/build/" in ignored


def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return nvcc


def test_build_runs_one_nvcc_per_missing_library(monkeypatch, tmp_path):
    """The build logic with a stand-in compiler that writes its -o."""
    nvcc = _fake_nvcc(tmp_path, textwrap.dedent("""
        while [ "$1" != "-o" ]; do shift; done
        echo built > "$2"
        echo x >> "${2%/*}/calls"
    """))
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    paths = _build.build()
    assert set(paths) == set(_build.sources())
    assert all(p.read_text() == "built\n" for p in paths.values())
    _build.build()                       # cached: no second compile
    calls = (tmp_path / "build" / "calls").read_text().count("x")
    assert calls == len(paths)


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path, "echo 'error: bad kernel' ; exit 1\n")
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(Mp4jError, match="bad kernel"):
        _build.build(["hist_kernel"])
    assert not list((tmp_path / "build").glob("*.so*"))


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_packaging_names_the_port():
    text = (REPO / "pyproject.toml").read_text()
    assert ('ytk_mp4j_tpu_torch = ["ops/csrc/*.cu", "csrc/*.cpp", '
            '"analysis/*.toml",\n                      "analysis/*.json"]'
            in text)
    for name in ("baseline.toml", "sarif-2.1.0-subset.json"):
        assert (PKG / "analysis" / name).is_file(), name
    assert re.search(r"torch\s*=\s*\[\s*\"torch", text)
