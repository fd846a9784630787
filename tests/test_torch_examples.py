"""The eleven mirrors in ``examples/torch/`` run on the CPU and print what
the reference examples print.

Each mirror runs as a subprocess with ``--device cpu`` (and its default
``--n 8``, the reference's 8-device rig) and must exit 0; its own
asserts are the reference example's. Each reference example then runs as
``tests/test_examples.py`` runs it (8 virtual CPU devices, x64 on), and
the two outputs are compared line by line: each line's text with its
numbers taken out must be equal, and each number must agree within one
unit of its last printed decimal (the printouts round f32 results to 3-4
places; every compared value here agreed exactly when this was written).

Lines that differ by design are listed in ``SKIP`` with the reason, and
01's trace table is compared on the columns that do not measure time.
Without CUDA, a mirror run without ``--device`` must exit non-zero with
the ``Mp4jError`` of ``device.make_device``: nothing moves to the CPU
unasked.
"""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
MIRRORS = sorted((REPO / "examples" / "torch").glob("*.py"))
REFERENCE = {p.name[:2]: p for p in (REPO / "examples").glob("*.py")}
TIMEOUT = 280

# example -> (reason, predicate on a reference output line); matching
# lines are left out of both outputs before the comparison
SKIP = {
    "03": ("the slaves' log lines carry wall-clock timestamps and arrive "
           "in thread order", lambda line: not line.startswith("job exit")),
    "07": ("row and feature subsampling draw from per-member "
           "torch.Generator streams, not jax.random keys, so the rounds "
           "kept, the holdout accuracy and the split shares differ",
           lambda line: line.startswith(("rounds kept", "holdout acc"))),
    "08": ("the reference names its functional layer after jax "
           "(in-jit psum, ppermute ring, rdma kernel); the mirror's lines "
           "name the member-tensor calls",
           lambda line: line.startswith("in-jit")),
}
# lines only the mirror prints (named after the port's functional layer)
MIRROR_ONLY = {"08": lambda line: line.startswith("member tensors")}

_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.update(extra)
    return env


def _run_mirror(path: Path):
    return subprocess.run([sys.executable, str(path), "--device", "cpu"],
                          env=_env(), capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=str(REPO))


def _run_reference(path: Path):
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8")
    prog = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "jax.config.update('jax_enable_x64', True); "
            f"exec(open({str(path)!r}).read())")
    return subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT,
                          cwd=str(REPO))


@pytest.fixture(scope="module")
def runs():
    """Every mirror and every reference example, run once for the
    module, three at a time: ``runs[("port" | "ref", "01")]`` is a
    future of the finished process."""
    with ThreadPoolExecutor(3) as pool:
        futs = {}
        for path in MIRRORS:
            futs["port", path.name[:2]] = pool.submit(_run_mirror, path)
        for key in sorted(REFERENCE):
            futs["ref", key] = pool.submit(_run_reference, REFERENCE[key])
        yield futs


def _close(a: str, b: str) -> bool:
    """Equal within one unit of the last printed decimal of either."""
    places = max(len(s.split(".")[1]) if "." in s and "e" not in s.lower()
                 else 0 for s in (a, b))
    return abs(float(a) - float(b)) <= 10.0 ** -places * 1.000001


def _split(line: str):
    return _NUM.sub("#", line), _NUM.findall(line)


def _trace_rows(out: str) -> list:
    """01's summary rows as (name, calls, MB); the other columns time."""
    rows = []
    for line in out.splitlines():
        f = line.split()
        if len(f) == 8 and f[0].endswith(("_array", "_map", "_async")):
            rows.append((f[0].split(".", 1)[1], f[1], f[3]))
    return rows


def test_mirror_set_matches_the_reference_examples():
    assert [p.name[:2] for p in MIRRORS] == sorted(REFERENCE)
    assert len(MIRRORS) == 11
    # tests/test_examples.py globs examples/*.py, not recursively: it
    # still collects exactly the eleven reference scripts
    assert len(list((REPO / "examples").glob("*.py"))) == 11


@pytest.mark.parametrize("path", MIRRORS, ids=lambda p: p.name)
def test_mirror_runs_on_cpu(path, runs):
    r = runs["port", path.name[:2]].result()
    assert r.returncode == 0, (path.name, r.stderr[-3000:])


@pytest.mark.parametrize("path", MIRRORS, ids=lambda p: p.name)
def test_mirror_prints_what_the_reference_prints(path, runs):
    key = path.name[:2]
    mine = runs["port", key].result()
    assert mine.returncode == 0, mine.stderr[-3000:]
    ref = runs["ref", key].result()
    assert ref.returncode == 0, ref.stderr[-3000:]
    if key == "01":
        assert mine.stdout.splitlines()[0] == ref.stdout.splitlines()[0]
        rows = _trace_rows(mine.stdout)
        assert len(rows) == 5
        assert rows == _trace_rows(ref.stdout)
        return
    skip = SKIP.get(key, (None, lambda line: False))[1]
    only = MIRROR_ONLY.get(key, lambda line: False)
    want = [ln for ln in ref.stdout.splitlines() if not skip(ln)]
    got = [ln for ln in mine.stdout.splitlines()
           if not skip(ln) and not only(ln)]
    assert want, ref.stdout
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        (gt, gn), (wt, wn) = _split(g), _split(w)
        assert gt == wt, (g, w)
        assert all(_close(a, b) for a, b in zip(gn, wn)), (g, w)


def test_mirrors_without_cuda_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")

    def run(path):
        return path.name, subprocess.run(
            [sys.executable, str(path)], env=_env(), capture_output=True,
            text=True, timeout=TIMEOUT, cwd=str(REPO))

    with ThreadPoolExecutor(4) as pool:
        for name, r in pool.map(run, MIRRORS):
            assert r.returncode != 0, name
            assert "Mp4jError" in r.stderr, (name, r.stderr[-2000:])
            assert "no CUDA device is available" in r.stderr, name
