"""The packed ring collectives' global path (``ops/csrc/ring_kernel.cu``,
n > 8 members on one card) on the CPU, where its plain version runs:
``ring_kernel._global_plain`` folds each chunk once over the rows, in the
order table the launch takes (``ring_kernel.fold_rotation``, built from
``RingPlan``), and stores it into every row that receives it.

- The order table, wider than ``member_order``'s bytes, is the ring's
  schedule for n up to 300: every chunk's rotation is ``fold_order``'s,
  and folding by it under an operator whose result depends on the order
  (a polynomial hash of the folded sequence, exact in int64) gives the
  ring schedule's result (``_plain``, step by step) element for element.
- The kernel's plain version equals ``_plain`` bit for bit through the
  entry points (their layouts and padding), for every mode, both
  directions, n in {9, 12, 16, 33, 64, 65, 300}, SUM / PROD / MAX / MIN
  (NaN under MAX / MIN) and f32 / f64 / bf16 / i8 (wrapping), on inputs
  that mix magnitudes, where a sum or product folded in another order
  gives other bits.
- Both equal the reference's Pallas ring kernels in interpret mode, bit
  for bit, at n = 9 and 16: more members than the conftest's 8 virtual
  devices, so the reference runs in child interpreters of 16
  (``tests/torch_ring_reference.py``), one a member count, started
  together once for the module.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import torch_ring_reference as ref
from test_torch_ring_member import _layout, _mixed, _same
from ytk_mp4j_tpu_torch.operators import Operators
from ytk_mp4j_tpu_torch.ops import ring_kernel as rk

MODES = ("allreduce", "reduce_scatter", "allgather")
OPS = ("SUM", "PROD", "MAX", "MIN")
GLOBAL_MEMBERS = (9, 12, 16, 33, 64, 65, 300)
ORDER_MEMBERS = (1, 2, 3, 5, 8, 9, 16, 31, 64, 100, 255, 256, 257, 300)
DTYPES = (np.float32, np.float64, ml_dtypes.bfloat16, np.int8)
REFERENCE_MEMBERS = (9, 16)
CHILD_TIMEOUT_S = 600


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _entry(mode, x, op, bidir):
    """The plain version through the entry point (on the CPU)."""
    if mode == "allreduce":
        return rk.ring_allreduce_reference(x, op, bidir)
    if mode == "reduce_scatter":
        return rk.ring_reduce_scatter_reference(x, op, bidir)
    return rk.ring_allgather_reference(x, bidir)


def _global(monkeypatch, mode, x, op, bidir):
    """The global kernel's plain version through the same entry point:
    the entry's layout and padding, ``_global_plain`` in place of the
    ring schedule."""
    with monkeypatch.context() as m:
        m.setattr(rk, "_plain", rk._global_plain)
        return _entry(mode, x, op, bidir)


# ----------------------------------------------------------------------
# the order table is the ring's schedule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", ORDER_MEMBERS)
def test_fold_rotation_is_the_rings_fold_order(n, mode, ndir):
    """Each chunk's j-th member is ``(K + rotation[d][j]) % n`` of
    ``fold_order``; the list form's byte table is the same rotation where
    a list takes n; the kernel's plain version under an order-revealing
    operator equals the ring schedule's exactly."""
    rotation = rk.fold_rotation(n, mode, ndir)
    assert len(rotation) == ndir * n
    assert all(isinstance(o, int) and 0 <= o < n for o in rotation)
    order = rk.fold_order(n, mode, ndir)
    for d in range(ndir):
        for k in range(n):
            assert tuple((k + rotation[d * n + j]) % n
                         for j in range(n)) == order[d][k]
    if n <= rk.MAX_MEMBERS:
        assert rk.member_order(n, mode, ndir) == bytes(rotation)
    hashing = SimpleNamespace(
        torch_fn=lambda acc, x: (acc * 1_000_003 + x) % 2_147_483_647)
    lay = _layout(mode, n, ndir * n * (1 if mode == "allreduce" else 2),
                  ndir)
    x = torch.arange(n * lay.in_row, dtype=torch.int64).view(n, lay.in_row)
    plan = rk.RingPlan(n, mode, ndir)
    assert torch.equal(rk._global_plain(x, plan, lay, hashing),
                       rk._plain(x, plan, lay, hashing))


# ----------------------------------------------------------------------
# the kernel's plain version against the ring's, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", GLOBAL_MEMBERS)
def test_global_fold_equals_the_ring_schedule(monkeypatch, n, mode, bidir,
                                              dt):
    """Every operator (the allgather has none), allreduce at an odd
    length (identity padding), NaN at two places of the MAX / MIN
    inputs: the global kernel's plain version equals the ring schedule
    bit for bit (NaN as NaN)."""
    rng = np.random.default_rng(n)
    shape = {"allreduce": (n, 3 * n + 5), "reduce_scatter": (n, 6 * n),
             "allgather": (n, 6)}[mode]
    for op_name in (OPS if mode != "allgather" else ("SUM",)):
        data = _mixed(rng, shape, dt)
        if np.dtype(dt).kind != "i" and op_name in ("MAX", "MIN"):
            data[0, 1] = data[n - 1, 2] = np.nan
        x = _to_torch(data)
        op = getattr(Operators, op_name)
        _same(_global(monkeypatch, mode, x, op, bidir),
              _entry(mode, x, op, bidir))


# ----------------------------------------------------------------------
# both against the reference, above the conftest's 8 devices
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{n: npz of the reference's inputs and outputs}, from one child
    interpreter of 16 virtual devices a member count, both started
    together (two, not four, to keep the load they add to a parallel
    test run down)."""
    out = tmp_path_factory.mktemp("ring_reference")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(tests), tests,
                    os.environ.get("PYTHONPATH", "")]))
    children = {}
    for n in REFERENCE_MEMBERS:
        path = out / f"n{n}.npz"
        children[n] = (path, subprocess.Popen(
            [sys.executable, os.path.join(tests, "torch_ring_reference.py"),
             str(n), str(path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    failed = []
    try:
        for n, (path, proc) in children.items():
            text, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
            if proc.returncode:
                failed.append(f"n={n}: rc {proc.returncode}\n"
                              f"{text.decode(errors='replace')[-2000:]}")
    finally:
        for _, proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not failed, "\n".join(failed)
    return {k: dict(np.load(path)) for k, (path, _) in children.items()}


@pytest.mark.parametrize("case", ref.CASES, ids=lambda c: ref.key(*c))
@pytest.mark.parametrize("dt", ref.DTYPES)
@pytest.mark.parametrize("n", REFERENCE_MEMBERS)
def test_global_path_matches_the_reference_above_eight(monkeypatch,
                                                       reference, n, dt,
                                                       case):
    """The port's packed entry point on the CPU (the ring schedule) and
    the global kernel's plain version against the reference's
    interpreted Pallas kernel, bit for bit (NaN as NaN)."""
    mode, op_name, bidir = case
    got = reference[n]
    k = f"{dt}.{ref.key(*case)}"
    np.testing.assert_array_equal(got[f"{k}.x"],
                                  ref.inputs(n, np.dtype(dt))[ref.key(*case)])
    x, want = torch.from_numpy(got[f"{k}.x"]), torch.from_numpy(got[f"{k}.y"])
    op = getattr(Operators, op_name)
    _same(_entry(mode, x, op, bidir), want)
    _same(_global(monkeypatch, mode, x, op, bidir), want)
