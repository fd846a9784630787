"""The port's entry points (ytk_mp4j_tpu_torch/entry.py) on the CPU:
``entry`` against the reference's ``__graft_entry__.entry`` on the same
inputs, and ``dryrun`` over 8 members (a 4 x 2 mesh) and an odd member
count (flat)."""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from ytk_mp4j_tpu_torch import entry
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import ring_kernel


def test_entry_matches_reference():
    """One depth-4 boosting round at F = 28, B = 256: the same inputs and
    margins to rtol = 1e-4, atol = 1e-5 (the reference's bf16 hi/lo
    histogram products against the port's f64 sums)."""
    fn, args = entry.entry(device="cpu")
    jfn, jargs = graft.entry()
    assert all(a.device.type == "cpu" for a in args)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == want.shape == (2048,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun(n):
    before = ring_kernel.ring_kernel.launches
    entry.dryrun(n, device="cpu")
    # the CPU runs the ring kernel's plain version: no launch
    assert ring_kernel.ring_kernel.launches == before


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Mp4jError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(Mp4jError, match="no CUDA device"):
        entry.dryrun(4)
