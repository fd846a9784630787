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


def test_dryrun_covers_the_whole_reference_dryrun(monkeypatch):
    """Every part of ``__graft_entry__.dryrun_multichip`` runs, in its
    order: GBDT (three trainers), the map allreduce, the dense allreduce
    under every algo, FFM sparse replicated / sharded / streamed both
    ways, and the softmax linear model."""
    from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster
    from ytk_mp4j_tpu_torch.models.fm import FMTrainer
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTTrainer
    from ytk_mp4j_tpu_torch.models.linear import LinearTrainer

    calls = []

    def spy(cls, name, tag):
        real = getattr(cls, name)

        def wrapped(self, *a, **kw):
            calls.append(tag(self, kw) if callable(tag) else tag)
            return real(self, *a, **kw)

        monkeypatch.setattr(cls, name, wrapped)

    spy(GBDTTrainer, "train", "gbdt")
    spy(GBDTTrainer, "train_raw", "train_raw")
    spy(GpuCommCluster, "allreduce_map", "map")
    spy(GpuCommCluster, "allreduce_array", lambda s, kw: kw["algo"])
    spy(FMTrainer, "fit", lambda s, kw: f"ffm {s.table_sharding}")
    spy(FMTrainer, "fit_stream",
        lambda s, kw: f"ffm stream {s.table_sharding}")
    spy(LinearTrainer, "fit", "linear")
    entry.dryrun(4, device="cpu")
    assert [c for c in calls if c != "gbdt"] == [
        "train_raw", "map", "xla", "ring", "rdma", "ffm replicated",
        "ffm sharded", "ffm stream replicated", "ffm stream sharded",
        "linear"]
    assert calls.count("gbdt") >= 2


def test_dryrun_raises_on_a_wrong_map_result(monkeypatch):
    from ytk_mp4j_tpu_torch.comm.gpu_comm import GpuCommCluster

    monkeypatch.setattr(GpuCommCluster, "allreduce_map",
                        lambda self, maps, *a, **kw: maps)
    with pytest.raises(Mp4jError, match="dryrun: map allreduce"):
        entry.dryrun(3, device="cpu")
