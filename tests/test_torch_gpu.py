"""The port's CUDA kernel on the card: against its plain version, run to
run, at the edges of its contract, and through the trainer. Every test
skips where there is no CUDA device.

This file imports neither jax nor the JAX package and uses no fixture of
tests/conftest.py, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu_torch import GBDTConfig, GBDTTrainer
from ytk_mp4j_tpu_torch.ops import hist_kernel as hk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, N, F, B, id_lo, id_hi, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, B, (N, F)).astype(np.int32),
              rng.standard_normal(N).astype(np.float32),
              rng.random(N).astype(np.float32),
              rng.integers(id_lo, id_hi, N).astype(np.int32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.mark.parametrize("n_nodes", [1, 16])
def test_kernel_matches_plain_and_is_deterministic(cuda, n_nodes):
    """Sentinel ids -1 and n_nodes included; tolerance 1e-5 relative (the
    two differ only in the last f32 rounding of near-exact sums)."""
    N, F, B = 200_000, 28, 256
    bins, g, h, nid = _inputs(cuda, N, F, B, -1, n_nodes + 1)
    before = hk.histograms.launches
    a = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    b = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    ref = hk.histograms_reference(bins, g, h, nid, n_nodes, F, B)
    torch.cuda.synchronize()
    assert hk.histograms.launches == before + 2
    for k in range(2):
        assert torch.equal(a[k], b[k])
        torch.testing.assert_close(a[k], ref[k], rtol=1e-5, atol=1e-5)


def test_kernel_takes_every_shape(cuda):
    """More (node, bin) cells than one block holds: several cell groups."""
    N, F, B, n_nodes = 50_000, 3, 4096, 8
    bins, g, h, nid = _inputs(cuda, N, F, B, 0, n_nodes)
    a = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    ref = hk.histograms_reference(bins, g, h, nid, n_nodes, F, B)
    for k in range(2):
        torch.testing.assert_close(a[k], ref[k], rtol=1e-5, atol=1e-5)


def test_kernel_empty_input_and_zero_rows(cuda):
    F, B = 28, 256
    before = hk.histograms.launches
    e = torch.zeros(0, device=cuda)
    ei = torch.zeros(0, dtype=torch.int32, device=cuda)
    hg, hh = hk.histograms(torch.zeros((0, F), dtype=torch.int32,
                                       device=cuda), e, e, ei, 4, F, B)
    assert hk.histograms.launches == before
    assert hg.shape == (4, F, B) and not hg.any() and not hh.any()
    bins, _, _, nid = _inputs(cuda, 1000, F, B, 0, 4)
    z = torch.zeros(1000, device=cuda)
    hg, hh = hk.histograms(bins, z, z, nid, 4, F, B)
    assert not hg.any() and not hh.any()


def test_kernel_non_finite_poisons_its_plane(cuda):
    bins, g, h, nid = _inputs(cuda, 1000, 4, 16, 0, 2)
    g[3] = float("inf")
    hg, hh = hk.histograms(bins, g, h, nid, 2, 4, 16)
    assert torch.isnan(hg).all()
    assert torch.isfinite(hh).all()


def test_trainer_through_kernel_matches_plain_histograms(cuda):
    """One depth-6 tree through the kernel against the same tree through
    the plain histogram (hist_mode="flat") on the same card."""
    rng = np.random.default_rng(0)
    N, F, B = 50_000, 28, 256
    bins = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.int32))
    y = torch.from_numpy((bins[:, 0].numpy() / B + 0.1 * rng.standard_normal(
        N)).astype(np.float32))
    kw = dict(n_features=F, n_bins=B, depth=6, n_trees=1)
    before = hk.histograms.launches
    tk, mk = GBDTTrainer(GBDTConfig(**kw)).train(bins, y)
    assert hk.histograms.launches == before + 6
    tp, mp = GBDTTrainer(GBDTConfig(hist_mode="flat", **kw)).train(bins, y)
    assert hk.histograms.launches == before + 6
    for k in range(3):
        assert torch.equal(tk[0][k], tp[0][k])
    torch.testing.assert_close(tk[0][3], tp[0][3], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mk, mp, rtol=1e-5, atol=1e-6)
