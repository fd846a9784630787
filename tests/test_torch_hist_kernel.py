"""The port's histogram op (ytk_mp4j_tpu_torch/ops/hist_kernel.py)
against the JAX package's Pallas kernel, interpreted on the CPU, over
the cases of tests/test_hist_kernel.py. The CUDA kernel itself is held
against this plain version in tests/test_torch_gpu.py.

Tolerance: rtol = atol = 1e-4, the reference test's own (its kernel sums
through hi/lo bf16 products, ~2^-17 relative each; the port's plain
version sums in f64 and rounds once)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ytk_mp4j_tpu.ops.hist_kernel import pallas_histograms
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import hist_kernel as hk


def np_hist(bins, g, node_ids, n_nodes, F, B):
    out = np.zeros((n_nodes, F, B), np.float64)
    for i in range(bins.shape[0]):
        if not 0 <= node_ids[i] < n_nodes:
            continue
        for f in range(F):
            if 0 <= bins[i, f] < B:
                out[node_ids[i], f, bins[i, f]] += g[i]
    return out


def _inputs(rng, N, F, B, n_nodes, id_hi=None):
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    g = rng.standard_normal(N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    nid = rng.integers(0, n_nodes if id_hi is None else id_hi,
                       N).astype(np.int32)
    return bins, g, h, nid


def _port(bins, g, h, nid, n_nodes, F, B):
    hg, hh = hk.histograms(torch.from_numpy(bins), torch.from_numpy(g),
                           torch.from_numpy(h), torch.from_numpy(nid),
                           n_nodes, F, B)
    return hg.numpy(), hh.numpy()


def _jax(bins, g, h, nid, n_nodes, F, B, **kw):
    hg, hh = pallas_histograms(jnp.array(bins), jnp.array(g), jnp.array(h),
                               jnp.array(nid), n_nodes, F, B,
                               interpret=True, **kw)
    return np.asarray(hg), np.asarray(hh)


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_nodes", [1, 4])
@pytest.mark.parametrize("N", [64, 77, 300])
def test_matches_pallas_interpreted(rng, n_nodes, N):
    F, B = 3, 16
    bins, g, h, nid = _inputs(rng, N, F, B, n_nodes)
    got = _port(bins, g, h, nid, n_nodes, F, B)
    want = _jax(bins, g, h, nid, n_nodes, F, B)
    for k, v in enumerate((g, h)):
        _assert_close(got[k], want[k])
        _assert_close(got[k], np_hist(bins, v, nid, n_nodes, F, B))


def test_multi_tile_grid(rng):
    """The reference's multi-step grid (tile=32 < N) against the port."""
    N, F, B = 100, 2, 8
    bins, g, _, _ = _inputs(rng, N, F, B, 1)
    h = np.ones(N, np.float32)
    nid = np.zeros(N, np.int32)
    got = _port(bins, g, h, nid, 1, F, B)
    want = _jax(bins, g, h, nid, 1, F, B, tile=32)
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])
    assert float(got[1].sum()) == N * F       # counts are exact


def test_zero_weight_rows_contribute_nothing(rng):
    N, F, B = 40, 2, 8
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    z = np.zeros(N, np.float32)
    nid = np.zeros(N, np.int32)
    for out in _port(bins, z, z, nid, 1, F, B):
        assert np.all(out == 0)


def test_f64_precision(rng):
    """Relative error <= 1e-5 against an f64 sum (the reference's
    hi/lo-split precision case), and agreement with the reference."""
    N, F, B = 4096, 1, 8
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    g = (1.0 + 1e-3 * rng.standard_normal(N)).astype(np.float32)
    h = np.ones(N, np.float32)
    nid = np.zeros(N, np.int32)
    hg, _ = _port(bins, g, h, nid, 1, F, B)
    want = np_hist(bins, g.astype(np.float64), nid, 1, F, B)
    rel = np.abs(hg.astype(np.float64) - want).max() / want.max()
    assert rel < 1e-5
    _assert_close(hg, _jax(bins, g, h, nid, 1, F, B)[0])


@pytest.mark.parametrize("sentinel", [-1, 4, 9])
def test_sentinel_ids_contribute_nothing(rng, sentinel):
    """Ids outside [0, n_nodes) add nothing (the sibling subtraction's
    sentinel is n_nodes itself)."""
    N, F, B, n = 300, 3, 16, 4
    bins, g, h, nid = _inputs(rng, N, F, B, n)
    nid[rng.random(N) < 0.4] = sentinel
    got = _port(bins, g, h, nid, n, F, B)
    want = _jax(bins, g, h, nid, n, F, B)
    keep = nid != sentinel
    for k, v in enumerate((g, h)):
        _assert_close(got[k], want[k])
        _assert_close(got[k], np_hist(bins[keep], v[keep], nid[keep], n,
                                      F, B))


def test_out_of_range_bins_dropped(rng):
    """Bins outside [0, B) add nothing, as the reference's one-hot drops
    them."""
    N, F, B = 200, 3, 8
    bins, g, h, nid = _inputs(rng, N, F, B, 2)
    bins[rng.random((N, F)) < 0.2] = B
    bins[rng.random((N, F)) < 0.1] = -1
    got = _port(bins, g, h, nid, 2, F, B)
    want = _jax(bins, g, h, nid, 2, F, B)
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])
    _assert_close(got[0], np_hist(bins, g, nid, 2, F, B))


def test_empty_input_returns_zeros():
    F, B = 3, 8
    e32 = np.zeros(0, np.int32)
    ef = np.zeros(0, np.float32)
    hg, hh = _port(np.zeros((0, F), np.int32), ef, ef, e32, 4, F, B)
    assert hg.shape == hh.shape == (4, F, B)
    assert not hg.any() and not hh.any()


def test_cpu_tensors_take_the_plain_version(rng):
    """On the CPU the wrapper computes its plain version and counts no
    launch."""
    N, F, B = 64, 3, 8
    bins, g, h, nid = _inputs(rng, N, F, B, 2)
    before = hk.histograms.launches
    got = _port(bins, g, h, nid, 2, F, B)
    plain = hk.histograms_reference(
        torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(nid), 2, F, B)
    assert hk.histograms.launches == before
    np.testing.assert_array_equal(got[0], plain[0].numpy())
    np.testing.assert_array_equal(got[1], plain[1].numpy())


def _good(N=16, F=3):
    return (torch.zeros((N, F), dtype=torch.int32), torch.zeros(N),
            torch.zeros(N), torch.zeros(N, dtype=torch.int32))


@pytest.mark.parametrize("bad", [
    "bins_dtype", "bins_width", "g_dtype", "h_shape", "ids_dtype",
    "strided", "neg_nodes",
])
def test_wrapper_checks_inputs(bad):
    bins, g, h, nid = _good()
    n_nodes = 2
    if bad == "bins_dtype":
        bins = bins.long()
    elif bad == "bins_width":
        bins = torch.zeros((16, 4), dtype=torch.int32)
    elif bad == "g_dtype":
        g = g.double()
    elif bad == "h_shape":
        h = torch.zeros(15)
    elif bad == "ids_dtype":
        nid = nid.long()
    elif bad == "strided":
        g = torch.zeros(32)[::2]
    else:
        n_nodes = -1
    with pytest.raises(Mp4jError):
        hk.histograms(bins, g, h, nid, n_nodes, 3, 8)


def test_other_devices_raise_not_fall_back():
    """A tensor that is on neither the CPU nor a CUDA card is refused;
    the wrapper never computes the plain version for it."""
    bins, g, h, nid = (t.to("meta") for t in _good())
    with pytest.raises(Mp4jError, match="cpu or cuda"):
        hk.histograms(bins, g, h, nid, 2, 3, 8)


@pytest.mark.parametrize("N,F,B,n_nodes", [
    (11_000_000, 28, 256, 1), (11_000_000, 28, 256, 16),
    (5, 28, 256, 64), (300, 3, 16, 4), (1, 1, 1, 1),
    (2048, 8, 65536, 2), (10_000, 4, 256, 2 ** 12),
])
def test_launch_geometry_covers_every_shape(N, F, B, n_nodes):
    """The grid covers every row and every (node, bin) cell within
    Hopper's limits: no shape is refused at depth 6 or beyond."""
    rows, row_blocks, cells, groups = hk.launch_geometry(N, F, B, n_nodes,
                                                         132)
    assert 2 * 8 * cells <= 232_448              # shared memory a block
    assert 1 <= row_blocks <= 65_535 and 1 <= groups <= 65_535
    assert rows * row_blocks >= N > rows * (row_blocks - 1)
    assert cells * groups >= n_nodes * B > cells * (groups - 1)
