"""The port's CUDA kernels on the card: the histogram kernel and the two
ring kernels on both their paths (thread-block clusters for n <= 8
members, device-memory slots above), against their plain versions, run
to run, at the edges of their contracts (for the rings: co-residency
refused, a stuck ring raising at the spin bound, unaligned inputs), and
through the trainer (one member and a mesh of members, ``train_raw`` and
the binner's transform) and the collective driver; and the paths that
have no kernel of their own -- the map collectives, the FM/FFM trainer on
every gradient path, the linear trainer, their streaming fits and the
libsvm parser's build -- on the card against the port's CPU path at small
sizes; and the multi-process plane (``checkdist`` under NCCL at world size
1 and under gloo with two ranks on one card, two NCCL ranks on one card
refused, the kernel's scale seeded from the job). Every test skips where
there is no CUDA device.

This file imports neither jax nor the JAX package and uses no fixture of
tests/conftest.py, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu_torch import (FMConfig, FMTrainer, GBDTConfig,
                                GBDTTrainer, GpuCommCluster, LinearConfig,
                                LinearTrainer, Operands, Operators, entry)
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
from ytk_mp4j_tpu_torch.ops import hist_kernel as hk
from ytk_mp4j_tpu_torch.ops import ring_kernel as rk

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


@pytest.mark.parametrize("N,F,B,n_nodes", [
    (50_000, 3, 4096, 8),      # a node's cells over several groups
    (40_000, 28, 256, 2500),   # more lists than are counted in smem
])
def test_kernel_takes_every_shape(cuda, N, F, B, n_nodes):
    """More (node, feature, bin) cells than one block holds: several cell
    groups in a node; and more lists than the absmax and scatter passes
    count in shared memory (those beyond count in device memory)."""
    bins, g, h, nid = _inputs(cuda, N, F, B, 0, n_nodes)
    a = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    ref = hk.histograms_reference(bins, g, h, nid, n_nodes, F, B)
    for k in range(2):
        torch.testing.assert_close(a[k], ref[k], rtol=1e-5, atol=1e-5)


def _level_ids(dev, N, depth, seed=1):
    """Node ids as the depth-6 tree's level ``depth`` passes them: 0 at the
    root, else left children 0 .. n_half-1 and the sentinel n_half on
    about half the rows. Returns (ids, n_nodes)."""
    if depth == 0:
        return torch.zeros(N, dtype=torch.int32, device=dev), 1
    n_half = 2 ** (depth - 1)
    raw = np.random.default_rng(seed).integers(0, 2 * n_half, N)
    ids = np.where(raw % 2 == 0, raw // 2, n_half).astype(np.int32)
    return torch.from_numpy(ids).to(dev), n_half


def _assert_kernel_ok(bins, g, h, nid, n_nodes, F, B):
    """Kernel against the plain version (1e-5 relative to the plane's
    largest cell: the two differ in the last f32 rounding of near-exact
    sums) and bitwise against a second launch."""
    a = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    b = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    ref = hk.histograms_reference(bins, g, h, nid, n_nodes, F, B)
    for k in range(2):
        assert torch.equal(a[k], b[k])
        tol = 1e-5 * max(ref[k].abs().max().item(), 1e-30)
        assert (a[k] - ref[k]).abs().max().item() <= tol


@pytest.mark.parametrize("depth", range(6))
def test_kernel_at_each_level_of_the_tree(cuda, depth):
    """n_nodes 1, 1, 2, 4, 8, 16 with the sentinel id n_half on about half
    the rows (levels >= 1): rows read in place at level 0, sorted into one
    run per node at the others."""
    N, F, B = 300_000, 28, 256
    bins, g, h, _ = _inputs(cuda, N, F, B, 0, 1)
    nid, n_nodes = _level_ids(cuda, N, depth)
    _assert_kernel_ok(bins, g, h, nid, n_nodes, F, B)


def test_kernel_all_rows_in_one_bin(cuda):
    """Every row and feature in bin 0 of node 0: the most contended
    cells."""
    N, F, B = 200_000, 28, 256
    _, g, h, nid = _inputs(cuda, N, F, B, 0, 1)
    bins = torch.zeros((N, F), dtype=torch.int32, device=cuda)
    _assert_kernel_ok(bins, g, h, nid, 1, F, B)
    _assert_kernel_ok(bins, g, h, _level_ids(cuda, N, 5)[0], 16, F, B)


@pytest.mark.parametrize("F", [1, 3, 5])
def test_kernel_rows_not_a_multiple_of_16_bytes(cuda, F):
    """F * 4 bytes not a multiple of 16: the rows are read element by
    element."""
    N, B = 100_003, 256
    bins, g, h, _ = _inputs(cuda, N, F, B, 0, 1)
    for depth in (0, 3):
        nid, n_nodes = _level_ids(cuda, N, depth)
        _assert_kernel_ok(bins, g, h, nid, n_nodes, F, B)


def test_kernel_view_starting_at_row_1(cuda):
    """A contiguous view whose data does not start on 16 bytes: the
    wrapper copies it first; g, h and ids are views at offset 1 too."""
    N, F, B = 50_001, 3, 256
    bins, g, h, _ = _inputs(cuda, N, F, B, 0, 1)
    nid, n_nodes = _level_ids(cuda, N, 2)
    v = (bins[1:], g[1:], h[1:], nid[1:])
    assert v[0].data_ptr() % 16 and v[0].is_contiguous()
    _assert_kernel_ok(*v, n_nodes, F, B)


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_kernel_rows_around_one_block(cuda, delta):
    """N = one block's threads (THREADS) -1, 0, +1: fewer rows than the
    grid's blocks, so most blocks' shares are empty; rows in place and
    sorted into sixteen runs."""
    N, F, B = hk.THREADS + delta, 28, 256
    bins, g, h, _ = _inputs(cuda, N, F, B, 0, 1)
    for depth in (0, 5):
        nid, n_nodes = _level_ids(cuda, N, depth)
        _assert_kernel_ok(bins, g, h, nid, n_nodes, F, B)


def test_kernel_two_launches_bitwise_equal_at_full_size(cuda):
    """11M rows at the deepest level: the scatter places records in a
    different order each launch, the sums are the same bits."""
    N, F, B = 11_000_000, 28, 256
    bins, g, h, _ = _inputs(cuda, N, F, B, 0, 1)
    nid, n_nodes = _level_ids(cuda, N, 5)
    a = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    for _ in range(3):
        b = hk.histograms(bins, g, h, nid, n_nodes, F, B)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


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


# ---- data-parallel GBDT over members on the card ------------------------
def _gbdt_data(N, F=28, B=256, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    y = (bins[:, 0] / B + 0.1 * rng.standard_normal(N)).astype(np.float32)
    return torch.from_numpy(bins), torch.from_numpy(y)


@pytest.mark.parametrize("members", [2, 4, 8])
def test_data_parallel_trainer_through_kernel(cuda, members):
    """One kernel launch a level covers every member (ids member-offset),
    N = 50,001 pads; the tree equals the same members' tree through the
    plain histogram."""
    bins, y = _gbdt_data(50_001)
    kw = dict(n_features=28, n_bins=256, depth=6, n_trees=1)
    mesh = make_mesh(members)
    before = hk.histograms.launches
    tk, mk = GBDTTrainer(GBDTConfig(**kw), mesh=mesh).train(bins, y)
    assert hk.histograms.launches == before + 6
    assert mk.shape == (-(-50_001 // members) * members,)
    tp, mp = GBDTTrainer(GBDTConfig(hist_mode="flat", **kw),
                         mesh=mesh).train(bins, y)
    for k in range(3):
        assert torch.equal(tk[0][k], tp[0][k])
    torch.testing.assert_close(tk[0][3], tp[0][3], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mk, mp, rtol=1e-5, atol=1e-6)


def test_hierarchical_mesh_equals_flat_on_the_card(cuda):
    """The trainer reads only a mesh's member count, so this is a check
    of run-to-run repeatability on the card: the same fold order, the
    kernel's repeatable sums, the same per-member streams, and leaf sums whose
    atomic adds land in float64, give the (2, 2) mesh's trees and margins
    bitwise equal to the flat mesh's, with stochastic boosting on."""
    bins, y = _gbdt_data(100_000)
    cfg = GBDTConfig(n_features=28, n_bins=256, depth=6, n_trees=2,
                     subsample=0.8, colsample=0.8)
    th, mh = GBDTTrainer(cfg, mesh=make_hier_mesh(2, 2)).train(bins, y)
    tf, mf = GBDTTrainer(cfg, mesh=make_mesh(4)).train(bins, y)
    assert torch.equal(mh, mf)
    for a, b in zip(th, tf):
        assert all(torch.equal(a[k], b[k]) for k in range(4))


@pytest.mark.parametrize("missing_bucket", [False, True])
def test_binner_transform_on_the_card_equals_the_cpu(cuda, missing_bucket):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((200_000, 28)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[::97, 3] = np.inf
    X[::89, 4] = -np.inf
    b = QuantileBinner(256, missing_bucket=missing_bucket).fit(X)
    card = b.transform(torch.from_numpy(X).to(cuda))
    assert card.device == cuda and card.dtype == torch.int32
    assert torch.equal(card.cpu(), b.transform(X, device="cpu"))


def test_train_raw_save_load_on_the_card(cuda, tmp_path):
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.standard_normal((60_000, 28)).astype(
        np.float32)).to(cuda)
    y = (X[:, 0] > 0).float()
    cfg = GBDTConfig(n_features=28, n_bins=256, depth=4, loss="logistic")
    tr = GBDTTrainer(cfg, mesh=make_mesh(4))
    trees, margins = tr.train_raw(X, y, n_trees=2, bin_sample=20_000)
    assert margins.device == cuda
    assert torch.equal(tr.predict_raw(X, trees), margins)
    path = str(tmp_path / "m.npz")
    tr.save_model(path, trees)
    cfg2, trees2, binner2 = GBDTTrainer.load_model(path)
    assert trees2[0][0].device == cuda
    assert torch.equal(GBDTTrainer(cfg2).predict(binner2.transform(X),
                                                 trees2), margins)


def test_entry_points_on_the_card(cuda):
    fn, args = entry.entry()
    assert all(a.device == cuda for a in args)
    assert torch.isfinite(fn(*args)).all()
    entry.dryrun(4)


# ---- the ring kernels (ops/csrc/ring_cluster.cu, ops/csrc/ring_kernel.cu) --
def _same(a, b):
    """Bitwise, NaN equal to NaN at the same places."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if torch.equal(a, b):
        return True
    if a.is_floating_point():
        na, nb = a.isnan(), b.isnan()
        return torch.equal(na, nb) and torch.equal(torch.where(na, 0, a),
                                                   torch.where(nb, 0, b))
    return torch.equal(a, b)


def _ring_data(dev, shape, dt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dt.is_floating_point:
        return torch.randn(shape, generator=g, device=dev).to(dt)
    return torch.randint(-100, 100, shape, generator=g, device=dev).to(dt)


def _path_counts(counter):
    return counter.cluster_launches, counter.global_launches


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int64,
                                torch.int32, torch.int16, torch.int8,
                                torch.bfloat16], ids=str)
def test_ring_kernels_match_plain_bitwise(cuda, dt, n, bidir):
    """Every mode and operator, odd allreduce length (padding), NaN under
    MAX/MIN: the kernel equals its plain version bit for bit, on the
    cluster path for n <= 8 and the global path above."""
    counter = rk.ring_kernel_bidir if bidir else rk.ring_kernel
    before = _path_counts(counter)
    c = 2 * rk.granule(dt, cuda) * 5
    for k, op in enumerate((Operators.SUM, Operators.PROD, Operators.MAX,
                            Operators.MIN)):
        x = _ring_data(cuda, (n, 3001), dt, k)
        if dt.is_floating_point and op.name in ("MAX", "MIN"):
            x[0, 7] = float("nan")
        assert _same(rk.ring_allreduce_kernel(x, op, bidir, True),
                     rk.ring_allreduce_reference(x, op, bidir, True))
        x = _ring_data(cuda, (n, n * c), dt, k)
        assert _same(rk.ring_reduce_scatter_kernel(x, op, bidir, True),
                     rk.ring_reduce_scatter_reference(x, op, bidir, True))
    x = _ring_data(cuda, (n, c), dt, 9)
    assert _same(rk.ring_allgather_kernel(x, bidir, True),
                 rk.ring_allgather_reference(x, bidir, True))
    cluster, glob = _path_counts(counter)
    launched = 9                      # 4 allreduces, 4 reduce-scatters, 1
    if n <= rk.CLUSTER_LIMIT:
        assert (cluster - before[0], glob - before[1]) == (launched, 0)
    else:
        assert (cluster - before[0], glob - before[1]) == (0, launched)


@pytest.mark.parametrize("bidir", [False, True])
def test_ring_kernel_unaligned_view_equals_plain(cuda, bidir):
    """A contiguous view whose data does not start on 16 bytes (bulk
    copies need 16): the wrapper copies it first; the result is the
    plain version's."""
    base = _ring_data(cuda, (4 * 4097 + 1,), torch.float32, 5)
    x = base[1:].view(4, 4097)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert _same(rk.ring_allreduce_kernel(x, bidirectional=bidir),
                 rk.ring_allreduce_reference(x, bidirectional=bidir))
    y = base[1:1 + 4 * 4 * 8].view(4, 32)
    assert y.data_ptr() % 16
    assert _same(rk.ring_reduce_scatter_kernel(y, bidirectional=bidir),
                 rk.ring_reduce_scatter_reference(y, bidirectional=bidir))
    assert _same(rk.ring_allgather_kernel(y, bidirectional=bidir),
                 rk.ring_allgather_reference(y, bidirectional=bidir))


def test_ring_kernel_path_is_chosen_by_rule(cuda):
    """n <= 8 takes the cluster path, larger n the global one; forcing the
    cluster path beyond its limit, or naming no path, raises."""
    for n in (2, 8, 9):
        x = _ring_data(cuda, (n, 1000), torch.float32, 6)
        before = _path_counts(rk.ring_kernel)
        assert _same(rk.ring_allreduce_kernel(x),
                     rk.ring_allreduce_reference(x))
        after = _path_counts(rk.ring_kernel)
        assert after[n > 8] == before[n > 8] + 1
        assert after[n <= 8] == before[n <= 8]
    x = _ring_data(cuda, (4, 1000), torch.float32, 6)
    assert _same(rk.ring_allreduce_kernel(x, path="global"),
                 rk.ring_allreduce_reference(x))
    with pytest.raises(Mp4jError, match="no cluster of 9"):
        rk.ring_allreduce_kernel(_ring_data(cuda, (9, 64), torch.float32, 6),
                                 path="cluster")
    with pytest.raises(Mp4jError, match="path must be one of"):
        rk.ring_allreduce_kernel(x, path="tpu")


@pytest.mark.parametrize("bidir", [False, True])
def test_ring_kernel_multiblock_repeats(cuda, bidir):
    """Many blocks per member and several segments per block; repeated
    launches give the plain version's bits every time."""
    x = _ring_data(cuda, (8, 2_000_003), torch.float32, 1)
    ref = rk.ring_allreduce_reference(x, bidirectional=bidir)
    counter = rk.ring_kernel_bidir if bidir else rk.ring_kernel
    before = counter.launches
    for _ in range(30):
        assert _same(rk.ring_allreduce_kernel(x, bidirectional=bidir), ref)
    assert counter.launches == before + 30


def test_ring_kernel_refuses_a_grid_that_cannot_be_resident(cuda):
    """The global path (n > 8): one block per member at least; n =
    capacity members fit (and equal the plain version), n = capacity + 1
    are refused before any launch."""
    cap = rk.capacity(torch.float32, Operators.SUM, 1, cuda)
    x = _ring_data(cuda, (cap + 1, 64), torch.float32, 3)
    before = rk.ring_kernel.launches
    with pytest.raises(Mp4jError, match="co-resident"):
        rk.ring_allreduce_kernel(x)
    assert rk.ring_kernel.launches == before
    assert _same(rk.ring_allreduce_kernel(x[:cap]),
                 rk.ring_allreduce_reference(x[:cap]))
    assert rk.ring_kernel.launches == before + 1


def test_ring_kernel_keeps_the_callers_current_device(cuda):
    """A launch on the last card leaves the current device as it was."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    current = torch.cuda.current_device()
    x = _ring_data(dev, (4, 1001), torch.float32, 4)
    for bidir in (False, True):
        rk.capacity(x.dtype, Operators.SUM, 1 + bidir, dev)
        assert _same(rk.ring_allreduce_kernel(x, bidirectional=bidir),
                     rk.ring_allreduce_reference(x, bidirectional=bidir))
        assert torch.cuda.current_device() == current


def test_ring_kernel_spin_bound_raises_instead_of_hanging(cuda):
    """A member that does no work (on the cluster path it still joins its
    cluster's exit barrier): its neighbours' waits hit the bound, the
    launch ends and the wrapper raises; the next launch is clean."""
    x = _ring_data(cuda, (4, 100_000), torch.float32, 2)
    before = _path_counts(rk.ring_kernel)
    t0 = time.perf_counter()
    with pytest.raises(Mp4jError, match="spin bound"):
        rk.ring_allreduce_kernel(x, spin_s=0.5, stall_member=2)
    assert time.perf_counter() - t0 < 30
    assert _path_counts(rk.ring_kernel)[0] == before[0] + 1
    assert _same(rk.ring_allreduce_kernel(x), rk.ring_allreduce_reference(x))


@pytest.mark.parametrize("bidir", [False, True])
def test_ring_kernel_spin_bound_raises_on_the_global_path(cuda, bidir):
    """The same stall on the global path, and the same clean recovery."""
    x = _ring_data(cuda, (4, 100_000), torch.float32, 2)
    with pytest.raises(Mp4jError, match="spin bound"):
        rk.ring_allreduce_kernel(x, bidirectional=bidir, spin_s=0.5,
                                 stall_member=1, path="global")
    assert _same(rk.ring_allreduce_kernel(x, bidirectional=bidir,
                                          path="global"),
                 rk.ring_allreduce_reference(x, bidirectional=bidir))


def test_gpu_comm_cluster_on_the_card(cuda):
    """The driver's default device is the card; rdma, ring and xla agree
    with the f64 sum, and rdma equals ring bitwise (same chunking)."""
    rng = np.random.default_rng(0)
    host = [rng.standard_normal(1 << 16).astype(np.float32)
            for _ in range(4)]
    cl = GpuCommCluster(4)
    assert cl.device == torch.device("cuda", 0)
    out = {}
    before = rk.ring_kernel.launches
    for algo in ("rdma", "ring", "xla"):
        arrs = [a.copy() for a in host]
        cl.allreduce_array(arrs, Operands.FLOAT, Operators.SUM, algo=algo)
        out[algo] = arrs
    assert rk.ring_kernel.launches == before + 1
    exact = np.sum(np.stack(host).astype(np.float64), 0)
    for algo, arrs in out.items():
        for a in arrs:
            np.testing.assert_allclose(a, exact, rtol=1e-5, atol=1e-5)
    for a, b in zip(out["rdma"], out["ring"]):
        np.testing.assert_array_equal(a, b)
    arrs = [a.copy() for a in host]
    cl.reduce_scatter_array(arrs, Operands.FLOAT, algo="rdma")
    cl.allgather_array(arrs, Operands.FLOAT, algo="rdma")
    for a in arrs:
        np.testing.assert_allclose(a, exact, rtol=1e-5, atol=1e-5)
    cl.barrier()


# ----------------------------------------------------------------------
# slice 6: the map plane, FM/FFM and linear on the card against the CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("op", ["SUM", "PROD", "MAX", "MIN"])
def test_map_collectives_on_the_card_equal_the_cpu(cuda, op):
    """Max/min and integer sums agree bitwise; float sums add with
    atomics on the card (rtol 1e-12 in f64)."""
    rng = np.random.default_rng(0)
    maps = [{f"k{int(k)}": float(v) for k, v in
             zip(rng.integers(0, 500, 300), rng.standard_normal(300))}
            for _ in range(4)]
    on = [dict(m) for m in maps]
    off = [dict(m) for m in maps]
    GpuCommCluster(4).allreduce_map(on, Operands.DOUBLE,
                                    Operators.by_name(op))
    GpuCommCluster(4, device="cpu").allreduce_map(off, Operands.DOUBLE,
                                                  Operators.by_name(op))
    for a, b in zip(on, off):
        assert set(a) == set(b)
        for k in b:
            if op in ("MAX", "MIN"):
                assert a[k] == b[k]
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-12)
    imaps = [{int(k): 1 for k in rng.integers(0, 1000, 200)}
             for _ in range(4)]
    on = [dict(m) for m in imaps]
    off = [dict(m) for m in imaps]
    GpuCommCluster(4).reduce_scatter_map(on, Operands.INT)
    GpuCommCluster(4, device="cpu").reduce_scatter_map(off, Operands.INT)
    assert on == off


def test_map_async_chain_on_the_card(cuda):
    """Eight chained allreduce_map_async calls, resolved in reverse:
    each equals its synchronous result."""
    rng = np.random.default_rng(1)
    cl = GpuCommCluster(4)
    batches = [[{int(k): float(v) for k, v in
                 zip(rng.integers(0, 5000, 800), rng.standard_normal(800))}
                for _ in range(4)] for _ in range(8)]
    want = []
    for maps in batches:
        w = [dict(m) for m in maps]
        cl.allreduce_map(w, Operands.DOUBLE)
        want.append(w)
    handles = [cl.allreduce_map_async([dict(m) for m in maps],
                                      Operands.DOUBLE) for maps in batches]
    for h, w in zip(handles[::-1], want[::-1]):
        for a, b in zip(h.result(), w):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-12)


FM_PATHS = {"dense": {}, "sparse": {"sparse_grads": True},
            "sparse_cap": {"sparse_grads": True, "sparse_capacity": 64},
            "sharded": {"sparse_grads": True, "table_sharding": "sharded"}}


def _ffm_data(n=96, vocab=64, K=4, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, vocab, (n, K)).astype(np.int32)
    fields = np.tile(np.arange(K, dtype=np.int32), (n, 1))
    vals = np.ones((n, K), np.float32)
    y = ((feats[:, 0] + feats[:, 1]) % 2).astype(np.float32)
    return feats, fields, vals, y


@pytest.mark.parametrize("path", sorted(FM_PATHS))
@pytest.mark.parametrize("model", ["fm", "ffm"])
def test_fm_paths_on_the_card_equal_the_cpu(cuda, model, path):
    """Losses, table and predictions to rtol 1e-5 (the card's table adds
    are atomics in no fixed order); the stream of one full batch a chunk
    equals fit to the same tolerance."""
    data = _ffm_data()
    cfg = FMConfig(n_features=64, n_fields=4, k=4, max_nnz=4, model=model,
                   learning_rate=0.3, l2=1e-3, init_scale=0.1)
    runs = {}
    for where in ("card", "cpu"):
        dev = None if where == "card" else "cpu"
        tr = FMTrainer(cfg, mesh=make_mesh(4, dev), **FM_PATHS[path])
        params, losses = tr.fit(*data, n_steps=5, seed=2)
        runs[where] = (tr, params, losses)
    tr, pc, lc = runs["card"]
    _, pp, lp = runs["cpu"]
    assert pc[2].device.type == "cuda"
    np.testing.assert_allclose(lc, lp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.full_table(pc), pp[2].numpy()
                               [:tr.n_rows], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.predict(pc, *data[:3]).cpu().numpy(),
                               runs["cpu"][0].predict(pp, *data[:3]).numpy(),
                               rtol=1e-5, atol=1e-6)
    _, ls = FMTrainer(cfg, mesh=make_mesh(4), **FM_PATHS[path]).fit_stream(
        (data for _ in range(5)), seed=2)
    np.testing.assert_allclose(ls, lc, rtol=1e-5, atol=1e-6)


def test_fm_trains_from_tensors_on_the_card(cuda):
    """Data already on the card stages without a host copy; sharded
    equals replicated at rtol 1e-4, as the reference's dry run holds
    it."""
    data = [torch.from_numpy(a).to(cuda) for a in _ffm_data(n=256)]
    cfg = FMConfig(n_features=64, n_fields=4, k=4, max_nnz=4, model="ffm",
                   learning_rate=0.3, init_scale=0.1)
    _, lr = FMTrainer(cfg, n_devices=4, sparse_grads=True).fit(*data,
                                                               n_steps=3)
    _, ls = FMTrainer(cfg, n_devices=4, sparse_grads=True,
                      table_sharding="sharded").fit(*data, n_steps=3)
    np.testing.assert_allclose(ls, lr, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_linear_on_the_card_equals_the_cpu(cuda, loss):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((501, 5)).astype(np.float32)
    y = (rng.integers(0, 3, 501).astype(np.int32) if loss == "softmax"
         else (x[:, 0] > 0).astype(np.float32))
    cfg = LinearConfig(n_features=5, loss=loss, n_classes=3,
                       learning_rate=0.2, momentum=0.9, l1=1e-3, l2=1e-3)
    pc, lc = LinearTrainer(cfg, n_devices=4).fit(x, y, n_steps=10)
    pp, lp = LinearTrainer(cfg, n_devices=4, device="cpu").fit(x, y,
                                                               n_steps=10)
    assert pc[0].device.type == "cuda"
    np.testing.assert_allclose(lc, lp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pc[0].cpu().numpy(), pp[0].numpy(),
                               rtol=1e-5, atol=1e-6)
    _, ls = LinearTrainer(cfg, n_devices=4).fit_stream(
        ((x, y) for _ in range(10)), max_in_flight=0)
    np.testing.assert_allclose(ls, lc, rtol=1e-5, atol=1e-6)


def test_libsvm_parser_builds_on_the_cards_machine(tmp_path):
    """The parser builds with the machine's g++ and parses like the
    line-by-line path (no card needed, but run with the card's suite)."""
    from ytk_mp4j_tpu_torch.utils import native
    from ytk_mp4j_tpu_torch.utils.libsvm import _parse_chunk_slow

    assert native.build().exists()
    lines = ["1 0:3:1.5 1:7:-2", "0 2:5:0.25"]
    got = native.parse_libsvm_chunk("\n".join(lines).encode(), 2, 3)
    for a, b in zip(got, _parse_chunk_slow(lines, [1, 2], 3)):
        assert a.tobytes() == b.tobytes()


# ----------------------------------------------------------------------
# the multi-process plane on the card
# ----------------------------------------------------------------------
def test_kernel_scale_seeded_from_a_larger_call(cuda):
    """Over processes each rank histograms its own members' rows with the
    job's max|g| and max|h| (``absmax``): a member's partial must then
    equal its partial in one call over every member's rows, bitwise."""
    N, F, B, k = 200_000, 28, 256, 4
    bins, g, h, _ = _inputs(cuda, 2 * N, F, B, 0, 1)
    g[N + 7] = 40.0                      # member 1 holds the largest |g|
    nid = torch.from_numpy(np.random.default_rng(2).integers(
        0, k, 2 * N).astype(np.int32)).to(cuda)
    member = (torch.arange(2 * N, device=cuda) >= N).to(torch.int32)
    whole = hk.histograms(bins, g, h, nid + member * k, 2 * k, F, B)
    seed = hk.absmax_bits(g, h)
    part = hk.histograms(bins[:N].contiguous(), g[:N].contiguous(),
                         h[:N].contiguous(), nid[:N].contiguous(), k, F, B,
                         seed)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[:k])


def _checkdist(tmp_path, world, backend=None, timeout=240):
    """checkdist over ``world`` processes on cuda:0; their outputs."""
    import sys

    from torch_dist_worker import run_procs

    store = tmp_path / "store"
    extra = ["--backend", backend] if backend else []
    return run_procs(lambda r: [
        sys.executable, "-m", "ytk_mp4j_tpu_torch.check.checkdist",
        "--init-method", f"file://{store}", "--num-processes", str(world),
        "--process-id", str(r), "--device", "cuda:0"] + extra, world,
        timeout=timeout)


def test_checkdist_nccl_world_one(cuda, tmp_path):
    """NCCL at world size 1: the dense and map families, the fold, GBDT
    over the global mesh bitwise equal to make_mesh(1), binning."""
    (log,) = _checkdist(tmp_path, 1)
    assert "checkdist done (nccl on cuda:0): 0 failures" in log


def test_checkdist_two_gloo_ranks_on_one_card(cuda, tmp_path):
    logs = _checkdist(tmp_path, 2, "gloo")
    assert all("checkdist done (gloo on cuda:0): 0 failures" in log
               for log in logs)


def test_two_nccl_ranks_on_one_card_raise(cuda, tmp_path):
    """NCCL refuses two ranks on one card: both raise, neither hangs, and
    nothing drops quietly to gloo."""
    with pytest.raises(RuntimeError, match="processes failed") as info:
        _checkdist(tmp_path, 2, timeout=120)
    assert "gloo on" not in str(info.value)
