"""The port's CUDA kernels on the card: the histogram kernel, the leaf-sum
kernel (against f64 sums and, bitwise, its order of adds replayed on the
CPU; run to run; packed against one call a member) and the two ring
kernels on both their paths (thread-block clusters for n <= 8
members; above, one launch that folds each chunk straight from the rows),
against their plain versions, run to run, at the edges of their
contracts (for the rings: 300 members on the global path, a stuck
cluster ring raising at the spin bound, the global path refusing the
stall hook, unaligned inputs), and
through the trainer (one member and a mesh of members, ``train_raw`` and
the binner's transform) and the collective driver; and the paths that
have no kernel of their own -- the map collectives, the FM/FFM trainer on
every gradient path, the linear trainer, their streaming fits and the
libsvm parser's build -- on the card against the port's CPU path at small
sizes; the nonblocking family of the collective driver; and the
multi-process plane (``checkdist`` under NCCL at world size 1 and under
gloo with two ranks on one card -- GBDT, FFM on every gradient path and
the dense plane over processes --, two NCCL ranks on one card refused,
the kernel's scale seeded from the job, the in-order row adds that keep a
replicated table identical on every rank); and the list form (members on
a device list, ``make_mesh(n, devices=["cuda:0"] * n)``): the ring kernel
launched a member at a time (``ring_member.cu``) against the packed
launch and the plain version on both sides of the one-shot threshold,
its launch counts, its refusals and calls made back to back with no
synchronize between them, ``GpuCommCluster(mesh=)``
(dense and map families) and GBDT over a list, bitwise the packed form,
FFM on every gradient path and linear over a list against the packed
form at rtol 1e-5, and ``entry.dryrun`` over a list; and wide,
mostly-missing rows (the Bosch shape: 968 features, 81 % missing): the
histogram kernel, its row-pass and row-quad counts, rows whose cell
groups cut quads and features, the kernel's rule for the quads a group
loads against the model the CPU tests walk, and a round with learned
missing directions and the min-child mask against the plain reference
``tests/torch_gbdt_reference.py``; and the route kernel
(``ops/csrc/route_kernel.cu``) bitwise its plain version at the Higgs
and Bosch shapes, for one and four members, numeric, missing and
categorical splits, over a list mesh's blocks, on odd rows and row
views, with 4,096 nodes, refusing out-of-range rows, and through the
trainer and ``predict_tree`` (its launches counted). Every
test skips where there is no CUDA device.

This file imports neither jax nor the JAX package and uses no fixture of
tests/conftest.py, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses
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
from ytk_mp4j_tpu_torch.ops import leaf_sums as ls
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
    before = (hk.histograms.launches, hk.histograms.row_quads)
    a = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    b = hk.histograms(bins, g, h, nid, n_nodes, F, B)
    ref = hk.histograms_reference(bins, g, h, nid, n_nodes, F, B)
    torch.cuda.synchronize()
    # one group: each launch loads the row's 7 quads once
    assert (hk.histograms.launches, hk.histograms.row_quads) == (
        before[0] + 2, before[1] + 2 * 7)
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
    kernel's repeatable sums, the same per-member streams, and the leaf-sum
    kernel's fixed order of adds give the (2, 2) mesh's trees and margins
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
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 16, 64])
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


@pytest.mark.parametrize("bidir", [False, True])
def test_ring_kernel_global_path_takes_300_members(cuda, bidir):
    """The global path has no co-residency limit and a table wider than a
    byte: 300 members (the old cooperative launch refused any n x blocks
    over the card's occupancy) run every mode, each call twice with no
    synchronize between, bitwise the plain version, one global launch a
    call."""
    n = 300
    counter = rk.ring_kernel_bidir if bidir else rk.ring_kernel
    c = 2 * rk.granule(torch.float32, cuda) * 3
    x = _ring_data(cuda, (n, 4001), torch.float32, 3)
    x[0, 7] = float("nan")
    y = _ring_data(cuda, (n, n * c), torch.float32, 4)
    z = _ring_data(cuda, (n, c), torch.float32, 5)
    calls = [(lambda: rk.ring_allreduce_kernel(x, Operators.MAX, bidir),
              rk.ring_allreduce_reference(x, Operators.MAX, bidir)),
             (lambda: rk.ring_reduce_scatter_kernel(y, Operators.SUM, bidir),
              rk.ring_reduce_scatter_reference(y, Operators.SUM, bidir)),
             (lambda: rk.ring_allgather_kernel(z, bidir),
              rk.ring_allgather_reference(z, bidir))]
    before = _path_counts(counter)
    for call, want in calls:
        first, again = call(), call()
        assert _same(first, want) and _same(again, want)
    assert _path_counts(counter) == (before[0], before[1] + 6)
    assert counter.last_plan.path == "global"


def test_ring_kernel_keeps_the_callers_current_device(cuda):
    """A launch on the last card leaves the current device as it was."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    current = torch.cuda.current_device()
    x = _ring_data(dev, (4, 1001), torch.float32, 4)
    for bidir in (False, True):
        for path in rk.PATHS:
            assert _same(rk.ring_allreduce_kernel(x, bidirectional=bidir,
                                                  path=path),
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
def test_ring_kernel_global_path_refuses_stall_member(cuda, bidir):
    """The global path's blocks never wait on each other: a stall hook
    there is refused before any launch (forced at n = 4, and n = 9 by
    rule); the defaults passed as such, and a spin bound, are no
    refusal."""
    counter = rk.ring_kernel_bidir if bidir else rk.ring_kernel
    for n, path in ((4, "global"), (9, None)):
        x = _ring_data(cuda, (n, 100_000), torch.float32, 2)
        before = counter.launches
        with pytest.raises(Mp4jError, match="stall_member"):
            rk.ring_allreduce_kernel(x, bidirectional=bidir, stall_member=1,
                                     path=path)
        assert counter.launches == before
        assert _same(rk.ring_allreduce_kernel(
            x, bidirectional=bidir, spin_s=0.5, stall_member=-1, path=path),
            rk.ring_allreduce_reference(x, bidirectional=bidir))
        assert counter.last_plan.path == "global"


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


def test_gpu_comm_cluster_nonblocking_family_on_the_card(cuda):
    """The i* twins equal their blocking twins bitwise on the card;
    iallreduce_map is in flight, unresolved, until wait()."""
    rng = np.random.default_rng(3)
    cl = GpuCommCluster(3)
    for name, twin in (("iallreduce", "allreduce_array"),
                       ("ireduce_scatter", "reduce_scatter_array"),
                       ("iallgather", "allgather_array"),
                       ("igather", "gather_array")):
        for operand in (Operands.FLOAT, Operands.LONG):
            host = [rng.integers(1, 3, 1001).astype(operand.dtype)
                    for _ in range(3)]
            want = [a.copy() for a in host]
            getattr(cl, twin)(want, operand)
            got = [a.copy() for a in host]
            getattr(cl, name)(got, operand).wait()
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    maps = [{int(k): float(k) for k in rng.integers(0, 900, 300)}
            for _ in range(3)]
    want = [dict(m) for m in maps]
    cl.allreduce_map(want, Operands.DOUBLE)
    fut = cl.iallreduce_map([dict(m) for m in maps], Operands.DOUBLE)
    assert not fut.done()
    for a, b in zip(fut.wait(), want):
        assert a == b
    cl.wait_all()


def test_in_order_row_adds_repeat_bitwise_on_the_card(cuda):
    """The replicated table's adds over processes (``fm._index_add`` with
    ``in_order``): duplicate rows add in one fixed order, so two runs give
    the same bits -- what keeps every rank's table identical -- and agree
    with the CPU's stream-order ``index_add_`` to rounding: row 17 takes
    666,667 adds, and two f32 orders of that many terms round apart by
    about sqrt(666,667) * 2^-24 = 4.9e-5 of the sum."""
    from ytk_mp4j_tpu_torch.models import fm

    g = torch.Generator().manual_seed(0)
    V = torch.randn(5000, 4, generator=g)
    rows = torch.randint(0, 5000, (2_000_000,), generator=g,
                         dtype=torch.int32)
    rows[::3] = 17                       # one row everywhere
    upd = torch.randn(rows.shape[0], 4, generator=g) * 1e-3
    want = V.clone()
    want.index_add_(0, rows.long(), upd)
    runs = []
    for _ in range(2):
        Vc = V.to(cuda)
        fm._index_add(Vc, rows.to(cuda), upd.to(cuda), in_order=True)
        runs.append(Vc.cpu())
    assert torch.equal(runs[0], runs[1])
    torch.testing.assert_close(runs[0], want, rtol=1e-4, atol=1e-6)


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


# ---- members on a device list (the launch a member at a time) ---------
def _cards(n):
    return ["cuda:0"] * n


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int8,
                                torch.bfloat16], ids=str)
def test_member_launches_equal_packed_and_plain(cuda, dt, n, bidir):
    """Each member a launch of its own (one card, n streams): every mode
    and operator equals the packed launch and the plain version bit for
    bit, the allreduce on both sides of ONE_SHOT_BYTES (one launch a
    member below, two above), and each call counts the launches its plan
    makes."""
    counter = rk.ring_kernel_bidir if bidir else rk.ring_kernel
    item = torch.empty((), dtype=dt).element_size()
    above = rk.ONE_SHOT_BYTES // (n * item) + 3001
    c = 2 * rk.granule(dt, cuda) * 5
    for k, op in enumerate((Operators.SUM, Operators.PROD, Operators.MAX,
                            Operators.MIN)):
        for length in (3001, above):
            x = _ring_data(cuda, (n, length), dt, k)
            before = counter.member_launches
            got = rk.ring_allreduce_kernel(list(x), op, bidir, True)
            rounds = 1 if length == 3001 or n == 1 else 2
            assert counter.last_plan.rounds == rounds
            assert counter.member_launches == before + n * rounds
            assert all(_same(got[r], row) for r, row in enumerate(
                rk.ring_allreduce_kernel(x, op, bidir, True)))
            assert all(_same(got[r], row) for r, row in enumerate(
                rk.ring_allreduce_reference(x, op, bidir, True)))
        x = _ring_data(cuda, (n, n * c), dt, k)
        before = counter.member_launches
        got = rk.ring_reduce_scatter_kernel(list(x), op, bidir, True)
        assert counter.member_launches == before + n
        assert all(_same(got[r], row) for r, row in enumerate(
            rk.ring_reduce_scatter_reference(x, op, bidir, True)))
    x = _ring_data(cuda, (n, c), dt, 9)
    before = counter.member_launches
    got = rk.ring_allgather_kernel(list(x), bidir, True)
    assert counter.member_launches == before + n
    assert all(_same(got[r], row) for r, row in enumerate(
        rk.ring_allgather_reference(x, bidir, True)))
    assert counter.last_plan.path == "member"


def test_member_launch_refusals(cuda):
    """A forced packed path on a list, a forced allreduce form on another
    mode, and the packed launch's spin bound and stall hook are refused
    before any launch."""
    before = rk.ring_kernel.member_launches
    x = _ring_data(cuda, (4, 64), torch.float32, 3)
    with pytest.raises(Mp4jError, match="member path"):
        rk.ring_allreduce_kernel(list(x[:2]), path="global")
    with pytest.raises(Mp4jError, match="forces the form"):
        rk.ring_reduce_scatter_kernel(list(x), path="two_round")
    with pytest.raises(Mp4jError, match="spin_s and stall_member"):
        rk.ring_allreduce_kernel(list(x), spin_s=0.5)
    with pytest.raises(Mp4jError, match="spin_s and stall_member"):
        rk.ring_allreduce_kernel(list(x), stall_member=1)
    assert rk.ring_kernel.member_launches == before


@pytest.mark.parametrize("form", ["one_shot", "two_round"])
def test_member_calls_back_to_back(cuda, form):
    """Calls made one after another with no synchronize between them
    reuse the same events and streams: each call's result is its own
    (the inputs change between the calls), none leaks into the next."""
    n = 4
    xs = [_ring_data(cuda, (n, 100_003), torch.float32, s)
          for s in range(6)]
    got = [rk.ring_allreduce_kernel(list(x), path=form) for x in xs]
    got += [rk.ring_reduce_scatter_kernel(list(x[:, :100_000]))
            for x in xs]
    torch.cuda.synchronize()
    for x, out in zip(xs, got[:6]):
        assert all(_same(o, row) for o, row in zip(
            out, rk.ring_allreduce_reference(x)))
    for x, out in zip(xs, got[6:]):
        assert all(_same(o, row) for o, row in zip(
            out, rk.ring_reduce_scatter_reference(x[:, :100_000])))


def test_gpu_comm_cluster_over_a_device_list(cuda):
    """The dense family under every algo and the map family over a list
    mesh equal the packed cluster bit for bit."""
    lst = GpuCommCluster(mesh=make_mesh(4, devices=_cards(4)))
    packed = GpuCommCluster(4)
    rng = np.random.default_rng(7)
    base = [rng.standard_normal(10_001).astype(np.float32) for _ in range(4)]
    for algo in ("xla", "ring", "rdma"):
        for method in ("allreduce_array", "reduce_scatter_array",
                       "allgather_array"):
            a, b = [x.copy() for x in base], [x.copy() for x in base]
            getattr(lst, method)(a, Operands.FLOAT, algo=algo)
            getattr(packed, method)(b, Operands.FLOAT, algo=algo)
            assert all(np.array_equal(p, q) for p, q in zip(a, b))
    a = [x.copy() for x in base]
    lst.iallreduce(a, Operands.FLOAT, Operators.MAX, algo="rdma").wait()
    assert all(np.array_equal(p, np.max(base, 0)) for p in a)
    maps = [{f"k{(r * 500 + i) % 2000}": float(i) for i in range(1000)}
            for r in range(4)]
    got, want = [dict(m) for m in maps], [dict(m) for m in maps]
    lst.allreduce_map(got, Operands.DOUBLE)
    packed.allreduce_map(want, Operands.DOUBLE)
    assert got == want
    asynced = [dict(m) for m in maps]
    assert lst.allreduce_map_async(asynced, Operands.DOUBLE).result() == want


@pytest.mark.parametrize("path", ["dense", "sparse", "sharded"])
def test_ffm_over_a_device_list(cuda, path):
    """FFM over make_mesh(4, devices=cuda:0 x 4) against the packed
    make_mesh(4) at rtol 1e-5; every member's replica the same bits and
    two runs bitwise on every path (the members' merges and the replicas'
    adds run in one fixed order)."""
    rng = np.random.default_rng(4)
    feats = rng.integers(0, 64, (96, 4)).astype(np.int32)
    data = (feats, np.tile(np.arange(4, dtype=np.int32), (96, 1)),
            np.ones((96, 4), np.float32),
            ((feats[:, 0] + feats[:, 1]) % 2).astype(np.float32))
    cfg = FMConfig(n_features=64, n_fields=4, k=4, max_nnz=4, model="ffm",
                   learning_rate=0.3, l2=1e-3, init_scale=0.1)
    kw = {"dense": {}, "sparse": dict(sparse_grads=True),
          "sharded": dict(sparse_grads=True,
                          table_sharding="sharded")}[path]
    runs = []
    for _ in range(2):
        tr = FMTrainer(cfg, mesh=make_mesh(4, devices=_cards(4)), **kw)
        runs.append((tr,) + tr.fit(*data, n_steps=5, seed=2))
    pk = FMTrainer(cfg, mesh=make_mesh(4), **kw)
    pp, pl = pk.fit(*data, n_steps=5, seed=2)
    tr, lp, ll = runs[0]
    np.testing.assert_allclose(ll, pl, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.full_table(lp), pk.full_table(pp),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ll, runs[1][2])
    np.testing.assert_array_equal(tr.full_table(lp),
                                  runs[1][0].full_table(runs[1][1]))
    k = 2 if path == "sharded" else 3
    for m in tr.replicas_:
        assert all(torch.equal(a, b) for a, b in zip(m[:k],
                                                     tr.replicas_[0][:k]))
    torch.testing.assert_close(tr.predict(lp, *data[:3]),
                               pk.predict(pp, *data[:3]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("loss", ["squared", "logistic", "softmax"])
def test_linear_over_a_device_list(cuda, loss):
    """Linear over cuda:0 x 4 against the packed mesh at rtol 1e-5, every
    replica the same bits."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1001, 6)).astype(np.float32)
    y = {"squared": x @ np.arange(6, dtype=np.float32),
         "logistic": (x[:, 0] > 0).astype(np.float32),
         "softmax": (x[:, 0] > 0).astype(np.int32)
         + (x[:, 1] > 0).astype(np.int32)}[loss]
    cfg = LinearConfig(n_features=6, loss=loss, n_classes=3,
                       learning_rate=0.1, momentum=0.5, l1=1e-3, l2=1e-3)
    tr = LinearTrainer(cfg, mesh=make_mesh(4, devices=_cards(4)))
    lp, ll = tr.fit(x, y, n_steps=10)
    pp, pl = LinearTrainer(cfg, mesh=make_mesh(4)).fit(x, y, n_steps=10)
    np.testing.assert_allclose(ll, pl, rtol=1e-5, atol=1e-6)
    for a, b in zip(lp, pp):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for m in tr.replicas_:
        assert all(torch.equal(a, b) for a, b in zip(m, tr.replicas_[0]))


def test_dryrun_over_a_device_list(cuda):
    """entry.dryrun over cuda:0 x 4 (hierarchical) and x 3 (flat): the
    histogram kernel launched one time a member a level, the ring kernel
    a member at a time (``algo="rdma"``)."""
    for n in (4, 3):
        hist0 = hk.histograms.launches
        ring0 = rk.ring_kernel.member_launches
        entry.dryrun(n, devices=_cards(n))
        torch.cuda.synchronize()
        assert hk.histograms.launches > hist0
        assert rk.ring_kernel.member_launches >= ring0 + n


@pytest.mark.parametrize("sampled", [False, True])
def test_gbdt_over_a_device_list_equals_packed(cuda, sampled):
    """GBDT over make_mesh(4, devices=cuda:0 x 4): one histogram launch a
    member a level with the mesh's fixed-point scale; trees and margins
    bitwise the packed make_mesh(4)'s."""
    bins, y = _gbdt_data(100_003)
    kw = dict(subsample=0.7, colsample=0.6) if sampled else {}
    cfg = GBDTConfig(n_features=28, n_bins=256, depth=4, **kw)
    before = hk.histograms.launches
    lt, lm = GBDTTrainer(cfg, mesh=make_mesh(4, devices=_cards(4))).train(
        bins, y, n_trees=2, seed=5)
    assert hk.histograms.launches == before + 2 * 4 * 4
    pt, pm = GBDTTrainer(cfg, mesh=make_mesh(4)).train(bins, y, n_trees=2,
                                                      seed=5)
    assert torch.equal(lm, pm)
    for a, b in zip(lt, pt):
        assert all(torch.equal(a[k], b[k]) for k in range(4))


# ---- the leaf-sum kernel (ops/csrc/leaf_sums.cu) ------------------------
def _leaf_inputs(dev, N, n_leaves, seed=0, id_lo=0, id_hi=None):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal(N).astype(np.float32),
              rng.random(N).astype(np.float32),
              rng.integers(id_lo, n_leaves if id_hi is None else id_hi,
                           N).astype(np.int32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def _f64_leaf_sums(v, ids, n_leaves, n_members):
    """An f64 sum of each (member, leaf)'s rows, and of their |v|."""
    got = ls.leaf_sums_reference(v, v.abs(), ids, n_leaves, n_members)
    return got[0].cpu(), got[1].cpu()


# a copy a thread up to 64 leaves; a copy a warp at 256 (two a block)
# and 4096 (one); two passes over each tile at 8192
@pytest.mark.parametrize("n_members,n_leaves,N", [
    (1, 64, 1_000_000), (4, 64, 2_000_000), (4, 1, 400_000),
    (3, 256, 300_000), (2, 4096, 200_000), (1, 8192, 300_000)])
def test_leaf_sums_kernel_matches_f64_sums_and_its_model(cuda, n_members,
                                                         n_leaves, N):
    """The kernel against an f64 sum of the same rows at rtol 1e-12 (of
    each leaf's sum of |v|), and bitwise against fixed_order_sums, its
    adds replayed in PyTorch on the CPU; ids -1 and n_leaves among the
    rows."""
    g, h, ids = _leaf_inputs(cuda, N, n_leaves, id_lo=-1,
                             id_hi=n_leaves + 1)
    before = ls.leaf_sums.launches
    got = ls.leaf_sums(g, h, ids, n_leaves, n_members)
    torch.cuda.synchronize()
    assert ls.leaf_sums.launches == before + 1
    model = ls.fixed_order_sums(g.cpu(), h.cpu(), ids.cpu(), n_leaves,
                                n_members)
    for k, v in enumerate((g, h)):
        assert got[k].dtype == torch.float64
        assert got[k].shape == (n_members * n_leaves,)
        assert torch.equal(got[k].cpu(), model[k])
        want, scale = _f64_leaf_sums(v, ids, n_leaves, n_members)
        assert ((got[k].cpu() - want).abs() <= 1e-12 * scale).all()


def test_leaf_sums_two_launches_bitwise_equal_at_full_size(cuda):
    """11M rows over 4 members, 64 leaves: the same bits every launch."""
    g, h, ids = _leaf_inputs(cuda, 11_000_000, 64)
    a = ls.leaf_sums(g, h, ids, 64, 4)
    for _ in range(3):
        b = ls.leaf_sums(g, h, ids, 64, 4)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n_leaves", [64, 256])
def test_leaf_sums_packed_slices_equal_one_call_a_member(cuda, n_leaves):
    """Each member's slice of a packed call is bitwise a call over its
    rows alone, as the list form and a process make it."""
    per = 1_000_003
    g, h, ids = _leaf_inputs(cuda, 4 * per, n_leaves)
    packed = ls.leaf_sums(g, h, ids, n_leaves, 4)
    for m in range(4):
        rows = slice(m * per, (m + 1) * per)
        alone = ls.leaf_sums(g[rows], h[rows], ids[rows], n_leaves)
        cells = slice(m * n_leaves, (m + 1) * n_leaves)
        assert torch.equal(packed[0][cells], alone[0])
        assert torch.equal(packed[1][cells], alone[1])


@pytest.mark.parametrize("n_leaves", [64, 256])
def test_leaf_sums_every_row_in_one_leaf(cuda, n_leaves):
    """Contention's worst case for atomics, and a copy a warp's (every
    lane of a warp in one leaf, 32 rounds): every row in leaf 5."""
    N = 4_000_000
    g, h, _ = _leaf_inputs(cuda, N, n_leaves)
    ids = torch.full((N,), 5, dtype=torch.int32, device=cuda)
    got = ls.leaf_sums(g, h, ids, n_leaves, 4)
    model = ls.fixed_order_sums(g.cpu(), h.cpu(), ids.cpu(), n_leaves, 4)
    for k, v in enumerate((g, h)):
        want, scale = _f64_leaf_sums(v, ids, n_leaves, 4)
        assert ((got[k].cpu() - want).abs() <= 1e-12 * scale).all()
        assert torch.equal(got[k].cpu(), model[k])
        others = torch.arange(n_leaves) != 5
        assert not got[k].view(4, n_leaves)[:, others].any()


@pytest.mark.parametrize("per", [1, 16_383, 16_385, 50_001])
def test_leaf_sums_rows_not_a_multiple_of_a_tile(cuda, per):
    g, h, ids = _leaf_inputs(cuda, 3 * per, 64, seed=per)
    got = ls.leaf_sums(g, h, ids, 64, 3)
    model = ls.fixed_order_sums(g.cpu(), h.cpu(), ids.cpu(), 64, 3)
    assert torch.equal(got[0].cpu(), model[0])
    assert torch.equal(got[1].cpu(), model[1])


def test_leaf_sums_empty_input(cuda):
    before = ls.leaf_sums.launches
    e = torch.zeros(0, device=cuda)
    sg, sh = ls.leaf_sums(e, e, torch.zeros(0, dtype=torch.int32,
                                            device=cuda), 64, 4)
    assert ls.leaf_sums.launches == before
    assert sg.shape == sh.shape == (256,) and not sg.any() and not sh.any()


def test_leaf_sums_non_finite_g_reaches_only_its_leaf(cuda):
    g, h, ids = _leaf_inputs(cuda, 100_000, 64)
    g[17], ids[17] = float("nan"), 9
    g[60_000], ids[60_000] = float("-inf"), 2
    sg, sh = ls.leaf_sums(g, h, ids, 64, 2)
    sg = sg.cpu()
    bad = torch.zeros(128, dtype=torch.bool)
    bad[9] = bad[64 + 2] = True
    assert sg[9].isnan() and sg[64 + 2] == float("-inf")
    assert torch.isfinite(sg[~bad]).all() and torch.isfinite(sh).all()


def test_leaf_sums_one_launch_a_tree_in_the_packed_trainer(cuda):
    """The packed trainer makes one leaf-sum call a tree (every member in
    it), and its leaves follow from those sums."""
    bins, y = _gbdt_data(100_000)
    cfg = GBDTConfig(n_features=28, n_bins=256, depth=6, n_trees=3)
    before = ls.leaf_sums.launches
    GBDTTrainer(cfg, mesh=make_mesh(4)).train(bins, y)
    assert ls.leaf_sums.launches == before + 3
    before = ls.leaf_sums.launches
    GBDTTrainer(cfg, mesh=make_mesh(4, devices=_cards(4))).train(
        bins, y, n_trees=2)
    assert ls.leaf_sums.launches == before + 2 * 4


# ---- wide, mostly-missing rows (the Bosch production-line shape) ----------
def _bosch_bins(dev, N, F=968, stations=52, present=0.19, seed=0):
    """[N, F] int32 bins in station blocks of consecutive features, present
    or missing (bin 0) together, as the Bosch data's are: ~81 % zeros."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    station = torch.arange(F, device=dev) * stations // F
    seen = torch.rand((N, stations), generator=gen, device=dev) < present
    vals = torch.randint(1, 256, (N, F), generator=gen, device=dev,
                         dtype=torch.int32)
    return vals * seen[:, station]


@pytest.mark.parametrize("n_nodes", [1, 16, 64])
def test_kernel_at_the_bosch_width(cuda, n_nodes):
    """F = 968: one node's 247,808 cells in 31 groups of a block's 8,192,
    81 % of the adds on each feature's bin 0. Against the plain version
    (1e-5 of the plane's largest cell), bitwise run to run, and each
    launch counts its 31 passes over the rows and, each pass loading
    only its group's 8 quads (the last 2), the row's 242 quads."""
    N, F, B = 120_000, 968, 256
    bins = _bosch_bins(cuda, N)
    assert 0.8 < (bins == 0).float().mean().item() < 0.82
    _, g, h, nid = _inputs(cuda, N, 1, B, 0, n_nodes + 1, seed=3)
    before = (hk.histograms.launches, hk.histograms.row_passes,
              hk.histograms.row_quads)
    _assert_kernel_ok(bins, g, h, nid, n_nodes, F, B)
    assert (hk.histograms.launches, hk.histograms.row_passes,
            hk.histograms.row_quads) == (
        before[0] + 2, before[1] + 2 * 31, before[2] + 2 * 242)


@pytest.mark.parametrize("n_nodes", [1, 16])
@pytest.mark.parametrize("F,B,quads", [
    (967, 256, 242),     # F * 4 not a multiple of 16: element loads
    (1001, 255, 282),    # groups of 8,192 cells end inside a feature
])
def test_kernel_on_wide_rows_cut_inside_quads(cuda, F, B, quads, n_nodes):
    """Wide rows whose groups do not fall on quad boundaries: the quads a
    group shares with its neighbour are loaded by both, and the elements
    outside each group dropped. Against the plain version (1e-5 of the
    plane's largest cell) and bitwise run to run; each launch counts the
    quads its groups load. At B = 255 the bins of 255 lie outside the
    range and add nothing."""
    N = 120_000
    bins = _bosch_bins(cuda, N, F=F, seed=6)
    _, g, h, nid = _inputs(cuda, N, 1, B, 0, n_nodes + 1, seed=7)
    before = hk.histograms.row_quads
    _assert_kernel_ok(bins, g, h, nid, n_nodes, F, B)
    assert hk.histograms.row_quads == before + 2 * quads


@pytest.mark.parametrize("N,F,B,n_nodes,smem", [
    (11_000_000, 28, 256, 1, 227 * 1024),
    (11_000_000, 28, 256, 16, 227 * 1024),     # lists of one node
    (1_183_748, 968, 256, 4, 227 * 1024),      # the Bosch width
    (100_000, 967, 256, 4, 227 * 1024),        # F * 4 not a multiple of 16
    (100_000, 1001, 255, 2, 227 * 1024),       # groups end inside features
    (400, 4, 40, 3, 16 * 60),                  # a node over three groups
    (300, 13, 8, 2, 16 * 20),                  # groups cut features, quads
    (700, 5, 7, 3, 16 * 36),
    (500, 1, 4, 2, 16 * 3),                    # groups inside a feature
    (300, 4, 8, 4, 16 * 64),                   # lists of two nodes
])
def test_kernel_quad_rule_is_the_model(cuda, N, F, B, n_nodes, smem):
    """The quads the kernel loads in each group, by its own rule compiled
    for the host (what ``histograms.row_quads`` counts), are those of
    ``group_quads``, the model the CPU tests check and walk."""
    geo = hk.launch_geometry(N, F, B, n_nodes, smem, lambda cells: 132)
    assert list(hk.kernel_group_quads(geo, F, B)) == hk.group_quads(
        geo, F, B)


def test_a_bosch_round_on_the_card_against_the_plain_reference(cuda):
    """Two rounds at the Bosch width and reduced rows, missing_bin and
    min_child_hessian 1 through make_mesh(4), against
    tests/torch_gbdt_reference.py (on the CPU) as the CPU test
    tests/test_torch_gbdt_missing_wide.py holds the plain path: round 0's
    splits equal, round 1's first two levels equal and the rest within
    1e-5 of the best gain; leaves within 2e-5 of the largest. Bitwise run
    to run."""
    import torch_gbdt_reference as R
    from ytk_mp4j_tpu_torch.models import gbdt

    N, F, B, depth = 60_001, 968, 256, 5
    bins = _bosch_bins(cuda, N, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.where(bins[:, :8] > 0, bins[:, :8] / 255 - 0.5, 0.0)
    w = torch.tensor([4.0 * (-1) ** j / (j + 1) for j in range(8)],
                     device=cuda)
    y = (torch.rand(N, generator=gen, device=cuda)
         < torch.sigmoid(4.0 * (x * w).sum(1) - 1.0)).float()
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=depth, loss="logistic",
                     missing_bin=True, min_child_hessian=1.0, n_trees=2)
    dbins, dy, zero, dw = GBDTTrainer(cfg, mesh=make_mesh(4)).shard_data(
        bins, y)

    def two_rounds():
        preds, out = zero, []
        for _ in range(2):
            new, tree = gbdt.train_tree_shard(dbins, dy, preds, cfg,
                                              weights=dw, n_members=4)
            out.append((preds, new, tree))
            preds = new
        return out

    first, again = two_rounds(), two_rounds()
    for a, b in zip(first, again):
        assert torch.equal(a[1], b[1])
        assert all(torch.equal(a[2][k], b[2][k]) for k in range(4))
    cb, cy, cw = dbins.cpu(), dy.cpu(), dw.cpu()
    kw = dict(depth=depth, n_bins=B, learning_rate=cfg.learning_rate,
              reg_lambda=cfg.reg_lambda,
              min_child_hessian=cfg.min_child_hessian)
    for r, (preds, new, tree) in enumerate(first):
        preds, tree = preds.cpu(), tuple(t.cpu() for t in tree)
        _, own, _ = R.boosting_round(cb, cy, preds, cw, **kw)
        want, ref_tree, scores = R.boosting_round(
            cb, cy, preds, cw, follow=tree, mask_slack=2e-5, **kw)
        frozen = own[1] == B - 1
        exact = len(frozen) if r == 0 else 3
        for i in range(exact):
            assert ((tree[0][i], tree[1][i], tree[2][i])
                    == (own[0][i], own[1][i], own[2][i])
                    or (frozen[i] and tree[1][i] == B - 1
                        and tree[2][i] == 0)), i
        assert float(R.regret(scores).max()) <= 1e-5
        scale = ref_tree[3].abs().max().item()
        torch.testing.assert_close(tree[3].double(), ref_tree[3], rtol=0,
                                   atol=2e-5 * scale)
        torch.testing.assert_close(new.cpu().double(), want, rtol=0,
                                   atol=2e-5 * scale * cfg.learning_rate
                                   + 1e-6 * want.abs().max().item())


# ---- the route kernel (ops/csrc/route_kernel.cu) ------------------------
_ROUTE_ROWS = {}


def _route_rows(dev, shape):
    """The Higgs rows (11M x 28, uniform bins) or the Bosch rows
    (1,183,748 x 968, 81 % bin 0), made once for the route tests."""
    if shape not in _ROUTE_ROWS:
        _ROUTE_ROWS.clear()
        torch.cuda.empty_cache()
        if shape == "higgs":
            gen = torch.Generator(device=dev).manual_seed(8)
            _ROUTE_ROWS[shape] = torch.randint(
                0, 256, (11_000_000, 28), generator=gen, device=dev,
                dtype=torch.int32)
        else:
            _ROUTE_ROWS[shape] = _bosch_bins(dev, 1_183_748, seed=8)
    return _ROUTE_ROWS[shape]


def _route_tables(dev, N, F, n_nodes, kind, seed):
    """Random node ids and split tables, a quarter of the nodes frozen
    (bin B - 1, dir 0), and the [F] categorical mask where asked for."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    nid, feat, bin_, dir_ = (ints(0, n_nodes, N), ints(0, F, n_nodes),
                             ints(0, 255, n_nodes), ints(0, 2, n_nodes))
    frozen = torch.arange(n_nodes, device=dev) % 4 == 3
    bin_ = torch.where(frozen, 255, bin_)
    dir_ = torch.where(frozen, 0, dir_)
    cat = (torch.arange(F, device=dev) % 3 == 0 if kind == "categorical"
           else None)
    return nid, feat, bin_, dir_, cat, kind == "missing"


def _assert_route_equals_plain(bins, args, members):
    """Both outputs of the kernel bitwise the plain version's, with and
    without histogram ids; two launches."""
    from ytk_mp4j_tpu_torch.ops import route_kernel as rt

    before = rt.route.launches
    nxt, ids = rt.route(bins, *args, members)
    alone = rt.route(bins, *args)
    assert rt.route.launches == before + 2
    want_nxt, want_ids = rt.route_reference(bins, *args, members)
    assert torch.equal(nxt, want_nxt) and torch.equal(alone, want_nxt)
    assert torch.equal(ids, want_ids)
    return nxt, ids


@pytest.mark.parametrize("shape", ["higgs", "bosch"])
@pytest.mark.parametrize("members", [1, 4])
@pytest.mark.parametrize("kind", ["numeric", "missing", "categorical"])
@pytest.mark.parametrize("n_nodes", [1, 32])
def test_route_kernel_equals_plain_at_full_size(cuda, shape, members, kind,
                                                n_nodes):
    """At the Higgs and the Bosch shapes, numeric splits, learned missing
    directions and a categorical mask, a quarter of the nodes frozen: the
    next node ids and the next level's histogram ids (member-offset left
    children, the sentinel for right ones) bitwise the plain version's."""
    bins = _route_rows(cuda, shape)
    N, F = bins.shape
    nid, feat, bin_, dir_, cat, missing = _route_tables(
        cuda, N, F, n_nodes, kind, seed=n_nodes + members)
    _assert_route_equals_plain(
        bins, (nid, feat, bin_, dir_, cat, missing, 256), members)


@pytest.mark.parametrize("shape", ["higgs", "bosch"])
def test_route_kernel_list_mesh_blocks(cuda, shape):
    """The list mesh routes each member's rows in a call of its own, with
    no member offset: each call bitwise the plain version, and its left
    children's ids the packed call's less the member's offset."""
    bins = _route_rows(cuda, shape)
    N, F = bins.shape
    nid, feat, bin_, dir_, cat, _ = _route_tables(cuda, N, F, 16, "missing",
                                                  seed=3)
    args = (feat, bin_, dir_, cat, True, 256)
    packed = _assert_route_equals_plain(bins, (nid, *args), 4)
    per = N // 4
    for m in range(4):
        rows = slice(m * per, (m + 1) * per)
        nxt, ids = _assert_route_equals_plain(bins[rows], (nid[rows], *args),
                                              1)
        assert torch.equal(nxt, packed[0][rows])
        left = nxt % 2 == 0
        assert torch.equal(ids[left] + m * 16, packed[1][rows][left])
        assert (ids[~left] == 16).all()


@pytest.mark.parametrize("N", [1, 255, 1_025, 70_001])
def test_route_kernel_odd_rows_and_a_row_view(cuda, N):
    """Rows that fill no whole step of a block, from a view of a wider
    table (row stride 40, 28 columns)."""
    wide = torch.randint(0, 256, (N, 40), device=cuda, dtype=torch.int32)
    bins = wide[:, 3:31]
    nid, feat, bin_, dir_, cat, _ = _route_tables(cuda, N, 28, 8,
                                                  "categorical", seed=N)
    _assert_route_equals_plain(bins, (nid, feat, bin_, dir_, cat, True,
                                      256), 1)


def test_route_kernel_tables_past_shared_memory(cuda):
    """4,096 nodes, a deep level's tables (16,384 bytes of feature and bin
    ids each)."""
    N = 1_000_003
    bins = torch.randint(0, 256, (N, 28), device=cuda, dtype=torch.int32)
    nid, feat, bin_, dir_, cat, _ = _route_tables(cuda, N, 28, 4096,
                                                  "categorical", seed=1)
    _assert_route_equals_plain(bins, (nid, feat, bin_, dir_, cat, True,
                                      256), 1)


def test_route_kernel_zero_rows_and_out_of_range_rows(cuda):
    """No launch for zero rows. A row whose node id, or whose node's
    feature, is out of range is refused, as the plain version refuses it;
    without the check (a caller whose tables are in range by
    construction) it goes nowhere: next id -1, histogram id the sentinel.
    ``predict_tree`` refuses a tree whose features the bins lack."""
    from ytk_mp4j_tpu_torch.models import gbdt
    from ytk_mp4j_tpu_torch.ops import route_kernel as rt

    feat = torch.tensor([0, 1, 9], device=cuda, dtype=torch.int32)
    bin_ = torch.tensor([5, 5, 5], device=cuda, dtype=torch.int32)
    before = rt.route.launches
    e = rt.route(torch.zeros(0, 4, device=cuda, dtype=torch.int32),
                 torch.zeros(0, device=cuda, dtype=torch.int32), feat, bin_,
                 n_members=2)
    assert rt.route.launches == before and e[0].shape == e[1].shape == (0,)
    bins = torch.full((6, 4), 7, device=cuda, dtype=torch.int32)
    for bad in ([0, 1, 2, 0, 0, 1], [0, 1, 0, -1, 3, 1]):
        nid = torch.tensor(bad, device=cuda, dtype=torch.int32)
        with pytest.raises(Mp4jError, match="out of range"):
            rt.route(bins, nid, feat, bin_, n_members=2)
    nid = torch.tensor([0, 1, 2, -1, 3, 1], device=cuda, dtype=torch.int32)
    nxt, ids = rt.route(bins, nid, feat, bin_, n_members=2, check=False)
    assert nxt.tolist() == [1, 3, -1, -1, -1, 3]
    assert ids.tolist() == [6] * 6
    bins[5, 1] = 2
    nid = torch.tensor([0, 1, 0, 1, 0, 1], device=cuda, dtype=torch.int32)
    nxt, ids = rt.route(bins, nid, feat, bin_, n_members=2)
    assert nxt[5].item() == 2 and ids[5].item() == 3 + 1
    cfg = GBDTConfig(n_features=4, n_bins=16, depth=2)
    tree = (torch.tensor([1, 2, 5], device=cuda, dtype=torch.int32),
            torch.full((3,), 3, device=cuda, dtype=torch.int32),
            torch.zeros(3, device=cuda, dtype=torch.int32),
            torch.arange(4, device=cuda, dtype=torch.float32))
    with pytest.raises(Mp4jError, match="out of range"):
        gbdt.predict_tree(bins, tree, cfg)
    fine = (torch.tensor([1, 2, 3], device=cuda, dtype=torch.int32),
            *tree[1:])
    assert gbdt.predict_tree(bins, fine, cfg).shape == (6,)


@pytest.mark.parametrize("mesh", ["packed", "list"])
def test_route_launches_depth_a_round_and_predict(cuda, mesh):
    """The trainer routes with one launch a level a block (depth a round
    packed, depth a member a round over a list), and its trees'
    ``predict_tree`` through the kernel is bitwise the plain version's
    (with depth more launches), with missing directions and a
    categorical feature."""
    from ytk_mp4j_tpu_torch.models import gbdt
    from ytk_mp4j_tpu_torch.ops import route_kernel as rt

    bins, y = _gbdt_data(100_000)
    bins[::3, 2] = 0
    cfg = GBDTConfig(n_features=28, n_bins=256, depth=6, missing_bin=True,
                     categorical_features=(5,))
    blocks = 4 if mesh == "list" else 1
    m = make_mesh(4, devices=_cards(4) if mesh == "list" else None)
    before = rt.route.launches
    trees, _ = GBDTTrainer(cfg, mesh=m).train(bins, y, n_trees=3)
    assert rt.route.launches == before + 3 * cfg.depth * blocks
    dbins = bins.to(cuda)
    for tree in trees:
        before = rt.route.launches
        got = gbdt.predict_tree(dbins, tree, cfg)
        assert rt.route.launches == before + cfg.depth
        plain = gbdt.predict_tree(dbins, tree,
                                  dataclasses.replace(cfg, hist_mode="flat"))
        assert rt.route.launches == before + cfg.depth
        assert torch.equal(got, plain)
