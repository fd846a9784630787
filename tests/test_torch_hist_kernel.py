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


SMEM_LIMIT = 232_448          # opt-in shared memory a block on an H100


def _h100_resident(cells_per_block):
    """Blocks 132 SMs of 228 KiB hold at once (1 KiB reserved a block)."""
    smem = 16 * cells_per_block
    return 132 * max(1, min(2, 233_472 // (smem + 1024)))


@pytest.mark.parametrize("N,F,B,n_nodes", [
    (11_000_000, 28, 256, 1), (11_000_000, 28, 256, 16),
    (5, 28, 256, 64), (300, 3, 16, 4), (1, 1, 1, 1),
    (2048, 8, 65536, 2), (10_000, 4, 256, 2 ** 12),
    (70_001, 1, 256, 16),                 # F = 1
    (5_000, 3, 256, 8), (3_333, 5, 64, 3),  # F * 4 not a multiple of 16
    (1000, 28, 256, 2),                   # N smaller than a chunk
    (1023, 28, 256, 1), (1025, 28, 256, 4),  # N = chunk -+ 1
    (50_000, 3, 4096, 8),                 # 4096 bins x 8 nodes
])
def test_launch_geometry_covers_every_shape(N, F, B, n_nodes):
    """The work split fits Hopper's limits and owns every (row, cell)
    exactly once: the lists partition the nodes, each list's cell groups
    partition its F * B cells per node, and the blocks' shares partition
    the records (rows) for any record count. No shape is refused at depth
    6 or beyond."""
    geo = hk.launch_geometry(N, F, B, n_nodes, SMEM_LIMIT, _h100_resident)
    assert geo.smem_bytes <= min(SMEM_LIMIT, hk._SMEM_CELLS)
    assert 1 <= geo.blocks <= min(N, _h100_resident(geo.cells_per_block))
    total = n_nodes * F * B
    assert geo.total_cells == total
    npl = geo.nodes_per_list
    assert geo.lists * npl >= n_nodes > (geo.lists - 1) * npl
    if F * B <= geo.cells_per_block:     # whole nodes a list, one group
        assert geo.cell_groups == 1 and geo.cells_per_block == npl * F * B
    else:
        assert npl == 1
    for records in {0, 1, N // 2, N}:
        shares = [hk.block_work(geo, b, records) for b in range(geo.blocks)]
        owned = [r for rows, _ in shares for r in (rows.start, rows.stop)]
        assert owned[0] == 0 and owned[-1] == records
        assert all(a == b for a, b in zip(owned[1:-1:2], owned[2::2]))
        groups = shares[0][1]
        assert all(g_ == groups for _, g_ in shares)
    assert groups[0][0] == 0 and groups[-1][1] == npl * F * B
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(groups,
                                                            groups[1:]))


def test_launch_geometry_follows_what_the_card_holds():
    """The grid is the resident block count (never a second wave) and at
    most one block a row; a list is one node of 28 x 256 cells (112 KiB of
    the 128 KiB a block's cells may take), so the depth-6 tree's deepest
    level, of 16 nodes, has 16 lists."""
    geo = hk.launch_geometry(11_000_000, 28, 256, 1, SMEM_LIMIT,
                             lambda cpb: 132)
    assert (geo.lists, geo.cell_groups, geo.blocks) == (1, 1, 132)
    geo = hk.launch_geometry(11_000_000, 28, 256, 16, SMEM_LIMIT,
                             lambda cpb: 132)
    assert (geo.nodes_per_list, geo.lists, geo.blocks) == (1, 16, 132)
    geo = hk.launch_geometry(7, 28, 256, 2, SMEM_LIMIT, lambda cpb: 132)
    assert geo.blocks == 7
    geo = hk.launch_geometry(1000, 3, 16, 40, SMEM_LIMIT, lambda cpb: 132)
    assert (geo.nodes_per_list, geo.lists) == (40, 1)
    with pytest.raises(Mp4jError):
        hk.launch_geometry(10, 3, 8, 1, 15, lambda cpb: 1)


# ---- a numpy model of the kernel's integer accumulation -----------------
# Each cell is two 32-bit words (lo, hi): the kernel adds an int32 q to lo
# with a 32-bit atomicAdd and, from lo's returned old value, adds the
# carry (q > 0 and the add wrapped) or borrow (q < 0 and it wrapped) to
# hi. lo starts at 2^31. The model replays that rule one add at a time.
BIAS = 1 << 31


def model_add(lo, hi, q):
    """One add of int32 q to (lo, hi) as the kernel does it."""
    if q == 0:
        return lo, hi
    old = lo
    now = (old + q) % (1 << 32)
    if (now < old) if q > 0 else (now > old):
        hi = (hi + (1 if q > 0 else -1)) % (1 << 32)
    return now, hi


def model_value(lo, hi):
    """The block's partial: hi as int32 times 2^32, plus lo, less 2^31."""
    hs = hi - (1 << 32) if hi >= 1 << 31 else hi
    return hs * (1 << 32) + lo - BIAS


def model_sum(qs, order, lo=BIAS, hi=0):
    for i in order:
        lo, hi = model_add(lo, hi, int(qs[i]))
    return model_value(lo, hi)


@pytest.mark.parametrize("case", ["signed", "one_cell_positive",
                                  "one_cell_negative", "alternating",
                                  "full_width"])
def test_split_word_accumulation_equals_int64_sum(rng, case):
    """The carry rule gives the exact int64 sum, bitwise, in any order
    of adds: random signed values, every add into one cell (the kernel's
    worst contention) of one sign or the other, sums that cross zero at
    every add, and values of the full int32 width."""
    lim = 1 << hk.QUANT_BITS
    n = 20_000
    if case == "signed":
        qs = rng.integers(-lim, lim + 1, n)
    elif case == "one_cell_positive":
        qs = np.full(n, lim)
    elif case == "one_cell_negative":
        qs = np.full(n, -lim)
    elif case == "alternating":
        qs = np.where(np.arange(n) % 2 == 0, lim, -lim)
    else:
        qs = rng.integers(-(1 << 31) + 1, 1 << 31, n)
    want = int(qs.astype(np.int64).sum())
    for _ in range(3):
        assert model_sum(qs, rng.permutation(n)) == want


@pytest.mark.parametrize("start", [(1 << 62) - (1 << 40), -(1 << 62),
                                   (1 << 33) * 1000 + 12345])
def test_split_word_accumulation_at_the_bound(rng, start):
    """Partials of N < 2^34 rows of |q| <= 2^28 stay inside 2^62: the
    model starts from a state that holds such a sum and stays exact."""
    assert hk._MAX_ROWS * (1 << hk.QUANT_BITS) <= 1 << 62
    lo = (start + BIAS) % (1 << 32)
    hi = ((start + BIAS) >> 32) % (1 << 32)
    assert model_value(lo, hi) == start
    lim = 1 << hk.QUANT_BITS
    qs = rng.integers(-lim, lim + 1, 5000)
    assert model_sum(qs, range(len(qs)), lo, hi) == start + int(qs.sum())


def _model_kernel(bins, g, h, ids, n_nodes, F, B, smem_limit, resident,
                  rng):
    """The kernel's passes replayed in numpy at a small size: max|g|,
    max|h|; records sorted into one run per list (each run shuffled: the
    scatter's order is free), or rows in place where one list holds every
    row; each block's share of the records, once per group of cells,
    through the carry rule, its sums added at each list's end; the f32
    scaling. Returns ([2, n_nodes, F, B] f32, geometry)."""
    N = bins.shape[0]
    geo = hk.launch_geometry(N, F, B, n_nodes, smem_limit, resident)
    fb, total = F * B, n_nodes * F * B
    npl, cpb = geo.nodes_per_list, geo.cells_per_block
    exps = []
    for v in (g, h):
        vmax = float(np.abs(v).max())
        exps.append(0 if vmax == 0 else
                    hk.QUANT_BITS - np.frexp(np.float32(vmax))[1])

    def record(i):
        node = int(ids[i])
        if not 0 <= node < n_nodes:
            return (i, node, 0, 0)
        return (i, node) + tuple(int(np.rint(np.float64(v[i]) * 2.0 ** e))
                                 for v, e in zip((g, h), exps))

    valid = [i for i in range(N) if 0 <= ids[i] < n_nodes]
    if geo.lists == 1 and len(valid) == N:
        recs, offsets = [record(i) for i in range(N)], [0, N]
    else:
        runs = [[] for _ in range(geo.lists)]
        for i in valid:
            runs[ids[i] // npl].append(record(i))
        offsets = np.cumsum([0] + [len(r) for r in runs]).tolist()
        recs = [x for r in runs for x in rng.permutation(
            np.array(r, dtype=np.int64).reshape(-1, 4)).tolist()]
    acc = np.zeros((2, total), np.int64)
    R = len(recs)
    for b in range(geo.blocks):
        (share, groups) = hk.block_work(geo, b, R)
        for s, (c_lo, c_hi) in enumerate(groups):
            for l in range(geo.lists):
                lo_r = max(share.start, offsets[l])
                hi_r = min(share.stop, offsets[l + 1])
                if lo_r >= hi_r:
                    continue
                ncell = min(c_hi - c_lo, total - l * npl * fb - c_lo)
                words = np.zeros((2, 2, max(ncell, 0)), np.int64)
                words[:, 0] = BIAS
                for row, node, *qs in recs[lo_r:hi_r]:
                    fc = (node - l * npl) * fb - c_lo
                    for f in range(F):
                        cell = fc + f * B + int(bins[row, f])
                        if not (0 <= bins[row, f] < B and 0 <= cell < ncell):
                            continue
                        for p in range(2):
                            words[p, 0, cell], words[p, 1, cell] = model_add(
                                int(words[p, 0, cell]), int(words[p, 1, cell]),
                                qs[p])
                c0 = l * npl * fb + c_lo
                for p in range(2):
                    acc[p, c0:c0 + ncell] += [
                        model_value(int(lo), int(hi))
                        for lo, hi in zip(words[p, 0], words[p, 1])]
    out = np.stack([(acc[p] * 2.0 ** -exps[p]).astype(np.float32)
                    for p in range(2)])
    return out.reshape(2, n_nodes, F, B), geo


@pytest.mark.parametrize("N,F,B,n_nodes,id_lo,id_hi,smem,blocks", [
    (1100, 6, 16, 1, 0, 1, 131_072, 3),     # one list, rows in place
    (1100, 6, 16, 1, 0, 2, 131_072, 3),     # one list, sentinel rows
    (900, 3, 8, 4, -1, 6, 16 * 50, 4),      # lists of two nodes
    (700, 5, 7, 3, 0, 4, 16 * 36, 5),       # F * 4 not a multiple of 16
    (500, 1, 4, 2, 0, 3, 16 * 3, 2),        # F = 1, groups inside a node
    (400, 4, 40, 3, -1, 4, 16 * 60, 3),     # a node over three groups
])
def test_kernel_model_equals_plain_version(rng, N, F, B, n_nodes, id_lo,
                                           id_hi, smem, blocks):
    """The kernel's work split, records and carry rule, replayed in numpy,
    give the plain version's histograms (1e-5 relative to the largest
    cell: one f32 rounding of a sum of values rounded at 2^-28 of their
    max) -- in place and sorted, with lists crossing block shares, groups
    of cells inside a node, out-of-range bins and zero rows."""
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    bins[rng.random((N, F)) < 0.05] = B
    g = rng.standard_normal(N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    g[:7] = h[:7] = 0
    ids = rng.integers(id_lo, id_hi, N).astype(np.int32)
    got, geo = _model_kernel(bins, g, h, ids, n_nodes, F, B, smem,
                             lambda cpb: blocks, rng)
    assert geo.blocks == blocks
    want = _port(bins, g, h, ids, n_nodes, F, B)
    for k in range(2):
        tol = 1e-5 * np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol)


def _quantise(v, vmax):
    """The kernel's q = round(v * 2^e), e = QUANT_BITS - (exponent of
    vmax) (frexp: vmax < 2^exponent), in float64 as the kernel does."""
    e = hk.QUANT_BITS - np.frexp(np.float32(vmax))[1]
    return np.rint(v.astype(np.float64) * 2.0 ** e).astype(np.int64), e


@pytest.mark.parametrize("scale", [1.0, 3e4, 1e-30, 1e-42, 1e30])
def test_quantisation_bounds_and_precision(rng, scale):
    """|q| <= 2^QUANT_BITS for any finite max (subnormals included); the
    fixed-point histogram of a random column is within 1e-5 of the f64
    sum, relative to its largest cell."""
    v = (rng.standard_normal(4096) * scale).astype(np.float32)
    q, e = _quantise(v, float(np.abs(v).max()))
    assert np.abs(q).max() <= 1 << hk.QUANT_BITS
    cells = rng.integers(0, 16, v.size)
    acc = np.zeros(16, np.int64)
    np.add.at(acc, cells, q)
    got = (acc.astype(np.float64) * 2.0 ** -e).astype(np.float32)
    want = np.bincount(cells, weights=v.astype(np.float64), minlength=16)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-5


