"""The port's leaf-sum op (ytk_mp4j_tpu_torch/ops/leaf_sums.py) on the
CPU: the kernel's work split, its fixed order of adds replayed in
PyTorch (``fixed_order_sums``) against the plain version, and the
wrapper's contract. The CUDA kernel itself is held against both in
tests/test_torch_gpu.py.

Values that are small multiples of a power of two sum exactly in float64
in any order, so there the model and the plain version agree bitwise;
normal values agree to 1e-12 of the sum of |v| a leaf (two orders of
float64 adds)."""

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import leaf_sums as ls


def _inputs(rng, N, n_leaves, values="normal", id_lo=0, id_hi=None):
    if values == "dyadic":
        g = rng.integers(-1000, 1001, N) / 64.0
        h = rng.integers(0, 1001, N) / 128.0
    else:
        g = rng.standard_normal(N)
        h = rng.random(N)
    ids = rng.integers(id_lo, n_leaves if id_hi is None else id_hi, N)
    return (torch.from_numpy(g.astype(np.float32)),
            torch.from_numpy(h.astype(np.float32)),
            torch.from_numpy(ids.astype(np.int32)))


def _abs_sums(v, ids, n_leaves, n_members):
    """Sum of |v| of each (member, leaf): the scale of its sum's error."""
    return ls.leaf_sums_reference(v.abs(), v.abs(), ids, n_leaves,
                                  n_members)[0]


# per = 40,000 rows a member: three tiles of 16,384 rows, the last one
# short; a copy a thread up to 64 leaves, a copy a warp (two a block)
# at 256; at 4096 leaves one copy a block fills the budget, in tiles of
# 8192 rows; at 8192 the leaves form two groups
@pytest.mark.parametrize("values", ["dyadic", "normal"])
@pytest.mark.parametrize("n_leaves,per,lanes,groups,tiles", [
    (1, 40_000, 1, 1, 3), (64, 40_000, 1, 1, 3), (256, 40_000, 32, 1, 3),
    (4096, 20_000, 32, 1, 3), (8192, 20_000, 32, 2, 3)])
@pytest.mark.parametrize("n_members", [1, 3, 4])
def test_model_equals_plain_version(rng, n_members, n_leaves, per, lanes,
                                    groups, tiles, values):
    """The kernel's tiles, its copies' turns, its halving folds and its
    fold over the tiles, replayed in float64, give the plain version's
    sums: bitwise on dyadic values, to 1e-12 of the sum of |v| a leaf on
    normal ones."""
    N = n_members * per
    g, h, ids = _inputs(rng, N, n_leaves, values)
    got = ls.fixed_order_sums(g, h, ids, n_leaves, n_members)
    want = ls.leaf_sums_reference(g, h, ids, n_leaves, n_members)
    geo = ls.launch_geometry(per, n_leaves)
    assert (geo.lanes, geo.groups, geo.tiles) == (lanes, groups, tiles)
    for k, v in enumerate((g, h)):
        assert got[k].shape == (n_members * n_leaves,)
        assert got[k].dtype == torch.float64
        if values == "dyadic":
            assert torch.equal(got[k], want[k])
        else:
            tol = 1e-12 * _abs_sums(v, ids, n_leaves, n_members)
            assert ((got[k] - want[k]).abs() <= tol).all()


@pytest.mark.parametrize("n_leaves", [1, 64, 256, 4096])
def test_model_order_depends_only_on_a_rows_place_in_its_member(rng,
                                                                n_leaves):
    """A member's sums in a packed call of four members are bitwise its
    sums in a call of its own (the list form, a process's member): every
    add's place follows from the row's position in its member."""
    per = 33_333 if n_leaves <= 256 else 7_777
    g, h, ids = _inputs(rng, 4 * per, n_leaves)
    packed = ls.fixed_order_sums(g, h, ids, n_leaves, 4)
    for m in range(4):
        rows = slice(m * per, (m + 1) * per)
        alone = ls.fixed_order_sums(g[rows], h[rows], ids[rows], n_leaves)
        cells = slice(m * n_leaves, (m + 1) * n_leaves)
        for k in range(2):
            assert torch.equal(packed[k][cells], alone[k])


@pytest.mark.parametrize("per", [0, 1, 16_383, 16_384, 16_385, 2_750_000,
                                 11_000_000])
@pytest.mark.parametrize("n_leaves", [1, 2, 64, 65, 128, 129, 256, 4096,
                                      1 << 16])
def test_launch_geometry_covers_every_shape(per, n_leaves):
    """Every row in exactly one tile and every leaf in exactly one group,
    the copies within their budget, one or two warps a block, a copy a
    thread or a warp; a tile whole rows a thread, at least
    ROWS_PER_THREAD of them, and ROWS_PER_LEAF rows a leaf unless the
    member would make fewer than MIN_BLOCKS blocks. The work split
    follows the leaves and the rows a member holds alone."""
    geo = ls.launch_geometry(per, n_leaves)
    assert geo.threads in (ls.WARP, ls.THREADS)
    assert geo.lanes in (1, ls.WARP)
    assert geo.copies * geo.lanes == geo.threads
    assert geo.smem_bytes <= ls._SMEM_SLOTS
    assert geo.smem_bytes == geo.leaves_per_group * geo.copies * 16
    assert 1 <= geo.leaves_per_group <= n_leaves
    assert (geo.groups - 1) * geo.leaves_per_group < n_leaves
    assert geo.groups * geo.leaves_per_group >= n_leaves
    assert geo.tile_rows % geo.threads == 0
    assert geo.tile_rows >= geo.threads * ls.ROWS_PER_THREAD
    if geo.tile_rows > geo.threads * ls.ROWS_PER_THREAD:
        # the least of ROWS_PER_LEAF rows a leaf and the tile that gives
        # MIN_BLOCKS blocks, rounded up to whole rows a thread
        want = min(ls.ROWS_PER_LEAF * n_leaves,
                   -(-per * geo.groups // ls.MIN_BLOCKS))
        assert geo.tile_rows - geo.threads < want <= geo.tile_rows
    assert geo.tiles * geo.tile_rows >= per
    assert per == 0 or (geo.tiles - 1) * geo.tile_rows < per
    if n_leaves <= 64:              # a copy a thread, one group
        assert (geo.threads, geo.lanes, geo.groups) == (ls.THREADS, 1, 1)
    elif n_leaves <= 2048:          # a copy a warp, two warps, one group
        assert (geo.threads, geo.lanes, geo.groups) == (64, ls.WARP, 1)
    else:                           # one warp, its copy filling the budget
        assert (geo.threads, geo.copies) == (ls.WARP, 1)
        assert geo.leaves_per_group == min(n_leaves, 4096)


def test_launch_geometry_at_the_main_paths_shape():
    """The benchmark's dp4 shape (4 members of 2.75M rows, depth 6) and
    one member of 11M rows: 64 threads a block, one pass, tiles of
    16,384 rows."""
    assert ls.launch_geometry(2_750_000, 64) == ls.Geometry(
        64, 1, 64, 64, 1, 16_384, 168, 65_536)
    assert ls.launch_geometry(11_000_000, 64).tiles == 672
    with pytest.raises(Mp4jError):
        ls.launch_geometry(10, 0)


def test_cpu_tensors_take_the_plain_version(rng):
    """On the CPU the wrapper computes its plain version and counts no
    launch."""
    g, h, ids = _inputs(rng, 3000, 8)
    before = ls.leaf_sums.launches
    got = ls.leaf_sums(g, h, ids, 8, 3)
    want = ls.leaf_sums_reference(g, h, ids, 8, 3)
    assert ls.leaf_sums.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n_members", [1, 4])
def test_plain_version_is_the_trainers_former_index_add(rng, n_members):
    """The plain version is the trainer's former leaf sums, moved: f64
    ``index_add`` of each row into ``member * n_leaves + id``, bitwise."""
    n_leaves, per = 16, 500
    g, h, ids = _inputs(rng, n_members * per, n_leaves)
    seg = (ids.long()
           + torch.arange(n_members * per) // per * n_leaves)
    zeros = torch.zeros(n_members * n_leaves, dtype=torch.float64)
    got = ls.leaf_sums_reference(g, h, ids, n_leaves, n_members)
    assert torch.equal(got[0], zeros.index_add(0, seg, g.double()))
    assert torch.equal(got[1], zeros.index_add(0, seg, h.double()))


@pytest.mark.parametrize("fn", [ls.leaf_sums_reference, ls.fixed_order_sums])
def test_out_of_range_ids_contribute_nothing(rng, fn):
    """Ids below 0 or at and past n_leaves add nothing: the sums equal
    those of the same rows with those rows' g and h zero in leaf 0."""
    n_leaves, n_members, per = 8, 2, 20_000
    g, h, ids = _inputs(rng, n_members * per, n_leaves, id_lo=-3,
                        id_hi=n_leaves + 3)
    ids[:5] = torch.tensor([-(1 << 31), (1 << 31) - 1, n_leaves, -1, 1 << 20],
                           dtype=torch.int32)
    out = (ids < 0) | (ids >= n_leaves)
    got = fn(g, h, ids, n_leaves, n_members)
    want = fn(torch.where(out, 0.0, g), torch.where(out, 0.0, h),
              torch.where(out, 0, ids), n_leaves, n_members)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("fn", [ls.leaf_sums_reference, ls.fixed_order_sums])
def test_non_finite_g_reaches_only_its_leaf(rng, fn):
    n_leaves, n_members, per = 8, 2, 5000
    g, h, ids = _inputs(rng, n_members * per, n_leaves)
    g[7], ids[7] = float("nan"), 3
    g[per + 9], ids[per + 9] = float("inf"), 5
    got = fn(g, h, ids, n_leaves, n_members)
    bad = torch.zeros(n_members * n_leaves, dtype=torch.bool)
    bad[3] = bad[n_leaves + 5] = True
    assert got[0][3].isnan() and got[0][n_leaves + 5] == float("inf")
    assert torch.isfinite(got[0][~bad]).all() and torch.isfinite(got[1]).all()


@pytest.mark.parametrize("n_members", [1, 4])
def test_empty_input_returns_zeros(n_members):
    e = torch.zeros(0)
    for fn in (ls.leaf_sums, ls.fixed_order_sums):
        sg, sh = fn(e, e, torch.zeros(0, dtype=torch.int32), 8, n_members)
        assert sg.shape == sh.shape == (8 * n_members,)
        assert not sg.any() and not sh.any()


def _good(N=16):
    return torch.zeros(N), torch.zeros(N), torch.zeros(N, dtype=torch.int32)


@pytest.mark.parametrize("bad", [
    "g_dtype", "h_dtype", "ids_dtype", "h_shape", "g_2d", "strided",
    "no_leaves", "no_members", "uneven_members", "other_device",
])
def test_wrapper_checks_inputs(bad):
    g, h, ids = _good()
    n_leaves, n_members = 4, 2
    if bad == "g_dtype":
        g = g.double()
    elif bad == "h_dtype":
        h = h.half()
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "h_shape":
        h = torch.zeros(15)
    elif bad == "g_2d":
        g = torch.zeros(16, 1)
    elif bad == "strided":
        ids = torch.zeros(32, dtype=torch.int32)[::2]
    elif bad == "no_leaves":
        n_leaves = 0
    elif bad == "no_members":
        n_members = 0
    elif bad == "uneven_members":
        n_members = 3
    else:
        h = h.to("meta")
    with pytest.raises(Mp4jError):
        ls.leaf_sums(g, h, ids, n_leaves, n_members)


def test_other_devices_raise_not_fall_back():
    """A tensor that is on neither the CPU nor a CUDA card is refused;
    the wrapper never computes the plain version for it."""
    g, h, ids = (t.to("meta") for t in _good())
    with pytest.raises(Mp4jError, match="cpu or cuda"):
        ls.leaf_sums(g, h, ids, 4, 2)
