"""The port's routing op (ytk_mp4j_tpu_torch/ops/route_kernel.py) on the
CPU: its plain version's next node ids and next-level histogram ids
against the formula the trainer used before the kernel (routing, then
``where(node % 2 == 0, member * k + node // 2, n * k)``) and against a
loop over the rows in numpy; the wrapper's contract; the trainer handing
each level's histogram call the ids its route wrote; and three boosting
rounds whose trees and margins hash to the digests recorded before the
kernel existed. The CUDA kernel itself is held bitwise against the plain
version in tests/test_torch_gpu.py.

The digests' rounds use the squared loss on labels that are multiples of
1/64, so that every value is a plain IEEE operation (no transcendental
function, whose vectorised rounding may differ between CPUs)."""

import hashlib

import numpy as np
import pytest
import torch

from ytk_mp4j_tpu_torch import GBDTConfig
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models import gbdt as T
from ytk_mp4j_tpu_torch.ops import route_kernel as rk

KINDS = ("numeric", "missing", "categorical", "missing+categorical")


def _level(rng, N, F, B, n_nodes, kind):
    """Bins (a third of them 0, the missing bucket), node ids and the
    level's tables, two of its nodes frozen (bin B - 1, dir 0)."""
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    bins[rng.random((N, F)) < 0.3] = 0
    nid = rng.integers(0, n_nodes, N).astype(np.int32)
    feat = rng.integers(0, F, n_nodes).astype(np.int32)
    bin_ = rng.integers(0, B - 1, n_nodes).astype(np.int32)
    dir_ = rng.integers(0, 2, n_nodes).astype(np.int32)
    frozen = rng.choice(n_nodes, min(2, n_nodes), replace=False)
    bin_[frozen], dir_[frozen] = B - 1, 0
    cat = (np.arange(F) % 2 == 0) if "categorical" in kind else None
    t = [torch.from_numpy(a) for a in (bins, nid, feat, bin_, dir_)]
    return t, cat, "missing" in kind


def _loop(bins, nid, feat, bin_, dir_, cat, missing, B):
    """The routing rule, a row at a time."""
    out = np.empty(len(nid), np.int64)
    for i, k in enumerate(nid):
        f, b = feat[k], bin_[k]
        v = bins[i, f]
        right = v > b
        if missing and v == 0:
            right = dir_[k] > 0
        if cat is not None and cat[f]:
            right = v == b and b != B - 1
        out[i] = 2 * k + right
    return out


@pytest.mark.parametrize("members", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_nodes", [1, 8])
@pytest.mark.parametrize("last", [False, True])
def test_plain_route_equals_the_old_formula(members, kind, n_nodes, last):
    """Next node ids: the routing rule row by row. Histogram ids (below
    the last level): the old trainer's ``where`` on the routed ids, with
    each row's member from its index; none asked for at the last level."""
    N, F, B = 1_000, 5, 8
    rng = np.random.default_rng(members * 100 + n_nodes + 7 * last)
    (bins, nid, feat, bin_, dir_), cat, missing = _level(rng, N, F, B,
                                                         n_nodes, kind)
    args = (bins, nid, feat, bin_, dir_, cat, missing, B)
    alone = T._route_samples(*args)
    assert alone.dtype == torch.int32
    np.testing.assert_array_equal(
        alone.numpy(), _loop(*(a.numpy() if isinstance(a, torch.Tensor)
                               else a for a in args)))
    if last:
        return
    nxt, ids = T._route_samples(*args, n_members=members)
    assert torch.equal(nxt, alone) and ids.dtype == torch.int32
    member = torch.arange(N, dtype=torch.int32) // (N // members)
    left = nxt // 2 + (member * n_nodes if members > 1 else 0)
    want = torch.where(nxt % 2 == 0, left, members * n_nodes)
    assert torch.equal(ids, want)
    right = nxt % 2 == 1
    assert (ids[right] == members * n_nodes).all()
    assert (ids[~right] < members * n_nodes).all()


@pytest.mark.parametrize("members", [None, 1, 4])
def test_route_on_the_cpu_is_the_plain_version(members):
    """``route`` on CPU tensors returns the plain version's ids and
    launches nothing; ``plain=True`` takes the same path."""
    rng = np.random.default_rng(3)
    (bins, nid, feat, bin_, dir_), cat, _ = _level(
        rng, 400, 6, 16, 4, "missing+categorical")
    before = rk.route.launches
    got = rk.route(bins, nid, feat, bin_, dir_, cat, True, 16, members)
    want = rk.route_reference(bins, nid, feat, bin_, dir_, cat, True, 16,
                              members)
    plain = T._route_samples(bins, nid, feat, bin_, dir_, cat, True, 16,
                             members, plain=True)
    assert rk.route.launches == before
    for x in (got, plain):
        if members is None:
            assert torch.equal(x, want)
        else:
            assert all(torch.equal(a, b) for a, b in zip(x, want))


def _check_args(**change):
    N, F, n = 8, 3, 2
    args = dict(bins=torch.zeros(N, F, dtype=torch.int32),
                node_ids=torch.zeros(N, dtype=torch.int32),
                feat=torch.zeros(n, dtype=torch.int32),
                bin_=torch.zeros(n, dtype=torch.int32),
                dir_=torch.zeros(n, dtype=torch.int32), cat=None,
                missing_bin=True, n_bins=4, n_members=2)
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    (dict(bins=torch.zeros(8, 3, dtype=torch.int64)), "bins must be"),
    (dict(bins=torch.zeros(3, 8, dtype=torch.int32).t()), "bins must be"),
    (dict(node_ids=torch.zeros(7, dtype=torch.int32)), "node_ids must"),
    (dict(feat=torch.zeros(2, dtype=torch.int64)), "feat must"),
    (dict(bin_=torch.zeros(3, dtype=torch.int32)), r"bin_ must"),
    (dict(dir_=None), "needs dir_"),
    (dict(cat=torch.zeros(3, dtype=torch.bool), n_bins=None),
     "needs n_bins"),
    (dict(cat=torch.zeros(2, dtype=torch.bool)), "cat_mask must"),
    (dict(n_members=3), "do not split"),
    (dict(node_ids=torch.zeros(16, dtype=torch.int32)[::2]),
     "must be contiguous"),
])
def test_route_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    with pytest.raises(Mp4jError, match=match):
        rk._check_inputs(**_check_args(**change))


def test_route_wrapper_takes_a_row_view():
    """A view of rows (row stride larger than F, columns contiguous), as
    a slice of a wider table, and dir_ unused without missing_bin."""
    rk._check_inputs(**_check_args(bins=torch.zeros(8, 5,
                                                    dtype=torch.int32)[:, :3],
                                   dir_=None, missing_bin=False))


def _bins_y(N, F, B, seed, missing):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.int32)
    if missing:
        bins[rng.random((N, F)) < 0.4] = 0
    y = (rng.integers(-64, 65, N) / 64.0).astype(np.float32)
    return torch.from_numpy(bins), torch.from_numpy(y)


# (members, list of members, GBDTConfig changes) of each recorded case
CASES = {
    "one": (1, False, {}),
    "four": (4, False, {}),
    "four-missing-cat": (4, False, dict(missing_bin=True,
                                        categorical_features=(1,),
                                        min_child_hessian=1.0)),
    "four-sampled": (4, False, dict(subsample=0.75)),
    "list-missing": (4, True, dict(missing_bin=True)),
}


def _three_rounds(case):
    """sha256 of three rounds' trees and margins over ``train_tree_shard``
    at 4,096 x 6 rows, 16 bins, depth 4 (the sampled case's rows kept by
    each member's own generator)."""
    members, listed, extra = CASES[case]
    cfg = GBDTConfig(n_features=6, n_bins=16, depth=4, learning_rate=0.25,
                     loss="squared", **extra)
    bins, y = _bins_y(4_096, 6, 16, 11, cfg.missing_bin)
    preds = torch.zeros_like(y)
    if listed:
        bins, y, preds = (list(t.chunk(members)) for t in (bins, y, preds))
    gens = (T.member_generators(3, members, "cpu") if cfg.subsample < 1
            else None)
    digest = hashlib.sha256()
    for _ in range(3):
        preds, tree = T.train_tree_shard(bins, y, preds, cfg,
                                         generators=gens, n_members=members)
        for t in tree:
            digest.update(t.contiguous().numpy().tobytes())
    margins = torch.cat(preds) if listed else preds
    digest.update(margins.contiguous().numpy().tobytes())
    return digest.hexdigest()


# the trees and margins before routing wrote the histogram ids; "one" and
# "four" agree, the members' exact sums folding to the same tree
PARENT_DIGESTS = {
    "one": "9a942c68e63abdf737d15a3d0a2b28a431dca9aecc47e3f8a3f163ecd28dcfae",
    "four": "9a942c68e63abdf737d15a3d0a2b28a431dca9aecc47e3f8a3f163ecd28dcfae",
    "four-missing-cat":
        "bca04715f08344ca3a5bc8636f8d41d7a1b84810353fdccbfcdda0b1e4905a23",
    "four-sampled":
        "f1bd5e064232b1410aa559dca1f3f13e62172926d83f1219021fe568f5104008",
    "list-missing":
        "c817683b3867f0978d906e1b0420b2840e6f4bb574a8ce898453e7fa06cb4ce3",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_rounds_equal_the_digests_before_the_kernel(case):
    assert _three_rounds(case) == PARENT_DIGESTS[case]


@pytest.mark.parametrize("members", [1, 4])
def test_each_level_histograms_the_ids_its_route_wrote(members,
                                                       monkeypatch):
    """Below the root, each histogram call takes the ids the level above
    routed its rows to, which are the old formula on that level's node
    ids; the last level's route asks for none."""
    cfg = GBDTConfig(n_features=6, n_bins=16, depth=4, loss="squared",
                     missing_bin=True)
    bins, y = _bins_y(2_048, 6, 16, 5, True)
    routes, hists = [], []
    real_route, real_hist = T._route_samples, T.build_histograms

    def route(*args, **kw):
        out = real_route(*args, **kw)
        routes.append((args, out))
        return out

    def hist(bins, g, h, ids, n_nodes, cfg, absmax=None):
        hists.append((ids, n_nodes))
        return real_hist(bins, g, h, ids, n_nodes, cfg, absmax)

    monkeypatch.setattr(T, "_route_samples", route)
    monkeypatch.setattr(T, "build_histograms", hist)
    T.train_tree_shard(bins, y, torch.zeros_like(y), cfg, n_members=members)
    assert len(routes) == len(hists) == cfg.depth
    assert routes[-1][0][8] is None and isinstance(routes[-1][1],
                                                   torch.Tensor)
    member = torch.arange(2_048, dtype=torch.int32) // (2_048 // members)
    for d in range(1, cfg.depth):
        (args, (nxt, ids)), (got, n_ids) = routes[d - 1], hists[d]
        k = 2 ** (d - 1)
        assert got is ids and n_ids == members * k
        left = nxt // 2 + (member * k if members > 1 else 0)
        assert torch.equal(ids, torch.where(nxt % 2 == 0, left,
                                            members * k))
