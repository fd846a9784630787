"""GBDT on wide, mostly-missing rows (the Bosch production-line shape at a
small size): the port's round against the plain float64 reference
``tests/torch_gbdt_reference.py``, with the learned missing direction and
the min-child mask, on one member and on four; the histogram kernel's
work split at the Bosch width; and the spans and counters that say what
such a round did.

Rows pass through stations, blocks of consecutive features that are
present or missing together (bin 0 is the missing bucket), as the
Bosch data's stations are; about 80 % of the values are missing.
"""

import pytest
import torch
import torch.distributed as dist

import torch_gbdt_reference as R
from ytk_mp4j_tpu_torch.comm import distributed as D
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.models import gbdt
from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig, GBDTTrainer
from ytk_mp4j_tpu_torch.obs import spans
from ytk_mp4j_tpu_torch.ops import hist_kernel as hk

STATIONS, PER_STATION = 8, 5        # F = 40 features in 8 station blocks
N = 2002                            # not a multiple of 4: a padding row
PRESENT = 0.2                       # a station is passed with this chance
WEIGHTS = [4.0 * (-1) ** j / (j + 1) for j in range(8)]


def _data(seed, n_bins):
    """[N, F] int32 bins with station-block missingness and {0, 1} labels
    drawn from a logistic function of the first present features."""
    gen = torch.Generator().manual_seed(seed)
    F = STATIONS * PER_STATION
    present = torch.rand((N, STATIONS), generator=gen) < PRESENT
    vals = torch.randint(1, n_bins, (N, F), generator=gen, dtype=torch.int32)
    bins = vals * present.repeat_interleave(PER_STATION, 1)
    x = torch.where(bins[:, :8] > 0, bins[:, :8] / (n_bins - 1) - 0.5, 0.0)
    p = torch.sigmoid(4.0 * (x * torch.tensor(WEIGHTS)).sum(1))
    y = (torch.rand(N, generator=gen) < p).to(torch.float32)
    return bins, y


def _cfg(n_bins, depth):
    return GBDTConfig(n_features=STATIONS * PER_STATION, n_bins=n_bins,
                      depth=depth, loss="logistic", missing_bin=True,
                      min_child_hessian=1.0, n_trees=2)


def test_the_data_is_mostly_missing_in_station_blocks():
    bins, _ = _data(0, 256)
    assert 0.75 < (bins == 0).float().mean().item() < 0.85
    blocks = (bins == 0).reshape(N, STATIONS, PER_STATION)
    assert bool((blocks.all(-1) | ~blocks.any(-1)).all())


# f32 sums and gains: a split within this of the best gain ties it, and a
# child's hessian sum is rounded by up to MASK_SLACK of its node's (a
# cumulative f32 sum over 256 bins: 255 x 6e-8 = 1.5e-5 at most)
ROUNDING, MASK_SLACK = 1e-5, 2e-5


@pytest.mark.parametrize("members", [1, 4])
@pytest.mark.parametrize("n_bins,depth,seed", [(16, 4, 0), (16, 4, 1),
                                                (256, 3, 2), (256, 3, 3)])
def test_rounds_equal_the_plain_reference(n_bins, depth, seed, members):
    """Two rounds from zero margins, each against the reference from the
    port's input margins.

    Round 0: every split (feature, bin, direction; a frozen node's bin and
    direction) equals the reference's. Round 1: the first two levels' do;
    below them a node of a few dozen rows may hold two splits whose gains
    tie to float32 rounding (the port takes g and h in f32 and derives right
    children by an f32 subtraction), so a split that differs must gain
    within ``ROUNDING`` of the best, where a child whose hessian sum lies
    within ``MASK_SLACK`` of its node's from the mask's threshold may fall
    on either side of it (f32 rounding too).
    Leaves and margins, against the reference routed by the port's tree,
    within 2e-5 of the largest leaf: the port rounds each g and h to f32
    (~6e-8 relative) and the leaf value to f32; f64 keeps the rest."""
    bins, y = _data(seed, n_bins)
    cfg = _cfg(n_bins, depth)
    trainer = GBDTTrainer(cfg, mesh=make_mesh(members, "cpu"))
    dbins, dy, preds, dw = trainer.shard_data(bins, y)
    assert dbins.shape[0] == members * -(-N // members)
    assert float(dw[N:].abs().sum()) == 0.0
    kw = dict(depth=depth, n_bins=n_bins, learning_rate=cfg.learning_rate,
              reg_lambda=cfg.reg_lambda,
              min_child_hessian=cfg.min_child_hessian)
    for r in range(2):
        new, tree = gbdt.train_tree_shard(dbins, dy, preds, cfg, weights=dw,
                                          n_members=members)
        _, own, _ = R.boosting_round(dbins, dy, preds, dw, **kw)
        want, ref_tree, scores = R.boosting_round(
            dbins, dy, preds, dw, follow=tree, mask_slack=MASK_SLACK, **kw)
        frozen = own[1] == n_bins - 1
        assert tree[1][frozen].tolist() == own[1][frozen].tolist()
        same = [(tree[0][i], tree[1][i], tree[2][i]) == (own[0][i], own[1][i],
                                                         own[2][i])
                or (frozen[i] and tree[2][i] == 0) for i in range(len(frozen))]
        exact = len(frozen) if r == 0 else 3       # round 1: levels 0 and 1
        assert all(same[:exact]), same
        assert float(R.regret(scores).max()) <= ROUNDING
        scale = ref_tree[3].abs().max().item()
        torch.testing.assert_close(tree[3].double(), ref_tree[3], rtol=0,
                                   atol=2e-5 * scale)
        torch.testing.assert_close(new.double(), want, rtol=0,
                                   atol=2e-5 * scale * cfg.learning_rate
                                   + 1e-6 * want.abs().max().item())
        preds = new


def test_the_mask_and_the_learned_direction_both_decide_splits():
    """Over the cases above, some node sends the missing bucket right, and
    dropping the mask would change some split: the comparison tests both."""
    rights = masked = 0
    for n_bins, depth, seed in [(16, 4, 0), (16, 4, 1), (256, 3, 2),
                                (256, 3, 3)]:
        bins, y = _data(seed, n_bins)
        w = torch.ones(N)
        kw = dict(depth=depth, n_bins=n_bins, learning_rate=0.1,
                  reg_lambda=1.0)
        _, tree, _ = R.boosting_round(bins, y, torch.zeros(N), w,
                                      min_child_hessian=1.0, **kw)
        _, loose, _ = R.boosting_round(bins, y, torch.zeros(N), w,
                                       min_child_hessian=0.0, **kw)
        frozen = tree[1] == n_bins - 1
        rights += int((tree[2].bool() & ~frozen).sum())
        masked += int(tree[0].tolist() != loose[0].tolist()
                      or tree[1].tolist() != loose[1].tolist())
    assert rights > 0 and masked > 0


def test_the_histogram_kernel_re_reads_a_bosch_row_31_times():
    """At F = 968, B = 256 one node's 247,808 cells do not fit a block's
    8,192: 31 groups, each a pass over the records, at every level, and
    each loading only its own 8 quads of the row (the last group 2): the
    row's 242 quads once in all. The Higgs width (F = 28) fits one group,
    which loads the row's 7 quads."""
    for n_nodes in (1, 4, 16, 64):
        geo = hk.launch_geometry(1_183_748, 968, 256, n_nodes, 227 * 1024,
                                 lambda cells: 132)
        assert (geo.nodes_per_list, geo.cells_per_block,
                geo.cell_groups) == (1, 8192, 31)
        assert geo.lists == n_nodes
        assert hk.group_quads(geo, 968, 256) == [
            (8 * s, min(8 * s + 8, 242)) for s in range(31)]
        higgs = hk.launch_geometry(11_000_000, 28, 256, n_nodes, 227 * 1024,
                                   lambda cells: 132)
        assert higgs.cell_groups == 1
        assert hk.group_quads(higgs, 28, 256) == [(0, 7)]


def test_the_plain_version_counts_no_launch_and_no_row_pass():
    """The counters count the kernel's launches, its passes over the rows
    and the quads of a row they load (checked on the card,
    tests/test_torch_gpu.py); a CPU tensor takes the plain version, which
    launches nothing."""
    bins, y = _data(0, 256)
    counters = ("launches", "row_passes", "row_quads")
    before = [getattr(hk.histograms, c) for c in counters]
    g = torch.randn(N)
    hg, hh = hk.histograms(bins, g, g.abs(), torch.zeros(N, dtype=torch.int32),
                           1, bins.shape[1], 256)
    assert [getattr(hk.histograms, c) for c in counters] == before
    want = R.histograms(bins, g, torch.zeros(N, dtype=torch.int64), 1, 256)
    torch.testing.assert_close(hg.double(), want, rtol=1e-6, atol=1e-6)


@pytest.fixture
def span_ring():
    prior = spans._capacity
    spans.configure(prior or 65536)
    yield
    spans.configure(prior)


@pytest.mark.parametrize("missing_bin", [False, True])
def test_the_splits_span_carries_the_variants_scored(span_ring, missing_bin):
    bins, y = _data(0, 16)
    cfg = GBDTConfig(n_features=bins.shape[1], n_bins=16, depth=3,
                     loss="logistic", missing_bin=missing_bin)
    gbdt.train_tree_shard(bins[:2000], y[:2000], torch.zeros(2000), cfg,
                          n_members=4)
    splits = [s[6] for s in spans.snapshot() if s[0] == "gbdt::splits"]
    assert len(splits) == 3
    assert all(a["variants"] == (2 if missing_bin else 1) for a in splits)


def test_the_exchanges_are_dist_spans(span_ring, tmp_path):
    """A one-rank gloo job: ``all_gather_rows`` and ``all_reduce_`` are
    spans with their bytes, backend and world."""
    D.init_distributed(num_processes=1, process_id=0,
                       init_method=f"file://{tmp_path / 'store'}",
                       device="cpu", timeout=60)
    try:
        spans.clear()
        x = torch.arange(12, dtype=torch.float64).reshape(3, 4)
        assert torch.equal(D.all_gather_rows(x)[0], x)
        D.all_reduce_(torch.ones(5, dtype=torch.int32))
    finally:
        dist.destroy_process_group()
    got = {s[0]: s[6] for s in spans.snapshot() if s[1] == "dist"}
    assert got["dist::all_gather_rows"]["bytes"] == 96
    assert got["dist::all_reduce"]["bytes"] == 20
    for a in got.values():
        assert (a["backend"], a["world"]) == ("gloo", 1)
