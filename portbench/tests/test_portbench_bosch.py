"""The Bosch cell (``gbdt-bosch.dp4``: wide, mostly-missing rows, learned
missing directions, the min-child mask) on the CPU at a size it holds: a
small run is correct and reports its end-to-end metrics, the control
fails the cell's limits, every planted fault makes a run not correct, and
the traced items and their readers."""

import time

import pytest
import torch

from conftest import SEED
from portbench import control, harness

from ytk_mp4j_tpu_torch.models import gbdt
from ytk_mp4j_tpu_torch.ops import hist_kernel

CELL = "gbdt-bosch.dp4"
# 40 features in 8 stations of 5 (the published 968 in 52 need minutes a
# round on one CPU thread); every other key as the configuration has it
SMALL = {"n_rows": 3001, "n_features": 40, "station_sizes": [5] * 8}
BENCH = harness.benchmark()


def small_run(seed=SEED, seconds=0.3, config=None):
    return harness.execute(CELL, seed, seconds, False, time.perf_counter(),
                           device="cpu", look_for_chips=False,
                           config={**SMALL, **(config or {})})


def _driver_state(seed=SEED):
    cell = harness.find_cell(BENCH, CELL)
    spec = cell["spec"]
    ctx = harness.Context(CELL, seed, 1.0, False, "cpu",
                          {**cell["config_file"], **SMALL},
                          spec["traffic"], spec["limits"])
    driver = harness.load("drivers", spec["driver"])
    return driver, driver.setup(ctx)


def test_the_rows_are_mostly_missing_in_station_blocks():
    driver, st = _driver_state()
    bins = st.bins
    assert bins.shape == (3001, 40)
    assert 0.72 < (bins == 0).float().mean().item() < 0.90
    blocks = (bins == 0).reshape(-1, 8, 5)
    assert bool((blocks.all(-1) | ~blocks.any(-1)).all())
    # the trainer pads to 4 equal blocks: one zero-weight row
    assert st.dbins.shape[0] == 3004 and float(st.dw[-3:].sum()) == 0.0


def test_the_seed_orders_rows_within_each_members_block():
    """Every member holds the same rows whatever the seed (so every seed
    trains the same trees); only their order within the block moves."""
    cell = harness.find_cell(BENCH, CELL)
    cfg = {**cell["config_file"], **SMALL}
    driver = harness.load("drivers", "gbdt_missing")
    a, _ = driver.make_data(cfg, 5, torch.device("cpu"), 4)
    b, _ = driver.make_data(cfg, 6, torch.device("cpu"), 4)
    assert not torch.equal(a, b)
    for lo in range(0, 3001, 751):           # blocks of ceil(3001 / 4)
        rows = [sorted(map(tuple, x[lo:lo + 751].tolist())) for x in (a, b)]
        assert rows[0] == rows[1]


def test_the_label_rate_is_the_configured_one():
    cell = harness.find_cell(BENCH, CELL)
    cfg = {**cell["config_file"], **SMALL, "n_rows": 200_000}
    driver = harness.load("drivers", "gbdt_missing")
    _, y = driver.make_data(cfg, 5, torch.device("cpu"))
    assert abs(y.mean().item() - cfg["label_rate"]) < 0.001


def test_a_small_run_is_correct_and_reports_its_metrics():
    out = small_run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "trees_per_s"}
    assert set(out["checks"]) == {"hist_err", "fold_err", "split_regret",
                                  "leaf_err", "margin_err"}


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_control_is_not_correct(seed):
    nums = control.readings(CELL, seed, "cpu", config=SMALL)
    limits = harness.find_cell(BENCH, CELL)["spec"]["limits"]
    assert nums and set(nums[0]) == set(limits)
    assert control.fails(nums, limits)


def missing_direction_flipped(mp):
    real = gbdt.best_splits

    def fault(*a, **k):
        feat, bin_, gain, dir_ = real(*a, **k)
        return feat, bin_, gain, 1 - dir_
    mp.setattr(gbdt, "best_splits", fault)


def min_child_mask_dropped(mp):
    real = gbdt.best_splits

    def fault(hg, hh, lam, feat_mask, mch, *a, **k):
        return real(hg, hh, lam, feat_mask, 0.0, *a, **k)
    mp.setattr(gbdt, "best_splits", fault)


def one_member_left_out_of_the_fold(mp):
    def fault(x, n):
        parts = x.reshape((n, -1) + tuple(x.shape[1:]))
        return parts[:n - 1].sum(0)
    mp.setattr(gbdt, "_fold", fault)


FAULTS = [missing_direction_flipped, min_child_mask_dropped,
          one_member_left_out_of_the_fold]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_fault_makes_the_run_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = small_run()
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


def test_traced_items_count_row_passes_and_route_by_learned_directions():
    driver, st = _driver_state()
    probe = driver.probe(st)
    probe.begin()
    driver.step(st)
    driver.step(st)
    items = probe.end()
    # a CPU run launches no kernel: stand in the card's counts for it
    items["kernel_counts"] = (12, 12 * 31)
    got = driver.traced_items(st, items)
    assert got["trees"] == 2 and got["hist_row_passes"] == 31.0
    calls = got["hist_calls"]
    assert len(calls) == 2 * 6 and calls[0] == (3004, 3004, 4)
    # each level's in-range rows are those the tree sent left, missing
    # rows by the node's learned direction
    tree = items["trees"][0]
    node = torch.zeros(3004, dtype=torch.int64)
    start = 0
    for d in range(5):
        lvl = slice(start, start + 2 ** d)
        node = driver.ref.route(st.dbins, node, *(t[lvl] for t in tree[:3]))
        assert calls[d + 1][1] == int((node % 2 == 0).sum())
        start += 2 ** d
    reader = harness.load("metrics", "gbdt.hist_row_passes")
    run = harness.Run(st.ctx, 0.0, {}, None, got)
    assert reader.read(run) == 31.0


def test_row_passes_are_left_out_where_the_program_counts_none(
        monkeypatch):
    driver = harness.load("drivers", "gbdt_missing")
    assert driver._kernel_counts() is not None
    monkeypatch.delattr(hist_kernel.histograms, "row_passes")
    assert driver._kernel_counts() is None
    reader = harness.load("metrics", "gbdt.hist_row_passes")
    assert reader.read(harness.Run(None, 0.0, {}, None, {"trees": 2})) is None
