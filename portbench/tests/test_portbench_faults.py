"""The rest of a run with the timed path broken underneath: each fault a
cell can have has to make ``correct`` come out false, and the unbroken
run true. Each cell runs on the CPU at a size the CPU holds."""

import pytest
import torch

from conftest import small_run

from ytk_mp4j_tpu_torch.models import gbdt
from ytk_mp4j_tpu_torch.ops import ring_kernel


# ----------------------------------------------------------------------
# GBDT: the round, the members' fold, the histograms, the splits
# ----------------------------------------------------------------------
def round_unchanged(mp):
    real = gbdt.train_tree_shard

    def fault(bins, y, preds, *a, **k):
        _, tree = real(bins, y, preds, *a, **k)
        return preds, tree
    mp.setattr(gbdt, "train_tree_shard", fault)


def fold_half_the_members(mp):
    def fault(x, n):
        parts = x.reshape((n, -1) + tuple(x.shape[1:]))
        return parts[:n // 2].sum(0) * (n / (n // 2))
    mp.setattr(gbdt, "_fold", fault)


def fold_without_exchange(mp):
    def fault(x, n):
        return x.reshape((n, -1) + tuple(x.shape[1:]))[0].clone()
    mp.setattr(gbdt, "_fold", fault)


def one_histogram_cell_changed(mp):
    real = gbdt.build_histograms

    def fault(*a, **k):
        hg, hh = real(*a, **k)
        hg = hg.clone()
        hg[0, 3, 7] += 1.0
        return hg, hh
    mp.setattr(gbdt, "build_histograms", fault)


def a_split_moved(mp):
    real = gbdt.best_splits

    def fault(*a, **k):
        feat, bin_, gain, dir_ = real(*a, **k)
        bin_ = bin_.clone()
        bin_[0] = (bin_[0] + 40) % 200
        return feat, bin_, gain, dir_
    mp.setattr(gbdt, "best_splits", fault)


def one_margin_altered(mp):
    real = gbdt.train_tree_shard

    def fault(*a, **k):
        preds, tree = real(*a, **k)
        preds = preds.clone()
        preds[11] += 0.5
        return preds, tree
    mp.setattr(gbdt, "train_tree_shard", fault)


# ----------------------------------------------------------------------
# device ring calls: reduce-scatter, then allgather of its result
# ----------------------------------------------------------------------
def rs_unchanged(mp):
    def fault(x, *a, **k):        # each member keeps its own chunk
        n, L = x.shape
        return torch.stack([x[r, r * (L // n):(r + 1) * (L // n)]
                            for r in range(n)])
    mp.setattr(ring_kernel, "ring_reduce_scatter_kernel", fault)


def rs_half_the_members(mp):
    def fault(x, *a, **k):
        n, L = x.shape
        return (x[:n // 2].sum(0) * 2).reshape(n, L // n)
    mp.setattr(ring_kernel, "ring_reduce_scatter_kernel", fault)


def ag_without_exchange(mp):
    def fault(x, *a, **k):        # each row keeps only its own shard
        n, c = x.shape
        out = torch.zeros((n, n * c), dtype=x.dtype)
        for r in range(n):
            out[r, r * c:(r + 1) * c] = x[r]
        return out
    mp.setattr(ring_kernel, "ring_allgather_kernel", fault)


def rs_one_element_altered(mp):
    real = ring_kernel.ring_reduce_scatter_kernel

    def fault(*a, **k):
        out = real(*a, **k).clone()
        out[1, 5] += 1.0
        return out
    mp.setattr(ring_kernel, "ring_reduce_scatter_kernel", fault)


FAULTS = {
    "gbdt-higgs.dp4": [round_unchanged, fold_half_the_members,
                       fold_without_exchange, one_histogram_cell_changed,
                       a_split_moved, one_margin_altered],
    "ring-rdma.rsag-f64-256M-n8": [rs_unchanged, rs_half_the_members,
                                   ag_without_exchange,
                                   rs_one_element_altered],
}
CASES = [(cell, f) for cell, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_fault_makes_the_run_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = small_run(cell)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_unbroken_run_is_correct(cell):
    out = small_run(cell)
    assert out["correct"] is True, out["checks"]
