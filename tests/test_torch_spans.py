"""The port's own spans (``obs.spans.span``): the GBDT round's phases and
the ring kernels' entry points, in the span ring and, while a
``torch.profiler`` records, as its ranges.

On the CPU the profiler sees the ATen ops a round runs, which are its
launches on the card: each must fall inside exactly one of the seven
phase spans, on the packed mesh, the list mesh and under softmax alike.
"""

import pytest
import torch

from ytk_mp4j_tpu_torch.models import gbdt
from ytk_mp4j_tpu_torch.obs import spans
from ytk_mp4j_tpu_torch.ops import ring_kernel

PHASES = tuple("gbdt::" + p for p in ("gradients", "histograms", "fold",
                                      "splits", "route", "leaf_sums",
                                      "margins"))
DEPTH, N, F, B, C = 3, 1200, 5, 16, 3


@pytest.fixture(autouse=True)
def fresh_ring():
    prior = spans._capacity
    spans.configure(prior or 65536)
    yield
    spans.configure(prior)


def _data(loss, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bins = torch.randint(0, B, (N, F), dtype=torch.int32, generator=gen)
    if loss == "softmax":
        y = torch.randint(0, C, (N,), generator=gen).to(torch.float32)
        preds = torch.zeros(N, C)
    else:
        y = (torch.rand(N, generator=gen) < 0.5).to(torch.float32)
        preds = torch.zeros(N)
    return bins, y, preds


def _prepared(mesh, loss, subsample=1.0):
    """One boosting round of 4 members, its inputs made: a function that
    runs it."""
    cfg = gbdt.GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss=loss,
                          n_classes=C, subsample=subsample)
    bins, y, preds = _data(loss)
    w = torch.ones(N)
    gens = (gbdt.member_generators(7, 4, "cpu") if subsample < 1.0
            else None)
    if mesh == "packed":
        return lambda: gbdt.train_tree_shard(bins, y, preds, cfg, weights=w,
                                             generators=gens, n_members=4)
    per = N // 4
    b, y, p, w = ([t[m * per:(m + 1) * per] for m in range(4)]
                  for t in (bins, y, preds, w))
    return lambda: gbdt.train_tree_shard(b, y, p, cfg, weights=w,
                                         generators=gens, n_members=4)


def _round(mesh, loss, subsample=1.0):
    return _prepared(mesh, loss, subsample)()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _inside(e, s):
    return (s.time_range.start <= e.time_range.start
            and e.time_range.end <= s.time_range.end)


CASES = [("packed", "logistic", 1.0), ("list", "logistic", 1.0),
         ("packed", "softmax", 1.0), ("list", "softmax", 1.0),
         ("packed", "squared", 0.5), ("list", "squared", 0.5)]


@pytest.mark.parametrize("mesh,loss,subsample", CASES)
def test_a_round_is_one_round_span_with_a_level_span_a_level(mesh, loss,
                                                              subsample):
    ev = _profiled(_prepared(mesh, loss, subsample))
    names = [e.name for e in ev if e.name.startswith("gbdt::")]
    trees = C if loss == "softmax" else 1
    assert names.count("gbdt::round") == 1
    assert names.count("gbdt::level") == DEPTH * trees
    assert set(names) == {"gbdt::round", "gbdt::level", *PHASES}


@pytest.mark.parametrize("mesh,loss,subsample", CASES)
def test_every_op_of_a_round_lies_in_exactly_one_phase(mesh, loss,
                                                       subsample):
    ev = _profiled(_prepared(mesh, loss, subsample))
    (rnd,) = [e for e in ev if e.name == "gbdt::round"]
    phases = [e for e in ev if e.name in PHASES]
    ops = [e for e in ev if e.name.startswith("aten::")]
    assert ops and all(_inside(e, rnd) for e in ops + phases)
    for e in ops:
        assert sum(_inside(e, s) for s in phases) == 1, e.name
    # no phase nests in another
    for s in phases:
        assert sum(_inside(s, o) for o in phases) == 1, s.name


@pytest.mark.parametrize("mesh,hists", [("packed", "h"), ("list", "hhhh")])
def test_the_histogram_and_fold_calls_are_the_ones_a_round_makes(
        monkeypatch, mesh, hists):
    """Per round, one histogram call a level a block (the packed mesh's
    one block, or each of the list mesh's 4 members) and 2 * depth + 2
    folds, in that order per level (a level's two folds after its
    histogram calls)."""
    calls = []
    real_hist, real_fold = gbdt.build_histograms, gbdt._fold

    def hist(*a, **k):
        calls.append("h")
        return real_hist(*a, **k)

    def fold(*a, **k):
        calls.append("f")
        return real_fold(*a, **k)

    monkeypatch.setattr(gbdt, "build_histograms", hist)
    monkeypatch.setattr(gbdt, "_fold", fold)
    _round(mesh, "logistic")
    assert "".join(calls) == (hists + "ff") * DEPTH + "ff"


def test_rounds_built_counts_rounds_and_their_spans_carry_it():
    before = gbdt.rounds_built
    _round("packed", "logistic")
    _round("list", "softmax")
    assert gbdt.rounds_built == before + 2
    recs = [s for s in spans.snapshot() if s[0].startswith("gbdt::")]
    rounds = [s for s in recs if s[0] == "gbdt::round"]
    assert [s[6]["round"] for s in rounds] == [before + 1, before + 2]
    assert rounds[0][6]["members"] == 4 and rounds[0][6]["rows"] == N
    for s in recs:
        assert s[6]["id"] in (before + 1, before + 2)
        assert (s[0] == "gbdt::round") == ("parent" not in s[6])
    second = [s for s in recs if s[6]["id"] == before + 2]
    levels = [s[6] for s in second if s[0] == "gbdt::level"]
    assert sorted((a["class"], a["level"], a["nodes"]) for a in levels) == [
        (c, d, 2 ** d) for c in range(C) for d in range(DEPTH)]
    assert all(s[6]["parent"] == "gbdt::level" for s in second
               if s[0] in PHASES[1:5])


@pytest.mark.parametrize("listed", [False, True])
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter",
                                  "allgather"])
def test_ring_entry_points_are_spans_with_their_path_and_size(mode, listed):
    n, L = 4, 64
    x = torch.arange(n * L, dtype=torch.float64).reshape(n, L)
    arg = list(x) if listed else x
    fn = getattr(ring_kernel, f"ring_{mode}_kernel")
    ev = _profiled(lambda: fn(arg))
    assert [e.name for e in ev if e.name.startswith("ring::")] == [
        f"ring::{mode}"]
    (rec,) = [s for s in spans.snapshot() if s[0].startswith("ring::")]
    assert rec[0] == f"ring::{mode}" and rec[1] == "ring"
    args = rec[6]
    assert args["path"] == "plain" and args["members"] == n
    assert args["bytes"] == L * 8 and args["dtype"] == "float64"
    assert args["ndir"] == 1 and "parent" not in args


def test_the_wait_for_the_error_word_is_a_child_of_its_call():
    with spans.span("ring::reduce_scatter", "ring") as outer:
        ring_kernel._raise_if_stuck(torch.zeros(4, dtype=torch.int64), 1.0)
        spans.annotate(path="cluster")
    wait, call = spans.snapshot()
    assert wait[0] == "ring::wait" and call[0] == "ring::reduce_scatter"
    assert wait[6] == {"id": outer.args["id"],
                       "parent": "ring::reduce_scatter"}
    assert call[6]["path"] == "cluster"
    assert call[2] <= wait[2] and wait[3] <= call[3]


def test_spans_nest_share_their_root_id_and_survive_a_raise():
    with spans.span("a", "t", id=41, k=1):
        with pytest.raises(ValueError):
            with spans.span("b", "t"):
                raise ValueError("inside")
        with spans.span("c", "t"):
            pass
    with spans.span("d", "t"):
        pass
    got = {s[0]: s[6] for s in spans.snapshot()}
    assert got["a"] == {"id": 41, "k": 1}
    assert got["b"] == got["c"] == {"id": 41, "parent": "a"}
    assert got["d"]["id"] != 41 and "parent" not in got["d"]


def test_no_profiler_range_is_opened_while_none_records(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _round("packed", "logistic")
    _round("list", "logistic")
    ring_kernel.ring_reduce_scatter_kernel(torch.ones(4, 64,
                                                      dtype=torch.float64))
    assert any(s[0] == "gbdt::round" for s in spans.snapshot())
    assert any(s[0] == "ring::reduce_scatter" for s in spans.snapshot())


def test_with_the_ring_off_and_no_profiler_nothing_is_recorded():
    spans.configure(0)
    assert spans.span("gbdt::round", "gbdt") is spans._OFF
    before = gbdt.rounds_built
    _round("packed", "logistic")
    ring_kernel.ring_allgather_kernel(torch.ones(4, 16, dtype=torch.float64))
    assert spans.snapshot() == []
    assert gbdt.rounds_built == before + 1
    assert not spans._local.__dict__.get("stack")


def test_the_spans_land_in_a_trace_collectives_profile(tmp_path):
    import json

    from ytk_mp4j_tpu_torch import trace_collectives

    run = _prepared("packed", "logistic")
    with trace_collectives(profile_dir=str(tmp_path)):
        run()
    (path,) = tmp_path.iterdir()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events
             if e.get("cat") == "user_annotation"]
    assert names.count("gbdt::round") == 1
    assert set(PHASES) <= set(names)
