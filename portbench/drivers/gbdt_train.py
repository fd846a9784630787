"""GBDT boosting rounds on one process, one round after another.

The loop is ``GBDTTrainer.train``'s per-tree round: ``train_tree_shard``
over the trainer's staged rows and mesh, each round starting from the
margins the last one returned. The loop trains one model of the
configuration's ``n_trees`` rounds after another, each from zero margins,
as a user trains a model: a round's work grows with its index in the
model (later trees route more rows to fewer leaves), so a window holds
the same work whatever its length and however far a faster program
gets. Set-up makes the bins and labels on the device from the seed,
stages them with ``GBDTTrainer.shard_data`` and warms up with one round
(round 0, judged as the start).

Judged (``reference/gbdt.py``): round 0 and a sample of the window's
rounds drawn from the seed. For a sampled round the driver keeps copies
of its input and output margins, its tree and each level's histogram
partials (``models.gbdt.build_histograms``) and folded sums
(``models.gbdt._fold``).

Traffic: ``members`` (packed on one card, ``device.make_mesh``),
``checked_rounds`` (the window's sample).
"""

from __future__ import annotations

import types

import torch

from portbench import profiling
from portbench import roofline
from portbench.reference import gbdt as ref
from portbench.sampling import Reservoir, generator


def make_data(cfg: dict, seed: int, device):
    """[N, F] int32 bins, uniform over the bins, and {0, 1} f32 labels
    drawn from a logistic function of the first features (weights
    ``cfg["label_weights"]``), all on ``device``. The rows are drawn from
    ``cfg["data_seed"]``, the same for every run, and put in an order
    drawn from ``seed``: every seed trains the same trees, so does the
    same work, with each member holding other rows."""
    N, F, B = cfg["n_rows"], cfg["n_features"], cfg["n_bins"]
    gen = generator(cfg["data_seed"], device)
    bins = torch.randint(0, B, (N, F), dtype=torch.int32, generator=gen,
                         device=device)
    w = torch.tensor(cfg["label_weights"], dtype=torch.float32,
                     device=device)
    x = bins[:, :w.numel()].to(torch.float32) / (B - 1) - 0.5
    p = torch.sigmoid((x * w).sum(1))
    y = (torch.rand(N, generator=gen, device=device) < p).to(torch.float32)
    order = torch.randperm(N, generator=generator(seed, device),
                           device=device)
    return bins[order], y[order]


def _program_config(cfg: dict):
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTConfig

    return GBDTConfig(
        n_features=cfg["n_features"], n_bins=cfg["n_bins"],
        depth=cfg["depth"], loss=cfg["loss"],
        learning_rate=cfg["learning_rate"], reg_lambda=cfg["reg_lambda"],
        subsample=cfg["subsample"], colsample=cfg["colsample"],
        min_split_gain=cfg["min_split_gain"],
        min_child_hessian=cfg["min_child_hessian"], n_trees=cfg["n_trees"])


class _Capture:
    """Wraps the trainer's histogram call and fold, keeping copies of
    their outputs while ``on``."""

    def __init__(self, gbdt):
        self.gbdt = gbdt
        self.on = False
        self.hists, self.folds = [], []
        real_hist, real_fold = gbdt.build_histograms, gbdt._fold

        def hist(*args, **kwargs):
            out = real_hist(*args, **kwargs)
            if self.on:
                self.hists.append(tuple(t.clone() for t in out))
            return out

        def fold(*args, **kwargs):
            out = real_fold(*args, **kwargs)
            if self.on:
                self.folds.append(out.clone())
            return out

        self.real = (real_hist, real_fold)
        gbdt.build_histograms, gbdt._fold = hist, fold

    def restore(self):
        self.gbdt.build_histograms, self.gbdt._fold = self.real

    def start(self):
        self.on, self.hists, self.folds = True, [], []

    def stop(self, depth: int):
        """(partials, folded) of each level: one histogram call a level,
        and the fold's first 2 * depth calls are the levels' g and h
        planes (the last two, the leaf sums)."""
        self.on = False
        if len(self.hists) != depth or len(self.folds) != 2 * depth + 2:
            raise RuntimeError(
                f"a round made {len(self.hists)} histogram calls and "
                f"{len(self.folds)} folds, not {depth} and {2 * depth + 2}: "
                "its levels cannot be judged")
        return self.hists, [(self.folds[2 * d], self.folds[2 * d + 1])
                            for d in range(depth)]


def setup(ctx):
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models import gbdt
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTTrainer

    dev = torch.device(ctx.device)
    cfg = ctx.config
    st = types.SimpleNamespace(ctx=ctx, cfg=cfg, gbdt=gbdt,
                               members=ctx.traffic["members"])
    st.bins, st.y = make_data(cfg, ctx.seed, dev)
    st.trainer = GBDTTrainer(_program_config(cfg),
                             mesh=make_mesh(st.members, dev))
    st.dbins, st.dy, st.preds, st.dw = st.trainer.shard_data(st.bins, st.y)
    st.model_round = 0                        # rounds of the model so far
    st.capture = _Capture(gbdt)
    st.sample = Reservoir(ctx.traffic["checked_rounds"], ctx.seed)
    st.trees, st.rounds = [], 0
    st.start = _round(st, keep=True)          # warm-up: round 0
    drain(st)
    st.rounds = 0
    st.trees.clear()
    return st


def _round(st, keep: bool):
    """One boosting round, as ``GBDTTrainer.train`` runs it; with ``keep``
    returns copies of what it read and made."""
    mesh = st.trainer.mesh
    if st.model_round == st.cfg["n_trees"]:   # the model is whole: a new one
        st.preds = torch.zeros_like(st.preds)
        st.model_round = 0
    before = st.preds.clone() if keep else None
    if keep:
        st.capture.start()
    st.preds, tree = st.gbdt.train_tree_shard(
        st.dbins, st.dy, st.preds, st.trainer.cfg, weights=st.dw,
        n_members=mesh.n_local, group=mesh.group)
    st.trees.append(tree)
    st.rounds += 1
    st.model_round += 1
    if not keep:
        return None
    partials, folded = st.capture.stop(st.cfg["depth"])
    return {"preds_in": before, "preds_out": st.preds.clone(),
            "tree": tuple(t.clone() for t in tree), "partials": partials,
            "folded": folded}


def step(st):
    slot = st.sample.slot()
    kept = _round(st, keep=slot is not None)
    if slot is not None:
        st.sample.items[slot] = kept


def drain(st):
    if st.bins.device.type == "cuda":
        torch.cuda.synchronize(st.bins.device)


def record(st):
    return {"trees": st.rounds}


class _Probe:
    def __init__(self, st):
        self.st = st

    def begin(self):
        g = self.st.gbdt
        self.real = g.build_histograms
        g.build_histograms = profiling.labelled("histograms", self.real)
        self.first = len(self.st.trees)

    def end(self):
        self.st.gbdt.build_histograms = self.real
        return {"trees": self.st.trees[self.first:]}


def probe(st):
    return _Probe(st)


def traced_items(st, items):
    """Rounds in the sub-window, and each histogram call's (rows, rows
    whose node id is in range, nodes): a level's in-range rows are those
    the tree sent left one level up."""
    cfg = st.cfg
    N, n = st.bins.shape[0], st.members
    calls = []
    for tree in items["trees"]:
        node = torch.zeros(N, dtype=torch.int64, device=st.bins.device)
        start = 0
        calls.append((N, N, n))
        for d in range(cfg["depth"] - 1):
            lvl = slice(start, start + 2 ** d)
            node = ref.route(st.bins, node, tree[0][lvl], tree[1][lvl])
            calls.append((N, int((node % 2 == 0).sum().item()), n * 2 ** d))
            start += 2 ** d
    return {"trees": len(items["trees"]), "hist_calls": calls,
            "least_tree_s": roofline.tree_seconds(
                N, cfg["n_features"], cfg["n_bins"], cfg["depth"])}


def check(st):
    attempted = st.rounds
    kept = [st.start] + st.sample.kept()
    # free the program's state before the reference runs
    st.capture.restore()
    st.trainer = st.preds = st.dbins = st.dy = st.dw = None
    st.trees = []
    if st.bins.device.type == "cuda":
        torch.cuda.empty_cache()
    worst, failed = {}, 0
    limits = st.ctx.limits
    for r in kept:
        nums = ref.judge_round(st.bins, st.y, r["preds_in"], r["preds_out"],
                               r["tree"], r["partials"], r["folded"], st.cfg,
                               st.members)
        failed += any(v > limits[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return attempted, failed, {k: (v, limits[k]) for k, v in worst.items()}


CONTROL_ROUNDS = 3


def control(ctx):
    """The numbers of the control: ``reference.gbdt.control_round`` (the
    round in bfloat16) in the program's place for the first rounds from
    zero margins, each judged as a program round is."""
    dev = torch.device(ctx.device)
    cfg, n = ctx.config, ctx.traffic["members"]
    bins, y = make_data(cfg, ctx.seed, dev)
    preds = torch.zeros(bins.shape[0], dtype=torch.float32, device=dev)
    out = []
    for _ in range(CONTROL_ROUNDS):
        new, tree, partials, folded = ref.control_round(bins, y, preds, cfg,
                                                        n)
        out.append(ref.judge_round(bins, y, preds, new, tree, partials,
                                   folded, cfg, n))
        preds = new
    return out
