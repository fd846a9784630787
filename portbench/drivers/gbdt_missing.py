"""GBDT boosting rounds on wide, mostly-missing rows, one process.

The loop is ``drivers/gbdt_train.py``'s (``train_tree_shard`` over the
trainer's staged rows and packed mesh, models of ``n_trees`` rounds from
zero margins, a sample of rounds kept and judged), on the rows of
:func:`make_data`: features in station blocks that a row passes through
or skips together, a skipped station's values in the missing bucket (bin
0), and the trainer's learned missing directions and min-child mask on.

Judged by ``reference/gbdt_missing.py``. The traced items are
``gbdt_train``'s (``trees``, ``hist_calls`` with the rows the tree's
learned directions send left, ``least_tree_s``) and
``hist_row_passes``: the passes the histogram kernel made over its rows
in the traced sub-window (the program's ``histograms.row_passes``) over
its launches (``histograms.launches``); absent where the program counts
no passes.

Traffic: ``members`` (packed on one card), ``checked_rounds``.
"""

from __future__ import annotations

import dataclasses
import types

import torch

from portbench import roofline
from portbench.drivers import gbdt_train as base
from portbench.reference import gbdt_missing as ref
from portbench.sampling import Reservoir, generator

step, drain, record = base.step, base.drain, base.record


def station_of_features(cfg: dict, device):
    """[F] int64: the station of each feature, stations being blocks of
    consecutive features of the sizes ``cfg["station_sizes"]``."""
    sizes = torch.tensor(cfg["station_sizes"], device=device)
    return torch.repeat_interleave(torch.arange(len(sizes), device=device),
                                   sizes)


def solve_bias(s, rate: float) -> float:
    """The b for which the mean of sigmoid(b + s) is ``rate`` (bisection
    in float64; the mean grows with b)."""
    lo, hi = -40.0, 40.0
    s = s.to(torch.float64)
    for _ in range(80):
        mid = (lo + hi) / 2
        if torch.sigmoid(s + mid).mean().item() < rate:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def make_data(cfg: dict, seed: int, device, members: int = 1):
    """[N, F] int32 bins and {0, 1} f32 labels on ``device``. A row passes
    through each station with probability ``station_pass_rate``; the
    features of a station it skips hold bin 0 (missing), those of a
    station it passes a bin uniform over 1 .. B - 1. Label ~
    Bernoulli(sigmoid(b + sum_j w_j x_j)) over the first features, x_j =
    bin/(B-1) - 0.5 where present and 0 where missing, the bias b solved
    so that the mean rate is ``label_rate``. The rows are drawn from
    ``cfg["data_seed"]``, the same in every run, and ``seed`` draws their
    order within each of the trainer's ``members`` blocks (ceil(N /
    members) rows each): every member holds the same rows whatever the
    seed, so every seed trains the same trees and does the same work.
    Where the seed moved rows between members, the float32 fold's
    rounding moved splits that tie at the min-child mask, and with them
    which child, the small or the large, each level sums: on an H100 six
    seeds' trees/s spread by 1.2 % (quartiles over the median)."""
    N, F, B = cfg["n_rows"], cfg["n_features"], cfg["n_bins"]
    gen = generator(cfg["data_seed"], device)
    station = station_of_features(cfg, device)
    if station.numel() != F:
        raise ValueError(f"station sizes cover {station.numel()} features, "
                         f"not {F}")
    seen = torch.rand((N, int(station.max()) + 1), generator=gen,
                      device=device) < cfg["station_pass_rate"]
    bins = torch.randint(1, B, (N, F), dtype=torch.int32, generator=gen,
                         device=device)
    bins.mul_(seen[:, station])
    w = torch.tensor(cfg["label_weights"], dtype=torch.float32,
                     device=device)
    first = bins[:, :w.numel()]
    x = torch.where(first > 0, first.to(torch.float32) / (B - 1) - 0.5, 0.0)
    s = (x * w).sum(1)
    b = solve_bias(s, cfg["label_rate"])
    p = torch.sigmoid(s.to(torch.float64) + b)
    y = (torch.rand(N, generator=gen, device=device, dtype=torch.float64)
         < p).to(torch.float32)
    size = -(-N // members)
    shuffle = generator(seed, device)
    order = torch.cat([lo + torch.randperm(min(size, N - lo),
                                           generator=shuffle, device=device)
                       for lo in range(0, N, size)])
    return bins[order], y[order]


def _program_config(cfg: dict):
    return dataclasses.replace(base._program_config(cfg),
                               missing_bin=cfg["missing_bin"])


def setup(ctx):
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models import gbdt
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTTrainer

    dev = torch.device(ctx.device)
    cfg = ctx.config
    st = types.SimpleNamespace(ctx=ctx, cfg=cfg, gbdt=gbdt,
                               members=ctx.traffic["members"])
    st.bins, st.y = make_data(cfg, ctx.seed, dev, st.members)
    st.trainer = GBDTTrainer(_program_config(cfg),
                             mesh=make_mesh(st.members, dev))
    st.dbins, st.dy, st.preds, st.dw = st.trainer.shard_data(st.bins, st.y)
    st.model_round = 0
    st.capture = base._Capture(gbdt)
    st.sample = Reservoir(ctx.traffic["checked_rounds"], ctx.seed)
    st.trees, st.rounds = [], 0
    st.start = base._round(st, keep=True)      # warm-up: round 0
    drain(st)
    st.rounds = 0
    st.trees.clear()
    return st


def _kernel_counts():
    """(launches, row passes) the program's histogram wrapper has counted,
    or None where it counts no row passes."""
    from ytk_mp4j_tpu_torch.ops import hist_kernel

    fn = hist_kernel.histograms
    passes = getattr(fn, "row_passes", None)
    return None if passes is None else (fn.launches, passes)


class _Probe(base._Probe):
    def begin(self):
        super().begin()
        self.counts = _kernel_counts()

    def end(self):
        out = super().end()
        after = _kernel_counts()
        if self.counts is not None and after is not None:
            out["kernel_counts"] = (after[0] - self.counts[0],
                                    after[1] - self.counts[1])
        return out


def probe(st):
    return _Probe(st)


def traced_items(st, items):
    """``gbdt_train``'s items, each histogram call's in-range rows those
    the tree's splits and learned directions sent left one level up, and
    the kernel's row passes a launch."""
    cfg = st.cfg
    bins = st.dbins                 # the staged rows, padding included
    N, n = bins.shape[0], st.members
    calls = []
    for tree in items["trees"]:
        node = torch.zeros(N, dtype=torch.int64, device=bins.device)
        start = 0
        calls.append((N, N, n))
        for d in range(cfg["depth"] - 1):
            lvl = slice(start, start + 2 ** d)
            node = ref.route(bins, node, tree[0][lvl], tree[1][lvl],
                             tree[2][lvl])
            calls.append((N, int((node % 2 == 0).sum().item()), n * 2 ** d))
            start += 2 ** d
    out = {"trees": len(items["trees"]), "hist_calls": calls,
           "least_tree_s": roofline.tree_seconds(
               N, cfg["n_features"], cfg["n_bins"], cfg["depth"])}
    launches, passes = items.get("kernel_counts", (0, 0))
    if launches:
        out["hist_row_passes"] = passes / launches
    return out


def _padded(st):
    """The benchmark's rows padded as the trainer pads them (zero rows,
    weight 0), so that each member holds an equal block."""
    total = st.preds.shape[0]
    pad = total - st.bins.shape[0]
    w = torch.ones(total, dtype=torch.float32, device=st.bins.device)
    if pad:
        w[-pad:] = 0.0
    return (torch.cat([st.bins, st.bins.new_zeros((pad, st.bins.shape[1]))]),
            torch.cat([st.y, st.y.new_zeros(pad)]), w)


def check(st):
    attempted = st.rounds
    kept = [st.start] + st.sample.kept()
    # free the program's state before the reference runs
    st.capture.restore()
    bins, y, w = _padded(st)
    st.trainer = st.preds = st.dbins = st.dy = st.dw = st.bins = None
    st.trees = []
    if bins.device.type == "cuda":
        torch.cuda.empty_cache()
    worst, failed = {}, 0
    limits = st.ctx.limits
    for r in kept:
        nums = ref.judge_round(bins, y, w, r["preds_in"], r["preds_out"],
                               r["tree"], r["partials"], r["folded"], st.cfg,
                               st.members)
        failed += any(v > limits[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return attempted, failed, {k: (v, limits[k]) for k, v in worst.items()}


CONTROL_ROUNDS = 3


def control(ctx):
    """The numbers of the control: ``reference.gbdt_missing.control_round``
    (the round in bfloat16) in the program's place for the first rounds
    from zero margins, each judged as a program round is."""
    dev = torch.device(ctx.device)
    cfg, n = ctx.config, ctx.traffic["members"]
    st = types.SimpleNamespace()
    st.bins, st.y = make_data(cfg, ctx.seed, dev, n)
    st.preds = torch.zeros(n * -(-st.bins.shape[0] // n), device=dev)
    bins, y, w = _padded(st)
    preds = st.preds
    out = []
    for _ in range(CONTROL_ROUNDS):
        new, tree, partials, folded = ref.control_round(bins, y, w, preds,
                                                        cfg, n)
        out.append(ref.judge_round(bins, y, w, preds, new, tree, partials,
                                   folded, cfg, n))
        preds = new
    return out
