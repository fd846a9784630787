"""Plain reference of one GBDT boosting round, and the comparison that
judges a round the program made.

Plain PyTorch, on whatever device the tensors are on. It imports nothing
of the program: it works out the gradients, the histograms, the gains,
the routing and the leaf values again from the inputs the benchmark made
(bins, labels) and from the margins a round started from.

A round is judged against the reference that follows the program's
tree: the reference routes every row by the program's splits, so that a
split the program chose among near ties does not make every later number
differ. Whether that split was a good one is read as its regret: how far
its gain, on the reference's exact histograms, falls short of the best
gain at that node. The numbers (worst over the rounds judged):

- ``hist_err``: the program's histogram partials (one block of nodes a
  member), the worst cell's gap to the exact sums, over the largest
  exact cell of its plane;
- ``fold_err``: the same for the members' folded sums;
- ``split_regret``: (best gain - the chosen split's gain) over the
  larger of the best gain and the node's own score G^2 / (H + lambda),
  the worst node; a node the program froze has gain 0;
- ``leaf_err``: the worst leaf's gap to the exact leaf value, over the
  largest exact leaf value;
- ``margin_err``: the worst row's gap between the program's new margin
  and its old margin plus the learning rate times its exact leaf, over
  the largest such step.

:func:`control_round` is the same round computed in bfloat16 (the
gradients and the leaf values rounded to it, sums in float32), shaped as
the program's output, so that the same comparison can show that it
fails.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 1 << 21      # rows a histogram block takes, to bound memory


def gradients(preds, y, loss: str, dtype=torch.float64):
    """(g, h) of each row in ``dtype`` from its margin and label."""
    z = preds.to(dtype)
    yy = y.to(dtype)
    if loss == "logistic":
        p = torch.sigmoid(z)
        return p - yy, p * (1.0 - p)
    if loss == "squared":
        return z - yy, torch.ones_like(z)
    raise ValueError(f"the reference has no loss {loss!r}")


def histograms(bins, v, node_ids, n_nodes: int, n_bins: int, dtype):
    """[n_nodes, F, B] sums of ``v`` by (node, feature, bin) in ``dtype``;
    rows whose id lies outside [0, n_nodes) add nothing."""
    N, F = bins.shape
    cells = n_nodes * F * n_bins
    acc = torch.zeros(cells, dtype=dtype, device=bins.device)
    feat = torch.arange(F, device=bins.device) * n_bins
    for lo in range(0, N, ROW_BLOCK):
        hi = min(N, lo + ROW_BLOCK)
        ids = node_ids[lo:hi].long()
        keep = (ids >= 0) & (ids < n_nodes)
        key = ids[keep, None] * (F * n_bins) + feat + bins[lo:hi][keep].long()
        val = v[lo:hi][keep].to(dtype)[:, None].expand(-1, F)
        acc.index_add_(0, key.reshape(-1), val.reshape(-1))
    return acc.reshape(n_nodes, F, n_bins)


def member_histograms(bins, g, h, ids, k: int, members: int, n_bins: int,
                      dtype):
    """Each member's [k, F, B] sums over its block of rows, stacked
    member-major as ``[members * k, F, B]`` (g plane, h plane)."""
    per = bins.shape[0] // members
    parts_g, parts_h = [], []
    for m in range(members):
        rows = slice(m * per, (m + 1) * per)
        parts_g.append(histograms(bins[rows], g[rows], ids[rows], k, n_bins,
                                  dtype))
        parts_h.append(histograms(bins[rows], h[rows], ids[rows], k, n_bins,
                                  dtype))
    return torch.cat(parts_g), torch.cat(parts_h)


def gains(hg, hh, reg_lambda: float):
    """[n_nodes, F, B] gain of each "bin <= b goes left" split; the last
    bin, which sends every row left, is no candidate (-inf)."""
    gl = torch.cumsum(hg, dim=-1)
    hl = torch.cumsum(hh, dim=-1)
    gt, ht = gl[..., -1:], hl[..., -1:]

    def score(a, b):
        return a * a / (b + reg_lambda)

    out = score(gl, hl) + score(gt - gl, ht - hl) - score(gt, ht)
    out = torch.where(torch.isnan(out), float("-inf"), out)
    out[..., -1] = float("-inf")
    return out


def route(bins, node, feat, bin_):
    """One level: ``2 * node + (bins[row, feat[node]] > bin[node])``."""
    idx = node.long()
    v = bins.gather(1, feat[idx].long()[:, None])[:, 0]
    return node * 2 + (v > bin_[idx]).to(node.dtype)


def _worst_rel(got, want):
    """Worst cell's gap over the largest exact cell (0 where all are 0)."""
    scale = want.abs().max().item()
    gap = (got.to(want.dtype) - want).abs().max().item()
    if gap != gap:                       # NaN in the program's output
        return float("inf")
    return gap / scale if scale > 0 else gap


def judge_round(bins, y, preds_in, preds_out, tree, partials, folded, cfg,
                members: int):
    """The numbers of one round (see the module docstring). ``tree`` is
    (feat, bin, dir, leaf); ``partials[d]`` and ``folded[d]`` are the
    program's (g, h) histogram planes of level d (the left children below
    level 0)."""
    F, B, depth = cfg["n_features"], cfg["n_bins"], cfg["depth"]
    lam, lr = cfg["reg_lambda"], cfg["learning_rate"]
    f64 = torch.float64
    dev = bins.device
    g, h = gradients(preds_in, y, cfg["loss"])
    feat = tree[0].to(dev).long()
    bin_ = tree[1].to(dev).long()
    N = bins.shape[0]
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    out = {"hist_err": 0.0, "fold_err": 0.0, "split_regret": 0.0}
    start = 0
    for d in range(depth):
        n_nodes = 2 ** d
        if d == 0:
            ids, k = node, 1
        else:
            k = n_nodes // 2
            ids = torch.where(node % 2 == 0, node // 2, -1)
        pg, ph = member_histograms(bins, g, h, ids, k, members, B, f64)
        out["hist_err"] = max(out["hist_err"],
                              _worst_rel(partials[d][0], pg),
                              _worst_rel(partials[d][1], ph))
        fg = pg.reshape(members, k, F, B).sum(0)
        fh = ph.reshape(members, k, F, B).sum(0)
        out["fold_err"] = max(out["fold_err"],
                              _worst_rel(folded[d][0], fg),
                              _worst_rel(folded[d][1], fh))
        if d == 0:
            hg, hh = fg, fh
        else:      # right child = parent - left child, exact to f64
            hg = torch.stack([fg, hg - fg], dim=1).reshape(n_nodes, F, B)
            hh = torch.stack([fh, hh - fh], dim=1).reshape(n_nodes, F, B)
        gain = gains(hg, hh, lam).reshape(n_nodes, -1)
        best = gain.max(dim=1).values
        lvl = slice(start, start + n_nodes)
        chosen_bin = bin_[lvl]
        frozen = chosen_bin >= B - 1
        flat = (feat[lvl] * B + chosen_bin.clamp(max=B - 1))[:, None]
        chosen = torch.where(frozen, torch.zeros_like(best),
                             gain.gather(1, flat)[:, 0])
        # over the larger of the best gain and the node's own score: a
        # node of a row or two has gains of 0 to rounding, whose ratios
        # to each other mean nothing
        gt, ht = hg[:, 0].sum(-1), hh[:, 0].sum(-1)
        scale = torch.maximum(best, gt * gt / (ht + lam))
        regret = torch.where(scale > 0, (best - chosen) / scale,
                             torch.zeros_like(best))
        out["split_regret"] = max(out["split_regret"],
                                  regret.max().nan_to_num(float("inf")).item())
        node = route(bins, node, feat[lvl], bin_[lvl])
        start += n_nodes
    n_leaves = 2 ** depth
    leaf_g = torch.zeros(n_leaves, dtype=f64, device=dev).index_add_(
        0, node, g)
    leaf_h = torch.zeros(n_leaves, dtype=f64, device=dev).index_add_(
        0, node, h)
    leaf = -leaf_g / (leaf_h + lam)
    out["leaf_err"] = _worst_rel(tree[3].to(dev), leaf)
    step = lr * leaf[node]
    want = preds_in.to(f64) + step
    gap = (preds_out.to(f64) - want).abs().max().item()
    scale = step.abs().max().item()
    out["margin_err"] = (float("inf") if gap != gap
                         else gap / scale if scale > 0 else gap)
    return out


def control_round(bins, y, preds, cfg, members: int):
    """The round computed in bfloat16 in the program's place: gradients
    rounded to bf16, histograms and folds summed in f32, the right
    children by subtraction as the program derives them, splits on those
    sums, leaf values rounded to bf16. Returns what the program's round
    gives: (new margins, tree, partials, folded)."""
    F, B, depth = cfg["n_features"], cfg["n_bins"], cfg["depth"]
    lam, lr = cfg["reg_lambda"], cfg["learning_rate"]
    f32, bf16 = torch.float32, torch.bfloat16
    dev = bins.device
    g, h = (v.to(bf16).to(f32) for v in gradients(preds, y, cfg["loss"],
                                                  f32))
    N = bins.shape[0]
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    n_internal = 2 ** depth - 1
    t_feat = torch.zeros(n_internal, dtype=torch.int32, device=dev)
    t_bin = torch.zeros(n_internal, dtype=torch.int32, device=dev)
    partials, folded = [], []
    prev = None
    start = 0
    for d in range(depth):
        n_nodes = 2 ** d
        k = 1 if d == 0 else n_nodes // 2
        ids = node if d == 0 else torch.where(node % 2 == 0, node // 2, -1)
        pg, ph = member_histograms(bins, g, h, ids, k, members, B, f32)
        fg = pg.reshape(members, k, F, B).sum(0)
        fh = ph.reshape(members, k, F, B).sum(0)
        partials.append((pg, ph))
        folded.append((fg, fh))
        if d == 0:
            hg, hh = fg, fh
        else:
            hg = torch.stack([fg, prev[0] - fg], dim=1).reshape(n_nodes, F, B)
            hh = torch.stack([fh, (prev[1] - fh).clamp(min=0)],
                             dim=1).reshape(n_nodes, F, B)
        prev = (hg, hh)
        gain = gains(hg, hh, lam).reshape(n_nodes, -1)
        best, arg = gain.max(dim=1)
        lvl = slice(start, start + n_nodes)
        t_feat[lvl] = (arg // B).to(torch.int32)
        t_bin[lvl] = torch.where(best > 0, arg % B, B - 1).to(torch.int32)
        node = route(bins, node, t_feat[lvl], t_bin[lvl])
        start += n_nodes
    n_leaves = 2 ** depth
    leaf_g = torch.zeros(n_leaves, dtype=f32, device=dev).index_add_(
        0, node, g)
    leaf_h = torch.zeros(n_leaves, dtype=f32, device=dev).index_add_(
        0, node, h)
    leaf = (-leaf_g / (leaf_h + lam)).to(bf16).to(f32)
    tree = (t_feat, t_bin, torch.zeros_like(t_feat), leaf)
    return preds + lr * leaf[node], tree, partials, folded
