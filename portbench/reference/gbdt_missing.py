"""Plain reference of one GBDT boosting round on wide, mostly-missing rows
(bin 0 the missing bucket, a learned direction for it at every split, a
min-child mask), and the comparison that judges a round the program made.

Plain PyTorch, on whatever device the tensors are on; it imports nothing
of the program. It is ``reference/gbdt.py``'s judge with three changes:

- histograms are summed in blocks of (row, feature) pairs, not of rows
  (at 968 features a block of 2M rows would take ~30 GB of keys and
  values): a present value by ``index_add_`` into its (node, feature,
  bin) cell, the missing bucket of every (node, feature) as one product
  of the rows' node-weighted values and their missing mask;
- every candidate is scored with the missing bucket on the left and on
  the right, children whose hessian sum is below ``min_child_hessian``
  out, and rows are routed by the tree's learned directions;
- sample weights (0 on the padding rows the trainer adds so that the
  members hold equal blocks).

The numbers (worst over the rounds judged) are those of
``reference/gbdt.py``: ``hist_err``, ``fold_err``, ``split_regret`` (over
both variants, with the mask), ``leaf_err``, ``margin_err``. A program
that sums in float32 rounds a child's hessian sum by up to ``MASK_SLACK``
of its node's (a cumulative f32 sum over 256 bins: 255 x 6e-8 at most)
plus what its node's cells carry from its ancestors (:func:`carried`), so
the best gain is taken over the candidates that clear the mask by that
much, and the program's split may miss it by as much. A frozen node (bin
B - 1) must send the missing bucket left.

:func:`control_round` is the round in bfloat16 (g, h and leaves rounded
to it, sums in float32), shaped as the program's output.
"""

from __future__ import annotations

import torch

# the missing bucket's sums are products: keep a float32 control out of
# TF32 on a card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAIR_BLOCK = 1 << 26     # (row, feature) pairs a histogram block takes
MASK_SLACK = 2e-5
F64 = torch.float64


def carried(root_hessian: float, depth: int) -> float:
    """The most a float32 program's child hessian sum may carry from the
    ancestors of its node: below the root a node's cells are its parent's
    less its sibling's, and each such subtraction, the fold of the
    members' partials (up to 3 adds a cell) and the conversion of the
    kernel's fixed-point sums round to 2^-24 of an ancestor's cells, whose
    sum over a feature's bins is at most the root's hessian sum: (depth +
    3) roundings on each of a split's two sums (the missing bucket moved
    right takes one sum from another)."""
    return 2 * (depth + 3) * 2.0 ** -24 * root_hessian


def gradients(preds, y, w, dtype=F64):
    """(g, h) of the logistic loss in ``dtype``, weighted by ``w``."""
    p = torch.sigmoid(preds.to(dtype))
    ww = w.to(dtype)
    return (p - y.to(dtype)) * ww, p * (1.0 - p) * ww


def histograms(bins, gh, ids, n_nodes: int, n_bins: int, dtype):
    """[n_nodes, F, B, 2] sums of the two columns of ``gh`` ([N, 2]) by
    (node, feature, bin) in ``dtype``; rows whose id lies outside [0,
    n_nodes) add nothing."""
    N, F = bins.shape
    dev = bins.device
    present = torch.zeros((n_nodes * F * n_bins, 2), dtype=dtype,
                          device=dev)
    missing = torch.zeros((n_nodes * 2, F), dtype=dtype, device=dev)
    step = max(1, PAIR_BLOCK // F)
    for lo in range(0, N, step):
        ids_b = ids[lo:lo + step].long()
        rows = ((ids_b >= 0) & (ids_b < n_nodes)).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        node = ids_b[rows]
        b = bins[lo:lo + step][rows]
        v = gh[lo:lo + step][rows].to(dtype)
        r, f = (b != 0).nonzero(as_tuple=True)
        key = (node[r] * F + f) * n_bins + b[r, f].long()
        present.index_add_(0, key, v[r])
        weighted = torch.zeros((rows.numel(), n_nodes, 2), dtype=dtype,
                               device=dev)
        weighted[torch.arange(rows.numel(), device=dev), node] = v
        missing += weighted.reshape(rows.numel(), -1).T @ (b == 0).to(dtype)
    out = present.reshape(n_nodes, F, n_bins, 2)
    out[:, :, 0, :] = missing.reshape(n_nodes, 2, F).transpose(1, 2)
    return out


def member_ids(node, k: int, members: int, level: int):
    """Level ``level``'s histogram ids as the program's call takes them:
    member m's node j as ``m * k + j`` (left children only below the
    root: j = node // 2 of an even node), -1 where nothing is summed."""
    N = node.shape[0]
    member = torch.arange(N, device=node.device) // (N // members)
    if level == 0:
        return member * k + node
    return torch.where(node % 2 == 0, member * k + node // 2, -1)


def split_gains(hg, hh, reg_lambda: float, min_child_hessian: float,
                slack: float = 0.0, extra: float = 0.0):
    """(gain [n, F, B], missing goes right [n, F, B]) of every candidate,
    both variants of the missing bucket scored; a child must hold
    ``min_child_hessian`` plus ``slack`` of its node's hessian sum plus
    ``extra``. Out: -inf (the last bin, the mask, NaN)."""
    gl, hl = torch.cumsum(hg, -1), torch.cumsum(hh, -1)
    gt, ht = gl[:, :1, -1:], hl[:, :1, -1:]     # the node's totals
    least = min_child_hessian + slack * ht + extra

    def variant(a, b):
        out = a * a / (b + reg_lambda) + (gt - a) ** 2 / (ht - b
                                                          + reg_lambda)
        out = out - gt * gt / (ht + reg_lambda)
        if min_child_hessian > 0:
            out = torch.where((b >= least) & (ht - b >= least), out,
                              float("-inf"))
        return torch.where(torch.isnan(out), float("-inf"), out)

    left = variant(gl, hl)
    right = variant(gl - hg[..., :1], hl - hh[..., :1])
    right[..., 0] = float("-inf")
    gain = torch.maximum(left, right)
    gain[..., -1] = float("-inf")
    return gain, right > left


def route(bins, node, feat, bin_, dir_):
    """One level: ``2 * node + goes_right``, a missing value by ``dir``."""
    idx = node.long()
    v = bins.gather(1, feat[idx].long()[:, None])[:, 0]
    go = torch.where(v == 0, dir_[idx] > 0, v > bin_[idx])
    return node * 2 + go.to(node.dtype)


def _worst_rel(got, want):
    """Worst cell's gap over the largest exact cell (0 where all are 0)."""
    scale = want.abs().max().item()
    gap = (got.to(want.dtype) - want).abs().max().item()
    if gap != gap:                       # NaN in the program's output
        return float("inf")
    return gap / scale if scale > 0 else gap


def _taken(hg, hh, feat, bin_, dir_, cfg, extra: float):
    """Each node's gain of the split the program took (a child may miss
    the mask by ``MASK_SLACK`` of its node plus ``extra``); 0 for a frozen
    node that sends the missing bucket left, -inf for one that does
    not."""
    B = cfg["n_bins"]
    lam, mch = cfg["reg_lambda"], cfg["min_child_hessian"]
    nodes = torch.arange(hg.shape[0], device=hg.device)
    frozen = bin_ >= B - 1
    b = bin_.clamp(max=B - 1)
    right = dir_ > 0
    gl = hg.cumsum(-1)[nodes, feat, b] - torch.where(
        right, hg[nodes, feat, 0], 0.0)
    hl = hh.cumsum(-1)[nodes, feat, b] - torch.where(
        right, hh[nodes, feat, 0], 0.0)
    gt, ht = hg[:, 0].sum(-1), hh[:, 0].sum(-1)
    out = (gl * gl / (hl + lam) + (gt - gl) ** 2 / (ht - hl + lam)
           - gt * gt / (ht + lam))
    least = mch - MASK_SLACK * ht - extra
    if mch > 0:
        out = torch.where((hl >= least) & (ht - hl >= least), out,
                          float("-inf"))
    out = torch.where(right & (b == 0), float("-inf"), out)
    return torch.where(frozen, torch.where(right, float("-inf"), 0.0), out)


def judge_round(bins, y, w, preds_in, preds_out, tree, partials, folded,
                cfg, members: int):
    """The numbers of one round. ``bins``, ``y``, ``w``: the rows as the
    program holds them, padding included; ``tree`` is (feat, bin, dir,
    leaf); ``partials[d]`` and ``folded[d]`` are the program's (g, h)
    histogram planes of level d (the left children below level 0)."""
    F, B, depth = cfg["n_features"], cfg["n_bins"], cfg["depth"]
    lam, lr = cfg["reg_lambda"], cfg["learning_rate"]
    dev = bins.device
    g, h = gradients(preds_in, y, w)
    gh = torch.stack([g, h], 1)
    feat, bin_, dir_ = (t.to(dev).long() for t in tree[:3])
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
    out = {"hist_err": 0.0, "fold_err": 0.0, "split_regret": 0.0}
    start = 0
    for d in range(depth):
        n_nodes = 2 ** d
        k = 1 if d == 0 else n_nodes // 2
        parts = histograms(bins, gh, member_ids(node, k, members, d),
                           members * k, B, F64)
        out["hist_err"] = max(out["hist_err"],
                              _worst_rel(partials[d][0], parts[..., 0]),
                              _worst_rel(partials[d][1], parts[..., 1]))
        fsum = parts.reshape(members, k, F, B, 2).sum(0)
        out["fold_err"] = max(out["fold_err"],
                              _worst_rel(folded[d][0], fsum[..., 0]),
                              _worst_rel(folded[d][1], fsum[..., 1]))
        if d == 0:
            hg, hh = fsum[..., 0], fsum[..., 1]
            extra = carried(float(hh[0, 0].sum()), depth)
        else:      # right child = parent - left child, exact to f64
            hg = torch.stack([fsum[..., 0], hg - fsum[..., 0]],
                             1).reshape(n_nodes, F, B)
            hh = torch.stack([fsum[..., 1], hh - fsum[..., 1]],
                             1).reshape(n_nodes, F, B)
        best = split_gains(hg, hh, lam, cfg["min_child_hessian"], MASK_SLACK,
                           extra)[0].reshape(n_nodes, -1).max(1).values
        lvl = slice(start, start + n_nodes)
        chosen = _taken(hg, hh, feat[lvl], bin_[lvl], dir_[lvl], cfg, extra)
        # over the larger of the best gain and the node's own score: a
        # node of a row or two has gains of 0 to rounding
        gt, ht = hg[:, 0].sum(-1), hh[:, 0].sum(-1)
        scale = torch.maximum(best, gt * gt / (ht + lam))
        regret = torch.where(best > 0, (best - chosen) / scale,
                             torch.where(chosen == float("-inf"),
                                         float("inf"), 0.0))
        out["split_regret"] = max(out["split_regret"],
                                  regret.max().nan_to_num(float("inf")).item())
        node = route(bins, node, feat[lvl], bin_[lvl], dir_[lvl])
        start += n_nodes
    leaves = torch.zeros((2 ** depth, 2), dtype=F64, device=dev).index_add_(
        0, node, gh)
    leaf = -leaves[:, 0] / (leaves[:, 1] + lam)
    out["leaf_err"] = _worst_rel(tree[3].to(dev), leaf)
    step = lr * leaf[node]
    want = preds_in.to(F64) + step
    gap = (preds_out.to(F64) - want).abs().max().item()
    scale = step.abs().max().item()
    out["margin_err"] = (float("inf") if gap != gap
                         else gap / scale if scale > 0 else gap)
    return out


def control_round(bins, y, w, preds, cfg, members: int):
    """The round computed in bfloat16 in the program's place: g and h
    rounded to bf16, histograms and folds summed in f32, the right
    children by subtraction as the program derives them, splits on those
    sums (both variants, the mask), leaf values rounded to bf16. Returns
    what the program's round gives: (new margins, tree, partials,
    folded)."""
    F, B, depth = cfg["n_features"], cfg["n_bins"], cfg["depth"]
    lam, lr = cfg["reg_lambda"], cfg["learning_rate"]
    f32, bf16 = torch.float32, torch.bfloat16
    dev = bins.device
    g, h = (v.to(bf16).to(f32) for v in gradients(preds, y, w, f32))
    gh = torch.stack([g, h], 1)
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
    n_internal = 2 ** depth - 1
    t_feat, t_bin, t_dir = (torch.zeros(n_internal, dtype=torch.int32,
                                        device=dev) for _ in range(3))
    partials, folded = [], []
    start = 0
    for d in range(depth):
        n_nodes = 2 ** d
        k = 1 if d == 0 else n_nodes // 2
        parts = histograms(bins, gh, member_ids(node, k, members, d),
                           members * k, B, f32)
        fsum = parts.reshape(members, k, F, B, 2).sum(0)
        partials.append((parts[..., 0], parts[..., 1]))
        folded.append((fsum[..., 0], fsum[..., 1]))
        if d == 0:
            hg, hh = fsum[..., 0], fsum[..., 1]
        else:
            hg = torch.stack([fsum[..., 0], hg - fsum[..., 0]],
                             1).reshape(n_nodes, F, B)
            hh = torch.stack([fsum[..., 1],
                              (hh - fsum[..., 1]).clamp(min=0)],
                             1).reshape(n_nodes, F, B)
        gain, right = split_gains(hg, hh, lam, cfg["min_child_hessian"])
        best, arg = gain.reshape(n_nodes, -1).max(1)
        lvl = slice(start, start + n_nodes)
        split = best > 0
        t_feat[lvl] = (arg // B).to(torch.int32)
        t_bin[lvl] = torch.where(split, arg % B, B - 1).to(torch.int32)
        t_dir[lvl] = (right.reshape(n_nodes, -1).gather(1, arg[:, None])[:, 0]
                      & split).to(torch.int32)
        node = route(bins, node, t_feat[lvl], t_bin[lvl], t_dir[lvl])
        start += n_nodes
    leaves = torch.zeros((2 ** depth, 2), dtype=f32, device=dev).index_add_(
        0, node, gh)
    leaf = (-leaves[:, 0] / (leaves[:, 1] + lam)).to(bf16).to(f32)
    tree = (t_feat, t_bin, t_dir, leaf)
    return preds + lr * leaf[node], tree, partials, folded
