"""Plain reference of one GBDT boosting round with the learned missing
direction and the min-child mask, in float64 PyTorch.

It follows ytk-learn's histogram boosting round as the port states it
(``ytk_mp4j_tpu_torch/models/gbdt.py``), written again from that
description with plain ``torch`` operations; it imports no JAX, nothing
of either package and no kernel of the port:

- logistic gradients ``g = (sigmoid(z) - y) * w``, ``h = p (1 - p) w``;
- exact (node, feature, bin) sums of g and h (``index_add_`` in f64);
- every candidate "bin <= b goes left" scored twice: with the missing
  bucket (bin 0) on the left and on the right, the better kept (a tie
  keeps it left); a candidate whose left or right hessian sum is below
  ``min_child_hessian`` is out; so is the last bin;
- the best candidate of a node, ties to the first in (feature, bin)
  order; a node whose best gain is not above ``min_split_gain`` is
  frozen (bin B - 1, missing left);
- each row routed by ``bin > b``, a missing row by the node's learned
  direction;
- leaf values ``-G / (H + lambda)`` of the leaves' exact sums.

Departures from the port, none of which changes the mathematics: every
node's histogram is summed directly (the port builds the left children
and derives the right ones from the parent by subtraction, in f32 with a
clamp at 0 on the hessians), and nothing is rounded to f32.
"""

from __future__ import annotations

import torch

# a float32 product on a card may otherwise run in TF32; the reference
# runs in float64, and states the switches all the same
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64


def gradients(preds, y, weights):
    """(g, h) in f64 of the logistic loss at margins ``preds``."""
    p = torch.sigmoid(preds.to(F64))
    w = weights.to(F64)
    return (p - y.to(F64)) * w, p * (1.0 - p) * w


def histograms(bins, v, node, n_nodes: int, n_bins: int):
    """[n_nodes, F, B] exact sums of ``v`` by (node, feature, bin); rows
    whose node lies outside [0, n_nodes) add nothing."""
    N, F = bins.shape
    keep = (node >= 0) & (node < n_nodes)
    key = (node[keep].long()[:, None] * (F * n_bins)
           + torch.arange(F, device=bins.device) * n_bins
           + bins[keep].long())
    acc = torch.zeros(n_nodes * F * n_bins, dtype=F64, device=bins.device)
    acc.index_add_(0, key.reshape(-1),
                   v[keep].to(F64)[:, None].expand(-1, F).reshape(-1))
    return acc.reshape(n_nodes, F, n_bins)


def split_gains(hg, hh, reg_lambda: float, min_child_hessian: float,
                missing_bin: bool, slack: float = 0.0):
    """(gain [n, F, B], missing goes right [n, F, B] bool) of every
    candidate; candidates that are out have gain -inf. ``slack``: the mask
    asks each child for ``min_child_hessian`` plus this share of its
    node's hessian sum (a negative share admits children that fall short
    by as much)."""
    gl, hl = torch.cumsum(hg, -1), torch.cumsum(hh, -1)
    # the node's totals, the same for every feature, so that two features
    # that split the node's rows alike score alike to the last bit
    gt = hg[:, :1].sum(-1, keepdim=True)
    ht = hh[:, :1].sum(-1, keepdim=True)

    def score(a, b):
        return a * a / (b + reg_lambda)

    def variant(a, b):                  # a, b: the left child's sums
        out = score(a, b) + score(gt - a, ht - b) - score(gt, ht)
        if min_child_hessian > 0:
            least = min_child_hessian + slack * ht
            out = torch.where((b >= least) & (ht - b >= least), out,
                              float("-inf"))
        return torch.where(torch.isnan(out), float("-inf"), out)

    gain = variant(gl, hl)
    right = torch.zeros_like(gain, dtype=torch.bool)
    if missing_bin:
        gain_r = variant(gl - hg[..., :1], hl - hh[..., :1])
        gain_r[..., 0] = float("-inf")  # nothing would be left of b = 0
        right = gain_r > gain
        gain = torch.maximum(gain, gain_r)
    gain[..., -1] = float("-inf")
    return gain, right


def route(bins, node, feat, bin_, right, missing_bin: bool):
    """One level: ``2 * node + goes_right``."""
    idx = node.long()
    v = bins.gather(1, feat[idx].long()[:, None])[:, 0]
    go = v > bin_[idx]
    if missing_bin:
        go = torch.where(v == 0, right[idx].bool(), go)
    return node * 2 + go.to(node.dtype)


def boosting_round(bins, y, preds, weights, *, depth: int, n_bins: int,
                   learning_rate: float, reg_lambda: float,
                   min_child_hessian: float = 0.0,
                   min_split_gain: float = 0.0, missing_bin: bool = True,
                   follow=None, mask_slack: float = 0.0):
    """One round from margins ``preds``: returns (new margins [N] f64,
    tree ``(feat, bin, dir, leaf)`` in level-order heap layout, and each
    node's (best gain, gain of the split taken, own score G^2/(H+lambda)),
    a frozen node's split scoring 0).

    ``follow``: a tree ``(feat, bin, dir, ...)`` whose splits the round
    takes in place of its own best ones (its leaves are the reference's):
    the comparison of a program whose float32 gains chose another of two
    splits that tie to rounding. ``mask_slack``: a program that sums in
    float32 rounds a child's hessian sum by up to this share of its node's,
    so the best gain is then taken over the candidates that clear the mask
    by that much, and the taken split's gain admits a child that misses it
    by as much."""
    dev = bins.device
    g, h = gradients(preds, y, weights)
    n_internal = 2 ** depth - 1
    feat = torch.zeros(n_internal, dtype=torch.int64, device=dev)
    bin_ = torch.zeros(n_internal, dtype=torch.int64, device=dev)
    right = torch.zeros(n_internal, dtype=torch.int64, device=dev)
    scores = torch.zeros((n_internal, 3), dtype=F64, device=dev)
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
    start = 0
    for d in range(depth):
        n_nodes = 2 ** d
        hg = histograms(bins, g, node, n_nodes, n_bins)
        hh = histograms(bins, h, node, n_nodes, n_bins)
        gain, goes_right = split_gains(hg, hh, reg_lambda,
                                       min_child_hessian, missing_bin)
        flat = gain.reshape(n_nodes, -1)
        best = torch.argmax(flat, dim=1)        # the first maximum
        top = flat.gather(1, best[:, None])[:, 0]
        frozen = ~(top > min_split_gain)
        lvl = slice(start, start + n_nodes)
        feat[lvl] = best // n_bins
        bin_[lvl] = torch.where(frozen, n_bins - 1, best % n_bins)
        right[lvl] = torch.where(
            frozen, 0, goes_right.reshape(n_nodes, -1).gather(
                1, best[:, None])[:, 0].long())
        if follow is not None:
            feat[lvl], bin_[lvl], right[lvl] = (
                t[lvl].to(dev).long() for t in follow[:3])
            top = split_gains(hg, hh, reg_lambda, min_child_hessian,
                              missing_bin, mask_slack)[0].reshape(
                                  n_nodes, -1).max(1).values
        gt, ht = hg[:, 0].sum(-1), hh[:, 0].sum(-1)
        scores[lvl, 0] = top
        scores[lvl, 1] = _taken_gain(hg, hh, feat[lvl], bin_[lvl],
                                     right[lvl], reg_lambda,
                                     min_child_hessian, mask_slack, n_bins)
        scores[lvl, 2] = gt * gt / (ht + reg_lambda)
        node = route(bins, node, feat[lvl], bin_[lvl], right[lvl],
                     missing_bin)
        start += n_nodes
    n_leaves = 2 ** depth
    leaf_g = torch.zeros(n_leaves, dtype=F64, device=dev).index_add_(0, node,
                                                                     g)
    leaf_h = torch.zeros(n_leaves, dtype=F64, device=dev).index_add_(0, node,
                                                                     h)
    leaf = -leaf_g / (leaf_h + reg_lambda)
    new = preds.to(F64) + learning_rate * leaf[node]
    return new, (feat, bin_, right, leaf), scores


def _taken_gain(hg, hh, feat, bin_, right, reg_lambda, min_child_hessian,
                slack, n_bins):
    """Each node's gain of the split (feat, bin, dir) it takes; 0 for a
    frozen node (bin B - 1), -inf for a split the mask rules out (with
    ``slack`` of the node's hessian sum)."""
    rows = torch.arange(hg.shape[0], device=hg.device)
    cg, ch = torch.cumsum(hg, -1), torch.cumsum(hh, -1)
    gl, hl = cg[rows, feat, bin_], ch[rows, feat, bin_]
    gl = gl - torch.where(right.bool(), hg[rows, feat, 0], 0.0)
    hl = hl - torch.where(right.bool(), hh[rows, feat, 0], 0.0)
    gt, ht = hg[:, 0].sum(-1), hh[:, 0].sum(-1)
    out = (gl * gl / (hl + reg_lambda) + (gt - gl) ** 2 / (ht - hl
                                                          + reg_lambda)
           - gt * gt / (ht + reg_lambda))
    if min_child_hessian > 0:
        least = min_child_hessian - slack * ht
        out = torch.where((hl >= least) & (ht - hl >= least), out,
                          float("-inf"))
    return torch.where(bin_ == n_bins - 1, 0.0, out)


def regret(scores):
    """Each node's (best gain - gain of the split taken) over the larger of
    the best gain and the node's own score (``scores`` as
    :func:`boosting_round` gives them); 0 where no split gains."""
    best, taken, own = scores.unbind(1)
    return torch.where(best > 0, (best - taken) / torch.maximum(best, own),
                       torch.zeros_like(best))
