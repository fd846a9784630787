"""Data-parallel GBDT: the histogram boosting round of
``ytk_mp4j_tpu/models/gbdt.py`` in PyTorch, over a mesh of members.

ytk-mp4j's flagship consumer is ytk-learn's distributed GBDT. Each tree
level does four things: every member builds (node x feature x bin)
gradient/hessian histograms over its own rows (:func:`build_histograms`,
which reaches the hand-written CUDA kernel behind
``ops.hist_kernel.histograms``), the members' histograms are allreduced,
the best split per node is chosen on the sums (:func:`best_splits`) and
every row is routed to its child node (:func:`_route_samples`, the
hand-written CUDA kernel behind ``ops.route_kernel.route``, which also
writes each row's id in the next level's histogram call). After
the last level the leaf sums (:func:`_segment_sum2`, the hand-written
CUDA kernel behind ``ops.leaf_sums.leaf_sums``) are allreduced the same
way.

The members (``device.make_mesh`` / ``make_hier_mesh``) share one
device: member m holds rows ``[m * per, (m + 1) * per)`` of one tensor.
One histogram call a level covers every member, member m's node k as id
``m * n_nodes + k``, and the members' histograms are folded in rank order
(:func:`_fold`, ``ops.collectives.reduce_all``, the counterpart of the
reference's ``lax.psum``). Splits are chosen once on the folded sums, so
every member holds the same tree, and routing runs once over all rows.

Over processes (``comm.distributed.global_mesh`` / ``hier_global_mesh``)
each process holds its members' rows on its own device and makes one
histogram call a level over them; :func:`_fold_across` then gathers every
rank's ``[n_local * k, ...]`` partials in rank order (the g and h planes
in one gather) and folds all n members in rank order, exactly as one
process folds n members, and the fixed-point
scale of the histogram kernel is the job's (its max|g| and max|h| agreed
by one MAX all-reduce a tree), so every member's partial is bitwise the
one-process partial: trees and margins equal a one-process
``make_mesh(n)``'s bit for bit. The gather moves n times the bytes of an
allreduce; it is the price of the rank order (an NCCL or gloo
all-reduce sums in its own order, and folding each process's members
first would group the sums differently).

Over a list mesh (``device.make_mesh(n, devices=...)``, the reference's
one member a device) member m's rows are a tensor of their own on
``devices[m]``, and the same round (:func:`train_tree_shard`,
:func:`_build_tree`) runs over them: it works over blocks, a block being
one device's rows of consecutive members -- the packed mesh one block of
every member, the list mesh one block a member. Each level makes one
histogram call a block, with the job's fixed-point scale where several
calls make the partials (a MAX of the blocks' :func:`hist_kernel.
absmax_bits`, so each partial is bitwise the packed call's slice of
it); the members' histograms and leaf sums are folded in rank order by
the list form of ``ops.collectives`` (on member 0's device, the result
copied back to every member); every block chooses the splits on its copy
of the folded sums and routes its own rows, as after the reference's
``psum``. Trees and margins are bitwise the packed ``make_mesh(n)``'s
(on the CPU only where the gradients are exact, as the squared loss's:
ATen's vectorised sigmoid and exp round a row by its place in the
tensor). Nothing in the level loop waits on the host: each member's work
is queued on its device's stream, and only the folds' copies join them.

Functions take tensors on an explicit device; :class:`GBDTTrainer` runs
on ``cuda:0`` unless given a mesh or ``device="cpu"``. Trees are tuples
of tensors ``(feat, bin, dir, leaf)`` in level-order heap layout, as in
the reference, and a C-tuple of them per round for softmax.

Intended divergences from the reference:

- ``train`` returns the margins of the padded ``[n * per]`` rows (the
  reference's layout) as a tensor on the device, and ``predict`` returns
  a tensor, where the reference returns numpy;
- stochastic boosting draws from ``torch.Generator`` streams, one per
  member, seeded from (seed, member), so subsampled trees differ from
  the reference's ``jax.random`` trees;
- leaf sums accumulate in float64 and round once to float32;
- over processes the trees and margins equal one process's bit for bit
  (the reference's global mesh sums by ``psum``, in its own order);
- :class:`GBDTServable` (:func:`servable`, the serve plane's reduce-mode
  adapter, routing on the host in numpy as the reference does) takes the
  port's trees on any device, keeping detached host copies (int32 split
  components, float32 leaves), or the reference's numpy trees, where the
  reference fetches with ``jax.device_get``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ytk_mp4j_tpu_torch.device import make_device
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models._base import (DataParallelTrainer,
                                             EarlyStopper,
                                             StepStatsExchanger, as_numpy,
                                             as_tensor, fold_across,
                                             load_npz, per_example_loss,
                                             save_npz, stage_softmax_labels)
from ytk_mp4j_tpu_torch.comm.distributed import all_reduce_
from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
from ytk_mp4j_tpu_torch.obs import spans
from ytk_mp4j_tpu_torch.operators import Operators
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import hist_kernel, leaf_sums, route_kernel


@dataclass(frozen=True)
class GBDTConfig:
    n_features: int = 28
    n_bins: int = 256           # byte-binned, like ytk-learn's 256-bin hists
    depth: int = 6
    # "squared": regression (g = pred - y, h = 1); "logistic": binary
    # classification on {0,1} labels with second-order (Newton) leaf
    # values; "softmax": multiclass on integer labels -- one tree per
    # class per round against the diagonal softmax gradient/hessian
    loss: str = "squared"
    n_classes: int = 2          # used by loss="softmax" only
    # stochastic boosting (ytk-learn's sample_rate / feature_sample_rate):
    # per tree, each sample is kept with prob ``subsample`` (dropped
    # samples get weight 0; kept ones are scaled 1/subsample so
    # gradient sums stay unbiased) and each feature is kept with prob
    # ``colsample`` (masked features never win a split)
    subsample: float = 1.0
    colsample: float = 1.0
    # split regularization (ytk-learn's min-gain / min-child thresholds):
    # a node whose best gain < min_split_gain stops splitting (routes all
    # samples left, equivalent to keeping the node a leaf); candidate
    # splits whose left or right hessian sum < min_child_hessian are
    # disqualified
    min_split_gain: float = 0.0
    min_child_hessian: float = 0.0
    learning_rate: float = 0.1
    reg_lambda: float = 1.0
    n_trees: int = 10
    # "pallas" (default): the hand-written CUDA histogram kernel on a
    # CUDA tensor (the name is the reference's, whose kernel is Pallas;
    # on a CPU tensor the kernel's plain version runs). "matmul", "pair"
    # and "flat": the plain PyTorch histogram on any device -- explicit
    # user choices, never a fallback
    hist_mode: str = "pallas"
    # Missing-value handling (ytk-learn routes missing by a learned
    # per-split default direction): when True, bin 0 is the RESERVED
    # missing bucket across all features and every split evaluates both
    # "missing goes left" and "missing goes right", keeping the better
    # gain; the chosen direction is stored per node and replayed at
    # predict time.
    missing_bin: bool = False
    # Categorical features (ytk-learn's one-hot split type): listed
    # feature indices split by EQUALITY -- "bin == b goes right, rest
    # left" -- instead of the ordered "bin <= b" rule. Bin B-1 cannot be
    # a split category (it doubles as the node-freeze sentinel); bin
    # categorical values into [0, B-2] (and into [1, B-2] under
    # missing_bin, where 0 is the missing bucket).
    categorical_features: tuple = ()

    def __post_init__(self):
        if self.hist_mode not in ("pallas", "matmul", "pair", "flat"):
            raise Mp4jError(
                f"hist_mode must be 'pallas', 'matmul', 'pair' or "
                f"'flat', got {self.hist_mode!r}")
        if self.loss not in ("squared", "logistic", "softmax"):
            raise Mp4jError(
                f"loss must be 'squared', 'logistic' or 'softmax', "
                f"got {self.loss!r}")
        if self.loss == "softmax" and self.n_classes < 2:
            raise Mp4jError(
                f"softmax needs n_classes >= 2, got {self.n_classes}")
        if not (0.0 < self.subsample <= 1.0
                and 0.0 < self.colsample <= 1.0):
            raise Mp4jError(
                f"subsample/colsample must be in (0, 1], got "
                f"{self.subsample}/{self.colsample}")
        cats = []
        for f in self.categorical_features:
            if isinstance(f, bool) or not isinstance(f, (int, np.integer)):
                raise Mp4jError(
                    f"categorical_features must be int feature indices, "
                    f"got {f!r}")
            if not 0 <= f < self.n_features:
                raise Mp4jError(
                    f"categorical_features must be indices in [0, "
                    f"{self.n_features}), got {f}")
            cats.append(int(f))
        object.__setattr__(self, "categorical_features", tuple(cats))

    def _cat_mask(self) -> np.ndarray | None:
        """[F] bool mask of equality-split features (None when there are
        none)."""
        if not self.categorical_features:
            return None
        m = np.zeros(self.n_features, bool)
        m[list(self.categorical_features)] = True
        return m


# ----------------------------------------------------------------------
# one tree level: histograms, splits, routing
# ----------------------------------------------------------------------
def build_histograms(bins, g, h, node_ids, n_nodes: int, cfg: GBDTConfig,
                     absmax=None):
    """Per-(node, feature, bin) gradient/hessian sums.

    bins: [N, F] int32 (values in [0, B)); g, h: [N] f32; node_ids: [N]
    int32 -- ids outside [0, n_nodes) contribute nothing (the sibling
    subtraction in :func:`_build_tree` passes a sentinel id for
    right-child samples and depends on this). Returns (hist_g, hist_h):
    [n_nodes, F, B] f32. ``hist_mode="pallas"`` goes through
    ``ops.hist_kernel.histograms`` (the CUDA kernel on a CUDA tensor,
    ``absmax`` its fixed-point scale); the other modes take its plain
    version on any device.
    """
    F, B = cfg.n_features, cfg.n_bins
    if cfg.hist_mode == "pallas":
        return hist_kernel.histograms(bins, g, h, node_ids, n_nodes, F, B,
                                      absmax)
    return hist_kernel.histograms_reference(bins, g, h, node_ids, n_nodes,
                                            F, B)


def _route_samples(bins, node_ids, feat, bin_, dir_=None, cat_mask=None,
                   missing_bin: bool = False, n_bins: int | None = None,
                   n_members: int | None = None, plain: bool = False,
                   check: bool = True):
    """One level of sample routing: ``node_ids*2 + go_right``, where
    ``go_right`` is ``bins[i, feat[n]] > bin_[n]`` for numeric features,
    ``== bin_[n]`` for categorical ones (never at the freeze sentinel
    B-1), and the node's learned default direction ``dir_`` for the
    missing bucket (bin 0) under ``missing_bin``. node_ids must lie in
    [0, len(feat)). With ``n_members`` also the next level's histogram
    ids, ``(next ids, ids)``: a left child's member-offset id, the
    sentinel for a right child.

    The one routing call of :func:`_build_tree` and :func:`predict_tree`
    (and the seam the tests patch). ``plain`` (what ``hist_mode !=
    "pallas"`` asks for: the reference mode runs no hand-written kernel)
    takes ``ops.route_kernel.route_reference`` on any device; else
    ``ops.route_kernel.route``, the CUDA kernel on a CUDA tensor and the
    plain version on the CPU, which refuses out-of-range rows unless
    ``check=False``."""
    if plain:
        return route_kernel.route_reference(bins, node_ids, feat, bin_, dir_,
                                            cat_mask, missing_bin, n_bins,
                                            n_members)
    return route_kernel.route(bins, node_ids, feat, bin_, dir_, cat_mask,
                              missing_bin, n_bins, n_members, check)


def split_gains(hist_g, hist_h, reg_lambda: float, feat_mask=None,
                min_child_hessian: float = 0.0, cat_mask=None,
                missing_bin: bool = False):
    """Regularized gain of every candidate split.

    hist_*: [n_nodes, F, B]. Returns (gain [n_nodes, F, B], dir
    [n_nodes, F, B] bool): candidate (f, b) is "bin <= b goes left" for
    numeric features and "bin == b goes right" for features flagged in
    ``cat_mask`` ([F] bool). ``dir`` is the missing bucket's default
    direction (True = right; all False unless ``missing_bin``): with
    ``missing_bin`` every numeric candidate is scored with bin 0's G/H on
    the left AND on the right, and the better variant wins. Disqualified
    candidates have gain -inf: the last bin, features masked out by
    ``feat_mask`` ([F] bool), children with hessian sum <
    ``min_child_hessian``, and NaN gains (0/0 at reg_lambda == 0).
    """
    cg = torch.cumsum(hist_g, dim=-1)       # G_left for split at bin b
    ch = torch.cumsum(hist_h, dim=-1)
    Gt = cg[..., -1:]
    Ht = ch[..., -1:]
    lam = reg_lambda
    mch = min_child_hessian
    neg_inf = float("-inf")

    def score(G, H):
        return (G * G) / (H + lam)

    def variant_gain(GL, HL):
        """Gain of a (left, right) partition given the left sums. A NaN
        is disqualified per variant: it would otherwise propagate
        through the maximum of the missing-left/right variants and win
        the argmax."""
        g = score(GL, HL) + score(Gt - GL, Ht - HL) - score(Gt, Ht)
        if mch > 0.0:
            ok = (HL >= mch) & (Ht - HL >= mch)
            g = torch.where(ok, g, neg_inf)
        return torch.where(torch.isnan(g), neg_inf, g)

    gain = variant_gain(cg, ch)             # missing (bin 0) left
    direction = torch.zeros(gain.shape, dtype=torch.bool,
                            device=gain.device)
    if missing_bin:
        # move bin 0 (the reserved missing bucket) to the right child
        gain_r = variant_gain(cg - hist_g[..., :1], ch - hist_h[..., :1])
        # at b=0 the right variant's left child is empty by construction
        gain_r[..., 0] = neg_inf
        direction = gain_r > gain
        gain = torch.maximum(gain, gain_r)
    if cat_mask is not None:
        # equality split: category b alone goes right
        cat_gain = variant_gain(Gt - hist_g, Ht - hist_h)
        cat = torch.as_tensor(cat_mask, device=gain.device)[None, :, None]
        gain = torch.where(cat, cat_gain, gain)
        direction = direction & ~cat
    # splitting at the last bin sends everything left (numeric) /
    # doubles as the freeze sentinel (categorical) -- never a candidate
    gain[..., -1] = neg_inf
    if feat_mask is not None:
        gain = torch.where(feat_mask[None, :, None], gain, neg_inf)
    return gain, direction


def best_splits(hist_g, hist_h, reg_lambda: float, feat_mask=None,
                min_child_hessian: float = 0.0, cat_mask=None,
                missing_bin: bool = False):
    """Regularized best split per node, over :func:`split_gains`.

    Returns (feat [n_nodes] int32, bin [n_nodes] int32, gain [n_nodes],
    dir [n_nodes] int32). Ties go to the first maximum in (feature, bin)
    order, as ``jnp.argmax`` gives them in the reference."""
    gain, direction = split_gains(hist_g, hist_h, reg_lambda, feat_mask,
                                  min_child_hessian, cat_mask, missing_bin)
    n = gain.shape[0]
    B = hist_g.shape[-1]
    flat = gain.reshape(n, -1)
    best = torch.argmax(flat, dim=-1)
    best_dir = direction.reshape(n, -1).gather(1, best[:, None])[:, 0]
    return ((best // B).to(torch.int32), (best % B).to(torch.int32),
            flat.gather(1, best[:, None])[:, 0], best_dir.to(torch.int32))


def _segment_sum2(val_a, val_b, node_ids, n_members: int, n_leaves: int):
    """Per-(member, leaf) float64 sums of two f32 value vectors (the leaf
    G/H), member m's leaf l at ``m * n_leaves + l``: ``node_ids`` are
    member-local, member m holding the m-th of ``n_members`` equal blocks
    of rows. ``ops.leaf_sums.leaf_sums``: the CUDA kernel on a CUDA
    tensor, its plain version on the CPU. On the card each member's sums
    are bitwise the same in every run and whichever call holds its rows
    (packed, one a member, or a process's)."""
    return leaf_sums.leaf_sums(val_a, val_b, node_ids, n_leaves, n_members)


def _fold(x, n_members: int):
    """The members' partial sums ``[n_members * k, ...]`` (member m's at
    rows ``[m * k, (m + 1) * k)``) -> their ``[k, ...]`` sum, folded in
    rank order: the histogram and leaf-sum allreduce, the reference's
    ``lax.psum``. Every member holds the result. ``x`` may instead be a
    member list, member m's ``[k, ...]`` partials on its own device: the
    same adds on member 0's device, and a list of every member's copy of
    the sum on its device."""
    if coll.is_list(x):
        return coll.allreduce(x)
    return coll.reduce_all(x.reshape((n_members, -1) + tuple(x.shape[1:])))


# :func:`_fold` over every rank of a process group (``_base.fold_across``,
# shared with the FM and linear trainers); a module global, so that a
# caller can wrap it
_fold_across = fold_across


# ----------------------------------------------------------------------
# one boosting round (tree build)
# ----------------------------------------------------------------------
# Each round is a ``gbdt::round`` span (``obs.spans.span``) whose id is
# its number in this process (:data:`rounds_built`); each level of a tree
# a ``gbdt::level``. Every launch of a round falls inside exactly one of
# the phase spans ``gbdt::gradients`` (g/h and the round's set-up
# tensors), ``gbdt::histograms`` (a level's histogram call; the root's
# ids and the job's scale), ``gbdt::fold`` (a level's fold),
# ``gbdt::splits`` (sibling subtraction, best splits, freeze, the tree's
# tables; its arg ``variants`` is the candidates scored a (feature, bin):
# 2 under ``missing_bin``, missing left and right, else 1),
# ``gbdt::route`` (each row's next node id and, below the last level, its
# id in the next level's histogram call), ``gbdt::leaf_sums`` (the leaf
# sums and their fold) and ``gbdt::margins`` (leaf values and the
# margins' update).
_round_ids = itertools.count(1)
rounds_built = 0      # rounds begun in this process: the latest's id


def _next_round() -> int:
    global rounds_built
    rounds_built = r = next(_round_ids)
    return r


def _phase(name: str, tags: dict, **args):
    """The span ``gbdt::<name>`` of one phase, with the tree's ``tags``
    (a softmax tree's class)."""
    return spans.span("gbdt::" + name, "gbdt", **tags, **args)


def _build_tree(bins, g, h, cfg: GBDTConfig, feat_mask, n_members: int = 1,
                group=None, tags=None):
    """Grow one tree from per-sample gradients/hessians over blocks of
    members. ``bins``, ``g``, ``h`` and ``feat_mask`` ([F] bool or None)
    are lists, one entry a block: a block is one device's rows of
    ``n_members`` consecutive members, member m holding its rows ``[m *
    per, (m + 1) * per)``. The packed mesh is one block of every member
    (with a process ``group``, this rank's members, and the folds cross
    the ranks); the list mesh is one block a member. Each level makes one
    histogram call a block, member m's node k as id ``m * n_nodes + k``,
    and folds the members in rank order (:func:`_fold`); the leaf sums
    likewise. Every block chooses the splits on its own copy of the
    folded sums and routes its own rows; the tree's tables are block 0's.
    ``tags``: args of the tree's spans. Returns (delta, one [rows] tensor
    a block -- the learning-rate-scaled leaf value each sample receives
    -- and the tree)."""
    F, B = cfg.n_features, cfg.n_bins
    n = n_members
    tags = tags or {}
    for x in bins:
        if x.shape[0] % n:
            raise Mp4jError(f"{x.shape[0]} rows do not split into {n} "
                            "equal shards")
    blocks = range(len(bins))
    dev0 = bins[0].device
    n_internal = 2 ** cfg.depth - 1
    with _phase("gradients", tags):
        node_ids = [torch.zeros(x.shape[0], dtype=torch.int32,
                                device=x.device) for x in bins]
        tree_feat, tree_bin, tree_dir = (
            torch.zeros(n_internal, dtype=torch.int32, device=dev0)
            for _ in range(3))
        # the categorical mask, and a copy on each block's device for
        # routing
        cat_mask = cfg._cat_mask()
        cat_dev = [None if cat_mask is None
                   else torch.as_tensor(cat_mask, device=x.device)
                   for x in bins]

    def fold2(a, b):
        """Fold the blocks' g and h partials: each block's copy of the
        sums. Across processes both planes ride one gather (the same
        element-wise adds, one host round trip)."""
        if group is not None:
            both = _fold_across(torch.stack([a[0], b[0]], dim=1), n, group)
            return [both[:, 0].contiguous()], [both[:, 1].contiguous()]
        if len(a) > 1:
            return _fold(a, n), _fold(b, n)
        return [_fold(a[0], n)], [_fold(b[0], n)]

    plain = cfg.hist_mode != "pallas"
    variants = 2 if cfg.missing_bin else 1
    absmax = [None] * len(bins)
    level_start = 0
    prev_hg = prev_hh = None
    for d in range(cfg.depth):
        n_nodes = 2 ** d
        with _phase("level", tags, level=d, nodes=n_nodes):
            with _phase("histograms", tags):
                if d == 0:
                    # where several calls make the job's partials (blocks
                    # or processes) the kernel's fixed-point scale is the
                    # job's, so that each member's partial is the one a
                    # single call over every row gives (the plain version
                    # on the CPU has no scale); a list of one block is
                    # folded without a launch
                    if ((len(bins) > 1 or group is not None)
                            and cfg.hist_mode == "pallas"
                            and dev0.type == "cuda"):
                        absmax = coll.allreduce(
                            [hist_kernel.absmax_bits(g[b], h[b])
                             for b in blocks], Operators.MAX)
                        if group is not None:
                            absmax = [all_reduce_(a, Operators.MAX, group)
                                      for a in absmax]
                    # the root's id of a row is its member
                    k = 1
                    ids = [torch.arange(x.shape[0], dtype=torch.int32,
                                        device=x.device) // (x.shape[0] // n)
                           if n > 1 else node_ids[b]
                           for b, x in enumerate(bins)]
                else:
                    # sibling subtraction, hist(parent) = hist(left) +
                    # hist(right): build only the LEFT children -- samples
                    # in right nodes map to an out-of-range sentinel id
                    # and contribute nothing -- and derive the right
                    # siblings from the previous level. A derived right
                    # child inherits error relative to its parent's
                    # magnitude; the hessian clamp keeps that noise from
                    # producing negative hessian sums. The sentinel is
                    # n * k: any smaller id is some member's left child.
                    # The level above routed its rows to these ids.
                    k = n_nodes // 2
                    ids = hist_ids
                parts = [build_histograms(bins[b], g[b], h[b], ids[b], n * k,
                                          cfg, absmax[b]) for b in blocks]
            with _phase("fold", tags):
                hl_g, hl_h = fold2([p[0] for p in parts],
                                   [p[1] for p in parts])
            with _phase("splits", tags, variants=variants):
                if d == 0:
                    hg, hh = hl_g, hl_h
                else:
                    hg = [torch.stack([lg, pg - lg],
                                      dim=1).reshape(n_nodes, F, B)
                          for lg, pg in zip(hl_g, prev_hg)]
                    hh = [torch.stack(
                        [lh, torch.clamp(ph - lh, min=0.0)],
                        dim=1).reshape(n_nodes, F, B)
                        for lh, ph in zip(hl_h, prev_hh)]
                prev_hg, prev_hh = hg, hh
                splits = []
                for b in blocks:
                    feat, bin_, gain, dir_ = best_splits(
                        hg[b], hh[b], cfg.reg_lambda, feat_mask[b],
                        cfg.min_child_hessian, cat_mask, cfg.missing_bin)
                    # freeze any node whose best gain does not clear the
                    # threshold: bin B-1 routes every sample left, keeping
                    # the node whole. The ~(gain > thr) form also freezes
                    # gain == 0, gain == -inf and NaN; a frozen node sends
                    # missing left.
                    freeze = ~(gain > cfg.min_split_gain)
                    splits.append((feat,
                                   torch.where(freeze, cfg.n_bins - 1, bin_),
                                   torch.where(freeze, 0, dir_)))
                for table, col in zip((tree_feat, tree_bin, tree_dir),
                                      splits[0]):
                    table[level_start:level_start + n_nodes] = col
            with _phase("route", tags):
                # each row's next node id and, below the last level, its
                # id in the next level's histogram call; no wait for the
                # card: the tables are best_splits' (features in [0, F))
                # and the node ids the route's own
                last = d == cfg.depth - 1
                routed = [_route_samples(bins[b], node_ids[b], *splits[b],
                                         cat_dev[b], cfg.missing_bin,
                                         cfg.n_bins, None if last else n,
                                         plain, check=False)
                          for b in blocks]
                if last:
                    node_ids = routed
                else:
                    node_ids, hist_ids = (list(x) for x in zip(*routed))
        level_start += n_nodes

    n_leaves = 2 ** cfg.depth
    with _phase("leaf_sums", tags):
        sums = [_segment_sum2(g[b], h[b], node_ids[b], n, n_leaves)
                for b in blocks]
        leaf_g, leaf_h = fold2([s[0] for s in sums], [s[1] for s in sums])
    with _phase("margins", tags):
        leaf_val = [-lg.float() / (lh.float() + cfg.reg_lambda)
                    for lg, lh in zip(leaf_g, leaf_h)]
        delta = [cfg.learning_rate * lv[ids.long()]
                 for lv, ids in zip(leaf_val, node_ids)]
    return delta, (tree_feat, tree_bin, tree_dir, leaf_val[0])


# odd 64-bit stride between the members' seeds (the golden-ratio constant)
_MEMBER_SEED_STRIDE = 0x9E3779B97F4A7C15


def member_generators(seed: int, n_members: int, device, first: int = 0):
    """One ``torch.Generator`` on ``device`` per member, member m seeded
    with ``(seed + m * stride) mod 2**64`` -- the counterpart of the
    reference folding the shard index into its key -- for the global
    members ``[first, first + n_members)``. Member 0 draws the stream a
    one-member trainer draws from ``seed``. ``device`` may be a list of
    the members' devices (a list mesh): member m's generator is then on
    ``device[m]``, with the same seed."""
    gens = []
    for m in range(first, first + n_members):
        gen = torch.Generator(device=(device[m - first]
                                      if isinstance(device, (list, tuple))
                                      else device))
        gen.manual_seed((seed + m * _MEMBER_SEED_STRIDE) % 2 ** 64)
        gens.append(gen)
    return gens


def _feature_mask(gen, cfg: GBDTConfig, device):
    """[F] bool: the features a tree may split on, drawn from ``gen``
    (member 0's stream); at least one survives."""
    F = cfg.n_features
    keep = torch.rand(F, generator=gen, device=device) < cfg.colsample
    rescue = torch.randint(0, F, (), generator=gen, device=device)
    fallback = (torch.arange(F, device=device) == rescue) & ~keep.any()
    return keep | fallback


def _sampling_masks(generators, cfg: GBDTConfig, N: int, device,
                    lead=None):
    """Per-tree stochastic-boosting masks. ``generators``: a sequence of
    ``torch.Generator``, one per member (one member: a list of one),
    member m's rows being the m-th of ``len`` equal blocks of N; None ->
    no masks. ``device``: the members' device, or a list of the blocks'
    devices (a list mesh: one block a member, each generator on its
    block's device).

    Returns (sample_scale [N] f32 | None, feat_mask [F] bool | None); for
    a list of devices, each a list of one a block on its device, or None.
    The feature mask comes from member 0's generator alone, so it is the
    same on every member; each member draws its rows' keeps from its own.
    Member 0 is the first generator, or ``lead`` where this process holds
    other members (a mesh over processes) and a feature mask is drawn:
    ``lead`` draws the feature mask, then as many row keeps as member 0
    draws, which it drops, so that its stream stays member 0's.
    Kept samples are scaled 1/subsample to keep gradient sums unbiased;
    at least one feature always survives (an all-dropped draw keeps one
    uniformly random feature)."""
    if generators is None:
        return None, None
    devs = device if isinstance(device, (list, tuple)) else [device]
    per = N // len(generators)
    at = len(generators) // len(devs)         # members a block
    sample_scale = feat_mask = None
    if cfg.colsample < 1.0:
        mask = _feature_mask(generators[0] if lead is None else lead, cfg,
                             devs[0])
        feat_mask = [mask.to(d, non_blocking=True) for d in devs]
    if cfg.subsample < 1.0:
        if lead is not None:
            torch.rand(per, generator=lead, device=devs[0])
        sample_scale = [
            (torch.cat([torch.rand(per, generator=gen, device=d)
                        for gen in generators[b * at:(b + 1) * at]])
             < cfg.subsample).to(torch.float32) / cfg.subsample
            for b, d in enumerate(devs)]
    if devs is not device:
        return tuple(None if m is None else m[0]
                     for m in (sample_scale, feat_mask))
    return sample_scale, feat_mask


def _gradients(preds, y, weights, cfg: GBDTConfig, c=None):
    """One block's per-sample gradient and hessian: of class ``c`` under
    "softmax" (``preds`` then the softmax probabilities [N, C], ``y``
    integer labels: g_c = p_c - 1[y=c], h_c = p_c (1 - p_c)), else of the
    margins [N]; each scaled by ``weights`` where given."""
    if cfg.loss == "softmax":
        onehot_y = (y.to(torch.int32) == c).to(torch.float32)
        g = preds[:, c] - onehot_y
        h = preds[:, c] * (1.0 - preds[:, c])
    elif cfg.loss == "logistic":
        p = torch.sigmoid(preds)
        g = p - y
        h = p * (1.0 - p)
    else:  # squared error: g = pred - y, h = 1
        g = preds - y
        h = torch.ones_like(preds)
    if weights is not None:
        g = g * weights
        h = h * weights
    return g, h


def train_tree_shard(bins, y, preds, cfg: GBDTConfig, weights=None,
                     generators=None, masks=None, n_members: int = 1,
                     group=None, lead=None):
    """One boosting round on these samples. Returns (new_preds, tree).

    ``weights`` ([N] f32, default all-ones) scales each sample's
    gradient/hessian contribution -- the trainer uses weight 0 to
    neutralize shard-padding rows. ``generators`` (one per member, see
    :func:`member_generators`) draw the per-tree stochastic-boosting
    masks when cfg.subsample/colsample < 1; ``masks=(sample_scale | None,
    feat_mask | None)`` hands them in ready-made instead (no generators
    and no masks -> full-data trees). ``n_members`` members hold equal
    blocks of the rows, in rank order (see :func:`_build_tree`); with a
    process ``group`` they are this rank's members, and ``lead`` is
    member 0's generator where this rank does not hold member 0 and
    cfg.colsample < 1 (see :func:`_sampling_masks`).

    Over a list mesh ``bins``, ``y``, ``preds`` and ``weights`` are lists
    of the ``n_members`` members' tensors, each on its member's device
    (``generators`` and ready-made ``masks`` likewise, one a member); the
    new preds are then a list, and the tree is on member 0's device. The
    trees and preds are bitwise those of the packed call on the stacked
    members.

    Scalar objectives ("squared", "logistic"): preds/y are [N]; one tree
    is grown; tree = (feat, bin, dir, leaf) in level-order heap layout.
    "softmax": preds are margins [N, C], y is integer class labels [N];
    one tree is grown PER CLASS against the diagonal softmax g/h
    (:func:`_gradients`); tree = a C-tuple, and the spans of class c's
    tree carry ``class=c``.

    The round is one ``gbdt::round`` span, its id the round's number
    (:data:`rounds_built`), each of its launches inside one phase span
    (the names above :func:`_next_round`).
    """
    listed = coll.is_list(bins)
    if not listed:
        bins, y, preds, weights = [bins], [y], [preds], [weights]
        if masks is not None:
            masks = tuple(None if m is None else [m] for m in masks)
    elif len(bins) != n_members:
        raise Mp4jError(f"a list of {len(bins)} members needs n_members="
                        f"{len(bins)}, got {n_members}")
    rows = sum(x.shape[0] for x in bins)
    r = _next_round()
    with spans.span("gbdt::round", "gbdt", id=r, round=r, members=n_members,
                    rows=rows):
        with _phase("gradients", {}):
            if masks is None:
                masks = _sampling_masks(generators, cfg, rows,
                                        [x.device for x in bins], lead)
            sample_scale, feat_mask = (
                [None] * len(bins) if m is None else m for m in masks)
            weights = [w if s is None else s if w is None else w * s
                       for w, s in zip(weights or [None] * len(bins),
                                       sample_scale)]

        softmax = cfg.loss == "softmax"
        if softmax:
            with _phase("gradients", {}):
                preds_in, preds = preds, [torch.softmax(p, dim=1)
                                          for p in preds]
        trees, deltas = [], []
        for c in range(cfg.n_classes) if softmax else (None,):
            tags = {"class": c} if softmax else {}
            with _phase("gradients", tags):
                g, h = zip(*(_gradients(p, yb, w, cfg, c)
                             for p, yb, w in zip(preds, y, weights)))
            delta, tree = _build_tree(bins, g, h, cfg, feat_mask,
                                      1 if listed else n_members, group, tags)
            deltas.append(delta)
            trees.append(tree)
        with _phase("margins", {}):
            if softmax:
                new = [p + torch.stack([dl[b] for dl in deltas], dim=1)
                       for b, p in enumerate(preds_in)]
            else:
                new = [p + dl for p, dl in zip(preds, deltas[0])]
        return (new if listed else new[0],
                tuple(trees) if softmax else trees[0])


def predict_tree(bins, tree, cfg: GBDTConfig):
    """Route samples through one tree (level-order heap layout); returns
    each sample's leaf value. A tree whose features lie outside the bins'
    columns raises Mp4jError (on the card, checked once, at the last
    level)."""
    tree_feat, tree_bin, tree_dir, leaf_val = tree
    cat_mask = cfg._cat_mask()
    node = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    level_start = 0
    for d in range(cfg.depth):
        level = slice(level_start, level_start + 2 ** d)
        node = _route_samples(bins, node, tree_feat[level], tree_bin[level],
                              tree_dir[level], cat_mask, cfg.missing_bin,
                              cfg.n_bins, plain=cfg.hist_mode != "pallas",
                              check=d == cfg.depth - 1)
        level_start += 2 ** d
    return leaf_val[node.long()]


# ----------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------
class GBDTTrainer(DataParallelTrainer):
    """Data-parallel GBDT over a mesh of members (flat or hierarchical,
    ``device.make_mesh`` / ``make_hier_mesh``, packed or a list mesh, or
    over processes, ``comm.distributed.global_mesh`` /
    ``hier_global_mesh``). Without a mesh it runs ``n_devices`` members
    (default 1) on ``device`` (default ``cuda:0``; no CUDA and no
    ``device`` raises Mp4jError). Over a list mesh the trees, margins and
    predictions live on member 0's device (``mesh.device``)."""

    def __init__(self, cfg: GBDTConfig, mesh=None, n_devices=None,
                 device=None):
        super().__init__(mesh, n_devices, device)
        self.cfg = cfg
        self.eval_history_: list[float] = []
        self.binner_ = None    # fitted by train_raw; rides save_model

    def shard_data(self, bins, y, sample_weight=None):
        """Stage ``bins`` [N, F] and labels [N] (numpy or tensors) on the
        mesh's device and pad them to ``n * per`` rows: member m's shard
        is rows ``[m * per, (m + 1) * per)``. Returns (bins, y, zero
        margins, weights), all ``[n_local * per, ...]``: this process's
        members' rows (every member's on a one-process mesh; on a mesh
        over processes every rank passes the same global arrays and only
        its own rows are staged). Padding rows get weight 0, so they
        contribute nothing to histograms or leaves; ``sample_weight``
        ([N], numpy) scales the real rows. A tensor already on the device
        is padded there, never copied to the host. On a list mesh each of
        the four is a list: member m's ``[per, ...]`` rows on
        ``devices[m]``."""
        cfg = self.cfg
        dev = self.device
        if not isinstance(bins, torch.Tensor):
            bins = np.asarray(bins)
        self._check_bins_width(bins)
        N = bins.shape[0]
        if cfg.loss == "softmax":
            y = stage_softmax_labels(as_numpy(y), cfg.n_classes)
        elif not isinstance(y, torch.Tensor):
            y = np.asarray(y)
        if tuple(y.shape) != (N,):
            raise Mp4jError(f"y must be [N={N}], got {tuple(y.shape)}")
        dbins = as_tensor(self._local_rows(bins, N), torch.int32, dev)
        y = self._local_rows(y, N)
        if cfg.loss == "softmax":
            dy = torch.from_numpy(y).to(dev)
        else:
            dy = as_tensor(y, torch.float32, dev)
        real = dy.shape[0]
        (dbins, dy), _, dw = self._pad_rows([dbins, dy], N)
        if sample_weight is not None:
            dw[:real] *= self._weights(sample_weight, N)
        shape = ((dw.shape[0], cfg.n_classes) if cfg.loss == "softmax"
                 else (dw.shape[0],))
        dpreds = torch.zeros(shape, dtype=torch.float32, device=dev)
        if self.mesh.is_list:
            return self._to_members((dbins, dy, dpreds, dw),
                                    dw.shape[0] // self.n_shards)
        return dbins, dy, dpreds, dw

    def train(self, bins, y, n_trees: int | None = None, seed: int = 0,
              sample_weight: np.ndarray | None = None,
              eval_set=None, early_stopping_rounds: int | None = None,
              comm=None):
        """Full boosting run over the mesh; returns (trees, final
        margins) -- the margins of the padded rows (see
        :meth:`shard_data`; the first N are the input's), a tensor on the
        trainer's device, ``[n * per]`` for scalar objectives and ``[n *
        per, n_classes]`` for softmax (on a mesh over processes every
        member's margins, gathered onto every rank). ``bins`` and ``y``
        may be numpy arrays or tensors (a tensor already on the device is
        used without a copy). ``seed`` seeds the members'
        ``torch.Generator`` streams of the stochastic-boosting masks when
        cfg.subsample/colsample < 1 (same seed -> same trees, on any mesh
        of n members); ``sample_weight`` ([N], numpy) scales per-instance
        g/h contributions.

        ``eval_set=(bins_va, y_va)`` evaluates the objective's metric on
        the whole (unsharded) held-out data after every round, on every
        rank (margins updated incrementally, one tree per round); with
        ``early_stopping_rounds=k`` training stops after k rounds without
        improvement and the returned ensemble is truncated to the best
        round. The per-round metric history is ``self.eval_history_``
        afterwards.

        ``comm`` (an mp4j comm; every rank calls ``train`` together) sums
        each round's statistics across its ranks on the map plane (the
        round count, and the eval metric when an ``eval_set`` is given):
        the per-round job-wide means land in ``self.sync_round_history_``.
        Under ``MP4J_OVERLAP=1`` the exchanges are drained at the end of
        the boosting loop (the same trees: the stats are observational;
        see ``models._base.StepStatsExchanger``).
        """
        cfg = self.cfg
        dev = self.device
        dbins, dy, dpreds, dw = self.shard_data(bins, y, sample_weight)

        if early_stopping_rounds is not None and eval_set is None:
            raise Mp4jError("early_stopping_rounds requires an eval_set")
        va = None
        if eval_set is not None:
            va = (as_tensor(eval_set[0], torch.int32, dev),
                  as_numpy(eval_set[1]))
            self._check_bins_width(va[0], "eval_set bins")
            va_margins = None
        stopper = EarlyStopper(early_stopping_rounds)
        self.eval_history_ = stopper.history

        mesh = self.mesh
        generators = lead = None
        if cfg.subsample < 1.0 or cfg.colsample < 1.0:
            generators = member_generators(
                seed, mesh.n_local,
                list(mesh.devices) if mesh.is_list else dev, mesh.first)
            if mesh.first and cfg.colsample < 1.0:
                lead = member_generators(seed, 1, dev)[0]
        exchanger = StepStatsExchanger(comm)
        trees = []
        for i in range(n_trees if n_trees is not None else cfg.n_trees):
            dpreds, tree = train_tree_shard(
                dbins, dy, dpreds, cfg, weights=dw, generators=generators,
                n_members=mesh.n_local, group=mesh.group, lead=lead)
            trees.append(tree)
            metric = None
            if va is not None:
                va_margins = self._update_margins(va[0], tree, va_margins)
                metric = self._eval_metric(as_numpy(va_margins), va[1])
            # round k's job-wide stats ride the map plane
            stats = {"trees": np.float64(1.0)}
            if metric is not None:
                stats["metric"] = np.float64(metric)
            exchanger.submit_map(stats)
            if metric is not None:
                # state: the margin snapshot matching the kept ensemble
                if stopper.update(metric, i, state=dpreds):
                    if stopper.best_state is not None:
                        trees = trees[:stopper.best_round + 1]
                        dpreds = stopper.best_state
                    break
        exchanger.drain()
        self.sync_round_history_ = exchanger.mean_map_history()
        return trees, self._gather_rows(dpreds)

    def train_raw(self, X, y, n_trees: int | None = None, seed: int = 0,
                  sample_weight: np.ndarray | None = None,
                  eval_set=None, early_stopping_rounds: int | None = None,
                  binner=None, comm=None,
                  bin_sample: int | None = 1_000_000):
        """The ytk-learn consumer entry point: RAW continuous features
        [N, F] (numpy, or a tensor, which stays on its device) ->
        quantile binning -> :meth:`train`, in one call.

        A :class:`~ytk_mp4j_tpu_torch.models.binning.QuantileBinner` with
        ``n_bins=cfg.n_bins`` and ``missing_bucket=cfg.missing_bin`` is
        fitted on the host from a ``bin_sample``-row sample of X -- by
        ``fit_distributed`` over ``comm`` where one with ``slave_num > 1``
        is given (every rank calls ``train_raw`` together with its own X;
        one allgather merges the ranks' sketches, and ``comm`` then syncs
        the round stats as in :meth:`train`) -- and X is binned on the
        trainer's device. NaN features flow to the
        missing bucket. The binner is kept as ``self.binner_`` and
        persisted by :meth:`save_model`; ``eval_set=(X_va, y_va)`` takes
        raw features, binned with the same edges. A pre-fitted ``binner``
        is used as it is. ``sample_weight`` weights both the quantile
        sketch and the boosting gradients. Returns ``(trees, margins)``
        like :meth:`train`; serve raw features with :meth:`predict_raw`.
        """
        if binner is None:
            binner = QuantileBinner(n_bins=self.cfg.n_bins,
                                    missing_bucket=self.cfg.missing_bin)
        # a finer binner would emit bin ids >= cfg.n_bins, which the
        # histograms silently drop; coarser is legal. The missing-bucket
        # conventions must agree or NaN routing silently changes.
        if binner.n_bins > self.cfg.n_bins:
            raise Mp4jError(
                f"binner.n_bins={binner.n_bins} exceeds "
                f"cfg.n_bins={self.cfg.n_bins}: out-of-range bin ids "
                "would silently vanish from the histograms (a coarser "
                "binner is fine)")
        if bool(binner.missing_bucket) != bool(self.cfg.missing_bin):
            raise Mp4jError(
                f"binner.missing_bucket={binner.missing_bucket} but "
                f"cfg.missing_bin={self.cfg.missing_bin}: the reserved "
                "bin-0 conventions must match or NaN routing silently "
                "changes")
        if binner.edges is None:
            if comm is not None and comm.slave_num > 1:
                binner.fit_distributed(X, comm, sample=bin_sample, seed=seed,
                                       sample_weight=sample_weight)
            else:
                binner.fit(X, sample=bin_sample, seed=seed,
                           sample_weight=sample_weight)
        self.binner_ = binner
        if eval_set is not None:
            eval_set = (binner.transform(eval_set[0], self.device),
                        eval_set[1])
        return self.train(
            binner.transform(X, self.device), y, n_trees=n_trees, seed=seed,
            sample_weight=sample_weight, eval_set=eval_set,
            early_stopping_rounds=early_stopping_rounds, comm=comm)

    def predict_raw(self, X, trees, proba: bool = False):
        """Serve RAW continuous features through the binner fitted by
        :meth:`train_raw` (or set on ``self.binner_`` from what
        :meth:`load_model` returns)."""
        if self.binner_ is None:
            raise Mp4jError(
                "no fitted binner on this trainer: train with "
                "train_raw, or set trainer.binner_ (load_model returns "
                "the persisted binner)")
        return self.predict(self.binner_.transform(X, self.device), trees,
                            proba=proba)

    def _check_bins_width(self, bins, what: str = "bins") -> None:
        """A bin matrix narrower/wider than cfg.n_features would route
        by the wrong columns, so wrong widths must be an error, not
        plausible-looking margins."""
        if bins.ndim != 2 or bins.shape[1] != self.cfg.n_features:
            raise Mp4jError(
                f"{what} must be [N, n_features={self.cfg.n_features}], "
                f"got {tuple(bins.shape)}")

    def _add_tree(self, margins, bins, tree):
        """margins + learning_rate * one round's tree output (the same
        arithmetic as training, so predict reproduces its margins)."""
        cfg = self.cfg
        if cfg.loss == "softmax":
            delta = torch.stack([predict_tree(bins, t, cfg) for t in tree],
                                dim=1)
        else:
            delta = predict_tree(bins, tree, cfg)
        return margins + cfg.learning_rate * delta

    def _update_margins(self, bins, tree, margins):
        """Incrementally add one round's tree output to held-out
        margins."""
        if margins is None:
            shape = ((bins.shape[0], self.cfg.n_classes)
                     if self.cfg.loss == "softmax" else (bins.shape[0],))
            margins = torch.zeros(shape, dtype=torch.float32,
                                  device=bins.device)
        return self._add_tree(margins, bins, tree)

    def _eval_metric(self, margins: np.ndarray, y: np.ndarray) -> float:
        """The objective's validation metric (lower is better):
        squared -> mse, logistic -> logloss, softmax -> logloss."""
        if self.cfg.loss == "squared":
            return float(np.mean((margins - y) ** 2))
        if self.cfg.loss == "logistic":
            return float(np.mean(per_example_loss(
                torch.from_numpy(margins),
                torch.from_numpy(np.asarray(y, margins.dtype)),
                "logistic").numpy()))
        z = margins - margins.max(axis=1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
        return float(-np.mean(logp[np.arange(len(y)), y.astype(int)]))

    def predict(self, bins, trees, proba: bool = False):
        """Ensemble prediction: the sum of learning-rate-scaled tree
        outputs, one tree after another. Returns margins as a tensor on
        the trainer's device ([N], or [N, n_classes] for softmax);
        ``proba=True`` applies the sigmoid (logistic) or softmax."""
        cfg = self.cfg
        bins = as_tensor(bins, torch.int32, self.device)
        self._check_bins_width(bins)
        shape = ((bins.shape[0], cfg.n_classes) if cfg.loss == "softmax"
                 else (bins.shape[0],))
        out = torch.zeros(shape, dtype=torch.float32, device=self.device)
        for tree in trees:
            out = self._add_tree(out, bins, tree)
        if not proba:
            return out
        if cfg.loss == "softmax":
            return torch.softmax(out, dim=1)
        return torch.sigmoid(out)

    def feature_importance(self, trees) -> np.ndarray:
        """Split-count feature importance over the ensemble: how many
        internal nodes split on each feature, normalized to sum to 1.
        Frozen nodes (split bin B-1 routes everything left -- no real
        split) are excluded."""
        counts = np.zeros(self.cfg.n_features, np.int64)
        for round_trees in trees:
            per_class = (round_trees if self.cfg.loss == "softmax"
                         else (round_trees,))
            for tf, tb, _td, _lv in per_class:
                real = as_numpy(tb) != self.cfg.n_bins - 1
                np.add.at(counts, as_numpy(tf)[real], 1)
        total = counts.sum()
        return (counts / total if total else
                np.zeros(self.cfg.n_features)).astype(np.float64)

    def save_model(self, path: str, trees, binner=None) -> None:
        """Persist the ensemble (and the fitted binner's edges -- the one
        from :meth:`train_raw` by default) as an .npz in the reference's
        format: ``GBDTTrainer.load_model`` of either package reads it."""
        if binner is None:
            binner = self.binner_
        arrays = {"n_trees": np.int64(len(trees))}
        for i, round_trees in enumerate(trees):
            per_class = (round_trees if self.cfg.loss == "softmax"
                         else (round_trees,))
            for c, (tf, tb, td, lv) in enumerate(per_class):
                arrays[f"feat_{i}_{c}"] = as_numpy(tf)
                arrays[f"bin_{i}_{c}"] = as_numpy(tb)
                arrays[f"dir_{i}_{c}"] = as_numpy(td)
                arrays[f"leaf_{i}_{c}"] = as_numpy(lv)
        if binner is not None and binner.edges is not None:
            arrays["bin_edges"] = binner.edges
            arrays["bin_missing"] = np.bool_(binner.missing_bucket)
        save_npz(path, self.cfg, arrays)

    @staticmethod
    def load_model(path: str, device=None):
        """Load an ensemble saved by either package; returns (cfg, trees
        on ``device`` (default ``cuda:0``), binner | None)."""
        cfg, z = load_npz(path, GBDTConfig)

        def tree(i, c):
            tf = z[f"feat_{i}_{c}"]
            # models saved before default-direction support have no dir
            # arrays; all-left (0) IS their training-time behavior
            td = z.get(f"dir_{i}_{c}")
            if td is None:
                td = np.zeros_like(tf)
            return (tf, z[f"bin_{i}_{c}"], td, z[f"leaf_{i}_{c}"])

        n_trees = int(z["n_trees"])
        if cfg.loss == "softmax":
            trees = [tuple(tree(i, c) for c in range(cfg.n_classes))
                     for i in range(n_trees)]
        else:
            trees = [tree(i, 0) for i in range(n_trees)]
        binner = None
        if "bin_edges" in z:
            # the binner's granularity may differ from cfg.n_bins (a
            # coarser binner feeding a finer histogram is legal); derive
            # it from the saved edges + missing-bucket flag
            edges = z["bin_edges"]
            mb = bool(z.get("bin_missing", False))
            binner = QuantileBinner(edges.shape[1] + (2 if mb else 1),
                                    missing_bucket=mb)
            binner.edges = edges
        return cfg, trees_from_numpy(trees, cfg, device), binner


def trees_from_numpy(trees, cfg: GBDTConfig, device=None):
    """Trees in the reference's layout -- a list of ``(feat, bin, dir,
    leaf)`` arrays per round, a per-class tuple of them for softmax, as
    ``ytk_mp4j_tpu`` trains and saves them -- as the port's trees on
    ``device`` (default ``cuda:0``), ready for :meth:`GBDTTrainer.predict`
    (:meth:`GBDTTrainer.load_model` reads the reference's saved files).
    """
    dev = make_device(device)
    n_internal = 2 ** cfg.depth - 1

    def one(tree):
        tf, tb, td, lv = (np.asarray(a) for a in tree)
        if (tf.shape != (n_internal,) or tb.shape != (n_internal,)
                or td.shape != (n_internal,)
                or lv.shape != (n_internal + 1,)):
            raise Mp4jError(
                f"a depth-{cfg.depth} tree has {n_internal} internal nodes "
                f"and {n_internal + 1} leaves, got feat {tf.shape}, bin "
                f"{tb.shape}, dir {td.shape}, leaf {lv.shape}")
        ints = (torch.from_numpy(np.array(a, np.int32)).to(dev)
                for a in (tf, tb, td))
        return (*ints, torch.from_numpy(np.array(lv, np.float32)).to(dev))

    if cfg.loss == "softmax":
        return [tuple(one(t) for t in rnd) for rnd in trees]
    return [one(t) for t in trees]


# ----------------------------------------------------------------------
# serve adapter: the reduce-mode sharded entry point
# ----------------------------------------------------------------------
class GBDTServable:
    """Tree-shard serve adapter for a trained ensemble.

    ``kind="reduce"``: unlike the embedding families there is no row to
    pull -- every example visits every tree -- so the serve dispatcher
    shards the ENSEMBLE (round ``t`` lives on rank ``t % size``), each
    rank routes the batch through its own trees, and the per-rank partial
    margins meet in one fixed-shape ``allreduce``. The host router
    mirrors :func:`predict_tree` exactly (ordered splits, categorical
    equality splits, the learned missing-bucket direction, the B-1 freeze
    sentinel), and margins accumulate per example in float64 in fixed
    tree order -- so partial sums are independent of batch composition
    and batched == sequential stays bitwise true through the
    deterministic reduce. ``trees`` are the port's (tensors on any
    device) or the reference's numpy trees.
    """

    kind = "reduce"
    family = "gbdt"

    def __init__(self, trees, cfg: GBDTConfig):
        self.cfg = cfg
        self.n_rounds = len(trees)
        self.req_width = cfg.n_features
        self.resp_width = (cfg.n_classes if cfg.loss == "softmax"
                           else 1)
        dtypes = (np.int32, np.int32, np.int32, np.float32)

        # [T, C, ...] host component arrays (C=1 unless softmax)
        def _host(rnd):
            per_class = rnd if cfg.loss == "softmax" else (rnd,)
            return [tuple(np.asarray(as_numpy(a), dt)
                          for a, dt in zip(cls, dtypes))
                    for cls in per_class]
        self._trees = [_host(rnd) for rnd in trees]
        self._cat_mask = cfg._cat_mask()

    def _route(self, bins: np.ndarray, tree) -> np.ndarray:
        """[N] leaf values -- numpy mirror of :func:`predict_tree`."""
        cfg = self.cfg
        tree_feat, tree_bin, tree_dir, leaf_val = tree
        N = bins.shape[0]
        node = np.zeros(N, np.int64)
        rows = np.arange(N)
        start = 0
        for d in range(cfg.depth):
            n_nodes = 2 ** d
            f = np.asarray(tree_feat[start:start + n_nodes])[node]
            b = np.asarray(tree_bin[start:start + n_nodes])[node]
            v = bins[rows, f]
            go_right = v > b
            if cfg.missing_bin:
                dd = np.asarray(
                    tree_dir[start:start + n_nodes])[node]
                go_right = np.where(v == 0, dd > 0, go_right)
            if self._cat_mask is not None:
                sc = self._cat_mask[f]
                go_right = np.where(
                    sc, (v == b) & (b != cfg.n_bins - 1), go_right)
            node = node * 2 + go_right.astype(np.int64)
            start += n_nodes
        return np.asarray(leaf_val)[node]

    def partial_margins(self, bins: np.ndarray, rank: int,
                        size: int) -> np.ndarray:
        """[N, resp_width] float64 margins over THIS rank's tree shard
        (rounds ``t % size == rank``); summing the partials of all ranks
        reproduces :meth:`GBDTTrainer.predict`'s raw margins up to the
        f32->f64 accumulation swap."""
        bins = np.asarray(bins, np.int64)
        out = np.zeros((bins.shape[0], self.resp_width), np.float64)
        lr = np.float64(self.cfg.learning_rate)
        for t in range(rank, self.n_rounds, size):
            for c, cls in enumerate(self._trees[t]):
                out[:, c] += lr * self._route(bins, cls).astype(
                    np.float64)
        return out

    def link(self, margins: np.ndarray) -> list:
        """Frontend head: margins [N, resp_width] -> one float64
        prediction vector per example (proba via the two-branch sigmoid /
        max-shifted softmax; squared stays the raw margin)."""
        out = []
        for m in margins:
            if self.cfg.loss == "logistic":
                z = float(m[0])
                if z >= 0:
                    p = 1.0 / (1.0 + np.exp(-z))
                else:
                    e = np.exp(z)
                    p = e / (1.0 + e)
                out.append(np.asarray([p], np.float64))
            elif self.cfg.loss == "softmax":
                z = m - m.max()
                e = np.exp(z)
                out.append(e / e.sum())
            else:
                out.append(np.asarray([float(m[0])], np.float64))
        return out


def servable(trees, cfg: GBDTConfig) -> GBDTServable:
    """The serve plane's per-family entry point."""
    return GBDTServable(trees, cfg)
