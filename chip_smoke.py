#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``ytk_mp4j_tpu_torch``) on one card.

Drives the port's main paths through its hand-written CUDA kernels
and holds each kernel against its plain PyTorch version on the card.

Slice 1, GBDT: ``GBDTTrainer.train`` on N = 11,000,000 rows x 28
features x 256 bins, depth 6 (the Higgs row count of BASELINE.json's
GBDT configuration, and bench.py's headline leg), through the histogram
kernel.

Slice 5, data-parallel GBDT: the same trainer over ``make_mesh(4)``
(BASELINE.json's "4 local processes" as 4 members on the card, 2.75M rows
each) on the same data, one histogram launch a level over every member,
the members' histograms and leaf sums folded in rank order; then
``train_raw`` on raw f32 features and the port's entry points.

Slice 2, the dense collective plane, through the ring kernels
(``ring_kernel`` one direction, ``ring_kernel_bidir`` two; each runs on
the cluster path, ``ops/csrc/ring_cluster.cu``, for n <= 8 members and on
the global path, ``ops/csrc/ring_kernel.cu``, above): BASELINE.json
configs[0] -- ``GpuCommCluster(4).allreduce_array`` of 1M f32 SUM with
``algo="rdma"`` through the numpy host API; the GBDT histogram payload
(2 x 16 x 28 x 256 f32, the deepest level of the depth-6 tree) allreduced
over 4 members by the bidirectional kernel; configs[1] -- reduce-scatter
then allgather of 256M f64 over 8 members on device tensors.

Slice 7, the multi-process plane: ``init_distributed`` /
``DistributedComm`` / ``global_mesh`` over ``torch.distributed``, each
rank a process, GBDT over processes with the histograms and leaf sums
folded across the ranks in rank order.

Phases:

1. build the kernels from the sources in this checkout (one ``nvcc``
   per source, all started together) and print the card's name and
   power limit;
2. the histogram kernel against its plain version and an f64 sum at the
   main path's shapes: n_nodes 1 and 16, sentinel ids, every row in one
   bin (timed), zero rows, N = 0, bitwise equality of two launches;
3. the GBDT slice: 1 warm-up tree, then 3 timed trees with every launch
   count set to 0 just before and read just after; trees/s, GB/s
   (bench.py's ``scanned_bytes``); ``predict`` must return the training
   margins; one more tree under ``torch.profiler``: device ms by kernel
   name, the histogram kernel's passes against the rest, and the
   device's idle share over the tree's window; one tree through the
   kernel must equal the same tree through the plain histogram; per
   level, the kernel against its plain version on the inputs the tree
   gave it, and kernel, plain and ``torch.bincount`` times beside the
   bound (bytes of every node id and of the in-range rows' bins, g and
   h). The
   profiled tree reports the members' folds and the leaf sums apart
   (``torch.profiler`` ranges around ``gbdt._fold`` and
   ``gbdt._segment_sum2``, CPU and CUDA activity);
4. the data-parallel slice on the same data: 1 warm-up tree, 3 timed
   trees between the counts (18 histogram launches: one a level), trees/s
   and GB/s, ``predict`` == the margins, trees/s in 10 pairs of 3 trees
   against one member (order alternating), the profiled tree's split beside
   the one-member tree's, kernel tree == plain tree on 200,000 rows, the
   (2, 2) mesh's tree and margins bitwise equal to the flat mesh's (the
   same code path: run-to-run repeatability), and per level the kernel
   against its plain version and the kernel's, plain and bincount ms at
   4 x n_nodes nodes beside the bound;
   ``train_raw`` over 4 members on 11M x 28 raw f32 features (the bins
   plus uniform noise): the fit (host, 1M-row sample) and the transform
   (card) timed apart, the card's transform of the first 1M rows bitwise
   equal to the CPU's, ``predict_raw`` and ``save_model`` ->
   ``load_model`` -> ``predict`` equal to the margins; ``entry.entry()``
   and ``entry.dryrun(4)``;
5. both ring kernels against their plain versions, BITWISE (NaN as NaN):
   both directions x three modes x {SUM, PROD, MAX, MIN} x {f32, f64,
   i64, i32, i16, i8, bf16} x n in {1 (force_kernel), 2, 3, 5, 8} on the
   cluster path and n = 9 on the global path, odd allreduce lengths
   (padding), NaN under MAX/MIN; then 200 launches of each kernel at
   n = 8 (cluster path) on a multi-column chunk, each checked; the
   largest difference from the plain version (0 where bitwise) is what
   the kernels line reports;
6. the collective slice: every launch count set to 0, the three
   configurations above driven once, the counts read (all through the
   cluster path); each result must equal its plain version bitwise
   (configs[0] also under ``algo="ring"``); per call, the kernel's path,
   its ms and ms per ring step, plain ms, the one-card ATen yardstick's
   ms, the global path's ms on the same call, and the bound. Every time
   is the device time of the call's kernels (``torch.profiler``, mean of
   5 calls), so the host's launch gap counts on no side; the older
   measure (CUDA events around each launch) is printed beside the
   kernel's;
7. the FFM, map-plane and linear phases of slice 6 (no kernel of their
   own);
8. the multi-process plane, in worker processes of this script (fresh
   interpreters, a ``file://`` store under ``.chipwork/``, a 300 s
   deadline that kills every worker): (a) NCCL at world size 1 --
   ``checkdist``'s checks on ``cuda:0``, then GBDT over ``global_mesh()``
   at the headline shape, whose 3 timed trees and margins must equal
   phase 3's one-member trees bitwise; (b) 4 processes on ``cuda:0`` with
   ``backend="gloo"`` (NCCL refuses two ranks on one card), 2.75M rows
   each of the same ``make_data`` draw: ``checkdist``'s checks, 1 warm-up
   tree, 3 timed trees (18 histogram launches a process) whose trees and
   margins must equal phase 4's ``make_mesh(4)`` trees bitwise, one more
   tree with the host ms of every cross-process fold, the gather of a
   level alone with every rank idle, and each process's peak device
   memory. First, in this process, the histogram kernel over half the
   rows with its scale seeded from all of them must give that half's
   partial of one call bitwise. The workers hand the trainer the global rows as a
   card tensor, as phases 3 and 4 do, so that no timed tree copies from
   the host; the trainer takes a view of its own members' rows;
9. one JSON line of kernels, then the card's ``nvidia-smi`` line, then
   the ``{"ok": true, ...}`` line last.

Any failed check raises, and the script exits non-zero without the ok
line; so it does where CUDA is absent or the package is not beside it.
A longer record goes to ``chiprun_out/chip_smoke.json``.

Usage: ``python3 chip_smoke.py`` from the repo root (no arguments; the
script starts itself with ``--rank-worker`` for phase 8).
"""

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ytk_mp4j_tpu_torch import (FMConfig, FMTrainer, GBDTConfig,
                                GBDTTrainer, GpuCommCluster, LinearConfig,
                                LinearTrainer, Operands, Operators, entry)
from ytk_mp4j_tpu_torch.device import make_hier_mesh, make_mesh
from ytk_mp4j_tpu_torch.models import fm as fm_mod
from ytk_mp4j_tpu_torch.models import gbdt
from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
from ytk_mp4j_tpu_torch.operands import to_tensor
from ytk_mp4j_tpu_torch.ops import _build
from ytk_mp4j_tpu_torch.ops import hist_kernel as hk
from ytk_mp4j_tpu_torch.ops import ring_kernel as rk
from ytk_mp4j_tpu_torch.ops import sparse as sparse_ops

ROWS = 11_000_000
F, B, DEPTH = 28, 256, 6
TIMED_TREES = 3
TURN_PAIRS = 10                    # one member vs 4 members, in turns
MEMBERS = 4                        # BASELINE.json's "4 local processes"
RAW_TREES = 2
RAW_FIT_SAMPLE = 1_000_000         # train_raw's default bin_sample
RAW_CHECK_ROWS = 1_000_000         # card transform == CPU transform on these
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
F64_OPS_PER_S = 34e12              # f64 outside the tensor cores (data sheet)
RING_DTYPES = (torch.float32, torch.float64, torch.int64, torch.int32,
               torch.int16, torch.int8, torch.bfloat16)
RING_MEMBERS = (1, 2, 3, 5, 8, 9)  # 9: above the cluster limit
RING_REPEATS = 200
TIMING_REPS = 5
PROFILE_ATTEMPTS = 3               # CUPTI now and then hands back nothing
CONFIG0_LEN = 1 << 20              # BASELINE.json configs[0]: 1M f32, 4 ranks
CONFIG1_LEN = 256 << 20            # configs[1]: 256M f64, 8 ranks
HIST_PAYLOAD = 2 * 16 * F * B      # g and h planes of 16 nodes
KERNEL_REL_TOL = 1e-5              # vs an f64 sum, relative to its max
HIST_KERNELS = ("absmax_kernel", "scan_kernel", "scatter_kernel",
                "hist_kernel", "finalize_kernel")   # ops/csrc/hist_kernel.cu
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".chipwork")
PROCESSES = 4                      # phase 8 (b): gloo ranks on one card
PROCESS_DEADLINE_S = 300


def make_data(n, f, b, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, (n, f)).astype(np.int32)
    y = (bins[:, 0] / b + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return bins, y


def scanned_bytes(n, f, depth):
    # per level the trainer scans every sample's F bin bytes + g/h floats
    return depth * n * (f + 8)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def timed_ms(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def f64_hist(bins, v, ids, n_nodes):
    """Exact-enough oracle: the histogram summed in float64."""
    cells, keep = hk.flat_cells(bins, ids, n_nodes, B)
    acc = torch.zeros(n_nodes * F * B, dtype=torch.float64,
                      device=bins.device)
    acc.index_add_(0, cells, v.double()[:, None].expand(-1, F)
                   .reshape(-1)[keep])
    return acc.reshape(n_nodes, F, B)


def bincount_call(bins, g, h, ids, n_nodes):
    """One ``torch.bincount`` computing both planes of the same
    histogram: the library yardstick (the port never calls it). Its ids
    are built, and the out-of-range rows dropped, before it is timed."""
    n_cells = n_nodes * F * B
    cells, keep = hk.flat_cells(bins, ids, n_nodes, B)
    idx = torch.cat([cells, cells + n_cells])
    w = torch.cat([g[:, None].expand(-1, F).reshape(-1)[keep],
                   h[:, None].expand(-1, F).reshape(-1)[keep]])
    return lambda: torch.bincount(idx, weights=w, minlength=2 * n_cells)


def level_bound_ms(n, n_valid, n_nodes):
    """Least time for one histogram call: bytes (every row's node id, the
    bins, g and h of the n_valid rows whose id is in range, each read
    once; each output written once) over HBM rate vs adds over the f32
    rate. Rows with the sentinel id need no bins."""
    moved = 4 * n + n_valid * (4 * F + 8) + 2 * n_nodes * F * B * 4
    ops = 2 * n_valid * F
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def phase_kernel_checks(bins, dev):
    """Kernel vs plain version and f64 sum; returns the max abs error
    against the plain version."""
    n = bins.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    cases = {
        "root n_nodes=1": (torch.zeros(n, dtype=torch.int32, device=dev), 1),
        "n_nodes=16": (torch.randint(0, 16, (n,), generator=gen, device=dev,
                                     dtype=torch.int32), 16),
        "n_nodes=16 sentinels": (torch.randint(-1, 18, (n,), generator=gen,
                                               device=dev,
                                               dtype=torch.int32), 16),
    }
    max_abs = 0.0
    for name, (ids, n_nodes) in cases.items():
        a = hk.histograms(bins, g, h, ids, n_nodes, F, B)
        b = hk.histograms(bins, g, h, ids, n_nodes, F, B)
        plain = hk.histograms_reference(bins, g, h, ids, n_nodes, F, B)
        for k, v in enumerate((g, h)):
            exact = f64_hist(bins, v, ids, n_nodes)
            rel = ((a[k].double() - exact).abs().max()
                   / exact.abs().max()).item()
            err = (a[k] - plain[k]).abs().max().item()
            max_abs = max(max_abs, err)
            print(f"kernel {name} {'gh'[k]}: rel err vs f64 {rel:.3e}, "
                  f"max abs err vs plain {err:.3e}, bitwise repeat "
                  f"{torch.equal(a[k], b[k])}", flush=True)
            check(torch.equal(a[k], b[k]), f"{name}: two launches differ")
            check(rel <= KERNEL_REL_TOL, f"{name}: rel err {rel}")
            check(err <= KERNEL_REL_TOL * plain[k].abs().max().item(),
                  f"{name}: kernel vs plain {err}")
    # the worst contention: every row and feature in bin 0 of node 0
    one = torch.zeros_like(bins)
    ids = cases["root n_nodes=1"][0]
    a = hk.histograms(one, g, h, ids, 1, F, B)
    plain = hk.histograms_reference(one, g, h, ids, 1, F, B)
    for k in range(2):
        err = (a[k] - plain[k]).abs().max().item()
        max_abs = max(max_abs, err)
        check(err <= KERNEL_REL_TOL * plain[k].abs().max().item(),
              f"one bin: kernel vs plain {err}")
    ms = timed_ms(lambda: hk.histograms(one, g, h, ids, 1, F, B), 10)
    print(f"kernel one bin (all {n} rows x {F} features in bin 0): max abs "
          f"err vs plain {err:.3e}, {ms:.3f} ms a call", flush=True)
    del one
    # rows with g = h = 0 leave exact zeros: zero every row of node 3
    ids, _ = cases["n_nodes=16"]
    zero = ids == 3
    gz = torch.where(zero, 0.0, g)
    hz = torch.where(zero, 0.0, h)
    a = hk.histograms(bins, gz, hz, ids, 16, F, B)
    check(not a[0][3].any() and not a[1][3].any(), "zero rows left a sum")
    # N = 0: zeros without a launch
    before = hk.histograms.launches
    e = torch.zeros(0, device=dev)
    ei = torch.zeros(0, dtype=torch.int32, device=dev)
    z = hk.histograms(torch.zeros((0, F), dtype=torch.int32, device=dev),
                      e, e, ei, 16, F, B)
    check(hk.histograms.launches == before, "N = 0 launched a kernel")
    check(z[0].shape == (16, F, B) and not z[0].any() and not z[1].any(),
          "N = 0 is not zeros")
    print("kernel zero rows exact, N=0 zeros without a launch", flush=True)
    return max_abs, ms


def kernel_name(key):
    return key.replace("(anonymous namespace)::", "").split("(")[0]


# trainer functions whose device work a profiled tree reports apart:
# the members' folds in rank order (histograms and leaf sums) and the leaf
# sums themselves
TREE_PARTS = {"fold": "_fold", "leaf sums": "_segment_sum2"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def labelled(label, fn):
    def run(*args, **kwargs):
        with torch.profiler.record_function(f"mp4j::{label}"):
            return fn(*args, **kwargs)
    return run


def part_of_launch(trace):
    """{correlation id: label} for device work launched inside one of
    the ``mp4j::`` ranges of :func:`labelled`."""
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"][len("mp4j::"):])
              for e in trace if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e["name"].startswith("mp4j::")]
    out = {}
    for e in trace:
        corr = e.get("args", {}).get("correlation")
        if (e.get("ph") != "X" or e.get("cat") in DEVICE_CATS
                or corr is None):
            continue
        for lo, hi, label in ranges:
            if lo <= e["ts"] <= hi:
                out[corr] = label
    return out


def profile_run(run, parts, name, exclude=()):
    """``run()`` once under ``torch.profiler`` (CPU + CUDA activity), each
    function of ``parts`` ({label: (module, attribute)}) wrapped in a
    labelled range; the trace goes to chiprun_out/``name``. Returns
    (device ms by kernel name, device ms launched inside each part --
    kernels named in ``exclude`` left out --, busy ms, window ms: first
    device event's start to the last one's end)."""
    real = {label: getattr(mod, attr) for label, (mod, attr) in
            parts.items()}
    for label, (mod, attr) in parts.items():
        setattr(mod, attr, labelled(label, real[label]))
    torch.cuda.synchronize()
    path = os.path.join(OUT_DIR, name)
    try:
        for _ in range(PROFILE_ATTEMPTS):    # again if CUPTI saw nothing
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)["traceEvents"]
            events = [e for e in trace
                      if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
            if events:
                break
    finally:
        for label, (mod, attr) in parts.items():
            setattr(mod, attr, real[label])
    check(events, f"the profiler saw no device event in {name}")
    launched_in = part_of_launch(trace)
    part_ms = dict.fromkeys(parts, 0.0)
    by_name = {}
    for e in events:
        k = kernel_name(e["name"])
        by_name[k] = by_name.get(k, 0.0) + e["dur"] / 1e3
        label = launched_in.get(e.get("args", {}).get("correlation"))
        if label is not None and k not in exclude:
            part_ms[label] += e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy = (busy + hi - lo) / 1e3
    window = (max(b for _, b in spans) - spans[0][0]) / 1e3
    return (dict(sorted(by_name.items(), key=lambda kv: -kv[1])), part_ms,
            busy, window)


def profile_tree(trainer, dbins, dy, name="tree_trace.json"):
    """One more tree like the timed ones, under ``torch.profiler``: device
    ms by kernel name, the histogram kernel's passes, the members' folds
    and the leaf sums against everything else, and the device's idle
    share over the tree's window."""
    by_name, parts, busy, window = profile_run(
        lambda: trainer.train(dbins, dy, n_trees=1),
        {label: (gbdt, attr) for label, attr in TREE_PARTS.items()}, name,
        exclude=HIST_KERNELS)
    hist = sum(v for k, v in by_name.items() if k in HIST_KERNELS)
    total = sum(by_name.values())
    rest = total - hist - sum(parts.values())
    rec = {"members": trainer.n_shards, "window_ms": window,
           "busy_ms": busy, "idle_share": 1 - busy / window,
           "device_ms": total, "hist_kernel_ms": hist,
           "fold_ms": parts["fold"], "leaf_sums_ms": parts["leaf sums"],
           "rest_ms": rest, "other_ms": total - hist, "by_name_ms": by_name}
    top = list(by_name.items())[:10]
    print(f"tree profile ({trainer.n_shards} member(s)), device ms by "
          "kernel: " + ", ".join(f"{k} {v:.3f}" for k, v in top), flush=True)
    print(f"tree profile ({trainer.n_shards} member(s)): {split_line(rec)}",
          flush=True)
    return rec


def split_line(rec):
    total = rec["device_ms"]
    return (f"histogram kernel {rec['hist_kernel_ms']:.3f} ms "
            f"({rec['hist_kernel_ms'] / total:.0%}), member folds "
            f"{rec['fold_ms']:.3f} ms, leaf sums {rec['leaf_sums_ms']:.3f} "
            f"ms, everything else {rec['rest_ms']:.3f} ms, of {total:.3f} ms "
            f"device time; window {rec['window_ms']:.3f} ms, device idle "
            f"share {rec['idle_share']:.1%}")


def record_levels(trainer, dbins, dy):
    """Train one tree while keeping each histogram call's inputs (the
    bins too: over processes they are the rank's rows)."""
    real = gbdt.build_histograms
    calls = []

    def recorder(bins, g, h, node_ids, n_nodes, cfg, absmax=None):
        calls.append((bins, g, h, node_ids, n_nodes, absmax))
        return real(bins, g, h, node_ids, n_nodes, cfg, absmax)

    gbdt.build_histograms = recorder
    try:
        trainer.train(dbins, dy, n_trees=1)
    finally:
        gbdt.build_histograms = real
    torch.cuda.synchronize()
    return calls


def level_errors(call):
    """The kernel against its plain version on one recorded call (with
    its fixed-point seed, where the path gave one): per plane (g, h), the
    largest abs error and the tolerance it is held to, KERNEL_REL_TOL of
    the plain version's largest magnitude."""
    bins, g, h, ids, n_nodes, absmax = call
    got = hk.histograms(bins, g, h, ids, n_nodes, F, B, absmax)
    plain = hk.histograms_reference(bins, g, h, ids, n_nodes, F, B)
    return [((a - p).abs().max().item(),
             KERNEL_REL_TOL * p.abs().max().item())
            for a, p in zip(got, plain)]


def phase_levels(calls):
    """Per level, the kernel against its plain version on the inputs the
    main path gave it, and kernel / plain / bincount ms beside the bound.
    Returns (rows, the largest abs error against the plain version)."""
    rows = []
    max_abs = 0.0
    for d, call in enumerate(calls):
        dbins, g, h, ids, n_nodes, absmax = call
        n = dbins.shape[0]
        errs = level_errors(call)
        for k, (e, tol) in enumerate(errs):
            check(e <= tol, f"level {d} (n_nodes={n_nodes}) {'gh'[k]}: "
                  f"kernel vs plain {e}")
        err = max(e for e, _ in errs)
        max_abs = max(max_abs, err)
        kern = timed_ms(lambda: hk.histograms(dbins, g, h, ids, n_nodes,
                                              F, B, absmax), 10)
        plain = timed_ms(lambda: hk.histograms_reference(
            dbins, g, h, ids, n_nodes, F, B), 2)
        lib = timed_ms(bincount_call(dbins, g, h, ids, n_nodes), 2)
        torch.cuda.empty_cache()
        n_valid = int(((ids >= 0) & (ids < n_nodes)).sum())
        bound = level_bound_ms(n, n_valid, n_nodes)
        rows.append(dict(level=d, n_nodes=n_nodes, rows_in_range=n_valid,
                         max_abs_err=err, ms=kern, plain_ms=plain,
                         library_ms=lib, bound_ms=bound))
        print(f"level {d} (n_nodes={n_nodes}, {n_valid} rows in range): "
              f"max abs err vs plain {err:.3e}; kernel {kern:.3f} ms, plain "
              f"{plain:.3f} ms, bincount {lib:.3f} ms, bound {bound:.3f} ms "
              f"(bytes; {bound / kern:.0%} of it)", flush=True)
    return rows, max_abs


def device_data(dev):
    """bench.py's synthetic Higgs-shaped rows, on the card."""
    t0 = time.perf_counter()
    bins, y = make_data(ROWS, F, B)
    dbins = torch.from_numpy(bins).to(dev)
    dy = torch.from_numpy(y).to(dev)
    print(f"data {ROWS} x {F} x {B} on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dbins, dy


def train_timed(trainer, dbins, dy):
    """TIMED_TREES trees; returns (trees, margins, seconds a tree from CUDA
    events around them, host seconds)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    trees, margins = trainer.train(dbins, dy, n_trees=TIMED_TREES)
    end.record()
    torch.cuda.synchronize()
    return (trees, margins, start.elapsed_time(end) / 1e3 / TIMED_TREES,
            time.perf_counter() - t0)


def timed_trees(trainer, dbins, dy, what):
    """TIMED_TREES trees with every launch count set to 0 just before and
    read just after; trees/s and GB/s from CUDA events around them; the
    margins must be finite, lower the loss and equal ``predict``'s.
    Returns (trees, margins, record)."""
    n = dbins.shape[0]
    zero_counts()
    trees, margins, tree_s, host_s = train_timed(trainer, dbins, dy)
    counts = read_counts()
    launches = counts["hist_kernel"]
    gbs = scanned_bytes(n, F, DEPTH) / tree_s / 1e9
    print(f"{what}: {TIMED_TREES} trees, {1 / tree_s:.3f} trees/s, "
          f"{gbs:.3f} GB/s scanned (host clock {host_s:.3f} s), "
          f"launches {counts}", flush=True)
    check(launches == DEPTH * TIMED_TREES,
          f"{launches} kernel launches, want {DEPTH * TIMED_TREES}")
    check(margins.shape == (n,) and bool(torch.isfinite(margins).all()),
          "margins not finite [N]")
    mse0 = float(dy.double().pow(2).mean())
    mse = float((margins - dy).double().pow(2).mean())
    check(mse < mse0, f"training did not reduce the loss ({mse} vs {mse0})")
    check(torch.equal(trainer.predict(dbins, trees), margins),
          "predict differs from the training margins")
    print(f"predict == training margins; mse {mse0:.5f} -> {mse:.5f}",
          flush=True)
    return trees, margins, {"trees_per_s": 1 / tree_s, "gb_per_s": gbs,
                            "host_s": host_s, "launches": launches}


def in_turns(one, many, dbins, dy):
    """trees/s of the one-member and the many-member trainer in
    TURN_PAIRS pairs of TIMED_TREES trees each, the order alternating
    from pair to pair (one, many, many, one, ...) so that a stall of the
    host or a drift of the card falls on both sides."""
    pairs = []
    for p in range(TURN_PAIRS):
        order = (one, many) if p % 2 == 0 else (many, one)
        rate = {id(t): 1 / train_timed(t, dbins, dy)[2] for t in order}
        pairs.append((rate[id(one)], rate[id(many)]))
    a, b = (np.array([q[k] for q in pairs]) for k in (0, 1))
    rec = {"pairs": pairs, "one_member_median": float(np.median(a)),
           "members_median": float(np.median(b)),
           "one_member_quartiles": np.percentile(a, [25, 75]).tolist(),
           "members_quartiles": np.percentile(b, [25, 75]).tolist()}
    rec["ratio"] = rec["members_median"] / rec["one_member_median"]
    print(f"in turns, {TURN_PAIRS} pairs of {TIMED_TREES} trees: 1 member "
          f"median {rec['one_member_median']:.3f} trees/s (quartiles "
          f"{rec['one_member_quartiles'][0]:.3f}-"
          f"{rec['one_member_quartiles'][1]:.3f}), {many.n_shards} members "
          f"median {rec['members_median']:.3f} trees/s (quartiles "
          f"{rec['members_quartiles'][0]:.3f}-"
          f"{rec['members_quartiles'][1]:.3f}), ratio {rec['ratio']:.3f}",
          flush=True)
    return rec


def kernel_tree_equals_plain(dbins, dy, mesh=None):
    """One tree through the kernel against the same tree through the
    plain histogram on the same card (the reference the CPU tests tie to
    JAX), on the first 200,000 rows."""
    small = min(dbins.shape[0], 200_000)
    kw = dict(n_features=F, n_bins=B, depth=DEPTH, n_trees=1)
    tk, mk = GBDTTrainer(GBDTConfig(**kw), mesh=mesh).train(dbins[:small],
                                                            dy[:small])
    tp, mp = GBDTTrainer(GBDTConfig(hist_mode="flat", **kw),
                         mesh=mesh).train(dbins[:small], dy[:small])
    for k in range(3):
        check(torch.equal(tk[0][k], tp[0][k]), "kernel tree != plain tree")
    torch.testing.assert_close(tk[0][3], tp[0][3], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mk, mp, rtol=1e-5, atol=1e-6)
    members = 1 if mesh is None else mesh.n
    print(f"kernel tree == plain tree on {small} rows, {members} member(s)",
          flush=True)


def run_gbdt(dev, dbins, dy):
    """Slice 1: kernel checks, the timed trees, per-level times. Returns
    the hist_kernel line and the record."""
    max_abs, one_bin_ms = phase_kernel_checks(dbins, dev)

    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    trainer = GBDTTrainer(cfg)
    calls = record_levels(trainer, dbins, dy)        # warm-up tree
    check(len(calls) == DEPTH, f"{len(calls)} histogram calls in a tree")
    trees, margins, rec = timed_trees(trainer, dbins, dy, "slice")
    save_reference("one_member", trees, margins)
    profile = profile_tree(trainer, dbins, dy)
    kernel_tree_equals_plain(dbins, dy)

    rows, level_err = phase_levels(calls)
    mean = {k: sum(r[k] for r in rows) / len(rows)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    line = {
        "name": "hist_kernel", "route": "cuda",
        "source": "ytk_mp4j_tpu_torch/ops/csrc/hist_kernel.cu",
        "replaces": "ytk_mp4j_tpu/ops/hist_kernel.py:106",
        "launches": rec["launches"], "max_abs_err": max(max_abs, level_err),
        "ms": mean["ms"], "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"], "bound_by": "bytes",
        "library_ms": mean["library_ms"],
    }
    return line, dict(rec, rows=dbins.shape[0], levels=rows,
                       tree_profile=profile, one_bin_ms=one_bin_ms)


# ----------------------------------------------------------------------
# slice 5: data-parallel GBDT over members on the card
# ----------------------------------------------------------------------
def run_data_parallel(dbins, dy, one_member):
    """GBDT over MEMBERS members on the slice-1 data: the timed trees
    between the counts, trees/s in turns with one member, the profiled
    split beside the one-member tree's,
    kernel tree == plain tree, the (2, 2) mesh == the flat one, and each
    level's kernel against its plain version, with kernel, plain and
    bincount ms at MEMBERS * n_nodes nodes beside its bound."""
    mesh = make_mesh(MEMBERS)
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    trainer = GBDTTrainer(cfg, mesh=mesh)
    calls = record_levels(trainer, dbins, dy)        # warm-up tree
    want_nodes = [MEMBERS * max(1, 2 ** (d - 1)) for d in range(DEPTH)]
    check([c[4] for c in calls] == want_nodes,
          f"histogram calls at {[c[4] for c in calls]} nodes, want "
          f"{want_nodes}: one call a level over every member")
    trees, margins, rec = timed_trees(
        trainer, dbins, dy, f"data-parallel slice ({MEMBERS} members)")
    save_reference("mesh4", trees, margins)
    rec["turns"] = in_turns(GBDTTrainer(cfg), trainer, dbins, dy)
    profile = profile_tree(trainer, dbins, dy, "tree_trace_members.json")
    check(profile["fold_ms"] > 0 and profile["leaf_sums_ms"] > 0,
          "the profile attributed no device time to the folds or leaf sums")
    print(f"tree split, 1 member: {split_line(one_member['tree_profile'])}",
          flush=True)
    print(f"tree split, {MEMBERS} members: {split_line(profile)}",
          flush=True)
    kernel_tree_equals_plain(dbins, dy, mesh)

    # the trainer reads only a mesh's member count, so the (2, 2) mesh
    # runs the flat mesh's code in the same rank order: this shows that a
    # tree repeats run to run (the kernel's sums repeat bitwise; the leaf
    # sums' atomic adds land in another order, in float64, each run)
    th, mh = GBDTTrainer(cfg, mesh=make_hier_mesh(2, MEMBERS // 2)).train(
        dbins, dy, n_trees=1)
    tf, mf = GBDTTrainer(cfg, mesh=mesh).train(dbins, dy, n_trees=1)
    for k in range(3):
        check(torch.equal(th[0][k], tf[0][k]), "hierarchical tree != flat")
    check(torch.equal(mh, mf), "hierarchical margins != flat margins")
    print(f"(2, {MEMBERS // 2}) mesh == flat {MEMBERS}-member mesh, margins "
          "bitwise (run-to-run repeatability: the same code path)",
          flush=True)

    rows, level_err = phase_levels(calls)
    return dict(rec, members=MEMBERS, levels=rows, max_abs_err=level_err,
                tree_profile=profile)


def run_train_raw(dev, dbins, dy):
    """``train_raw`` over MEMBERS members on raw f32 features (the bins
    plus uniform noise in [0, 1), so binning recovers the bins up to the
    sampled edges): the fit (host) and the transform (card) timed apart,
    the card's transform of the first RAW_CHECK_ROWS rows bitwise equal to
    the CPU's, ``predict_raw`` and a ``save_model`` / ``load_model`` round
    trip equal to the training margins."""
    gen = torch.Generator(device=dev).manual_seed(0)
    X = dbins.float() + torch.rand(dbins.shape, generator=gen, device=dev)
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    trainer = GBDTTrainer(cfg, mesh=make_mesh(MEMBERS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trees, margins = trainer.train_raw(X, dy, n_trees=RAW_TREES,
                                       bin_sample=RAW_FIT_SAMPLE)
    torch.cuda.synchronize()
    train_raw_s = time.perf_counter() - t0
    binner = trainer.binner_

    t0 = time.perf_counter()
    refit = QuantileBinner(B).fit(X, sample=RAW_FIT_SAMPLE)
    fit_s = time.perf_counter() - t0
    check(np.array_equal(refit.edges, binner.edges), "fit is not repeatable")
    transform_ms = timed_ms(lambda: binner.transform(X), 2)
    bins = binner.transform(X)
    t0 = time.perf_counter()
    cpu = binner.transform(X[:RAW_CHECK_ROWS].cpu(), device="cpu")
    cpu_s = time.perf_counter() - t0
    check(torch.equal(bins[:RAW_CHECK_ROWS].cpu(), cpu),
          "the card's transform != the CPU's")
    recovered = float((bins == dbins).double().mean())
    del bins, cpu
    print(f"train_raw over {MEMBERS} members, {ROWS} x {F} raw f32, "
          f"{RAW_TREES} trees: {train_raw_s:.3f} s (host clock); fit on a "
          f"{RAW_FIT_SAMPLE}-row sample {fit_s:.3f} s (host), transform "
          f"{transform_ms:.3f} ms (card), CPU transform of {RAW_CHECK_ROWS} "
          f"rows {cpu_s:.3f} s and bitwise equal; {recovered:.2%} of the "
          "bins recovered", flush=True)

    check(margins.shape == (ROWS,) and bool(torch.isfinite(margins).all()),
          "train_raw margins not finite [N]")
    mse0 = float(dy.double().pow(2).mean())
    mse = float((margins - dy).double().pow(2).mean())
    check(mse < mse0, f"train_raw did not reduce the loss ({mse} vs {mse0})")
    check(torch.equal(trainer.predict_raw(X, trees), margins),
          "predict_raw differs from the training margins")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        trainer.save_model(path, trees)
        cfg2, trees2, binner2 = GBDTTrainer.load_model(path)
    check(cfg2 == cfg and np.array_equal(binner2.edges, binner.edges),
          "load_model changed the config or the edges")
    served = GBDTTrainer(cfg2).predict(binner2.transform(X), trees2)
    check(torch.equal(served, margins),
          "save_model -> load_model -> predict differs from the margins")
    print(f"predict_raw == training margins == load_model's predict; mse "
          f"{mse0:.5f} -> {mse:.5f}", flush=True)
    return {"train_raw_s": train_raw_s, "fit_s": fit_s,
            "transform_ms": transform_ms, "cpu_transform_s": cpu_s,
            "recovered": recovered}


def run_entry():
    """The port's entry points on the card."""
    t0 = time.perf_counter()
    fn, args = entry.entry()
    out = fn(*args)
    check(out.shape == (2048,) and bool(torch.isfinite(out).all()),
          "entry() margins")
    entry.dryrun(MEMBERS)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    print(f"entry.entry() and entry.dryrun({MEMBERS}) ran on the card in "
          f"{took:.3f} s", flush=True)
    return {"s": took}


# ----------------------------------------------------------------------
# slice 2: the ring kernels
# ----------------------------------------------------------------------
COUNTERS = {"hist_kernel": hk.histograms, "ring_kernel": rk.ring_kernel,
            "ring_kernel_bidir": rk.ring_kernel_bidir}


RING_COUNTERS = ("ring_kernel", "ring_kernel_bidir")


def zero_counts():
    for fn in COUNTERS.values():
        fn.launches = 0
    for name in RING_COUNTERS:
        COUNTERS[name].cluster_launches = COUNTERS[name].global_launches = 0


def read_counts():
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    for name in RING_COUNTERS:
        for path in rk.PATHS:
            counts[f"{name}.{path}"] = getattr(COUNTERS[name],
                                               f"{path}_launches")
    return counts


def same(a, b):
    """Bitwise equal, NaN equal to NaN at the same places (the NaN-aware
    pass, which allocates, runs only when plain equality fails)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if torch.equal(a, b):
        return True
    if a.is_floating_point():
        na, nb = a.isnan(), b.isnan()
        if not torch.equal(na, nb):
            return False
        a, b = torch.where(na, 0, a), torch.where(nb, 0, b)
    return torch.equal(a, b)


def max_abs_diff(a, b):
    """Largest |a - b| in float64, 0 where both are NaN and inf where only
    one is; row by row, so a 256M-element row is the most it allocates."""
    err = 0.0
    for ra, rb in zip(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)):
        d = ra.double() - rb.double()
        d.abs_()
        if ra.is_floating_point():
            d.masked_fill_(ra.isnan() & rb.isnan(), 0)
        err = max(err, d.nan_to_num_(nan=float("inf")).max().item())
    return err


RING_ERR = {"ring_kernel": 0.0, "ring_kernel_bidir": 0.0}


def held(name, a, b, what):
    """Kernel ``name``'s result ``a`` against the plain version's ``b``:
    must be bitwise equal; the difference goes into ``RING_ERR``."""
    check(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype")
    RING_ERR[name] = max(RING_ERR[name], max_abs_diff(a, b))
    check(same(a, b), f"{what}: kernel != plain")


def ring_data(shape, dt, gen, dev):
    if dt.is_floating_point:
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    return torch.randint(-100, 100, shape, generator=gen,
                         device=dev).to(dt)


def device_ms(fn, reps=TIMING_REPS, match=None):
    """Mean device ms of the kernels ``fn`` launches (those whose name
    holds ``match``, default all; copies and fills excluded), from
    ``torch.profiler`` over ``reps`` calls after one warm-up: the host's
    launch latency between calls counts on no side. A profile with no
    device time is taken again, PROFILE_ATTEMPTS times at most."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us and "Memcpy" not in e.key and "Memset" not in e.key \
                    and (match is None or match in e.key):
                total += us
        if total > 0:
            break
    check(total > 0, "the profiler saw no device time")
    return total / reps / 1e3


class LaunchTimer:
    """The older measure: CUDA events recorded just around each C launch
    call of either ring library (the wrapper's allocations and its
    error-word read stay outside, the host's launch latency inside).
    Installed on the loaded libraries only here."""

    def __init__(self):
        self.events = []
        for lib, name in ((rk._library(), "mp4j_ring_launch"),
                          (rk._cluster_library(),
                           "mp4j_ring_cluster_launch")):
            setattr(lib, name, self._timed(getattr(lib, name)))

    def _timed(self, real):
        def timed(*args):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            rc = real(*args)
            e.record()
            self.events.append((s, e))
            return rc
        return timed

    def kernel_ms(self, fn, reps=TIMING_REPS):
        fn()                                       # warm-up
        self.events.clear()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        check(len(self.events) == reps, "a timed call did not launch once")
        return sum(s.elapsed_time(e) for s, e in self.events) / reps


def ring_bound_ms(mode, n, length, dt):
    """Least time: every input read once and every output written once
    at the HBM rate, against the folds at the card's rate for the type."""
    s = torch.empty((), dtype=dt).element_size()
    moved = {"allreduce": 2 * n * length,
             "reduce_scatter": n * length + length,
             "allgather": n * length + n * n * length}[mode] * s
    ops = 0 if mode == "allgather" else (n - 1) * length
    rate = F64_OPS_PER_S if dt == torch.float64 else F32_OPS_PER_S
    return max(moved / HBM_BYTES_PER_S, ops / rate) * 1e3


def phase_ring_checks(dev):
    """Both kernels against their plain versions, bitwise, over the grid;
    then RING_REPEATS checked launches of each at n = 8, multi-column."""
    gen = torch.Generator(device=dev).manual_seed(2)
    ops = (Operators.SUM, Operators.PROD, Operators.MAX, Operators.MIN)
    cases = 0
    for dt in RING_DTYPES:
        c = 2 * rk.granule(dt, dev) * 3     # RS/AG chunk: both halves odd
        for n in RING_MEMBERS:
            for bidir in (False, True):
                name = "ring_kernel_bidir" if bidir else "ring_kernel"
                for op in ops:
                    x = ring_data((n, 1001 + 2 * n), dt, gen, dev)
                    if dt.is_floating_point and op.name in ("MAX", "MIN"):
                        x[0, 3] = x[n - 1, 700] = float("nan")
                    a = rk.ring_allreduce_kernel(x, op, bidir,
                                                 force_kernel=True)
                    b = rk.ring_allreduce_reference(x, op, bidir,
                                                    force_kernel=True)
                    held(name, a, b, f"allreduce {dt} n={n} {op.name}")
                    x = ring_data((n, n * c), dt, gen, dev)
                    a = rk.ring_reduce_scatter_kernel(x, op, bidir,
                                                      force_kernel=True)
                    b = rk.ring_reduce_scatter_reference(x, op, bidir,
                                                         force_kernel=True)
                    held(name, a, b, f"reduce_scatter {dt} n={n} {op.name}")
                    cases += 2
                x = ring_data((n, c), dt, gen, dev)
                a = rk.ring_allgather_kernel(x, bidir, force_kernel=True)
                b = rk.ring_allgather_reference(x, bidir, force_kernel=True)
                held(name, a, b, f"allgather {dt} n={n}")
                cases += 1
    torch.cuda.synchronize()
    print(f"ring kernels == plain, bitwise, in {cases} cases "
          f"(launches {read_counts()})", flush=True)
    x = ring_data((8, 4_000_003), torch.float32, gen, dev)
    for bidir in (False, True):
        name = "ring_kernel_bidir" if bidir else "ring_kernel"
        ref = rk.ring_allreduce_reference(x, bidirectional=bidir)
        t0 = time.perf_counter()
        for i in range(RING_REPEATS):
            got = rk.ring_allreduce_kernel(x, bidirectional=bidir)
            held(name, got, ref, f"repeat {i} {name}")
        print(f"ring {RING_REPEATS} repeats bidir={bidir} at n=8, L=4000003: "
              f"all bitwise, {time.perf_counter() - t0:.2f} s", flush=True)
    return cases + 2 * RING_REPEATS


def chain_steps(counter, mode, n):
    """Dependent ring steps of the latest launch: segments of its
    longest column times the exchanges of one segment."""
    lp = counter.last_plan
    longest = max(len(lp.segments(c)) for c in range(lp.cols))
    return lp, longest * rk.RingPlan(n, mode).steps


def ring_row(name, mode, n, length, dt, kernel, plain, library, timer,
             counter, on_global):
    """One timed call: kernel (its path, ms per ring step, the older
    event measure), plain, library and global-path ms, and the bound."""
    ms = device_ms(kernel, match="ring_")
    lp, steps = chain_steps(counter, mode, n)
    row = dict(call=name, mode=mode, n=n, length=length, dtype=str(dt),
               path=lp.path, cols=lp.cols, slot_bytes=lp.slot_bytes,
               steps=steps, ms=ms, ms_per_step=ms / steps,
               event_ms=timer.kernel_ms(kernel),
               global_ms=device_ms(on_global, match="ring_"),
               plain_ms=device_ms(plain),
               library_ms=device_ms(library),
               bound_ms=ring_bound_ms(mode, n, length, dt))
    torch.cuda.empty_cache()
    print(f"{name}: {row['path']} path, kernel {row['ms']:.4f} ms "
          f"({row['steps']} ring steps, {row['ms_per_step'] * 1e3:.3f} us "
          f"a step; CUDA events around the launch: {row['event_ms']:.4f} "
          f"ms), global path {row['global_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms (bytes)", flush=True)
    return row


def replicated_sum(x):
    """The one-card ATen yardstick of an allreduce: one sum over the
    stacked members, copied into n outputs."""
    return lambda: x.sum(0).expand(x.shape[0], -1).contiguous()


def run_ring(dev):
    """Slice 2: kernel checks, the collective slice driven once with the
    counts around it, then per-call checks and times."""
    torch.cuda.reset_peak_memory_stats(dev)
    phase_ring_checks(dev)
    timer = LaunchTimer()
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    host = [rng.standard_normal(CONFIG0_LEN).astype(np.float32)
            for _ in range(4)]
    hist = torch.randn((4, HIST_PAYLOAD), generator=gen, device=dev)
    t0 = time.perf_counter()
    big = torch.randn((8, CONFIG1_LEN), generator=gen, device=dev,
                      dtype=torch.float64)
    torch.cuda.synchronize()
    print(f"configs[1] input 8 x {CONFIG1_LEN} f64 "
          f"({big.numel() * 8 / 2**30:.0f} GiB) on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the main path, driven once between the counts ----------------
    zero_counts()
    t0 = time.perf_counter()
    arrs = [a.copy() for a in host]
    cluster = GpuCommCluster(4)
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM, algo="rdma")
    hist_out = rk.ring_allreduce_kernel(hist, bidirectional=True)
    scattered = rk.ring_reduce_scatter_kernel(big)
    gathered = rk.ring_allgather_kernel(scattered)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"collective slice driven in {host_s:.3f} s (host clock), "
          f"launches {counts}", flush=True)
    check(counts["ring_kernel"] == 3 and counts["ring_kernel_bidir"] == 1
          and counts["hist_kernel"] == 0, f"launch counts {counts}")
    check(counts["ring_kernel.cluster"] == 3
          and counts["ring_kernel_bidir.cluster"] == 1,
          f"the main path left the cluster kernel: {counts}")

    # ---- configs[0]: the host API against the plain version and "ring"
    stacked = to_tensor(np.stack(host), dev)
    plain = rk.ring_allreduce_reference(stacked).cpu().numpy()
    ring = [a.copy() for a in host]
    cluster.allreduce_array(ring, Operands.FLOAT, Operators.SUM,
                            algo="ring")
    held("ring_kernel", torch.from_numpy(np.stack(arrs)),
         torch.from_numpy(plain), "configs[0] rdma")
    for r in range(4):
        check(np.array_equal(arrs[r], ring[r]), "configs[0]: rdma != ring")
    exact = np.sum(np.stack(host).astype(np.float64), 0)
    print(f"configs[0] rdma == plain == ring, bitwise; max |err| vs f64 "
          f"sum {np.abs(arrs[0] - exact).max():.3e}", flush=True)
    rows = {"ring_kernel": [], "ring_kernel_bidir": []}
    rows["ring_kernel"].append(ring_row(
        "configs[0] allreduce 4 x 1M f32", "allreduce", 4, CONFIG0_LEN,
        torch.float32, lambda: rk.ring_allreduce_kernel(stacked),
        lambda: rk.ring_allreduce_reference(stacked),
        replicated_sum(stacked), timer, rk.ring_kernel,
        lambda: rk.ring_allreduce_kernel(stacked, path="global")))

    # ---- the histogram payload, bidirectional -------------------------
    held("ring_kernel_bidir", hist_out,
         rk.ring_allreduce_reference(hist, bidirectional=True),
         "histogram payload")
    rows["ring_kernel_bidir"].append(ring_row(
        "histogram payload allreduce 4 x 2x16x28x256 f32 bidir", "allreduce",
        4, HIST_PAYLOAD, torch.float32,
        lambda: rk.ring_allreduce_kernel(hist, bidirectional=True),
        lambda: rk.ring_allreduce_reference(hist, bidirectional=True),
        replicated_sum(hist), timer, rk.ring_kernel_bidir,
        lambda: rk.ring_allreduce_kernel(hist, bidirectional=True,
                                         path="global")))

    # ---- configs[1]: one mode at a time, to stay well inside 80 GB ----
    held("ring_kernel", scattered, rk.ring_reduce_scatter_reference(big),
         "configs[1] reduce-scatter")
    torch.cuda.empty_cache()
    rows["ring_kernel"].append(ring_row(
        "configs[1] reduce-scatter 8 x 256M f64", "reduce_scatter", 8,
        CONFIG1_LEN, torch.float64,
        lambda: rk.ring_reduce_scatter_kernel(big),
        lambda: rk.ring_reduce_scatter_reference(big),
        lambda: big.sum(0).view(8, -1), timer, rk.ring_kernel,
        lambda: rk.ring_reduce_scatter_kernel(big, path="global")))
    del big
    torch.cuda.empty_cache()
    held("ring_kernel", gathered, rk.ring_allgather_reference(scattered),
         "configs[1] allgather")
    del gathered
    torch.cuda.empty_cache()
    c = scattered.shape[1]
    rows["ring_kernel"].append(ring_row(
        "configs[1] allgather 8 x 32M f64", "allgather", 8, c,
        torch.float64, lambda: rk.ring_allgather_kernel(scattered),
        lambda: rk.ring_allgather_reference(scattered),
        lambda: scattered.reshape(-1).expand(8, -1).contiguous(), timer,
        rk.ring_kernel,
        lambda: rk.ring_allgather_kernel(scattered, path="global")))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"peak device memory of the ring phases {peak:.1f} GiB", flush=True)

    sources = {"ring_kernel": ":244", "ring_kernel_bidir": ":382"}
    files = {"cluster": "ytk_mp4j_tpu_torch/ops/csrc/ring_cluster.cu",
             "global": "ytk_mp4j_tpu_torch/ops/csrc/ring_kernel.cu"}
    entries = []
    for name, rs in rows.items():
        total = {k: sum(r[k] for r in rs)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        paths = sorted({r["path"] for r in rs})
        check(len(paths) == 1, f"{name}: timed calls on paths {paths}")
        entries.append({
            "name": name, "route": "cuda", "source": files[paths[0]],
            "replaces": "ytk_mp4j_tpu/ops/ring_kernel.py" + sources[name],
            "path": paths[0],
            "launches": counts[name], "max_abs_err": RING_ERR[name],
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": "bytes",
            "library_ms": total["library_ms"]})
    return entries, {"calls": rows, "host_s": host_s, "peak_gib": peak}


# ----------------------------------------------------------------------
# slice 6: FM/FFM, the map plane and linear (no kernel of their own)
# ----------------------------------------------------------------------
# Juan et al., "Field-aware Factorization Machines for CTR Prediction"
# (RecSys 2016), Criteo: 39 fields (13 integer + 26 categorical columns),
# features hashed to 10^6, k = 4
CRITEO = dict(n_features=1_000_000, n_fields=39, k=4, max_nnz=39,
              model="ffm", learning_rate=0.1)
CRITEO_ROWS = 16_384               # 4,096 a member
CONFIG4 = dict(n_features=100_000, n_fields=8, k=8, max_nnz=8,
               model="ffm", learning_rate=0.05)     # bench.py:1624-1639
CONFIG4_ROWS = 8192
FM_FIT_STEPS = 3                   # the equalities' runs
FM_TIMED_STEPS = 5
CONFIG4_TIMED_STEPS = 10           # bench.py's steps
FM_PATHS = {"dense": {},
            "sparse": {"sparse_grads": True},
            "sharded": {"sparse_grads": True, "table_sharding": "sharded"}}
MAP_KEYS = 20_000                  # configs[2]: a member, 50 % overlap
MAP_INT_KEYS = 50_000              # bench.py:1742
MAP_REPS = 5
MAP_CHAIN = 8
LINEAR_STEPS = 10


def steps_ms(step, params, batch, steps):
    """Mean device ms of one step over ``steps`` steps after one warm-up
    step (CUDA events around the loop); the steps' final params."""
    params, _ = step(params, batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        params, _ = step(params, batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


# the FM step's parts a profiled step reports apart
FM_PARTS = {"grads": (fm_mod, "_loss_and_grads"),
            "fetch": (fm_mod, "_fetch_rows_sharded"),
            "sort": (sparse_ops, "sort_by_key"),
            "segment": (sparse_ops, "segment_reduce_sorted"),
            "masked add": (fm_mod, "_add_rows")}


def fm_path(name, cfg, mesh, data, p0, steps, profile=None):
    """One FM gradient path: ``fit`` (FM_FIT_STEPS, public API) for the
    equalities, then the step alone timed over ``steps`` steps; with
    ``profile`` (a trace file name), one more step under
    ``torch.profiler``: device ms by kernel, by part (FM_PARTS) and the
    device's idle share over the step's window."""
    tr = FMTrainer(cfg, mesh=mesh, **FM_PATHS[name])
    params, losses = tr.fit(*data, n_steps=FM_FIT_STEPS, params=p0)
    check(np.isfinite(losses).all(), f"{name} FFM losses not finite")
    batch = tr.shard_data(*data)
    step = tr._step(int(batch[0].shape[1]) * cfg.max_nnz)
    q = tr._place_params(p0)
    ms = steps_ms(step, q, batch, steps)
    prof = None
    if profile is not None:
        by_name, parts, busy, window = profile_run(lambda: step(q, batch),
                                                   FM_PARTS, profile)
        total = sum(by_name.values())
        prof = {"device_ms": total, "window_ms": window,
                "idle_share": 1 - busy / window, "parts_ms": parts,
                "rest_ms": total - sum(parts.values()),
                "by_name_ms": by_name}
        print(f"FFM {name} step profile: device {total:.3f} ms of a "
              f"{window:.3f} ms window (idle {1 - busy / window:.1%}); "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items() if v)
              + f", rest {prof['rest_ms']:.3f} ms; by kernel: "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          list(by_name.items())[:8]), flush=True)
    return tr, params, losses, ms, prof


def ffm_small_card_equals_cpu():
    """The three FFM paths at a small size on the card against the
    port's CPU path (the CPU path is held against the reference in
    tests/test_torch_fm.py): losses to rtol 1e-5."""
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 64, (96, 4)).astype(np.int32)
    fields = np.tile(np.arange(4, dtype=np.int32), (96, 1))
    vals = np.ones((96, 4), np.float32)
    y = ((feats[:, 0] + feats[:, 1]) % 2).astype(np.float32)
    cfg = FMConfig(n_features=64, n_fields=4, k=4, max_nnz=4, model="ffm",
                   learning_rate=0.3, l2=1e-3, init_scale=0.1)
    for name, kw in FM_PATHS.items():
        _, lc = FMTrainer(cfg, mesh=make_mesh(4), **kw).fit(
            feats, fields, vals, y, n_steps=5, seed=2)
        _, lp = FMTrainer(cfg, mesh=make_mesh(4, "cpu"), **kw).fit(
            feats, fields, vals, y, n_steps=5, seed=2)
        check(np.allclose(lc, lp, rtol=1e-5, atol=1e-6),
              f"small FFM {name}: card {lc} != CPU {lp}")


def run_ffm_criteo(dev):
    """FFM at Criteo width over 4 members: dense, sparse replicated and
    sparse sharded, the reference's equalities at this size (sparse ==
    dense and sharded == replicated at rtol 1e-4; the stream of one
    full-batch chunk a step == fit at rtol 1e-5, replicated and
    sharded), steps/s and rows/s of each path."""
    ffm_small_card_equals_cpu()
    cfg = FMConfig(**CRITEO)
    mesh = make_mesh(MEMBERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    K = cfg.max_nnz
    data = (torch.randint(0, cfg.n_features, (CRITEO_ROWS, K), device=dev,
                          generator=gen, dtype=torch.int32),
            torch.arange(K, dtype=torch.int32, device=dev).expand(
                CRITEO_ROWS, K).contiguous(),
            torch.ones((CRITEO_ROWS, K), device=dev),
            torch.randint(0, 2, (CRITEO_ROWS,), device=dev,
                          generator=gen).float())
    t0 = time.perf_counter()
    p0 = FMTrainer(cfg, mesh=mesh).init_params(seed=0)
    init_s = time.perf_counter() - t0
    rows = FMTrainer(cfg, mesh=mesh).n_rows
    slots = CRITEO_ROWS // MEMBERS * K * K
    print(f"FFM at Criteo width: {cfg.n_features} features x "
          f"{cfg.n_fields} fields, k {cfg.k}, table {rows} x {cfg.k} f32 "
          f"({rows * cfg.k * 4 / 1e6:.0f} MB, drawn in {init_s:.1f} s), "
          f"{CRITEO_ROWS} rows over {MEMBERS} members ({slots} slot rows a "
          "member)", flush=True)
    rec = {}
    runs = {}
    for name in FM_PATHS:
        torch.cuda.reset_peak_memory_stats()
        tr, params, losses, ms, prof = fm_path(
            name, cfg, mesh, data, p0, FM_TIMED_STEPS,
            profile=f"ffm_{name}_step_trace.json")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[name] = (tr, params, losses)
        rec[name] = {"ms_per_step": ms, "steps_s": 1e3 / ms,
                     "rows_s": CRITEO_ROWS * 1e3 / ms, "losses":
                     losses.tolist(), "peak_gib": peak, "profile": prof}
        print(f"FFM {name}: {ms:.3f} ms a step, {1e3 / ms:.3f} steps/s, "
              f"{CRITEO_ROWS * 1e3 / ms:.0f} rows/s (CUDA events, "
              f"{FM_TIMED_STEPS} steps after a warm-up); losses "
              f"{losses.tolist()}; peak {peak:.2f} GiB", flush=True)
        del tr, params
    lref = runs["dense"][2]
    check(np.allclose(runs["sparse"][2], lref, rtol=1e-4, atol=1e-6),
          "sparse FFM losses != dense")
    check(np.allclose(runs["sharded"][2], runs["sparse"][2], rtol=1e-4,
                      atol=1e-6), "sharded FFM losses != replicated")
    table_diff = float((runs["sharded"][1][2][:rows]
                        - runs["sparse"][1][2]).abs().max())
    check(table_diff < 1e-4, f"sharded table != replicated ({table_diff})")
    for name in ("sparse", "sharded"):
        tr = FMTrainer(cfg, mesh=mesh, **FM_PATHS[name])
        _, stream = tr.fit_stream((data for _ in range(FM_FIT_STEPS)),
                                  params=p0)
        check(np.allclose(stream, runs[name][2], rtol=1e-5, atol=1e-7),
              f"{name} FFM stream {stream} != fit {runs[name][2]}")
        rec[name]["stream_losses"] = stream.tolist()
        rec[name]["stream_bitwise"] = bool(
            np.array_equal(stream, runs[name][2]))
    print(f"FFM equalities hold: sparse == dense and sharded == replicated "
          f"(rtol 1e-4; tables within {table_diff:.2e}), stream == fit "
          f"(rtol 1e-5; bitwise: replicated "
          f"{rec['sparse']['stream_bitwise']}, sharded "
          f"{rec['sharded']['stream_bitwise']})", flush=True)
    del runs, p0, data
    torch.cuda.empty_cache()
    return rec


def run_ffm_config4(dev):
    """BASELINE.json configs[4] at the repo's bench shape (one member, the
    sparse path, bench.py's data): steps/s."""
    rng = np.random.default_rng(3)
    cfg = FMConfig(**CONFIG4)
    K = cfg.max_nnz
    data = (rng.integers(0, cfg.n_features, (CONFIG4_ROWS, K)).astype(
                np.int32),
            rng.integers(0, cfg.n_fields, (CONFIG4_ROWS, K)).astype(np.int32),
            np.ones((CONFIG4_ROWS, K), np.float32),
            (rng.random(CONFIG4_ROWS) > 0.5).astype(np.float32))
    mesh = make_mesh(1)
    p0 = FMTrainer(cfg, mesh=mesh).init_params(seed=0)
    _, _, losses, ms, _ = fm_path("sparse", cfg, mesh, data, p0,
                                  CONFIG4_TIMED_STEPS)
    print(f"FFM configs[4] shape ({cfg.n_features} features x "
          f"{cfg.n_fields} fields, k {cfg.k}, {CONFIG4_ROWS} rows, one "
          f"member, sparse): {ms:.3f} ms a step, {1e3 / ms:.3f} steps/s",
          flush=True)
    return {"ms_per_step": ms, "steps_s": 1e3 / ms,
            "losses": losses.tolist()}


def overlap_maps(keys, key):
    """configs[2]'s key layout (bench.py ``bench_socket_map``): member r
    holds keys ``(r * keys // 2 + i) % (MEMBERS * keys)``, 50 % shared
    with its neighbour; values ``float(i)``."""
    return [{key((r * keys // 2 + i) % (MEMBERS * keys)): float(i)
             for i in range(keys)} for r in range(MEMBERS)]


def host_merge(maps):
    out = {}
    for m in maps:
        for k, v in m.items():
            out[k] = out.get(k, 0.0) + v
    return out


def map_rate(cl, maps, want, reps):
    """Merged keys/s of ``reps`` synchronous allreduce_map calls (host
    clock; each call ends with the values on the host), each checked
    against the host merge, after one untimed warm-up."""
    cl.allreduce_map([dict(m) for m in maps], Operands.DOUBLE)
    work = [[dict(m) for m in maps] for _ in range(reps)]
    t0 = time.perf_counter()
    for w in work:
        cl.allreduce_map(w, Operands.DOUBLE)
    s = time.perf_counter() - t0
    for w in work:
        check(all(m == want for m in w), "allreduce_map != host merge")
    return reps * len(want) / s, s / reps


def run_maps(dev):
    """configs[2]: 4 members, 20,000 string keys a member, 50 % overlap,
    DOUBLE SUM; then 50,000 int keys a member, synchronous and chained
    MAP_CHAIN deep through allreduce_map_async. Merged keys/s."""
    cl = GpuCommCluster(MEMBERS)
    check(cl.device == dev, "the cluster is not on the card")
    smaps = overlap_maps(MAP_KEYS, lambda c: f"w{c}")
    swant = host_merge(smaps)
    s_rate, s_call = map_rate(cl, smaps, swant, MAP_REPS)
    imaps = overlap_maps(MAP_INT_KEYS, lambda c: c)
    iwant = host_merge(imaps)
    i_rate, i_call = map_rate(cl, imaps, iwant, MAP_REPS)
    work = [[dict(m) for m in imaps] for _ in range(MAP_CHAIN)]
    t0 = time.perf_counter()
    handles = [cl.allreduce_map_async(w, Operands.DOUBLE) for w in work]
    for h in handles:
        h.result()
    chain_s = time.perf_counter() - t0
    for w in work:
        check(all(m == iwant for m in w), "allreduce_map_async != merge")
    c_rate = MAP_CHAIN * len(iwant) / chain_s
    print(f"map allreduce, {MEMBERS} members, DOUBLE SUM (host clock): "
          f"{MAP_KEYS} string keys a member (union {len(swant)}) "
          f"{s_rate:.0f} merged keys/s ({s_call * 1e3:.2f} ms a call); "
          f"{MAP_INT_KEYS} int keys a member (union {len(iwant)}) "
          f"{i_rate:.0f} keys/s ({i_call * 1e3:.2f} ms a call), chained "
          f"{MAP_CHAIN} deep {c_rate:.0f} keys/s; every result == the "
          "host merge", flush=True)
    return {"string_keys_s": s_rate, "string_call_ms": s_call * 1e3,
            "int_keys_s": i_rate, "int_call_ms": i_call * 1e3,
            "int_chained_keys_s": c_rate}


def run_linear(dev):
    """Logistic regression over the GBDT headline's rows as floats
    (bins / B; label bins[:, 0] / B + noise > 0.5), 4 members,
    LINEAR_STEPS steps: loss and steps/s; the first 100,000 rows' fit on
    the card equals the CPU's at rtol 1e-5."""
    bins, y = make_data(ROWS, F, B)
    x = torch.from_numpy(bins).to(dev).float() / B
    yl = (torch.from_numpy(y).to(dev) > 0.5).float()
    del bins, y
    cfg = LinearConfig(n_features=F, loss="logistic", learning_rate=0.5)
    tr = LinearTrainer(cfg, mesh=make_mesh(MEMBERS))
    tr.fit(x, yl, n_steps=1)                                  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    params, losses = tr.fit(x, yl, n_steps=LINEAR_STEPS)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / LINEAR_STEPS
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"linear losses {losses}")
    sub = 100_000
    _, lc = LinearTrainer(cfg, mesh=make_mesh(MEMBERS)).fit(
        x[:sub], yl[:sub], n_steps=LINEAR_STEPS)
    _, lp = LinearTrainer(cfg, mesh=make_mesh(MEMBERS, "cpu")).fit(
        x[:sub].cpu(), yl[:sub].cpu(), n_steps=LINEAR_STEPS)
    check(np.allclose(lc, lp, rtol=1e-5, atol=1e-6),
          f"linear on the card {lc} != CPU {lp}")
    print(f"linear logistic, {ROWS} x {F} f32 over {MEMBERS} members: loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} in {LINEAR_STEPS} steps, "
          f"{ms:.3f} ms a step (fit, CUDA events), {1e3 / ms:.2f} steps/s; "
          f"card == CPU on {sub} rows", flush=True)
    del x, yl
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "steps_s": 1e3 / ms,
            "losses": losses.tolist()}


# ----------------------------------------------------------------------
# slice 7: the multi-process plane (worker processes of this script)
# ----------------------------------------------------------------------
def save_reference(name, trees, margins):
    """A phase's timed trees and margins, for the workers of phase 8."""
    os.makedirs(WORK_DIR, exist_ok=True)
    with open(os.path.join(WORK_DIR, f"ref_{name}.pkl"), "wb") as f:
        pickle.dump({"trees": [tuple(a.cpu() for a in t) for t in trees],
                     "margins": margins.cpu()}, f)


def rank_worker(job):
    """One rank of a phase-8 job (``job``: the dict ``run_processes``
    passes). Runs checkdist's checks, then GBDT over ``global_mesh()`` at
    the headline shape: 1 warm-up tree whose histogram calls (this
    rank's rows, the job's fixed-point seed) are each held against the
    plain version, 3 timed trees between the launch counts, held bitwise
    against the reference trees of ``job["ref"]``, and one more tree with
    every cross-process fold timed. Writes its
    record to ``job["out"]``; returns the job-wide exit code."""
    from ytk_mp4j_tpu_torch.check import checkdist
    from ytk_mp4j_tpu_torch.comm.distributed import (all_gather_rows,
                                                     global_mesh,
                                                     init_distributed)

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    comm = init_distributed(num_processes=job["world"],
                            process_id=job["rank"],
                            init_method=f"file://{job['store']}",
                            backend=job["backend"], device=job["device"],
                            timeout=PROCESS_DEADLINE_S)
    rec = {"rank": comm.rank, "backend": comm.backend,
           "init_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    fails = checkdist.run_checks(comm)
    rec["checks_s"] = time.perf_counter() - t0
    rec["check_failures"] = fails

    bins, y = make_data(ROWS, F, B)
    dbins = torch.from_numpy(bins).to(comm.device)
    dy = torch.from_numpy(y).to(comm.device)
    del bins, y
    mesh = global_mesh()
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    trainer = GBDTTrainer(cfg, mesh=mesh)
    calls = record_levels(trainer, dbins, dy)            # warm-up tree
    # every level's call of this rank (its rows, the job's seed) against
    # the plain version; the cells the call gives unseeded that differ
    lv_errs, rec["unseeded_cells_differing"] = [], []
    for call in calls:
        lv_errs.append(level_errors(call))
        bins, g, h, ids, k, absmax = call
        seeded = hk.histograms(bins, g, h, ids, k, F, B, absmax)
        unseeded = hk.histograms(bins, g, h, ids, k, F, B)
        rec["unseeded_cells_differing"].append(
            [int((a != b).sum()) for a, b in zip(unseeded, seeded)])
    rec["hist_seeded"] = all(c[5] is not None for c in calls)
    rec["hist_max_abs_err"] = max(e for lv in lv_errs for e, _ in lv)
    rec["hist_misses"] = [
        f"level {d} {'gh'[k]}: kernel vs plain {e} > {tol}"
        for d, lv in enumerate(lv_errs) for k, (e, tol) in enumerate(lv)
        if not e <= tol]
    del calls, seeded, unseeded
    torch.cuda.synchronize()
    # the peak of the trees alone; the allocator keeps its cached blocks,
    # so the timed trees allocate as the warm-up tree left them
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    trees, margins, tree_s, host_s = train_timed(trainer, dbins, dy)
    rec["launches"] = read_counts()["hist_kernel"]
    rec["trees_per_s"] = 1 / tree_s
    rec["host_s"] = host_s
    with open(job["ref"], "rb") as f:
        ref = pickle.load(f)
    same = (len(trees) == len(ref["trees"]) and all(
        torch.equal(a.cpu(), b) for t, r in zip(trees, ref["trees"])
        for a, b in zip(t, r)))
    rec["trees_equal"] = bool(same)
    rec["margins_equal"] = bool(torch.equal(margins.cpu(), ref["margins"]))

    # one more tree, every cross-process fold (gather and rank-order
    # fold) timed on the host clock, synchronized
    real = gbdt._fold_across
    fold_ms = []

    def timed_fold(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        fold_ms.append((time.perf_counter() - t) * 1e3)
        return out

    gbdt._fold_across = timed_fold
    try:
        trainer.train(dbins, dy, n_trees=1)
    finally:
        gbdt._fold_across = real
    # one fold a level (g and h together), then one of the leaf sums
    check(len(fold_ms) == DEPTH + 1, f"{len(fold_ms)} folds in a tree")
    rec["fold_ms_levels"] = fold_ms[:DEPTH]
    rec["fold_ms_leaves"] = fold_ms[DEPTH]
    # the gather alone, every rank idle: a level's g and h partials at 1
    # and 16 nodes, 10 gathers after a barrier
    rec["idle_gather_ms"] = {}
    for nodes in (1, 16):
        x = torch.randn(nodes, 2, F, B, device=comm.device)
        comm.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            all_gather_rows(x, mesh.group)
        torch.cuda.synchronize()
        rec["idle_gather_ms"][nodes] = (time.perf_counter() - t) * 100
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = (fails == 0 and rec["launches"] == DEPTH * TIMED_TREES and same
          and rec["margins_equal"] and rec["hist_seeded"]
          and not rec["hist_misses"])
    comm.close(0 if ok else 1)
    rec["final_code"] = comm.final_code
    with open(job["out"], "w") as f:
        json.dump(rec, f)
    return comm.final_code


def run_processes(world, backend, ref, tag):
    """Phase-8 job: ``world`` worker processes of this script on cuda:0,
    meeting through a file store; every worker killed at the deadline.
    Returns the ranks' records."""
    store = os.path.join(WORK_DIR, f"store_{tag}")
    if os.path.exists(store):
        os.remove(store)
    jobs = [{"world": world, "rank": r, "backend": backend, "store": store,
             "device": "cuda:0",
             "ref": os.path.join(WORK_DIR, f"ref_{ref}.pkl"),
             "out": os.path.join(WORK_DIR, f"{tag}_rank{r}.json")}
            for r in range(world)]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker",
         json.dumps(j)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env) for j in jobs]
    deadline = time.monotonic() + PROCESS_DEADLINE_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
                .decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"{tag}: {world} workers passed the "
                           f"{PROCESS_DEADLINE_S} s deadline")
    took = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, f"workers_{tag}.log"), "w") as f:
        f.write("\n".join(f"--- rank {r}\n{log}"
                          for r, log in enumerate(logs)))
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            print(log[-3000:], file=sys.stderr)
            raise RuntimeError(f"{tag}: worker {r} exited {p.returncode}")
    recs = []
    for j in jobs:
        with open(j["out"]) as f:
            recs.append(json.load(f))
    for rec in recs:
        check(rec["backend"] == (backend or "nccl"),
              f"{tag}: rank {rec['rank']} ran {rec['backend']}")
        check(rec["check_failures"] == 0, f"{tag}: checkdist failed")
        check(rec["hist_seeded"], f"{tag}: rank {rec['rank']}'s histogram "
              "calls were not seeded with the job's scale")
        check(not rec["hist_misses"], f"{tag}: rank {rec['rank']}: "
              f"{rec['hist_misses']}")
        check(rec["launches"] == DEPTH * TIMED_TREES,
              f"{tag}: rank {rec['rank']} launched the kernel "
              f"{rec['launches']} times, want {DEPTH * TIMED_TREES}")
        check(rec["trees_equal"] and rec["margins_equal"],
              f"{tag}: rank {rec['rank']}'s trees/margins != {ref}'s")
    rate = min(rec["trees_per_s"] for rec in recs)
    fold = np.mean([np.mean(rec["fold_ms_levels"]) for rec in recs])
    err = max(rec["hist_max_abs_err"] for rec in recs)
    differ = [int(np.sum(rec["unseeded_cells_differing"])) for rec in recs]
    cells = 2 * F * B * (2 ** DEPTH - 1)      # g and h, every level's nodes
    print(f"{tag}: {world} process(es), backend {recs[0]['backend']}, "
          f"{took:.1f} s in all (checks {max(r['checks_s'] for r in recs):.1f}"
          f" s); {TIMED_TREES} trees at {rate:.3f} trees/s (slowest rank), "
          f"launches {[r['launches'] for r in recs]}, trees and margins "
          f"bitwise {ref}'s; each rank's {DEPTH} seeded histogram calls "
          f"vs plain: max abs err {err:.3e}; unseeded, {differ} of {cells} "
          f"cells a rank would differ; cross-process fold {fold:.3f} ms a level (host, "
          f"mean over levels and ranks; leaves "
          f"{np.mean([r['fold_ms_leaves'] for r in recs]):.3f} ms); peak "
          f"device memory {[round(r['peak_gib'], 2) for r in recs]} GiB; "
          f"one gather of a level's g and h, every rank idle: "
          f"{max(r['idle_gather_ms']['1'] for r in recs):.3f} ms at 1 node, "
          f"{max(r['idle_gather_ms']['16'] for r in recs):.3f} ms at 16 "
          "(slowest rank)", flush=True)
    return {"world": world, "backend": recs[0]["backend"], "s": took,
            "trees_per_s": rate, "fold_ms_level": fold, "max_abs_err": err,
            "ranks": recs}


def run_multiprocess(mesh4_rates):
    """Phase 8: (a) NCCL at world size 1, (b) PROCESSES gloo ranks."""
    nccl = run_processes(1, None, "one_member", "nccl1")
    gloo = run_processes(PROCESSES, "gloo", "mesh4", f"gloo{PROCESSES}")
    print(f"GBDT over {PROCESSES} gloo processes {gloo['trees_per_s']:.3f} "
          f"trees/s against make_mesh({MEMBERS}) in this run "
          f"{mesh4_rates['timed']:.3f} (timed set) / "
          f"{mesh4_rates['turns']:.3f} (median in turns) trees/s; "
          f"NCCL world 1 {nccl['trees_per_s']:.3f} trees/s", flush=True)
    return {"nccl_world1": nccl, "gloo": gloo, "mesh4": mesh4_rates}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}", flush=True)

    dbins, dy = device_data(dev)
    hist_entry, gbdt_record = run_gbdt(dev, dbins, dy)
    dp_record = run_data_parallel(dbins, dy, gbdt_record)
    hist_entry["data_parallel_launches"] = dp_record["launches"]
    hist_entry["max_abs_err"] = max(hist_entry["max_abs_err"],
                                    dp_record["max_abs_err"])
    raw_record = run_train_raw(dev, dbins, dy)
    del dbins, dy
    torch.cuda.empty_cache()
    entry_record = run_entry()
    ring_entries, ring_record = run_ring(dev)
    kernels = [hist_entry] + ring_entries
    slice6 = {"ffm_criteo": run_ffm_criteo(dev),
              "ffm_config4": run_ffm_config4(dev), "maps": run_maps(dev),
              "linear": run_linear(dev)}
    slice7 = run_multiprocess({
        "timed": dp_record["trees_per_s"],
        "turns": dp_record["turns"]["members_median"]})
    hist_entry["max_abs_err"] = max(hist_entry["max_abs_err"],
                                    slice7["nccl_world1"]["max_abs_err"],
                                    slice7["gloo"]["max_abs_err"])
    hist_entry["process_path_launches"] = {
        "nccl_world1": [r["launches"] for r in slice7["nccl_world1"]["ranks"]],
        f"gloo{PROCESSES}": [r["launches"] for r in slice7["gloo"]["ranks"]]}

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi, "gbdt": gbdt_record,
                   "data_parallel": dp_record, "train_raw": raw_record,
                   "entry": entry_record, "ring": ring_record,
                   "slice6": slice6, "slice7": slice7,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":
        sys.exit(rank_worker(json.loads(sys.argv[2])))
    sys.exit(main())
