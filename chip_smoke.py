#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``ytk_mp4j_tpu_torch``) on one card.

Drives the port's main path -- ``GBDTTrainer.train`` on N = 11,000,000
rows x 28 features x 256 bins, depth 6 (the Higgs row count of
BASELINE.json's GBDT configuration, and bench.py's headline leg) --
through the hand-written CUDA histogram kernel, and holds that kernel
against its plain PyTorch version on the card. Phases:

1. build the kernels from the sources in this checkout (one ``nvcc``
   per source, all started together) and print the card's name and
   power limit;
2. the kernel against its plain version and an f64 sum at the main
   path's shapes: n_nodes 1 and 16, sentinel ids, zero rows, N = 0,
   bitwise equality of two launches;
3. the slice: 1 warm-up tree, then 3 timed trees with every launch
   count set to 0 just before and read just after; trees/s, GB/s
   (bench.py's ``scanned_bytes``), per-level kernel, plain and
   ``torch.bincount`` times beside the bound; ``predict`` must return
   the training margins, and one tree through the kernel must equal
   the same tree through the plain histogram;
4. one JSON line of kernels, then the card's ``nvidia-smi`` line, then
   the ``{"ok": true, ...}`` line last.

Any failed check raises, and the script exits non-zero without the ok
line; so it does where CUDA is absent or the package is not beside it.
A longer record goes to ``chiprun_out/chip_smoke.json``.

Usage: ``python3 chip_smoke.py`` from the repo root (no arguments).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ytk_mp4j_tpu_torch import GBDTConfig, GBDTTrainer
from ytk_mp4j_tpu_torch.models import gbdt
from ytk_mp4j_tpu_torch.ops import _build
from ytk_mp4j_tpu_torch.ops import hist_kernel as hk

ROWS = 11_000_000
F, B, DEPTH = 28, 256, 6
TIMED_TREES = 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
KERNEL_REL_TOL = 1e-5              # vs an f64 sum, relative to its max


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


def level_bound_ms(n, n_nodes):
    """Least time for one histogram call: bytes (each input read once,
    each output written once) over HBM rate vs adds over the f32 rate."""
    moved = n * (4 * F + 12) + 2 * n_nodes * F * B * 4
    ops = 2 * n * F
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
    return max_abs


def record_levels(trainer, dbins, dy):
    """Train one tree while keeping each histogram call's inputs."""
    real = gbdt.build_histograms
    calls = []

    def recorder(bins, g, h, node_ids, n_nodes, cfg):
        calls.append((g, h, node_ids, n_nodes))
        return real(bins, g, h, node_ids, n_nodes, cfg)

    gbdt.build_histograms = recorder
    try:
        trainer.train(dbins, dy, n_trees=1)
    finally:
        gbdt.build_histograms = real
    torch.cuda.synchronize()
    return calls


def phase_levels(dbins, calls):
    """Per-level kernel / plain / bincount ms beside the bound."""
    n = dbins.shape[0]
    rows = []
    for d, (g, h, ids, n_nodes) in enumerate(calls):
        kern = timed_ms(lambda: hk.histograms(dbins, g, h, ids, n_nodes,
                                              F, B), 10)
        plain = timed_ms(lambda: hk.histograms_reference(
            dbins, g, h, ids, n_nodes, F, B), 2)
        lib = timed_ms(bincount_call(dbins, g, h, ids, n_nodes), 2)
        torch.cuda.empty_cache()
        bound = level_bound_ms(n, n_nodes)
        rows.append(dict(level=d, n_nodes=n_nodes, ms=kern, plain_ms=plain,
                         library_ms=lib, bound_ms=bound))
        print(f"level {d} (n_nodes={n_nodes}): kernel {kern:.3f} ms, plain "
              f"{plain:.3f} ms, bincount {lib:.3f} ms, bound {bound:.3f} ms "
              f"(bytes)", flush=True)
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    n = ROWS
    t0 = time.perf_counter()
    bins, y = make_data(n, F, B)
    dbins = torch.from_numpy(bins).to(dev)
    dy = torch.from_numpy(y).to(dev)
    del bins
    print(f"data {n} x {F} x {B} on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    max_abs = phase_kernel_checks(dbins, dev)

    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    trainer = GBDTTrainer(cfg)
    calls = record_levels(trainer, dbins, dy)        # warm-up tree
    check(len(calls) == DEPTH, f"{len(calls)} histogram calls in a tree")

    hk.histograms.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    trees, margins = trainer.train(dbins, dy, n_trees=TIMED_TREES)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = hk.histograms.launches
    tree_s = start.elapsed_time(end) / 1e3 / TIMED_TREES
    gbs = scanned_bytes(n, F, DEPTH) / tree_s / 1e9
    print(f"slice: {TIMED_TREES} trees, {1 / tree_s:.3f} trees/s, "
          f"{gbs:.3f} GB/s scanned (host clock {host_s:.3f} s), "
          f"hist launches {launches}", flush=True)
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

    # one tree through the kernel against the same tree through the plain
    # histogram, on the same card (the reference the CPU tests tie to JAX)
    small = min(n, 200_000)
    kw = dict(n_features=F, n_bins=B, depth=DEPTH, n_trees=1)
    tk, mk = GBDTTrainer(GBDTConfig(**kw)).train(dbins[:small], dy[:small])
    tp, mp = GBDTTrainer(GBDTConfig(hist_mode="flat", **kw)).train(
        dbins[:small], dy[:small])
    for k in range(3):
        check(torch.equal(tk[0][k], tp[0][k]), "kernel tree != plain tree")
    torch.testing.assert_close(tk[0][3], tp[0][3], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mk, mp, rtol=1e-5, atol=1e-6)
    print(f"kernel tree == plain tree on {small} rows", flush=True)

    rows = phase_levels(dbins, calls)
    mean = {k: sum(r[k] for r in rows) / len(rows)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernels = [{
        "name": "hist_kernel", "route": "cuda",
        "source": "ytk_mp4j_tpu_torch/ops/csrc/hist_kernel.cu",
        "replaces": "ytk_mp4j_tpu/ops/hist_kernel.py:106",
        "launches": launches, "max_abs_err": max_abs,
        "ms": mean["ms"], "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"], "bound_by": "bytes",
        "library_ms": mean["library_ms"],
    }]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi, "rows": n,
                   "trees_per_s": 1 / tree_s, "gb_per_s": gbs,
                   "levels": rows, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
