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

Slice 8, FM/FFM and linear over processes: ``FMTrainer`` on its dense,
sparse and sharded-table paths and ``LinearTrainer`` over
``global_mesh()``, ``fit(comm=)`` (no kernel of their own).

Slice 9, the socket plane: the port's ``Master``, ``ProcessCommSlave``
(TCP and shared-memory transports, the native merge and raw data plane,
the progression engine) and ``ThreadCommSlave``, with the trainers'
``comm=`` over it; GBDT runs the histogram kernel on every rank.

Slice 10, the serve plane and the check suites: ``ServeFrontend`` /
``serve_worker`` over the socket plane with the GBDT, FFM and linear
servables, then ``check.checkgpu`` and ``check.checkaot``.

Slice 11, the examples and tracing: the eleven mirrors of the reference's
examples (``examples/torch/``) run on the card, the port's entry points
as a user calls them, and the device planes' collectives traced
(``trace_collectives``).

Slice 12, members on a device list: ``make_mesh(n, devices=[...])``, one
member a tensor of its own on its list entry, in one process -- GBDT,
``GpuCommCluster(mesh=)`` and the ring kernel launched a member at a
time. One card runs the whole path with the list ``["cuda:0"] * n``.

Slice 13, the rest of the list form: ``FMTrainer`` (dense, sparse,
sharded) and ``LinearTrainer`` over ``make_mesh(4, devices=[...])``, the
map family of ``GpuCommCluster(mesh=<list mesh>)``, and
``entry.dryrun(n, devices=[...])``, the counterpart of the reference's
``dryrun_multichip``, whose members are chips.

Slice 14, the list form's ring kernel redesigned (``ring_member.cu``):
each member's launch reads the chunks it owes straight from every
member's input and folds each in the ring's order; CUDA events order
the launches (no flag, no spin); an allreduce is one launch a member
below a size threshold and two above it (fold the owned chunk, then
copy the others from their owners).

Slice 15, the packed ring's global path redesigned (``ring_kernel.cu``,
n > 8 members, or a cluster size the card refuses): one plain launch
that folds each chunk once, straight from the members' rows, in the
ring's fold order, and writes it to every row that receives it (an
allgather copies each member's part to every row); no flag, slot, spin
or cooperative launch. Driven at the reference's own meshes: 16 members
(BASELINE.json's north star, a v5e-16 pod) and 64 (configs[4]'s
v5e-64), through ``GpuCommCluster(16)`` and the ring kernels.

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
   h); the leaf-sum kernel (``ops/csrc/leaf_sums.cu``) on the tree's
   own leaf ids: bitwise its order of adds (``fixed_order_sums``), near
   the plain ``index_add`` version, and kernel, plain and
   ``torch.bincount`` ms beside its bound (each row's id, g and h). The
   profiled tree reports the members' folds and the leaf sums apart
   (``torch.profiler`` ranges around ``gbdt._fold`` and
   ``gbdt._segment_sum2``, CPU and CUDA activity);
4. the data-parallel slice on the same data: 1 warm-up tree, 3 timed
   trees between the counts (18 histogram launches: one a level; 3
   leaf-sum launches: one a tree over every member; 18 route launches,
   ``ops/csrc/route_kernel.cu``: one a level, as in slice 3), trees/s
   and GB/s, ``predict`` == the margins, trees/s in 10 pairs of 3 trees
   against one member (order alternating), the profiled tree's split beside
   the one-member tree's, kernel tree == plain tree on 200,000 rows, the
   (2, 2) mesh's tree and margins bitwise equal to the flat mesh's (the
   same code path: run-to-run repeatability), and per level the kernel
   against its plain version and the kernel's, plain and bincount ms at
   4 x n_nodes nodes beside the bound, and the leaf-sum kernel's row over
   4 members;
   ``train_raw`` over 4 members on 11M x 28 raw f32 features (the bins
   plus uniform noise): the fit (host, 1M-row sample) and the transform
   (card) timed apart, the card's transform of the first 1M rows bitwise
   equal to the CPU's, ``predict_raw`` and ``save_model`` ->
   ``load_model`` -> ``predict`` equal to the margins; the histogram
   kernel at ``gbdt-bosch.dp4``'s width (one member's 295,937 rows x 968
   features, ~81 % in bin 0: 31 cell groups a node, each loading only
   its own features' quads of a row) at 4, 16 and 64 nodes: against its
   plain version, two launches bitwise equal, the launch, row-pass and
   row-quad counts set to 0 just before and read after, ms a call;
   the route kernel (``ops/csrc/route_kernel.cu``) at the Higgs shape
   (the slice's 11M x 28 rows) and at ``gbdt-bosch.dp4``'s (1,183,748 x
   968, ~81 % in bin 0), for 1 and 4 members, numeric splits and learned
   missing directions with a categorical mask, a quarter of the
   ROUTE_NODES nodes frozen: both outputs (next node ids, next level's
   histogram ids) bitwise the plain version's, one launch counted
   between counts set to 0 and read, and kernel, plain and one-column
   copy (ATen reading the same sectors) ms by CUDA events beside the
   bound (each row's node id, one 32-byte sector of its bins, two ids
   written);
   ``entry.entry()`` and ``entry.dryrun(4)``;
5. both ring kernels against their plain versions, BITWISE (NaN as NaN):
   both directions x three modes x {SUM, PROD, MAX, MIN} x {f32, f64,
   i64, i32, i16, i8, bf16} x n in {1 (force_kernel), 2, 3, 5, 8} on the
   cluster path and n in {9, 16, 64} on the global path, odd allreduce
   lengths (padding), NaN under MAX/MIN; then 200 launches of each
   kernel at n = 8 (cluster path) on a multi-column chunk, each checked;
   the largest difference from the plain version (0 where bitwise) is
   what the kernels line reports;
6. the collective slice: every launch count set to 0, the three
   configurations above driven once (through the cluster path), then
   configs[0] through ``GpuCommCluster(16)`` (``algo="rdma"``) and the
   histogram payload over 16 members (through the global path), the
   counts read; each result must equal its plain version bitwise
   (configs[0] also under ``algo="ring"``); per call, the kernel's path,
   its ms (and ms per ring step on the cluster path), plain ms, the
   one-card ATen yardstick's ms, the global path's ms on the same call,
   and the bound. Then the global path at the reference's meshes: the
   histogram payload over 16 members (bidirectional), reduce-scatter of
   16 x 128M f64 (configs[1]'s 16 GiB), allgather of 16 x 8M f64 and
   allreduce of 64 x 1M f32, each held bitwise against its plain version
   and timed with its plain, library and bound columns; the 16-member
   reduce-scatter and allgather and the 64-member allreduce also at 1, 2
   and 4 blocks an SM (the global plan's two per-SM constants), as are
   configs[1]'s two calls forced onto the global path. Every
   time is the device time of the call's kernels (``torch.profiler``,
   mean of 5 calls), so the host's launch gap counts on no side; the
   older measure (CUDA events around each launch) is printed beside the
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
9. FM/FFM and linear over processes, in worker processes as phase 8:
   (a) NCCL at world size 1 -- checkdist's FFM and dense-plane checks,
   FFM at Criteo width on the sparse and sharded paths and linear over
   the headline rows over ``global_mesh()``, each held against (and timed
   beside) the same trainer on ``make_mesh(1)`` in the worker at rtol
   1e-5; (b) 4 gloo processes on ``cuda:0``, 4,096 rows each of phase 7's
   draw: the same checks, then each of the three FFM paths (``fit`` of 3
   steps, losses held against phase 7's ``make_mesh(4)`` losses at rtol
   1e-5; the replicated parameters bitwise equal on every rank; 1 warm-up
   and 5 timed steps; one more step with the cross-process exchange timed
   by part on the host clock: the dense all-reduce, the sparse gather,
   the sharded fetch and return, the fold of the loss and w), the
   sharded table gathered and its collective ``predict`` bitwise equal
   on every rank and equal to a local scorer, each rank's peak memory;
   linear over 4 ranks, 10 steps, against ``make_mesh(4)``; and
   ``fit(comm=)`` on both families, whose ``sync_loss_history_`` must be
   the mean of the ranks' losses. The phase's seconds are printed;
10. the socket plane, in 4 worker processes of this script under the
    port's ``Master`` in this process (the 300 s deadline of phase 8):
    one job a transport -- TCP on the native data plane, TCP framed
    (``native_transport=False``), shared memory where ``/dev/shm`` is
    writable. (a) configs[0]: ``allreduce_array`` of 1M f32 SUM on every
    job with ``algo`` rhd, ring, auto and tree: every rank's result
    bitwise equal, within rtol 1e-6 of the f64 sum, the framed and shm
    jobs bitwise the native TCP job; GB/s a rank as bench.py's
    ``bench_socket_collective`` computes it, the median of 5; the native
    merge must have built in every process. (b) configs[2]:
    ``allreduce_map`` of 20,000 string keys a rank at 50 % overlap, equal
    to the host merge; merged keys/s. (c) ``GBDTTrainer(cfg,
    mesh=make_mesh(1)).train_raw(X_r, y_r, comm=slave)`` on phase 4's raw
    features, 2.75M rows a rank: ``fit_distributed``'s edges bitwise on
    every rank and equal to ``ThreadCommSlave.spawn_group(4)``'s in this
    process; every histogram call of the warm-up tree held against the
    plain version; 3 timed trees under ``MP4J_OVERLAP=0`` and ``=1``
    (trees, margins and ``sync_round_history_`` bitwise between the two,
    18 histogram launches a rank in each); trees/s and each round's stats
    exchange in host ms. (d) ``ThreadCommSlave.spawn_group(4)`` in this
    process on (a)'s payload: bitwise (a)'s tree schedule, whose fold
    order it shares. (e) ``fit(comm=slave)`` on FM and linear:
    ``sync_loss_history_`` the ranks' mean, overlap on and off within
    rtol 1e-5;
11. the serve plane: 4 ``ProcessCommSlave`` threads of this process under
    the port's ``Master`` (elastic, health, tuner, shm and audit off, as
    bench.py's ``_serve_threads_job``), the launch counts set to 0 just
    before and read just after. (a) GBDT over the reduce plane: 32
    headline trees trained on the card on phase 3's rows (192 histogram
    launches), 1,024 of those rows served with ``max_batch`` 32 and 64 in
    flight: bitwise the same requests served one a round (each rank sums
    its own trees, the reduce adds the ranks' partials, so the answers
    are the single-rank oracle's f64 sum regrouped by rank: within 1e-12
    of ``servable.link(servable.partial_margins(bins, 0, 1))``), that
    oracle within 1e-5 of ``GBDTTrainer.predict`` on the card, a servable
    of card tensors bitwise one of numpy arrays, every worker answering.
    (b) FFM at Criteo width over the pull plane: phase 7's sparse-path
    parameters, 1,024 rows of ``criteo_data``: bitwise the sequential
    oracle (a row map of the touched ids only), within rtol 1e-5 of
    ``FMTrainer.predict``; then bench.py ``bench_serve_latency_qps``'s
    figures on that traffic (batched, one pull round a request, a warm
    replay with the cache sized to the touched rows; the speedup is
    printed, not checked). (c) linear: phase 7's parameters, 256 rows,
    bitwise the sequential oracle, within rtol 1e-5 of ``predict``;
12. the check suites: ``checkgpu --n 8 --cpu-mesh-n 8`` on cuda:0 (every
    check passes on the card and on the CPU; the ring kernels launched
    on the card at 8 members and at one, counted) and ``checkaot`` (every
    source compiled for sm_90a; each kernel's registers, shared memory
    and spills printed); artifacts in ``chiprun_out/checkgpu.json`` and
    ``checkaot.json``;
13. the examples and the traces on the card: each of the eleven mirrors
    in ``examples/torch/`` run in this process (``runpy``, ``sys.argv``
    set to ``--device cuda`` and, where the script takes it, ``--n 8``),
    the launch counts set to 0 just before each and read just after; the
    example's own asserts must hold, 01 must launch ``ring_kernel``, 08
    ``ring_kernel`` and ``ring_kernel_bidir``, 05, 07 and 11 the
    histogram kernel; each example's seconds and launches are printed and
    its output goes to ``chiprun_out/examples.log``. Then
    ``GpuCommCluster(4, "cuda")`` ``allreduce_array`` (``algo="rdma"``) and
    ``broadcast_array`` of 1024-element f32 arrays inside
    ``trace_collectives()`` must give exactly the two rows
    ``GpuCommCluster.<method>`` with the reference's payload bytes (4 x
    4096); phase 8's workers each trace one ``DistributedComm``
    collective, whose one row each must be ``DistributedComm.
    allreduce_array`` (NCCL at world 1 and gloo at 4);
14. members on a device list (``devices=["cuda:0"] * n``): with every
    launch count set to 0 just before and read just after, the GBDT
    headline over ``make_mesh(4, devices=...)`` (3 timed trees, 72
    histogram launches: one a member a level), configs[0] through
    ``GpuCommCluster(mesh=<list mesh>).allreduce_array(algo="rdma")``, the
    histogram payload bidirectional and configs[1] (reduce-scatter then
    allgather over 8) through the ring kernel launched a member at a
    time (``ring_member.cu``: the launches each call's plan makes -- one
    a member, two a member for an allreduce above
    ``ring_kernel.ONE_SHOT_BYTES``); then each result held against its
    plain version and BITWISE against the packed launch on the stacked
    members, the trees and margins bitwise the packed
    ``make_mesh(4)``'s, trees/s in 10 pairs in turns against the packed
    form, each ring call's device ms (``torch.profiler``, calls told
    apart by ``torch.cuda._sleep`` marker kernels between them: the span
    from the call's first kernel start to its last one's end, and the sum
    of its kernels' times), its ms by CUDA events around back-to-back
    calls (host included), the packed launch's, the plain version's and
    the library's ms beside the bound (HBM bytes at 3.35 TB/s: one card
    moves no NVLink byte); the member kernel held BITWISE against its
    plain version and the packed launch over phase 5's grid (every mode,
    both directions, both allreduce forms, each call made twice with no
    synchronize between); a list call refusing ``spin_s``; the one-shot
    threshold's sweep (allreduces of 4 and 8 f32 members, one launch a
    member against two, in turns, by CUDA events) and configs[1]'s spans
    at 1, 2 and 4 blocks an SM (the plan's two per-SM constants);
    ``checkgpu --devices cuda:0 x 8`` (618 checks on the
    card's list and on a CPU list, the ring kernels launched a member at
    a time). Then the list trainers (slice 13): ``entry.dryrun(4,
    devices=["cuda:0"] * 4)`` with every launch count set to 0 just
    before and read just after (28 histogram launches: one a member a
    level of its three trees; 4 member launches of ``ring_kernel`` from
    its ``algo="rdma"`` allreduce); FFM at Criteo width (phase 7's
    config, data and initial table) over the 4-entry list on the dense,
    sparse and sharded paths: ``fit`` of 3 steps held against phase 7's
    packed losses at rtol 1e-5, the 4 replicas bitwise equal, the sharded
    table's ``full_table`` against the packed one at rtol 1e-5 and its
    ``predict`` against a local scorer on the whole table, ms a step (a
    warm-up and 5 timed steps, CUDA events) in 2 pairs in turns with the
    packed ``make_mesh(4)``, and one more list step under
    ``torch.profiler`` (device ms by part -- grads, folds, gathers,
    all-to-alls, sort, segment, masked add -- and by kernel, idle share);
    phase 7's linear run over the list (losses at rtol 1e-5, replicas
    bitwise, ms a step in turns with packed); configs[2] through the list
    cluster's ``allreduce_map`` and a chain of ``allreduce_map_async``
    (each equal to the host merge and to the packed cluster; merged
    keys/s in turns). With two cards or more the same runs over
    ``min(4, count)`` distinct cards, with the NVLink bound (bytes each
    way at 450 GB/s) and ``torch.cuda.nccl.all_reduce`` as the library,
    and the list trainers over the 4 members on those cards; with one
    card it prints ``distinct cards: not run (1 card visible)``, a stated
    limit;
15. one JSON line of kernels, then the card's ``nvidia-smi`` line, then
    the ``{"ok": true, ...}`` line last.

Any failed check raises, and the script exits non-zero without the ok
line; so it does where CUDA is absent or the package is not beside it.
A longer record goes to ``chiprun_out/chip_smoke.json``.

Usage: ``python3 chip_smoke.py`` from the repo root (no arguments; the
script starts itself with ``--rank-worker`` for phases 8, 9 and 10).
"""

import bisect
import contextlib
import hashlib
import io
import json
import os
import pickle
import runpy
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
from ytk_mp4j_tpu_torch.models import linear as linear_mod
from ytk_mp4j_tpu_torch.models.binning import QuantileBinner
from ytk_mp4j_tpu_torch.operands import to_tensor
from ytk_mp4j_tpu_torch.ops import _build
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import hist_kernel as hk
from ytk_mp4j_tpu_torch.ops import leaf_sums as ls
from ytk_mp4j_tpu_torch.ops import ring_kernel as rk
from ytk_mp4j_tpu_torch.ops import route_kernel as rt
from ytk_mp4j_tpu_torch.ops import sparse as sparse_ops
from ytk_mp4j_tpu_torch.utils import trace as collective_trace

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
RING_MEMBERS = (1, 2, 3, 5, 8, 9, 16, 64)   # 9 up: the global path
RING_REPEATS = 200
TIMING_REPS = 5
PROFILE_ATTEMPTS = 3               # CUPTI now and then hands back nothing
PROFILE_WARM_LAUNCHES = 256        # CUPTI loses the first launches' kernels
CONFIG0_LEN = 1 << 20              # BASELINE.json configs[0]: 1M f32, 4 ranks
CONFIG1_LEN = 256 << 20            # configs[1]: 256M f64, 8 ranks
POD16 = 16                         # BASELINE.json's north star: v5e-16
POD64 = 64                         # configs[4]: v5e-64
CONFIG1_POD16_LEN = 128 << 20      # configs[1]'s 16 GiB over 16 members
ALLGATHER_POD16_LEN = 8 << 20      # f64 shards a member
GLOBAL_PER_SM = (1, 2, 4)          # blocks an SM tried for the global plan
HIST_PAYLOAD = 2 * 16 * F * B      # g and h planes of 16 nodes
KERNEL_REL_TOL = 1e-5              # vs an f64 sum, relative to its max
BOSCH_ROWS = 1_183_748 // MEMBERS  # gbdt-bosch.dp4's rows a member
BOSCH_F = 968                      # its features: 31 cell groups a node
BOSCH_NODES = (4, 16, 64)          # its levels' nodes a member's call sees
ROUTE_NODES = 2 ** (DEPTH - 1)     # a depth-6 tree's last routed level
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
# the runtime and driver calls that launch a kernel, by name prefix
# (cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel, cuLaunchKernelEx,
# the cooperative forms): one device event each, matched by correlation
LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel",
               "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")


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
    device event's start to the last one's end). CUPTI loses the kernels
    of some launches (the first 2 to 31 of a step in this script's
    traces; once 252 further on): small kernels go first, and only what
    starts after ``run()`` begins counts."""
    real = {label: getattr(mod, attr) for label, (mod, attr) in
            parts.items()}
    for label, (mod, attr) in parts.items():
        setattr(mod, attr, labelled(label, real[label]))
    torch.cuda.synchronize()
    path = os.path.join(OUT_DIR, name)
    try:
        # again if CUPTI saw nothing, or dropped the kernels of some
        # launches (their time would be missing from every figure); each
        # attempt warms up with a quarter of the last one's launches, and
        # the attempt that lost the fewest is kept
        best = None
        for attempt in range(PROFILE_ATTEMPTS):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                warm = torch.zeros(1, device="cuda")
                for _ in range(PROFILE_WARM_LAUNCHES >> (2 * attempt)):
                    warm.add_(1)
                torch.cuda.synchronize()
                with torch.profiler.record_function("profiled_run"):
                    run()
                    torch.cuda.synchronize()
            prof.export_chrome_trace(path + ".try")
            with open(path + ".try") as f:
                trace = json.load(f)["traceEvents"]
            begin = min((e["ts"] for e in trace if e.get("ph") == "X"
                         and e.get("name") == "profiled_run"), default=0)
            events = [e for e in trace
                      if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                      and e["ts"] >= begin]
            seen = {e.get("args", {}).get("correlation") for e in events}
            dropped = sum(1 for e in trace if e.get("ph") == "X"
                          and e.get("name", "").startswith(LAUNCH_APIS)
                          and e["ts"] >= begin
                          and e.get("args", {}).get("correlation")
                          not in seen)
            if events and (best is None or dropped < best[2]):
                best = (trace, events, dropped)
                os.replace(path + ".try", path)
            if events and not dropped:
                break
    finally:
        for label, (mod, attr) in parts.items():
            setattr(mod, attr, real[label])
        if os.path.exists(path + ".try"):
            os.remove(path + ".try")
    check(best is not None, f"the profiler saw no device event in {name}")
    trace, events, dropped = best
    if dropped:
        print(f"{name}: the profiler dropped the kernels of {dropped} "
              f"launches in the best of {PROFILE_ATTEMPTS} attempts; the "
              "figures below leave them out", flush=True)
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


def profile_tree(trainer, dbins, dy, name="tree_trace.json", parts=None):
    """One more tree like the timed ones, under ``torch.profiler``: device
    ms by kernel name, the histogram kernel's passes, the members' folds
    and the leaf sums against everything else, and the device's idle
    share over the tree's window. ``parts``: the functions that carry the
    folds and the leaf sums ({label: (module, attribute)}; default
    ``gbdt._fold`` and ``gbdt._segment_sum2``)."""
    if parts is None:
        parts = {label: (gbdt, attr) for label, attr in TREE_PARTS.items()}
    by_name, parts, busy, window = profile_run(
        lambda: trainer.train(dbins, dy, n_trees=1), parts, name,
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


@contextlib.contextmanager
def recording_histograms():
    """Keep each histogram call's inputs (the bins too: over processes
    they are the rank's rows) in the list it yields."""
    real = gbdt.build_histograms
    calls = []

    def recorder(bins, g, h, node_ids, n_nodes, cfg, absmax=None):
        calls.append((bins, g, h, node_ids, n_nodes, absmax))
        return real(bins, g, h, node_ids, n_nodes, cfg, absmax)

    gbdt.build_histograms = recorder
    try:
        yield calls
    finally:
        gbdt.build_histograms = real
    torch.cuda.synchronize()


def record_levels(trainer, dbins, dy):
    """Train one tree while keeping each histogram call's inputs and its
    leaf-sum call's. Returns (histogram calls, the leaf-sum call)."""
    real = gbdt._segment_sum2
    leaf = []

    def recorder(*args):
        leaf.append(args)
        return real(*args)

    gbdt._segment_sum2 = recorder
    try:
        with recording_histograms() as calls:
            trainer.train(dbins, dy, n_trees=1)
    finally:
        gbdt._segment_sum2 = real
    check(len(leaf) == 1, f"{len(leaf)} leaf-sum calls in a tree")
    return calls, leaf[0]


def leaf_row(call, launches):
    """The leaf-sum kernel on the inputs the main path gave it: bitwise
    its order of adds (``fixed_order_sums``, replayed on the card), within
    1e-12 of each leaf's sum of |v| of the plain version, and kernel,
    plain and ``torch.bincount`` ms beside the bound (each row's id, g and
    h read once). ``launches``: the timed trees' leaf-sum launches."""
    g, h, ids, n_members, n_leaves = call
    n = g.shape[0]
    got = ls.leaf_sums(g, h, ids, n_leaves, n_members)
    model = ls.fixed_order_sums(g, h, ids, n_leaves, n_members)
    plain = ls.leaf_sums_reference(g, h, ids, n_leaves, n_members)
    err = 0.0
    for k, v in enumerate((g, h)):
        check(torch.equal(got[k], model[k]),
              f"leaf sums {'gh'[k]}: kernel != its order of adds")
        scale = ls.leaf_sums_reference(v.abs(), v.abs(), ids, n_leaves,
                                       n_members)[0]
        err = max(err, ((got[k] - plain[k]).abs()
                        / scale.clamp_min(1e-300)).max().item())
    check(err <= 1e-12, f"leaf sums vs plain: {err:.3e} of sum |v|")
    del model, plain
    kern = timed_ms(lambda: ls.leaf_sums(g, h, ids, n_leaves, n_members),
                    20)
    plain_ms = timed_ms(lambda: ls.leaf_sums_reference(
        g, h, ids, n_leaves, n_members), 5)
    n_cells = n_members * n_leaves
    cells = (ids.long() + torch.arange(n, device=g.device)
             // (n // n_members) * n_leaves)
    idx = torch.cat([cells, cells + n_cells])
    w = torch.cat([g.double(), h.double()])
    lib = timed_ms(lambda: torch.bincount(idx, weights=w,
                                          minlength=2 * n_cells), 5)
    del cells, idx, w
    bound = n * 12 / HBM_BYTES_PER_S * 1e3
    row = dict(members=n_members, n_leaves=n_leaves, rows=n,
               max_rel_err=err, ms=kern, plain_ms=plain_ms, library_ms=lib,
               bound_ms=bound, launches=launches)
    print(f"leaf sums ({n_members} member(s), {n_leaves} leaves, {n} rows): "
          f"bitwise its order of adds, {err:.3e} of sum |v| from plain; "
          f"kernel {kern:.4f} ms, plain {plain_ms:.4f} ms, bincount "
          f"{lib:.4f} ms, bound {bound:.4f} ms (bytes; {bound / kern:.0%} "
          f"of it); {launches} launches in {TIMED_TREES} trees",
          flush=True)
    return row


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
    leaf_launches = counts["leaf_sums"]
    gbs = scanned_bytes(n, F, DEPTH) / tree_s / 1e9
    print(f"{what}: {TIMED_TREES} trees, {1 / tree_s:.3f} trees/s, "
          f"{gbs:.3f} GB/s scanned (host clock {host_s:.3f} s), "
          f"launches {counts}", flush=True)
    check(launches == DEPTH * TIMED_TREES,
          f"{launches} kernel launches, want {DEPTH * TIMED_TREES}")
    check(leaf_launches == TIMED_TREES,
          f"{leaf_launches} leaf-sum launches, want {TIMED_TREES}")
    check(counts["route"] == DEPTH * TIMED_TREES,
          f"{counts['route']} route launches, want {DEPTH * TIMED_TREES}")
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
                            "host_s": host_s, "launches": launches,
                            "leaf_sums_launches": leaf_launches,
                            "route_launches": counts["route"]}


def in_turns(one, many, dbins, dy, names=None):
    """trees/s of the one-member and the many-member trainer in
    TURN_PAIRS pairs of TIMED_TREES trees each, the order alternating
    from pair to pair (one, many, many, one, ...) so that a stall of the
    host or a drift of the card falls on both sides. ``names`` labels the
    two in the printed line (default: by their member counts)."""
    if names is None:
        names = ("1 member", f"{many.n_shards} members")
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
    print(f"in turns, {TURN_PAIRS} pairs of {TIMED_TREES} trees: {names[0]} "
          f"median {rec['one_member_median']:.3f} trees/s (quartiles "
          f"{rec['one_member_quartiles'][0]:.3f}-"
          f"{rec['one_member_quartiles'][1]:.3f}), {names[1]} "
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
    calls, leaf_call = record_levels(trainer, dbins, dy)   # warm-up tree
    check(len(calls) == DEPTH, f"{len(calls)} histogram calls in a tree")
    trees, margins, rec = timed_trees(trainer, dbins, dy, "slice")
    save_reference("one_member", trees, margins)
    profile = profile_tree(trainer, dbins, dy)
    kernel_tree_equals_plain(dbins, dy)

    rows, level_err = phase_levels(calls)
    rec["leaf_sums"] = leaf_row(leaf_call, rec["leaf_sums_launches"])
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


def bosch_bins(dev, n, seed, stations=52, present=0.19):
    """[n, BOSCH_F] int32 bins in station blocks of consecutive features,
    present (bins 1 to B - 1) or missing (bin 0) together, as
    ``gbdt-bosch.dp4``'s rows are: ~81 % zeros."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    station = torch.arange(BOSCH_F, device=dev) * stations // BOSCH_F
    seen = torch.rand((n, stations), generator=gen, device=dev) < present
    vals = torch.randint(1, B, (n, BOSCH_F), generator=gen, device=dev,
                         dtype=torch.int32)
    return vals * seen[:, station]


def run_bosch_width(dev):
    """The histogram kernel at ``gbdt-bosch.dp4``'s width, where one
    node's 968 x 256 cells take 31 groups and each group loads only its
    own features' quads of a row (8, the last 2: 242 a record over a
    launch). At each of BOSCH_NODES (below the root the sentinel id on
    about half the rows): two launches bitwise equal, against the plain
    version at KERNEL_REL_TOL of the plane's largest cell, the counters
    set to 0 just before them and read just after (2 launches, 62 row
    passes, 484 row quads), and ms a call by CUDA events. Returns the
    record the kernels line carries."""
    n = BOSCH_ROWS
    bins = bosch_bins(dev, n, 5)
    zeros = (bins == 0).float().mean().item()
    check(0.80 < zeros < 0.82, f"Bosch rows: {zeros:.4f} in bin 0")
    gen = torch.Generator(device=dev).manual_seed(6)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    rec = {"rows": n, "F": BOSCH_F, "B": B, "bin0_share": zeros,
           "levels": []}
    for n_nodes in BOSCH_NODES:
        ids = torch.randint(0, n_nodes, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        if n_nodes > MEMBERS:
            right = torch.rand(n, generator=gen, device=dev) < 0.5
            ids = torch.where(right, n_nodes, ids).int()
        hk.histograms.launches = 0
        hk.histograms.row_passes = 0
        hk.histograms.row_quads = 0
        a = hk.histograms(bins, g, h, ids, n_nodes, BOSCH_F, B)
        b = hk.histograms(bins, g, h, ids, n_nodes, BOSCH_F, B)
        counts = {"launches": hk.histograms.launches,
                  "row_passes": hk.histograms.row_passes,
                  "row_quads": hk.histograms.row_quads}
        plain = hk.histograms_reference(bins, g, h, ids, n_nodes, BOSCH_F, B)
        bitwise = all(torch.equal(a[k], b[k]) for k in range(2))
        rel = max(((a[k] - plain[k]).abs().max()
                   / plain[k].abs().max()).item() for k in range(2))
        del a, b, plain
        ms = timed_ms(lambda: hk.histograms(bins, g, h, ids, n_nodes,
                                            BOSCH_F, B), TIMING_REPS)
        print(f"kernel Bosch width {n} x {BOSCH_F} ({zeros:.1%} bin 0), "
              f"n_nodes={n_nodes}: rel err vs plain {rel:.3e}, bitwise "
              f"repeat {bitwise}, counts {counts}, {ms:.3f} ms a call",
              flush=True)
        check(bitwise, f"Bosch width n_nodes={n_nodes}: two launches differ")
        check(rel <= KERNEL_REL_TOL,
              f"Bosch width n_nodes={n_nodes}: kernel vs plain {rel}")
        check(counts == {"launches": 2, "row_passes": 2 * 31,
                         "row_quads": 2 * 242},
              f"Bosch width n_nodes={n_nodes}: counts {counts}")
        rec["levels"].append(dict(counts, n_nodes=n_nodes, max_rel_err=rel,
                                  bitwise_repeat=bitwise, ms=ms))
    return rec


def route_row(shape, bins, members, kind, seed):
    """The route kernel on random tables at ROUTE_NODES nodes, a quarter
    of them frozen (bin B - 1, dir 0), ``kind`` "numeric" or
    "missing+categorical" (learned directions and every third feature
    categorical), both outputs asked for: bitwise the plain version's,
    one launch between the count set to 0 and read, and kernel (as the
    trainer calls it, without the range check's wait), plain and
    one-column copy ms beside the bound."""
    n, width = bins.shape
    dev = bins.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, k):
        return torch.randint(lo, hi, (k,), generator=gen, device=dev,
                             dtype=torch.int32)

    nid, feat = ints(0, ROUTE_NODES, n), ints(0, width, ROUTE_NODES)
    bin_, dir_ = ints(0, B - 1, ROUTE_NODES), ints(0, 2, ROUTE_NODES)
    frozen = torch.arange(ROUTE_NODES, device=dev) % 4 == 3
    bin_ = torch.where(frozen, B - 1, bin_)
    dir_ = torch.where(frozen, 0, dir_)
    missing = kind != "numeric"
    cat = torch.arange(width, device=dev) % 3 == 0 if missing else None
    args = (bins, nid, feat, bin_, dir_, cat, missing, B, members)
    rt.route.launches = 0
    got = rt.route(*args)
    launches = rt.route.launches
    want = rt.route_reference(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    check(same, f"route {shape} {members} member(s) {kind}: kernel != "
          "plain")
    check(launches == 1, f"route: {launches} launches for one call")
    del got, want
    kern = timed_ms(lambda: rt.route(*args, check=False), 20)
    plain = timed_ms(lambda: rt.route_reference(*args), 5)
    col = bins[:, 0]
    lib = timed_ms(col.clone, 20)
    bound = n * (4 + min(32, 4 * width) + 8) / HBM_BYTES_PER_S * 1e3
    row = dict(shape=shape, rows=n, F=width, members=members, kind=kind,
               n_nodes=ROUTE_NODES, bitwise=same, launches=launches,
               ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound)
    print(f"route {shape} {n} x {width}, {members} member(s), {kind}, "
          f"{ROUTE_NODES} nodes: bitwise the plain version, {launches} "
          f"launch; kernel {kern:.4f} ms, plain {plain:.4f} ms, one-column "
          f"copy {lib:.4f} ms, bound {bound:.4f} ms (bytes; "
          f"{bound / kern:.0%} of it)", flush=True)
    return row


def run_route(dev, dbins, launches):
    """The route kernel at the Higgs shape (the slice's rows) and at
    ``gbdt-bosch.dp4``'s, for 1 and MEMBERS members, numeric and
    missing+categorical (:func:`route_row`). Returns the kernels line's
    ``route_kernel`` entry: the Higgs main path's case (MEMBERS members,
    numeric) and every case under ``cases``; ``launches``: the timed
    trees' route launches."""
    rows = []
    for shape in ("higgs", "bosch"):
        bins = (dbins if shape == "higgs"
                else bosch_bins(dev, MEMBERS * BOSCH_ROWS, 7))
        for members in (1, MEMBERS):
            for kind in ("numeric", "missing+categorical"):
                rows.append(route_row(shape, bins, members, kind,
                                      len(rows) + 11))
        del bins
        torch.cuda.empty_cache()
    main = rows[2]
    return {"name": "route_kernel", "route": "cuda",
            "source": "ytk_mp4j_tpu_torch/ops/csrc/route_kernel.cu",
            "replaces": "none (ytk_mp4j_tpu/models/gbdt.py:348 is XLA)",
            "launches": launches, "max_abs_err": 0,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"], "cases": rows}


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
    calls, leaf_call = record_levels(trainer, dbins, dy)   # warm-up tree
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
    # tree repeats run to run (the histogram kernel's sums and the leaf-sum
    # kernel's repeat bitwise)
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
    rec["leaf_sums"] = leaf_row(leaf_call, rec["leaf_sums_launches"])
    return dict(rec, members=MEMBERS, levels=rows, max_abs_err=level_err,
                tree_profile=profile)


def raw_features(dbins):
    """The raw f32 features of ``train_raw``: the bins plus uniform noise
    in [0, 1) from a generator seeded 0 on the bins' device."""
    gen = torch.Generator(device=dbins.device).manual_seed(0)
    return dbins.float() + torch.rand(dbins.shape, generator=gen,
                                      device=dbins.device)


def run_train_raw(dev, dbins, dy):
    """``train_raw`` over MEMBERS members on raw f32 features (the bins
    plus uniform noise in [0, 1), so binning recovers the bins up to the
    sampled edges): the fit (host) and the transform (card) timed apart,
    the card's transform of the first RAW_CHECK_ROWS rows bitwise equal to
    the CPU's, ``predict_raw`` and a ``save_model`` / ``load_model`` round
    trip equal to the training margins."""
    X = raw_features(dbins)
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
COUNTERS = {"hist_kernel": hk.histograms, "leaf_sums": ls.leaf_sums,
            "route": rt.route, "ring_kernel": rk.ring_kernel,
            "ring_kernel_bidir": rk.ring_kernel_bidir}


RING_COUNTERS = ("ring_kernel", "ring_kernel_bidir")


RING_PATHS = rk.PATHS + ("member",)     # member: a launch a list member


def zero_counts():
    for fn in COUNTERS.values():
        fn.launches = 0
    for name in RING_COUNTERS:
        for path in RING_PATHS:
            setattr(COUNTERS[name], f"{path}_launches", 0)


def read_counts():
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    for name in RING_COUNTERS:
        for path in RING_PATHS:
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


def device_ms(fn, reps=TIMING_REPS, match=None, copies=False):
    """Mean device ms of the kernels ``fn`` launches (those whose name
    holds ``match``, default all; copies and fills excluded unless
    ``copies``), from
    ``torch.profiler`` over ``reps`` calls after one warm-up: the host's
    launch latency between calls counts on no side. CUPTI now and then
    loses the kernels of a profile's first launches (or of a few further
    on), so each profile first launches PROFILE_WARM_LAUNCHES marker
    kernels (ATen's ``spin_kernel``, left out of the sum). With ``match``
    every call launches one matched kernel: the mean is over the kernels
    seen, and a profile that saw fewer than ``reps`` is taken again
    (without ``match``, one with no device time is), PROFILE_ATTEMPTS
    times at most; the attempt that saw the most is kept."""
    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)                        # (kernels seen, device us)
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_WARM_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen, total = 0, 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            moves = "Memcpy" in e.key or "Memset" in e.key
            if us and (copies or not moves) and "spin_kernel" not in e.key \
                    and (match is None or match in e.key):
                seen += e.count
                total += us
        if (seen, total) > best:
            best = (seen, total)
        if total > 0 and (match is None or seen >= reps):
            break
    seen, total = best
    check(total > 0, "the profiler saw no device time")
    if match is None:
        return total / reps / 1e3
    if seen < reps:
        print(f"device_ms: the profiler kept {seen} of {reps} calls' "
              f"{match!r} kernels in the best of {PROFILE_ATTEMPTS} "
              "attempts; the mean is over those", flush=True)
    return total / seen / 1e3


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


def ring_row(name, mode, n, length, dt, kernel, plain, library, timer,
             counter, on_global=None):
    """One timed call: kernel (its path, the older event measure; on the
    cluster path its dependent ring steps -- segments of its longest
    column times the exchanges of one segment -- and ms a step), plain,
    library and (where ``on_global`` forces it on a call that takes the
    cluster path) global-path ms, and the bound."""
    ms = device_ms(kernel, match="ring_")
    lp = counter.last_plan
    row = dict(call=name, mode=mode, n=n, length=length, dtype=str(dt),
               path=lp.path, cols=lp.cols, ms=ms,
               event_ms=timer.kernel_ms(kernel))
    if lp.path == "cluster":
        longest = max(len(lp.segments(c)) for c in range(lp.cols))
        row.update(slot_bytes=lp.slot_bytes,
                   steps=longest * rk.RingPlan(n, mode).steps)
        row["ms_per_step"] = ms / row["steps"]
        shape = (f"{row['steps']} ring steps, "
                 f"{row['ms_per_step'] * 1e3:.3f} us a step")
    else:
        row["jobs"] = lp.jobs
        shape = f"{lp.jobs} jobs x {lp.cols} columns, one pass"
    if on_global is not None:
        row["global_ms"] = device_ms(on_global, match="ring_")
    row.update(plain_ms=device_ms(plain), library_ms=device_ms(library),
               bound_ms=ring_bound_ms(mode, n, length, dt))
    torch.cuda.empty_cache()
    print(f"{name}: {row['path']} path, kernel {row['ms']:.4f} ms "
          f"({shape}; CUDA events around the launch: "
          f"{row['event_ms']:.4f} ms)"
          + (f", global path {row['global_ms']:.4f} ms"
             if on_global is not None else "")
          + f", plain {row['plain_ms']:.4f} ms, library "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          "(bytes)", flush=True)
    return row


def global_per_sm(kernel, counter, mode):
    """Device ms of one global-path call with the plan's blocks an SM for
    ``mode`` (``GLOBAL_FOLD_BLOCKS_PER_SM`` or, for an allgather,
    ``GLOBAL_COPY_BLOCKS_PER_SM``) set to each of GLOBAL_PER_SM, restored
    after: the measurement behind the constant."""
    knob = ("GLOBAL_COPY_BLOCKS_PER_SM" if mode == "allgather"
            else "GLOBAL_FOLD_BLOCKS_PER_SM")
    real = getattr(rk, knob)
    times = {}
    try:
        for v in GLOBAL_PER_SM:
            setattr(rk, knob, v)
            times[v] = device_ms(kernel, match="ring_")
            check(counter.last_plan.path == "global",
                  f"{knob} sweep left the global path")
    finally:
        setattr(rk, knob, real)
    print(f"{knob} (now {real}): {mode} ms by blocks an SM "
          + ", ".join(f"{v}: {ms:.4f}" for v, ms in times.items()),
          flush=True)
    return times


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
    host16 = [rng.standard_normal(CONFIG0_LEN).astype(np.float32)
              for _ in range(POD16)]
    hist16 = torch.randn((POD16, HIST_PAYLOAD), generator=gen, device=dev)
    cluster16 = GpuCommCluster(POD16)
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
    arrs16 = [a.copy() for a in host16]
    cluster16.allreduce_array(arrs16, Operands.FLOAT, Operators.SUM,
                              algo="rdma")
    hist16_out = rk.ring_allreduce_kernel(hist16, bidirectional=True)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"collective slice driven in {host_s:.3f} s (host clock), "
          f"launches {counts}", flush=True)
    check(counts["ring_kernel"] == 4 and counts["ring_kernel_bidir"] == 2
          and counts["hist_kernel"] == 0, f"launch counts {counts}")
    check(counts["ring_kernel.cluster"] == 3
          and counts["ring_kernel_bidir.cluster"] == 1,
          f"the 4- and 8-member calls left the cluster kernel: {counts}")
    check(counts["ring_kernel.global"] == 1
          and counts["ring_kernel_bidir.global"] == 1,
          f"the {POD16}-member calls left the global kernel: {counts}")

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
    rows["ring_kernel"][-1]["global_ms_by_blocks_per_sm"] = global_per_sm(
        lambda: rk.ring_reduce_scatter_kernel(big, path="global"),
        rk.ring_kernel, "reduce_scatter")
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
    rows["ring_kernel"][-1]["global_ms_by_blocks_per_sm"] = global_per_sm(
        lambda: rk.ring_allgather_kernel(scattered, path="global"),
        rk.ring_kernel, "allgather")
    del scattered
    torch.cuda.empty_cache()

    # ---- the global path at the reference's 16- and 64-member meshes ----
    global_rows = run_global_calls(dev, gen, timer, host16, arrs16, hist16,
                                   hist16_out)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"peak device memory of the ring phases {peak:.1f} GiB", flush=True)

    sources = {"ring_kernel": ":244", "ring_kernel_bidir": ":382"}
    files = {"cluster": "ytk_mp4j_tpu_torch/ops/csrc/ring_cluster.cu",
             "global": "ytk_mp4j_tpu_torch/ops/csrc/ring_kernel.cu"}
    entries = []
    for path, by_name in (("cluster", rows), ("global", global_rows)):
        for name, rs in by_name.items():
            total = {k: sum(r[k] for r in rs)
                     for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            paths = sorted({r["path"] for r in rs})
            check(paths == [path], f"{name}: timed calls on paths {paths}, "
                  f"want {path}")
            entries.append({
                "name": name if path == "cluster" else f"{name}.{path}",
                "route": "cuda", "source": files[path],
                "replaces": "ytk_mp4j_tpu/ops/ring_kernel.py" + sources[name],
                "path": path, "launches": counts[f"{name}.{path}"],
                "max_abs_err": RING_ERR[name],
                "ms": total["ms"], "plain_ms": total["plain_ms"],
                "bound_ms": total["bound_ms"], "bound_by": "bytes",
                "library_ms": total["library_ms"]})
    return entries, {"calls": rows, "global_calls": global_rows,
                     "host_s": host_s, "peak_gib": peak}


def run_global_calls(dev, gen, timer, host16, arrs16, hist16, hist16_out):
    """Slice 15: the main path's 16-member calls held against their plain
    versions (configs[0] through ``GpuCommCluster(16)`` also against
    ``algo="ring"``), then the global path timed at the reference's
    meshes, each call held bitwise against its plain version first; the
    16-member reduce-scatter and allgather and the 64-member allreduce
    also at each of GLOBAL_PER_SM blocks an SM."""
    stacked = to_tensor(np.stack(host16), dev)
    held("ring_kernel", torch.from_numpy(np.stack(arrs16)),
         rk.ring_allreduce_reference(stacked).cpu(),
         f"configs[0] over {POD16} rdma")
    ring = [a.copy() for a in host16]
    GpuCommCluster(POD16).allreduce_array(ring, Operands.FLOAT,
                                          Operators.SUM, algo="ring")
    for r in range(POD16):
        check(np.array_equal(arrs16[r], ring[r]),
              f"configs[0] over {POD16}: rdma != ring")
    print(f"configs[0] over {POD16} members (global path): rdma == plain "
          "== ring, bitwise", flush=True)
    rows = {"ring_kernel": [], "ring_kernel_bidir": []}
    rows["ring_kernel"].append(ring_row(
        f"configs[0] allreduce {POD16} x 1M f32", "allreduce", POD16,
        CONFIG0_LEN, torch.float32, lambda: rk.ring_allreduce_kernel(stacked),
        lambda: rk.ring_allreduce_reference(stacked),
        replicated_sum(stacked), timer, rk.ring_kernel))
    del stacked
    held("ring_kernel_bidir", hist16_out,
         rk.ring_allreduce_reference(hist16, bidirectional=True),
         f"histogram payload over {POD16}")
    rows["ring_kernel_bidir"].append(ring_row(
        f"histogram payload allreduce {POD16} x 2x16x28x256 f32 bidir",
        "allreduce", POD16, HIST_PAYLOAD, torch.float32,
        lambda: rk.ring_allreduce_kernel(hist16, bidirectional=True),
        lambda: rk.ring_allreduce_reference(hist16, bidirectional=True),
        replicated_sum(hist16), timer, rk.ring_kernel_bidir))

    x = torch.randn((POD16, CONFIG1_POD16_LEN), generator=gen, device=dev,
                    dtype=torch.float64)
    held("ring_kernel", rk.ring_reduce_scatter_kernel(x),
         rk.ring_reduce_scatter_reference(x),
         f"reduce-scatter {POD16} x 128M f64")
    torch.cuda.empty_cache()
    rows["ring_kernel"].append(ring_row(
        f"reduce-scatter {POD16} x 128M f64", "reduce_scatter", POD16,
        CONFIG1_POD16_LEN, torch.float64,
        lambda: rk.ring_reduce_scatter_kernel(x),
        lambda: rk.ring_reduce_scatter_reference(x),
        lambda: x.sum(0).view(POD16, -1), timer, rk.ring_kernel))
    rows["ring_kernel"][-1]["ms_by_blocks_per_sm"] = global_per_sm(
        lambda: rk.ring_reduce_scatter_kernel(x), rk.ring_kernel,
        "reduce_scatter")
    del x
    torch.cuda.empty_cache()

    x = torch.randn((POD16, ALLGATHER_POD16_LEN), generator=gen,
                    device=dev, dtype=torch.float64)
    held("ring_kernel", rk.ring_allgather_kernel(x),
         rk.ring_allgather_reference(x), f"allgather {POD16} x 8M f64")
    torch.cuda.empty_cache()
    rows["ring_kernel"].append(ring_row(
        f"allgather {POD16} x 8M f64", "allgather", POD16,
        ALLGATHER_POD16_LEN, torch.float64,
        lambda: rk.ring_allgather_kernel(x),
        lambda: rk.ring_allgather_reference(x),
        lambda: x.reshape(-1).expand(POD16, -1).contiguous(), timer,
        rk.ring_kernel))
    rows["ring_kernel"][-1]["ms_by_blocks_per_sm"] = global_per_sm(
        lambda: rk.ring_allgather_kernel(x), rk.ring_kernel, "allgather")
    del x
    torch.cuda.empty_cache()

    x = torch.randn((POD64, CONFIG0_LEN), generator=gen, device=dev)
    held("ring_kernel", rk.ring_allreduce_kernel(x),
         rk.ring_allreduce_reference(x), f"allreduce {POD64} x 1M f32")
    rows["ring_kernel"].append(ring_row(
        f"allreduce {POD64} x 1M f32", "allreduce", POD64, CONFIG0_LEN,
        torch.float32, lambda: rk.ring_allreduce_kernel(x),
        lambda: rk.ring_allreduce_reference(x), replicated_sum(x), timer,
        rk.ring_kernel))
    rows["ring_kernel"][-1]["ms_by_blocks_per_sm"] = global_per_sm(
        lambda: rk.ring_allreduce_kernel(x), rk.ring_kernel, "allreduce")
    del x
    torch.cuda.empty_cache()
    return rows


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


def criteo_data(cfg, dev):
    """The FFM batch at Criteo width, drawn on the card from a seeded
    generator: phase 7 and every process of phase 9 hold the same rows."""
    gen = torch.Generator(device=dev).manual_seed(0)
    K = cfg.max_nnz
    return (torch.randint(0, cfg.n_features, (CRITEO_ROWS, K), device=dev,
                          generator=gen, dtype=torch.int32),
            torch.arange(K, dtype=torch.int32, device=dev).expand(
                CRITEO_ROWS, K).contiguous(),
            torch.ones((CRITEO_ROWS, K), device=dev),
            torch.randint(0, 2, (CRITEO_ROWS,), device=dev,
                          generator=gen).float())


def run_ffm_criteo(dev):
    """FFM at Criteo width over 4 members: dense, sparse replicated and
    sparse sharded, the reference's equalities at this size (sparse ==
    dense and sharded == replicated at rtol 1e-4; the stream of one
    full-batch chunk a step == fit at rtol 1e-5, replicated and
    sharded), steps/s and rows/s of each path."""
    ffm_small_card_equals_cpu()
    cfg = FMConfig(**CRITEO)
    mesh = make_mesh(MEMBERS)
    K = cfg.max_nnz
    data = criteo_data(cfg, dev)
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
    serve_params = runs["sparse"][1]          # phase 11 (b) serves these
    del runs, p0, data
    torch.cuda.empty_cache()
    return rec, serve_params


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


LINEAR_CFG = dict(n_features=F, loss="logistic", learning_rate=0.5)


def linear_data(dev):
    """The GBDT headline's rows as floats (bins / B) and labels (the
    target > 0.5), on the card."""
    bins, y = make_data(ROWS, F, B)
    return (torch.from_numpy(bins).to(dev).float() / B,
            (torch.from_numpy(y).to(dev) > 0.5).float())


def run_linear(dev):
    """Logistic regression over the GBDT headline's rows as floats
    (bins / B; label bins[:, 0] / B + noise > 0.5), 4 members,
    LINEAR_STEPS steps: loss and steps/s; the first 100,000 rows' fit on
    the card equals the CPU's at rtol 1e-5."""
    x, yl = linear_data(dev)
    cfg = LinearConfig(**LINEAR_CFG)
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
            "losses": losses.tolist()}, params


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
    # the device plane's collectives are traced: one row a call
    with collective_trace.trace_collectives():
        comm.allreduce_array(np.ones(1024, np.float32), Operands.FLOAT,
                             Operators.SUM)
    rec["trace_rows"] = [(name, nb)
                         for name, _s, nb in collective_trace.events()]

    bins, y = make_data(ROWS, F, B)
    dbins = torch.from_numpy(bins).to(comm.device)
    dy = torch.from_numpy(y).to(comm.device)
    del bins, y
    mesh = global_mesh()
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    trainer = GBDTTrainer(cfg, mesh=mesh)
    calls, _ = record_levels(trainer, dbins, dy)         # warm-up tree
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
    counts = read_counts()
    rec["launches"] = counts["hist_kernel"]
    rec["leaf_sums_launches"] = counts["leaf_sums"]
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


def spawn_workers(world, backend, tag, phase, **extra):
    """``world`` worker processes of this script on cuda:0 (``--rank-worker``
    with the job's dict: ``phase`` picks the worker function), meeting
    through a file store under ``.chipwork/``; every worker killed at the
    deadline. Their logs go to ``chiprun_out/workers_<tag>.log``. Returns
    (the ranks' records, seconds)."""
    store = os.path.join(WORK_DIR, f"store_{tag}")
    if os.path.exists(store):
        os.remove(store)
    jobs = [dict(extra, world=world, rank=r, backend=backend, store=store,
                 device="cuda:0", phase=phase,
                 out=os.path.join(WORK_DIR, f"{tag}_rank{r}.json"))
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
    return recs, took


def run_processes(world, backend, ref, tag):
    """Phase-8 job: ``world`` worker processes of this script on cuda:0
    running :func:`rank_worker`; its checks. Returns the ranks'
    records."""
    recs, took = spawn_workers(world, backend, tag, 8,
                               ref=os.path.join(WORK_DIR, f"ref_{ref}.pkl"))
    for rec in recs:
        check(rec["backend"] == (backend or "nccl"),
              f"{tag}: rank {rec['rank']} ran {rec['backend']}")
        check(rec["check_failures"] == 0, f"{tag}: checkdist failed")
        check([tuple(r) for r in rec["trace_rows"]] == TRACE_DIST_ROWS,
              f"{tag}: rank {rec['rank']} traced {rec['trace_rows']}")
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
    print(f"{tag}: every rank traced {TRACE_DIST_ROWS}", flush=True)
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


# ----------------------------------------------------------------------
# slice 8: FM/FFM and linear over processes (worker processes)
# ----------------------------------------------------------------------
# the cross-process exchange of an FM step, by part: the module-level
# function of models/fm.py that carries each (host ms, synchronized)
FM_EXCHANGE = {"dense all-reduce": "_sum_table_grads",
               "sparse gather": "_gather_updates",
               "sharded fetch": "_fetch_rows_across",
               "sharded return": "_return_grads_across",
               "loss and w fold": "job_sum"}
PROCESS_FM_TIMED = {"dense": FM_TIMED_STEPS, "sparse": FM_TIMED_STEPS,
                    "sharded": FM_TIMED_STEPS}
PREDICT_ROWS = 4096


def exchange_timer(parts):
    """Wrap the module functions of ``parts`` ({label: attribute of
    models/fm.py}): each call's host ms, the card synchronized before and
    after. Returns ({label: [ms]}, a function that unwraps them)."""
    real = {label: getattr(fm_mod, attr) for label, attr in parts.items()}
    ms = {label: [] for label in parts}

    def timed(label):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real[label](*args, **kwargs)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    for label, attr in parts.items():
        setattr(fm_mod, attr, timed(label))

    def restore():
        for label, attr in parts.items():
            setattr(fm_mod, attr, real[label])
    return ms, restore


def process_ffm_path(name, cfg, mesh, data, p0, timed_steps):
    """One FFM gradient path over the processes of ``mesh``: ``fit``
    (FM_FIT_STEPS, the public API; the losses phase 7 took over
    ``make_mesh(4)``), the replicated parameters compared across the
    ranks, then 1 warm-up and ``timed_steps`` steps timed (CUDA events),
    and one more step with the cross-process exchange timed by part.
    Returns (record, trainer, fitted params)."""
    from ytk_mp4j_tpu_torch.check.checkdist import identical_across_ranks

    tr = FMTrainer(cfg, mesh=mesh, **FM_PATHS[name])
    params, losses = tr.fit(*data, n_steps=FM_FIT_STEPS, params=p0)
    rec = {"losses": losses.tolist(), "finite": bool(
        np.isfinite(losses).all())}
    rec["replicated_bitwise"] = identical_across_ranks(
        params[:2] if name == "sharded" else params, mesh.group)
    rec["ms_per_step"], step, q, batch = trainer_step_ms(tr, data, p0,
                                                         timed_steps)
    ms, restore = exchange_timer(FM_EXCHANGE)
    try:
        step(q, batch)
    finally:
        restore()
    rec["exchange_ms"] = {k: sum(v) for k, v in ms.items() if v}
    del q, batch
    return rec, tr, params


def trainer_step_ms(tr, data, p0, steps):
    """:func:`steps_ms` of an FM trainer's step on ``data`` from ``p0``;
    returns (ms, step, params, batch)."""
    batch = tr.shard_data(*data)
    step = tr._step(int(batch[0].shape[1]) * tr.cfg.max_nnz)
    q = tr._place_params(p0)
    return steps_ms(step, q, batch, steps), step, q, batch


def linear_fit_ms(tr, x, y):
    """CUDA events around ``fit`` of LINEAR_STEPS steps, after a one-step
    warm-up: (ms a step, params, losses)."""
    tr.fit(x, y, n_steps=1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    params, losses = tr.fit(x, y, n_steps=LINEAR_STEPS)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LINEAR_STEPS, params, losses


def fit_comm_runs(comm, dev):
    """``fit(comm=)`` on both families, each rank on its own rows of
    tests/test_trainer_overlap.py's data. Per family: this rank's losses,
    ``sync_loss_history_``, the mean of the ranks' losses (gathered
    here) and the parameters on the host."""
    from ytk_mp4j_tpu_torch.device import make_mesh as mesh1

    r, world = comm.rank, comm.slave_num
    rng = np.random.default_rng(7)
    cx = rng.standard_normal((64, 4)).astype(np.float32)
    cy = cx @ np.array([1.0, -2.0, 0.5, 0.0], np.float32)
    feats = np.random.default_rng(11).integers(0, 32, (48, 3)).astype(
        np.int32)
    fdata = (feats, np.broadcast_to(np.arange(3, dtype=np.int32) % 2,
                                    (48, 3)).copy(),
             np.ones((48, 3), np.float32),
             ((feats[:, 0] + feats[:, 1]) % 2).astype(np.float32))
    runs = {"linear": LinearTrainer(LinearConfig(
                n_features=4, loss="squared", learning_rate=0.1),
                mesh=mesh1(1, dev)),
            "fm": FMTrainer(FMConfig(n_features=32, n_fields=2, k=2,
                                     max_nnz=3, model="fm",
                                     learning_rate=0.3, init_scale=0.1),
                            mesh=mesh1(1, dev))}
    out = {}
    for (name, tr), data in zip(runs.items(), ((cx, cy), fdata)):
        params, losses = tr.fit(*(a[r::world] for a in data), n_steps=4,
                                comm=comm)
        buf = np.zeros(world * 4, np.float64)
        buf[r * 4: (r + 1) * 4] = losses
        comm.allgather_array(buf, Operands.DOUBLE)
        out[name] = {"losses": np.asarray(losses, np.float64),
                     "sync": np.asarray(tr.sync_loss_history_),
                     "mean": buf.reshape(world, 4).mean(0),
                     "params": [p.detach().cpu().numpy() for p in params]}
    return out


def comm_sync_ok(comm, dev):
    """``sync_loss_history_`` equals the mean of the ranks' losses on
    both families of :func:`fit_comm_runs`."""
    return all(bool(np.allclose(f["sync"], f["mean"], rtol=1e-12, atol=0))
               for f in fit_comm_runs(comm, dev).values())


def process_fm_worker(job):
    """One rank of a phase-9 job: checkdist's FFM and dense-plane checks;
    FFM at Criteo width over ``global_mesh()`` on each gradient path
    (:func:`process_ffm_path`), the sharded table gathered and its
    collective ``predict`` held against a local scorer; linear over the
    headline rows; ``fit(comm=)``. At world size 1 each run is held
    against the same trainer on ``make_mesh(1)`` here; over several
    ranks the parent holds the losses against phase 7's ``make_mesh(4)``.
    Writes its record to ``job["out"]``; returns the job-wide exit
    code."""
    from ytk_mp4j_tpu_torch.check import checkdist
    from ytk_mp4j_tpu_torch.comm.distributed import (global_mesh,
                                                     init_distributed)

    torch.set_num_threads(1)
    comm = init_distributed(num_processes=job["world"],
                            process_id=job["rank"],
                            init_method=f"file://{job['store']}",
                            backend=job["backend"], device=job["device"],
                            timeout=PROCESS_DEADLINE_S)
    dev = comm.device
    world = comm.slave_num
    rec = {"rank": comm.rank, "backend": comm.backend, "ffm": {}}
    t0 = time.perf_counter()
    rec["check_failures"] = (checkdist.check_ffm_global_mesh(comm)
                             + checkdist.check_ffm_round4_global_mesh(comm)
                             + checkdist.check_dense_plane_timing(comm))
    rec["checks_s"] = time.perf_counter() - t0

    cfg = FMConfig(**CRITEO)
    data = criteo_data(cfg, dev)
    mesh = global_mesh()
    p0 = FMTrainer(cfg, mesh=mesh).init_params(seed=0)  # the whole table
    paths = ("sparse", "sharded") if world == 1 else tuple(FM_PATHS)
    fitted = {}
    for name in paths:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r, tr, params = process_ffm_path(name, cfg, mesh, data, p0,
                                         PROCESS_FM_TIMED[name])
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if world == 1:
            one = FMTrainer(cfg, mesh=make_mesh(1), **FM_PATHS[name])
            r["one_process_losses"] = one.fit(
                *data, n_steps=FM_FIT_STEPS, params=p0)[1].tolist()
            r["one_process_ms_per_step"] = trainer_step_ms(
                one, data, p0, PROCESS_FM_TIMED[name])[0]
            del one
        if name == "sharded":
            table = tr.full_table(params)                  # a collective
            r["table_bitwise"] = checkdist.identical_across_ranks(
                [torch.from_numpy(table).to(dev)], mesh.group)
            r["table_vs_sparse"] = float(np.abs(
                table - fitted["sparse"]).max())
            rows = [a[:PREDICT_ROWS] for a in data[:3]]
            got = tr.predict(params, *rows)                # a collective
            want = FMTrainer(cfg, mesh=make_mesh(1)).predict(
                (params[0], params[1], table), *rows)
            r["predict_bitwise"] = checkdist.identical_across_ranks(
                [got], mesh.group)
            r["predict_max_diff"] = float((got - want).abs().max())
            del table
        elif name == "sparse":
            fitted["sparse"] = tr.full_table(params)
        rec["ffm"][name] = r
        print(f"rank {comm.rank} FFM {name}: {r['ms_per_step']:.3f} ms a "
              f"step; exchange {r['exchange_ms']}", flush=True)
        del tr, params
    del fitted, p0, data
    torch.cuda.empty_cache()

    x, yl = linear_data(dev)
    lcfg = LinearConfig(**LINEAR_CFG)
    torch.cuda.reset_peak_memory_stats()
    ms, params, losses = linear_fit_ms(LinearTrainer(lcfg, mesh=mesh), x,
                                       yl)
    rec["linear"] = {"ms_per_step": ms, "losses": losses.tolist(),
                     "bitwise": checkdist.identical_across_ranks(
                         params, mesh.group),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if world == 1:
        ms, _, one = linear_fit_ms(LinearTrainer(lcfg, mesh=make_mesh(1)), x,
                                   yl)
        rec["linear"]["one_process_losses"] = one.tolist()
        rec["linear"]["one_process_ms_per_step"] = ms
    del x, yl
    torch.cuda.empty_cache()
    rec["comm_sync_ok"] = comm_sync_ok(comm, dev)
    ffm = rec["ffm"]
    ok = (rec["check_failures"] == 0 and rec["comm_sync_ok"]
          and rec["linear"]["bitwise"]
          and all(r["finite"] and r["replicated_bitwise"]
                  for r in ffm.values())
          and ffm["sharded"]["table_bitwise"]
          and ffm["sharded"]["predict_bitwise"])
    comm.close(0 if ok else 1)
    rec["final_code"] = comm.final_code
    with open(job["out"], "w") as f:
        json.dump(rec, f)
    return comm.final_code


def losses_close(got, want, what):
    check(np.allclose(got, want, rtol=1e-5, atol=1e-7),
          f"{what}: losses {got} != {want} (rtol 1e-5)")


def run_fm_processes(ffm_rec, linear_rec):
    """Phase 9: (a) NCCL at world size 1, (b) PROCESSES gloo ranks on
    cuda:0, each running :func:`process_fm_worker`; their checks."""
    t0 = time.perf_counter()
    out = {}
    for tag, world, backend in (("fm_nccl1", 1, None),
                                (f"fm_gloo{PROCESSES}", PROCESSES, "gloo")):
        recs, took = spawn_workers(world, backend, tag, 9)
        for rec in recs:
            r = rec["rank"]
            check(rec["backend"] == (backend or "nccl"),
                  f"{tag}: rank {r} ran {rec['backend']}")
            check(rec["check_failures"] == 0, f"{tag}: checkdist failed")
            check(rec["comm_sync_ok"], f"{tag}: sync_loss_history_ != the "
                  "mean of the ranks' losses")
            check(rec["linear"]["bitwise"], f"{tag}: linear parameters "
                  "differ across ranks")
            for name, p in rec["ffm"].items():
                check(p["finite"] and p["replicated_bitwise"],
                      f"{tag}: rank {r} FFM {name}: non-finite losses or "
                      "replicated parameters that differ across ranks")
                want = (p["one_process_losses"] if world == 1
                        else ffm_rec[name]["losses"])
                losses_close(p["losses"], want, f"{tag} FFM {name}")
            sh = rec["ffm"]["sharded"]
            check(sh["table_bitwise"] and sh["predict_bitwise"],
                  f"{tag}: the gathered table or predict differ across "
                  "ranks")
            check(sh["table_vs_sparse"] < 1e-4,
                  f"{tag}: sharded table != replicated "
                  f"({sh['table_vs_sparse']})")
            check(sh["predict_max_diff"] < 1e-5,
                  f"{tag}: sharded predict != local scorer "
                  f"({sh['predict_max_diff']})")
            losses_close(rec["linear"]["losses"],
                         rec["linear"].get("one_process_losses",
                                           linear_rec["losses"]),
                         f"{tag} linear")
        # the one-process yardstick: make_mesh(1) in the worker at world
        # size 1, phase 7's make_mesh(4) over several ranks
        one = ("make_mesh(1) in the worker" if world == 1
               else f"phase 7's make_mesh({MEMBERS})")
        paths = {}
        for name in recs[0]["ffm"]:
            parts = {}
            for rec in recs:
                for k, v in rec["ffm"][name]["exchange_ms"].items():
                    parts[k] = max(parts.get(k, 0.0), v)
            paths[name] = {
                "ms_per_step": max(rec["ffm"][name]["ms_per_step"]
                                   for rec in recs),
                "one_process_ms_per_step": recs[0]["ffm"][name].get(
                    "one_process_ms_per_step",
                    ffm_rec[name]["ms_per_step"]),
                "exchange_ms": parts,
                "peak_gib": [rec["ffm"][name]["peak_gib"] for rec in recs]}
        lin = max(rec["linear"]["ms_per_step"] for rec in recs)
        lin_one = recs[0]["linear"].get("one_process_ms_per_step",
                                        linear_rec["ms_per_step"])
        out[tag] = {"world": world, "s": took, "ffm": paths,
                    "linear_ms_per_step": lin,
                    "linear_one_process_ms_per_step": lin_one,
                    "linear_peak_gib": [rec["linear"]["peak_gib"]
                                        for rec in recs],
                    "ranks": recs}
        print(f"{tag}: {world} process(es), backend "
              f"{recs[0]['backend']}, {took:.1f} s in all (checks "
              f"{max(r['checks_s'] for r in recs):.1f} s); FFM at Criteo "
              "width, ms a step (slowest rank, CUDA events, "
              f"{FM_TIMED_STEPS} steps after a warm-up) against {one}: "
              + "; ".join(f"{n} {v['ms_per_step']:.3f} vs "
                          f"{v['one_process_ms_per_step']:.3f}, exchange "
                          + ", ".join(f"{k} {ms:.3f}" for k, ms in
                                      v["exchange_ms"].items())
                          + " ms (host, slowest rank), peak "
                          f"{[round(g, 2) for g in v['peak_gib']]} GiB"
                          for n, v in paths.items())
              + f"; linear {lin:.3f} ms a step against {lin_one:.3f}, "
              f"peak {[round(r['linear']['peak_gib'], 2) for r in recs]} "
              f"GiB; losses within rtol 1e-5 of {one}; replicated "
              "parameters bitwise on every rank; sync_loss_history_ == "
              "the ranks' mean", flush=True)
    s = time.perf_counter() - t0
    print(f"phase 9 (FM/FFM and linear over processes): {s:.1f} s",
          flush=True)
    out["s"] = s
    return out



# -- phase 10: the socket plane (slice 9) -----------------------------------
SOCKET_RANKS = 4                   # configs[0]: "4 local processes"
SOCKET_ALGOS = ("rhd", "ring", "auto", "tree")
SOCKET_REPS = 5                    # timed calls a figure (median)
SOCKET_SEED = 900


def socket_rank_array(q):
    """configs[0]'s payload of rank q: 1M f32, uniform in [0, 1) (all
    positive, so an f32 sum of 4 is within rtol 1e-6 of the f64 sum
    element by element)."""
    return np.random.default_rng(SOCKET_SEED + q).random(CONFIG0_LEN,
                                                         dtype=np.float32)


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def socket_allreduce(slave):
    """(a) configs[0] on one job: every algo, 1 warm-up and SOCKET_REPS
    timed calls after a barrier each; the result's digest, its largest
    relative error against the f64 sum, and each call's seconds."""
    r, n = slave.rank, slave.slave_num
    mine = socket_rank_array(r)
    want = sum(socket_rank_array(q).astype(np.float64) for q in range(n))
    out = {}
    for algo in SOCKET_ALGOS:
        secs = []
        for rep in range(1 + SOCKET_REPS):
            a = mine.copy()
            slave.barrier()
            t0 = time.perf_counter()
            slave.allreduce_array(a, Operands.FLOAT, Operators.SUM,
                                  algo=algo)
            if rep:
                secs.append(time.perf_counter() - t0)
        out[algo] = {"digest": digest(a), "secs": secs,
                     "max_rel": float(np.max(np.abs(a - want) / want))}
    wire = {"tcp": 0, "shm": 0}
    for fam in slave.stats().values():
        wire["tcp"] += int(fam.get("wire_bytes_tcp", 0))
        wire["shm"] += int(fam.get("wire_bytes_shm", 0))
    return out, wire


def socket_maps(slave):
    """(b) configs[2]: 20,000 string keys a rank at 50 % overlap, DOUBLE
    SUM; every result must equal the host merge. Seconds of each timed
    call after a barrier."""
    maps = overlap_maps(MAP_KEYS, lambda c: f"w{c}")
    want = host_merge(maps)
    secs, ok = [], True
    for rep in range(1 + MAP_REPS):
        d = dict(maps[slave.rank])
        slave.barrier()
        t0 = time.perf_counter()
        slave.allreduce_map(d, Operands.DOUBLE, Operators.SUM)
        if rep:
            secs.append(time.perf_counter() - t0)
        ok = ok and d == want
    return {"secs": secs, "equal": bool(ok), "keys": len(want)}


def raw_rows(dev, q=None, n=SOCKET_RANKS):
    """Phase 4's raw f32 features (:func:`raw_features`) and labels on
    the card; rank q's rows when q is given."""
    bins, y = make_data(ROWS, F, B)
    X = raw_features(torch.from_numpy(bins).to(dev))
    del bins
    dy = torch.from_numpy(y).to(dev)
    if q is None:
        return X, dy
    per = ROWS // n
    return (X[q * per:(q + 1) * per].clone(),
            dy[q * per:(q + 1) * per].clone())


def socket_gbdt(slave, dev):
    """(c) ``train_raw(X_r, y_r, comm=slave)`` on this rank's 2.75M rows:
    a warm-up tree that fits the binner through ``fit_distributed`` over
    the socket plane (every histogram call recorded and held against the
    plain version), then TIMED_TREES trees with the fitted binner under
    ``MP4J_OVERLAP=0`` and ``=1``: each tree's device time (synchronized
    on the host clock), each round's stats exchange on the host clock,
    the launch counts, and digests of the trees and margins."""
    from ytk_mp4j_tpu_torch.models import _base

    X, y = raw_rows(dev, slave.rank, slave.slave_num)
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    out = {}
    os.environ["MP4J_OVERLAP"] = "0"
    trainer = GBDTTrainer(cfg, mesh=make_mesh(1, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_histograms() as calls:
        trainer.train_raw(X, y, n_trees=1, comm=slave,
                          bin_sample=RAW_FIT_SAMPLE)
    out["warmup_s"] = time.perf_counter() - t0
    binner = trainer.binner_
    out["edges"] = digest(binner.edges)
    errs = [level_errors(c) for c in calls]
    out["hist_levels_checked"] = len(errs)
    out["hist_max_abs_err"] = max(e for lv in errs for e, _ in lv)
    out["hist_misses"] = [f"level {d} {'gh'[k]}: {e} > {tol}"
                          for d, lv in enumerate(errs)
                          for k, (e, tol) in enumerate(lv) if not e <= tol]
    del calls

    real_tree = gbdt.train_tree_shard
    real_submit = _base.StepStatsExchanger.submit_map
    real_drain = _base.StepStatsExchanger.drain
    for flag in ("0", "1"):
        os.environ["MP4J_OVERLAP"] = flag
        tree_s, exch_ms, drain_ms = [], [], []

        def timed_tree(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = real_tree(*a, **k)
            torch.cuda.synchronize()
            tree_s.append(time.perf_counter() - t)
            return res

        def timed_submit(self, d):
            t = time.perf_counter()
            res = real_submit(self, d)
            exch_ms.append((time.perf_counter() - t) * 1e3)
            return res

        def timed_drain(self):
            t = time.perf_counter()
            real_drain(self)
            drain_ms.append((time.perf_counter() - t) * 1e3)

        gbdt.train_tree_shard = timed_tree
        _base.StepStatsExchanger.submit_map = timed_submit
        _base.StepStatsExchanger.drain = timed_drain
        tr = GBDTTrainer(cfg, mesh=make_mesh(1, dev))
        zero_counts()
        try:
            trees, margins = tr.train_raw(X, y, n_trees=TIMED_TREES,
                                          comm=slave, binner=binner)
            torch.cuda.synchronize()
        finally:
            gbdt.train_tree_shard = real_tree
            _base.StepStatsExchanger.submit_map = real_submit
            _base.StepStatsExchanger.drain = real_drain
        launches = read_counts()["hist_kernel"]
        mse0 = float(y.double().pow(2).mean())
        mse = float((margins - y).double().pow(2).mean())
        out[f"overlap{flag}"] = {
            "launches": launches, "tree_s": tree_s, "exchange_ms": exch_ms,
            "drain_ms": drain_ms, "trees": digest(*[a for t in trees
                                                    for a in t]),
            "margins": digest(margins),
            "history": tr.sync_round_history_,
            "finite": bool(torch.isfinite(margins).all()),
            "loss_down": mse < mse0}
    os.environ.pop("MP4J_OVERLAP", None)
    return out


def socket_fit_comm(slave, dev):
    """(e) ``fit(comm=slave)`` on FM and linear under ``MP4J_OVERLAP=0``
    and ``=1``: the synced history against the ranks' mean (rtol 1e-12)
    and the two modes against each other (rtol 1e-5)."""
    runs = {}
    for flag in ("0", "1"):
        os.environ["MP4J_OVERLAP"] = flag
        runs[flag] = fit_comm_runs(slave, dev)
    os.environ.pop("MP4J_OVERLAP", None)
    out = {}
    for name in runs["0"]:
        off, on = runs["0"][name], runs["1"][name]
        out[name] = {
            "sync_is_mean": all(bool(np.allclose(r[name]["sync"],
                                                 r[name]["mean"],
                                                 rtol=1e-12, atol=0))
                                for r in runs.values()),
            "modes_agree": bool(
                np.allclose(on["losses"], off["losses"], rtol=1e-5,
                            atol=1e-7)
                and np.allclose(on["sync"], off["sync"], rtol=1e-5,
                                atol=1e-7)
                and all(np.allclose(a, b, rtol=1e-5, atol=1e-6)
                        for a, b in zip(on["params"], off["params"]))),
            "sync": off["sync"].tolist()}
    return out


def socket_worker(job):
    """One rank of the phase-10 job: a ``ProcessCommSlave`` of the port
    for each of ``job["socket_jobs"]`` (one master each, in order), with
    (a) on every one and (b), (c), (e) on the full one. The audit plane
    is off, as in bench.py's socket legs (its default digest mode hashes
    every map entry: ~2 s a call of configs[2]). Writes its record to
    ``job["out"]``; returns 0, or raises."""
    from ytk_mp4j_tpu_torch.comm.process_comm import ProcessCommSlave
    from ytk_mp4j_tpu_torch.utils import native

    torch.set_num_threads(2)
    dev = torch.device(job["device"])
    rec = {"have_native": native.ensure_loaded()}
    for spec in job["socket_jobs"]:
        slave = ProcessCommSlave("127.0.0.1", spec["port"],
                                 timeout=PROCESS_DEADLINE_S,
                                 peer_timeout=PROCESS_DEADLINE_S / 2,
                                 shm=spec["shm"],
                                 native_transport=spec["native"],
                                 audit="off")
        try:
            res = {"rank": slave.rank}
            res["allreduce"], res["wire"] = socket_allreduce(slave)
            if spec["full"]:
                res["maps"] = socket_maps(slave)
                res["gbdt"] = socket_gbdt(slave, dev)
                res["fit_comm"] = socket_fit_comm(slave, dev)
        except BaseException:
            slave.close(1)
            raise
        slave.close(0)
        rec[spec["name"]] = res
    with open(job["out"], "w") as f:
        json.dump(rec, f)
    return 0


def on_threads(group, body):
    """``body(slave)`` on one thread per slave of a thread group; its
    results by rank."""
    import threading

    res = [None] * len(group)

    def run(s):
        res[s.rank] = body(s)

    ts = [threading.Thread(target=run, args=(s,)) for s in group]
    for th in ts:
        th.start()
    for th in ts:
        th.join(PROCESS_DEADLINE_S)
    check(all(r is not None for r in res), "a thread slave failed or hung")
    return res


def thread_group_allreduce(n):
    """(d) ``ThreadCommSlave.spawn_group(n)`` in this process on (a)'s
    payload: the digest of every thread's result, the largest relative
    error against the f64 sum, and seconds of each timed call."""
    from ytk_mp4j_tpu_torch.comm.thread_comm import ThreadCommSlave

    want = sum(socket_rank_array(q).astype(np.float64) for q in range(n))

    def body(s):
        secs = []
        for rep in range(1 + SOCKET_REPS):
            a = socket_rank_array(s.rank)
            s.barrier()
            t0 = time.perf_counter()
            s.allreduce_array(a, Operands.FLOAT, Operators.SUM)
            if rep:
                secs.append(time.perf_counter() - t0)
        return digest(a), float(np.max(np.abs(a - want) / want)), secs

    return on_threads(ThreadCommSlave.spawn_group(n), body)


def thread_group_edges(dev):
    """``fit_distributed``'s edges from ``ThreadCommSlave.spawn_group(4)``
    in this process on the four ranks' rows of (c)."""
    from ytk_mp4j_tpu_torch.comm.thread_comm import ThreadCommSlave

    X, _ = raw_rows(dev)
    per = ROWS // SOCKET_RANKS

    def body(s):
        b = QuantileBinner(n_bins=B, missing_bucket=False)
        b.fit_distributed(X[s.rank * per:(s.rank + 1) * per], s,
                          sample=RAW_FIT_SAMPLE, seed=0)
        return digest(b.edges)

    edges = on_threads(ThreadCommSlave.spawn_group(SOCKET_RANKS), body)
    del X
    torch.cuda.empty_cache()
    return edges


def median_rate(recs, job, algo, nbytes):
    """bench.py ``bench_socket_collective``'s GB/s a rank (bytes over
    the slowest rank's seconds), the median of the timed calls."""
    secs = [max(r[job]["allreduce"][algo]["secs"][k] for r in recs)
            for k in range(SOCKET_REPS)]
    return float(np.median([nbytes / s / 1e9 for s in secs]))


def run_socket_plane():
    """Phase 10: the port's ``Master`` here and SOCKET_RANKS worker
    processes of this script on cuda:0, over one job for each transport:
    TCP on the native data plane (a), (b), (c), (e); TCP framed (a); and
    shared memory (a) where /dev/shm is writable. Then (d) in this
    process, and the checks."""
    from ytk_mp4j_tpu_torch.comm.master import Master
    from ytk_mp4j_tpu_torch.utils import native

    t0 = time.perf_counter()
    check(native.ensure_loaded() and native.HAVE_NATIVE,
          "the native merge did not build: the socket plane would take "
          "the numpy path")
    specs = [dict(name="tcp", shm=False, native=True, full=True),
             dict(name="tcp_framed", shm=False, native=False, full=False)]
    shm_ok = os.access("/dev/shm", os.W_OK)
    if shm_ok:
        specs.append(dict(name="shm", shm=True, native=True, full=False))
    masters = []
    for spec in specs:
        m = Master(SOCKET_RANKS, timeout=PROCESS_DEADLINE_S)
        spec["port"] = m.port
        masters.append(m.serve_in_thread())
    recs, took = spawn_workers(SOCKET_RANKS, None, "socket4", 10,
                               socket_jobs=specs)
    for m in masters:
        m.join(60)
        check(m.final_code == 0, f"a socket master ended {m.final_code}")
    for rec in recs:
        check(rec["have_native"], "a rank's native merge did not build")
    names = [s["name"] for s in specs]
    by_rank = {name: sorted((r[name] for r in recs), key=lambda x:
                            x["rank"]) for name in names}
    # (a) every rank's bits equal, within rtol 1e-6 of the f64 sum, the
    # framed plane and shm equal to the native TCP plane, algo by algo
    out = {"transports": names, "s": None}
    for name in names:
        for algo in SOCKET_ALGOS:
            ds = {r["allreduce"][algo]["digest"] for r in by_rank[name]}
            check(len(ds) == 1, f"{name} {algo}: ranks' results differ")
            rel = max(r["allreduce"][algo]["max_rel"] for r in by_rank[name])
            check(rel <= 1e-6, f"{name} {algo}: rel err {rel} > 1e-6")
            ref = by_rank["tcp"][0]["allreduce"][algo]["digest"]
            check(ds == {ref}, f"{name} {algo} != the native TCP plane")
    wire = {name: [r["wire"] for r in by_rank[name]] for name in names}
    check(all(w["shm"] == 0 and w["tcp"] > 0 for w in wire["tcp"]),
          f"the TCP job moved bytes over shm: {wire['tcp']}")
    if shm_ok:
        check(all(w["shm"] > 0 for w in wire["shm"]),
              f"the shm job moved no bytes over shm: {wire['shm']}")
    nbytes = CONFIG0_LEN * 4
    rates = {name: {algo: median_rate(recs, name, algo, nbytes)
                    for algo in SOCKET_ALGOS} for name in names}
    out["allreduce_gbs"] = rates
    out["wire"] = wire
    print(f"socket plane (a) configs[0]: {SOCKET_RANKS} ProcessCommSlave "
          f"processes, 1M f32 SUM, transports {names} (/dev/shm "
          f"{'writable' if shm_ok else 'not writable'}); GB/s a rank "
          f"(median of {SOCKET_REPS}, slowest rank): "
          + "; ".join(f"{n}: " + ", ".join(f"{a} {v:.4f}" for a, v in
                                           rates[n].items())
                      for n in names)
          + "; every rank bitwise equal, within rtol 1e-6 of the f64 sum, "
          "the framed plane and shm bitwise the native TCP plane; "
          "native merge built on every rank", flush=True)

    # (b) configs[2]
    full = by_rank["tcp"]
    check(all(r["maps"]["equal"] for r in full),
          "allreduce_map != the host merge")
    msecs = [max(r["maps"]["secs"][k] for r in full)
             for k in range(MAP_REPS)]
    keys = full[0]["maps"]["keys"]
    map_rate_s = float(np.median([keys / s for s in msecs]))
    out["map_keys_s"] = map_rate_s
    out["map_call_ms"] = float(np.median(msecs)) * 1e3
    print(f"socket plane (b) configs[2]: allreduce_map of {MAP_KEYS} "
          f"string keys a rank, 50 % overlap (union {keys}): "
          f"{map_rate_s:.0f} merged keys/s (median of {MAP_REPS}, "
          f"{out['map_call_ms']:.2f} ms a call, slowest rank); every rank "
          "== the host merge", flush=True)

    # (c) GBDT over the socket plane
    g = [r["gbdt"] for r in full]
    check(len({x["edges"] for x in g}) == 1,
          "fit_distributed's edges differ across ranks")
    thread_edges = thread_group_edges(torch.device("cuda", 0))
    check(set(thread_edges) == {g[0]["edges"]},
          "fit_distributed over ProcessCommSlave != ThreadCommSlave's")
    for r, x in enumerate(g):
        check(not x["hist_misses"], f"rank {r}: {x['hist_misses']}")
        off, on = x["overlap0"], x["overlap1"]
        for mode in (off, on):
            check(mode["launches"] == DEPTH * TIMED_TREES,
                  f"rank {r}: {mode['launches']} histogram launches, want "
                  f"{DEPTH * TIMED_TREES}")
            check(mode["finite"] and mode["loss_down"],
                  f"rank {r}: margins not finite or the loss not lower")
        check(off["trees"] == on["trees"] and off["margins"] ==
              on["margins"] and off["history"] == on["history"],
              f"rank {r}: MP4J_OVERLAP=1 != 0")
        check(off["history"] == [{"trees": 1.0}] * TIMED_TREES,
              f"rank {r}: sync_round_history_ {off['history']}")
    gb = {}
    for flag in ("0", "1"):
        tree_s = [float(np.mean(x[f"overlap{flag}"]["tree_s"])) for x in g]
        gb[flag] = {
            "trees_per_s": 1 / max(tree_s),
            "exchange_ms": [max(x[f"overlap{flag}"]["exchange_ms"][k]
                                for x in g) for k in range(TIMED_TREES)],
            "drain_ms": max(sum(x[f"overlap{flag}"]["drain_ms"])
                            for x in g)}
    out["gbdt"] = gb
    out["gbdt_launches"] = [x["overlap0"]["launches"] for x in g]
    out["gbdt_max_abs_err"] = max(x["hist_max_abs_err"] for x in g)
    out["gbdt_warmup_s"] = max(x["warmup_s"] for x in g)
    print(f"socket plane (c) GBDT train_raw over {SOCKET_RANKS} ranks on "
          f"cuda:0, {ROWS // SOCKET_RANKS} x {F} raw f32 a rank: "
          f"fit_distributed's edges bitwise on every rank and "
          f"ThreadCommSlave's; warm-up (fit, transform, 1 tree) "
          f"{out['gbdt_warmup_s']:.2f} s; {TIMED_TREES} trees a mode, "
          f"trees/s a rank (slowest): overlap off "
          f"{gb['0']['trees_per_s']:.3f}, on {gb['1']['trees_per_s']:.3f};"
          f" each round's stats exchange, host ms (slowest rank): off "
          f"{[round(v, 3) for v in gb['0']['exchange_ms']]}, on "
          f"{[round(v, 3) for v in gb['1']['exchange_ms']]} + drain "
          f"{gb['1']['drain_ms']:.3f}; trees, margins and history bitwise "
          f"between the modes; launches {out['gbdt_launches']} a mode; "
          f"{g[0]['hist_levels_checked']} histogram calls a rank vs plain: "
          f"max abs err {out['gbdt_max_abs_err']:.3e}", flush=True)

    # (d) the thread plane in this process
    th = thread_group_allreduce(SOCKET_RANKS)
    check(len({d for d, _, _ in th}) == 1, "thread ranks differ")
    check(max(e for _, e, _ in th) <= 1e-6, "thread group rel err > 1e-6")
    check(th[0][0] == by_rank["tcp"][0]["allreduce"]["tree"]["digest"],
          "ThreadCommSlave group != the process plane's tree allreduce")
    tsecs = [max(x[2][k] for x in th) for k in range(SOCKET_REPS)]
    out["thread_gbs"] = float(np.median([nbytes / s / 1e9 for s in tsecs]))
    print(f"socket plane (d) ThreadCommSlave.spawn_group({SOCKET_RANKS}) "
          f"in one process: {out['thread_gbs']:.4f} GB/s a rank; bitwise "
          "the process plane's tree schedule (its fold order), within "
          "rtol 1e-6 of the f64 sum", flush=True)

    # (e) fit(comm=) on FM and linear
    for r in full:
        for name, v in r["fit_comm"].items():
            check(v["sync_is_mean"], f"{name}: sync_loss_history_ != mean")
            check(v["modes_agree"], f"{name}: overlap on != off (1e-5)")
    out["fit_comm"] = {n: v["sync"] for n, v in full[0]["fit_comm"].items()}
    print("socket plane (e) fit(comm=ProcessCommSlave) on FM and linear, "
          f"{SOCKET_RANKS} ranks: sync_loss_history_ == the ranks' mean, "
          "overlap on == off to rtol 1e-5", flush=True)
    out["s"] = time.perf_counter() - t0
    out["workers_s"] = took
    out["ranks"] = recs
    print(f"phase 10 (the socket plane): {out['s']:.1f} s", flush=True)
    return out



# -- phase 11: the serve plane (slice 10) -----------------------------------
SERVE_RANKS = 4                    # bench.py _serve_threads_job's procs
SERVE_TREES = 32                   # bench.py:1375's ensemble size
SERVE_GBDT_REQS = 1024
SERVE_FFM_REQS = 1024
SERVE_LINEAR_REQS = 256
SERVE_WINDOW = 64                  # bench_serve_latency_qps's in-flight
SERVE_DEADLINE_MS = 2.0
SERVE_MAX_BATCH = 32
SERVE_SEED = 1100
SPEEDUP_BAR = 1.5                  # bench.py:1526, the reference's bar


def serve_threads_job(servable, frontend_body, max_batch, cache_rows=0):
    """One serve job on threads (bench.py ``_serve_threads_job``'s shape):
    the port's ``Master`` and SERVE_RANKS ``ProcessCommSlave`` threads of
    this process; rank 0 builds the ``ServeFrontend`` and runs
    ``frontend_body(fe)``, every other rank answers rounds in
    ``serve_worker`` until the frontend's STOP. Every wait is bounded by
    phase 10's deadline, and a hung job fails the phase. Returns the
    frontend body's result and the workers' round counters."""
    import threading

    from ytk_mp4j_tpu_torch.comm.master import Master
    from ytk_mp4j_tpu_torch.comm.process_comm import ProcessCommSlave
    from ytk_mp4j_tpu_torch.serve import ServeFrontend, serve_worker

    master = Master(SERVE_RANKS, timeout=PROCESS_DEADLINE_S, elastic="off",
                    health=False, autoscale="off",
                    tuner="off").serve_in_thread()
    out, workers, errs = {}, {}, []

    def rank():
        try:
            slave = ProcessCommSlave(
                "127.0.0.1", master.port, timeout=PROCESS_DEADLINE_S,
                elastic="off", async_collectives=False, health=False,
                tuner="off", shm=False, audit="off", sink_dir="")
            if slave.rank == 0:
                fe = ServeFrontend(slave, servable,
                                   deadline_ms=SERVE_DEADLINE_MS,
                                   max_batch=max_batch,
                                   cache_rows=cache_rows)
                try:
                    out["result"] = frontend_body(fe)
                finally:
                    fe.close()
            else:
                workers[slave.rank] = serve_worker(slave, servable,
                                                   max_batch=max_batch)
            slave.close(0)
        except Exception as e:
            errs.append(repr(e))

    threads = [threading.Thread(target=rank, daemon=True)
               for _ in range(SERVE_RANKS)]
    for th in threads:
        th.start()
    end = time.monotonic() + PROCESS_DEADLINE_S
    for th in threads:
        th.join(max(0.1, end - time.monotonic()))
    master.join(60)
    check(not errs, f"serve job failed: {errs}")
    check(not any(th.is_alive() for th in threads) and "result" in out,
          "serve job hung")
    check(master.final_code == 0, f"serve master ended {master.final_code}")
    return out["result"], [workers[r] for r in sorted(workers)]


def serve_all(fe, reqs, window=None):
    """Submit ``reqs`` in order (at most ``window`` in flight: the open
    loop of bench_serve_latency_qps) and wait for every answer; returns
    the answers, the wall seconds and each request's enqueue-to-resolve
    seconds (the batcher's own latency hook)."""
    import collections

    lats = []
    orig = fe._batcher._on_latency
    fe._batcher._on_latency = lambda s: (lats.append(s), orig(s))
    window = window or len(reqs)
    got = []
    futs = collections.deque()
    t0 = time.perf_counter()
    for r in reqs:
        futs.append(fe.submit(r))
        if len(futs) >= window:
            got.append(futs.popleft().wait(PROCESS_DEADLINE_S))
    while futs:
        got.append(futs.popleft().wait(PROCESS_DEADLINE_S))
    return got, time.perf_counter() - t0, lats


def bitwise_answers(got, want, what):
    check(len(got) == len(want), f"{what}: {len(got)} answers for "
          f"{len(want)} requests")
    for k, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and np.array_equal(g, w),
              f"{what}: answer {k} {g} != the sequential oracle's {w}")


def serve_checked(servable, reqs, want, what):
    """The requests through a serve job (SERVE_WINDOW in flight,
    max_batch SERVE_MAX_BATCH, cache off): the answers bitwise the
    sequential oracle ``want``, every worker answered at least one round.
    Returns (wall seconds, each request's latency, worker rounds)."""
    (got, wall, lats), workers = serve_threads_job(
        servable, lambda fe: serve_all(fe, reqs, SERVE_WINDOW),
        SERVE_MAX_BATCH)
    bitwise_answers(got, want, what)
    rounds = [w["rounds"] for w in workers]
    check(min(rounds) >= 1, f"{what}: a worker answered no round: {rounds}")
    return wall, lats, rounds


def run_serve_gbdt(dev):
    """(a) GBDT over the reduce plane: SERVE_TREES headline trees trained
    on the card on phase 3's rows (the histogram kernel in every level),
    served for SERVE_GBDT_REQS of those rows."""
    dbins, dy = device_data(dev)
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH,
                     n_trees=SERVE_TREES, loss="squared")
    trainer = GBDTTrainer(cfg)
    t0 = time.perf_counter()
    trees, margins = trainer.train(dbins, dy)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rows = torch.from_numpy(np.random.default_rng(SERVE_SEED).choice(
        ROWS, SERVE_GBDT_REQS, replace=False)).to(dev)
    req_bins = dbins[rows]
    want_dev = trainer.predict(req_bins, trees).double().cpu().numpy()
    check(torch.equal(margins[rows], trainer.predict(req_bins, trees)),
          "predict != the training margins on the served rows")
    x_linear = (dbins[rows[:SERVE_LINEAR_REQS]].float() / B).cpu().numpy()
    del dbins, dy, margins
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    servable = gbdt.servable(trees, cfg)
    host_s = time.perf_counter() - t0
    np_servable = gbdt.servable(
        [tuple(a.cpu().numpy() for a in tree) for tree in trees], cfg)
    bins = req_bins.cpu().numpy().astype(np.int64)
    reqs = list(bins)
    single = np.concatenate(
        servable.link(servable.partial_margins(bins, 0, 1)))
    check(np.array_equal(servable.partial_margins(bins, 0, 1),
                         np_servable.partial_margins(bins, 0, 1)),
          "a servable of card tensors != one of the same arrays in numpy")
    err = float(np.max(np.abs(single - want_dev)))
    check(np.allclose(single, want_dev, rtol=1e-5, atol=1e-5),
          f"GBDT servable != GBDTTrainer.predict on the card ({err})")
    # the plane's sequential oracle: one request a round (max_batch 1);
    # each rank sums its own trees and the reduce adds the ranks' partials,
    # so an answer is the single-rank sum regrouped by rank (f64)
    (seq, seq_wall, _), _ = serve_threads_job(
        servable, lambda fe: serve_all(fe, reqs, 1), 1)
    seq_all = np.concatenate(seq)
    regroup = float(np.max(np.abs(seq_all - single)))
    n_bitwise = int(np.sum(seq_all == single))
    check(np.allclose(seq_all, single, rtol=1e-12, atol=1e-12),
          f"GBDT serve != the single-rank oracle beyond f64 regrouping "
          f"({regroup})")
    wall, _, rounds = serve_checked(servable, reqs, seq, "GBDT serve")
    print(f"serve plane (a) GBDT reduce plane: {SERVE_TREES} trees of "
          f"depth {DEPTH} at {F} x {B}, trained on the card in "
          f"{train_s:.2f} s on {ROWS} rows; host copy {host_s * 1e3:.1f} "
          f"ms; {SERVE_GBDT_REQS} requests over {SERVE_RANKS} ranks "
          f"(max_batch {SERVE_MAX_BATCH}, deadline {SERVE_DEADLINE_MS} ms, "
          f"{SERVE_WINDOW} in flight) in {wall:.3f} s "
          f"({SERVE_GBDT_REQS / wall:.1f} QPS), bitwise the same requests "
          f"served one a round ({seq_wall:.3f} s); against the single-rank "
          f"oracle {n_bitwise} of {len(seq)} bitwise, max abs err "
          f"{regroup:.3e} (rtol 1e-12, atol 1e-12: the f64 sum regrouped "
          f"by rank); single-rank oracle vs GBDTTrainer.predict on the card "
          f"max abs err {err:.3e} (rtol 1e-5, atol 1e-5; f64 against f32 "
          f"sums); worker rounds {rounds}", flush=True)
    return {"train_s": train_s, "host_copy_s": host_s, "wall_s": wall,
            "qps": SERVE_GBDT_REQS / wall, "sequential_wall_s": seq_wall,
            "max_abs_err_vs_predict": err,
            "max_abs_err_vs_single_rank": regroup,
            "bitwise_vs_single_rank": n_bitwise,
            "worker_rounds": rounds}, x_linear


def touched_rowmap(servable, reqs):
    """The sequential oracle's rows: only the ids the requests touch."""
    ids = np.unique(np.concatenate([servable.row_ids(r) for r in reqs]))
    mat = servable.rows(ids)
    return {int(i): mat[j] for j, i in enumerate(ids)}, ids.shape[0]


def run_serve_ffm(dev, params, smi):
    """(b) FFM at Criteo width over the pull plane: phase 7's sparse-path
    parameters, SERVE_FFM_REQS rows of ``criteo_data``; then the figures
    of bench.py ``bench_serve_latency_qps`` on that traffic."""
    cfg = FMConfig(**CRITEO)
    t0 = time.perf_counter()
    servable = fm_mod.servable(params, cfg)
    host_s = time.perf_counter() - t0
    feats, fields, vals, _ = criteo_data(cfg, dev)
    n = SERVE_FFM_REQS
    want_dev = FMTrainer(cfg, mesh=make_mesh(MEMBERS),
                         sparse_grads=True).predict(
        params, feats[:n], fields[:n], vals[:n]).double().cpu().numpy()
    f_h = feats[:n].cpu().numpy().astype(np.int64)
    fl_h = fields[:n].cpu().numpy()
    v_h = vals[:n].cpu().numpy()
    reqs = [(f_h[i], fl_h[i], v_h[i]) for i in range(n)]
    del feats, fields, vals
    rowmap, touched = touched_rowmap(servable, reqs)
    t0 = time.perf_counter()
    want = servable.predict_sharded(reqs, rowmap)
    oracle_s = time.perf_counter() - t0
    oracle = np.concatenate(want)
    err = float(np.max(np.abs(oracle - want_dev)))
    check(np.allclose(oracle, want_dev, rtol=1e-5, atol=0),
          f"FFM servable != FMTrainer.predict on the card ({err})")
    # the batched leg of bench_serve_latency_qps is this job
    wall_b, lats, rounds = serve_checked(servable, reqs, want, "FFM serve")
    print(f"serve plane (b) FFM pull plane at Criteo width ({cfg.n_features}"
          f" x {cfg.n_fields} fields, k {cfg.k}): host copy of the table "
          f"{host_s:.2f} s; {n} requests touching {touched} rows; answers "
          f"bitwise the sequential oracle ({oracle_s:.2f} s single-thread "
          f"scoring); servable vs FMTrainer.predict on the card max abs err "
          f"{err:.3e} (rtol 1e-5); worker rounds {rounds}", flush=True)

    # the rest of bench_serve_latency_qps on this traffic: one pull round
    # a request (max_batch 1, cache off), then a warm replay
    (one, wall_u, _), _ = serve_threads_job(
        servable, lambda fe: serve_all(fe, reqs, SERVE_WINDOW), 1)
    bitwise_answers(one, want, "FFM serve, max_batch 1")

    def warm(fe):
        serve_all(fe, reqs)
        cold = fe.cache_stats()
        again, wall, _ = serve_all(fe, reqs)
        return again, wall, cold, fe.cache_stats()

    (again, wall_w, cold, hot), _ = serve_threads_job(
        servable, warm, SERVE_MAX_BATCH, cache_rows=touched)
    bitwise_answers(again, want, "FFM serve, warm cache")
    check(len(lats) == n, f"{len(lats)} latencies for {n} requests")
    lat = sorted(lats)
    d = {k: hot[k] - cold[k] for k in ("hits", "misses")}
    fig = {
        "serve_batched_qps": n / wall_b,
        "serve_unbatched_qps": n / wall_u,
        "serve_speedup": wall_u / wall_b,
        "serve_p50_ms": lat[len(lat) // 2] * 1e3,
        "serve_p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
        "serve_warm_qps": n / wall_w,
        "serve_warm_hit_rate": d["hits"] / max(1, d["hits"] + d["misses"]),
        "serve_cold_hit_rate": cold["hit_rate"],
        "reqs": n, "procs": SERVE_RANKS, "touched_rows": touched}
    print(f"serve plane (b) bench_serve_latency_qps on this traffic, "
          f"{smi} ({SERVE_WINDOW} in flight, deadline {SERVE_DEADLINE_MS} ms, "
          f"cache off; max_batch {SERVE_MAX_BATCH} vs 1; warm replay with "
          f"the cache sized to the {touched} touched rows): "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                      f"{k} {v}" for k, v in fig.items())
          + f" (the reference's bar on serve_speedup: {SPEEDUP_BAR}, not "
          "checked here)", flush=True)
    return dict(fig, host_copy_s=host_s, oracle_s=oracle_s,
                max_abs_err_vs_predict=err, worker_rounds=rounds)


def run_serve_linear(dev, params, x):
    """(c) Linear over the pull plane: phase 7's parameters,
    SERVE_LINEAR_REQS of (a)'s rows as floats (bins / B, phase 7's
    features)."""
    from ytk_mp4j_tpu_torch.models import linear as linear_mod

    cfg = LinearConfig(**LINEAR_CFG)
    servable = linear_mod.servable(params, cfg)
    ids = np.arange(F, dtype=np.int64)
    zeros = np.zeros(F, np.int32)
    reqs = [(ids, zeros, x[i]) for i in range(x.shape[0])]
    rowmap, _ = touched_rowmap(servable, reqs)
    want = servable.predict_sharded(reqs, rowmap)
    want_dev = LinearTrainer(cfg, mesh=make_mesh(MEMBERS)).predict(
        params, torch.from_numpy(x).to(dev)).double().cpu().numpy()
    err = float(np.max(np.abs(np.concatenate(want) - want_dev)))
    check(np.allclose(np.concatenate(want), want_dev, rtol=1e-5, atol=0),
          f"linear servable != LinearTrainer.predict on the card ({err})")
    wall, _, rounds = serve_checked(servable, reqs, want, "linear serve")
    print(f"serve plane (c) linear pull plane: {len(reqs)} requests of "
          f"{F} features in {wall:.3f} s; answers bitwise the sequential "
          f"oracle; vs LinearTrainer.predict on the card max abs err "
          f"{err:.3e} (rtol 1e-5); worker rounds {rounds}", flush=True)
    return {"wall_s": wall, "max_abs_err_vs_predict": err,
            "worker_rounds": rounds}


def run_serve_plane(dev, ffm_params, linear_params, smi):
    """Phase 11, with every launch count set to 0 just before and read
    just after: the histogram kernel runs in every level of (a)'s
    training, and nothing else of the serve plane touches a kernel."""
    t0 = time.perf_counter()
    zero_counts()
    out = {}
    out["gbdt"], x_linear = run_serve_gbdt(dev)
    out["ffm"] = run_serve_ffm(dev, ffm_params, smi)
    out["linear"] = run_serve_linear(dev, linear_params, x_linear)
    counts = read_counts()
    out["launches"] = counts
    check(counts["hist_kernel"] == DEPTH * SERVE_TREES,
          f"{counts['hist_kernel']} histogram launches in phase 11, want "
          f"{DEPTH * SERVE_TREES}")
    out["s"] = time.perf_counter() - t0
    print(f"phase 11 (the serve plane): {out['s']:.1f} s; launches "
          f"{counts}", flush=True)
    return out


# -- phase 12: the device check suites (slice 10) ---------------------------
def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured (the suites print
    their whole artifact as one line); returns (result, output)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue()


def run_check_suites():
    """Phase 12: ``checkgpu`` on cuda:0 (8 members, the CPU section at 8,
    the ring kernels launched on the card) and ``checkaot`` (every source
    compiled for sm_90a), with the launch counts set to 0 just before
    checkgpu and read just after."""
    from ytk_mp4j_tpu_torch.check import checkaot, checkgpu

    t0 = time.perf_counter()
    gpath = os.path.join(OUT_DIR, "checkgpu.json")
    zero_counts()
    rc, _ = quiet(checkgpu.main, ["--n", "8", "--cpu-mesh-n", "8",
                                  "--out", gpath])
    counts = read_counts()
    with open(gpath) as f:
        g = json.load(f)
    hw = g.get("ring_kernel_hw", {})
    check(rc == 0 and g["ok"], f"checkgpu returned {rc}: failures "
          f"{g['failures']}, cpu {g['cpu_mesh'].get('failures')}, hw "
          f"{ {k: v['failures'] for k, v in hw.items()} }, error "
          f"{g['error']}")
    check(set(hw) == {"n8", "n1"}, f"ring hardware sections {sorted(hw)}")
    for name in RING_COUNTERS:
        check(counts[name] >= 1, f"checkgpu launched no {name}")
    g_s = time.perf_counter() - t0
    print(f"checkgpu on {g['device_kind']}, {g['n_members']} members: "
          f"{g['passed']} passed on the card, "
          f"{g['cpu_mesh']['passed']} on the CPU (8 members), ring "
          f"hardware {hw['n8']['passed']} (n=8, cluster path) + "
          f"{hw['n1']['passed']} (n=1), 0 failures; launches {counts}; "
          f"{g_s:.1f} s", flush=True)
    t1 = time.perf_counter()
    apath = os.path.join(OUT_DIR, "checkaot.json")
    rc, _ = quiet(checkaot.main, ["--out", apath])
    with open(apath) as f:
        a = json.load(f)
    check(rc == 0 and a["ok"] and sorted(a["programs"]) == _build.sources(),
          f"checkaot returned {rc}: "
          f"{ {k: v.get('error', '')[-300:] for k, v in a['programs'].items()} }")
    for src, rec in a["programs"].items():
        check(rec["kernels"], f"{src}.cu: ptxas reported no kernel")
        by = {}
        for k in rec["kernels"].values():
            by.setdefault(k["kernel"], []).append(k)
        for name, ks in sorted(by.items()):
            regs = [k["registers"] for k in ks]
            smem = [k["smem_bytes"] for k in ks]
            print(f"checkaot {src}.cu {name}: {len(ks)} instantiation(s), "
                  f"registers {min(regs)}-{max(regs)}, smem "
                  f"{min(smem)}-{max(smem)} B, spill stores "
                  f"{max(k['spill_stores'] for k in ks)} B, spill loads "
                  f"{max(k['spill_loads'] for k in ks)} B (max)", flush=True)
    a_s = time.perf_counter() - t1
    print(f"checkaot: {len(a['programs'])} sources compiled for sm_90a "
          f"({a['nvcc_version']}) in {a_s:.1f} s", flush=True)
    s = time.perf_counter() - t0
    print(f"phase 12 (the check suites): {s:.1f} s", flush=True)
    return {"checkgpu": {k: g[k] for k in ("passed", "n_members",
                                           "device_kind")},
            "checkgpu_cpu_passed": g["cpu_mesh"]["passed"],
            "checkgpu_hw_passed": {k: v["passed"] for k, v in hw.items()},
            "launches": counts, "checkgpu_s": g_s,
            "checkaot": {src: rec["kernels"] for src, rec in
                         a["programs"].items()}, "checkaot_s": a_s, "s": s}


# ----------------------------------------------------------------------
# slice 11: the examples and the traces on the card
# ----------------------------------------------------------------------
EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples", "torch")
EXAMPLE_MEMBERS = 8                # the reference's 8-device rig
HOST_EXAMPLES = ("03", "04")       # socket / thread planes: no --n
EXAMPLE_KERNELS = {"01": ("ring_kernel",), "05": ("hist_kernel",),
                   "07": ("hist_kernel",),
                   "08": ("ring_kernel", "ring_kernel_bidir"),
                   "11": ("hist_kernel",)}
TRACE_MEMBERS = 4
TRACE_ROWS = [("GpuCommCluster.allreduce_array", TRACE_MEMBERS * 4096),
              ("GpuCommCluster.broadcast_array", TRACE_MEMBERS * 4096)]
TRACE_DIST_ROWS = [("DistributedComm.allreduce_array", 4096)]


def run_example(path):
    """One mirror in this process, as ``python path --device cuda`` would
    run it, between the launch counts. Returns (seconds, counts, its
    standard output)."""
    key = os.path.basename(path)[:2]
    argv = [path, "--device", "cuda"]
    if key not in HOST_EXAMPLES:
        argv += ["--n", str(EXAMPLE_MEMBERS)]
    saved, sys.argv = sys.argv, argv
    buf = io.StringIO()
    try:
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        counts = read_counts()
    finally:
        sys.argv = saved
    return took, counts, buf.getvalue()


def run_examples_and_traces():
    """Phase 13: every mirror of ``examples/torch`` on the card (its own
    asserts, the launches its path must make), then the trace rows of
    ``GpuCommCluster`` on the card."""
    t0 = time.perf_counter()
    paths = sorted(os.path.join(EXAMPLES_DIR, f)
                   for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py"))
    check(len(paths) == 11, f"{len(paths)} example mirrors, want 11")
    recs, log = {}, []
    for path in paths:
        name = os.path.basename(path)
        took, counts, out = run_example(path)
        for kernel in EXAMPLE_KERNELS.get(name[:2], ()):
            check(counts[kernel] >= 1, f"{name} launched no {kernel}")
        launches = {k: counts[k] for k in COUNTERS}
        recs[name] = {"s": took, "launches": counts}
        log.append(f"==== {name} ({took:.3f} s, launches {launches})\n"
                   + out)
        print(f"example {name}: {took:.3f} s, launches {launches}",
              flush=True)
    with open(os.path.join(OUT_DIR, "examples.log"), "w") as f:
        f.write("\n".join(log))

    cl = GpuCommCluster(TRACE_MEMBERS, "cuda")
    arrs = [np.full(1024, r + 1, np.float32) for r in range(TRACE_MEMBERS)]
    zero_counts()
    with collective_trace.trace_collectives():
        cl.allreduce_array(arrs, Operands.FLOAT, Operators.SUM, algo="rdma")
        cl.broadcast_array(arrs, Operands.FLOAT, root=0)
    counts = read_counts()
    events = collective_trace.events()
    rows = [(name, nb) for name, _s, nb in events]
    check(rows == TRACE_ROWS, f"trace rows on the card {rows}, want "
          f"{TRACE_ROWS}")
    want = sum(range(1, TRACE_MEMBERS + 1))
    check(all((a == want).all() for a in arrs), "traced allreduce wrong")
    check(counts["ring_kernel"] >= 1, "the traced allreduce launched no "
          "ring_kernel")
    print(f"traces on the card: {rows}, host ms "
          f"{[round(sec * 1e3, 3) for _n, sec, _b in events]}", flush=True)
    s = time.perf_counter() - t0
    print(f"phase 13 (the examples and the traces): {s:.1f} s", flush=True)
    return {"examples": recs, "trace_rows": rows, "s": s}


# ----------------------------------------------------------------------
# slice 12: members on a device list
# ----------------------------------------------------------------------
LIST_RING_MEMBERS = 8              # configs[1]'s members
NVLINK_BYTES_PER_S = 450e9         # H100 NVLink to one peer, each way
MEMBER_ERR = {"ring_kernel": 0.0, "ring_kernel_bidir": 0.0}
MARK_CYCLES = 1000                 # the marker kernel between profiled calls
SWEEP_MEMBERS = (4, 8)             # the one-shot threshold's sweep
SWEEP_LENGTHS = tuple(1 << k for k in (12, 14, 16, 18, 20, 21, 22, 23,
                                        24))    # f32 elements a member
PER_SM = (1, 2, 4)                 # blocks an SM tried for the member plan
SWEEP_REPS = 20


def list_devices(n, cards=1):
    """n member devices, member r on ``cuda:{r % cards}``."""
    return [f"cuda:{r % cards}" for r in range(n)]


def member_held(name, got, packed, plain, what):
    """A list result against the packed launch's rows (bitwise) and the
    plain version's (bitwise; the difference goes into MEMBER_ERR)."""
    check(isinstance(got, list) and len(got) == packed.shape[0],
          f"{what}: not a member list")
    for r, t in enumerate(got):
        check(same(t, packed[r].to(t.device)),
              f"{what}: member {r} != the packed launch")
        b = plain[r].to(t.device)
        MEMBER_ERR[name] = max(MEMBER_ERR[name],
                               max_abs_diff(t[None], b[None]))
        check(same(t, b), f"{what}: member {r} != plain")


def device_span_ms(fn, counter, reps=TIMING_REPS, match="ring_"):
    """Device time of one list call, from ``torch.profiler`` over ``reps``
    calls after one warm-up: (the mean span from the call's first
    kernel's start to its last one's end, the mean sum of its kernels'
    times, its launches). A call's kernels are those whose name holds
    ``match``, as many as ``counter.last_plan`` launches. Marker kernels
    (``torch.cuda._sleep``: ATen's ``spin_kernel``) on the current stream
    between the calls tell them apart: a call's launches all start after
    the marker before it (they wait on its cards' ready events) and end
    before the marker after it (the current stream waits on every
    launch), whichever stream or card they ran on. Only calls whose
    every kernel the profiler recorded count (CUPTI now and then drops a
    few); at least half of them must."""
    fn()
    torch.cuda.synchronize()
    launches = counter.last_plan.launches
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(MARK_CYCLES)
                fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        marks, kern = [], []
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "spin_kernel" in e.name:
                marks.append(e.time_range.start)
            elif match in e.name:
                kern.append((e.time_range.start, e.time_range.end))
        marks.sort()
        calls = [[] for _ in marks[1:]]
        for start, end in kern:
            k = bisect.bisect(marks, start) - 1
            if 0 <= k < len(calls):
                calls[k].append((start, end))
        whole = [c for c in calls if len(c) == launches]
        if 2 * len(whole) >= reps:
            break
    check(2 * len(whole) >= reps,
          f"the profiler saw {len(whole)} whole calls of {launches} "
          f"kernels in {reps} ({len(kern)} kernels, {len(marks)} markers)")
    spans = [max(e for _, e in c) - min(s for s, _ in c) for c in whole]
    sums = [sum(e - s for s, e in c) for c in whole]
    return (sum(spans) / len(whole) / 1e3, sum(sums) / len(whole) / 1e3,
            launches)


def call_ms(fn, reps=SWEEP_REPS):
    """Mean ms of ``reps`` back-to-back calls by CUDA events on the
    current stream, after one warm-up: nothing synchronizes between the
    calls, so this is the device's time or the host's, whichever is the
    longer -- what a caller that issues calls one after another pays."""
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


def nvlink_bound_ms(mode, n, length, dt, ndir):
    """Least time across distinct cards: the bytes a member sends its
    neighbour, each way of a link at the NVLink rate (the links run side
    by side; two directions halve each way's bytes)."""
    s = torch.empty((), dtype=dt).element_size()
    steps = 2 * (n - 1) if mode == "allreduce" else n - 1
    chunk = length if mode == "allgather" else length / n
    return steps * chunk * s / ndir / NVLINK_BYTES_PER_S * 1e3


def member_row(name, mode, n, length, dt, ndir, kernel, packed, plain,
               library, cards=1, nccl=None, measured=None):
    """One list call timed: the member launches' span and sum, their ms
    by CUDA events around back-to-back calls (host included), the
    packed launch's, the plain version's (the list's, ``plain``, copies
    included: an allgather's plain version is nothing else) and the
    library's device ms, and the bound (HBM bytes; across cards also
    NVLink bytes). ``measured``: phase 6's row of the same call on the
    same shapes, whose packed (cluster path) and library ms this run
    already took; else they are measured here."""
    span, total, launches = device_span_ms(kernel, COUNTERS[name])
    lp = COUNTERS[name].last_plan
    if measured is None:
        measured = dict(ms=device_ms(packed, match="ring_"),
                        library_ms=device_ms(library))
    row = dict(call=name, mode=mode, n=n, length=length, dtype=str(dt),
               cards=cards, launches=launches, rounds=lp.rounds,
               cols=list(lp.cols), ms=span, member_sum_ms=total,
               event_ms=call_ms(kernel, TIMING_REPS),
               packed_ms=measured["ms"],
               plain_ms=device_ms(plain, copies=True),
               library_ms=measured["library_ms"],
               bound_ms=ring_bound_ms(mode, n, length, dt), bound_by="bytes")
    if cards > 1:
        row["nvlink_bound_ms"] = nvlink_bound_ms(mode, n, length, dt, ndir)
        row["bound_ms"] = max(row["bound_ms"], row["nvlink_bound_ms"])
        if nccl is not None:
            row["nccl_ms"] = device_ms(nccl)
    torch.cuda.empty_cache()
    print(f"{row['call']} ({cards} card(s)): member path, {launches} "
          f"launches ({n} members x {lp.rounds} round(s), columns "
          f"{row['cols']} a job), span {span:.4f} ms (members' kernels "
          f"summed {total:.4f} ms; CUDA events around back-to-back calls "
          f"{row['event_ms']:.4f} ms), packed launch "
          f"{row['packed_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms"
          + (f" (NVLink {row['nvlink_bound_ms']:.4f} ms, NCCL "
             f"{row.get('nccl_ms', float('nan')):.4f} ms)" if cards > 1
             else " (HBM bytes: one card moves no NVLink byte)"),
          flush=True)
    return row


def per_sm_spans(name, kernel, knob):
    """The span of one list call with ``ring_kernel.<knob>`` (the member
    plan's ``FOLD_BLOCKS_PER_SM`` or ``COPY_BLOCKS_PER_SM``) set to each
    of PER_SM, restored after: the measurement behind the constant."""
    real = getattr(rk, knob)
    spans = {}
    try:
        for v in PER_SM:
            setattr(rk, knob, v)
            rk.member_plan.cache_clear()
            spans[v] = device_span_ms(kernel, COUNTERS[name])[0]
    finally:
        setattr(rk, knob, real)
        rk.member_plan.cache_clear()
    print(f"{knob} (now {real}): span by blocks an SM "
          + ", ".join(f"{v}: {ms:.4f} ms" for v, ms in spans.items()),
          flush=True)
    return spans


def phase_member_checks(dev):
    """The member kernel against its plain version (the list's) and the
    packed launch, BITWISE (NaN as NaN), over phase 5's grid: both
    directions, allreduce in one launch a member and in two, reduce-
    scatter and allgather, every operator and dtype, n in RING_MEMBERS;
    every call made twice with no synchronize between the two."""
    gen = torch.Generator(device=dev).manual_seed(21)
    ops = (Operators.SUM, Operators.PROD, Operators.MAX, Operators.MIN)
    cases = 0
    t0 = time.perf_counter()

    def twice(name, call, packed, plain, what):
        first, again = call(), call()
        member_held(name, first, packed, plain, what)
        member_held(name, again, packed, plain, what + " (again)")

    for dt in RING_DTYPES:
        c = 2 * rk.granule(dt, dev) * 3     # RS/AG chunk: both halves odd
        for n in RING_MEMBERS:
            forms = ("one_shot", "two_round") if n > 1 else ("one_shot",)
            for bidir in (False, True):
                name = "ring_kernel_bidir" if bidir else "ring_kernel"
                for op in ops:
                    x = ring_data((n, 1001 + 2 * n), dt, gen, dev)
                    if dt.is_floating_point and op.name in ("MAX", "MIN"):
                        x[0, 3] = x[n - 1, 700] = float("nan")
                    xs = [t.clone() for t in x]
                    packed = rk.ring_allreduce_kernel(x, op, bidir,
                                                      force_kernel=True)
                    plain = rk.ring_allreduce_reference(xs, op, bidir,
                                                        force_kernel=True)
                    for form in forms:
                        twice(name, lambda: rk.ring_allreduce_kernel(
                            xs, op, bidir, force_kernel=True, path=form),
                            packed, plain,
                            f"member allreduce {form} {dt} n={n} {op.name}")
                        cases += 1
                    x = ring_data((n, n * c), dt, gen, dev)
                    xs = [t.clone() for t in x]
                    twice(name, lambda: rk.ring_reduce_scatter_kernel(
                        xs, op, bidir, force_kernel=True),
                        rk.ring_reduce_scatter_kernel(x, op, bidir,
                                                      force_kernel=True),
                        rk.ring_reduce_scatter_reference(
                            xs, op, bidir, force_kernel=True),
                        f"member reduce_scatter {dt} n={n} {op.name}")
                    cases += 1
                x = ring_data((n, c), dt, gen, dev)
                xs = [t.clone() for t in x]
                twice(name, lambda: rk.ring_allgather_kernel(
                    xs, bidir, force_kernel=True),
                    rk.ring_allgather_kernel(x, bidir, force_kernel=True),
                    rk.ring_allgather_reference(xs, bidir,
                                                force_kernel=True),
                    f"member allgather {dt} n={n}")
                cases += 1
    torch.cuda.synchronize()
    print(f"member ring kernel == plain == packed, bitwise, in {cases} "
          f"cases, each made twice ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return cases


def member_threshold_sweep(dev):
    """The measurement behind ``ring_kernel.ONE_SHOT_BYTES``: allreduces
    of n f32 members on cuda:0 (n in SWEEP_MEMBERS, lengths
    SWEEP_LENGTHS), one launch a member (every member folds every chunk)
    against two (fold the owned chunk, then copy the others), each
    ``call_ms`` in turns (one, two, two, one), the two forms' results
    held bitwise. Returns the rows and, per n, the largest inputs' bytes
    at which one launch was not slower than two."""
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = []
    crossover = {}
    for n in SWEEP_MEMBERS:
        crossover[n] = 0
        for length in SWEEP_LENGTHS:
            xs = list(torch.randn((n, length), generator=gen, device=dev))
            one = lambda: rk.ring_allreduce_kernel(xs, path="one_shot")
            two = lambda: rk.ring_allreduce_kernel(xs, path="two_round")
            a, b = one(), two()
            check(all(same(p, q) for p, q in zip(a, b)),
                  f"one launch != two launches at n={n}, L={length}")
            del a, b
            times = {"one_shot": [], "two_round": []}
            for form, fn in (("one_shot", one), ("two_round", two),
                             ("two_round", two), ("one_shot", one)):
                times[form].append(call_ms(fn))
            row = dict(n=n, length=length, input_bytes=n * length * 4,
                       one_shot_ms=sum(times["one_shot"]) / 2,
                       two_round_ms=sum(times["two_round"]) / 2)
            rows.append(row)
            if row["one_shot_ms"] <= row["two_round_ms"]:
                crossover[n] = row["input_bytes"]
            print(f"threshold sweep n={n} L={length} ({row['input_bytes']} "
                  f"B of inputs): one launch a member "
                  f"{row['one_shot_ms']:.4f} ms, two "
                  f"{row['two_round_ms']:.4f} ms", flush=True)
            del xs
            torch.cuda.empty_cache()
    print(f"one-shot threshold: one launch a member was not slower up to "
          f"{crossover} B of inputs (by n); ring_kernel.ONE_SHOT_BYTES = "
          f"{rk.ONE_SHOT_BYTES}", flush=True)
    return {"rows": rows, "one_shot_not_slower_up_to": crossover,
            "one_shot_bytes": rk.ONE_SHOT_BYTES}


def trees_bitwise(a, b, what):
    for ta, tb in zip(a, b):
        for k in range(4):
            check(torch.equal(ta[k], tb[k].to(ta[k].device)),
                  f"{what}: tree component {k} differs")


def run_device_list(ring_record, slice6):
    """Phase 14: the list form on one card (see the module docstring).
    ``ring_record``: phase 6's, whose rows give the packed, plain and
    library ms of the same calls (measured here without it); ``slice6``:
    phase 7's record, whose packed FFM and linear losses the list
    trainers are held against."""
    from ytk_mp4j_tpu_torch.check import checkgpu
    from ytk_mp4j_tpu_torch.exceptions import Mp4jError

    t0 = time.perf_counter()
    done = {"start": t0}

    def part(name):
        done[name] = time.perf_counter()

    def phase6(name, k):
        return ring_record["calls"][name][k]

    dev = torch.device("cuda", 0)
    dbins, dy = device_data(dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    rng = np.random.default_rng(14)
    host = [rng.standard_normal(CONFIG0_LEN).astype(np.float32)
            for _ in range(MEMBERS)]
    hist = torch.randn((MEMBERS, HIST_PAYLOAD), generator=gen, device=dev)
    big = torch.randn((LIST_RING_MEMBERS, CONFIG1_LEN), generator=gen,
                      device=dev, dtype=torch.float64)
    devs4 = list_devices(MEMBERS)
    devs8 = list_devices(LIST_RING_MEMBERS)
    cluster = GpuCommCluster(mesh=make_mesh(MEMBERS, devices=devs4))
    packed_cluster = GpuCommCluster(MEMBERS)
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    listed = GBDTTrainer(cfg, mesh=make_mesh(MEMBERS, devices=devs4))
    listed.train(dbins, dy, n_trees=1)                # warm-up tree
    cluster.allreduce_array([a.copy() for a in host], Operands.FLOAT,
                            Operators.SUM, algo="rdma")
    torch.cuda.synchronize()

    # ---- the main path, driven once between the counts ----------------
    zero_counts()
    trees, margins, tree_s, host_s = train_timed(listed, dbins, dy)
    arrs = [a.copy() for a in host]
    cluster.allreduce_array(arrs, Operands.FLOAT, Operators.SUM, algo="rdma")
    hist_out = rk.ring_allreduce_kernel(list(hist), bidirectional=True)
    scattered = rk.ring_reduce_scatter_kernel(list(big))
    gathered = rk.ring_allgather_kernel(scattered)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"device list ({MEMBERS} and {LIST_RING_MEMBERS} entries of "
          f"cuda:0): GBDT {TIMED_TREES} trees {1 / tree_s:.3f} trees/s "
          f"(host clock {host_s:.3f} s), launches by path {counts}",
          flush=True)
    # configs[0] and the histogram payload divide into equal chunks, so
    # their rows need no padding: the plan's rounds follow from L
    one_way = (MEMBERS * rk.allreduce_rounds(MEMBERS, CONFIG0_LEN,
                                             torch.float32)
               + 2 * LIST_RING_MEMBERS)
    two_way = MEMBERS * rk.allreduce_rounds(MEMBERS, HIST_PAYLOAD,
                                            torch.float32)
    want = {"hist_kernel": DEPTH * TIMED_TREES * MEMBERS,
            "leaf_sums": TIMED_TREES * MEMBERS, "ring_kernel": one_way,
            "ring_kernel.member": one_way,
            "ring_kernel_bidir": two_way,
            "ring_kernel_bidir.member": two_way}
    for k, v in want.items():
        check(counts[k] == v, f"device list: {k} launched {counts[k]} "
              f"times, want {v}")
    for k in ("ring_kernel.cluster", "ring_kernel.global",
              "ring_kernel_bidir.cluster", "ring_kernel_bidir.global"):
        check(counts[k] == 0, f"device list: {k} launched {counts[k]}")

    # ---- GBDT: bitwise the packed mesh, trees/s in turns -----------------
    packed = GBDTTrainer(cfg, mesh=make_mesh(MEMBERS))
    pt, pm = packed.train(dbins, dy, n_trees=TIMED_TREES)
    trees_bitwise(trees, pt, "GBDT list vs packed")
    check(torch.equal(margins, pm), "GBDT list margins != packed margins")
    check(torch.equal(listed.predict(dbins, trees), margins),
          "GBDT list: predict != the training margins")
    mse0 = float(dy.double().pow(2).mean())
    mse = float((margins - dy).double().pow(2).mean())
    check(bool(torch.isfinite(margins).all()) and mse < mse0,
          f"GBDT list: margins not finite or no lower loss ({mse}, {mse0})")
    print(f"GBDT list == packed make_mesh({MEMBERS}): trees and margins "
          f"bitwise; predict == margins; mse {mse0:.5f} -> {mse:.5f}",
          flush=True)
    part("gbdt")
    turns = in_turns(packed, listed, dbins, dy,
                     names=(f"packed make_mesh({MEMBERS})",
                            f"list of {MEMBERS} x cuda:0"))
    part("turns")
    # the list's folds go through the list form of ops.collectives
    profile = profile_tree(
        listed, dbins, dy, "tree_trace_list.json",
        parts={"fold": (coll, "allreduce"),
               "leaf sums": (gbdt, "_segment_sum2")})
    part("profile")
    del dbins, dy, packed, listed

    # ---- the ring calls: plain, packed launch, times -------------------
    stacked = to_tensor(np.stack(host), dev)
    packed_arrs = [a.copy() for a in host]
    packed_cluster.allreduce_array(packed_arrs, Operands.FLOAT,
                                   Operators.SUM, algo="rdma")
    plain = rk.ring_allreduce_reference(stacked)
    for r in range(MEMBERS):
        check(np.array_equal(arrs[r], packed_arrs[r]),
              f"configs[0] list rank {r} != the packed cluster")
    xs = list(stacked)
    member_held("ring_kernel",
                [torch.from_numpy(a).to(dev) for a in arrs],
                rk.ring_allreduce_kernel(stacked),
                rk.ring_allreduce_reference(xs), "configs[0]")
    check(all(same(p, q) for p, q in zip(rk.ring_allreduce_reference(xs),
                                         plain)),
          "configs[0]: the member plain version != the ring's")
    rows = {"ring_kernel": [], "ring_kernel_bidir": []}
    rows["ring_kernel"].append(member_row(
        "ring_kernel", "allreduce", MEMBERS, CONFIG0_LEN, torch.float32, 1,
        lambda: rk.ring_allreduce_kernel(xs),
        lambda: rk.ring_allreduce_kernel(stacked),
        lambda: rk.ring_allreduce_reference(xs),
        replicated_sum(stacked), measured=phase6("ring_kernel", 0)))
    rows["ring_kernel"][-1]["call"] = "configs[0] allreduce 4 x 1M f32"
    hs = list(hist)
    member_held("ring_kernel_bidir", hist_out,
                rk.ring_allreduce_kernel(hist, bidirectional=True),
                rk.ring_allreduce_reference(hs, bidirectional=True),
                "histogram payload")
    rows["ring_kernel_bidir"].append(member_row(
        "ring_kernel_bidir", "allreduce", MEMBERS, HIST_PAYLOAD,
        torch.float32, 2,
        lambda: rk.ring_allreduce_kernel(hs, bidirectional=True),
        lambda: rk.ring_allreduce_kernel(hist, bidirectional=True),
        lambda: rk.ring_allreduce_reference(hs, bidirectional=True),
        replicated_sum(hist), measured=phase6("ring_kernel_bidir", 0)))
    rows["ring_kernel_bidir"][-1]["call"] = (
        "histogram payload allreduce 4 x 2x16x28x256 f32 bidir")
    packed_rs = rk.ring_reduce_scatter_kernel(big)
    bs = list(big)
    member_held("ring_kernel", scattered, packed_rs,
                rk.ring_reduce_scatter_reference(bs),
                "configs[1] reduce-scatter")
    torch.cuda.empty_cache()
    rows["ring_kernel"].append(member_row(
        "ring_kernel", "reduce_scatter", LIST_RING_MEMBERS, CONFIG1_LEN,
        torch.float64, 1, lambda: rk.ring_reduce_scatter_kernel(bs),
        lambda: rk.ring_reduce_scatter_kernel(big),
        lambda: rk.ring_reduce_scatter_reference(bs),
        lambda: big.sum(0).view(LIST_RING_MEMBERS, -1),
        measured=phase6("ring_kernel", 1)))
    rows["ring_kernel"][-1]["call"] = "configs[1] reduce-scatter 8 x 256M f64"
    rows["ring_kernel"][-1]["span_by_blocks_per_sm"] = per_sm_spans(
        "ring_kernel", lambda: rk.ring_reduce_scatter_kernel(bs),
        "FOLD_BLOCKS_PER_SM")
    del big, bs
    torch.cuda.empty_cache()
    packed_ag = rk.ring_allgather_kernel(packed_rs)
    member_held("ring_kernel", gathered, packed_ag,
                rk.ring_allgather_reference(scattered),
                "configs[1] allgather")
    del gathered, packed_ag
    torch.cuda.empty_cache()
    c = packed_rs.shape[1]
    rows["ring_kernel"].append(member_row(
        "ring_kernel", "allgather", LIST_RING_MEMBERS, c, torch.float64, 1,
        lambda: rk.ring_allgather_kernel(scattered),
        lambda: rk.ring_allgather_kernel(packed_rs),
        lambda: rk.ring_allgather_reference(scattered),
        lambda: packed_rs.reshape(-1).expand(LIST_RING_MEMBERS,
                                             -1).contiguous(),
        measured=phase6("ring_kernel", 2)))
    rows["ring_kernel"][-1]["call"] = "configs[1] allgather 8 x 32M f64"
    rows["ring_kernel"][-1]["span_by_blocks_per_sm"] = per_sm_spans(
        "ring_kernel", lambda: rk.ring_allgather_kernel(scattered),
        "COPY_BLOCKS_PER_SM")
    del scattered, packed_rs
    torch.cuda.empty_cache()
    part("rings")

    # ---- the member kernel over phase 5's grid; the refusal; the sweep ---
    member_cases = phase_member_checks(dev)
    try:
        rk.ring_allreduce_kernel(xs, spin_s=0.5)
        refused = None
    except Mp4jError as e:
        refused = str(e)
    check(refused is not None and "spin_s and stall_member" in refused,
          f"a list call with spin_s: {refused!r}")
    print(f"a list call with spin_s=0.5 is refused: {refused}", flush=True)
    part("member checks")
    sweep = member_threshold_sweep(dev)
    part("threshold sweep")

    # ---- checkgpu over the list ------------------------------------------
    gpath = os.path.join(OUT_DIR, "checkgpu_list.json")
    rc, _ = quiet(checkgpu.main, ["--devices", ",".join(devs8),
                                  "--cpu-mesh-n", "8", "--out", gpath])
    with open(gpath) as f:
        g = json.load(f)
    hw = g.get("ring_kernel_hw", {})
    check(rc == 0 and g["ok"] and g["passed"] == 618
          and g["cpu_mesh"]["passed"] == 618,
          f"checkgpu over the list returned {rc}: {g.get('failures')}, "
          f"cpu {g.get('cpu_mesh', {}).get('failures')}, error "
          f"{g.get('error')}")
    print(f"checkgpu --devices cuda:0 x {LIST_RING_MEMBERS}: {g['passed']} "
          f"passed on the card's list, {g['cpu_mesh']['passed']} on a CPU "
          f"list, ring hardware {hw['n8']['passed']} (n=8, a launch a "
          f"member) + {hw['n1']['passed']} (n=1); every part over the "
          "list", flush=True)
    check("packed_parts" not in g, "checkgpu ran a part packed")
    part("checkgpu")

    trainers = run_list_trainers(devs4, slice6)
    part("trainers")

    cards = torch.cuda.device_count()
    distinct = (run_distinct_cards(min(MEMBERS, cards), slice6)
                if cards >= 2 else None)
    if distinct is None:
        print("distinct cards: not run (1 card visible)", flush=True)

    s = time.perf_counter() - t0
    marks = sorted(done.items(), key=lambda kv: kv[1])
    split = ", ".join(f"{b[0]} {b[1] - a[1]:.1f} s"
                      for a, b in zip(marks, marks[1:]))
    print(f"phase 14 (members on a device list): {s:.1f} s ({split})",
          flush=True)
    replaces = {"ring_kernel": ":244", "ring_kernel_bidir": ":382"}
    entries = []
    for name, rs in rows.items():
        total = {k: sum(r[k] for r in rs)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "packed_ms", "member_sum_ms")}
        entries.append({
            "name": f"{name}.member", "route": "cuda",
            "source": "ytk_mp4j_tpu_torch/ops/csrc/ring_member.cu",
            "replaces": "ytk_mp4j_tpu/ops/ring_kernel.py" + replaces[name],
            "path": "member", "launches": counts[f"{name}.member"],
            "max_abs_err": MEMBER_ERR[name], "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "bytes", "library_ms": total["library_ms"],
            "packed_ms": total["packed_ms"],
            "member_sum_ms": total["member_sum_ms"]})
    return entries, {"counts": counts, "trees_per_s": 1 / tree_s,
                     "host_s": host_s, "turns": turns,
                     "tree_profile": profile, "calls": rows,
                     "member_cases": member_cases, "threshold_sweep": sweep,
                     "checkgpu_passed": g["passed"],
                     "checkgpu_cpu_passed": g["cpu_mesh"]["passed"],
                     "trainers": trainers, "distinct_cards": distinct,
                     "s": s}


def run_distinct_cards(k, slice6):
    """Phase 14 over ``k`` distinct cards (peer memory, NVLink): configs[0]
    and the histogram payload through the member launches held against
    the plain version and the packed launch on cuda:0, with the NVLink
    bound and ``torch.cuda.nccl.all_reduce``; GBDT over the k cards,
    bitwise the packed mesh on cuda:0; the list trainers over the 4
    members on the k cards, held against ``slice6`` (phase 7's record)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    devs = list_devices(k, k)
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"cards": k, "devices": devs}
    for name, length, ndir in (("ring_kernel", CONFIG0_LEN, 1),
                               ("ring_kernel_bidir", HIST_PAYLOAD, 2)):
        x = torch.randn((k, length), generator=gen, device=dev)
        xs = [x[r].to(d) for r, d in enumerate(devs)]
        got = rk.ring_allreduce_kernel(xs, bidirectional=ndir == 2)
        member_held(name, got, rk.ring_allreduce_kernel(
            x, bidirectional=ndir == 2), rk.ring_allreduce_reference(
            x, bidirectional=ndir == 2), f"{name} over {k} cards")
        ys = [t.clone() for t in xs]
        out[name] = member_row(
            name, "allreduce", k, length, torch.float32, ndir,
            lambda: rk.ring_allreduce_kernel(xs, bidirectional=ndir == 2),
            lambda: rk.ring_allreduce_kernel(x, bidirectional=ndir == 2),
            lambda: rk.ring_allreduce_reference(x,
                                                bidirectional=ndir == 2),
            replicated_sum(x), cards=k,
            nccl=lambda: torch.cuda.nccl.all_reduce(ys))
    dbins, dy = device_data(dev)
    cfg = GBDTConfig(n_features=F, n_bins=B, depth=DEPTH, loss="squared")
    listed = GBDTTrainer(cfg, mesh=make_mesh(
        MEMBERS, devices=list_devices(MEMBERS, k)))
    listed.train(dbins, dy, n_trees=1)                # warm-up tree
    trees, margins, tree_s, _ = train_timed(listed, dbins, dy)
    pt, pm = GBDTTrainer(cfg, mesh=make_mesh(MEMBERS)).train(
        dbins, dy, n_trees=TIMED_TREES)
    trees_bitwise(trees, pt, f"GBDT over {k} cards vs packed")
    check(torch.equal(margins, pm), f"GBDT over {k} cards: margins differ")
    out["gbdt_trees_per_s"] = 1 / tree_s
    del dbins, dy, listed, trees, margins, pt, pm
    torch.cuda.empty_cache()
    out["trainers"] = run_list_trainers(list_devices(MEMBERS, k), slice6)
    out["s"] = time.perf_counter() - t0
    print(f"distinct cards ({k}): GBDT {1 / tree_s:.3f} trees/s, bitwise "
          f"the packed mesh; {out['s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------------
# slice 13: the trainers, the map family and the dry run over a list
# ----------------------------------------------------------------------
# GBDT depths of entry.dryrun's three trainers (the tree, the missing /
# categorical tree, train_raw's tree): one histogram launch a member a
# level
DRYRUN_DEPTHS = (3, 2, 2)
LIST_TURNS = 2                     # pairs of packed / list step timings
LIST_FM_PARTS = {"grads": (fm_mod, "_grad_sums"),
                 "fold": (coll, "allreduce"),
                 "gather": (coll, "allgather"),
                 "all_to_all": (coll, "all_to_all"),
                 "sort": (sparse_ops, "sort_by_key"),
                 "segment": (sparse_ops, "segment_reduce_sorted"),
                 "masked add": (fm_mod, "_add_rows")}
SCORED_ROWS = 1024                 # the sharded list's predict, checked


def run_list_dryrun(devs):
    """``entry.dryrun(n, devices=devs)`` with every launch count set to 0
    just before and read just after: one histogram launch a member a
    level of its three trees, and the ring kernel a member at a time
    (the ``algo="rdma"`` allreduce)."""
    n = len(devs)
    zero_counts()
    t0 = time.perf_counter()
    entry.dryrun(n, devices=devs)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    counts = read_counts()
    ring = n * rk.allreduce_rounds(n, 16, torch.float32)  # 16-float arrays
    want = {"hist_kernel": n * sum(DRYRUN_DEPTHS),
            "leaf_sums": n * len(DRYRUN_DEPTHS), "ring_kernel": ring,
            "ring_kernel.member": ring, "ring_kernel_bidir": 0}
    for k, v in want.items():
        check(counts[k] == v, f"dryrun over {devs}: {k} launched "
              f"{counts[k]} times, want {v}")
    print(f"entry.dryrun({n}, devices={devs}): passed in {s:.2f} s; "
          f"launches {counts}", flush=True)
    return {"s": s, "counts": counts}


def list_step_turns(trainers, data, p0, name, profile):
    """ms a step of the packed and the list trainer (``{form: trainer}``)
    timed in LIST_TURNS pairs, the order alternating (packed, list, list,
    packed, ...), each a warm-up step and FM_TIMED_STEPS timed ones
    (``steps_ms``); then, with ``profile``, the list's step once more
    under ``torch.profiler``: device ms by part and by kernel, idle
    share."""
    runs = {}
    for form, tr in trainers.items():
        batch = tr.shard_data(*data)
        per = int(batch[0][0].shape[0])
        runs[form] = (tr._step(per * tr.cfg.max_nnz), batch)
    times = {form: [] for form in trainers}
    for p in range(LIST_TURNS):
        order = list(trainers) if p % 2 == 0 else list(trainers)[::-1]
        for form in order:
            step, batch = runs[form]
            q = trainers[form]._place_params(p0)
            times[form].append(steps_ms(step, q, batch, FM_TIMED_STEPS))
            del q
            torch.cuda.empty_cache()
    rec = {f"{form}_ms": float(np.median(v)) for form, v in times.items()}
    rec["turns_ms"] = times
    step, batch = runs["list"]
    q = trainers["list"]._place_params(p0)
    by_name, parts, busy, window = profile_run(lambda: step(q, batch),
                                               LIST_FM_PARTS, profile)
    total = sum(by_name.values())
    rec["profile"] = {"device_ms": total, "window_ms": window,
                      "idle_share": 1 - busy / window, "parts_ms": parts,
                      "rest_ms": total - sum(parts.values()),
                      "by_name_ms": by_name}
    print(f"FFM {name} over the list: {rec['list_ms']:.3f} ms a step "
          f"against packed {rec['packed_ms']:.3f} (medians of "
          f"{LIST_TURNS} in turns: list {times['list']}, packed "
          f"{times['packed']}); profiled step: device {total:.3f} ms of a "
          f"{window:.3f} ms window (idle {1 - busy / window:.1%}); "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items() if v)
          + f", rest {rec['profile']['rest_ms']:.3f} ms; by kernel: "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      list(by_name.items())[:6]), flush=True)
    return rec


def run_list_ffm(devs, ffm_rec):
    """FFM at Criteo width (phase 7's config, data and initial table) over
    ``make_mesh(4, devices=devs)`` on the dense, sparse and sharded
    paths: ``fit`` of FM_FIT_STEPS steps against phase 7's packed losses
    at rtol 1e-5, every member's replica the same bits, the sharded
    table's ``full_table`` against the packed one at rtol 1e-5 and its
    ``predict`` against a local scorer on the whole table; ms a step in
    turns with the packed ``make_mesh(4)``; the profiled step."""
    dev = torch.device("cuda", 0)
    cfg = FMConfig(**CRITEO)
    data = criteo_data(cfg, dev)
    lmesh = make_mesh(MEMBERS, devices=devs)
    pmesh = make_mesh(MEMBERS)
    p0 = FMTrainer(cfg, mesh=pmesh).init_params(seed=0)
    rec = {}
    for name, kw in FM_PATHS.items():
        torch.cuda.reset_peak_memory_stats()
        tr = FMTrainer(cfg, mesh=lmesh, **kw)
        params, losses = tr.fit(*data, n_steps=FM_FIT_STEPS, params=p0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = np.asarray(ffm_rec[name]["losses"])
        err = float(np.max(np.abs(losses - want) / np.abs(want)))
        check(np.allclose(losses, want, rtol=1e-5, atol=1e-6),
              f"{name} FFM over the list {losses} != packed {want}")
        k = 2 if name == "sharded" else 3
        for m, (rep, d) in enumerate(zip(tr.replicas_, lmesh.devices)):
            check(all(a.device == d and torch.equal(a, b.to(d))
                      for a, b in zip(rep[:k], tr.replicas_[0][:k])),
                  f"{name} FFM over the list: member {m}'s replica differs")
        r = {"losses": losses.tolist(), "rel_err_vs_packed": err,
             "peak_gib": peak}
        if name == "sharded":
            pk = FMTrainer(cfg, mesh=pmesh, **kw)
            pp, _ = pk.fit(*data, n_steps=FM_FIT_STEPS, params=p0)
            lt, pt = tr.full_table(params), pk.full_table(pp)
            r["table_max_abs_vs_packed"] = float(np.max(np.abs(lt - pt)))
            check(np.allclose(lt, pt, rtol=1e-5, atol=1e-6),
                  "sharded FFM over the list: table != packed")
            del pk, pp, pt
            sub = tuple(a[:SCORED_ROWS] for a in data[:3])
            got = tr.predict(params, *sub)
            whole = (params[0], params[1],
                     torch.from_numpy(lt).to(params[0].device))
            local = fm_mod.predict(whole, *sub,
                                   (sub[2] != 0).to(torch.float32), cfg)
            check(torch.allclose(got, local, rtol=1e-5, atol=1e-6),
                  "sharded FFM over the list: predict != local scorer")
            r["predict_max_abs"] = float((got - local).abs().max())
            del lt, whole
        del tr, params
        torch.cuda.empty_cache()
        r.update(list_step_turns(
            {"packed": FMTrainer(cfg, mesh=pmesh, **kw),
             "list": FMTrainer(cfg, mesh=lmesh, **kw)}, data, p0, name,
            f"ffm_list_{name}_step_trace.json"))
        print(f"FFM {name} over the list of {len(devs)}: losses "
              f"{r['losses']} (largest relative difference from phase 7's "
              f"packed {err:.2e}); replicas bitwise; peak {peak:.2f} GiB",
              flush=True)
        rec[name] = r
        torch.cuda.empty_cache()
    del data, p0
    torch.cuda.empty_cache()
    return rec


def run_list_linear(devs, linear_rec):
    """Phase 7's linear run (the headline rows as floats, LINEAR_STEPS
    steps) over the list: losses against phase 7's at rtol 1e-5, every
    replica the same bits; ms a step from CUDA events around ``fit``, in
    turns with the packed mesh."""
    x, yl = linear_data(torch.device("cuda", 0))
    cfg = LinearConfig(**LINEAR_CFG)
    trainers = {"packed": LinearTrainer(cfg, mesh=make_mesh(MEMBERS)),
                "list": LinearTrainer(cfg, mesh=make_mesh(MEMBERS,
                                                          devices=devs))}
    for tr in trainers.values():
        tr.fit(x, yl, n_steps=1)                              # warm-up
    times = {form: [] for form in trainers}
    for p in range(LIST_TURNS):
        order = list(trainers) if p % 2 == 0 else list(trainers)[::-1]
        for form in order:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, losses = trainers[form].fit(x, yl, n_steps=LINEAR_STEPS)
            end.record()
            torch.cuda.synchronize()
            times[form].append(start.elapsed_time(end) / LINEAR_STEPS)
            if form == "list":
                list_losses = losses
    want = np.asarray(linear_rec["losses"])
    check(np.allclose(list_losses, want, rtol=1e-5, atol=1e-6),
          f"linear over the list {list_losses} != packed {want}")
    reps = trainers["list"].replicas_
    check(all(torch.equal(a, b) for rep in reps
              for a, b in zip(rep, reps[0])),
          "linear over the list: the replicas differ")
    rec = {"losses": list_losses.tolist(), "turns_ms": times,
           "list_ms": float(np.median(times["list"])),
           "packed_ms": float(np.median(times["packed"]))}
    print(f"linear over the list of {len(devs)}: {rec['list_ms']:.3f} ms a "
          f"step against packed {rec['packed_ms']:.3f} (in turns: list "
          f"{times['list']}, packed {times['packed']}); losses == phase "
          "7's (rtol 1e-5); replicas bitwise", flush=True)
    # one step of each under the profiler: device ms and idle share
    for form, tr in trainers.items():
        batch = tr.shard_data(x, yl)
        params, vel = tr._start(None)
        by_name, parts, busy, window = profile_run(
            lambda: tr._train_step(params, vel, batch),
            {"grads": (linear_mod, "_grad_sums"),
             "fold": (coll, "allreduce")},
            f"linear_{form}_step_trace.json")
        total = sum(by_name.values())
        rec[f"{form}_profile"] = {"device_ms": total, "window_ms": window,
                                  "idle_share": 1 - busy / window,
                                  "parts_ms": parts, "by_name_ms": by_name}
        print(f"linear {form} step profile: device {total:.3f} ms of a "
              f"{window:.3f} ms window (idle {1 - busy / window:.1%}); "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + "; by kernel: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in list(by_name.items())[:5]),
              flush=True)
    del x, yl, trainers
    torch.cuda.empty_cache()
    return rec


def run_list_maps(devs):
    """configs[2] over ``GpuCommCluster(mesh=<list mesh>)``: 20,000 string
    keys a member at 50 % overlap through ``allreduce_map`` and a chain of
    ``allreduce_map_async``, each equal to the host merge and to the
    packed cluster; merged keys/s in turns with the packed cluster."""
    lst = GpuCommCluster(mesh=make_mesh(MEMBERS, devices=devs))
    packed = GpuCommCluster(MEMBERS)
    maps = overlap_maps(MAP_KEYS, lambda c: f"w{c}")
    want = host_merge(maps)
    a, b = [dict(m) for m in maps], [dict(m) for m in maps]
    lst.allreduce_map(a, Operands.DOUBLE)
    packed.allreduce_map(b, Operands.DOUBLE)
    check(a == b, "configs[2] over the list != the packed cluster")
    rates = {"packed": [], "list": []}
    for p in range(LIST_TURNS):
        order = ("packed", "list") if p % 2 == 0 else ("list", "packed")
        for form in order:
            cl = lst if form == "list" else packed
            rates[form].append(map_rate(cl, maps, want, MAP_REPS)[0])
    work = [[dict(m) for m in maps] for _ in range(MAP_CHAIN)]
    t0 = time.perf_counter()
    handles = [lst.allreduce_map_async(w, Operands.DOUBLE) for w in work]
    for h in handles:
        h.result()
    chain_s = time.perf_counter() - t0
    check(all(m == want for w in work for m in w),
          "allreduce_map_async over the list != the host merge")
    rec = {"list_keys_s": float(np.median(rates["list"])),
           "packed_keys_s": float(np.median(rates["packed"])),
           "turns_keys_s": rates,
           "list_chained_keys_s": MAP_CHAIN * len(want) / chain_s}
    print(f"configs[2] over the list of {len(devs)} (host clock): "
          f"{rec['list_keys_s']:.0f} merged keys/s against packed "
          f"{rec['packed_keys_s']:.0f} (in turns {rates}), chained "
          f"{MAP_CHAIN} deep {rec['list_chained_keys_s']:.0f} keys/s; "
          "every result == the host merge and the packed cluster",
          flush=True)
    return rec


def run_list_trainers(devs, slice6):
    """Phase 14's list trainers (slice 13): the dry run between the
    counts, FFM on its three paths, linear, configs[2]."""
    t0 = time.perf_counter()
    rec = {"dryrun": run_list_dryrun(devs),
           "ffm_criteo": run_list_ffm(devs, slice6["ffm_criteo"]),
           "linear": run_list_linear(devs, slice6["linear"]),
           "maps": run_list_maps(devs)}
    rec["s"] = time.perf_counter() - t0
    print(f"list trainers over {devs}: {rec['s']:.1f} s", flush=True)
    return rec


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
    route_entry = run_route(dev, dbins, dp_record["route_launches"])
    del dbins, dy
    torch.cuda.empty_cache()
    hist_entry["bosch_width"] = run_bosch_width(dev)
    torch.cuda.empty_cache()
    entry_record = run_entry()
    ring_entries, ring_record = run_ring(dev)
    leaf = dp_record["leaf_sums"]
    leaf_entry = {
        "name": "leaf_sums", "route": "cuda",
        "source": "ytk_mp4j_tpu_torch/ops/csrc/leaf_sums.cu",
        "replaces": "none (ytk_mp4j_tpu/models/gbdt.py:332 is an MXU "
                    "product)",
        "launches": leaf["launches"], "max_rel_err": max(
            leaf["max_rel_err"], gbdt_record["leaf_sums"]["max_rel_err"]),
        "ms": leaf["ms"], "plain_ms": leaf["plain_ms"],
        "bound_ms": leaf["bound_ms"], "bound_by": "bytes",
        "library_ms": leaf["library_ms"],
        "one_member": gbdt_record["leaf_sums"],
    }
    kernels = [hist_entry, leaf_entry, route_entry] + ring_entries
    ffm_rec, ffm_params = run_ffm_criteo(dev)
    slice6 = {"ffm_criteo": ffm_rec, "ffm_config4": run_ffm_config4(dev),
              "maps": run_maps(dev)}
    slice6["linear"], linear_params = run_linear(dev)
    slice7 = run_multiprocess({
        "timed": dp_record["trees_per_s"],
        "turns": dp_record["turns"]["members_median"]})
    slice8 = run_fm_processes(slice6["ffm_criteo"], slice6["linear"])
    slice9 = run_socket_plane()
    slice10 = {"serve": run_serve_plane(dev, ffm_params, linear_params,
                                        smi)}
    del ffm_params, linear_params
    torch.cuda.empty_cache()
    slice10["checks"] = run_check_suites()
    slice11 = run_examples_and_traces()
    member_entries, slice12 = run_device_list(ring_record, slice6)
    kernels += member_entries
    hist_entry["device_list_launches"] = slice12["counts"]["hist_kernel"]
    dry = slice12["trainers"]["dryrun"]["counts"]
    hist_entry["dryrun_list_launches"] = dry["hist_kernel"]
    hist_entry["max_abs_err"] = max(hist_entry["max_abs_err"],
                                    slice7["nccl_world1"]["max_abs_err"],
                                    slice7["gloo"]["max_abs_err"],
                                    slice9["gbdt_max_abs_err"])
    hist_entry["process_path_launches"] = {
        "nccl_world1": [r["launches"] for r in slice7["nccl_world1"]["ranks"]],
        f"gloo{PROCESSES}": [r["launches"] for r in slice7["gloo"]["ranks"]],
        f"socket{SOCKET_RANKS}": slice9["gbdt_launches"]}
    leaf_entry["process_path_launches"] = {
        "nccl_world1": [r["leaf_sums_launches"]
                        for r in slice7["nccl_world1"]["ranks"]],
        f"gloo{PROCESSES}": [r["leaf_sums_launches"]
                             for r in slice7["gloo"]["ranks"]]}
    leaf_entry["device_list_launches"] = slice12["counts"]["leaf_sums"]
    leaf_entry["dryrun_list_launches"] = dry["leaf_sums"]
    hist_entry["serve_path_launches"] = slice10["serve"]["launches"][
        "hist_kernel"]
    for e in ring_entries:
        e["check_path_launches"] = slice10["checks"]["launches"][e["name"]]
        e["device_list_launches"] = slice12["counts"][e["name"]]
        e["dryrun_list_launches"] = dry[e["name"]]
    for e in [hist_entry] + ring_entries:
        e["example_path_launches"] = {
            name: rec["launches"][e["name"]]
            for name, rec in slice11["examples"].items()
            if rec["launches"][e["name"]]}

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi, "gbdt": gbdt_record,
                   "data_parallel": dp_record, "train_raw": raw_record,
                   "entry": entry_record, "ring": ring_record,
                   "slice6": slice6, "slice7": slice7, "slice8": slice8,
                   "slice9": slice9, "slice10": slice10,
                   "slice11": slice11, "slice12": slice12,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":
        job = json.loads(sys.argv[2])
        worker = {8: rank_worker, 9: process_fm_worker,
                  10: socket_worker}[job["phase"]]
        sys.exit(worker(job))
    sys.exit(main())
