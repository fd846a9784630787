"""Ring collectives as hand-written CUDA kernels: the port of
``ytk_mp4j_tpu/ops/ring_kernel.py`` (the Pallas RDMA ring kernels).

n ring members live on one card as the rows of a ``[n, L]`` tensor, and
one launch runs all of them, on one of two paths that
:func:`launch_plan` picks from n and the card, never from a failure:

- **cluster** (n <= 8, ``ops/csrc/ring_cluster.cu``): the members of a
  column are the blocks of one thread-block cluster and follow the
  reference's slot and credit protocol (``_direction:128``): receive
  slots live in the receiver's shared memory, sends are bulk
  asynchronous copies into it, credits are remote mbarrier arrives, so
  device memory carries only the input and the output;
- **global** (larger n, or a cluster size the card refuses;
  ``ops/csrc/ring_kernel.cu``): no ring of neighbours at all. All n rows
  lie in the card's memory, so each chunk is folded once, straight from
  the rows, over the members in exactly the order the ring's schedule
  folds it (:func:`fold_rotation`), and written to every row that
  receives it (:class:`GlobalPlan`); an allgather copies each member's
  part to every row. One plain launch, no block waits on another.

Members may also come as a list of n tensors, member r's on its own
device (``device.make_mesh(n, devices=...)``, the reference's one member
a device). Then each member is a launch of its own (``member`` path,
``ops/csrc/ring_member.cu``), on its card and on a stream of its own,
that reads the chunks it owes straight from every member's input (peer
memory between cards, enabled once a pair; a pair the hardware cannot
join raises) and folds each chunk over the members in exactly the order
the ring's schedule folds it (:func:`fold_order`, from :class:`RingPlan`).
CUDA events order the launches: each waits for every card's inputs, and
every card's current stream waits for every launch; no kernel waits on
another, so nothing spins and nothing needs to be co-resident. A
reduce-scatter or an allgather is one launch a member; an allreduce is
one launch a member that folds every chunk while the inputs together are
small (:data:`ONE_SHOT_BYTES`), else two: each member folds the chunk it
owns, then, behind every member's first launch, copies the others from
their owners (:func:`member_plan`). The result is a list the same way,
and it is bitwise the packed launch's on the stacked members. A
``ring_cluster.cu`` cluster cannot span launches or cards, so the list
form always takes this path.

Entry points, each on a ``[n, ...]`` tensor of members (or a list):

- :func:`ring_allreduce_kernel` -- reduce-scatter + allgather in one
  launch (2(n-1) steps); any length (padded with the operator's identity
  to equal chunks and sliced back); member r's row is the reduction.
- :func:`ring_reduce_scatter_kernel` -- n-1 steps; member r ends with
  chunk r of the reduction.
- :func:`ring_allgather_kernel` -- n-1 steps; every member ends with
  ``[n * c]``, member q's shard at block q.

``bidirectional=True`` rings two halves in opposite directions (the
buffer's halves for allreduce, each chunk's halves otherwise), as
``_ring_kernel_bidir:276`` does. ``force_kernel=True`` launches even at
n = 1 (zero steps).

Each entry has a plain PyTorch version with the same contract, step
schedule and fold order (:func:`ring_allreduce_reference` and its
siblings); all follow :class:`RingPlan`, the schedule in Python that
the CUDA sources mirror, and the cluster kernel follows
:data:`CLUSTER_PROTOCOL`, the slot/credit sequence of :func:`protocol`
(the tests run it under the reference's skew-adversarial scheduler). On
a CPU tensor the entries compute the plain version; on a CUDA tensor
they launch a kernel or raise, and nothing retries on another kernel.
Launches are counted on ``ring_kernel.launches`` (one direction) and
``ring_kernel_bidir.launches`` (two), and per path on their
``cluster_launches`` / ``global_launches`` / ``member_launches`` (every
launch of a member of a list).

Chunk granule (:func:`granule`), the one place it is defined: 1 element
on the CPU, as the reference's interpret mode, so the CPU version chunks
exactly as the reference's interpreted kernel; 16 bytes on CUDA, for
vector accesses and bulk copies (every chunk, column and segment
boundary is a multiple of it). Reduce-scatter and allgather chunks must
be multiples of it (twice it when bidirectional); allreduce pads to it.

Divergences from the reference, intended:

- a custom operator raises :class:`Mp4jError` naming ``algo="ring"``:
  the kernel cannot run a Python function;
- on the cluster path every wait is bounded (``spin_s``), and a stuck
  ring raises instead of hanging; the global path and a list have no
  wait to bound, so ``stall_member`` (the cluster path's test hook) is
  refused on both, and a list also refuses ``spin_s``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from dataclasses import dataclass

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.obs import spans
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.ops import _build

# dtype codes: must match kernel_for in ops/csrc/ring_cluster.cu,
# ops/csrc/ring_kernel.cu and ops/csrc/ring_member.cu
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                torch.int64: 3, torch.int16: 4, torch.int8: 5,
                torch.bfloat16: 6}
_MODE_CODES = {"allreduce": 0, "reduce_scatter": 1, "allgather": 2}
_VECTOR_BYTES = 16
SPIN_SECONDS = 30.0     # longest single wait before the launch fails
_WAITS = ("a receive slot", "a credit", "the final credits",
          "an input load")


def granule(dtype: torch.dtype, device) -> int:
    """Chunk granule in elements: 1 on the CPU, 16 bytes on CUDA."""
    if torch.device(device).type == "cpu":
        return 1
    return max(1, _VECTOR_BYTES // torch.empty((), dtype=dtype).element_size())


def round_up_chunk(n_elems: int, dtype: torch.dtype, device) -> int:
    """``n_elems`` (at least 1) rounded up to the granule."""
    g = granule(dtype, device)
    return -(-max(n_elems, 1) // g) * g


# ----------------------------------------------------------------------
# the schedule, shared by the plain version, the CUDA source and the tests
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class RingPlan:
    """Which chunk each member loads, merges and stores, per direction d
    (sign -1: send right; +1: send left) and step s. Indices are taken
    mod n; they work on ints and on tensors of member indices alike."""

    n: int
    mode: str                   # allreduce | reduce_scatter | allgather
    ndir: int = 1

    @staticmethod
    def sign(d: int) -> int:
        return -1 if d == 0 else 1

    @property
    def steps(self) -> int:
        """Exchanges per segment: n-1, or 2(n-1) for allreduce."""
        return (self.n - 1) * (2 if self.mode == "allreduce" else 1)

    def shift(self, d: int) -> int:
        """Reduce-scatter ends with chunk me in every direction."""
        return self.sign(d) if self.mode == "reduce_scatter" else 0

    def start(self, me, d):
        """Chunk a member sends first (its own block for allgather)."""
        return (me + self.shift(d)) % self.n

    def merge(self, me, d, s):
        """Local chunk folded into what arrived at reduce step s:
        ``acc = op(got, x[merge])``."""
        return (me + self.sign(d) * (s + 1) + self.shift(d)) % self.n

    def finish(self, me, d):
        """Allreduce: where the fully reduced chunk lands."""
        return (me - self.sign(d)) % self.n

    def forward(self, me, d, s):
        """Block the chunk that arrives at forwarding step s belongs to."""
        k = s if self.mode == "allreduce" else s + 1
        return (me + self.sign(d) * k) % self.n

    @staticmethod
    def dest(me, d, n):
        """The member a direction sends to (credits come back from it)."""
        return (me - RingPlan.sign(d)) % n

    @staticmethod
    def upstream(me, d, n):
        """The member a direction receives from (credits go to it)."""
        return (me + RingPlan.sign(d)) % n


def protocol(slots: int, ahead: int = 0) -> dict:
    """The cluster kernel's per-direction protocol at global step g with
    ``slots`` receive slots, as ops on flags that only grow within a
    launch: ("wait_*",
    slot, v) waits for flag >= v, "send" writes the neighbour's slot then
    stores its recv flag = v, "consume" reads our slot, "signal_credit"
    stores the upstream's credit = v. Every direction's begin runs before
    any finish; after the last step each direction waits ``drain(steps)``.

    A sender may reuse slot k once the receiver consumed the previous send
    into k. ``ahead``: begin(g) waits that credit for the slot of step
    g + ahead (the cluster kernel folds step g into the buffer step g + 1
    sends, so it waits one step ahead)."""

    def begin(g: int):
        h = g + ahead
        wait = ([("wait_credit", h % slots, h - slots + 1)]
                if h >= slots else [])
        return wait + [("send", g % slots, g + 1)]

    def finish(g: int):
        slot = g % slots
        return [("wait_recv", slot, g + 1), ("consume", slot),
                ("signal_credit", slot, g + 1)]

    def drain(steps: int):
        out = []
        for slot in range(min(slots, steps)):
            last = steps - 1 - (steps - 1 - slot) % slots
            out.append(("wait_credit", slot, last + 1))
        return out

    return {"begin": begin, "finish": finish, "drain": drain,
            "slots": slots}


CLUSTER_SLOTS = 2           # ring_cluster.cu kSlots
# the cluster kernel's (ops/csrc/ring_cluster.cu): mbarrier phases take the
# place of the step-number flags, one phase per use of a slot
CLUSTER_PROTOCOL = protocol(CLUSTER_SLOTS, ahead=1)


@dataclass(frozen=True)
class _Layout:
    """Where direction d's chunk i lies in a row (``base[d] + i * stride``,
    ``w`` elements), and its part of a reduce-scatter output or an
    allgather input row (``vbase[d]``)."""

    w: int
    stride: int
    base: tuple
    vbase: tuple
    in_row: int
    out_row: int


def _chunks(t, n, lay: _Layout, d):
    """[member, chunk, w] view of direction d's chunks in rows of t."""
    row = t.shape[1]
    return torch.as_strided(t, (n, n, lay.w), (row, lay.stride, 1),
                            t.storage_offset() + lay.base[d])


def _plain(xp, plan: RingPlan, lay: _Layout, operator: Operator):
    """The plain version: the plan on all members at once. A ring step
    is a roll along the member axis (member me receives what its
    upstream sent); every fold is ``op(got, local)``, as in the kernel."""
    n = plan.n
    out = torch.empty((n, lay.out_row), dtype=xp.dtype, device=xp.device)
    me = torch.arange(n, device=xp.device)
    for d in range(plan.ndir):
        back = -RingPlan.sign(d)             # roll: row me <- row upstream
        if plan.mode == "allgather":
            dst = _chunks(out, n, lay, d)
            v = xp[:, lay.vbase[d]:lay.vbase[d] + lay.w]
            dst[me, me] = v
            for s in range(n - 1):
                v = torch.roll(v, back, 0)
                dst[me, plan.forward(me, d, s)] = v
            continue
        src = _chunks(xp, n, lay, d)
        v = src[me, plan.start(me, d)]
        for s in range(n - 1):
            v = operator.torch_fn(torch.roll(v, back, 0),
                                  src[me, plan.merge(me, d, s)])
        if plan.mode == "reduce_scatter":
            out[:, lay.vbase[d]:lay.vbase[d] + lay.w] = v
            continue
        dst = _chunks(out, n, lay, d)
        dst[me, plan.finish(me, d)] = v
        for s in range(n - 1):
            v = torch.roll(v, back, 0)
            dst[me, plan.forward(me, d, s)] = v
    return out


# ----------------------------------------------------------------------
# the launch plan: which kernel, and how it cuts the chunks
# ----------------------------------------------------------------------
CLUSTER_LIMIT = 8           # portable cluster size: ring_cluster.cu kMaxCluster
CLUSTER_SEG_BYTES = 12288   # a slot over all directions: three 128-thread
                            # blocks share an SM (ring_cluster.cu takes up
                            # to 18 KiB, kMaxSegBytes)
PATHS = ("cluster", "global")
GLOBAL_THREADS = 256        # ring_kernel.cu kThreads
GLOBAL_MAX_MEMBERS = 2048   # ring_kernel.cu kMaxMembers: a block's row
                            # offsets in shared memory
# blocks an SM of the global kernel, by what it does (PERF.md:
# measured at 1, 2 and 4 on an H100; folds fastest at 4, the copy of
# configs[1]'s allgather at 1)
GLOBAL_FOLD_BLOCKS_PER_SM = 4
GLOBAL_COPY_BLOCKS_PER_SM = 1


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch of the cluster kernel (``ops/csrc/ring_cluster.cu``,
    ``path`` "cluster") covers each direction's chunk ``[0, w)``: ``cols``
    columns of ``col_w`` elements (the last ones may be short or empty),
    one thread-block cluster of n blocks each, walked in segments of
    ``seg`` elements, one slot in shared memory each. The kernel walks
    exactly :meth:`segments`."""

    path: str
    n: int
    ndir: int
    w: int
    itemsize: int
    cols: int
    col_w: int
    seg: int
    slots: int

    @property
    def slot_bytes(self) -> int:
        return self.seg * self.itemsize

    def columns(self):
        """``[lo, hi)`` of every launched column."""
        return [(min(c * self.col_w, self.w), min((c + 1) * self.col_w, self.w))
                for c in range(self.cols)]

    def segments(self, col: int):
        """``(start, length)`` of each segment of column ``col``."""
        lo, hi = self.columns()[col]
        return [(s, min(self.seg, hi - s)) for s in range(lo, hi, self.seg)]


@dataclass(frozen=True)
class GlobalPlan:
    """How one launch of the global kernel (``ops/csrc/ring_kernel.cu``)
    covers a call: ``jobs`` = ndir x n jobs (a reducing mode's job folds
    one chunk of one direction; an allgather's copies one member's part of
    one direction), each cut into ``cols`` columns of ``col_w`` elements
    (the last ones may be short or empty). The kernel's ``column`` cuts
    exactly :meth:`columns`, in 16-byte vectors."""

    path: str
    n: int
    ndir: int
    mode: str
    w: int
    itemsize: int
    jobs: int
    cols: int
    col_w: int

    def columns(self):
        """``[lo, hi)`` of every column of a job."""
        return [(min(c * self.col_w, self.w), min((c + 1) * self.col_w, self.w))
                for c in range(self.cols)]


def global_plan(n: int, mode: str, ndir: int, w: int, dtype: torch.dtype,
                sms: int) -> GlobalPlan:
    """The global kernel's grid for n members, chunks of ``w`` elements
    (a multiple of 16 bytes) and a card of ``sms`` SMs, sized by bytes as
    :func:`member_plan` sizes a member's: a column takes at least one
    16-byte vector a thread, and the launch at most
    ``GLOBAL_FOLD_BLOCKS_PER_SM`` (an allgather's copy:
    ``GLOBAL_COPY_BLOCKS_PER_SM``) ``* sms`` blocks, whatever n is."""
    item = dtype.itemsize
    vectors = w * item // _VECTOR_BYTES
    per_sm = (GLOBAL_COPY_BLOCKS_PER_SM if mode == "allgather"
              else GLOBAL_FOLD_BLOCKS_PER_SM)
    jobs = ndir * n
    cols = max(1, min(-(-max(1, per_sm * sms) // jobs),
                      -(-vectors // GLOBAL_THREADS)))
    per = -(-vectors // cols)                # vectors a column, as the kernel
    return GlobalPlan("global", n, ndir, mode, w, item, jobs, cols,
                      per * _VECTOR_BYTES // item)


def launch_plan(n: int, w: int, dtype: torch.dtype, ndir: int, device, *,
                clusters: int = 0, mode: str = "allreduce",
                sms: int = 0):
    """The plan for n members and chunks of ``w`` elements. ``clusters``:
    clusters of n blocks the card holds at once (0 where it refuses that
    size); ``sms``: the card's SMs. The cluster path
    (:class:`LaunchPlan`) takes n <= CLUSTER_LIMIT whenever the card holds
    such a cluster; the global path (:class:`GlobalPlan`) takes the rest.
    Every boundary is a multiple of the granule, so 16-byte aligned on
    CUDA."""
    if not (1 <= n <= CLUSTER_LIMIT and clusters > 0):
        return global_plan(n, mode, ndir, w, dtype, sms)
    item = torch.empty((), dtype=dtype).element_size()
    g = granule(dtype, device)

    def up(v):
        return -(-v // g) * g

    cols = max(1, min(clusters, -(-w // g)))
    col_w = up(-(-w // cols))
    per_col = -(-col_w // (CLUSTER_SEG_BYTES // ndir // item))
    seg = max(g, up(-(-col_w // per_col)))     # equal segments
    return LaunchPlan("cluster", n, ndir, w, item, cols, col_w, seg,
                      CLUSTER_SLOTS)


# ----------------------------------------------------------------------
# the CUDA launch
# ----------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("ring_kernel")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mp4j_ring_launch.argtypes = [i, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
                                     ll, ll, p, p, p, p]
    lib.mp4j_ring_launch.restype = i
    lib.mp4j_ring_max_members.argtypes = []
    lib.mp4j_ring_max_members.restype = i
    lib.mp4j_ring_threads.argtypes = []
    lib.mp4j_ring_threads.restype = i
    lib.mp4j_error_string.argtypes = [i]
    lib.mp4j_error_string.restype = ctypes.c_char_p
    if (lib.mp4j_ring_max_members(), lib.mp4j_ring_threads()) != (
            GLOBAL_MAX_MEMBERS, GLOBAL_THREADS):
        raise Mp4jError(
            f"ring_kernel.cu takes {lib.mp4j_ring_max_members()} members "
            f"in blocks of {lib.mp4j_ring_threads()} threads, the plan "
            f"assumes {GLOBAL_MAX_MEMBERS} and {GLOBAL_THREADS}")
    return lib


@functools.cache
def _cluster_library() -> ctypes.CDLL:
    lib = _build.load("ring_cluster")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mp4j_ring_cluster_max_clusters.argtypes = [i, i, i, i, i,
                                                   ctypes.POINTER(i)]
    lib.mp4j_ring_cluster_max_clusters.restype = i
    lib.mp4j_ring_cluster_launch.argtypes = [
        i, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll, p, p, p, ll,
        i, p]
    lib.mp4j_ring_cluster_launch.restype = i
    lib.mp4j_error_string.argtypes = [i]
    lib.mp4j_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _member_library() -> ctypes.CDLL:
    lib = _build.load("ring_member")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip, pp = ctypes.POINTER(i), ctypes.POINTER(p)
    lib.mp4j_ring_members_launch.argtypes = [
        i, i, i, i, i, i, ip, ip, ll, ll, ll, ll, ll, ll, ctypes.c_char_p,
        ip, pp, pp, pp, i, ip, pp, pp, pp, pp, p, ip]
    lib.mp4j_ring_members_launch.restype = i
    lib.mp4j_ring_member_events.argtypes = [i, pp]
    lib.mp4j_ring_member_events.restype = i
    lib.mp4j_ring_enable_peer.argtypes = [i]
    lib.mp4j_ring_enable_peer.restype = i
    lib.mp4j_ring_member_max.argtypes = []
    lib.mp4j_ring_member_max.restype = i
    lib.mp4j_error_string.argtypes = [i]
    lib.mp4j_error_string.restype = ctypes.c_char_p
    if lib.mp4j_ring_member_max() != MAX_MEMBERS:
        raise Mp4jError(f"ring_member.cu takes {lib.mp4j_ring_member_max()} "
                        f"members, the wrapper assumes {MAX_MEMBERS}")
    return lib


def _device_index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


@functools.cache
def _query_clusters(dtype_code: int, op_code: int, ndir: int, n: int,
                    index: int, slot_bytes: int) -> int:
    value = ctypes.c_int(0)
    lib = _cluster_library()
    with torch.cuda.device(index):
        rc = lib.mp4j_ring_cluster_max_clusters(
            dtype_code, op_code, ndir, n, slot_bytes, ctypes.byref(value))
    if rc:
        raise Mp4jError(f"ring kernel occupancy query (clusters) failed: "
                        f"{lib.mp4j_error_string(rc).decode()}")
    return value.value


def max_clusters(dtype: torch.dtype, operator: Operator, ndir: int, n: int,
                 device) -> int:
    """Clusters of n blocks of the cluster kernel resident at once on the
    card, 0 where the card refuses that size (queried once per dtype,
    operator, directions, n and card)."""
    if not 1 <= n <= CLUSTER_LIMIT:
        return 0
    return _query_clusters(_DTYPE_CODES[dtype], operator.kernel_code, ndir,
                           n, _device_index(device),
                           CLUSTER_SEG_BYTES // ndir)


def _plan_launch(xp, plan: RingPlan, lay: _Layout, operator: Operator,
                 path):
    n, ndir, dev = plan.n, plan.ndir, xp.device
    if path not in (None,) + PATHS:
        raise Mp4jError(f"ring kernel path must be one of {PATHS}, "
                        f"got {path!r}")
    clusters = 0
    if path != "global":
        clusters = max_clusters(xp.dtype, operator, ndir, n, dev)
        if path == "cluster" and not clusters:
            raise Mp4jError(f"ring kernel: the card takes no cluster of {n} "
                            "blocks for this kernel")
    if not clusters and n > GLOBAL_MAX_MEMBERS:
        raise Mp4jError(f"ring kernel: {n} members; the global path takes "
                        f"at most {GLOBAL_MAX_MEMBERS}")
    return launch_plan(n, lay.w, xp.dtype, ndir, dev, clusters=clusters,
                       mode=plan.mode, sms=_sm_count(_device_index(dev)))


@functools.cache
def _order_tensor(n: int, mode: str, ndir: int, index: int) -> torch.Tensor:
    """:func:`fold_rotation` as int32 on card ``index``, made once; its
    copy is complete before any stream can read it."""
    t = torch.tensor(fold_rotation(n, mode, ndir), dtype=torch.int32).to(
        torch.device("cuda", index))
    torch.cuda.current_stream(index).synchronize()
    return t


def _launch(xp, plan: RingPlan, lay: _Layout, operator: Operator, spin_s,
            stall_member, path):
    """One launch on xp's card, on the path :func:`launch_plan` picks
    (``path`` forces one, for tests and measurements). Returns (output,
    the cluster path's error word or None, plan). Vector and bulk copies
    need 16-byte-aligned addresses: an input whose data does not start on
    16 bytes (a view at an odd storage offset) is copied first."""
    lp = _plan_launch(xp, plan, lay, operator, path)
    if lp.path == "global" and stall_member != -1:
        raise Mp4jError(
            "ring kernel: stall_member stalls a member of the cluster "
            "path's ring; the global path's blocks never wait on each "
            "other, so a call on it takes no stall_member")
    dev = xp.device
    n, ndir = plan.n, plan.ndir
    if xp.data_ptr() % _VECTOR_BYTES:
        xp = xp.clone(memory_format=torch.contiguous_format)
    out = torch.empty((n, lay.out_row), dtype=xp.dtype, device=dev)
    base = tuple(lay.base) + (0,) * (2 - len(lay.base))
    vbase = tuple(lay.vbase) + (0,) * (2 - len(lay.vbase))
    layout = (lay.w, lay.stride, base[0], base[1], vbase[0], vbase[1])
    codes = (_DTYPE_CODES[xp.dtype], operator.kernel_code, ndir,
             _MODE_CODES[plan.mode], n, lp.cols)
    err = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lp.path == "cluster":
            lib = _cluster_library()
            err = torch.zeros(4, dtype=torch.int64, device=dev)
            rc = lib.mp4j_ring_cluster_launch(
                *codes, lp.seg, *layout, lp.col_w, lay.in_row, lay.out_row,
                xp.data_ptr(), out.data_ptr(), err.data_ptr(),
                int(spin_s * 1e9), stall_member, stream)
        else:
            lib = _library()
            order = (None if plan.mode == "allgather" else _order_tensor(
                n, plan.mode, ndir, _device_index(dev)).data_ptr())
            rc = lib.mp4j_ring_launch(
                *codes, *layout, lay.in_row, lay.out_row, xp.data_ptr(),
                out.data_ptr(), order, stream)
    if rc:
        raise Mp4jError(f"ring kernel launch ({lp.path} path) failed: "
                        f"{lib.mp4j_error_string(rc).decode()}")
    return out, err, lp


def _raise_if_stuck(err, spin_s):
    with spans.span("ring::wait", "ring"):
        code, member, step, what = err.tolist()  # waits for the kernel
    if code:
        raise Mp4jError(
            f"ring kernel: member {member} waited on {_WAITS[what]} at step "
            f"{step} past the spin bound ({spin_s} s); the ring is stuck")


def _counted(counter, xp, plan, lay, operator, spin_s, stall_member, path):
    err = None
    if isinstance(xp, list):
        out, lp = _launch_members(xp, plan, lay, operator, path)
        launched = lp.launches
    else:
        out, err, lp = _launch(xp, plan, lay, operator, spin_s,
                               stall_member, path)
        launched = 1
    counter.launches += launched
    setattr(counter, f"{lp.path}_launches",
            getattr(counter, f"{lp.path}_launches") + launched)
    counter.last_plan = lp
    spans.annotate(path=lp.path)
    if err is not None:
        _raise_if_stuck(err, spin_s)
    return out


# ----------------------------------------------------------------------
# the list form: a launch a member (ops/csrc/ring_member.cu)
# ----------------------------------------------------------------------
MAX_MEMBERS = 64            # ring_member.cu kMaxMembers: every member's
                            # input and output pointer in the parameters
ONE_SHOT_BYTES = 64 << 20   # an allreduce whose inputs together take at
                            # most this many bytes runs in one launch a
                            # member (PERF.md: the one-shot threshold)
MEMBER_THREADS = 256        # ring_member.cu kThreads
# blocks an SM that a card's members share, by what a launch does
# (PERF.md: folds ran fastest at 2, copies at 1 on an H100)
FOLD_BLOCKS_PER_SM = 2
COPY_BLOCKS_PER_SM = 1
MEMBER_PATHS = ("member", "one_shot", "two_round")
# what a launch does: must match ring_member.cu
_FOLD_OWN, _FOLD_ALL, _COPY_INPUTS, _COPY_OWNERS = 0, 1, 2, 3
_member_lock = threading.Lock()
# per-card streams (member k of a card takes stream k), the state of each
# list of member cards (_Cards), the pairs of cards with peer access:
# created once and reused, under _member_lock
# mp4j-lint: disable=R7 (process-wide launch state, guarded by _member_lock)
_streams: dict = {}
# mp4j-lint: disable=R7 (process-wide launch state, guarded by _member_lock)
_cards: dict = {}
# mp4j-lint: disable=R7 (process-wide launch state, guarded by _member_lock)
_peers: set = set()


@functools.cache
def fold_order(n: int, mode: str, ndir: int) -> tuple:
    """``order[d][K]``: the members whose chunk K of direction d the ring
    folds, in the order it folds them (``acc = op(acc, x_m)``), read off
    :class:`RingPlan`: member me starts with its chunk ``start(me, d)``,
    and at reduce step s folds its chunk ``merge(me, d, s)`` into what
    its upstream sent; after n - 1 steps each member holds one chunk
    folded over every member."""
    plan = RingPlan(n, mode, ndir)
    order = []
    for d in range(ndir):
        # each member's (chunk, members folded so far); a step hands every
        # list on to exactly one member, which appends itself
        held = [(plan.start(me, d), [me]) for me in range(n)]
        for s in range(n - 1):
            held = [(plan.merge(me, d, s),
                     held[RingPlan.upstream(me, d, n)][1])
                    for me in range(n)]
            for me, (_, members) in enumerate(held):
                members.append(me)
        by_chunk = dict(held)
        order.append(tuple(tuple(by_chunk[k]) for k in range(n)))
    return tuple(order)


@functools.cache
def fold_rotation(n: int, mode: str, ndir: int) -> tuple:
    """The order table of the kernels that fold straight from the members
    (``ring_kernel.cu``, ``ring_member.cu``): ``[ndir][n]`` offsets,
    flattened, chunk K's j-th member ``(K + order[d][j]) % n``. The ring
    folds every chunk in a rotation of one order; a schedule that did not
    would raise."""
    table = []
    for d, chunks in enumerate(fold_order(n, mode, ndir)):
        row = list(chunks[0])
        for k, members in enumerate(chunks):
            if [(m - k) % n for m in members] != row:
                raise Mp4jError(f"ring fold order of chunk {k}, direction "
                                f"{d} is no rotation of chunk 0's")
        table += row
    return tuple(table)


@functools.cache
def member_order(n: int, mode: str, ndir: int) -> bytes:
    """:func:`fold_rotation` as ``ring_member.cu`` takes it: one byte an
    offset (a list has at most :data:`MAX_MEMBERS` members)."""
    return bytes(fold_rotation(n, mode, ndir))


def allreduce_rounds(n: int, row: int, dtype: torch.dtype) -> int:
    """Launches a member of a list allreduce of n ``[row]`` members: 1
    (every member folds every chunk: n times the reads, no second round)
    while the inputs together take at most :data:`ONE_SHOT_BYTES`, else
    2 (fold the owned chunk, then copy the others from their owners)."""
    return 1 if n == 1 or n * row * dtype.itemsize <= ONE_SHOT_BYTES else 2


@dataclass(frozen=True)
class MemberPlan:
    """The launches of one list call: per round, what each member's
    launch does (``tasks``, ``ring_member.cu``'s task codes), its jobs (a
    chunk of one direction each) and the columns a job is cut into."""

    path: str
    n: int
    ndir: int
    mode: str
    w: int
    itemsize: int
    tasks: tuple
    jobs: tuple
    cols: tuple

    @property
    def rounds(self) -> int:
        return len(self.tasks)

    @property
    def launches(self) -> int:
        return self.n * self.rounds


@functools.cache
def member_plan(n: int, mode: str, ndir: int, w: int, row: int,
                dtype: torch.dtype, sms: int, per_card: int,
                path=None) -> MemberPlan:
    """The plan of a list call of n members (at most ``per_card`` on one
    card of ``sms`` SMs) on chunks of ``w`` elements (``row`` the input
    row). The grid is sized by bytes: a job's columns take at least one
    16-byte vector a thread, and a member at most ``FOLD_BLOCKS_PER_SM``
    (a copy: ``COPY_BLOCKS_PER_SM``) ``* sms / per_card`` blocks, so that
    the members of a card run side by side. ``path`` "one_shot" /
    "two_round" forces an allreduce's form (tests and measurements)."""
    if path not in (None,) + MEMBER_PATHS:
        raise Mp4jError(f"a member list takes the member path "
                        f"({MEMBER_PATHS}), not {path!r}")
    if path in ("one_shot", "two_round") and (
            mode != "allreduce" or (path == "two_round" and n < 2)):
        raise Mp4jError(f"path {path!r} forces the form of an allreduce of "
                        f"n >= 2 members, not a {mode} of {n}")
    if mode == "reduce_scatter":
        tasks = (_FOLD_OWN,)
    elif mode == "allgather":
        tasks = (_COPY_INPUTS,)
    else:
        rounds = {"one_shot": 1, "two_round": 2}.get(
            path, allreduce_rounds(n, row, dtype))
        tasks = (_FOLD_ALL,) if rounds == 1 else (_FOLD_OWN, _COPY_OWNERS)
    item = dtype.itemsize
    vectors = -(-w * item // _VECTOR_BYTES)
    jobs = tuple({_FOLD_OWN: ndir, _COPY_OWNERS: ndir * (n - 1)}.get(
        t, ndir * n) for t in tasks)
    cols = []
    for t, j in zip(tasks, jobs):
        per_sm = (COPY_BLOCKS_PER_SM if t in (_COPY_INPUTS, _COPY_OWNERS)
                  else FOLD_BLOCKS_PER_SM)
        blocks = max(1, per_sm * sms // per_card)
        cols.append(max(1, min(-(-blocks // j),
                               -(-vectors // MEMBER_THREADS))))
    return MemberPlan("member", n, ndir, mode, w, item, tasks, jobs,
                      tuple(cols))


def _global_plain(xp, plan: RingPlan, lay: _Layout, operator: Operator):
    """The plain version of ``ring_kernel.cu`` on a packed ``[n, L]``
    tensor: chunk K of direction d folded once over the rows in the
    ring's order (:func:`fold_rotation`, every chunk at once), then
    stored into every row that receives it; an allgather copies each
    member's part into every row. The tests hold it bitwise against
    :func:`_plain` (the ring schedule, step by step) and the reference."""
    n = plan.n
    out = torch.empty((n, lay.out_row), dtype=xp.dtype, device=xp.device)
    k = torch.arange(n, device=xp.device)
    rotation = fold_rotation(n, plan.mode, plan.ndir)
    for d in range(plan.ndir):
        if plan.mode == "allgather":         # [row, chunk, w] <- [q, w]
            _chunks(out, n, lay, d)[:] = xp[:, lay.vbase[d]:lay.vbase[d]
                                            + lay.w]
            continue
        src = _chunks(xp, n, lay, d)
        acc = None
        for o in rotation[d * n:(d + 1) * n]:
            v = src[(k + o) % n, k]          # [chunk, w]: row K + o's chunk K
            acc = v if acc is None else operator.torch_fn(acc, v)
        if plan.mode == "reduce_scatter":
            out[:, lay.vbase[d]:lay.vbase[d] + lay.w] = acc
        else:
            _chunks(out, n, lay, d)[:] = acc
    return out


def _members_plain(xs, plan: RingPlan, lay: _Layout, operator: Operator):
    """The plain version of ``ring_member.cu``: chunk K of direction d
    folded over the members in :func:`fold_order`, on the device of the
    member that owns it, and copied to every member that receives it."""
    n = plan.n
    outs = [torch.empty(lay.out_row, dtype=t.dtype, device=t.device)
            for t in xs]
    order = fold_order(n, plan.mode, plan.ndir)
    for d in range(plan.ndir):
        for k in range(n):
            at = lay.base[d] + k * lay.stride
            if plan.mode == "allgather":
                part = xs[k][lay.vbase[d]:lay.vbase[d] + lay.w]
                for out in outs:
                    out[at:at + lay.w].copy_(part)
                continue
            acc = None
            for m in order[d][k]:
                v = xs[m][at:at + lay.w].to(xs[k].device)
                acc = v if acc is None else operator.torch_fn(acc, v)
            if plan.mode == "reduce_scatter":
                outs[k][lay.vbase[d]:lay.vbase[d] + lay.w].copy_(acc)
                continue
            for out in outs:
                out[at:at + lay.w].copy_(acc)
    return outs


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _enable_peers(indexes) -> None:
    """Peer access for every ordered pair of distinct cards, once."""
    lib = _member_library()
    for a in indexes:
        for b in indexes:
            if a == b or (a, b) in _peers:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise Mp4jError(
                    f"ring kernel: cuda:{a} cannot reach cuda:{b}'s memory "
                    "(no peer access between the cards); the list form "
                    "never stages through the host")
            with torch.cuda.device(a):
                rc = lib.mp4j_ring_enable_peer(b)
            if rc:
                raise Mp4jError(
                    f"ring kernel: peer access cuda:{a} -> cuda:{b} "
                    f"failed: {lib.mp4j_error_string(rc).decode()}")
            _peers.add((a, b))


def _new_event(index: int) -> int:
    lib = _member_library()
    event = (ctypes.c_void_p * 1)()
    with torch.cuda.device(index):
        rc = lib.mp4j_ring_member_events(1, event)
    if rc:
        raise Mp4jError(f"ring kernel: an event on cuda:{index} failed: "
                        f"{lib.mp4j_error_string(rc).decode()}")
    return event[0]


class _Cards:
    """What every call over one list of member cards reuses, made once:
    the native call's arrays of member cards, distinct cards and member
    streams (member k of a card on that card's k-th stream), and the
    events -- a ready event a card, a first-launch and a last-launch
    event a member, the join event on member 0's card."""

    def __init__(self, indexes: tuple):
        self.cards = sorted(set(indexes))
        self.per_card = max(indexes.count(i) for i in self.cards)
        self.sms = min(_sm_count(i) for i in self.cards)
        n, c = len(indexes), len(self.cards)
        _enable_peers(self.cards)
        seen: dict = {}
        streams = []
        for i in indexes:
            k = seen[i] = seen.get(i, -1) + 1
            stream = _streams.get((i, k))
            if stream is None:
                stream = _streams[(i, k)] = torch.cuda.Stream(i)
            streams.append(stream.cuda_stream)
        self.devices = (ctypes.c_int * n)(*indexes)
        self.card_ids = (ctypes.c_int * c)(*self.cards)
        self.streams = (ctypes.c_void_p * n)(*streams)
        self.ready = (ctypes.c_void_p * c)(*map(_new_event, self.cards))
        self.done1 = (ctypes.c_void_p * n)(*map(_new_event, indexes))
        self.done = (ctypes.c_void_p * n)(*map(_new_event, indexes))
        self.join = _new_event(indexes[0])


def _launch_members(xs, plan: RingPlan, lay: _Layout, operator: Operator,
                    path):
    """Every member's launches of one list call, in one native call:
    member r's on its tensor's card, on a stream of its own, after every
    card's inputs (each card's ready event, recorded on its current
    stream); each card's current stream then waits on every launch, so
    what follows on any card sees every member's output and PyTorch's
    allocator reuses no input early. Returns (outputs, plan)."""
    n, x0 = plan.n, xs[0]
    if n > MAX_MEMBERS:
        raise Mp4jError(f"ring kernel: a list of {n} members; the member "
                        f"launch takes at most {MAX_MEMBERS}")
    indexes = tuple(t.device.index for t in xs)
    lib = _member_library()
    base = tuple(lay.base) + (0,) * (2 - len(lay.base))
    vbase = tuple(lay.vbase) + (0,) * (2 - len(lay.vbase))
    ptrs = ctypes.c_void_p * n
    with _member_lock:
        cards = _cards.get(indexes)
        if cards is None:
            cards = _cards[indexes] = _Cards(indexes)
        mp = member_plan(n, plan.mode, plan.ndir, lay.w, lay.in_row,
                         x0.dtype, cards.sms, cards.per_card, path)
        ins, outs = [], []
        for t in xs:
            if t.data_ptr() % _VECTOR_BYTES:
                t = t.clone(memory_format=torch.contiguous_format)
            ins.append(t)
            # on the card's current stream, before its ready event
            outs.append(torch.empty(lay.out_row, dtype=t.dtype,
                                    device=t.device))
        currents = (ctypes.c_void_p * len(cards.cards))(
            *[torch.cuda.current_stream(i).cuda_stream for i in cards.cards])
        failed = ctypes.c_int(-1)
        rc = lib.mp4j_ring_members_launch(
            _DTYPE_CODES[x0.dtype], operator.kernel_code,
            _MODE_CODES[plan.mode], plan.ndir, n, mp.rounds,
            (ctypes.c_int * 2)(*mp.tasks), (ctypes.c_int * 2)(*mp.cols),
            lay.w, lay.stride, *base, *vbase,
            member_order(n, plan.mode, plan.ndir), cards.devices,
            ptrs(*[t.data_ptr() for t in ins]),
            ptrs(*[t.data_ptr() for t in outs]), cards.streams,
            len(cards.cards), cards.card_ids, currents, cards.ready,
            cards.done1, cards.done, cards.join, ctypes.byref(failed))
    if rc:
        raise Mp4jError(
            f"ring kernel launch (member path, member {failed.value}) "
            f"failed: {lib.mp4j_error_string(rc).decode()}")
    return outs, mp


def ring_kernel(xp, plan, lay, operator, spin_s=SPIN_SECONDS,
                stall_member=-1, path=None):
    """One launch of the unidirectional kernel (row 2 of the TPU table),
    or, for a list of member tensors, the launches of every member (each
    counted). ``spin_s`` bounds every wait of the cluster path (the
    global path and a list have none); ``stall_member`` (a test hook of
    the cluster path, refused on the others) names a member that does no
    work; ``path`` forces "cluster" or "global" (tests and measurements;
    on a list, "one_shot" or "two_round" forces an allreduce's form).
    Counts ``launches`` and the path's ``cluster_launches`` /
    ``global_launches`` / ``member_launches``; ``last_plan`` is the
    :class:`LaunchPlan`, :class:`GlobalPlan` or :class:`MemberPlan` of the
    latest call."""
    return _counted(ring_kernel, xp, plan, lay, operator, spin_s,
                    stall_member, path)


def ring_kernel_bidir(xp, plan, lay, operator, spin_s=SPIN_SECONDS,
                      stall_member=-1, path=None):
    """One launch of the bidirectional kernel (row 3); as
    :func:`ring_kernel`."""
    return _counted(ring_kernel_bidir, xp, plan, lay, operator, spin_s,
                    stall_member, path)


for _fn in (ring_kernel, ring_kernel_bidir):
    _fn.launches = _fn.cluster_launches = _fn.global_launches = 0
    _fn.member_launches = 0
    _fn.last_plan = None


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def _check(x, operator: Operator, what: str):
    if isinstance(x, (list, tuple)):
        _check_list(x, what)
        x = x[0]
    elif not isinstance(x, torch.Tensor) or x.ndim != 2 or x.shape[0] < 1:
        raise Mp4jError(f"{what} needs a [n, L] tensor of n >= 1 members, "
                        f"got {getattr(x, 'shape', type(x).__name__)}")
    if x.dtype not in _DTYPE_CODES:
        raise Mp4jError(f"{what}: dtype {x.dtype} is not one the kernel "
                        f"takes ({sorted(map(str, _DTYPE_CODES))})")
    if not operator.is_builtin:
        raise Mp4jError(
            f"{what}: custom operator {operator.name} cannot run inside "
            "the CUDA ring kernel; use algo=\"ring\" (the torch ring "
            "schedule)")
    if x.device.type not in ("cpu", "cuda"):
        raise Mp4jError(f"{what} runs on cpu or cuda tensors, not {x.device}")


def _check_list(xs, what: str):
    if not xs or any(not isinstance(t, torch.Tensor) or t.ndim != 1
                     for t in xs):
        raise Mp4jError(f"{what} needs a list of n >= 1 [L] member "
                        f"tensors, got "
                        f"{[getattr(t, 'shape', type(t).__name__) for t in xs]}")
    t0 = xs[0]
    for t in xs:
        if (t.shape != t0.shape or t.dtype != t0.dtype
                or t.device.type != t0.device.type):
            raise Mp4jError(
                f"{what}: list members must share a length, a dtype and a "
                f"device type, got "
                f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in xs]}")


class _List:
    """A member list seen as the packed form's ``[n, L]``: its shape,
    dtype and (member 0's) device."""

    def __init__(self, xs):
        self.xs = list(xs)
        self.shape = (len(xs), xs[0].shape[0])
        self.dtype = xs[0].dtype
        self.device = xs[0].device


def _chunk_granule(c: int, x, bidirectional: bool, what: str) -> None:
    g = granule(x.dtype, x.device) * (2 if bidirectional else 1)
    if c % g:
        raise Mp4jError(
            f"{what}: chunks must be multiples of {g} elements for "
            f"{x.dtype} on {x.device.type}"
            + (" (two halves of the granule when bidirectional)"
               if bidirectional else "")
            + f"; got {c} (see granule)")


def _run(xp, plan, lay, operator, plain, kw):
    if not plain:   # a kernel entry point's call, on its ring::<mode> span
        spans.annotate(members=plan.n, bytes=lay.in_row * xp.dtype.itemsize,
                       dtype=str(xp.dtype).removeprefix("torch."),
                       ndir=plan.ndir)
        if xp.device.type == "cpu":
            spans.annotate(path="plain")
    if isinstance(xp, _List):
        if (kw.get("spin_s", SPIN_SECONDS) != SPIN_SECONDS
                or kw.get("stall_member", -1) != -1):
            raise Mp4jError(
                "ring kernel: spin_s and stall_member bound and stall the "
                "packed launch's waits; a member list's launches never "
                "wait on each other, so a list call takes neither")
        if plain or xp.device.type == "cpu":
            return _members_plain(xp.xs, plan, lay, operator)
        xp = [t.contiguous() for t in xp.xs]
    elif plain or xp.device.type == "cpu":
        return _plain(xp, plan, lay, operator)
    return (ring_kernel if plan.ndir == 1 else ring_kernel_bidir)(
        xp, plan, lay, operator, **kw)


def _members(x):
    """(members as the packed tensor or a :class:`_List`, their
    ``[n, L]`` shape)."""
    if isinstance(x, (list, tuple)):
        x = _List(x)
        return x, x.shape
    return x.contiguous(), tuple(x.shape)


def _identity(x):
    """The n = 1 result: the input (a fresh list of a list)."""
    return list(x) if isinstance(x, (list, tuple)) else x


def _allreduce(x, operator, bidirectional, force_kernel, plain, kw):
    what = "ring allreduce kernel"
    _check(x, operator, what)
    xp, (n, L) = _members(x)
    if n == 1 and not force_kernel:
        return _identity(x)
    ndir = 2 if bidirectional else 1
    parts = ndir * n
    c = round_up_chunk(-(-L // parts), xp.dtype, xp.device)
    pad = parts * c - L
    if pad:
        def padded(t):
            fill = torch.full(t.shape[:-1] + (pad,),
                              operator.identity(t.dtype), dtype=t.dtype,
                              device=t.device)
            return torch.cat([t, fill], dim=-1)

        xp = (_List([padded(t) for t in xp.xs]) if isinstance(xp, _List)
              else padded(xp))
    lay = _Layout(w=c, stride=c, base=(0, n * c)[:ndir], vbase=(0, 0)[:ndir],
                  in_row=parts * c, out_row=parts * c)
    out = _run(xp, RingPlan(n, "allreduce", ndir), lay, operator, plain, kw)
    if not pad:
        return out
    return [t[:L] for t in out] if isinstance(out, list) else out[:, :L]


def _reduce_scatter(x, operator, bidirectional, force_kernel, plain, kw):
    what = "ring reduce-scatter kernel"
    _check(x, operator, what)
    xp, (n, L) = _members(x)
    if L % n:
        raise Mp4jError(f"{what} needs a length divisible by {n}, got "
                        f"shape {(n, L)}")
    if n == 1 and not force_kernel:
        return _identity(x)
    c = L // n
    _chunk_granule(c, xp, bidirectional, what)
    ndir = 2 if bidirectional else 1
    w = c // ndir
    lay = _Layout(w=w, stride=c, base=(0, w)[:ndir], vbase=(0, w)[:ndir],
                  in_row=L, out_row=c)
    return _run(xp, RingPlan(n, "reduce_scatter", ndir), lay, operator,
                plain, kw)


def _allgather(x, bidirectional, force_kernel, plain, kw):
    what = "ring allgather kernel"
    _check(x, Operators.SUM, what)
    xp, (n, c) = _members(x)
    if n == 1 and not force_kernel:
        return _identity(x)
    _chunk_granule(c, xp, bidirectional, what)
    ndir = 2 if bidirectional else 1
    w = c // ndir
    lay = _Layout(w=w, stride=c, base=(0, w)[:ndir], vbase=(0, w)[:ndir],
                  in_row=c, out_row=n * c)
    return _run(xp, RingPlan(n, "allgather", ndir), lay, Operators.SUM,
                plain, kw)


def ring_allreduce_kernel(x, operator: Operator = Operators.SUM,
                          bidirectional: bool = False,
                          force_kernel: bool = False, **launch):
    """Allreduce of members ``x`` [n, L] (any L): every row becomes the
    element-wise reduction. ``launch``: ``spin_s`` and the test hooks
    ``stall_member`` and ``path`` (see :func:`ring_kernel`; a list takes
    only ``path``). A CUDA input
    whose data does not start on 16 bytes is copied first. Each entry
    point also takes a list of n ``[L]`` member tensors, member r's on
    its own device, and returns a list the same way (one launch a
    member on CUDA; see the module docstring). Each entry point's call is
    one span ``ring::<mode>`` (``obs.spans.span``) whose args give the
    ``path`` it took (``cluster``, ``global``, ``member``, or ``plain`` on
    a CPU tensor), ``members``, ``bytes`` (a member's input as the kernel
    reads it, an allreduce's padded to whole chunks), ``dtype`` and
    ``ndir``; on the cluster path the host's wait for the kernel's error
    word is its child ``ring::wait``."""
    with spans.span("ring::allreduce", "ring"):
        return _allreduce(x, operator, bidirectional, force_kernel, False,
                          launch)


def ring_reduce_scatter_kernel(x, operator: Operator = Operators.SUM,
                               bidirectional: bool = False,
                               force_kernel: bool = False, **launch):
    """Members ``x`` [n, L], L divisible by n, chunks L/n multiples of the
    granule: member r's row of the [n, L/n] result is chunk r of the
    reduction."""
    with spans.span("ring::reduce_scatter", "ring"):
        return _reduce_scatter(x, operator, bidirectional, force_kernel,
                               False, launch)


def ring_allgather_kernel(x, bidirectional: bool = False,
                          force_kernel: bool = False, **launch):
    """Members' shards ``x`` [n, c] (c a multiple of the granule): every
    row of the [n, n*c] result holds member q's shard at block q."""
    with spans.span("ring::allgather", "ring"):
        return _allgather(x, bidirectional, force_kernel, False, launch)


def ring_allreduce_reference(x, operator: Operator = Operators.SUM,
                             bidirectional: bool = False,
                             force_kernel: bool = False):
    """Plain version of :func:`ring_allreduce_kernel` on any device."""
    return _allreduce(x, operator, bidirectional, force_kernel, True, {})


def ring_reduce_scatter_reference(x, operator: Operator = Operators.SUM,
                                  bidirectional: bool = False,
                                  force_kernel: bool = False):
    """Plain version of :func:`ring_reduce_scatter_kernel`."""
    return _reduce_scatter(x, operator, bidirectional, force_kernel, True,
                           {})


def ring_allgather_reference(x, bidirectional: bool = False,
                             force_kernel: bool = False):
    """Plain version of :func:`ring_allgather_kernel`."""
    return _allgather(x, bidirectional, force_kernel, True, {})
