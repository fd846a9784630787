"""Ring collectives as hand-written CUDA kernels: the port of
``ytk_mp4j_tpu/ops/ring_kernel.py`` (the Pallas RDMA ring kernels).

n ring members live on one card as the rows of a ``[n, L]`` tensor, and
one launch runs all of them, on one of two paths that
:func:`launch_plan` picks from n and the card, never from a failure:

- **cluster** (n <= 8, ``ops/csrc/ring_cluster.cu``): the members of a
  column are the blocks of one thread-block cluster; receive slots live
  in the receiver's shared memory, sends are bulk asynchronous copies
  into it, credits are remote mbarrier arrives, so device memory carries
  only the input and the output;
- **global** (larger n, or a cluster size the card refuses;
  ``ops/csrc/ring_kernel.cu``): each member is a row of blocks writing
  into its neighbour's receive slots in device memory, in one cooperative
  launch.

Both follow the reference's slot and credit protocol (``_direction:128``).
Entry points, each on a ``[n, ...]`` tensor of members:

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
the CUDA sources mirror, and :func:`protocol`, the slot/credit sequence
(:data:`PROTOCOL` for the global kernel, :data:`CLUSTER_PROTOCOL` for the
cluster kernel; the tests run both under the reference's
skew-adversarial scheduler). On a CPU tensor the entries compute the
plain version; on a CUDA tensor they launch a kernel or raise, and
nothing retries on another kernel. Launches are counted on
``ring_kernel.launches`` (one direction) and ``ring_kernel_bidir.launches``
(two), and per path on their ``cluster_launches`` / ``global_launches``.

Chunk granule (:func:`granule`), the one place it is defined: 1 element
on the CPU, as the reference's interpret mode, so the CPU version chunks
exactly as the reference's interpreted kernel; 16 bytes on CUDA, for
vector accesses and bulk copies (every column and segment boundary is a
multiple of it). Reduce-scatter and allgather chunks must be multiples of
it (twice it when bidirectional); allreduce pads to it.

Divergences from the reference, intended:

- a custom operator raises :class:`Mp4jError` naming ``algo="ring"``:
  the kernel cannot run a Python function;
- on the global path, a member that cannot be co-resident with the
  others is refused: n x blocks per member over the card's occupancy
  raises before any launch (a cluster's blocks are co-resident by
  construction); on both paths every wait is bounded, and a stuck ring
  raises instead of hanging.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.ops import _build

# dtype codes: must match kernel_for in ops/csrc/ring_cluster.cu and
# ops/csrc/ring_kernel.cu
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
    """The per-direction protocol at global step g with ``slots`` receive
    slots, as ops on flags that only grow within a launch: ("wait_*",
    slot, v) waits for flag >= v, "send" writes the neighbour's slot then
    stores its recv flag = v, "consume" reads our slot, "signal_credit"
    stores the upstream's credit = v. Every direction's begin runs before
    any finish; after the last step each direction waits ``drain(steps)``.

    A sender may reuse slot k once the receiver consumed the previous send
    into k. ``ahead``: begin(g) waits that credit for the slot of step
    g + ahead (the cluster kernel folds step g into the buffer step g + 1
    sends, so it waits one step ahead; the global kernel waits at g)."""

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


# the global-memory kernel's protocol (ops/csrc/ring_kernel.cu)
PROTOCOL = protocol(2)
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
GLOBAL_SEG = 2048           # elements of a slot: ring_kernel.cu kSeg
PATHS = ("cluster", "global")


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch covers each direction's chunk ``[0, w)``: ``cols``
    columns of ``col_w`` elements (the last ones may be short or empty),
    each walked in segments of ``seg`` elements, one slot each.

    ``path`` "cluster": one thread-block cluster of n blocks per column,
    slots in shared memory (``ops/csrc/ring_cluster.cu``); "global": one
    block per member and column, slots in device memory
    (``ops/csrc/ring_kernel.cu``). Both kernels walk exactly
    :meth:`segments`."""

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


def launch_plan(n: int, w: int, dtype: torch.dtype, ndir: int, device, *,
                clusters: int = 0, capacity: int = 0) -> LaunchPlan:
    """The plan for n members and chunks of ``w`` elements. ``clusters``:
    clusters of n blocks the card holds at once (0 where it refuses that
    size); ``capacity``: co-resident blocks of the global kernel. The
    cluster path takes n <= CLUSTER_LIMIT whenever the card holds such a
    cluster; the global path takes the rest. Every boundary is a multiple
    of the granule, so 16-byte aligned on CUDA."""
    item = torch.empty((), dtype=dtype).element_size()
    g = granule(dtype, device)

    def up(v):
        return -(-v // g) * g

    if 1 <= n <= CLUSTER_LIMIT and clusters > 0:
        cols = max(1, min(clusters, -(-w // g)))
        col_w = up(-(-w // cols))
        per_col = -(-col_w // (CLUSTER_SEG_BYTES // ndir // item))
        seg = max(g, up(-(-col_w // per_col)))     # equal segments
        return LaunchPlan("cluster", n, ndir, w, item, cols, col_w, seg,
                          CLUSTER_SLOTS)
    cols = max(1, min(capacity // n, -(-w // GLOBAL_SEG)))
    return LaunchPlan("global", n, ndir, w, item, cols, up(-(-w // cols)),
                      GLOBAL_SEG, PROTOCOL["slots"])


# ----------------------------------------------------------------------
# the CUDA launch
# ----------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("ring_kernel")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mp4j_ring_capacity.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.mp4j_ring_capacity.restype = i
    lib.mp4j_ring_seg.argtypes = []
    lib.mp4j_ring_seg.restype = i
    lib.mp4j_ring_launch.argtypes = [i, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
                                     ll, ll, ll, p, p, p, p, p, ll, i, p]
    lib.mp4j_ring_launch.restype = i
    lib.mp4j_error_string.argtypes = [i]
    lib.mp4j_error_string.restype = ctypes.c_char_p
    if lib.mp4j_ring_seg() != GLOBAL_SEG:
        raise Mp4jError(f"ring_kernel.cu slots hold {lib.mp4j_ring_seg()} "
                        f"elements, the launch plan assumes {GLOBAL_SEG}")
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


def _device_index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


@functools.cache
def _query(kind: str, dtype_code: int, op_code: int, ndir: int, n: int,
           index: int, slot_bytes: int = 0) -> int:
    value = ctypes.c_int(0)
    with torch.cuda.device(index):
        if kind == "clusters":
            lib = _cluster_library()
            rc = lib.mp4j_ring_cluster_max_clusters(
                dtype_code, op_code, ndir, n, slot_bytes, ctypes.byref(value))
        else:
            lib = _library()
            rc = lib.mp4j_ring_capacity(dtype_code, op_code, ndir,
                                        ctypes.byref(value))
    if rc:
        raise Mp4jError(f"ring kernel occupancy query ({kind}) failed: "
                        f"{lib.mp4j_error_string(rc).decode()}")
    return value.value


def capacity(dtype: torch.dtype, operator: Operator, ndir: int,
             device) -> int:
    """Blocks of the global-memory kernel that fit on the card at once
    (queried once per dtype, operator, directions and card)."""
    return _query("capacity", _DTYPE_CODES[dtype], operator.kernel_code,
                  ndir, 0, _device_index(device))


def max_clusters(dtype: torch.dtype, operator: Operator, ndir: int, n: int,
                 device) -> int:
    """Clusters of n blocks of the cluster kernel resident at once on the
    card, 0 where the card refuses that size (queried once per dtype,
    operator, directions, n and card)."""
    if not 1 <= n <= CLUSTER_LIMIT:
        return 0
    return _query("clusters", _DTYPE_CODES[dtype], operator.kernel_code,
                  ndir, n, _device_index(device), CLUSTER_SEG_BYTES // ndir)


def _plan_launch(xp, plan: RingPlan, lay: _Layout, operator: Operator,
                 path) -> LaunchPlan:
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
    cap = 0 if clusters else capacity(xp.dtype, operator, ndir, dev)
    lp = launch_plan(n, lay.w, xp.dtype, ndir, dev, clusters=clusters,
                     capacity=cap)
    if lp.path == "global" and n * lp.cols > cap:
        raise Mp4jError(
            f"ring kernel: {n} members x {lp.cols} blocks each need "
            f"{n * lp.cols} co-resident blocks, the card holds {cap}; every "
            "member spins on its neighbours, so a grid that does not fit "
            "would hang")
    return lp


def _launch(xp, plan: RingPlan, lay: _Layout, operator: Operator, spin_s,
            stall_member, path):
    """One launch on xp's card, on the path :func:`launch_plan` picks
    (``path`` forces one, for tests and measurements). Bulk copies need
    16-byte-aligned addresses: an input whose data does not start on 16
    bytes (a view at an odd storage offset) is copied first."""
    lp = _plan_launch(xp, plan, lay, operator, path)
    dev = xp.device
    n, ndir = plan.n, plan.ndir
    if xp.data_ptr() % _VECTOR_BYTES:
        xp = xp.clone(memory_format=torch.contiguous_format)
    err = torch.zeros(4, dtype=torch.int64, device=dev)
    out = torch.empty((n, lay.out_row), dtype=xp.dtype, device=dev)
    base = tuple(lay.base) + (0,) * (2 - len(lay.base))
    vbase = tuple(lay.vbase) + (0,) * (2 - len(lay.vbase))
    shape = (lay.w, lay.stride, base[0], base[1], vbase[0], vbase[1],
             lp.col_w, lay.in_row, lay.out_row)
    codes = (_DTYPE_CODES[xp.dtype], operator.kernel_code, ndir,
             _MODE_CODES[plan.mode], n, lp.cols)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lp.path == "cluster":
            lib = _cluster_library()
            rc = lib.mp4j_ring_cluster_launch(
                *codes, lp.seg, *shape, xp.data_ptr(), out.data_ptr(),
                err.data_ptr(), int(spin_s * 1e9), stall_member, stream)
        else:
            lib = _library()
            flags = torch.zeros(2 * ndir * n * lp.cols * 2,
                                dtype=torch.int64, device=dev)
            slots = torch.empty(ndir * n * lp.cols * 2 * GLOBAL_SEG,
                                dtype=xp.dtype, device=dev)
            rc = lib.mp4j_ring_launch(
                *codes, *shape, xp.data_ptr(), out.data_ptr(),
                slots.data_ptr(), flags.data_ptr(), err.data_ptr(),
                int(spin_s * 1e9), stall_member, stream)
    if rc:
        raise Mp4jError(f"ring kernel launch ({lp.path} path) failed: "
                        f"{lib.mp4j_error_string(rc).decode()}")
    return out, err, lp


def _raise_if_stuck(err, spin_s):
    code, member, step, what = err.tolist()      # waits for the kernel
    if code:
        raise Mp4jError(
            f"ring kernel: member {member} waited on {_WAITS[what]} at step "
            f"{step} past the spin bound ({spin_s} s); the ring is stuck")


def _counted(counter, xp, plan, lay, operator, spin_s, stall_member, path):
    out, err, lp = _launch(xp, plan, lay, operator, spin_s, stall_member,
                           path)
    counter.launches += 1
    setattr(counter, f"{lp.path}_launches",
            getattr(counter, f"{lp.path}_launches") + 1)
    counter.last_plan = lp
    _raise_if_stuck(err, spin_s)
    return out


def ring_kernel(xp, plan, lay, operator, spin_s=SPIN_SECONDS,
                stall_member=-1, path=None):
    """One launch of the unidirectional kernel (row 2 of the TPU table).
    ``spin_s`` bounds every wait; ``stall_member`` (a test hook) names a
    member that does no work; ``path`` forces "cluster" or "global"
    (tests and measurements). Counts ``launches`` and the path's
    ``cluster_launches`` / ``global_launches``; ``last_plan`` is the
    :class:`LaunchPlan` of the latest launch."""
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
    _fn.last_plan = None


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def _check(x, operator: Operator, what: str):
    if not isinstance(x, torch.Tensor) or x.ndim != 2 or x.shape[0] < 1:
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
    if plain or xp.device.type == "cpu":
        return _plain(xp, plan, lay, operator)
    return (ring_kernel if plan.ndir == 1 else ring_kernel_bidir)(
        xp, plan, lay, operator, **kw)


def _allreduce(x, operator, bidirectional, force_kernel, plain, kw):
    what = "ring allreduce kernel"
    _check(x, operator, what)
    n, L = x.shape
    if n == 1 and not force_kernel:
        return x
    ndir = 2 if bidirectional else 1
    parts = ndir * n
    c = round_up_chunk(-(-L // parts), x.dtype, x.device)
    pad = parts * c - L
    xp = x.contiguous()
    if pad:
        fill = torch.full((n, pad), operator.identity(x.dtype),
                          dtype=x.dtype, device=x.device)
        xp = torch.cat([xp, fill], dim=1)
    lay = _Layout(w=c, stride=c, base=(0, n * c)[:ndir], vbase=(0, 0)[:ndir],
                  in_row=parts * c, out_row=parts * c)
    out = _run(xp, RingPlan(n, "allreduce", ndir), lay, operator, plain, kw)
    return out[:, :L] if pad else out


def _reduce_scatter(x, operator, bidirectional, force_kernel, plain, kw):
    what = "ring reduce-scatter kernel"
    _check(x, operator, what)
    n, L = x.shape
    if L % n:
        raise Mp4jError(f"{what} needs a length divisible by {n}, got "
                        f"shape {tuple(x.shape)}")
    if n == 1 and not force_kernel:
        return x
    c = L // n
    _chunk_granule(c, x, bidirectional, what)
    ndir = 2 if bidirectional else 1
    w = c // ndir
    lay = _Layout(w=w, stride=c, base=(0, w)[:ndir], vbase=(0, w)[:ndir],
                  in_row=L, out_row=c)
    return _run(x.contiguous(), RingPlan(n, "reduce_scatter", ndir), lay,
                operator, plain, kw)


def _allgather(x, bidirectional, force_kernel, plain, kw):
    what = "ring allgather kernel"
    _check(x, Operators.SUM, what)
    n, c = x.shape
    if n == 1 and not force_kernel:
        return x
    _chunk_granule(c, x, bidirectional, what)
    ndir = 2 if bidirectional else 1
    w = c // ndir
    lay = _Layout(w=w, stride=c, base=(0, w)[:ndir], vbase=(0, w)[:ndir],
                  in_row=c, out_row=n * c)
    return _run(x.contiguous(), RingPlan(n, "allgather", ndir), lay,
                Operators.SUM, plain, kw)


def ring_allreduce_kernel(x, operator: Operator = Operators.SUM,
                          bidirectional: bool = False,
                          force_kernel: bool = False, **launch):
    """Allreduce of members ``x`` [n, L] (any L): every row becomes the
    element-wise reduction. ``launch``: ``spin_s`` and the test hooks
    ``stall_member`` and ``path`` (see :func:`ring_kernel`). A CUDA input
    whose data does not start on 16 bytes is copied first."""
    return _allreduce(x, operator, bidirectional, force_kernel, False, launch)


def ring_reduce_scatter_kernel(x, operator: Operator = Operators.SUM,
                               bidirectional: bool = False,
                               force_kernel: bool = False, **launch):
    """Members ``x`` [n, L], L divisible by n, chunks L/n multiples of the
    granule: member r's row of the [n, L/n] result is chunk r of the
    reduction."""
    return _reduce_scatter(x, operator, bidirectional, force_kernel, False,
                           launch)


def ring_allgather_kernel(x, bidirectional: bool = False,
                          force_kernel: bool = False, **launch):
    """Members' shards ``x`` [n, c] (c a multiple of the granule): every
    row of the [n, n*c] result holds member q's shard at block q."""
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
