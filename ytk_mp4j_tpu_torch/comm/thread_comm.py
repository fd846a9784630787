"""Thread-level slave — hybrid process x thread parallelism.

A copy of ``ytk_mp4j_tpu/comm/thread_comm.py``, with its imports re-rooted
at the port; it imports nothing of the JAX package. The device mapping
note below names the port's ``GpuCommCluster``.

The reference's ``ThreadCommSlave`` (SURVEY.md sections 2, 3d): each of
``thread_num`` threads in a process holds a slave object with a per-thread
rank; collectives synchronize on an in-process barrier, reduce into
thread 0's buffer through shared memory, run the process-level collective
on thread 0, then fan results back out to all threads.

Global rank layout is blocked: ``global_rank = proc_rank * thread_num +
thread_rank``, so a process owns a contiguous global-rank range and
segment collectives can coarsen thread ranges into per-process ranges for
the process-level step.

Construction: ``ThreadCommSlave.spawn_group(thread_num, master_host,
master_port)`` builds the ``thread_num`` slave objects sharing one
``ProcessCommSlave`` (or, with no master args, a standalone single-process
thread group — useful for tests and pure-thread jobs).

Device mapping note (SURVEY.md 3d): this two-level hierarchy is the host
analogue of the device mesh's inter x intra axes — the device-side
equivalent is ``GpuCommCluster`` over ``make_hier_mesh(inter, intra)``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ytk_mp4j_tpu_torch import meta
from ytk_mp4j_tpu_torch.comm.context import CommSlave
from ytk_mp4j_tpu_torch.comm import progress as progress_mod
from ytk_mp4j_tpu_torch.comm.process_comm import ProcessCommSlave
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operands import Operand, Operands
from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.utils import native, trace
from ytk_mp4j_tpu_torch.utils.stats import CommStats, merge_snapshots


class _ThreadGroup:
    """Shared state for the threads of one process."""

    def __init__(self, thread_num: int, proc: ProcessCommSlave | None):
        self.thread_num = thread_num
        self.proc = proc
        # intra-process counters (shared-memory merges); the process
        # slave keeps its own wire counters — stats() sums both
        self.comm_stats = CommStats()
        self.barrier = threading.Barrier(thread_num)
        self.slots: list = [None] * thread_num
        self.result = None
        self.lock = threading.Lock()
        # close bookkeeping: the underlying process slave closes when
        # every thread's slave has closed (or immediately if only one
        # close ever comes — see ThreadCommSlave.close)
        self.pending_closes = thread_num
        self.max_code = 0
        self.closed = False

    @property
    def proc_rank(self) -> int:
        return self.proc.rank if self.proc is not None else 0

    @property
    def proc_num(self) -> int:
        return self.proc.slave_num if self.proc is not None else 1


class ThreadCommSlave(CommSlave):
    """One thread's endpoint in a hybrid process x thread job."""

    def __init__(self, group: _ThreadGroup, thread_rank: int):
        self._g = group
        self._tr = thread_rank
        # trace.traced scopes this around every collective call so
        # intra-process merge time attributes to the right collective
        self._comm_stats = group.comm_stats

    # ------------------------------------------------------------------
    @classmethod
    def spawn_group(cls, thread_num: int, master_host: str | None = None,
                    master_port: int | None = None,
                    **proc_kwargs) -> list["ThreadCommSlave"]:
        """Create the ``thread_num`` slaves of this process. With master
        args, also joins the process-level job (one ProcessCommSlave
        shared by all threads, used from thread 0 only)."""
        if thread_num < 1:
            raise Mp4jError(f"thread_num must be >= 1, got {thread_num}")
        proc = None
        if master_host is not None:
            if master_port is None:
                raise Mp4jError("master_port required with master_host")
            proc = ProcessCommSlave(master_host, master_port, **proc_kwargs)
        g = _ThreadGroup(thread_num, proc)
        # intra-process spans (shared-memory merges) land on the
        # process rank's timeline track; per-thread tids distinguish
        # the threads within it
        g.comm_stats.rank = proc.rank if proc is not None else 0
        return [cls(g, t) for t in range(thread_num)]

    # ------------------------------------------------------------------
    # identity
    # ------------------------------------------------------------------
    @property
    def thread_rank(self) -> int:
        return self._tr

    @property
    def thread_num(self) -> int:
        return self._g.thread_num

    @property
    def rank(self) -> int:
        """Global rank across all processes x threads (blocked layout)."""
        return self._g.proc_rank * self._g.thread_num + self._tr

    @property
    def slave_num(self) -> int:
        """Global endpoint count (process count x thread count)."""
        return self._g.proc_num * self._g.thread_num

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------
    def thread_barrier(self) -> None:
        """Intra-process barrier (the reference's ``threadBarrier()``)."""
        self._g.barrier.wait()

    def barrier(self) -> None:
        """Global barrier: threads sync, thread 0 joins the process-level
        barrier, threads sync again."""
        self.thread_barrier()
        # leader pattern: only thread 0 joins the process barrier; the
        # surrounding thread barriers keep every thread's schedule
        # aligned, so the rank-conditional collective cannot diverge
        # mp4j-lint: disable=R1 (leader collective bracketed by barriers)
        if self._tr == 0 and self._g.proc is not None:
            self._g.proc.barrier()
        self.thread_barrier()

    def info(self, msg: str) -> None:
        if self._g.proc is not None:
            with self._g.lock:
                self._g.proc.info(f"[t{self._tr}] {msg}")
        else:
            super().info(msg)

    def error(self, msg: str) -> None:
        if self._g.proc is not None:
            with self._g.lock:
                self._g.proc.error(f"[t{self._tr}] {msg}")
        else:
            super().error(msg)

    def stats(self) -> dict[str, dict[str, float]]:
        """Per-collective transport counters: the group's intra-process
        merge counters summed with the shared process slave's wire
        counters (schema: :mod:`ytk_mp4j_tpu_torch.utils.stats`)."""
        snaps = [self._g.comm_stats.snapshot()]
        if self._g.proc is not None:
            snaps.append(self._g.proc.stats())
        return merge_snapshots(*snaps)

    def progress(self) -> dict:
        """The group's telemetry progress record (schema:
        obs.telemetry). ``seq`` counts outermost collective calls
        across ALL threads of the group — a per-group, still
        monotonically increasing, sequence number."""
        return self._g.comm_stats.progress()

    def audit_records(self) -> list[dict]:
        """The shared process slave's audit record ring.
        In a hybrid job every thread-level collective funnels through
        ONE process-level collective on thread 0, and THAT call is
        what the audit plane records (the process slave owns the wire)
        — so any thread may read/dump the group's audit state, exactly
        like :meth:`stats`. Standalone groups have no wire and no
        audit ring; they return []."""
        if self._g.proc is not None:
            return self._g.proc.audit_records()
        return []

    def dump_audit(self, root: str) -> str | None:
        """Write the group's replay bundle file (see
        ``ProcessCommSlave.dump_audit``); None for standalone groups
        or ``MP4J_AUDIT=off``. Idempotent across threads — every
        thread writes the same process-rank file."""
        if self._g.proc is not None:
            return self._g.proc.dump_audit(root)
        return None

    def _on_collective_error(self, name: str, exc: BaseException) -> None:
        """Forward a failed collective to the process slave's DIAGNOSE
        path so the master's hang diagnosis also covers hybrid jobs."""
        if self._g.proc is not None:
            self._g.proc._on_collective_error(
                f"{name}[t{self._tr}]", exc)

    def close(self, code: int = 0) -> None:
        """Close the process-level connection (idempotent; safe to call
        once per thread or once per process — no barrier, so a single
        thread closing sequentially cannot deadlock). The highest code
        seen before the underlying close wins."""
        with self._g.lock:
            self._g.max_code = max(self._g.max_code, int(code))
            self._g.pending_closes -= 1
            if self._g.pending_closes <= 0 and not self._g.closed:
                self._g.closed = True
                if self._g.proc is not None:
                    self._g.proc.close(self._g.max_code)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    @staticmethod
    def _detach(buf):
        """Copy a deposited slot out of the caller's buffer (slots hold
        VIEWS of caller arrays until first write; merging in place
        would corrupt a sibling thread's input)."""
        return buf.copy() if isinstance(buf, np.ndarray) else list(buf)

    def _tree_reduce_slots(self, operator: Operator) -> None:
        """Pairwise-parallel intra-process reduction of the deposited
        slots into thread 0's slot: round k merges ``slot[t + k]`` into
        ``slot[t]`` for ``t % 2k == 0``, every eligible thread merging
        CONCURRENTLY (numpy's reduce loops release the GIL), so the
        intra-process reduce runs O(log T) rounds instead of the old
        leader-serial O(T) loop — the reference's simple pattern, but
        scalable past a handful of threads. Must be called by EVERY
        thread between deposit and the leader phase (each round ends on
        the shared barrier; all threads run the same barrier count).
        Thread 0's slot ends DETACHED from its input view, like the
        leader's copy did.

        Memory: round 1 detaches up to ceil(T/2) slots concurrently
        (the old serial leader held ONE working copy), so transient RSS
        for a [L] collective is ~T/2 x L elements — the price of the
        parallel merge; size thread groups accordingly on memory-tight
        hosts."""
        slots = self._g.slots
        T = self._g.thread_num
        tr = self._tr
        detached = False
        if tr == 0:
            # barrier-delimited: thread t writes only slot t, and reads
            # slot t+k only after the round barrier below has published it
            # mp4j-lint: disable=R3 (disjoint slot ownership per round)
            slots[0] = self._detach(slots[0])
            detached = True
        k = 1
        while k < T:
            if tr % (2 * k) == 0 and tr + k < T:
                acc = slots[tr]
                if not detached:
                    acc = self._detach(acc)
                    detached = True
                self._merge_into(operator, acc, slots[tr + k])
                # mp4j-lint: disable=R3 (disjoint slot ownership per round)
                slots[tr] = acc
            self.thread_barrier()
            k *= 2

    def _fan_in_out(self, deposit, leader, collect, tree_operator=None):
        """The hybrid pattern: all threads deposit, thread 0 runs
        ``leader`` (merging + process collective), all threads collect.
        With ``tree_operator`` the deposits are pre-reduced into slot 0
        by the pairwise tree above and ``leader`` gets merged slots."""
        # barrier-delimited: each thread writes only its own slot, and
        # no slot is read before the barrier below publishes them all
        # mp4j-lint: disable=R3 (own-slot write before the deposit barrier)
        self._g.slots[self._tr] = deposit()
        self.thread_barrier()
        if tree_operator is not None:
            self._tree_reduce_slots(tree_operator)
        if self._tr == 0:
            # thread 0 alone writes result, between the deposit barrier
            # and the publish barrier below — no concurrent reader exists
            # mp4j-lint: disable=R3 (leader write between barriers)
            self._g.result = leader(self._g.slots)
        self.thread_barrier()
        out = collect(self._g.result)
        # final barrier so thread 0 can't start the next collective and
        # overwrite shared state while others are still reading
        self.thread_barrier()
        return out

    def _coarse_ranges(self, ranges):
        """Merge per-global-rank ranges into per-process ranges (blocked
        layout makes each process's range contiguous)."""
        T = self._g.thread_num
        return [(ranges[p * T][0], ranges[p * T + T - 1][1])
                for p in range(self._g.proc_num)]

    def _merge_into(self, operator, acc, src):
        if isinstance(acc, np.ndarray):
            t0 = time.perf_counter()
            native.reduce_into(operator, acc, src)
            self._g.comm_stats.add("reduce_seconds",
                                   time.perf_counter() - t0)
        else:
            for i in range(len(acc)):
                acc[i] = operator.np_fn(acc[i], src[i])
        return acc

    @staticmethod
    def _copied_map(m: dict) -> dict:
        """Per-thread value copies: threads must never alias the same
        mutable value objects after a map collective (in-place updates on
        one thread would corrupt another's map)."""
        return {k: (v.copy() if isinstance(v, np.ndarray) else v)
                for k, v in m.items()}

    def _decompose_root(self, root: int):
        if not (0 <= root < self.slave_num):
            raise Mp4jError(f"root {root} out of range [0, {self.slave_num})")
        return divmod(root, self._g.thread_num)  # (proc, thread)

    # ------------------------------------------------------------------
    # dense-array collectives
    # ------------------------------------------------------------------
    def allreduce_array(self, arr, operand: Operand = Operands.FLOAT,
                        operator: Operator = Operators.SUM,
                        from_: int = 0, to: int | None = None,
                        algo: str = "auto"):
        """Intra-process tree into thread 0, process allreduce, fan out.

        ``algo`` selects the process-level algorithm, as on
        ProcessCommSlave: ``"auto"`` (default, size-aware selection),
        ``"tree"``, ``"rhd"``, or ``"ring"``."""
        hi = to if to is not None else len(arr)
        lo = from_

        def deposit():
            return arr[lo:hi]

        def leader(slots):
            acc = slots[0]          # tree-merged, detached
            if self._g.proc is not None:
                self._g.proc.allreduce_array(acc, operand, operator,
                                             algo=algo)
            # mp4j-lint: disable=R6 (slot 0 detached by _tree_reduce_slots)
            return acc

        def collect(result):
            arr[lo:hi] = result
            return arr

        return self._fan_in_out(deposit, leader, collect,
                                tree_operator=operator)

    def reduce_array(self, arr, operand: Operand = Operands.FLOAT,
                     operator: Operator = Operators.SUM, root: int = 0,
                     from_: int = 0, to: int | None = None):
        root_proc, root_thread = self._decompose_root(root)
        hi = to if to is not None else len(arr)
        lo = from_

        def deposit():
            return arr[lo:hi]

        def leader(slots):
            acc = slots[0]          # tree-merged, detached
            if self._g.proc is not None:
                self._g.proc.reduce_array(acc, operand, operator,
                                          root=root_proc)
            # mp4j-lint: disable=R6 (slot 0 detached by _tree_reduce_slots)
            return acc

        def collect(result):
            if (self._g.proc_rank == root_proc
                    and self._tr == root_thread):
                arr[lo:hi] = result
            return arr

        return self._fan_in_out(deposit, leader, collect,
                                tree_operator=operator)

    def broadcast_array(self, arr, operand: Operand = Operands.FLOAT,
                        root: int = 0, from_: int = 0,
                        to: int | None = None):
        root_proc, root_thread = self._decompose_root(root)
        hi = to if to is not None else len(arr)
        lo = from_

        def deposit():
            # only the root thread's payload matters
            return arr[lo:hi]

        def leader(slots):
            buf = self._detach(slots[root_thread]
                               if self._g.proc_rank == root_proc
                               else slots[0])
            if self._g.proc is not None:
                self._g.proc.broadcast_array(buf, operand, root=root_proc)
            return buf

        def collect(result):
            arr[lo:hi] = result
            return arr

        return self._fan_in_out(deposit, leader, collect)

    def allgather_array(self, arr, operand: Operand = Operands.FLOAT,
                        ranges=None, algo: str = "auto"):
        """``algo`` selects the process-level schedule ("auto"/"ring"/
        "tree"), as on ProcessCommSlave."""
        N = self.slave_num
        if ranges is None:
            ranges = meta.partition_range(0, len(arr), N)
        if len(ranges) != N:
            raise Mp4jError(f"need {N} ranges, got {len(ranges)}")
        my_s, my_e = ranges[self.rank]

        def deposit():
            return (my_s, my_e, arr[my_s:my_e])

        def leader(slots):
            if isinstance(slots[0][2], np.ndarray):
                full = np.zeros(len(arr), dtype=operand.dtype)
            else:
                full = [None] * len(arr)
            for (s, e, seg) in slots:
                full[s:e] = seg
            if self._g.proc is not None:
                self._g.proc.allgather_array(
                    full, operand, ranges=self._coarse_ranges(ranges),
                    algo=algo)
            return full

        def collect(result):
            lo = ranges[0][0]
            hi = ranges[-1][1]
            arr[lo:hi] = result[lo:hi]
            return arr

        return self._fan_in_out(deposit, leader, collect)

    def gather_array(self, arr, operand: Operand = Operands.FLOAT,
                     root: int = 0, ranges=None):
        root_proc, root_thread = self._decompose_root(root)
        N = self.slave_num
        if ranges is None:
            ranges = meta.partition_range(0, len(arr), N)
        my_s, my_e = ranges[self.rank]

        def deposit():
            return (my_s, my_e, arr[my_s:my_e])

        def leader(slots):
            if isinstance(slots[0][2], np.ndarray):
                full = np.zeros(len(arr), dtype=operand.dtype)
            else:
                full = [None] * len(arr)
            for (s, e, seg) in slots:
                full[s:e] = seg
            if self._g.proc is not None:
                self._g.proc.gather_array(
                    full, operand, root=root_proc,
                    ranges=self._coarse_ranges(ranges))
            return full

        def collect(result):
            if (self._g.proc_rank == root_proc
                    and self._tr == root_thread):
                lo, hi = ranges[0][0], ranges[-1][1]
                arr[lo:hi] = result[lo:hi]
            return arr

        return self._fan_in_out(deposit, leader, collect)

    def scatter_array(self, arr, operand: Operand = Operands.FLOAT,
                      root: int = 0, ranges=None):
        root_proc, root_thread = self._decompose_root(root)
        N = self.slave_num
        if ranges is None:
            ranges = meta.partition_range(0, len(arr), N)

        def deposit():
            return arr

        def leader(slots):
            full = self._detach(slots[root_thread]
                                if self._g.proc_rank == root_proc
                                else slots[0])
            if self._g.proc is not None:
                self._g.proc.scatter_array(
                    full, operand, root=root_proc,
                    ranges=self._coarse_ranges(ranges))
            return full

        def collect(result):
            s, e = ranges[self.rank]
            arr[s:e] = result[s:e]
            return arr

        return self._fan_in_out(deposit, leader, collect)

    def reduce_scatter_array(self, arr, operand: Operand = Operands.FLOAT,
                             operator: Operator = Operators.SUM,
                             ranges=None, algo: str = "auto"):
        """``algo`` selects the process-level schedule ("auto"/"ring"/
        "tree"), as on ProcessCommSlave."""
        N = self.slave_num
        if ranges is None:
            ranges = meta.partition_range(0, len(arr), N)

        def deposit():
            return arr

        def leader(slots):
            acc = slots[0]          # tree-merged, detached
            if self._g.proc is not None:
                self._g.proc.reduce_scatter_array(
                    acc, operand, operator,
                    ranges=self._coarse_ranges(ranges), algo=algo)
            # mp4j-lint: disable=R6 (slot 0 detached by _tree_reduce_slots)
            return acc

        def collect(result):
            s, e = ranges[self.rank]
            arr[s:e] = result[s:e]
            return arr

        return self._fan_in_out(deposit, leader, collect,
                                tree_operator=operator)

    # ------------------------------------------------------------------
    # map collectives
    # ------------------------------------------------------------------
    def allreduce_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                      operator: Operator = Operators.SUM) -> dict:
        def deposit():
            return dict(d)

        def leader(slots):
            acc: dict = {}
            for m in slots:
                for k, v in m.items():
                    acc[k] = operator.np_fn(acc[k], v) if k in acc else v
            if self._g.proc is not None:
                self._g.proc.allreduce_map(acc, operand, operator)
            return acc

        def collect(result):
            d.clear()
            d.update(self._copied_map(result))
            return d

        return self._fan_in_out(deposit, leader, collect)

    def reduce_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                   operator: Operator = Operators.SUM, root: int = 0) -> dict:
        root_proc, root_thread = self._decompose_root(root)

        def deposit():
            return dict(d)

        def leader(slots):
            acc: dict = {}
            for m in slots:
                for k, v in m.items():
                    acc[k] = operator.np_fn(acc[k], v) if k in acc else v
            if self._g.proc is not None:
                self._g.proc.reduce_map(acc, operand, operator,
                                        root=root_proc)
            return acc

        def collect(result):
            if (self._g.proc_rank == root_proc
                    and self._tr == root_thread):
                d.clear()
                d.update(self._copied_map(result))
            return d

        return self._fan_in_out(deposit, leader, collect)

    def broadcast_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                      root: int = 0) -> dict:
        root_proc, root_thread = self._decompose_root(root)

        def deposit():
            return dict(d)

        def leader(slots):
            buf = dict(slots[root_thread
                             if self._g.proc_rank == root_proc else 0])
            if self._g.proc is not None:
                self._g.proc.broadcast_map(buf, operand, root=root_proc)
            return buf

        def collect(result):
            d.clear()
            d.update(self._copied_map(result))
            return d

        return self._fan_in_out(deposit, leader, collect)

    def _disjoint_union_slots(self, slots, what: str) -> dict:
        """Disjoint union of the threads' deposited maps; a duplicate
        raises naming the key and BOTH owner GLOBAL ranks (contract
        parity with ProcessCommSlave.gather_map). The conflict hunt
        runs only on the error path — the fast path stays one
        update+len check per slot."""
        acc: dict = {}
        total = 0
        for m in slots:
            total += len(m)
            acc.update(m)
        if len(acc) != total:
            base = self._g.proc_rank * self._g.thread_num
            seen: dict = {}
            for t, m in enumerate(slots):
                for k in m:
                    if k in seen:
                        raise Mp4jError(
                            f"{what}: duplicate key {k!r} owned by "
                            f"global ranks {base + seen[k]} and "
                            f"{base + t}; use reduce_map to combine")
                    seen[k] = t
        return acc

    def gather_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                   root: int = 0) -> dict:
        root_proc, root_thread = self._decompose_root(root)

        def deposit():
            return dict(d)

        def leader(slots):
            acc = self._disjoint_union_slots(slots, "gather_map")
            if self._g.proc is not None:
                self._g.proc.gather_map(acc, operand, root=root_proc)
            return acc

        def collect(result):
            if (self._g.proc_rank == root_proc
                    and self._tr == root_thread):
                d.clear()
                d.update(self._copied_map(result))
            return d

        return self._fan_in_out(deposit, leader, collect)

    def allgather_map(self, d: dict,
                      operand: Operand = Operands.DOUBLE) -> dict:
        def deposit():
            return dict(d)

        def leader(slots):
            acc = self._disjoint_union_slots(slots, "allgather_map")
            if self._g.proc is not None:
                self._g.proc.allgather_map(acc, operand)
            return acc

        def collect(result):
            d.clear()
            d.update(self._copied_map(result))
            return d

        return self._fan_in_out(deposit, leader, collect)

    def scatter_map(self, d: dict, operand: Operand = Operands.DOUBLE,
                    root: int = 0) -> dict:
        """Rank r keeps the subset of ``root``'s entries whose keys hash
        to global rank r (meta.key_partition over slave_num).

        Each process receives only its own threads' share over the wire
        (the process-level scatter places by ``global_rank // T``), then
        threads split it through shared memory."""
        root_proc, root_thread = self._decompose_root(root)
        N = self.slave_num
        T = self._g.thread_num

        def deposit():
            return dict(d)

        def leader(slots):
            buf = dict(slots[root_thread
                             if self._g.proc_rank == root_proc else 0])
            if self._g.proc is not None:
                self._g.proc.scatter_map(
                    buf, operand, root=root_proc,
                    partitioner=lambda k: meta.key_partition(k, N) // T)
            return buf

        def collect(result):
            mine = {k: v for k, v in result.items()
                    if meta.key_partition(k, N) == self.rank}
            d.clear()
            d.update(self._copied_map(mine))
            return d

        return self._fan_in_out(deposit, leader, collect)

    def reduce_scatter_map(self, d: dict,
                           operand: Operand = Operands.DOUBLE,
                           operator: Operator = Operators.SUM) -> dict:
        """Key-union reduce, keep this global rank's hash share. Tree
        reduce to global rank 0, then partitioned scatter (each process
        only receives its threads' share)."""
        self.reduce_map(d, operand, operator, root=0)
        return self.scatter_map(d, operand, root=0)

    # ------------------------------------------------------------------
    # nonblocking collectives: the thread backend's
    # collectives are shared-memory synchronous — every thread of the
    # group must enter the same call before any can leave — so the i*
    # twins execute eagerly and return resolved futures; the futures-
    # conformance contract (i*().wait() == blocking, bit-for-bit)
    # holds trivially, and portable code keeps one API across backends.
    # ------------------------------------------------------------------
    def iallreduce(self, arr, operand: Operand = Operands.FLOAT,
                   operator: Operator = Operators.SUM,
                   from_: int = 0, to: int | None = None,
                   algo: str = "auto"):
        """Eager nonblocking :meth:`allreduce_array` (resolved
        future)."""
        return progress_mod.eager_future(
            self, "allreduce_array", arr, operand, operator,
            from_=from_, to=to, algo=algo)

    def ireduce_scatter(self, arr, operand: Operand = Operands.FLOAT,
                        operator: Operator = Operators.SUM,
                        ranges=None, algo: str = "auto"):
        """Eager nonblocking :meth:`reduce_scatter_array`."""
        return progress_mod.eager_future(
            self, "reduce_scatter_array", arr, operand, operator,
            ranges=ranges, algo=algo)

    def iallgather(self, arr, operand: Operand = Operands.FLOAT,
                   ranges=None, algo: str = "auto"):
        """Eager nonblocking :meth:`allgather_array`."""
        return progress_mod.eager_future(
            self, "allgather_array", arr, operand, ranges=ranges,
            algo=algo)

    def igather(self, arr, operand: Operand = Operands.FLOAT,
                root: int = 0, ranges=None):
        """Eager nonblocking :meth:`gather_array`."""
        return progress_mod.eager_future(
            self, "gather_array", arr, operand, root=root,
            ranges=ranges)

    def iallreduce_map(self, d: dict,
                       operand: Operand = Operands.DOUBLE,
                       operator: Operator = Operators.SUM):
        """Eager nonblocking :meth:`allreduce_map`."""
        return progress_mod.eager_future(
            self, "allreduce_map", d, operand, operator)

    def wait_all(self, timeout: float | None = None) -> None:
        """Collective-boundary drain; the eager backend never has
        outstanding work — no-op, kept for portable code."""


# per-collective tracing (utils.trace; zero overhead when disabled)
trace.instrument(ThreadCommSlave)
