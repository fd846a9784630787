"""Serve dispatch over the collective substrate.

A copy of ``ytk_mp4j_tpu/serve/dispatcher.py``, with its imports
re-rooted at the port; it imports nothing of the JAX package.

Two dispatch shapes cover the four model families, chosen by the
servable's ``kind``:

- **pull** (linear / FM / FFM): the parameter table is sharded by
  ``row_id % size`` across the job's ranks (the serve mirror of
  ``FMTrainer``'s sharded-table owner-routed row fetch). Per batch the
  frontend broadcasts the list of row ids its cache is missing
  (``LONG`` header + ids on the binomial tree) and the rows come back
  in ONE ``allreduce_map`` on the columnar keycodec plane — owners
  contribute their rows, ownership is disjoint, so SUM is identity
  and every rank pays one vectorized merge. A warm cache means zero
  collectives for the batch.

- **reduce** (GBDT): every example visits every tree, so the ENSEMBLE
  is sharded (round ``t % size``) and the batch itself rides the
  wire: one fixed-shape float64 ``allreduce`` announces the batch
  (the frontend's request region sums against zeros), the next one
  collects it (every rank contributes its partial margins plus a
  contributor-bitmap bit). Every round is exactly ONE allreduce of
  ONE agreed shape, which is what makes the chaos story honest — a
  replacement rank adopted mid-stream (``elastic="replace"``) joins
  the next round; the batch it could not score shows up as a bitmap
  gap, is counted ``serve/degraded_batches``, and is still DELIVERED
  (status DEGRADED), never hung.

The frontend is rank 0: it owns the :class:`MicroBatcher` (whose one
dispatch thread is the only caller of the comm — collectives are
ordered, so request concurrency must be funneled), the hot-key cache
and the latency/QPS metrics. All other ranks run :func:`serve_worker`
until the frontend's STOP round.
"""

from __future__ import annotations

import time

import numpy as np

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.obs import metrics as metrics_mod
from ytk_mp4j_tpu_torch.operands import Operands
from ytk_mp4j_tpu_torch.operators import Operators
from ytk_mp4j_tpu_torch.serve.batcher import MicroBatcher
from ytk_mp4j_tpu_torch.serve.cache import HotKeyCache, validate_version
from ytk_mp4j_tpu_torch.serve import framing
from ytk_mp4j_tpu_torch.utils import tuning

# pull-plane round ops (header slot 0)
OP_STOP = 0
OP_PULL = 1
# reduce-plane round ops (buffer slot 0; the frontend is the only
# writer of the op slot, so the summed value IS the op)
OP_BATCH = 1
OP_FLUSH = 2

_HDR = 4          # reduce buffer header slots: [op, n, seq, reserved]
_QPS_WINDOW_SECS = 5.0


class _ReduceLayout:
    """The agreed reduce-round buffer layout — a pure function of
    (max_batch, req_width, resp_width, size), identical on every rank
    (mp4j-lint R8 discipline: the shape IS the wire protocol)."""

    def __init__(self, max_batch: int, req_width: int,
                 resp_width: int, size: int):
        self.max_batch = max_batch
        self.req_width = req_width
        self.resp_width = resp_width
        self.size = size
        self.off_req = _HDR
        self.off_resp = self.off_req + max_batch * req_width
        self.off_bm = self.off_resp + max_batch * resp_width
        self.total = self.off_bm + size

    def new_buf(self) -> np.ndarray:
        return np.zeros(self.total, np.float64)

    def put_batch(self, buf, bins: np.ndarray) -> None:
        n = bins.shape[0]
        buf[self.off_req:self.off_req + n * self.req_width] = \
            bins.astype(np.float64).ravel()

    def get_batch(self, buf, n: int) -> np.ndarray:
        flat = buf[self.off_req:self.off_req + n * self.req_width]
        return np.rint(flat).astype(np.int64).reshape(
            n, self.req_width)

    def put_partials(self, buf, part: np.ndarray, rank: int) -> None:
        n = part.shape[0]
        buf[self.off_resp:self.off_resp + n * self.resp_width] = \
            part.ravel()
        buf[self.off_bm + rank] = 1.0

    def get_margins(self, buf, n: int) -> np.ndarray:
        flat = buf[self.off_resp:self.off_resp + n * self.resp_width]
        return flat.reshape(n, self.resp_width)

    def contributors(self, buf) -> int:
        return int(np.rint(
            buf[self.off_bm:self.off_bm + self.size]).sum())


class ServeFrontend:
    """Rank 0's serve plane: micro-batcher + hot-key cache + sharded
    dispatch + first-class latency/QPS/hit-rate metrics.

    ``deadline_ms`` / ``max_batch`` / ``cache_rows`` /
    ``stale_versions`` fall back to the ``MP4J_SERVE_*`` knobs.
    ``max_batch`` is JOB-wide for reduce-kind servables (it sizes the
    agreed allreduce buffer): run every rank's :func:`serve_worker`
    with the same value.
    """

    def __init__(self, comm, servable, deadline_ms=None,
                 max_batch=None, cache_rows=None, stale_versions=None,
                 version: int = 0):
        if comm.rank != 0:
            raise Mp4jError(
                f"ServeFrontend must run on rank 0, got rank "
                f"{comm.rank}")
        self._comm = comm
        self._servable = servable
        self._size = comm.slave_num
        self.version = validate_version(version)
        self._metrics = comm.metrics_registry()
        self._cache = (HotKeyCache(cache_rows, stale_versions)
                       if servable.kind == "pull" else None)
        self._layout = None
        if servable.kind == "reduce":
            self._layout = _ReduceLayout(
                tuning.serve_max_batch(max_batch),
                servable.req_width, servable.resp_width, self._size)
        self._seq = 0
        self._requests = 0
        self._stale_prev = 0
        self.degraded_batches = 0
        self._qps_win = metrics_mod.RateWindow(_QPS_WINDOW_SECS)
        self._closed = False
        self._batcher = MicroBatcher(
            self._dispatch, deadline_ms=deadline_ms,
            max_batch=max_batch, on_batch=self._note_batch,
            on_latency=self._note_latency)

    # -- request side ---------------------------------------------------
    def submit(self, req):
        """Enqueue one request payload (the family's array triplet /
        binned vector); returns a ``ServeFuture`` resolving to the
        float64 prediction vector."""
        return self._batcher.submit(req)

    def predict(self, req, timeout: float = 60.0) -> np.ndarray:
        """Blocking single-request convenience: submit + wait."""
        return self.submit(req).wait(timeout)

    def submit_frame(self, frame: bytes):
        """Framed entry (``serve/framing``): decode one request frame,
        enqueue it; returns ``(req_id, future)``."""
        family, req_id, ids, fields, vals = framing.decode_request(
            frame)
        if family != self._servable.family:
            raise Mp4jError(
                f"frame family {family!r} does not match servable "
                f"{self._servable.family!r}")
        if family == "gbdt":
            return req_id, self._batcher.submit(ids)
        return req_id, self._batcher.submit((ids, fields, vals))

    def bump_version(self) -> int:
        """Advance the live model version (a table republish): cached
        rows stamped more than ``stale_versions`` bumps ago become
        misses from here on."""
        self.version += 1
        return self.version

    def cache_stats(self) -> dict:
        return self._cache.stats() if self._cache is not None else {}

    def close(self, timeout: float = 30.0) -> None:
        """Drain the batcher, then fan the STOP round out to the
        workers (idempotent)."""
        if self._closed:
            return
        self._batcher.close(timeout=timeout)
        self._closed = True
        if self._size > 1:
            if self._servable.kind == "pull":
                header = np.asarray([OP_STOP, 0], np.int64)
                self._comm.broadcast_array(header, Operands.LONG,
                                           root=0)
            else:
                buf = self._layout.new_buf()
                buf[0] = OP_STOP
                self._comm.allreduce_array(buf, Operands.DOUBLE,
                                           Operators.SUM)

    # -- dispatch thread ------------------------------------------------
    def _dispatch(self, reqs: list) -> list:
        if self._servable.kind == "pull":
            preds = self._dispatch_pull(reqs)
        else:
            preds = self._dispatch_reduce(reqs)
        self._requests += len(reqs)
        self._qps_win.note(time.monotonic(),
                           {"requests": self._requests})
        qps = self._qps_win.rates().get("requests_per_sec", 0.0)
        self._metrics.set_gauge("serve/qps", qps)
        self._metrics.inc("serve/requests", len(reqs))
        return preds

    def _dispatch_pull(self, reqs: list) -> list:
        need: dict[int, np.ndarray | None] = {}
        for req in reqs:
            for rid in self._servable.row_ids(req):
                need.setdefault(int(rid), None)
        miss = []
        for rid in need:
            row = self._cache.lookup(rid, self.version)
            if row is None:
                miss.append(rid)
            else:
                need[rid] = row
        self._metrics.inc("serve/cache_hits",
                          len(need) - len(miss))
        self._metrics.inc("serve/cache_misses", len(miss))
        if miss:
            ids = np.asarray(sorted(miss), np.int64)
            if self._size > 1:
                header = np.asarray([OP_PULL, ids.shape[0]], np.int64)
                self._comm.broadcast_array(header, Operands.LONG,
                                           root=0)
                self._comm.broadcast_array(ids, Operands.LONG, root=0)
            pulled = _owned_rows(self._servable, ids, 0, self._size)
            if self._size > 1:
                pulled = self._comm.allreduce_map(
                    pulled, Operands.DOUBLE, Operators.SUM)
            self._metrics.inc("serve/pull_rows", len(pulled))
            for rid in miss:
                row = pulled.get(rid)
                if row is not None:
                    need[rid] = row
                    self._cache.insert(rid, row, self.version)
        self._metrics.set_gauge("serve/cache_rows", len(self._cache))
        rowmap = {k: v for k, v in need.items() if v is not None}
        if len(rowmap) != len(need):
            # rows nobody owns (out-of-vocabulary ids): delivered as
            # zero-contribution, surfaced as a degraded batch
            self.degraded_batches += 1
            self._metrics.inc("serve/degraded_batches")
        return self._servable.predict_sharded(reqs, rowmap)

    def _dispatch_reduce(self, reqs: list) -> list:
        lay = self._layout
        n = len(reqs)
        bins = np.stack([np.asarray(r, np.int64).reshape(-1)
                         for r in reqs])
        if bins.shape[1] != lay.req_width:
            raise Mp4jError(
                f"gbdt serve request width {bins.shape[1]} != "
                f"n_features {lay.req_width}")
        self._seq += 1
        if self._size > 1:
            # round 1: announce the batch
            buf = lay.new_buf()
            buf[0] = OP_BATCH
            buf[1] = float(n)
            buf[2] = float(self._seq)
            lay.put_batch(buf, bins)
            self._comm.allreduce_array(buf, Operands.DOUBLE,
                                       Operators.SUM)
        # round 2: collect — the frontend contributes its own shard
        buf = lay.new_buf()
        buf[0] = OP_FLUSH
        buf[1] = float(n)
        buf[2] = float(self._seq)
        lay.put_partials(
            buf, self._servable.partial_margins(bins, 0, self._size),
            0)
        if self._size > 1:
            self._comm.allreduce_array(buf, Operands.DOUBLE,
                                       Operators.SUM)
        if lay.contributors(buf) != self._size:
            # a replacement rank joined mid-batch and could not score
            # it: deliver the partial margin, say so
            self.degraded_batches += 1
            self._metrics.inc("serve/degraded_batches")
        return self._servable.link(lay.get_margins(buf, n))

    # -- metrics hooks (called from the batcher's dispatch thread) ------
    def _note_batch(self, n: int, reason: str, wait_secs: float) -> None:
        self._metrics.inc("serve/batches")
        if reason == "full":
            self._metrics.inc("serve/batch_full")
        elif reason == "deadline":
            self._metrics.inc("serve/batch_deadline")
        if self._cache is not None:
            # registry counters take deltas; the cache keeps lifetimes
            d = self._cache.stale - self._stale_prev
            if d:
                self._metrics.inc("serve/cache_stale", d)
                self._stale_prev = self._cache.stale

    def _note_latency(self, secs: float) -> None:
        self._metrics.observe("latency/serve_request", secs,
                              metrics_mod.LATENCY_LO,
                              metrics_mod.LATENCY_BUCKETS)


def _owned_rows(servable, ids: np.ndarray, rank: int,
                size: int) -> dict:
    """This rank's contribution to a pull round: the rows it OWNS
    (``row_id % size == rank``), fetched in one vectorized lookup.
    Ids outside the servable's table are nobody's (the frontend
    reports the batch degraded), never an exception mid-collective."""
    owned = ids[(ids % size) == rank]
    owned = owned[(owned >= 0) & (owned < servable.n_rows)]
    if owned.shape[0] == 0:
        return {}
    mat = servable.rows(owned)
    return {int(rid): mat[j] for j, rid in enumerate(owned)}


def serve_worker(comm, servable, max_batch=None) -> dict:
    """Every non-frontend rank's serve loop: answer pull / reduce
    rounds until the frontend's STOP. Returns the worker's round
    counters (handy for tests and bench bodies).

    ``max_batch`` must match the frontend's for reduce-kind servables
    (it sizes the agreed buffer) — both default to
    ``MP4J_SERVE_MAX_BATCH``, so env-configured jobs agree for free.
    """
    metrics = comm.metrics_registry()
    rank, size = comm.rank, comm.slave_num
    rounds = pulls = 0
    if servable.kind == "pull":
        while True:
            header = np.zeros(2, np.int64)
            comm.broadcast_array(header, Operands.LONG, root=0)
            if int(header[0]) == OP_STOP:
                break
            nids = int(header[1])
            ids = np.zeros(nids, np.int64)
            comm.broadcast_array(ids, Operands.LONG, root=0)
            contrib = _owned_rows(servable, ids, rank, size)
            comm.allreduce_map(contrib, Operands.DOUBLE,
                               Operators.SUM)
            rounds += 1
            pulls += nids
            metrics.inc("serve/worker_rounds")
    else:
        lay = _ReduceLayout(tuning.serve_max_batch(max_batch),
                            servable.req_width, servable.resp_width,
                            size)
        pending = None        # (bins of the announced batch)
        while True:
            buf = lay.new_buf()
            if pending is not None:
                lay.put_partials(
                    buf,
                    servable.partial_margins(pending, rank, size),
                    rank)
            comm.allreduce_array(buf, Operands.DOUBLE, Operators.SUM)
            op = int(np.rint(buf[0]))
            if op == OP_STOP:
                break
            if op == OP_BATCH:
                pending = lay.get_batch(buf, int(np.rint(buf[1])))
            else:                               # OP_FLUSH
                pending = None
            rounds += 1
            metrics.inc("serve/worker_rounds")
    return {"rounds": rounds, "pull_ids": pulls, "rank": rank}
