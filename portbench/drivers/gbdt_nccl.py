"""GBDT boosting rounds over processes: one rank a card, the trainer over
``comm.distributed.global_mesh()``.

Rank 0 is the harness's process, on the run's device (``cuda:0``). Set-up
starts ranks 1 .. ranks-1 as child processes of this file (``python
gbdt_nccl.py <spec.json> <rank>``, rank r on ``cuda:r``), which meet rank
0 through a ``FileStore`` in a temporary directory (NCCL; gloo where the
run's device is the CPU). Every rank draws the same rows
(``gbdt_train.make_data``: from the configuration's ``data_seed``, in an
order drawn from the seed), stages its own block of them
(``GBDTTrainer.shard_data`` over the global mesh) and runs round 0 as its
warm-up. Each round of the loop, rank 0 sends the others one small
broadcast, a command: run, run and keep (a slot of the judged sample), or
stop; then every rank runs ``train_tree_shard`` over its rows, and every
level's histogram partials and the leaf sums cross the cards
(``_fold_across``: an all-gather in rank order).

After the window rank 0 stops the ranks, gathers every rank's partials
and margins of the kept rounds, and judges them with
``reference/gbdt.py``'s ``judge_round`` over the full rows, the ranks as
its members. One more number, ``tree_mismatch``: the elements of round
0's tree (feat, bin, dir, leaf) that differ from the same round over
``make_mesh(ranks)`` in rank 0's process, which must be none (the process
path is bitwise the one-process mesh).

Shutdown: NCCL's ``destroy_process_group`` waits for every rank, so all
ranks leave together (:func:`_leave`: a barrier, then the destroy), and
only then does rank 0 wait for the child processes to exit.

Deadlines: every collective times out after ``TIMEOUT_S``; a child rank
dies with rank 0 (``PR_SET_PDEATHSIG``, and a watch of its parent) and
past its own deadline; rank 0 kills the children and exits with an error
where leaving the group takes longer than ``LEAVE_S``, and kills what is
left at exit.

Traffic: ``ranks``, ``checked_rounds``.
"""

from __future__ import annotations

import atexit
import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench.drivers import gbdt_train as base  # noqa: E402
from portbench.reference import gbdt as ref  # noqa: E402
from portbench.sampling import Reservoir  # noqa: E402

TIMEOUT_S = 300.0        # a collective that waits longer raises
LIFE_S = 900.0           # a child rank's deadline beyond the window
LEAVE_S = 120.0          # rank 0's deadline to leave the process group
STOP, RUN, KEEP = 0, 1, 2


def _device(kind: str, rank: int):
    return torch.device("cuda", rank) if kind == "cuda" else torch.device(
        "cpu")


class _Capture:
    """Wraps the trainer's histogram call and its fold across the ranks,
    keeping copies of their outputs while ``on``."""

    def __init__(self, gbdt):
        self.gbdt = gbdt
        self.on = False
        self.hists, self.folds = [], []
        real_hist, real_fold = gbdt.build_histograms, gbdt._fold_across

        def hist(*args, **kwargs):
            out = real_hist(*args, **kwargs)
            if self.on:
                self.hists.append(tuple(t.clone() for t in out))
            return out

        def fold(*args, **kwargs):
            out = real_fold(*args, **kwargs)
            if self.on:
                self.folds.append(out.clone())
            return out

        self.real = (real_hist, real_fold)
        gbdt.build_histograms, gbdt._fold_across = hist, fold

    def restore(self):
        self.gbdt.build_histograms, self.gbdt._fold_across = self.real

    def start(self):
        self.on, self.hists, self.folds = True, [], []

    def stop(self, depth: int):
        """(partials, folded) of each level: one histogram call and one
        fold of the stacked g and h planes a level (the last fold, the
        leaf sums)."""
        self.on = False
        if len(self.hists) != depth or len(self.folds) != depth + 1:
            raise RuntimeError(
                f"a round made {len(self.hists)} histogram calls and "
                f"{len(self.folds)} folds, not {depth} and {depth + 1}: "
                "its levels cannot be judged")
        return self.hists, [(f[:, 0], f[:, 1]) for f in self.folds[:depth]]


def _prepare(cfg, traffic, seed, dev, world):
    """A rank's state: the rows, the trainer over the global mesh, its
    block staged, round 0 run and kept."""
    from ytk_mp4j_tpu_torch.comm.distributed import global_mesh
    from ytk_mp4j_tpu_torch.models import gbdt
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTTrainer

    st = types.SimpleNamespace(cfg=cfg, gbdt=gbdt, world=world)
    st.bins, st.y = base.make_data(cfg, seed, dev)
    st.trainer = GBDTTrainer(base._program_config(cfg),
                             mesh=global_mesh(dev))
    st.dbins, st.dy, st.preds, st.dw = st.trainer.shard_data(st.bins, st.y)
    st.model_round = 0
    st.capture = _Capture(gbdt)
    st.kept = [None] * traffic["checked_rounds"]
    st.trees, st.rounds = [], 0
    st.start = base._round(st, keep=True)
    _sync(dev)
    st.rounds = 0
    st.trees.clear()
    return st


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leave(dev):
    """Leave the process group with the other ranks: NCCL's destroy waits
    for every rank, so every rank calls this at the same point."""
    dist.all_reduce(torch.zeros(1, device=dev))     # the barrier
    _sync(dev)
    dist.destroy_process_group()


def _gather(t, world):
    """Every rank's ``t`` concatenated in rank order along dim 0."""
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def _collect(st, dev):
    """After the stop: the kept slots (rank 0's list, broadcast), then
    each kept round's margins and partials gathered over the ranks, in
    the order [round 0] + the kept slots. Returns those rounds on every
    rank, whole on rank 0."""
    slots = torch.tensor([-1 if x is None else i
                          for i, x in enumerate(st.kept)], device=dev)
    dist.broadcast(slots, 0)
    items = [st.start] + [st.kept[i] for i in slots.tolist() if i >= 0]
    out = []
    for item in items:
        whole = dict(item)
        whole["preds_in"] = _gather(item["preds_in"], st.world)
        whole["preds_out"] = _gather(item["preds_out"], st.world)
        whole["partials"] = [tuple(_gather(p, st.world) for p in level)
                             for level in item["partials"]]
        out.append(whole)
    return out


# ----------------------------------------------------------------------
# rank 0: the harness's driver
# ----------------------------------------------------------------------
def setup(ctx):
    from ytk_mp4j_tpu_torch.comm.distributed import init_distributed

    world = ctx.traffic["ranks"]
    dev = _device(torch.device(ctx.device).type, 0)
    tmp = tempfile.mkdtemp(prefix="portbench-nccl-")
    spec = {"config": ctx.config, "traffic": ctx.traffic, "seed": ctx.seed,
            "device": dev.type, "store": os.path.join(tmp, "store"),
            "world": world, "parent": os.getpid(),
            "deadline": time.time() + ctx.seconds + LIFE_S}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    procs = []
    for r in range(1, world):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec_path, str(r)],
            stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            cwd=REPO))
        log.close()
    atexit.register(_reap, procs, tmp)
    init_distributed(init_method="file://" + spec["store"],
                     num_processes=world, process_id=0, device=dev,
                     timeout=TIMEOUT_S)
    st = _prepare(ctx.config, ctx.traffic, ctx.seed, dev, world)
    st.ctx, st.dev, st.procs, st.tmp = ctx, dev, procs, tmp
    st.sample = Reservoir(ctx.traffic["checked_rounds"], ctx.seed)
    st.sample.items = st.kept
    # the commands, made once: a broadcast from rank 0 only reads them
    st.commands = {RUN: torch.tensor([RUN, 0], device=dev)}
    st.commands.update({(KEEP, i): torch.tensor([KEEP, i], device=dev)
                        for i in range(len(st.kept))})
    return st


def step(st):
    slot = st.sample.slot()
    cmd = st.commands[RUN] if slot is None else st.commands[KEEP, slot]
    dist.broadcast(cmd, 0)
    kept = base._round(st, keep=slot is not None)
    if slot is not None:
        st.kept[slot] = kept


def drain(st):
    _sync(st.dev)


def record(st):
    return {"trees": st.rounds}


def probe(st):
    return base._Probe(st)


def traced_items(st, items):
    return {"trees": len(items["trees"])}


def _reap(procs, tmp):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def _finish(st):
    """Wait for the child ranks to exit; raise with a child's log where
    one failed."""
    for r, p in enumerate(st.procs, start=1):
        try:
            code = p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            code = p.wait()
        if code != 0:
            with open(os.path.join(st.tmp, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"rank {r} exited with {code}:\n{tail}")


def _mesh_round(bins, y, preds, cfg, world):
    """The same round over ``make_mesh(world)`` in this process, from the
    margins ``preds`` of every row: its tree."""
    from ytk_mp4j_tpu_torch.device import make_mesh
    from ytk_mp4j_tpu_torch.models import gbdt
    from ytk_mp4j_tpu_torch.models.gbdt import GBDTTrainer

    trainer = GBDTTrainer(base._program_config(cfg),
                          mesh=make_mesh(world, bins.device))
    dbins, dy, _, dw = trainer.shard_data(bins, y)
    return gbdt.train_tree_shard(dbins, dy, preds, trainer.cfg, weights=dw,
                                 n_members=world)[1]


def tree_mismatch(tree, want) -> int:
    """Elements of (feat, bin, dir, leaf) that differ, bit for bit."""
    return sum(int((a.to(b.device) != b).sum()) for a, b in zip(tree, want))


def _leave_or_die(st):
    """:func:`_leave` under a deadline: past ``LEAVE_S`` the children are
    killed and this process exits with an error, as a hung collective
    would otherwise hold the run."""
    def die():
        _reap(st.procs, st.tmp)
        print(f"gbdt_nccl: leaving the process group took over {LEAVE_S} s",
              file=sys.stderr, flush=True)
        os._exit(4)

    watch = threading.Timer(LEAVE_S, die)
    watch.daemon = True
    watch.start()
    try:
        _leave(st.dev)
    finally:
        watch.cancel()


def check(st):
    attempted = st.rounds
    dist.broadcast(torch.tensor([STOP, 0], device=st.dev), 0)
    rounds = _collect(st, st.dev)
    _leave_or_die(st)
    _finish(st)
    st.capture.restore()
    st.trainer = st.preds = st.dbins = st.dy = st.dw = None
    st.trees = []
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = st.ctx.limits
    mismatch = tree_mismatch(
        rounds[0]["tree"],
        _mesh_round(st.bins, st.y, torch.zeros_like(rounds[0]["preds_in"]),
                    st.cfg, st.world))
    worst, failed = {"tree_mismatch": float(mismatch)}, int(mismatch > 0)
    for r in rounds:
        nums = ref.judge_round(st.bins, st.y, r["preds_in"], r["preds_out"],
                               r["tree"], r["partials"], r["folded"], st.cfg,
                               st.world)
        failed += any(v > limits[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return attempted, failed, {k: (v, limits[k]) for k, v in worst.items()}


CONTROL_ROUNDS = 3


def control(ctx):
    """The numbers of the control, on one card: ``reference.gbdt.
    control_round`` (the round in bfloat16) in the program's place for the
    first rounds from zero margins, each judged as a program round is,
    with the ranks as its members, and its tree against the program's
    same round over ``make_mesh(ranks)``."""
    dev = torch.device(ctx.device)
    cfg, n = ctx.config, ctx.traffic["ranks"]
    bins, y = base.make_data(cfg, ctx.seed, dev)
    preds = torch.zeros(bins.shape[0], dtype=torch.float32, device=dev)
    out = []
    for _ in range(CONTROL_ROUNDS):
        new, tree, partials, folded = ref.control_round(bins, y, preds, cfg,
                                                        n)
        nums = ref.judge_round(bins, y, preds, new, tree, partials, folded,
                               cfg, n)
        nums["tree_mismatch"] = float(tree_mismatch(
            tree, _mesh_round(bins, y, preds, cfg, n)))
        out.append(nums)
        preds = new
    return out


# ----------------------------------------------------------------------
# ranks 1 .. ranks-1: child processes
# ----------------------------------------------------------------------
def _die_with_parent(parent: int, deadline: float):
    """This process ends when its parent, process ``parent``, does (at
    once where the kernel can signal it), also where the parent was gone
    before this process got here, or past ``deadline``."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, signal.SIGKILL)            # PR_SET_PDEATHSIG
    except OSError:
        pass

    def watch():
        while True:
            if os.getppid() != parent or time.time() > deadline:
                os._exit(3)
            time.sleep(1.0)

    if os.getppid() != parent:
        os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def worker(spec_path: str, rank: int) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    _die_with_parent(spec["parent"], spec["deadline"])
    from ytk_mp4j_tpu_torch.comm.distributed import init_distributed

    torch.set_num_threads(1)
    dev = _device(spec["device"], rank)
    init_distributed(init_method="file://" + spec["store"],
                     num_processes=spec["world"], process_id=rank,
                     device=dev, timeout=TIMEOUT_S)
    st = _prepare(spec["config"], spec["traffic"], spec["seed"], dev,
                  spec["world"])
    cmd = torch.empty(2, dtype=torch.int64, device=dev)
    while True:
        dist.broadcast(cmd, 0)
        c, slot = cmd.tolist()
        if c == STOP:
            break
        kept = base._round(st, keep=c == KEEP)
        if c == KEEP:
            st.kept[slot] = kept
    _collect(st, dev)
    _leave(dev)
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], int(sys.argv[2])))
