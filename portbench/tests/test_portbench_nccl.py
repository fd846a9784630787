"""The four-card cell (``gbdt-higgs.nccl4``: the trainer over
``global_mesh()``, one rank a card) rehearsed on the CPU as four gloo
ranks in four processes: a small run is correct, reports its end-to-end
metrics and holds round 0 bitwise to ``make_mesh(4)``; the control fails
the cell's limits; a rank's partial left out of the fold makes a run not
correct; a child rank does not outlive rank 0.

The cell's files are in place but its entry is not in BENCHMARK.json
yet: its ``trees_per_s`` spreads wider than the benchmark's check admits
(PERF.md §7). The tests register the entry it is to have."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import REPO, SEED
from portbench import control, harness

from ytk_mp4j_tpu_torch.models import gbdt

CELL = "gbdt-higgs.nccl4"
SMALL = {"n_rows": 4000}           # 1000 rows a rank
with open(os.path.join(REPO, "portbench", "workloads", CELL + ".json")) as f:
    SPEC = json.load(f)
ENTRY = {"name": CELL, "config": SPEC["config"], "traffic": "nccl4",
         "chips": SPEC["chips"], "why": SPEC["why"]}


@pytest.fixture(autouse=True)
def _register(monkeypatch):
    """BENCHMARK.json as the harness reads it, with the cell's entry and
    the cell on ``trees_per_s``'s list."""
    bench = harness.benchmark()
    bench["workloads"].append(ENTRY)
    (e2e,) = [m for m in bench["end_to_end"] if m["name"] == "trees_per_s"]
    e2e["workloads"].append(CELL)
    monkeypatch.setattr(harness, "benchmark", lambda: bench)


def small_run(seed=SEED, seconds=0.5):
    return harness.execute(CELL, seed, seconds, False, time.perf_counter(),
                           device="cpu", look_for_chips=False, config=SMALL)


def test_the_cell_takes_four_chips_and_its_driver():
    bench = harness.benchmark()
    cell = harness.find_cell(bench, CELL)
    assert cell["chips"] == 4 and cell["spec"]["traffic"]["ranks"] == 4
    assert cell["spec"]["limits"]["tree_mismatch"] == 0
    assert len(ENTRY["why"]) <= 200
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)


def test_a_small_run_over_four_gloo_ranks_is_correct():
    out = small_run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "trees_per_s"}
    assert out["checks"]["tree_mismatch"]["value"] == 0
    assert out["device"]["count"] == 4


def test_the_control_is_not_correct():
    nums = control.readings(CELL, SEED, "cpu", config=SMALL)
    limits = harness.find_cell(harness.benchmark(), CELL)["spec"]["limits"]
    assert nums and set(nums[0]) == set(limits)
    assert control.fails(nums, limits)
    assert all(d["tree_mismatch"] > 0 for d in nums)


def test_a_rank_left_out_of_the_fold_makes_the_run_not_correct(
        monkeypatch):
    """Rank 0 folds every rank's partials but the last one's."""
    from ytk_mp4j_tpu_torch.comm.distributed import all_gather_rows
    from ytk_mp4j_tpu_torch.ops import collectives as coll

    def fault(x, n_members, group):
        every = all_gather_rows(x, group)[:-1]
        return coll.reduce_all(every.reshape(
            (n_members * every.shape[0], -1) + tuple(x.shape[1:])))
    monkeypatch.setattr(gbdt, "_fold_across", fault)
    out = small_run()
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


def test_a_child_rank_dies_with_its_parent(tmp_path):
    """A child rank whose parent is gone exits at once, though its
    rendezvous would have waited for the others; also where the parent
    ended while the child was still starting."""
    driver = os.path.join(REPO, "portbench", "drivers", "gbdt_nccl.py")
    spec_path = str(tmp_path / "spec.json")
    # the parent writes the spec with its own pid, as rank 0 does
    parent = ("import json, os, subprocess, sys, time;"
              f"json.dump({{'config': {{}}, 'traffic': {{}}, 'seed': 1,"
              f" 'device': 'cpu', 'store': {str(tmp_path / 'store')!r},"
              " 'world': 2, 'parent': os.getpid(),"
              " 'deadline': time.time() + 600},"
              f" open({spec_path!r}, 'w'));"
              f"p = subprocess.Popen([sys.executable, {driver!r},"
              f" {spec_path!r}, '1'],"
              " stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL);"
              "print(p.pid, flush=True); sys.stdin.read()")
    for wait_s in (0.0, 3.0):
        proc = subprocess.Popen([sys.executable, "-c", parent],
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        pid = int(proc.stdout.readline())
        time.sleep(wait_s)
        assert _alive(pid)         # starting, or waiting at its rendezvous
        proc.stdin.close()         # the parent ends
        proc.wait(timeout=60)
        deadline = time.time() + 60
        while time.time() < deadline and _alive(pid):
            time.sleep(0.5)
        assert not _alive(pid), wait_s


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, or a pid now another program's,
    counts as gone)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            status = f.read()
    except OSError:
        return False
    return "State:\tZ" not in status and "gbdt_nccl" in open(
        f"/proc/{pid}/cmdline").read()


@pytest.mark.parametrize("name", ["gbdt.fold_ms_per_tree",
                                  "device.idle_pct.train",
                                  "dist.exchange_ms_per_tree"])
def test_its_traced_metrics_read_nothing_without_a_trace(name):
    reader = harness.load("metrics", name)
    assert reader.read(harness.Run(None, 0.0, {}, None, {"trees": 3})) is None


def test_rank_0_leaves_the_group_before_it_waits_for_its_children(
        monkeypatch):
    """NCCL's destroy waits for every rank: rank 0 must be in it while its
    children are, not wait for them to exit first."""
    import types

    import torch

    driver = harness.load("drivers", "gbdt_nccl")
    order = []

    def finish(st):
        order.append("finish")
        raise StopIteration
    monkeypatch.setattr(driver.dist, "broadcast", lambda *a, **k: None)
    monkeypatch.setattr(driver, "_collect",
                        lambda st, dev: order.append("collect"))
    monkeypatch.setattr(driver, "_leave_or_die",
                        lambda st: order.append("leave"))
    monkeypatch.setattr(driver, "_finish", finish)
    with pytest.raises(StopIteration):
        driver.check(types.SimpleNamespace(rounds=0,
                                           dev=torch.device("cpu")))
    assert order == ["collect", "leave", "finish"]


def test_a_hung_leave_kills_the_children_and_fails_the_run(tmp_path):
    """Past its deadline to leave the process group, rank 0 kills its
    children and exits with an error instead of hanging."""
    driver = os.path.join(REPO, "portbench", "drivers", "gbdt_nccl.py")
    script = (
        "import importlib.util, subprocess, sys, time, types;"
        f"spec = importlib.util.spec_from_file_location('d', {driver!r});"
        "d = importlib.util.module_from_spec(spec);"
        "spec.loader.exec_module(d);"
        "d.LEAVE_S = 0.5;"
        "d._leave = lambda dev: time.sleep(60);"
        "child = subprocess.Popen([sys.executable, '-c',"
        " 'import time; time.sleep(60)']);"
        "print(child.pid, flush=True);"
        f"d._leave_or_die(types.SimpleNamespace(procs=[child], dev=None,"
        f" tmp={str(tmp_path / 'run')!r}))")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 4, proc.stderr
    assert "leaving the process group took over" in proc.stderr
    pid = int(proc.stdout.split()[0])
    assert not os.path.exists(f"/proc/{pid}") or "State:\tZ" in open(
        f"/proc/{pid}/status").read()
