"""The port lints clean: ``tests/test_lint_clean.py`` over
``ytk_mp4j_tpu_torch``.

Runs the port's ``mp4j-lint`` (all rules, the port's committed baseline,
strict baseline mode) over the port's package and fails on any
unsuppressed finding, so every change to the port's comm/, ops/ and
models/ inherits the protocol checks. The whole-program rules R19-R21 run
here too, and the discovered lock-order graph must stay cycle-free; the
shared-field locksets must be clean modulo the baseline. A scratch file
seeded with a rank-conditional collective must be reported by R1 at its
file:line, so the gate has teeth.

The package's contexts are parsed once for the module (a module-scoped
fixture) where the reference's file parses them in each test.
"""

import os
import textwrap

import pytest

import ytk_mp4j_tpu_torch
from ytk_mp4j_tpu_torch.analysis import baseline as baseline_mod
from ytk_mp4j_tpu_torch.analysis import lint_paths
from ytk_mp4j_tpu_torch.analysis.cli import DEFAULT_BASELINE, main
from ytk_mp4j_tpu_torch.analysis.engine import Engine, Program
from ytk_mp4j_tpu_torch.analysis.rules import get_rules

PKG_DIR = os.path.dirname(ytk_mp4j_tpu_torch.__file__)


@pytest.fixture(scope="module")
def program():
    contexts, errors = Engine(rules=[]).load_contexts([PKG_DIR])
    assert not errors, errors
    return Program.shared(contexts)


def test_repo_lints_clean():
    result = lint_paths([PKG_DIR])
    assert result.ok, (
        "unsuppressed mp4j-lint findings (fix them or add a reasoned "
        "suppression):\n" + "\n".join(f.format() for f in result.findings))


def test_cli_exits_zero_on_repo():
    assert main([PKG_DIR]) == 0


def test_cli_exits_zero_on_repo_strict():
    # strict mode: a baseline entry matching no finding is a B001 error
    assert main([PKG_DIR, "--strict"]) == 0


def test_package_lock_order_graph_is_cycle_free(program):
    model = program.locks
    # sanity: the model sees the package's lock landscape, the port's
    # own kernel-build lock included
    displays = {d.display for d in model.locks.values()}
    assert {"Master._lock", "_Slot.lock", "Autoscaler._lock",
            "ProcessCommSlave._tel_lock", "ProcessCommSlave._master_lock",
            "_build._lock"} <= displays
    assert len(model.edges) >= 2, "order edges vanished — model blind?"
    assert model.cycles() == [], (
        "lock-order cycle introduced:\n" + "\n".join(
            "  " + " <-> ".join(model.locks[k].display for k in scc)
            for scc in model.cycles()))


def test_package_shared_field_locksets_clean_modulo_baseline(program):
    model = program.races
    assert any(r.startswith("thread:") for r in model.roots), \
        "no thread roots discovered — model blind?"
    assert "main" in model.roots
    shared = model.shared_fields()
    assert len(shared) >= 10, "shared-field discovery collapsed"
    assert "Master._slots" in {fr.display for fr in shared}
    bl = baseline_mod.load(DEFAULT_BASELINE)
    result = Engine(rules=get_rules(["R23"]),
                    baseline=bl).lint_paths([PKG_DIR])
    assert result.ok, (
        "shared field with inconsistent lockset (fix it or add a "
        "reasoned R23 suppression):\n"
        + "\n".join(f.format() for f in result.findings))


def test_committed_baseline_exists_and_is_fully_used():
    assert os.path.exists(DEFAULT_BASELINE)
    bl = baseline_mod.load(DEFAULT_BASELINE)
    assert bl.entries, "baseline should carry the accepted findings"
    assert all(e.reason for e in bl.entries), \
        "every baseline entry needs a recorded reason"
    assert all(e.file.startswith("ytk_mp4j_tpu_torch/") for e in bl.entries)
    result = Engine(baseline=bl, strict_baseline=True,
                    baseline_path=DEFAULT_BASELINE).lint_paths([PKG_DIR])
    assert result.ok, "\n".join(f.format() for f in result.findings)
    assert not bl.unused(), f"stale baseline entries: {bl.unused()}"


def test_seeded_rank_conditional_collective_is_caught(tmp_path):
    scratch = tmp_path / "ytk_mp4j_tpu_torch" / "comm" / "seeded.py"
    scratch.parent.mkdir(parents=True)
    scratch.write_text(textwrap.dedent("""
        def broken_step(comm, grads):       # line 2
            comm.allreduce_array(grads)     # line 3
            if comm.rank == 0:              # line 4 <- R1 here
                comm.barrier()
    """))
    result = lint_paths([str(tmp_path)])
    r1 = [f for f in result.findings if f.rule == "R1"]
    assert len(r1) == 1
    assert r1[0].path.endswith("ytk_mp4j_tpu_torch/comm/seeded.py")
    assert r1[0].line == 4
    assert r1[0].context == "broken_step"


def test_cli_reports_seeded_finding(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(c):\n    if c.rank:\n        c.barrier()\n")
    assert main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "R1" in out and "bad.py:2" in out


def test_module_entry_point():
    """``python -m ytk_mp4j_tpu_torch.analysis`` is the CLI (the strict
    lint of the package itself is ``main([PKG_DIR, "--strict"])`` above;
    this checks the module's wiring on the cheap catalogue command)."""
    import subprocess
    import sys

    repo = os.path.dirname(PKG_DIR)
    r = subprocess.run([sys.executable, "-m", "ytk_mp4j_tpu_torch.analysis",
                        "--list-rules"], cwd=repo, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "R1" in r.stdout and "R28" in r.stdout
