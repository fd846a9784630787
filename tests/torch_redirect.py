"""Run test files of the JAX package against the PyTorch port.

    python tests/torch_redirect.py tests/test_socket_comm.py -q [pytest args]

An import finder on ``sys.meta_path`` maps ``ytk_mp4j_tpu`` and every
``ytk_mp4j_tpu.*`` onto the port's module of the same relative name, so a
reference test that imports ``ytk_mp4j_tpu.comm.process_comm`` gets
``ytk_mp4j_tpu_torch.comm.process_comm`` itself (one module object under
both names, so monkeypatching either patches the port). A module the
port lacks raises ``ModuleNotFoundError``; nothing of the JAX package
loads. Then ``pytest.main`` runs with the arguments given, and the exit
code is pytest's. The first line of output names the file the
redirected ``ytk_mp4j_tpu.comm.process_comm`` came from.

This is a helper of the ``tests/test_torch_ref_*.py`` runners, not a
collected test; they call :func:`run_reference_file`. A child
interpreter that a test starts does not inherit the finder: it runs the
reference.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE, TARGET = "ytk_mp4j_tpu", "ytk_mp4j_tpu_torch"


class _Alias(importlib.abc.Loader):
    """Loads a name as an alias of an already importable module."""

    def __init__(self, target: str):
        self.target = target

    def create_module(self, spec):
        return importlib.import_module(self.target)

    def exec_module(self, module):
        pass


class RedirectFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name != SOURCE and not name.startswith(SOURCE + "."):
            return None
        real = TARGET + name[len(SOURCE):]
        if importlib.util.find_spec(real) is None:
            raise ModuleNotFoundError(
                f"the port has no {real!r} (redirected from {name!r})",
                name=name)
        is_pkg = hasattr(importlib.import_module(real), "__path__")
        return importlib.machinery.ModuleSpec(name, _Alias(real),
                                              is_package=is_pkg)


def install() -> None:
    if not any(isinstance(f, RedirectFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, RedirectFinder())


def main(argv: list[str]) -> int:
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    install()
    import pytest

    from ytk_mp4j_tpu.comm import process_comm

    print(f"REDIRECT process_comm={process_comm.__file__}", flush=True)
    return pytest.main(argv)


def run_reference_file(name: str, deselect, tmp_dir: Path,
                       timeout: float = 600.0) -> dict:
    """Run ``tests/<name>.py`` against the port in a child interpreter,
    with ``-m 'not slow'``, without xdist and the cache, and with each
    node id of ``deselect`` (pairs of node id and reason) left out.
    Returns the counts of the inner run's junit report, the file the
    redirected ``process_comm`` came from, and the output's tail."""
    xml = tmp_dir / f"{name}.xml"
    cmd = [sys.executable, str(Path(__file__).resolve()),
           f"tests/{name}.py", "-q", "-m", "not slow", "-p", "no:xdist",
           "-p", "no:cacheprovider", "-p", "no:randomly",
           f"--junitxml={xml}"]
    for node, _reason in deselect:
        cmd.append(f"--deselect=tests/{name}.py::{node}")
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    out = proc.stdout + proc.stderr
    origin = next((line.split("=", 1)[1] for line in out.splitlines()
                   if line.startswith("REDIRECT process_comm=")), None)
    counts = {"tests": 0, "failures": 0, "errors": 0, "skipped": 0}
    if xml.exists():
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        counts = {k: int(suite.get(k, 0)) for k in counts}
    passed = (counts["tests"] - counts["failures"] - counts["errors"]
              - counts["skipped"])
    return dict(counts, passed=passed, rc=proc.returncode, origin=origin,
                tail=out[-4000:])


def check_reference_file(name: str, min_passed: int, deselect,
                         tmp_dir: Path) -> None:
    """The runners' one assertion: no failure, at least ``min_passed``
    passes, and the modules under test were the port's."""
    r = run_reference_file(name, deselect, tmp_dir)
    port = str(REPO / TARGET) + os.sep
    assert r["origin"] and r["origin"].startswith(port), r["tail"]
    assert r["failures"] == 0 and r["errors"] == 0, r["tail"]
    assert r["rc"] == 0, r["tail"]
    assert r["passed"] >= min_passed, (r["passed"], r["tail"])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
