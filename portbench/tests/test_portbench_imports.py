"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level module name, and the plain reference loads nothing of the
program."""

import ast
import os
import subprocess
import sys

from conftest import REPO

LOAD_ALL = """
import sys, time, glob, os
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from portbench import harness, control, profiling, roofline, sampling
from portbench.reference import gbdt, ring
for kind in ("drivers", "metrics"):
    for p in sorted(glob.glob(os.path.join({repo!r}, "portbench", kind,
                                           "*.py"))):
        harness.load(kind, os.path.basename(p)[:-3])
small = {small!r}
for name, (traffic, config) in small.items():
    harness.execute(name, 3, 0.1, False, time.perf_counter(), device="cpu",
                    look_for_chips=False, traffic=traffic, config=config)
print(repr(harness.forbidden_modules()))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    from conftest import SMALL

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c",
                        LOAD_ALL.format(repo=REPO, small=SMALL)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names():
    from portbench import harness

    names = ["ytk_mp4j_tpu_torch", "ytk_mp4j_tpu_torch.models.gbdt",
             "jaxtyping", "ytk_mp4j_tpu", "ytk_mp4j_tpu.ops", "jax.numpy",
             "jaxlib", "flax.linen"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "ytk_mp4j_tpu",
        "ytk_mp4j_tpu.ops"]


def test_the_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(REPO, "portbench", "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] in ("torch", "numpy", "__future__"), (
                    name, m)
    code = (f"import sys; sys.path.insert(0, {REPO!r});"
            "import portbench.reference.gbdt, portbench.reference.ring;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'ytk_mp4j_tpu_torch', 'ytk_mp4j_tpu', 'jax'}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
