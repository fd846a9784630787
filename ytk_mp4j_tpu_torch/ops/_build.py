"""Build and load the port's CUDA kernels.

Each source ``ops/csrc/<name>.cu`` compiles on its own, with ``nvcc``,
into a shared library with a plain C interface that ``ctypes`` loads:
``ytk_mp4j_tpu_torch/csrc/build/lib<name>-<digest>.so``. The digest
covers the source and the flags, so an edited source builds anew and an
unchanged one is reused. Nothing builds when a module is imported: the
first call that needs a kernel builds it, and :func:`build` compiles
several sources at once, one ``nvcc`` process each.

``nvcc`` comes from ``PATH`` or from ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``). Where there is none, loading a kernel raises
:class:`~ytk_mp4j_tpu_torch.exceptions.Mp4jError`; no caller falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ytk_mp4j_tpu_torch.exceptions import Mp4jError

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "ops" / "csrc"
BUILD_DIR = PACKAGE_DIR / "csrc" / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
# the loaded library of each source, one per process by design: load()
# reads and writes it only under _lock
# mp4j-lint: disable=R7 (process-wide library cache, guarded by _lock)
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under ``ops/csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise Mp4jError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels build "
        "only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise Mp4jError(f"no kernel source {src}")
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def build(names=None) -> dict[str, Path]:
    """Compile each named source (default: all) whose library is missing,
    every ``nvcc`` started before any is awaited. Returns
    ``{name: library path}``; raises Mp4jError with the compiler's
    output when a build fails."""
    names = sources() if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    failures = []
    try:
        for n in todo:
            tmp = paths[n].with_name(f"{paths[n].name}.{os.getpid()}.tmp")
            procs.append((n, tmp, subprocess.Popen(
                nvcc_command(nvcc, n, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)))
        for n, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                failures.append(f"{n}.cu:\n{out.decode(errors='replace')}")
            else:
                os.replace(tmp, paths[n])
    finally:
        for _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise Mp4jError("nvcc failed for " + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
