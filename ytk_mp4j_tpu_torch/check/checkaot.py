"""Compile-only proof of the port's CUDA kernels: the counterpart of
``ytk_mp4j_tpu/check/checkaot.py``.

The reference lowers and compiles every multi-chip program for a TPU
topology without chips and records XLA's cost analysis. The port's
device programs are its hand-written kernel sources, so this program
compiles every ``.cu`` that ``ops/_build.sources()`` lists with the
build's own command (``_build.nvcc_command``: ``NVCC_FLAGS``, sm_90a)
plus ``-Xptxas -v``, one ``nvcc`` per source, all started together, each
into a throwaway library under a temporary directory. No card is
needed. For each source it records whether it compiled, and for each
kernel entry ptxas' registers, shared memory, stack frame, spill stores
and spill loads.

    python -m ytk_mp4j_tpu_torch.check.checkaot [--out f.json]

Exit code 0 iff every source compiled. Where no ``nvcc`` is found the
artifact says ``"nvcc": null`` with the reason, lists no program and
exits 2: a compile that did not run is never reported ok.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.ops import _build

COMPILE_TIMEOUT_S = 900
_ENTRY = re.compile(r"Compiling entry function '([^']+)' for '(\w+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_name(mangled: str) -> str:
    """The function's own identifier in an Itanium-mangled name, without
    its namespaces and template arguments (``_Z11hist_kernelPKi...`` and
    ``_ZN12_GLOBAL__N_111ring_kernelILi1EEEv...`` -> ``hist_kernel``,
    ``ring_kernel``); the name itself when it is not mangled."""
    nested = mangled.startswith("_ZN")
    if not (nested or re.match(r"_Z\d", mangled)):
        return mangled
    name, i = mangled, 3 if nested else 2
    while (m := re.compile(r"\d+").match(mangled, i)) is not None:
        end = m.end() + int(m.group())
        name, i = mangled[m.end():end], end
        if not nested:
            break
    return name


def parse_ptxas(text: str) -> dict:
    """``-Xptxas -v`` output -> ``{mangled entry: {kernel, arch,
    registers, smem_bytes, stack_bytes, spill_stores, spill_loads}}``."""
    kernels: dict = {}
    current = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = kernels.setdefault(m.group(1), {
                "kernel": kernel_name(m.group(1)), "arch": m.group(2)})
            continue
        m = _PROPS.search(line)
        if m:
            current = kernels.setdefault(
                m.group(1), {"kernel": kernel_name(m.group(1))})
            continue
        if current is None:
            continue
        m = _FRAME.search(line)
        if m:
            current.update(stack_bytes=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            current["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            current["smem_bytes"] = int(s.group(1)) if s else 0
    return {k: v for k, v in kernels.items() if "registers" in v}


def compile_all(nvcc: str, names, out_dir: Path) -> dict:
    """Start one ``nvcc`` a source, then wait for each; returns
    ``{name: {ok, seconds, kernels | error}}``."""
    procs = []
    t0 = time.perf_counter()
    for name in names:
        cmd = _build.nvcc_command(nvcc, name, out_dir / f"lib{name}.so")
        cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    results = {}
    try:
        for name, proc in procs:
            try:
                out, _ = proc.communicate(timeout=COMPILE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                out += f"\nkilled after {COMPILE_TIMEOUT_S} s".encode()
            text = out.decode(errors="replace")
            rec = {"ok": proc.returncode == 0,
                   "seconds": time.perf_counter() - t0}
            if rec["ok"]:
                rec["kernels"] = parse_ptxas(text)
                print(f"ok   {name}.cu: {len(rec['kernels'])} kernels, "
                      f"{rec['seconds']:.1f} s")
            else:
                rec["error"] = text[-4000:]
                print(f"FAIL {name}.cu: {text[-300:]}", file=sys.stderr)
            results[name] = rec
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    args = ap.parse_args(argv)
    artifact = {"nvcc": None, "flags": list(_build.NVCC_FLAGS),
                "programs": {}, "ok": False}
    try:
        nvcc = _build.find_nvcc()
    except Mp4jError as e:
        artifact["reason"] = str(e)
        rc = 2
    else:
        artifact["nvcc"] = nvcc
        artifact["nvcc_version"] = subprocess.run(
            [nvcc, "--version"], capture_output=True, text=True,
            timeout=60).stdout.strip().rpartition("\n")[2]
        with tempfile.TemporaryDirectory(prefix="mp4j-checkaot-") as d:
            progs = compile_all(nvcc, _build.sources(), Path(d))
        artifact["programs"] = progs
        artifact["ok"] = bool(progs) and all(p["ok"]
                                             for p in progs.values())
        rc = 0 if artifact["ok"] else 1
    line = json.dumps(artifact)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
