"""The harness: finds a cell's files by name, runs its driver for the
measured window, reads the cell's metrics and judges its outputs.

Everything that belongs to one cell, configuration or metric lives in a
file of its own, found by name:

- ``BENCHMARK.json`` (the checkout's root): the cell's configuration,
  chips and metrics;
- ``portbench/workloads/<cell>.json``: its driver, its traffic
  parameters and the limits of the numbers that decide ``correct``;
- ``portbench/configs/<config>.json``: the configuration as it is run;
- ``portbench/drivers/<driver>.py``: makes the inputs, builds the
  program, warms it up, runs one item of the loop, judges the outputs;
- ``portbench/metrics/<metric>.py``: ``read(run)`` gives the metric's
  number, or None where the run holds nothing to read.

A driver module has ``setup(ctx) -> state`` (inputs made, program built,
every shape warmed up), ``step(state)`` (one item of the closed loop),
``drain(state)`` (waits for the device), ``record(state) -> dict`` (what
the window completed), ``probe(state)`` (an object whose ``begin()`` and
``end() -> dict`` bracket a traced sub-window), ``traced_items(state,
items) -> dict`` (what the readers take from that sub-window, worked out
after it) and ``check(state) -> (attempted, failed, {name: (number,
limit)})``, run after the window, once the program's state is freed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "ytk_mp4j_tpu")
TRACE_AT = 0.3           # the traced sub-window starts at this share of
TRACE_SECONDS = 2.0      # the window and lasts this long an attempt


class HarnessError(Exception):
    """A cell's files are missing or do not fit together."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def load(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded from its path."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise HarnessError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str) -> dict:
    """The cell ``name``: its BENCHMARK.json entry with its workload file
    (``spec``) and its configuration file (``config``)."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise HarnessError(f"BENCHMARK.json has no workload {name!r}")
    cell = dict(entries[0])
    spec = load_json(ROOT / "workloads" / f"{name}.json")
    for key in ("config", "chips"):
        if spec[key] != cell[key]:
            raise HarnessError(f"{name}: {key} is {cell[key]!r} in "
                               f"BENCHMARK.json, {spec[key]!r} in its file")
    cell["spec"] = spec
    cell["config_file"] = load_json(ROOT / "configs" / f"{cell['config']}.json")
    return cell


def cell_metrics(bench: dict, name: str, traced: bool) -> list:
    """The metrics cell ``name`` reports: its end-to-end ones untraced,
    its per-layer ones traced (a metric without ``workloads`` goes to
    every cell that reports the end-to-end metric it moves)."""
    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules(names=None) -> list:
    """The loaded modules (or ``names``) whose whole top-level name is
    JAX's, its relatives' or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclass
class Context:
    """What a driver is given: the run's arguments and the cell's files."""
    name: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    traffic: dict
    limits: dict


@dataclass
class Run:
    """What a metric's reader reads."""
    ctx: Context
    setup_s: float
    window: dict                    # the driver's record and "seconds"
    trace: object = None            # profiling.Trace of the sub-window
    traced: dict = field(default_factory=dict)   # driver's items for it


def _loop(driver, state, seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        driver.step(state)


def run_window(driver, state, ctx: Context):
    """The measured window: the loop for ``ctx.seconds``, then a drain.
    Traced, a sub-window of it is profiled. Returns (start time, window
    record, trace or None, its items)."""
    start = time.perf_counter()
    trace = traced = None
    if ctx.trace:
        from portbench import profiling

        _loop(driver, state, ctx.seconds * TRACE_AT)
        probe = driver.probe(state)

        def some(seconds):
            probe.begin()
            _loop(driver, state, seconds)
            driver.drain(state)
            return probe.end()

        trace = profiling.profile(some, TRACE_SECONDS)
        if trace is not None:
            traced = driver.traced_items(state, trace.items)
        _loop(driver, state, start + ctx.seconds - time.perf_counter())
    else:
        _loop(driver, state, ctx.seconds)
    driver.drain(state)
    window = dict(driver.record(state))
    window["seconds"] = time.perf_counter() - start
    return start, window, trace, traced or {}


def _number(v: float) -> float:
    if not math.isfinite(v):
        raise HarnessError(f"a metric read {v}")
    return float(v)


def execute(name: str, seed: int, seconds: float, trace: bool,
            t0: float, device: str = "cuda", look_for_chips: bool = True,
            traffic: dict | None = None, config: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``look_for_chips=False``, ``device``, ``traffic`` and ``config`` (keys
    that replace the workload's and configuration's) let a test drive the
    rest of a run on the CPU at a size it can hold."""
    bench = benchmark()
    cell = find_cell(bench, name)
    spec = cell["spec"]
    import torch

    if look_for_chips and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < cell["chips"]):
        raise HarnessError(
            f"{name} needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
    ctx = Context(name, seed, seconds, trace, device,
                  {**cell["config_file"], **(config or {})},
                  {**spec["traffic"], **(traffic or {})},
                  spec["limits"])
    driver = load("drivers", spec["driver"])
    state = driver.setup(ctx)
    start, window, tr, traced = run_window(driver, state, ctx)
    on_card = device == "cuda"
    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(cell["chips"])) if on_card else 0)
    run = Run(ctx, start - t0, window, tr, traced)
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    attempted, failed, checks = driver.check(state)
    correct = bool(attempted) and not failed and all(
        v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        if tr is None:
            raise HarnessError("the profiler saw no device event")
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    # JSON has no infinity: a number that could not be read (a NaN in the
    # program's output) prints as the largest double
    out["checks"] = {k: {"value": v if math.isfinite(v) else sys.float_info.max,
                         "limit": lim} for k, (v, lim) in checks.items()}
    return out
