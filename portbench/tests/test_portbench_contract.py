"""BENCHMARK.json against the benchmark's contract, the cells' files,
and the frozen byte counts."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, SMALL
from portbench import harness, roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
BENCH = harness.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    full = 2 + 14 * 24
    assert full * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.find_cell(BENCH, cell)
    spec = c["spec"]
    assert (harness.ROOT / "drivers" / f"{spec['driver']}.py").is_file()
    assert TEXT.match(spec["why"])
    config = [k for k in BENCH["configs"] if k["name"] == c["config"]][0]
    assert (harness.REPO / config["file"]).is_file()
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(BENCH, cell, True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
    for m in harness.cell_metrics(BENCH, cell, False) + layer:
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").is_file()
    driver = harness.load("drivers", spec["driver"])
    for fn in ("setup", "step", "drain", "record", "probe", "traced_items",
               "check", "control"):
        assert callable(getattr(driver, fn))


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        body = json.load(open(os.path.join(REPO, c["file"])))
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_frozen_byte_counts_at_published_shapes():
    # configs[1]: 8 x 256M f64 reduce-scatter, 8 x 32M allgather
    assert roofline.ring_seconds("reduce_scatter", 8, 256 << 20,
                                 "float64") * 1e3 == pytest.approx(5.769,
                                                                   abs=5e-4)
    assert roofline.ring_seconds("allgather", 8, 32 << 20,
                                 "float64") * 1e3 == pytest.approx(5.769,
                                                                   abs=5e-4)
    # configs[0]'s shape: 4 x 1M f32 allreduce
    assert roofline.ring_seconds("allreduce", 4, 1 << 20,
                                 "float32") * 1e3 == pytest.approx(0.0100,
                                                                   abs=5e-5)
    # nccl-tests' bus bytes
    assert roofline.bus_bytes("allreduce", 4, 1 << 20, "float32") == (
        1.5 * (4 << 20))
    assert roofline.bus_bytes("reduce_scatter", 8, 256 << 20,
                              "float64") == 7 / 8 * (2 << 30)
    assert roofline.bus_bytes("allgather", 8, 32 << 20,
                              "float64") == 7 / 8 * (2 << 30)
    # the Higgs round: 11M x (28 one-byte bins + g + h) x (1 + 5 / 2)
    assert roofline.tree_bytes(11_000_000, 28, 256, 6) == 11_000_000 * 36 * 3.5
    assert roofline.tree_seconds(11_000_000, 28, 256, 6) * 1e3 == (
        pytest.approx(0.41373, abs=1e-4))
    # a level-0 histogram call over 4 members: one-byte ids and bins
    assert roofline.hist_level_bytes(11_000_000, 11_000_000, 4, 28,
                                     256) == (11_000_000 + 11_000_000 * 36
                                              + 2 * 4 * 28 * 256 * 4)
    assert roofline.value_bytes(256) == 1 and roofline.value_bytes(257) == 2


def test_a_cell_added_as_files_is_found_without_editing_any(tmp_path):
    for entry in ["BENCHMARK.json"]:
        shutil.copy(os.path.join(REPO, entry), tmp_path / entry)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    spec = json.load(open(tmp_path / "portbench" / "workloads" /
                          "ring-rdma.rsag-f64-256M-n8.json"))
    spec["traffic"]["length"] = 4 * 4096
    spec["traffic"]["members"] = 4
    spec["why"] = "a dummy cell: reduce-scatter and allgather of 4 x 16K f64"
    (tmp_path / "portbench" / "workloads" /
     "ring-rdma.dummy-f64-16K-n4.json").write_text(json.dumps(spec))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["workloads"].append({"name": "ring-rdma.dummy-f64-16K-n4",
                               "config": "ring-rdma", "traffic": "dummy",
                               "chips": 1, "why": spec["why"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time, json; sys.path.insert(0, '.');"
        "from portbench import harness;"
        "out = harness.execute('ring-rdma.dummy-f64-16K-n4', 5, 0.2, False,"
        " time.perf_counter(), device='cpu', look_for_chips=False);"
        "print(json.dumps(out))")
    # the copy holds the benchmark; the program is the repository's
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and "setup_s" in out["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_run_refuses_where_no_card_is_there(tmp_path):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ring-rdma.rsag-f64-256M-n8", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "gbdt-higgs.dp4", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode != 0
    assert not p.stdout.strip()


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_small_run_is_correct_and_reports_its_metrics(cell):
    from conftest import small_run

    out = small_run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checks"
