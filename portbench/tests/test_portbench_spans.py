"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that use it), on traces built by hand: each reads None where the
program opened no span of its name, and the right number where it did."""

import pytest

from portbench import harness, roofline, spans
from portbench.profiling import Trace

GBDT = ["gbdt." + m + "_ms_per_tree" for m in (
    "gradients", "hist", "fold", "splits", "route", "leaf_sums", "margins")]
RING = ["ring.reduce_scatter_roofline", "ring.allgather_roofline",
        "ring.host_us_per_call"]
NEW = GBDT + ["gbdt.span_coverage_pct"] + RING


class _Parts:
    """Host ranges, launches and the kernels they launch, in us."""

    def __init__(self):
        self.host, self.launches, self.device = [], [], []

    def range(self, name, ts, dur):
        self.host.append({"name": name, "cat": "user_annotation", "ts": ts,
                          "dur": dur})

    def launch(self, ts, kernel, start, dur):
        corr = len(self.launches) + 1
        self.launches.append({"name": "cudaLaunchKernel", "ts": ts,
                              "args": {"correlation": corr}})
        self.device.append({"name": kernel, "cat": "kernel", "ts": start,
                            "dur": dur, "args": {"correlation": corr}})

    def trace(self, keep_ranges=True):
        host = self.host if keep_ranges else []
        return Trace(0.0, 1e6, list(self.device), list(self.launches),
                     list(host), 0)


def _read(name, tr, traced):
    return harness.load("metrics", name).read(
        harness.Run(None, 0.0, {}, tr, traced))


# each phase of a round launches one kernel of this many us
PHASE_US = {"gradients": 30.0, "histograms": 400.0, "fold": 50.0,
            "splits": 70.0, "route": 90.0, "leaf_sums": 800.0,
            "margins": 40.0}


def _gbdt(rounds=2, harness_us=5.0):
    b = _Parts()
    t = 100.0
    for _ in range(rounds):
        start = t
        for phase, us in PHASE_US.items():
            b.range("gbdt::" + phase, t, 10.0)
            b.launch(t + 5, "k_" + phase, t + 20, us)
            t += 20 + us
        b.range("gbdt::round", start, t - start)
        t += 50
        b.launch(t, "harness_copy", t + 10, harness_us)   # outside a round
        t += 100
    return b


def test_each_gbdt_phase_reads_its_device_ms_per_round():
    tr = _gbdt().trace()
    for name, phase in zip(GBDT, PHASE_US):
        assert _read(name, tr, {"trees": 2}) == pytest.approx(
            PHASE_US[phase] / 1e3)


def test_the_seven_phases_sum_to_the_work_launched_inside_the_rounds():
    tr = _gbdt().trace()
    phases = sum(_read(name, tr, {"trees": 2}) for name in GBDT)
    assert phases == pytest.approx(1e3 * spans.device_s(tr, "gbdt::round")
                                   / 2)
    assert phases == pytest.approx(sum(PHASE_US.values()) / 1e3)


def test_coverage_is_the_share_launched_inside_a_round():
    tr = _gbdt(harness_us=148.0).trace()
    work = sum(PHASE_US.values())
    assert _read("gbdt.span_coverage_pct", tr, {"trees": 2}) == (
        pytest.approx(100 * work / (work + 148.0)))


def _ring(n=8, length=1 << 20, calls=3, rs_us=900.0, ag_us=1100.0,
          fill_us=0.0):
    """``calls`` items of a reduce-scatter then an allgather, each call a
    span with one ring kernel (and a fill where ``fill_us``), the
    cluster path's wait inside it."""
    b = _Parts()
    items = []
    t = 0.0
    for _ in range(calls):
        for mode, us, shard in (("reduce_scatter", rs_us, length),
                                ("allgather", ag_us, length // n)):
            if fill_us:
                b.launch(t + 2, "vectorized_elementwise_kernel", t + 3,
                         fill_us)
            b.launch(t + 5, "ring_cluster", t + 6 + fill_us, us)
            b.range("ring::wait", t + 10, us)
            b.range("ring::" + mode, t, us + 30)
            items.append((mode, n, shard, "float64"))
            t += us + 200
    return b, items


def test_the_two_ring_rooflines_recombine_by_time_to_the_kernels_one():
    b, items = _ring()
    tr = b.trace()
    traced = {"ring_calls": items}
    rs = _read("ring.reduce_scatter_roofline", tr, traced)
    ag = _read("ring.allgather_roofline", tr, traced)
    least = roofline.ring_seconds(*items[0])
    assert rs == pytest.approx(100 * least / 900e-6)
    assert ag == pytest.approx(100 * roofline.ring_seconds(*items[1])
                               / 1100e-6)
    t_rs = spans.device_s(tr, "ring::reduce_scatter")
    t_ag = spans.device_s(tr, "ring::allgather")
    whole = _read("ring_kernel_roofline", tr, traced)
    assert (rs * t_rs + ag * t_ag) / (t_rs + t_ag) == pytest.approx(whole)


def test_an_error_word_fill_moves_the_recombination_by_its_share_alone():
    b, items = _ring(fill_us=2.0)
    tr = b.trace()
    traced = {"ring_calls": items}
    rs = _read("ring.reduce_scatter_roofline", tr, traced)
    ag = _read("ring.allgather_roofline", tr, traced)
    t_rs = spans.device_s(tr, "ring::reduce_scatter")
    t_ag = spans.device_s(tr, "ring::allgather")
    whole = _read("ring_kernel_roofline", tr, traced)
    mixed = (rs * t_rs + ag * t_ag) / (t_rs + t_ag)
    assert mixed < whole
    assert whole - mixed == pytest.approx(whole * 4.0 / 2004.0)


def test_host_time_of_a_call_leaves_out_its_wait():
    b, items = _ring()
    assert _read("ring.host_us_per_call", b.trace(),
                 {"ring_calls": items}) == pytest.approx(30.0)
    # a call without a wait (the global path) counts whole
    b.range("ring::allreduce", 1e5, 75.0)
    assert _read("ring.host_us_per_call", b.trace(),
                 {"ring_calls": items}) == pytest.approx(
                     (6 * 30.0 + 75.0) / 7)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name):
    gb, ring = _gbdt(), _ring()[0]
    for b in (gb, ring):
        traced = {"trees": 2, "ring_calls": _ring()[1]}
        assert _read(name, b.trace(keep_ranges=False), traced) is None
        assert _read(name, None, traced) is None


@pytest.mark.parametrize("name", NEW)
def test_every_new_metric_is_declared_for_its_cell(name):
    (m,) = [m for m in harness.benchmark()["per_layer"] if m["name"] == name]
    assert m["source"] == "program_span"
    cell = ("gbdt-higgs.dp4" if name.startswith("gbdt.")
            else "ring-rdma.rsag-f64-256M-n8")
    assert m["workloads"] == [cell]
    assert name in {x["name"] for x in harness.cell_metrics(
        harness.benchmark(), cell, True)}
