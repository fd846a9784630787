"""``mp4j-scope bench-diff`` — perf regression gating over BENCH files.

A copy of ``ytk_mp4j_tpu/obs/benchdiff.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package. It gates the reference's
``bench.py`` files; the port has no bench of its own yet.

Compares the headline figures of two ``bench.py`` JSON outputs (round
A vs round B) against per-metric regression thresholds and reports a
verdict per metric — the seed of perf regression gating for every
future PR: drop two BENCH files in, get a nonzero exit when a tracked
figure regressed past its budget.

Accepted input shapes (both appear in the repo):

- the raw one-line bench output: ``{"metric", "value", "extra": {...}}``;
- a run record: ``{"n", "cmd", "rc", "tail", "parsed": {...}}``, the
  run's index, command, exit code and output tail, with ``parsed``
  holding the raw form.

Thresholds are PER METRIC because the noise floor is: pure-device
figures repeat within a few percent, while the loopback socket legs on
a shared 1-core bench host swing 10-20% run to run. Every tracked
metric is higher-is-better; a metric missing from either file is
skipped (rounds grow new figures), never an error.
"""

from __future__ import annotations

import json

# metric -> max tolerated fractional drop (new >= old * (1 - thr)).
# Grounded in the run-to-run spread of the BENCH files; tighten as the bench
# host stabilizes. "value" is the headline GB/s/chip figure.
THRESHOLDS: dict[str, float] = {
    "value": 0.10,
    "trees_per_sec": 0.10,
    "socket_baseline_gbs": 0.25,
    "socket_collective_gbs": 0.20,
    "socket_native_collective_gbs": 0.20,
    # the intra-host shared-memory plane and the forced
    # two-level schedule over it; same loopback-leg noise floor as the
    # other socket figures on the shared 1-core bench host
    "socket_shm_collective_gbs": 0.25,
    "socket_twolevel_gbs": 0.25,
    # the audit plane's default (digest) mode on the headline
    # leg — gated so the always-on digest tax cannot silently creep;
    # same loopback noise floor as the other socket figures
    "socket_collective_gbs_audit_digest": 0.25,
    # the durable sink armed on the headline leg — gated so
    # the background-drain tax cannot silently creep; same noise floor
    "socket_collective_gbs_sink_on": 0.25,
    # the streaming health plane armed (slave span-cell
    # folds + master detector set) on the headline leg — gated so the
    # verdict engine's tax cannot silently creep; same noise floor
    "socket_collective_gbs_health_on": 0.25,
    # mp4j-async: k outstanding iallreduces on the
    # scheduler (overlap leg) and the tiny-map coalescing figure —
    # gated so neither the scheduler's dense cost nor the fused map
    # plane regresses silently; same loopback noise floor as the
    # other socket figures. The frozen legs pin async off, so every
    # historical figure stays comparable.
    "socket_async_overlap_gbs": 0.25,
    "socket_async_sequential_gbs": 0.25,
    "socket_coalesce_keys_per_sec": 0.25,
    "socket_coalesce_off_keys_per_sec": 0.25,
    # mp4j-overlap: the dense small-array fused plane (the
    # array twin of the map coalescing rows above) and the
    # trainer-overlap epoch ratio. The ratio row only appears in BENCH
    # files produced on a multi-core host (1-core rigs record a
    # skipped_1core marker instead of a figure), and as an on/off
    # ratio it is already normalized against host speed — the budget
    # bounds erosion of the overlap win itself, not wall-clock drift
    "socket_coalesce_array_elems_per_sec": 0.25,
    "socket_coalesce_array_off_elems_per_sec": 0.25,
    "socket_trainer_overlap_ratio": 0.25,
    "socket_framed_collective_gbs": 0.20,
    "socket_collective_in_workload_gbs": 0.25,
    # mp4j-tuner: the framed/columnar-map planes over the
    # shm rings (frame-level ring routing) and the tuner act leg —
    # gated so neither the routing fast path nor the adaptive win
    # regresses silently; same loopback noise floor. The act leg's
    # win over socket_tuner_off_gbs is the acceptance evidence.
    "socket_framed_shm_gbs": 0.25,
    "socket_map_shm_keys_s": 0.25,
    "socket_tuner_act_gbs": 0.25,
    "socket_tuner_off_gbs": 0.25,
    "ffm_sparse_steps_per_sec": 0.10,
    "ffm_stream_rows_per_sec": 0.20,
    "ffm_stream_rows_per_sec_serialized": 0.20,
    "ffm_stream_text_rows_per_sec": 0.20,
    "libsvm_reader_rows_per_sec": 0.20,
    "socket_map_allreduce_keys_per_sec": 0.20,
    "socket_map_int_allreduce_keys_per_sec": 0.20,
    "socket_map_pickle_keys_per_sec": 0.25,
    "socket_map_int_pickle_keys_per_sec": 0.25,
    "device_map_int_allreduce_keys_per_sec": 0.20,
    "device_map_chained_keys_per_sec": 0.20,
    "gbdt_hist_mxu_tflops_per_sec_per_chip": 0.10,
    # recovery/membership latencies (LOWER is better — see
    # LOWER_IS_BETTER below). Wide budgets: these are single-event
    # wall-clock deltas on a shared 1-core host whose scheduler tails
    # swing them run to run; the gate exists to catch a protocol
    # regression (an extra round trip, a lost deadline), which shows
    # as a multiple, not a percent
    "socket_recovery_latency_ms": 1.0,
    "socket_replacement_latency_ms": 1.0,
    "socket_shrink_latency_ms": 1.0,
    # autoscaler actuation latencies, same single-event
    # wall-clock caveat and wide budget as the membership rows above
    "socket_planned_evict_ms": 1.0,
    "socket_grow_latency_ms": 1.0,
    # mp4j-fleet: one full FleetPoller sweep against a
    # live 4-rank job (both endpoint fetches + summary fold + model
    # rebuild + contention detection), p99 over the sweep loop —
    # LOWER is better. Wide budget: the tail rides loopback-HTTP
    # scheduler wakeups on the shared 1-core bench host; the gate
    # exists to catch a fold/detector complexity regression, which
    # shows as a multiple, not a percent
    "fleet_scrape_p99_ms": 1.0,
    # mp4j-serve: the inference plane. The QPS rows gate
    # the micro-batched and unbatched throughputs (loopback noise
    # floor, like the other socket figures) and the speedup row gates
    # the batching win itself — a RATIO, already normalized against
    # host speed. The latency rows (LOWER is better, see below) carry
    # the membership-row caveat: single-digit-ms tails on a shared
    # 1-core host swing run to run, so the gate exists to catch a
    # protocol regression (an extra collective per batch, a lost
    # deadline), which shows as a multiple, not a percent
    "serve_batched_qps": 0.25,
    "serve_unbatched_qps": 0.25,
    "serve_speedup": 0.25,
    "serve_p50_ms": 1.0,
    "serve_p99_ms": 1.0,
    "serve_chaos_p99_ms": 1.0,
    # mp4j-lint v3 (R23-R25 lockset/resource whole-program
    # passes) over v2 (R19-R21) — a RATIO, so already normalized
    # against host speed; the budget bounds growth of the marginal
    # analysis cost (v3 <= 1.5x v2 absolute is asserted in tier-1,
    # this row gates drift between bench rounds)
    "lint_v3_over_v2_ratio": 0.5,
}

# metrics where SMALLER is the good direction (latencies): the budget
# bounds GROWTH — new <= old * (1 + thr) — instead of shrinkage
LOWER_IS_BETTER = frozenset({
    "socket_recovery_latency_ms",
    "socket_replacement_latency_ms",
    "socket_shrink_latency_ms",
    "socket_planned_evict_ms",
    "socket_grow_latency_ms",
    "fleet_scrape_p99_ms",
    "lint_v3_over_v2_ratio",
    "serve_p50_ms",
    "serve_p99_ms",
    "serve_chaos_p99_ms",
})


def load_bench(path: str) -> dict[str, float]:
    """Flat ``{metric: value}`` from a BENCH file (either shape);
    raises ``ValueError`` on anything that is not a bench document."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    if not isinstance(doc, dict) or "value" not in doc:
        raise ValueError(f"{path}: not a bench.py output "
                         "(no 'value' headline)")
    out: dict[str, float] = {}
    if isinstance(doc.get("value"), (int, float)):
        out["value"] = float(doc["value"])
    for k, v in (doc.get("extra") or {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = float(v)
    return out


def compare(old: dict[str, float], new: dict[str, float],
            threshold: float | None = None) -> list[dict]:
    """Row per tracked metric present in BOTH files: ``{metric, old,
    new, ratio, threshold, verdict}`` with verdict ``"REGRESSED"`` /
    ``"ok"`` / ``"improved"`` (improved = past the same margin in the
    good direction). ``threshold`` overrides every per-metric value."""
    rows = []
    for metric, thr in THRESHOLDS.items():
        if metric not in old or metric not in new:
            continue
        if threshold is not None:
            thr = threshold
        a, b = old[metric], new[metric]
        ratio = b / a if a else float("inf")
        lower = metric in LOWER_IS_BETTER
        if lower:
            # latency: growth past budget regresses, shrinkage improves
            if b > a * (1.0 + thr):
                verdict = "REGRESSED"
            elif b < a * (1.0 - thr):
                verdict = "improved"
            else:
                verdict = "ok"
        elif b < a * (1.0 - thr):
            verdict = "REGRESSED"
        elif b > a * (1.0 + thr):
            verdict = "improved"
        else:
            verdict = "ok"
        rows.append({"metric": metric, "old": a, "new": b,
                     "ratio": ratio, "threshold": thr,
                     "lower_is_better": lower,
                     "verdict": verdict})
    return rows


def format_table(rows: list[dict]) -> str:
    if not rows:
        return "(no tracked metrics common to both files)"
    w = max(len(r["metric"]) for r in rows)
    lines = [f"{'metric':<{w}}  {'old':>12}  {'new':>12}  "
             f"{'ratio':>6}  {'budget':>6}  verdict"]
    for r in rows:
        sign = "+" if r.get("lower_is_better") else "-"
        lines.append(
            f"{r['metric']:<{w}}  {r['old']:>12.4f}  {r['new']:>12.4f}  "
            f"{r['ratio']:>6.2f}  {sign}{r['threshold'] * 100:>4.0f}%  "
            f"{r['verdict']}")
    regressed = [r["metric"] for r in rows
                 if r["verdict"] == "REGRESSED"]
    if regressed:
        lines.append(f"REGRESSION: {', '.join(regressed)} dropped past "
                     "budget")
    else:
        lines.append(f"ok: {len(rows)} tracked metric(s) within budget")
    return "\n".join(lines)


def run(old_path: str, new_path: str,
        threshold: float | None = None) -> tuple[str, bool]:
    """(report text, regressed?) — the CLI's whole job."""
    rows = compare(load_bench(old_path), load_bench(new_path),
                   threshold)
    return (format_table(rows),
            any(r["verdict"] == "REGRESSED" for r in rows))
