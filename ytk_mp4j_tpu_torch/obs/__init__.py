"""mp4j-scope — cluster-wide observability.

A copy of ``ytk_mp4j_tpu/obs/__init__.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

Layers on top of the stats measurement substrate:

- :mod:`ytk_mp4j_tpu_torch.obs.spans` — a bounded in-process span ring fed by
  the always-on :class:`~ytk_mp4j_tpu_torch.utils.stats.CommStats` phase
  counters and the ``trace.traced`` collective wrappers; exported as
  Chrome-trace/Perfetto JSON (``trace.export_chrome_trace``).
- :mod:`ytk_mp4j_tpu_torch.obs.telemetry` — pure functions over per-rank
  telemetry: heartbeat progress records, cross-rank skew aggregation
  (``cluster_skew``) and hang diagnosis rendering
  (``render_diagnosis``). The master (``comm/master.py``) is the stateful
  consumer; this module deliberately imports nothing from ``comm`` so
  the CLI and the master share one implementation without a cycle.
- :mod:`ytk_mp4j_tpu_torch.obs.metrics` — the live metrics plane:
  counters/gauges/log2-bucket histograms, heartbeat delta shipping,
  sliding rate windows, and the Prometheus renderer behind the
  master's ``MP4J_METRICS_PORT`` endpoint.
- :mod:`ytk_mp4j_tpu_torch.obs.postmortem` — the flight recorder:
  per-rank crash bundles on any terminal abort
  (``MP4J_POSTMORTEM_DIR``), the master manifest, and the merged
  report behind ``mp4j-scope postmortem``.
- :mod:`ytk_mp4j_tpu_torch.obs.benchdiff` — the perf regression gate behind
  ``mp4j-scope bench-diff``: per-metric budgets over
  ``bench.py`` JSON outputs.
- :mod:`ytk_mp4j_tpu_torch.obs.sink` — mp4j-trail: the durable
  streaming telemetry sink draining the span/metrics/audit/recovery
  rings into crc-framed rotating segment files (``MP4J_SINK_DIR``,
  per-rank budget, torn-tail-tolerant reader).
- :mod:`ytk_mp4j_tpu_torch.obs.critpath` — cross-rank per-collective
  timeline reconstruction over sink segments with critical-path
  dominator attribution, per-phase wait decomposition and
  straggler-onset trend detection (``mp4j-scope analyze``/``tail``).
- :mod:`ytk_mp4j_tpu_torch.obs.health` — mp4j-health: the
  streaming health plane interpreting the other three — rolling
  per-rank baselines, a detector set (online critpath dominance,
  latency drift, storms, sink outages, backlog growth, heartbeat
  flapping, audit escalation) and the per-rank hysteresis verdict
  machine behind ``Master.health_status()``, the ``alerts`` sink
  records and ``mp4j-scope health``.
- :mod:`ytk_mp4j_tpu_torch.obs.cli` — the ``mp4j-scope`` CLI: merge per-rank
  Chrome-trace files into one timeline; render the cross-rank skew
  table from per-rank ``comm.stats()`` JSON dumps; ``live`` /
  ``postmortem`` / ``replay`` / ``analyze`` / ``tail`` / ``health`` /
  ``bench-diff``.
"""
