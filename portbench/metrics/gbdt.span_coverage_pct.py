"""gbdt.span_coverage_pct: the share of the traced window's device time
(every kernel, copy and fill) launched inside the trainer's
``gbdt::round`` spans; what lies outside is the harness's."""

from portbench.spans import device_s


def read(run):
    inside = device_s(run.trace, "gbdt::round")
    if inside is None:
        return None
    total = run.trace.device_s(lambda e: True)
    return 100 * inside / total if total > 0 else None
