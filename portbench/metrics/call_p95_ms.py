"""call_p95_ms: the 95th percentile of every call's host time in the
window (its start to its synchronised end), interpolated between ranks."""

import statistics


def read(run):
    calls = run.window.get("call_s")
    if not calls:
        return None
    if len(calls) == 1:
        return calls[0] * 1e3
    return statistics.quantiles(calls, n=20, method="inclusive")[18] * 1e3
