"""R27 — HTTP fetch without an explicit timeout in obs/ code.

The observability planes scrape live masters over HTTP
(``mp4j-scope live``, the fleet poller). ``urllib.request.urlopen``
and raw ``http.client`` connections default to NO timeout — the
socket blocks forever — so an unbounded fetch wedges the scrape loop
exactly when a master hangs, which is exactly when the operator needs
the view. Every fetch in ``obs/`` must carry an explicit
bound: ``timeout=`` (or the positional timeout slot), with the
staleness state machine — not the socket — deciding what a silent
master means.

Scoped to ``obs/``: the comm planes own their socket discipline under
R2, and analysis/test code fetching fixtures is not a scrape loop.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, call_name
from ytk_mp4j_tpu_torch.analysis.report import Severity

# urlopen(url, data=None, timeout=...) — timeout is the 3rd
# positional; HTTPConnection(host, port=..., timeout=...) likewise
_FETCHERS = {"urlopen": 3, "HTTPConnection": 3, "HTTPSConnection": 3}


class R27HttpNoTimeout(Rule):
    rule_id = "R27"
    severity = Severity.WARNING
    title = "HTTP fetch without explicit timeout"
    description = ("urllib.request.urlopen / http.client connection "
                   "in obs/ without timeout= — a hung master wedges "
                   "the scrape loop exactly when the view matters")
    example = """\
import urllib.request

def scrape(base):
    with urllib.request.urlopen(base + "/metrics.json") as resp:
        return resp.read()      # blocks forever on a hung master
"""
    example_path = "ytk_mp4j_tpu_torch/obs/example.py"

    def visit_Call(self, node: ast.Call):       # noqa: N802
        name = call_name(node)
        slot = _FETCHERS.get(name)
        if slot is not None and self.ctx.in_dirs("obs"):
            has_kw = any(kw.arg == "timeout" for kw in node.keywords)
            # a **kwargs splat may carry the timeout — out of static
            # reach, give it the benefit of the doubt
            has_splat = any(kw.arg is None for kw in node.keywords)
            if not has_kw and not has_splat and len(node.args) < slot:
                self.report(node, (
                    f"{name}(...) with no explicit timeout: the "
                    f"socket default is block-forever, so a hung "
                    f"endpoint wedges this scrape thread exactly "
                    f"when the fleet/live view is needed most — "
                    f"pass timeout= and let the staleness state "
                    f"machine interpret silence"))
        self.generic_visit(node)
