"""Findings and rendering for mp4j-lint.

A :class:`Finding` is one rule violation pinned to ``file:line:col``
with a severity and the enclosing scope (``Class.method``) — the scope
is what baseline suppressions key on, so findings survive line drift
from unrelated edits.
"""

from __future__ import annotations

import dataclasses
import enum
import json

# Directory names that anchor a display path at a package root: the
# port's own, and the JAX package's, whose layout the port mirrors
# module for module (snippets and trees written under either name name
# the same modules and match the same baseline keys).
PACKAGE_ROOTS = ("ytk_mp4j_tpu_torch", "ytk_mp4j_tpu")


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR"
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # "R1".."R7", or "E001" for parse failures
    severity: Severity
    path: str            # as given to the engine (normalized to posix)
    line: int
    col: int
    message: str
    context: str = "<module>"   # enclosing Class.func qualname

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.severity}: {self.message} "
                f"[{self.context}]")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["severity"] = str(self.severity)
        return d


def render_text(findings, suppressed_count: int = 0) -> str:
    lines = [f.format() for f in findings]
    n = len(findings)
    noun = "finding" if n == 1 else "findings"
    tail = f"{n} {noun}"
    if suppressed_count:
        tail += f" ({suppressed_count} suppressed)"
    lines.append(tail)
    return "\n".join(lines)


def render_json(findings, suppressed_count: int = 0) -> str:
    return json.dumps({
        "findings": [f.to_dict() for f in findings],
        "suppressed": suppressed_count,
    }, indent=2, sort_keys=True)


# SARIF severity levels for the three Severity tiers
_SARIF_LEVEL = {Severity.INFO: "note",
                Severity.WARNING: "warning",
                Severity.ERROR: "error"}

_SARIF_SCHEMA_URI = ("https://raw.githubusercontent.com/oasis-tcs/"
                     "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def render_sarif(findings, rule_classes=()) -> str:
    """The findings as a SARIF 2.1.0 log (one run, driver mp4j-lint).

    ``rule_classes`` is the rule catalogue that RAN (not just the rules
    that fired): SARIF viewers use ``tool.driver.rules`` to render the
    catalogue, and an empty-results log should still carry it so "0
    findings" is distinguishable from "0 rules ran". ``ruleIndex`` on
    each result points into that array. The scope qualname the baseline
    keys on travels as a partial fingerprint, so result identity
    survives line drift exactly like baseline matching does.
    """
    rules = []
    index: dict[str, int] = {}
    for cls in rule_classes:
        index[cls.rule_id] = len(rules)
        rules.append({
            "id": cls.rule_id,
            "name": cls.title.title().replace(" ", "").replace("-", ""),
            "shortDescription": {"text": cls.title},
            "fullDescription": {"text": cls.description},
            "defaultConfiguration": {
                "level": _SARIF_LEVEL[cls.severity]},
        })
    results = []
    for f in findings:
        res = {
            "ruleId": f.rule,
            "level": _SARIF_LEVEL.get(f.severity, "warning"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(f.line, 1),
                               "startColumn": max(f.col, 1)},
                },
            }],
            "partialFingerprints": {"mp4jContext/v1": f.context},
        }
        if f.rule in index:
            res["ruleIndex"] = index[f.rule]
        results.append(res)
    return json.dumps({
        "$schema": _SARIF_SCHEMA_URI,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "mp4j-lint",
                "informationUri":
                    "https://github.com/ytk-mp4j/ytk-mp4j-tpu",
                "rules": rules,
            }},
            "columnKind": "utf16CodeUnits",
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }, indent=2, sort_keys=True)
