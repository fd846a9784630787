"""``mp4j-lint`` — collective-protocol static analyzer CLI.

Usage::

    mp4j-lint [paths...]              # default: ytk_mp4j_tpu_torch
    mp4j-lint --json                  # machine-readable findings
    mp4j-lint --explain R20           # catalogue entry + firing example
    mp4j-lint --strict                # stale baseline entries are findings
    mp4j-lint --prune-baseline        # rewrite the baseline minus stale rows
    mp4j-lint graph --dot             # the discovered lock-order graph
    mp4j-lint races [--dot]           # the shared-field -> lockset map
    mp4j-lint --sarif out.sarif       # SARIF 2.1.0 log for CI viewers
    mp4j-lint diff-sarif OLD NEW      # nonzero only on NEW fingerprints
    python -m ytk_mp4j_tpu_torch.analysis ytk_mp4j_tpu_torch/

``mp4j-lint`` stands for ``python -m ytk_mp4j_tpu_torch.analysis``: the
port installs no console script (the ``mp4j-lint`` script runs the JAX
package's copy, with its own baseline).

Exit codes: 0 clean, 1 unsuppressed findings, 2 bad invocation or
unreadable baseline. By default the committed baseline
(``ytk_mp4j_tpu_torch/analysis/baseline.toml``) is applied; ``--no-baseline``
shows everything, ``--write-baseline`` accepts the current findings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import textwrap

from ytk_mp4j_tpu_torch.analysis import baseline as baseline_mod
from ytk_mp4j_tpu_torch.analysis.engine import Engine, Program, ProgramRule
from ytk_mp4j_tpu_torch.analysis.report import (render_json, render_sarif,
                                          render_text)
from ytk_mp4j_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_ID, get_rules
from ytk_mp4j_tpu_torch.exceptions import Mp4jError

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.toml")


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mp4j-lint",
        description=("static analyzer for distributed-correctness hazards "
                     "in the mp4j comm stack"))
    ap.add_argument("paths", nargs="*", default=["ytk_mp4j_tpu_torch"],
                    help="files or directories to lint "
                         "(default: ytk_mp4j_tpu_torch)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="suppression file (default: the committed "
                         "analysis/baseline.toml)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline; report every finding")
    ap.add_argument("--select", default=None, metavar="R1,R2,...",
                    help="run only these rule ids")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--json", action="store_true",
                    help="shorthand for --format json (editors/CI)")
    ap.add_argument("--strict", action="store_true",
                    help="stale baseline entries (matching no finding) "
                         "are B001 findings — the tier-1 gate's mode")
    ap.add_argument("--write-baseline", metavar="PATH", default=None,
                    help="write a baseline accepting the current "
                         "unsuppressed findings, then exit 0")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="rewrite the baseline file keeping only the "
                         "entries that still match a finding")
    ap.add_argument("--sarif", metavar="OUT.sarif", default=None,
                    help="also write the findings as a SARIF 2.1.0 "
                         "log to OUT.sarif (for CI annotation viewers)")
    ap.add_argument("--explain", metavar="RN", default=None,
                    help="print one rule's catalogue entry and a "
                         "firing example, then exit")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    return ap


def _build_races_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mp4j-lint races",
        description=("dump the shared-field -> lockset map discovered "
                     "by the R23 lockset analysis: every mutable field "
                     "reachable from >= 2 thread roots, which locks "
                     "its access sites hold (and how consistently), "
                     "and a witness pair for each inconsistency"))
    ap.add_argument("paths", nargs="*", default=["ytk_mp4j_tpu_torch"])
    ap.add_argument("--dot", action="store_true",
                    help="GraphViz DOT output (default: text report)")
    ap.add_argument("-o", "--output", default=None, metavar="FILE",
                    help="write to FILE instead of stdout")
    return ap


def _build_graph_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mp4j-lint graph",
        description=("dump the whole-program lock-order graph "
                     "discovered by the R19-R21 analysis: nodes are "
                     "lock attributes with their defining class, edges "
                     "are observed acquisition orders with one witness "
                     "call chain each"))
    ap.add_argument("paths", nargs="*", default=["ytk_mp4j_tpu_torch"])
    ap.add_argument("--dot", action="store_true",
                    help="GraphViz DOT output (default: text edges)")
    ap.add_argument("-o", "--output", default=None, metavar="FILE",
                    help="write to FILE instead of stdout")
    return ap


def _explain(rule_id: str) -> int:
    cls = RULES_BY_ID.get(rule_id)
    if cls is None:
        print(f"mp4j-lint: unknown rule id {rule_id!r} "
              f"(see --list-rules)", file=sys.stderr)
        return 2
    print(f"{cls.rule_id} ({cls.severity!s}) — {cls.title}")
    print()
    print(textwrap.fill(cls.description, width=72))
    example = getattr(cls, "example", "")
    if example:
        print("\nfiring example:\n")
        for line in example.rstrip().splitlines():
            print("    " + line)
        # show the rule actually firing on its own example — the
        # catalogue stays honest by construction (tested in tier-1)
        rule = cls()
        eng = Engine(rules=[rule])
        path = getattr(cls, "example_path",
                       "ytk_mp4j_tpu_torch/comm/example.py")
        result = eng.lint_source(example, path)
        hits = [f for f in result.findings if f.rule == cls.rule_id]
        print("\nfires:")
        for f in hits:
            print(f"    line {f.line}: {f.message[:100]}"
                  + ("..." if len(f.message) > 100 else ""))
        if not hits:
            print("    (example did not fire — catalogue bug)")
            return 2
    return 0


def _load_program(paths, prog: str):
    contexts, errors = Engine(rules=[]).load_contexts(paths)
    for f in errors:
        print(f"mp4j-lint {prog}: skipped {f.path}: {f.message}",
              file=sys.stderr)
    if not contexts:
        print(f"mp4j-lint {prog}: no parsable files", file=sys.stderr)
        return None
    return Program(contexts)


def _emit(out: str, output: str | None) -> None:
    if output:
        tmp = output + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(out + "\n")
        os.replace(tmp, output)
        print(f"mp4j-lint: wrote {output}")
    else:
        print(out)


def _races_main(argv) -> int:
    args = _build_races_parser().parse_args(argv)
    program = _load_program(args.paths, "races")
    if program is None:
        return 2
    model = program.races
    _emit(model.to_dot() if args.dot else model.to_text(), args.output)
    return 0


def _graph_main(argv) -> int:
    args = _build_graph_parser().parse_args(argv)
    program = _load_program(args.paths, "graph")
    if program is None:
        return 2
    model = program.locks
    if args.dot:
        out = model.to_dot()
    else:
        lines = [f"{len(model.locks)} locks, {len(model.edges)} "
                 f"order edges, {len(model.cycles())} cycle(s)"]
        for (_s, _d), e in sorted(model.edges.items()):
            lines.append("  " + model.format_witness(e))
        for scc in model.cycles():
            lines.append("  CYCLE: " + " <-> ".join(
                model.locks[k].display for k in scc))
        out = "\n".join(lines)
    _emit(out, args.output)
    return 0


def _build_diff_sarif_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mp4j-lint diff-sarif",
        description=("compare two SARIF logs by result fingerprint "
                     "and exit nonzero ONLY when NEW carries findings "
                     "whose partialFingerprints are absent from OLD — "
                     "the ratchet CI gate: pre-existing findings never "
                     "block, line drift never false-alarms (the "
                     "fingerprint is the scope qualname, not a line "
                     "number)"))
    ap.add_argument("old", help="baseline SARIF log")
    ap.add_argument("new", help="candidate SARIF log")
    return ap


def _sarif_result_keys(doc) -> dict[tuple, dict]:
    """Identity map of a SARIF log's results: ``(ruleId, artifact
    uri, sorted partialFingerprints) -> result``. Line numbers are
    deliberately NOT part of the key."""
    out: dict[tuple, dict] = {}
    for run in doc.get("runs") or []:
        for res in run.get("results") or []:
            locs = res.get("locations") or [{}]
            uri = (locs[0].get("physicalLocation") or {}) \
                .get("artifactLocation", {}).get("uri", "")
            fp = tuple(sorted(
                (res.get("partialFingerprints") or {}).items()))
            out.setdefault((res.get("ruleId"), uri, fp), res)
    return out


def _diff_sarif_main(argv) -> int:
    args = _build_diff_sarif_parser().parse_args(argv)
    docs = []
    for path in (args.old, args.new):
        try:
            with open(path, encoding="utf-8") as fh:
                docs.append(json.load(fh))
        except (OSError, ValueError) as e:
            print(f"mp4j-lint diff-sarif: unreadable {path}: {e}",
                  file=sys.stderr)
            return 2
    old_keys = set(_sarif_result_keys(docs[0]))
    fresh = [(k, r) for k, r in _sarif_result_keys(docs[1]).items()
             if k not in old_keys]
    for (rule, uri, _fp), res in fresh:
        region = (res.get("locations") or [{}])[0] \
            .get("physicalLocation", {}).get("region", {})
        msg = res.get("message", {}).get("text", "")
        print(f"NEW {rule} {uri}:{region.get('startLine', 0)} {msg}")
    print(f"mp4j-lint diff-sarif: {len(fresh)} new finding(s)")
    return 1 if fresh else 0


def _baseline_header(path: str) -> str | None:
    """The leading comment block of the committed baseline, preserved
    across --prune-baseline rewrites."""
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return None
    head: list[str] = []
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            head.append(line)
        else:
            break
    while head and not head[-1].strip():
        head.pop()
    return "\n".join(head) if head else None


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "graph":
        return _graph_main(argv[1:])
    if argv and argv[0] == "races":
        return _races_main(argv[1:])
    if argv and argv[0] == "diff-sarif":
        return _diff_sarif_main(argv[1:])
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            scope = ("whole-program"
                     if issubclass(cls, ProgramRule) else "per-file")
            print(f"{cls.rule_id}  {cls.severity!s:7s} [{scope}] "
                  f"{cls.title}: {cls.description}")
        return 0
    if args.explain:
        return _explain(args.explain.strip())

    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
    try:
        rules = get_rules(select)
    except KeyError as e:
        print(f"mp4j-lint: {e.args[0]}", file=sys.stderr)
        return 2

    bl = None
    if args.write_baseline:
        # regeneration must see EVERY finding, or entries the current
        # baseline already suppresses would be silently dropped
        args.no_baseline = True
    if not args.no_baseline and os.path.exists(args.baseline):
        try:
            bl = baseline_mod.load(args.baseline)
        except (Mp4jError, OSError) as e:
            print(f"mp4j-lint: bad baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
    if args.prune_baseline and bl is None:
        print("mp4j-lint: --prune-baseline needs a readable baseline",
              file=sys.stderr)
        return 2

    eng = Engine(rules=rules, baseline=bl,
                 strict_baseline=args.strict,
                 baseline_path=args.baseline)
    result = eng.lint_paths(args.paths)

    if args.write_baseline:
        text = baseline_mod.render(result.findings,
                                   reason="accepted by --write-baseline")
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"mp4j-lint: wrote {len(result.findings)} suppression(s) "
              f"to {args.write_baseline}")
        return 0

    if args.prune_baseline:
        # only entries PROVABLY stale for this run are dropped: their
        # rule ran and their file was in scope — `--select R18
        # --prune-baseline` or a single-file path keeps every entry it
        # could not judge (code-review finding)
        stale_ids = {id(e) for e in eng.stale_entries(
            eng.last_linted_paths)}
        kept = [e for e in bl.entries if id(e) not in stale_ids]
        stale = len(bl.entries) - len(kept)
        text = baseline_mod.render_entries(
            kept, header=_baseline_header(args.baseline))
        tmp = args.baseline + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
        os.replace(tmp, args.baseline)
        print(f"mp4j-lint: pruned {stale} stale entr"
              f"{'y' if stale == 1 else 'ies'}, kept {len(kept)} "
              f"in {args.baseline}")
        return 0

    if args.sarif:
        sarif = render_sarif(
            result.findings, [type(r) for r in rules])
        tmp = args.sarif + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(sarif + "\n")
        os.replace(tmp, args.sarif)
        print(f"mp4j-lint: wrote SARIF log {args.sarif}",
              file=sys.stderr)

    if args.format == "json" or args.json:
        print(render_json(result.findings, len(result.suppressed)))
    else:
        print(render_text(result.findings, len(result.suppressed)))
        if bl is not None and not args.strict:
            for e in bl.unused():
                print(f"note: unused baseline suppression "
                      f"({e.rule} {e.file} {e.context})", file=sys.stderr)
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
