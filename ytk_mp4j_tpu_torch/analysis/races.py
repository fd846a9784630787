"""Eraser/RacerD-style lockset race analysis.

The lock model answers "what is held HERE"; this module answers the
question every hand-written hardening pass in CHANGES.md was chasing:
*which lock protects which shared field, and is it always the same
one?* The classic lockset discipline, adapted to the package:

1. **Thread roots** — the entry points concurrency actually flows
   from: every ``threading.Thread(target=...)`` / ``Timer(...)``
   callback, every callable registered as a ``*_hook``/``*_cb``, and
   one merged ``main`` root for the public API surface (the collective
   path). Constructors are NOT roots: ``__init__``-time writes happen
   before the object is published, the classic happens-before edge.
2. **Reachability with lock contexts** — for each root, a monotone
   fixpoint over the call graph computes the set of held-lock contexts
   each function can be entered under (``{} ∪ caller-held`` per call
   edge; reuses :mod:`callgraph` resolution and the per-call held sets
   of :mod:`locks`).
3. **Site records** — every :class:`~ytk_mp4j_tpu_torch.analysis.locks.
   AccessEvent` of a reachable function becomes ``(root, site, write,
   lockset)`` records, one per entry context, with the local held set
   unioned in. Field identity is canonicalized to the DEEPEST base
   class that assigns the attribute, so a base-class field written
   through two subclasses is one field.
4. **The verdict** — a field is *shared* when records from >= 2
   distinct roots exist and at least one is a write; it is *racy*
   when some write's lockset has empty intersection with some other
   root's access lockset. The report carries both witness sites, the
   roots that reach them, and the candidate lock (the lock most often
   held across the field's accesses — the one the fix should use).

Missed call edges and unresolvable receivers drop records, never
invent them: like the rest of the analysis stack, a finding here is a
witnessed interleaving, not a guess.
"""

from __future__ import annotations

import ast
import dataclasses

from ytk_mp4j_tpu_torch.analysis.engine import attr_chain
from ytk_mp4j_tpu_torch.analysis.locks import _is_hookish

# entry contexts per function per root are capped; past the cap the
# set collapses to its intersection (= the locks GUARANTEED held),
# which can only make a field look less protected — the sound
# direction for a race detector
_MAX_CONTEXTS = 16


@dataclasses.dataclass(frozen=True)
class SiteRecord:
    """One access to a shared field from one root, with its lockset."""

    root: str                    # "main" | "thread:Cls.meth" | "hook:..."
    path: str
    lineno: int
    func: str                    # display of the accessing function
    write: bool
    lockset: frozenset[str]      # LockDecl keys held at the site


@dataclasses.dataclass
class FieldReport:
    """The lockset verdict for one shared mutable field."""

    owner: str                   # canonical ClassInfo key
    attr: str
    records: list[SiteRecord]
    roots: tuple[str, ...]
    racy: bool
    # (write site, conflicting other-root site) when racy
    witness: tuple[SiteRecord, SiteRecord] | None
    candidate: str | None        # lock key the fix should take

    @property
    def display(self) -> str:
        cls = self.owner.rsplit(":", 1)[-1]
        return f"{cls}.{self.attr}"


class RaceModel:
    """Thread roots + per-root lock contexts + shared-field records."""

    def __init__(self, index, locks):
        self.index = index
        self.locks = locks
        # root id -> entry function keys
        self.roots: dict[str, set[str]] = {}
        # class key -> attrs its OWN methods assign to ``self`` —
        # filled by _discover_roots in the same walk that finds roots
        self._declared: dict[str, set[str]] = {}
        self._discover_roots()
        # (owner, attr) -> [SiteRecord]
        self.fields: dict[tuple[str, str], list[SiteRecord]] = {}
        for root, entries in self.roots.items():
            self._collect(root, entries)
        self._reports: list[FieldReport] | None = None

    # -- field identity -------------------------------------------------
    def canonical_owner(self, owner_key: str, attr: str) -> str:
        """The deepest base class that assigns ``attr`` — merges a
        base-class field accessed through several subclasses."""
        ci = self.index.classes.get(owner_key)
        if ci is None:
            return owner_key
        cand = owner_key
        for c in self.index.mro(ci):      # nearest first
            if attr in self._declared.get(c.key, ()):
                cand = c.key
        return cand

    # -- thread-root discovery ------------------------------------------
    def _discover_roots(self) -> None:
        thread_entries: set[str] = set()
        for fkey, s in self.locks.summaries.items():
            fi = s.func
            # the same walk also records which attrs this method
            # assigns to ``self`` (canonical_owner's evidence) — one
            # pass over every function node, not two
            decl = None if fi.cls is None else self._declared.setdefault(
                f"{fi.module.name}:{fi.cls}", set())
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call):
                    self._root_from_call(node, fi, thread_entries)
                elif isinstance(node, ast.Assign):
                    if len(node.targets) == 1:
                        ch = attr_chain(node.targets[0])
                        if ch and _is_hookish(ch[-1]):
                            for t in self._func_ref(node.value, fi):
                                self._add_root(f"hook:{t.display}", t,
                                               thread_entries)
                    if decl is not None:
                        for t in node.targets:
                            ch = attr_chain(t)
                            if ch and len(ch) == 2 and ch[0] == "self":
                                decl.add(ch[1])
                elif decl is not None and isinstance(
                        node, (ast.AnnAssign, ast.AugAssign)):
                    ch = attr_chain(node.target)
                    if ch and len(ch) == 2 and ch[0] == "self":
                        decl.add(ch[1])
        # the merged "main" root: the public API surface — public
        # functions NO internal code calls. A public method with an
        # internal caller (the master invoking HealthEngine.fold
        # under its lock) is plumbing: its concurrency contexts are
        # the CALLERS' paths, and inventing an extra bare-entry
        # context would report every such site as lock-free. Thread
        # targets are excluded too (target=self.run only runs there).
        called: set[str] = set()
        for fkey, s in self.locks.summaries.items():
            for call in s.calls:
                called.update(c for c in call.callees if c != fkey)
        main: set[str] = set()
        for fi in self.index.functions.values():
            if fi.name.startswith("_"):
                continue
            if fi.key in thread_entries or fi.key in called:
                continue
            main.add(fi.key)
        if main:
            self.roots["main"] = main

    def _root_from_call(self, call: ast.Call, fi, thread_entries):
        chain = attr_chain(call.func) or []
        name = chain[-1] if chain else None
        # type resolution is the expensive step: only a call carrying
        # a ``target=`` keyword can mint a thread root, so every other
        # call skips it (a Thread ctor without target= contributes no
        # root either way)
        if any(kw.arg == "target" for kw in call.keywords):
            t = self.index.type_of_expr(call, fi.module)
            if t == "threading.Thread":
                for kw in call.keywords:
                    if kw.arg == "target":
                        for tgt in self._func_ref(kw.value, fi):
                            self._add_root(f"thread:{tgt.display}", tgt,
                                           thread_entries)
                return
        if name == "Timer" and (
                chain == ["threading", "Timer"]
                or (len(chain) == 1 and fi.module.from_names.get(
                    "Timer", ("", ""))[1] == "Timer")):
            cb = call.args[1] if len(call.args) >= 2 else None
            for kw in call.keywords:
                if kw.arg == "function":
                    cb = kw.value
            if cb is not None:
                for tgt in self._func_ref(cb, fi):
                    self._add_root(f"thread:{tgt.display}", tgt,
                                   thread_entries)
            return
        # callable registered through a hookish keyword: runs on
        # whatever thread fires the hook — its own root
        for kw in call.keywords:
            if kw.arg and _is_hookish(kw.arg):
                for tgt in self._func_ref(kw.value, fi):
                    self._add_root(f"hook:{tgt.display}", tgt,
                                   thread_entries)

    def _add_root(self, root_id: str, fi, thread_entries: set) -> None:
        self.roots.setdefault(root_id, set()).add(fi.key)
        thread_entries.add(fi.key)

    def _func_ref(self, expr, fi) -> list:
        """Resolve a function/bound-method REFERENCE expression."""
        ch = attr_chain(expr)
        if not ch:
            return []
        if len(ch) == 1:
            t = fi.module.functions.get(ch[0])
            return [t] if t is not None else []
        owner = self.index._owner_class(ch[:-1], fi, {})
        if owner is not None:
            t = self.index.lookup_method(owner, ch[-1])
            return [t] if t is not None else []
        return []

    # -- reachability with lock contexts --------------------------------
    def _reach_contexts(self, entries) -> dict[str, set[frozenset]]:
        ctxs: dict[str, set[frozenset]] = {}
        work: list[str] = []
        for e in entries:
            if e in self.locks.summaries:
                ctxs[e] = {frozenset()}
                work.append(e)
        while work:
            f = work.pop()
            for call in self.locks.summaries[f].calls:
                h = frozenset(call.held)
                for ckey in call.callees:
                    if ckey == f or ckey not in self.locks.summaries:
                        continue
                    cur = ctxs.setdefault(ckey, set())
                    new = {c | h for c in ctxs[f]} - cur
                    if not new:
                        continue
                    cur |= new
                    if len(cur) > _MAX_CONTEXTS:
                        inter = frozenset.intersection(*cur)
                        cur.clear()
                        cur.add(inter)
                    work.append(ckey)
        return ctxs

    def _collect(self, root: str, entries) -> None:
        for fkey, cset in self._reach_contexts(entries).items():
            s = self.locks.summaries[fkey]
            fi = s.func
            for a in s.accesses:
                owner = self.canonical_owner(a.owner, a.attr)
                recs = self.fields.setdefault((owner, a.attr), [])
                for c in cset:
                    recs.append(SiteRecord(
                        root, fi.path, a.lineno, fi.display, a.write,
                        c | frozenset(a.held)))

    # -- verdicts -------------------------------------------------------
    def field_reports(self) -> list[FieldReport]:
        if self._reports is not None:
            return self._reports
        out: list[FieldReport] = []
        for (owner, attr), recs in sorted(self.fields.items()):
            recs = self._dedup(recs)
            roots = tuple(sorted({r.root for r in recs}))
            writes = [r for r in recs if r.write]
            racy = False
            witness = None
            if len(roots) >= 2 and writes:
                racy, witness = self._find_race(recs, writes)
            out.append(FieldReport(
                owner=owner, attr=attr, records=recs, roots=roots,
                racy=racy, witness=witness,
                candidate=self._candidate(recs)))
        self._reports = out
        return out

    @staticmethod
    def _dedup(recs: list[SiteRecord]) -> list[SiteRecord]:
        """One record per (root, site, lockset); a write at a site
        subsumes the read the walker also recorded there."""
        write_sites = {(r.root, r.path, r.lineno, r.lockset)
                       for r in recs if r.write}
        seen: set = set()
        out: list[SiteRecord] = []
        for r in sorted(recs, key=lambda r: (r.path, r.lineno,
                                             not r.write, r.root,
                                             sorted(r.lockset))):
            if not r.write and (r.root, r.path, r.lineno,
                                r.lockset) in write_sites:
                continue
            key = (r.root, r.path, r.lineno, r.write, r.lockset)
            if key in seen:
                continue
            seen.add(key)
            out.append(r)
        return out

    @staticmethod
    def _find_race(recs, writes):
        """First (write, other-root access) pair with disjoint
        locksets; pairs where a lock was held SOMEWHERE are preferred
        so the witness names the broken discipline, not just two bare
        sites. Pairs at the SAME site are skipped: "one function,
        reachable from two roots, racing with itself at one line" is
        the entry-enumeration artifact (serve() run inline vs on a
        thread), not two distinct accesses — a genuinely racy field
        always has a second site to witness with."""
        best = None
        for w in writes:
            for o in recs:
                if o.root == w.root:
                    continue
                if (o.path, o.lineno) == (w.path, w.lineno):
                    continue
                if w.lockset & o.lockset:
                    continue
                pair = (w, o)
                if w.lockset or o.lockset:
                    return True, pair
                if best is None:
                    best = pair
        return (True, best) if best is not None else (False, None)

    @staticmethod
    def _candidate(recs) -> str | None:
        counts: dict[str, int] = {}
        for r in recs:
            for lk in r.lockset:
                counts[lk] = counts.get(lk, 0) + 1
        if not counts:
            return None
        return max(sorted(counts), key=lambda k: counts[k])

    # -- views ----------------------------------------------------------
    def shared_fields(self) -> list[FieldReport]:
        """Fields reachable from >= 2 roots with a write involved —
        the concurrency contract surface ``mp4j-lint races`` prints."""
        return [fr for fr in self.field_reports()
                if len(fr.roots) >= 2 and any(r.write
                                              for r in fr.records)]

    def to_text(self) -> str:
        shared = self.shared_fields()
        racy = [fr for fr in shared if fr.racy]
        lines = [f"{len(self.roots)} thread roots, {len(shared)} "
                 f"shared mutable fields, {len(racy)} with "
                 f"inconsistent locksets"]
        for fr in shared:
            locks = self._lock_coverage(fr)
            cov = ", ".join(
                f"{self.locks.locks[k].display}:{n}/{len(fr.records)}"
                for k, n in locks) or "none"
            verdict = "RACE" if fr.racy else "ok"
            lines.append(f"  {fr.display}  roots=[{', '.join(fr.roots)}]"
                         f"  locks held: {cov}  {verdict}")
            if fr.racy and fr.witness:
                w, o = fr.witness
                lines.append(
                    f"    write {w.path}:{w.lineno} ({w.func}, "
                    f"{w.root}) holds "
                    f"[{self._names(w.lockset)}] vs "
                    f"{'write' if o.write else 'read'} "
                    f"{o.path}:{o.lineno} ({o.func}, {o.root}) holds "
                    f"[{self._names(o.lockset)}]")
        return "\n".join(lines)

    def _lock_coverage(self, fr: FieldReport):
        counts: dict[str, int] = {}
        for r in fr.records:
            for lk in r.lockset:
                counts[lk] = counts.get(lk, 0) + 1
        return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))

    def _names(self, lockset) -> str:
        return ", ".join(sorted(self.locks.locks[k].display
                                for k in lockset))

    def to_dot(self) -> str:
        """The shared-field -> lockset graph as GraphViz DOT: field
        boxes (red when racy), lock ovals, an edge per (field, lock)
        labeled with how many of the field's access sites hold it."""
        lines = ["digraph mp4j_shared_fields {",
                 "  rankdir=LR;",
                 '  node [fontname="monospace"];']
        shared = self.shared_fields()
        used_locks: set[str] = set()
        for fr in shared:
            color = ', color=red' if fr.racy else ''
            lines.append(
                f'  "{fr.owner}.{fr.attr}" [shape=box, '
                f'label="{fr.display}\\nroots: '
                f'{", ".join(fr.roots)}"{color}];')
            for lk, n in self._lock_coverage(fr):
                used_locks.add(lk)
                style = ("solid" if n == len(fr.records) else "dashed")
                lines.append(
                    f'  "{fr.owner}.{fr.attr}" -> "{lk}" '
                    f'[label="{n}/{len(fr.records)}", style={style}];')
        for lk in sorted(used_locks):
            d = self.locks.locks[lk]
            lines.append(f'  "{lk}" [shape=oval, '
                         f'label="{d.display}\\n{d.kind}"];')
        lines.append("}")
        return "\n".join(lines)
