"""Whole-package module index + conservative call graph.

mp4j-lint's per-file rules see one AST at a time; the concurrency
disciplines R19-R21 check are properties of CALL CHAINS — a lock
acquired here, a blocking call three frames deeper, a hook fired from
a helper of a helper. This module builds the shared substrate: a
package-wide index of modules, classes and functions, plus a call
graph whose edges are resolved CONSERVATIVELY. An edge exists only
when the callee is identified with confidence:

- ``self.m()`` / ``cls.m()`` through the enclosing class, its bases
  (resolved across modules) and class-attribute method bindings
  (``visit_AsyncFunctionDef = visit_FunctionDef``);
- ``f()`` through module-level functions and name-assignment aliases
  (``g = f``);
- ``mod.f()`` through ``import``/``from`` aliases when ``mod`` is in
  the index;
- ``self.attr.m()`` / ``local.m()`` through inferred attribute and
  local types: ``self._recovery = RecoveryManager(...)`` binds
  ``_recovery`` to that class, a parameter whose name matches exactly
  one index class case-insensitively (``master`` -> ``Master``) binds
  the same way, and a list attribute built from one constructor
  (``self._slots = [...]`` + ``self._slots.append(_Slot(...))``)
  types its subscripts and loop variables.

Unresolvable calls contribute NO edge: for the lock analyses a missed
edge can hide a finding but never invent one, which is the right
failure mode for a tier-1 gate.
"""

from __future__ import annotations

import ast
import dataclasses

from ytk_mp4j_tpu_torch.analysis.engine import LintContext, attr_chain
from ytk_mp4j_tpu_torch.analysis.report import PACKAGE_ROOTS

# constructor spellings worth typing even though the classes live
# outside the index (lock discovery + blocking-receiver typing)
_BUILTIN_TYPES = {
    ("threading", "Lock"): "threading.Lock",
    ("threading", "RLock"): "threading.RLock",
    ("threading", "Condition"): "threading.Condition",
    ("threading", "Event"): "threading.Event",
    ("threading", "Semaphore"): "threading.Semaphore",
    ("threading", "BoundedSemaphore"): "threading.Semaphore",
    ("threading", "Thread"): "threading.Thread",
    ("multiprocessing", "Process"): "threading.Thread",
    ("queue", "Queue"): "queue.Queue",
    ("queue", "SimpleQueue"): "queue.Queue",
}

# container verbs on a list:/dict:-typed receiver belong to the
# container, never to the element class
_CONTAINER_METHODS = {
    "append", "extend", "insert", "pop", "clear", "remove", "sort",
    "reverse", "index", "count", "copy", "update", "setdefault",
    "get", "items", "values", "keys", "popitem", "discard", "add",
}


def module_name_for(path: str) -> str:
    """Dotted module id for a display path: anchored at the first
    package root (:data:`~ytk_mp4j_tpu_torch.analysis.report.PACKAGE_ROOTS`)
    when one is present (``.../ytk_mp4j_tpu_torch/comm/master.py`` ->
    ``ytk_mp4j_tpu_torch.comm.master``), else the bare stem — stable
    however the linter was invoked."""
    parts = path.split("/")
    at = [i for i, seg in enumerate(parts) if seg in PACKAGE_ROOTS]
    if at:
        parts = parts[at[0]:]
    name = "/".join(parts)
    if name.endswith(".py"):
        name = name[:-3]
    if name.endswith("/__init__"):
        name = name[: -len("/__init__")]
    return name.replace("/", ".")


@dataclasses.dataclass(eq=False)
class FunctionInfo:
    """One top-level or class-level ``def`` in the index."""

    key: str                    # "ytk_mp4j_tpu_torch.comm.master:Master._serve"
    name: str
    cls: str | None             # owning class name, None for module fns
    module: "ModuleInfo"
    node: ast.FunctionDef | ast.AsyncFunctionDef

    @property
    def display(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name

    @property
    def path(self) -> str:
        return self.module.path


@dataclasses.dataclass(eq=False)
class ClassInfo:
    key: str                    # "ytk_mp4j_tpu_torch.comm.master:Master"
    name: str
    module: "ModuleInfo"
    node: ast.ClassDef
    bases: list[str] = dataclasses.field(default_factory=list)  # raw dotted
    methods: dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    # attr -> type key: a ClassInfo.key, a _BUILTIN_TYPES value, or
    # ("list", elem_key) encoded as "list:" + elem_key
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(eq=False)
class ModuleInfo:
    name: str                   # dotted id
    path: str                   # posix display path
    ctx: LintContext
    classes: dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    functions: dict[str, FunctionInfo] = dataclasses.field(
        default_factory=dict)
    imports: dict[str, str] = dataclasses.field(default_factory=dict)
    # alias -> (module dotted, original name) for `from x import y as z`
    from_names: dict[str, tuple[str, str]] = dataclasses.field(
        default_factory=dict)


class ProgramIndex:
    """The package seen whole: modules, classes, functions, and the
    resolution helpers the lock model and the R19-R21 rules share."""

    def __init__(self, contexts: list[LintContext]):
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        # suffix -> resolved module: _module_by_suffix scans the whole
        # module table per miss, and the same few dotted names resolve
        # thousands of times across the race/resource passes
        self._suffix_cache: dict[str, "ModuleInfo | None"] = {}
        for ctx in contexts:
            self._index_module(ctx)
        self._classes_ci = self._build_ci_table()
        for mod in self.modules.values():
            for ci in mod.classes.values():
                self._infer_attr_types(ci)

    # -- construction ---------------------------------------------------
    def _index_module(self, ctx: LintContext) -> None:
        mod = ModuleInfo(name=module_name_for(ctx.path), path=ctx.path,
                         ctx=ctx)
        # a stale duplicate (same dotted id from two trees) keeps the
        # first; the lint run's path set is the source of truth
        if mod.name in self.modules:
            mod = ModuleInfo(name=mod.name + "#" + ctx.path,
                             path=ctx.path, ctx=ctx)
        self.modules[mod.name] = mod
        for node in ctx.tree.body:
            if isinstance(node, (ast.Import,)):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    mod.from_names[a.asname or a.name] = (
                        node.module, a.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FunctionInfo(
                    key=f"{mod.name}:{node.name}", name=node.name,
                    cls=None, module=mod, node=node)
                mod.functions[node.name] = fi
                self.functions[fi.key] = fi
            elif isinstance(node, ast.ClassDef):
                self._index_class(mod, node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Name):
                # module-level alias: g = f
                src = mod.functions.get(node.value.id)
                if src is not None:
                    mod.functions[node.targets[0].id] = src

    def _index_class(self, mod: ModuleInfo, node: ast.ClassDef) -> None:
        ci = ClassInfo(key=f"{mod.name}:{node.name}", name=node.name,
                       module=mod, node=node)
        for b in node.bases:
            chain = attr_chain(b)
            if chain:
                ci.bases.append(".".join(chain))
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FunctionInfo(
                    key=f"{mod.name}:{node.name}.{item.name}",
                    name=item.name, cls=node.name, module=mod, node=item)
                ci.methods[item.name] = fi
                self.functions[fi.key] = fi
        for item in node.body:
            # class-attribute method binding: visit_X = visit_Y
            if isinstance(item, ast.Assign) and len(item.targets) == 1 \
                    and isinstance(item.targets[0], ast.Name) \
                    and isinstance(item.value, ast.Name) \
                    and item.value.id in ci.methods:
                ci.methods[item.targets[0].id] = ci.methods[item.value.id]
        mod.classes[node.name] = ci
        self.classes[ci.key] = ci

    def _build_ci_table(self) -> dict[str, ClassInfo | None]:
        """Case-insensitive class-name table for parameter typing;
        ambiguous names map to None (no binding)."""
        out: dict[str, ClassInfo | None] = {}
        for ci in self.classes.values():
            k = ci.name.lower().lstrip("_")
            if k in out and out[k] is not ci:
                out[k] = None
            else:
                out[k] = ci
        return out

    # -- type inference -------------------------------------------------
    def _resolve_class_name(self, mod: ModuleInfo,
                            chain: list[str]) -> ClassInfo | None:
        """Resolve a dotted constructor name to an index class."""
        if len(chain) == 1:
            name = chain[0]
            if name in mod.classes:
                return mod.classes[name]
            if name in mod.from_names:
                src_mod, orig = mod.from_names[name]
                m = self._module_by_suffix(src_mod)
                if m is not None:
                    return m.classes.get(orig)
            return None
        if len(chain) == 2:
            m = self._imported_module(mod, chain[0])
            if m is not None:
                return m.classes.get(chain[1])
        return None

    def _module_by_suffix(self, dotted: str) -> ModuleInfo | None:
        if dotted in self.modules:
            return self.modules[dotted]
        if dotted in self._suffix_cache:
            return self._suffix_cache[dotted]
        out = None
        for name, m in self.modules.items():
            if name.endswith("." + dotted.rsplit(".", 1)[-1]) \
                    and (name == dotted or name.endswith("." + dotted)):
                out = m
                break
        self._suffix_cache[dotted] = out
        return out

    def _imported_module(self, mod: ModuleInfo,
                         alias: str) -> ModuleInfo | None:
        if alias in mod.imports:
            return self._module_by_suffix(mod.imports[alias])
        if alias in mod.from_names:
            src_mod, orig = mod.from_names[alias]
            return self._module_by_suffix(src_mod + "." + orig) \
                or self._module_by_suffix(orig)
        return None

    def type_of_expr(self, expr: ast.AST, mod: ModuleInfo) -> str | None:
        """Type key of a constructor-ish expression, or None."""
        if isinstance(expr, ast.Call):
            chain = attr_chain(expr.func)
            if not chain:
                return None
            if len(chain) == 2 and tuple(chain) in _BUILTIN_TYPES:
                return _BUILTIN_TYPES[tuple(chain)]
            if len(chain) == 1 and chain[0] in ("Lock", "RLock",
                                                "Condition", "Event",
                                                "Thread", "Queue"):
                # `from threading import Lock` style
                fn = mod.from_names.get(chain[0])
                if fn and tuple([fn[0].split(".")[-1], fn[1]]) \
                        in _BUILTIN_TYPES:
                    return _BUILTIN_TYPES[(fn[0].split(".")[-1], fn[1])]
            ci = self._resolve_class_name(mod, chain)
            if ci is not None:
                return ci.key
            return None
        if isinstance(expr, (ast.List, ast.ListComp)):
            elts = (expr.elts if isinstance(expr, ast.List)
                    else [expr.elt])
            elem_keys = {self.type_of_expr(e, mod) for e in elts}
            elem_keys.discard(None)
            if len(elem_keys) == 1:
                return "list:" + elem_keys.pop()
            return "list:" if isinstance(expr, ast.List) \
                and not expr.elts else None
        return None

    def type_from_annotation(self, ann: ast.AST,
                             mod: ModuleInfo) -> str | None:
        """Type key from an annotation: ``_Slot`` -> the class,
        ``list[_Slot]`` -> ``list:<class>``, ``dict[int, _Slot]`` ->
        ``dict:<class>``, ``Optional[X]``/``X | None`` -> X."""
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            # X | None / None | X
            for side in (ann.left, ann.right):
                if not (isinstance(side, ast.Constant)
                        and side.value is None):
                    t = self.type_from_annotation(side, mod)
                    if t is not None:
                        return t
            return None
        chain = attr_chain(ann)
        if chain:
            ci = self._resolve_class_name(mod, chain)
            return ci.key if ci is not None else None
        if isinstance(ann, ast.Subscript):
            base = attr_chain(ann.value) or []
            base_name = base[-1] if base else ""
            sl = ann.slice
            if base_name in ("list", "List", "Sequence", "set",
                             "frozenset", "Set", "tuple", "Tuple"):
                t = self.type_from_annotation(sl, mod)
                return "list:" + t if t else None
            if base_name in ("dict", "Dict", "Mapping", "defaultdict"):
                if isinstance(sl, ast.Tuple) and len(sl.elts) == 2:
                    t = self.type_from_annotation(sl.elts[1], mod)
                    return "dict:" + t if t else None
                return None
            if base_name == "Optional":
                return self.type_from_annotation(sl, mod)
        return None

    def _infer_attr_types(self, ci: ClassInfo) -> None:
        """``self.X = <expr>`` sites across the class body, with the
        parameter-name heuristic and list-element typing."""
        mod = ci.module
        param_types: dict[str, dict[str, str]] = {}
        for m in set(ci.methods.values()):
            ptypes: dict[str, str] = {}
            for arg in (m.node.args.posonlyargs + m.node.args.args
                        + m.node.args.kwonlyargs):
                bound = self._classes_ci.get(arg.arg.lower().lstrip("_"))
                if bound is not None:
                    ptypes[arg.arg] = bound.key
            param_types[m.key] = ptypes
        for m in set(ci.methods.values()):
            for node in ast.walk(m.node):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign):
                    # the annotation is authoritative when it resolves
                    # (`self._slots: list[_Slot] = []`)
                    ch = attr_chain(node.target)
                    if ch and len(ch) == 2 and ch[0] == "self":
                        t = self.type_from_annotation(
                            node.annotation, mod)
                        if t is not None:
                            ci.attr_types[ch[1]] = t
                            continue
                    if node.value is None:
                        continue
                    targets = [node.target]
                else:
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr == "append" \
                            and len(node.args) == 1:
                        # self.X.append(C(...)) types the list elements
                        ch = attr_chain(node.func.value)
                        if ch and len(ch) == 2 and ch[0] == "self":
                            t = self.type_of_expr(node.args[0], mod)
                            if t and ci.attr_types.get(ch[1]) \
                                    in (None, "list:", "list:" + t):
                                ci.attr_types[ch[1]] = "list:" + t
                    continue
                value = node.value
                for tgt in targets:
                    ch = attr_chain(tgt)
                    if not ch or len(ch) != 2 or ch[0] != "self":
                        continue
                    attr = ch[1]
                    t = self.type_of_expr(value, mod)
                    if t is None and isinstance(value, ast.Name):
                        t = param_types[m.key].get(value.id)
                    if t is None:
                        # `self.x = None` placeholders don't clobber
                        if isinstance(value, ast.Constant) \
                                and value.value is None:
                            continue
                        # a second, untypable assignment to a typed
                        # attr makes it unknown — safety over recall
                        if attr in ci.attr_types \
                                and not ci.attr_types[attr].startswith(
                                    "list:"):
                            del ci.attr_types[attr]
                        continue
                    prev = ci.attr_types.get(attr)
                    if prev is None or prev == "list:" or prev == t:
                        ci.attr_types[attr] = t
                    elif t == "list:" and prev.startswith("list:"):
                        pass      # an empty re-init keeps the elem type
                    elif prev != t:
                        del ci.attr_types[attr]

    # -- resolution helpers ---------------------------------------------
    def mro(self, ci: ClassInfo):
        """The class and its resolvable bases, nearest first."""
        out, stack, seen = [], [ci], set()
        while stack:
            c = stack.pop(0)
            if c.key in seen:
                continue
            seen.add(c.key)
            out.append(c)
            for raw in c.bases:
                b = self._resolve_class_name(c.module, raw.split("."))
                if b is not None:
                    stack.append(b)
        return out

    def lookup_method(self, ci: ClassInfo,
                      name: str) -> FunctionInfo | None:
        for c in self.mro(ci):
            if name in c.methods:
                return c.methods[name]
        return None

    def attr_type(self, ci: ClassInfo, attr: str) -> str | None:
        for c in self.mro(ci):
            if attr in c.attr_types:
                return c.attr_types[attr]
        return None

    def class_of_key(self, key: str | None) -> ClassInfo | None:
        if key is None:
            return None
        if key.startswith("list:"):
            key = key[5:]
        elif key.startswith("dict:"):
            key = key[5:]
        return self.classes.get(key)

    def resolve_call(self, call: ast.Call, scope: FunctionInfo,
                     local_types: dict[str, str] | None = None,
                     ) -> list[FunctionInfo]:
        """Callee candidates for one call site (empty when unknown)."""
        mod = scope.module
        local_types = local_types or {}
        f = call.func
        if isinstance(f, ast.Name):
            fi = mod.functions.get(f.id)
            if fi is not None:
                return [fi]
            if f.id in mod.from_names:
                src_mod, orig = mod.from_names[f.id]
                m = self._module_by_suffix(src_mod)
                if m is not None and orig in m.functions:
                    return [m.functions[orig]]
            return []
        chain = attr_chain(f)
        if not chain:
            return []
        recv_type = self.resolve_receiver_type(chain[:-1], scope,
                                               local_types)
        if recv_type is not None \
                and recv_type[:5] in ("list:", "dict:") \
                and chain[-1] in _CONTAINER_METHODS:
            return []     # list/dict verbs never resolve to the elems
        owner = self._owner_class(chain[:-1], scope, local_types)
        if owner is not None:
            fi = self.lookup_method(owner, chain[-1])
            return [fi] if fi is not None else []
        if len(chain) == 2:
            m = self._imported_module(mod, chain[0])
            if m is not None and chain[-1] in m.functions:
                return [m.functions[chain[-1]]]
        return []

    def _owner_class(self, recv: list[str], scope: FunctionInfo,
                     local_types: dict[str, str]) -> ClassInfo | None:
        """Class owning the method for a dotted receiver chain."""
        if not recv:
            return None
        mod = scope.module
        if recv[0] in ("self", "cls") and scope.cls:
            cur = mod.classes.get(scope.cls)
            rest = recv[1:]
        elif recv[0] in local_types:
            cur = self.class_of_key(local_types[recv[0]])
            rest = recv[1:]
        else:
            return None
        for attr in rest:
            if cur is None:
                return None
            cur = self.class_of_key(self.attr_type(cur, attr))
        return cur

    def resolve_receiver_type(self, recv: list[str], scope: FunctionInfo,
                              local_types: dict[str, str]) -> str | None:
        """Type key of a dotted receiver expression, if inferable."""
        mod = scope.module
        if not recv:
            return None
        if recv[0] in ("self", "cls") and scope.cls:
            cur: str | None = mod.classes[scope.cls].key \
                if scope.cls in mod.classes else None
            rest = recv[1:]
        elif recv[0] in local_types:
            cur = local_types[recv[0]]
            rest = recv[1:]
        else:
            return None
        for attr in rest:
            ci = self.class_of_key(cur)
            if ci is None:
                return None
            cur = self.attr_type(ci, attr)
        return cur
