"""Lock model for mp4j-lint's whole-program concurrency rules.

The package's safety rests on hand-enforced lock disciplines — "master
-> controller only", "``_tel_lock`` never nests inside
``_master_lock``", "events minted under the lock dispatch from an
outbox outside it". This module turns those review-time rules into a
checked artifact:

1. **Lock discovery** — every ``threading.Lock``/``RLock``/
   ``Condition`` assignment site becomes a lock node identified by its
   DEFINING site ``(class, attr)`` (or ``(module, name)``). Two
   instances of the same class share a node: for ordering analysis the
   conservative merge is exactly right — an order violation between
   any two instances is a violation of the class's discipline.
2. **Per-function summaries** — each function's acquisition events
   (``with``-nesting and linear ``acquire()``/``release()`` pairs),
   call sites and blocking operations, each annotated with the set of
   locks held at that point.
3. **Interprocedural propagation** — a fixpoint over the call graph
   computes, per function, every lock it may transitively acquire and
   every blocking operation it may transitively reach, each with one
   shortest witness chain.
4. **The lock-order graph** — an edge ``A -> B`` means some execution
   acquires ``B`` while holding ``A``, with a witness call chain. R19
   reports its cycles; ``mp4j-lint graph --dot`` dumps it.

Closures are summarized with an EMPTY held set (their bodies run on
their own thread/schedule, not at the definition site), and
unresolvable lock expressions or callees contribute nothing: a missed
edge can hide a finding but never invent one.
"""

from __future__ import annotations

import ast
import dataclasses

from ytk_mp4j_tpu_torch.analysis.callgraph import (
    FunctionInfo, ProgramIndex)
from ytk_mp4j_tpu_torch.analysis.engine import attr_chain

_LOCK_KINDS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
}

# -- R20 blocking vocabulary -------------------------------------------
# Channel SPI + raw socket verbs: any of these holds the calling
# thread against a peer's progress.
_CHANNEL_BLOCKERS = {
    "recv", "recv_into", "recv_obj", "recv_array", "recv_array_into",
    "recv_map_columns", "recv_raw_into", "sendall", "send_obj",
    "send_array", "send_map_columns", "send_raw", "accept", "connect",
}
# synchronization waits: Event.wait / Condition.wait(_for) / future
# wait; a wait on a HELD condition releases it for the duration and is
# exempted at charge time, every other held lock still stalls.
_WAIT_BLOCKERS = {"wait", "wait_for", "wait_all"}
_SUBPROCESS_BLOCKERS = {"run", "check_call", "check_output", "call",
                        "communicate"}
_THREADISH = ("thread", "proc", "worker", "drain", "heartbeat")

# -- R23 access vocabulary ---------------------------------------------
# attribute types that are internally synchronized (or are themselves
# the synchronization): accessing the OBJECT is safe, so these never
# become shared-field access events — the data they guard does.
_SYNC_TYPES = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Event", "threading.Semaphore", "threading.Thread",
    "queue.Queue",
})
# container verbs that MUTATE their receiver: `self._peers.pop(r)` is
# a write to `_peers`, not a read
_MUTATORS = {
    "append", "extend", "insert", "pop", "remove", "clear", "sort",
    "reverse", "update", "setdefault", "add", "discard", "popitem",
    "appendleft", "popleft",
}


@dataclasses.dataclass(frozen=True)
class LockDecl:
    key: str            # "Master._lock@comm.master" / "spans._lock@obs.spans"
    kind: str           # Lock | RLock | Condition | local
    cls: str | None
    attr: str
    module: str         # dotted module id
    path: str
    lineno: int

    @property
    def display(self) -> str:
        return f"{self.cls}.{self.attr}" if self.cls else \
            f"{self.module.rsplit('.', 1)[-1]}.{self.attr}"

    @property
    def reentrant(self) -> bool:
        # threading.Condition's default internal lock is an RLock
        return self.kind in ("RLock", "Condition")


@dataclasses.dataclass
class AcqEvent:
    lock: str                    # LockDecl key
    held: tuple[str, ...]        # locks held at the acquisition
    lineno: int


@dataclasses.dataclass
class CallEvent:
    callees: tuple[str, ...]     # FunctionInfo keys (resolved)
    held: tuple[str, ...]
    lineno: int
    display: str                 # terminal callee name for messages


@dataclasses.dataclass
class BlockEvent:
    what: str                    # e.g. "socket/channel recv", "Event.wait"
    terminal: str                # the called name
    held: tuple[str, ...]
    lineno: int
    recv_lock: str | None        # lock key when the receiver IS a lock


@dataclasses.dataclass
class HookEvent:
    name: str                    # the hook-ish callable's name
    held: tuple[str, ...]
    lineno: int


@dataclasses.dataclass
class AccessEvent:
    """One read/write of an instance attribute of an index class, with
    the locks held at the site (the lockset analysis' substrate)."""

    owner: str                   # receiver's ClassInfo key ("mod:Cls")
    attr: str
    write: bool
    held: tuple[str, ...]
    lineno: int


@dataclasses.dataclass
class Summary:
    func: FunctionInfo
    acquires: list[AcqEvent] = dataclasses.field(default_factory=list)
    calls: list[CallEvent] = dataclasses.field(default_factory=list)
    blockers: list[BlockEvent] = dataclasses.field(default_factory=list)
    hooks: list[HookEvent] = dataclasses.field(default_factory=list)
    accesses: list[AccessEvent] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass(frozen=True)
class Edge:
    """One observed acquisition order src -> dst with a witness."""

    src: str
    dst: str
    chain: tuple[str, ...]       # function displays, caller-first
    path: str                    # file of the charging frame
    lineno: int                  # line of the charging frame


def _is_hookish(name: str) -> bool:
    low = name.lower()
    return (low.endswith("hook") or low.endswith("callback")
            or low.endswith("_cb") or low == "cb")


class _FuncWalker:
    """Extract one function's Summary: a recursive statement walk that
    threads the held-lock tuple through ``with`` nesting and linear
    ``acquire()``/``release()`` pairs, typing locals as it goes."""

    def __init__(self, model: "LockModel", func: FunctionInfo):
        self.model = model
        self.index = model.index
        self.func = func
        self.out = Summary(func)
        self.local_types: dict[str, str] = {}
        self.local_lock_alias: dict[str, str] = {}   # name -> lock key

    def walk(self) -> Summary:
        self._stmts(self.func.node.body, ())
        return self.out

    # -- statement traversal -------------------------------------------
    def _stmts(self, body, held):
        for stmt in body:
            held = self._stmt(stmt, held)
        return held

    def _stmt(self, node, held):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                self._expr(item.context_expr, inner)
                lk = self._resolve_lock(item.context_expr)
                if lk is not None:
                    self.out.acquires.append(AcqEvent(
                        lk, inner, node.lineno))
                    if lk not in inner:
                        inner = inner + (lk,)
            self._stmts(node.body, inner)
            return held
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # a closure runs on its own schedule: empty held set, but
            # its acquisitions/calls still belong to this summary so
            # thread bodies defined inline are not invisible
            self._stmts(getattr(node, "body", []), ())
            return held
        if isinstance(node, ast.Try):
            h = self._stmts(node.body, held)
            for hd in node.handlers:
                self._stmts(hd.body, held)
            self._stmts(node.orelse, h)
            return self._stmts(node.finalbody, h)
        if isinstance(node, ast.If):
            self._expr(node.test, held)
            self._stmts(node.body, held)
            self._stmts(node.orelse, held)
            return held
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._expr(node.iter, held)
            self._type_loop_target(node)
            self._stmts(node.body, held)
            self._stmts(node.orelse, held)
            return held
        if isinstance(node, ast.While):
            self._expr(node.test, held)
            self._stmts(node.body, held)
            self._stmts(node.orelse, held)
            return held
        if isinstance(node, ast.Assign):
            self._expr(node.value, held)
            self._track_assign(node)
            for tgt in node.targets:
                self._assign_target(tgt, held)
            return held
        if isinstance(node, ast.AugAssign):
            self._expr(node.value, held)
            self._assign_target(node.target, held)
            return held
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._assign_target(tgt, held)
            return held
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._expr(node.value, held)
                self._assign_target(node.target, held)
            return held
        if isinstance(node, ast.Expr):
            # statement-level acquire()/release() adjusts the linear
            # held set for the REST of this statement list
            adj = self._acquire_release(node.value, held)
            if adj is not None:
                return adj
            self._expr(node.value, held)
            return held
        if isinstance(node, (ast.Return, ast.Raise)):
            for child in ast.iter_child_nodes(node):
                self._expr(child, held)
            return held
        # default: visit child expressions, recurse into child stmt
        # lists (Match etc.) conservatively with the same held set
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child, held)
            else:
                self._expr(child, held)
        return held

    def _acquire_release(self, expr, held):
        if not isinstance(expr, ast.Call) \
                or not isinstance(expr.func, ast.Attribute) \
                or expr.func.attr not in ("acquire", "release"):
            return None
        lk = self._resolve_lock(expr.func.value)
        if lk is None:
            return None
        if expr.func.attr == "acquire":
            self.out.acquires.append(AcqEvent(lk, held, expr.lineno))
            return held if lk in held else held + (lk,)
        return tuple(h for h in held if h != lk)

    def _type_loop_target(self, node) -> None:
        # `for s in self._slots:` types s as the list's element class
        if isinstance(node.target, ast.Name):
            t = self._expr_type(node.iter)
            if t and t.startswith("list:") and len(t) > 5:
                self.local_types[node.target.id] = t[5:]

    def _track_assign(self, node: ast.Assign) -> None:
        if len(node.targets) != 1 \
                or not isinstance(node.targets[0], ast.Name):
            return
        name = node.targets[0].id
        self.local_types.pop(name, None)
        self.local_lock_alias.pop(name, None)
        value = node.value
        lk = self._resolve_lock(value, declare_local=name)
        if lk is not None:
            self.local_lock_alias[name] = lk
            return
        t = self._expr_type(value)
        if t is not None:
            self.local_types[name] = t

    def _expr_type(self, expr) -> str | None:
        t = self.index.type_of_expr(expr, self.func.module)
        if t is not None:
            return t
        ch = attr_chain(expr)
        if ch:
            if len(ch) == 1 and ch[0] in self.local_types:
                return self.local_types[ch[0]]
            return self.index.resolve_receiver_type(
                ch, self.func, self.local_types)
        if isinstance(expr, ast.Subscript):
            base_t = self._expr_type(expr.value)
            if base_t and base_t[:5] in ("list:", "dict:") \
                    and len(base_t) > 5:
                return base_t[5:]
        if isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr == "get":
            base_t = self._expr_type(expr.func.value)
            if base_t and base_t.startswith("dict:"):
                return base_t[5:]
        if isinstance(expr, ast.IfExp):
            return (self._expr_type(expr.body)
                    or self._expr_type(expr.orelse))
        return None

    # -- expression traversal ------------------------------------------
    def _expr(self, expr, held) -> None:
        """Recursive expression walk: classify calls, and record every
        resolvable attribute read/write with the held-lock set. A
        ``wait()``/``wait_for()`` on a HELD condition RELEASES it for
        the duration, so its argument expressions (predicates, lambda
        bodies) are walked with the condition's lock removed — a site
        reached from inside the wait must not be credited with a lock
        the wait gave up."""
        if expr is None:
            return
        if isinstance(expr, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(expr, ast.Lambda):
            self._expr(expr.body, held)
            return
        if isinstance(expr, ast.Call):
            self._call(expr, held)
            arg_held = self._wait_arg_held(expr, held)
            f = expr.func
            if isinstance(f, ast.Attribute):
                if f.attr in _MUTATORS \
                        and isinstance(f.value, ast.Attribute) \
                        and not self._user_method(f.value, f.attr):
                    self._access(f.value, held, write=True)
                    self._expr(f.value.value, held)
                else:
                    self._expr(f.value, held)
            elif not isinstance(f, ast.Name):
                self._expr(f, held)
            for a in expr.args:
                self._expr(a, arg_held)
            for kw in expr.keywords:
                self._expr(kw.value, arg_held)
            return
        if isinstance(expr, ast.Attribute):
            self._access(expr, held, write=False)
            self._expr(expr.value, held)
            return
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.stmt):
                self._stmt(child, held)
            elif isinstance(child, ast.AST):
                self._expr(child, held)

    def _assign_target(self, tgt, held) -> None:
        """Record write accesses for assignment/del targets: attribute
        stores, and subscript stores into an attribute container."""
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._assign_target(e, held)
        elif isinstance(tgt, ast.Starred):
            self._assign_target(tgt.value, held)
        elif isinstance(tgt, ast.Subscript):
            self._expr(tgt.slice, held)
            base = tgt.value
            while isinstance(base, ast.Subscript):
                self._expr(base.slice, held)
                base = base.value
            if isinstance(base, ast.Attribute):
                self._access(base, held, write=True)
        elif isinstance(tgt, ast.Attribute):
            self._access(tgt, held, write=True)
            self._expr(tgt.value, held)

    def _access(self, node, held, write: bool) -> None:
        """One attribute read/write, filtered down to what the lockset
        analysis can reason about: instance fields of INDEX classes.
        Locks themselves, internally-synchronized objects (events,
        queues, threads) and bound-method references are not data."""
        if not isinstance(node, ast.Attribute):
            return
        attr = node.attr
        if attr.startswith("__"):
            return
        if self._resolve_lock(node) is not None:
            return
        owner = self._expr_type(node.value)
        if not owner or ":" not in owner \
                or owner.startswith(("list:", "dict:")):
            return
        oci = self.index.classes.get(owner)
        if oci is None:
            return
        at = self.index.attr_type(oci, attr)
        if at in _SYNC_TYPES:
            return
        if self.index.lookup_method(oci, attr) is not None:
            return
        self.out.accesses.append(AccessEvent(
            owner, attr, write, held, node.lineno))

    def _user_method(self, receiver: ast.Attribute, name: str) -> bool:
        """True when ``receiver.name(...)`` resolves to a method a
        class in the index DEFINES: then the call is tracked through
        the call graph (the callee's own accesses carry the locksets)
        and the container-verb heuristic must not also charge the
        receiver field with a write — ``stats.add(...)`` mutates
        *inside* ``CommStats.add``, it does not rebind ``stats``."""
        owner = self._expr_type(receiver)
        if not owner or ":" not in owner:
            return False
        oci = self.index.classes.get(owner)
        if oci is None:
            return False
        return self.index.lookup_method(oci, name) is not None

    def _wait_arg_held(self, call: ast.Call, held):
        """Held set for a call's ARGUMENT expressions: minus the
        receiver condition for ``wait``/``wait_for`` on a held lock."""
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in ("wait",
                                                       "wait_for"):
            lk = self._resolve_lock(f.value)
            if lk is not None and lk in held:
                return tuple(h for h in held if h != lk)
        return held

    def _resolve_func_ref(self, expr) -> list[FunctionInfo]:
        """A bare function/bound-method REFERENCE (not a call):
        ``self._drained`` / ``check_fn`` -> FunctionInfo candidates."""
        ch = attr_chain(expr)
        if not ch:
            return []
        if len(ch) == 1:
            fi = self.func.module.functions.get(ch[0])
            return [fi] if fi is not None else []
        owner = self.index._owner_class(ch[:-1], self.func,
                                        self.local_types)
        if owner is not None:
            fi = self.index.lookup_method(owner, ch[-1])
            return [fi] if fi is not None else []
        return []

    def _call(self, call: ast.Call, held) -> None:
        name = None
        if isinstance(call.func, ast.Attribute):
            name = call.func.attr
        elif isinstance(call.func, ast.Name):
            name = call.func.id
        if name is None:
            return
        if name in ("acquire", "release"):
            # non-statement-level acquire/release: record the acquire
            # event (ordering) without linear tracking
            if name == "acquire":
                lk = self._resolve_lock(call.func.value) \
                    if isinstance(call.func, ast.Attribute) else None
                if lk is not None:
                    self.out.acquires.append(
                        AcqEvent(lk, held, call.lineno))
            return
        self._classify_blocking(call, name, held)
        if name == "wait_for" and call.args \
                and isinstance(call.func, ast.Attribute):
            # the predicate runs INSIDE the wait, i.e. with the
            # condition's lock re-acquired around each evaluation but
            # released between them — model the call edge with the
            # condition removed from the held set so real R23 findings
            # under the predicate are not masked by a false "held"
            lk = self._resolve_lock(call.func.value)
            inner = tuple(h for h in held if h != lk) \
                if lk is not None else held
            preds = self._resolve_func_ref(call.args[0])
            if preds:
                self.out.calls.append(CallEvent(
                    tuple(fi.key for fi in preds), inner, call.lineno,
                    preds[0].name))
        if _is_hookish(name):
            self.out.hooks.append(HookEvent(name, held, call.lineno))
        callees = self.index.resolve_call(call, self.func,
                                          self.local_types)
        if callees:
            self.out.calls.append(CallEvent(
                tuple(fi.key for fi in callees), held, call.lineno,
                name))

    def _classify_blocking(self, call, name, held) -> None:
        chain = attr_chain(call.func) or []
        recv = chain[:-1]
        if name in _CHANNEL_BLOCKERS:
            # `connect` also names non-socket verbs; require a
            # receiver for the socket-ish ones that need one
            self.out.blockers.append(BlockEvent(
                f"socket/channel {name}", name, held, call.lineno,
                None))
            return
        if name in _WAIT_BLOCKERS:
            recv_lock = self._resolve_lock(call.func.value) \
                if isinstance(call.func, ast.Attribute) else None
            self.out.blockers.append(BlockEvent(
                f"{name}() on " + (".".join(recv) if recv else "a waitable"),
                name, held, call.lineno, recv_lock))
            return
        if name == "sleep" and recv == ["time"]:
            self.out.blockers.append(BlockEvent(
                "time.sleep", name, held, call.lineno, None))
            return
        if name in _SUBPROCESS_BLOCKERS and recv == ["subprocess"]:
            self.out.blockers.append(BlockEvent(
                f"subprocess.{name}", name, held, call.lineno, None))
            return
        if name == "select" and recv in (["select"], ["selectors"]):
            self.out.blockers.append(BlockEvent(
                "select.select", name, held, call.lineno, None))
            return
        if name == "join":
            # thread/process join only: typed receivers, or names that
            # read as threads — never str.join / os.path.join
            if recv in (["os", "path"], ["posixpath"], ["ntpath"]):
                return
            t = self.index.resolve_receiver_type(
                recv, self.func, self.local_types) if recv else None
            if recv and recv[0] in self.local_types and t is None:
                t = None
            threadish = (t == "threading.Thread"
                         or any(any(p in seg.lower() for p in _THREADISH)
                                for seg in recv))
            if threadish:
                self.out.blockers.append(BlockEvent(
                    ".".join(recv) + ".join()", name, held, call.lineno,
                    None))
            return
        if name in ("get", "put"):
            t = self.index.resolve_receiver_type(
                recv, self.func, self.local_types) if recv else None
            if t == "queue.Queue":
                self.out.blockers.append(BlockEvent(
                    f"Queue.{name}", name, held, call.lineno, None))

    # -- lock resolution ------------------------------------------------
    def _resolve_lock(self, expr, declare_local: str | None = None
                      ) -> str | None:
        """Lock key for an expression, or None. ``declare_local``
        registers a fresh function-local lock for ``x = Lock()``."""
        model = self.model
        if isinstance(expr, ast.Call) and declare_local is not None:
            t = self.index.type_of_expr(expr, self.func.module)
            kind = _LOCK_KINDS.get(t or "")
            if kind:
                return model.declare_local_lock(
                    self.func, declare_local, kind, expr.lineno)
            return None
        chain = attr_chain(expr)
        if not chain:
            # subscripted/computed receivers: `self._slots[rank].lock`
            if isinstance(expr, ast.Attribute):
                t = self._expr_type(expr.value)
                if t and t[:5] not in ("list:", "dict:"):
                    oci = self.index.class_of_key(t)
                    if oci is not None:
                        for c in self.index.mro(oci):
                            lk = model.lookup(c.module.name, c.name,
                                              expr.attr)
                            if lk is not None:
                                return lk
            return None
        if len(chain) == 1:
            name = chain[0]
            if name in self.local_lock_alias:
                return self.local_lock_alias[name]
            return model.lookup(self.func.module.name, None, name)
        if chain[0] in ("self", "cls") and self.func.cls:
            mod = self.func.module
            ci = mod.classes.get(self.func.cls)
            if ci is None:
                return None
            if len(chain) == 2:
                for c in self.index.mro(ci):
                    lk = model.lookup(c.module.name, c.name, chain[1])
                    if lk is not None:
                        return lk
                return None
            owner = self.index.resolve_receiver_type(
                chain[:-1], self.func, self.local_types)
            oci = self.index.class_of_key(owner)
            if oci is not None:
                for c in self.index.mro(oci):
                    lk = model.lookup(c.module.name, c.name, chain[-1])
                    if lk is not None:
                        return lk
            return None
        # local var receiver: slot.lock / g.lock
        t = self.index.resolve_receiver_type(
            chain[:-1], self.func, self.local_types)
        oci = self.index.class_of_key(t)
        if oci is not None:
            for c in self.index.mro(oci):
                lk = model.lookup(c.module.name, c.name, chain[-1])
                if lk is not None:
                    return lk
        # imported module's lock: spans._lock
        m = self.index._imported_module(self.func.module, chain[0])
        if m is not None and len(chain) == 2:
            return model.lookup(m.name, None, chain[1])
        return None


class LockModel:
    """Discovery + summaries + fixpoint + the lock-order graph."""

    def __init__(self, index: ProgramIndex):
        self.index = index
        self.locks: dict[str, LockDecl] = {}
        self._by_site: dict[tuple[str, str | None, str], str] = {}
        self.summaries: dict[str, Summary] = {}
        # fkey -> lock key -> ("direct", lineno) | ("via", lineno, ckey)
        self.trans_acquires: dict[str, dict[str, tuple]] = {}
        # fkey -> (terminal, recv_lock) -> BlockEvent | ("via", ln, ckey)
        self.trans_blockers: dict[str, dict[tuple, tuple]] = {}
        self.trans_hooks: dict[str, dict[str, tuple]] = {}
        self.edges: dict[tuple[str, str], Edge] = {}
        self.reentries: list[tuple[str, Edge]] = []   # (lock, witness)
        self._discover()
        for fi in index.functions.values():
            self.summaries[fi.key] = _FuncWalker(self, fi).walk()
        self._fixpoint()
        self._build_edges()

    # -- discovery ------------------------------------------------------
    def declare(self, module: str, path: str, cls: str | None, attr: str,
                kind: str, lineno: int) -> str:
        key = (f"{cls}.{attr}@{module}" if cls
               else f"{attr}@{module}")
        if key not in self.locks:
            self.locks[key] = LockDecl(
                key=key, kind=kind, cls=cls, attr=attr, module=module,
                path=path, lineno=lineno)
            self._by_site[(module, cls, attr)] = key
        return key

    def declare_local_lock(self, func: FunctionInfo, name: str,
                           kind: str, lineno: int) -> str:
        return self.declare(func.module.name, func.path,
                            func.cls, f"<{func.name}:{name}>", kind,
                            lineno)

    def lookup(self, module: str, cls: str | None,
               attr: str) -> str | None:
        return self._by_site.get((module, cls, attr))

    def _discover(self) -> None:
        for mod in self.index.modules.values():
            for node in mod.ctx.tree.body:
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    kind = _LOCK_KINDS.get(
                        self.index.type_of_expr(node.value, mod) or "")
                    if kind:
                        self.declare(mod.name, mod.path, None,
                                     node.targets[0].id, kind,
                                     node.lineno)
            for ci in mod.classes.values():
                for m in set(ci.methods.values()):
                    if m.cls != ci.name:
                        continue      # inherited binding
                    for sub in ast.walk(m.node):
                        if not isinstance(sub, ast.Assign) \
                                or len(sub.targets) != 1:
                            continue
                        ch = attr_chain(sub.targets[0])
                        if not ch or len(ch) != 2 or ch[0] != "self":
                            continue
                        kind = _LOCK_KINDS.get(
                            self.index.type_of_expr(sub.value, mod)
                            or "")
                        if kind:
                            self.declare(mod.name, mod.path, ci.name,
                                         ch[1], kind, sub.lineno)

    # -- fixpoint -------------------------------------------------------
    def _fixpoint(self) -> None:
        for fkey, s in self.summaries.items():
            acq = {}
            for a in s.acquires:
                acq.setdefault(a.lock, ("direct", a.lineno))
            self.trans_acquires[fkey] = acq
            blk = {}
            for b in s.blockers:
                blk.setdefault((b.terminal, b.recv_lock),
                               ("direct", b.lineno, b.what))
            self.trans_blockers[fkey] = blk
            hks = {}
            for h in s.hooks:
                hks.setdefault(h.name, ("direct", h.lineno))
            self.trans_hooks[fkey] = hks
        changed = True
        while changed:
            changed = False
            for fkey, s in self.summaries.items():
                for call in s.calls:
                    for ckey in call.callees:
                        if ckey == fkey or ckey not in self.summaries:
                            continue
                        for lk in self.trans_acquires[ckey]:
                            if lk not in self.trans_acquires[fkey]:
                                self.trans_acquires[fkey][lk] = (
                                    "via", call.lineno, ckey)
                                changed = True
                        for bk, ent in self.trans_blockers[ckey] \
                                .items():
                            if bk not in self.trans_blockers[fkey]:
                                self.trans_blockers[fkey][bk] = (
                                    "via", call.lineno, ckey, ent[2]
                                    if ent[0] == "direct" else ent[3])
                                changed = True
                        for hk in self.trans_hooks[ckey]:
                            if hk not in self.trans_hooks[fkey]:
                                self.trans_hooks[fkey][hk] = (
                                    "via", call.lineno, ckey)
                                changed = True

    def _chase(self, table, fkey, key) -> tuple[tuple[str, ...], int]:
        """Witness chain (function displays) + terminal line."""
        chain: list[str] = []
        seen = set()
        lineno = 0
        while fkey not in seen:
            seen.add(fkey)
            fi = self.index.functions[fkey]
            chain.append(fi.display)
            ent = table[fkey][key]
            lineno = ent[1]
            if ent[0] == "direct":
                break
            fkey = ent[2]
        return tuple(chain), lineno

    # -- the lock-order graph ------------------------------------------
    def _note_edge(self, src, dst, chain, path, lineno) -> None:
        if src == dst:
            decl = self.locks[dst]
            if not decl.reentrant:
                self.reentries.append((dst, Edge(
                    src, dst, chain, path, lineno)))
            return
        self.edges.setdefault((src, dst), Edge(
            src, dst, chain, path, lineno))

    def _build_edges(self) -> None:
        for fkey, s in self.summaries.items():
            fi = s.func
            for a in s.acquires:
                for held in a.held:
                    self._note_edge(held, a.lock, (fi.display,),
                                    fi.path, a.lineno)
            for call in s.calls:
                if not call.held:
                    continue
                for ckey in call.callees:
                    if ckey not in self.trans_acquires:
                        continue
                    for lk in self.trans_acquires[ckey]:
                        tail, _ = self._chase(
                            self.trans_acquires, ckey, lk)
                        for held in call.held:
                            self._note_edge(
                                held, lk, (fi.display,) + tail,
                                fi.path, call.lineno)

    def cycles(self) -> list[list[str]]:
        """SCCs of size >= 2 in the lock-order graph (Tarjan)."""
        graph: dict[str, list[str]] = {}
        for (src, dst) in self.edges:
            graph.setdefault(src, []).append(dst)
            graph.setdefault(dst, [])
        index_of: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        out: list[list[str]] = []
        counter = [0]

        def strongconnect(v):
            # iterative Tarjan: (node, child-iterator) frames
            work = [(v, iter(graph[v]))]
            index_of[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index_of:
                        index_of[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(graph[w])))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index_of[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index_of[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        out.append(sorted(scc))

        for v in sorted(graph):
            if v not in index_of:
                strongconnect(v)
        return sorted(out)

    def format_witness(self, edge: Edge) -> str:
        site = f"{edge.path}:{edge.lineno}"
        return (f"{self.locks[edge.src].display} -> "
                f"{self.locks[edge.dst].display} via "
                + " -> ".join(edge.chain) + f" ({site})")

    def to_dot(self) -> str:
        """The discovered lock-order graph as GraphViz DOT: nodes =
        lock attrs with their defining class/module, edges = observed
        acquisition orders with one witness call chain each. The
        README's discipline table is generated from this, not prose."""
        lines = ["digraph mp4j_lock_order {",
                 '  rankdir=LR;',
                 '  node [shape=box, fontname="monospace"];']
        used = sorted({k for e in self.edges for k in e})
        for key in used:
            d = self.locks[key]
            shape = "box" if d.kind != "Condition" else "oval"
            lines.append(
                f'  "{key}" [label="{d.display}\\n'
                f'{d.kind} @ {d.module}", shape={shape}];')
        for (src, dst), e in sorted(self.edges.items()):
            label = " -> ".join(e.chain)
            lines.append(
                f'  "{src}" -> "{dst}" '
                f'[label="{label}\\n{e.path}:{e.lineno}"];')
        lines.append("}")
        return "\n".join(lines)
