"""Acquire/release path analysis over the call graph.

Every fd-reuse window and orphaned-thread incident in CHANGES.md is
the same shape: a resource acquired, an exception edge between the
acquire and the release, and nothing on that edge that closes it.
This module models the package's acquire vocabulary and checks the
edges:

- **R24 (resource leaked on exception path)** — sockets
  (``socket.socket``/``create_connection``/``accept``), files
  (``open``/``os.fdopen``), shm segments (``os.memfd_create``,
  ``mmap.mmap``), transport channels (constructors of ``transport/``
  classes with a ``close``), and lock ``acquire()`` outside ``with``.
  A tracked resource is SAFE inside a ``with``, once a ``try`` whose
  ``finally`` (or handler) releases it encloses the risky region, or
  once ownership transfers — returned/yielded, stored into an
  attribute or container (the registered-drain pattern:
  ``_drain_dead_channels`` owns what ``self._channels`` holds), or
  passed to another call. Any OTHER statement that can raise while
  the resource is live and unprotected is a leaked exception edge,
  charged at the acquire site.
- **R25 (thread started without join/daemon/stop registration)** —
  a started ``Thread``/``Timer`` must be daemonized, joined, or
  stored somewhere the program provably joins/cancels (an attribute
  or list some function calls ``.join()``/``.cancel()`` on, directly
  or via a drain loop). A fire-and-forget non-daemon thread outlives
  shutdown and deadlocks interpreter exit.

Per-function path reasoning, whole-program release registry: the
join/daemon registry is built over every module first, so storing a
thread in ``self._threads`` is fine exactly when someone, anywhere,
drains that list.
"""

from __future__ import annotations

import ast
import dataclasses

from ytk_mp4j_tpu_torch.analysis.engine import attr_chain

# acquire chains -> kind
_OPENERS: dict[tuple[str, ...], str] = {
    ("open",): "file",
    ("io", "open"): "file",
    ("os", "fdopen"): "file",
    ("gzip", "open"): "file",
    ("socket", "socket"): "socket",
    ("socket", "create_connection"): "socket",
    ("mmap", "mmap"): "shm segment",
    ("os", "memfd_create"): "memfd",
}

# verbs that fully release a tracked resource
_RELEASES = {"close", "shutdown", "detach", "release", "join", "stop",
             "cancel", "terminate", "kill", "unlink"}

# thread lifecycle registrations R25 accepts
_THREAD_STOPS = {"join", "cancel", "stop"}


@dataclasses.dataclass
class Leak:
    """One R24 finding candidate."""

    kind: str
    name: str                    # variable / dotted lock chain
    path: str
    func: str                    # display of the owning function
    lineno: int                  # acquire site (the fix site)
    risk_lineno: int             # first unprotected raising statement
    risk_desc: str


@dataclasses.dataclass
class ThreadLeak:
    """One R25 finding candidate."""

    path: str
    func: str
    lineno: int                  # constructor site
    detail: str


@dataclasses.dataclass
class _Res:
    kind: str
    lineno: int
    reported: bool = False


class ResourceModel:
    """Whole-program acquire/release verdicts for R24/R25."""

    def __init__(self, index):
        self.index = index
        self.leaks: list[Leak] = []
        self.thread_leaks: list[ThreadLeak] = []
        self.joined_attrs, self.daemon_attrs = self._thread_registry()
        for fi in sorted(index.functions.values(),
                         key=lambda f: f.key):
            _FnWalker(self, fi).walk()
            self._scan_threads(fi)

    # -- the whole-program thread registry ------------------------------
    def _thread_registry(self) -> tuple[set[str], set[str]]:
        """Attrs provably joined/cancelled or daemonized SOMEWHERE:
        ``self.X.join()``, ``for t in self.Y: t.join()`` (loop-drain),
        ``self.X.daemon = True``."""
        joined: set[str] = set()
        daemon: set[str] = set()
        for fi in self.index.functions.values():
            loop_srcs: dict[str, str] = {}
            for node in ast.walk(fi.node):
                if isinstance(node, (ast.For, ast.AsyncFor)) \
                        and isinstance(node.target, ast.Name):
                    ch = attr_chain(node.iter)
                    if ch and len(ch) >= 2:
                        loop_srcs[node.target.id] = ch[-1]
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _THREAD_STOPS:
                    ch = attr_chain(node.func.value)
                    if not ch:
                        continue
                    if len(ch) >= 2:
                        joined.add(ch[-1])
                    elif ch[0] in loop_srcs:
                        joined.add(loop_srcs[ch[0]])
                elif isinstance(node, ast.Assign) \
                        and len(node.targets) == 1:
                    ch = attr_chain(node.targets[0])
                    if ch and ch[-1] == "daemon" and len(ch) >= 3 \
                            and isinstance(node.value, ast.Constant) \
                            and node.value.value is True:
                        daemon.add(ch[-2])
        return joined, daemon

    # -- R25: thread lifecycle ------------------------------------------
    def _is_thread_ctor(self, call: ast.Call, fi) -> bool:
        if self.index.type_of_expr(call, fi.module) \
                == "threading.Thread":
            return True
        chain = attr_chain(call.func) or []
        if chain and chain[-1] == "Timer":
            return (chain == ["threading", "Timer"]
                    or fi.module.from_names.get(
                        "Timer", ("", ""))[1] == "Timer")
        return False

    @staticmethod
    def _ctor_daemonized(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "daemon" \
                    and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return True
        return False

    def _scan_threads(self, fi) -> None:
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.value, ast.Call) \
                    and self._is_thread_ctor(node.value, fi):
                if self._ctor_daemonized(node.value):
                    continue
                tgt = node.targets[0]
                ch = attr_chain(tgt)
                if isinstance(tgt, ast.Name):
                    self._judge_local_thread(fi, node, tgt.id)
                elif ch and len(ch) >= 2:
                    self._judge_attr_thread(fi, node, ch[-1])
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "start" \
                    and isinstance(node.func.value, ast.Call) \
                    and self._is_thread_ctor(node.func.value, fi) \
                    and not self._ctor_daemonized(node.func.value):
                self.thread_leaks.append(ThreadLeak(
                    fi.path, fi.display, node.func.value.lineno,
                    "started inline without binding: it can never be "
                    "joined"))

    def _judge_local_thread(self, fi, assign, name: str) -> None:
        started = joined = escaped = False
        stored_attr = None
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                ch = attr_chain(node.func) or []
                if ch[:1] == [name] and len(ch) == 2:
                    if ch[1] == "start":
                        started = True
                    elif ch[1] in _THREAD_STOPS:
                        joined = True
                    continue
                if any(isinstance(a, ast.Name) and a.id == name
                       for a in node.args):
                    # passed along (a register call / a list append
                    # with a drained attr): judged via the receiver
                    # attr when there is one, else ownership transfer
                    recv = attr_chain(node.func) or []
                    if len(recv) == 3 and recv[-1] == "append":
                        stored_attr = recv[-2]
                    else:
                        escaped = True
                if any(isinstance(kw.value, ast.Name)
                       and kw.value.id == name
                       for kw in node.keywords):
                    escaped = True
            elif isinstance(node, ast.Assign):
                ch = attr_chain(node.targets[0]) \
                    if len(node.targets) == 1 else None
                if isinstance(node.value, ast.Name) \
                        and node.value.id == name and ch:
                    if len(ch) >= 2:
                        stored_attr = ch[-1]
                    else:
                        escaped = True
                if ch and ch[:1] == [name] and ch[-1] == "daemon" \
                        and isinstance(node.value, ast.Constant) \
                        and node.value.value is True:
                    joined = True        # daemonized before start
            elif isinstance(node, (ast.Return, ast.Yield)) \
                    and isinstance(getattr(node, "value", None),
                                   ast.Name) \
                    and node.value.id == name:
                escaped = True
        if not started and stored_attr is None and not escaped:
            return                       # never started: not R25's job
        if joined or escaped:
            return
        if stored_attr is not None:
            if stored_attr in self.joined_attrs \
                    or stored_attr in self.daemon_attrs:
                return
            self.thread_leaks.append(ThreadLeak(
                fi.path, fi.display, assign.lineno,
                f"stored in '{stored_attr}' but no function joins, "
                f"cancels or daemonizes that attribute"))
            return
        self.thread_leaks.append(ThreadLeak(
            fi.path, fi.display, assign.lineno,
            f"'{name}' is started but never joined, daemonized or "
            f"registered for stop"))

    def _judge_attr_thread(self, fi, assign, attr: str) -> None:
        if attr in self.joined_attrs or attr in self.daemon_attrs:
            return
        self.thread_leaks.append(ThreadLeak(
            fi.path, fi.display, assign.lineno,
            f"stored in '{attr}' but no function joins, cancels or "
            f"daemonizes that attribute"))


class _FnWalker:
    """One function's R24 path check: a recursive statement walk with
    the live-resource table and the enclosing-``try`` protection set."""

    def __init__(self, model: ResourceModel, fi):
        self.model = model
        self.index = model.index
        self.fi = fi
        self.live: dict[str, _Res] = {}
        # one prescan fills both: names captured by nested
        # defs/lambdas (their lifetime leaves this function's paths —
        # never tracked) and the lock-acquire chains this function
        # also releases (paired acquire/release methods are a
        # different, reviewed discipline)
        self.closure_names, self.releasable_chains = \
            self._prescan(fi.node)

    def walk(self) -> None:
        self._stmts(self.fi.node.body, frozenset())
        for name, r in sorted(self.live.items()):
            if not r.reported:
                self.model.leaks.append(Leak(
                    r.kind, name, self.fi.path, self.fi.display,
                    r.lineno, r.lineno,
                    "never released or handed off on any path"))

    @staticmethod
    def _prescan(fnode) -> tuple[set[str], set[tuple[str, ...]]]:
        closure: set[str] = set()
        chains: set[tuple[str, ...]] = set()
        for node in ast.walk(fnode):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fnode:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name):
                        closure.add(sub.id)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "release":
                ch = attr_chain(node.func.value)
                if ch:
                    chains.add(tuple(ch))
        return closure, chains

    # -- classification --------------------------------------------------
    def _acquire_kind(self, expr) -> str | None:
        if not isinstance(expr, ast.Call):
            return None
        chain = attr_chain(expr.func)
        if chain:
            kind = _OPENERS.get(tuple(chain))
            if kind:
                return kind
            if chain[-1] == "accept":
                return "socket"
        t = self.index.type_of_expr(expr, self.fi.module)
        ci = self.index.class_of_key(t) if t and ":" in (t or "") \
            else None
        if ci is not None and ci.module.ctx.in_dirs("transport") \
                and self.index.lookup_method(ci, "close") is not None:
            return "channel"
        return None

    # -- the walk --------------------------------------------------------
    def _stmts(self, body, protected: frozenset) -> None:
        for stmt in body:
            self._stmt(stmt, protected)

    def _stmt(self, node, protected: frozenset) -> None:
        if isinstance(node, ast.Try):
            # names whose release/handoff sits on the exception edges
            # of THIS try are protected inside its body
            guarded: set[str] = set()
            for blk in [node.finalbody] + [h.body for h in
                                           node.handlers]:
                for s in blk:
                    rel, esc, _ = self._stmt_facts(s)
                    guarded |= rel | esc
            # a catch-all handler that does not re-raise ABSORBS the
            # body's exception edges: control falls through to the
            # statements after the try, where a conditional release
            # (`except Exception: ok = False` ... `if not ok:
            # ch.close()`) settles the resource — the end-of-function
            # sweep still reports it if no path ever releases
            if self._absorbs(node):
                guarded.add("*")
            inner = protected | frozenset(guarded)
            self._stmts(node.body, inner)
            for h in node.handlers:
                self._stmts(h.body, protected)
            self._stmts(node.orelse, inner)
            self._stmts(node.finalbody, protected)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # `with open(p) as fh:` — scoped by construction; other
            # context managers (locks) are not risky edges themselves
            withheld: set[str] = set()
            for item in node.items:
                if isinstance(item.optional_vars, ast.Name) \
                        and self._acquire_kind(item.context_expr):
                    withheld.add(item.optional_vars.id)
            self._stmts(node.body, protected | frozenset(withheld))
            return
        if isinstance(node, (ast.If, ast.While)):
            self._simple(node.test, node, protected)
            self._stmts(node.body, protected)
            self._stmts(node.orelse, protected)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._simple(node.iter, node, protected)
            self._stmts(node.body, protected)
            self._stmts(node.orelse, protected)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        self._simple(node, node, protected)

    def _simple(self, scan_node, stmt, protected: frozenset) -> None:
        """One non-compound statement (or a compound head expression):
        releases and escapes first, then the riskiness check, then new
        acquisitions become live."""
        rel, esc, raisy = self._stmt_facts(scan_node)
        acq = self._acquisitions(stmt if scan_node is stmt else None)
        if raisy:
            self._risk(stmt, protected | frozenset(rel) | frozenset(esc),
                       self._describe(scan_node))
        for n in rel | esc:
            self.live.pop(n, None)
        self.live.update(acq)

    def _risk(self, stmt, safe_names: frozenset, desc: str) -> None:
        if "*" in safe_names:   # inside an absorbing try (see _absorbs)
            return
        for name, r in self.live.items():
            if r.reported or name in safe_names:
                continue
            r.reported = True
            self.model.leaks.append(Leak(
                r.kind, name, self.fi.path, self.fi.display,
                r.lineno, stmt.lineno, desc))

    @staticmethod
    def _absorbs(node: ast.Try) -> bool:
        """True when every exception edge out of this try's body lands
        in a catch-all handler that does not re-raise — control is
        guaranteed to continue after the try, so the body's raises are
        not leak edges (the fall-through path owns the release)."""
        catch_all = False
        for h in node.handlers:
            if h.type is None:
                catch_all = True
            else:
                names = (h.type.elts if isinstance(h.type, ast.Tuple)
                         else [h.type])
                catch_all = catch_all or any(
                    isinstance(n, ast.Name)
                    and n.id in ("Exception", "BaseException")
                    for n in names)
            for s in h.body:
                for sub in ast.walk(s):
                    if isinstance(sub, ast.Raise):
                        return False
        return catch_all

    # -- statement facts -------------------------------------------------
    def _acquisitions(self, stmt) -> dict[str, _Res]:
        out: dict[str, _Res] = {}
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            if isinstance(stmt, ast.Expr):
                self._lock_acquire_stmt(stmt.value)
            return out
        kind = self._acquire_kind(stmt.value)
        if kind is None:
            return out
        tgt = stmt.targets[0]
        if isinstance(tgt, ast.Name):
            names = [tgt.id]
        elif isinstance(tgt, ast.Tuple) and tgt.elts \
                and isinstance(tgt.elts[0], ast.Name):
            # `conn, addr = lsock.accept()` — the fd is element 0
            names = [tgt.elts[0].id]
        else:
            return out
        for n in names:
            if n not in self.closure_names:
                out[n] = _Res(kind, stmt.lineno)
        return out

    def _lock_acquire_stmt(self, expr) -> None:
        """``self._lock.acquire()`` outside ``with``: tracked by its
        dotted chain, only when this function also releases it."""
        if not isinstance(expr, ast.Call) \
                or not isinstance(expr.func, ast.Attribute) \
                or expr.func.attr != "acquire":
            return
        ch = attr_chain(expr.func.value)
        if not ch or tuple(ch) not in self.releasable_chains:
            return
        self.live.setdefault(".".join(ch),
                             _Res("lock", expr.lineno))

    def _stmt_facts(self, node) -> tuple[set, set, bool]:
        """ONE walk over a statement, three facts: released names,
        escaped names (ownership transfers: returned/yielded, stored
        into an attribute/container/alias, or passed as a call
        argument), and whether the statement has a raise edge (an
        explicit raise/assert, or any call that is not purely its own
        acquire/release bookkeeping). The type-resolving
        ``_acquire_kind`` probe runs last and only until the first
        risky call settles the verdict — it is the expensive check."""
        rel: set[str] = set()
        esc: set[str] = set()
        raisy = isinstance(node, (ast.Raise, ast.Assert))
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Return, ast.Yield, ast.YieldFrom)):
                v = sub.value
                if v is not None:
                    esc |= {n.id for n in ast.walk(v)
                            if isinstance(n, ast.Name)}
            elif isinstance(sub, ast.Assign):
                for n in ast.walk(sub.value):
                    if isinstance(n, ast.Name) and n.id in self.live:
                        esc.add(n.id)
            elif isinstance(sub, ast.Call):
                for a in list(sub.args) + [kw.value
                                           for kw in sub.keywords]:
                    for n in ast.walk(a):
                        if isinstance(n, ast.Name) \
                                and n.id in self.live:
                            esc.add(n.id)
                bookkeeping = False
                if isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in _RELEASES:
                    ch = attr_chain(sub.func.value)
                    if ch and len(ch) == 1:
                        rel.add(ch[0])
                    elif ch:
                        rel.add(".".join(ch))     # lock chains
                    bookkeeping = True
                elif isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "acquire":
                    bookkeeping = True
                chain = attr_chain(sub.func) or []
                if chain == ["os", "close"]:
                    if sub.args and isinstance(sub.args[0], ast.Name):
                        rel.add(sub.args[0].id)
                    bookkeeping = True
                if not raisy and not bookkeeping \
                        and not self._acquire_kind(sub):
                    raisy = True
        return rel, esc, raisy

    @staticmethod
    def _describe(node) -> str:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                ch = attr_chain(sub.func)
                if ch:
                    return f"call to {'.'.join(ch)} at line " \
                           f"{sub.lineno}"
                return f"call at line {sub.lineno}"
        if isinstance(node, ast.Raise):
            return f"raise at line {node.lineno}"
        return f"statement at line {getattr(node, 'lineno', 0)}"
