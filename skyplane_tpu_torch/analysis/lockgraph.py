"""Whole-program lock-order analysis: the deadlock gate for the threaded
gateway — and the fork-safety gate for the multi-process pump that replaces it.

Every prior wire-path postmortem on this codebase (socket-io-under-lock, the
retarget registration race, the lock-held spill reads) was an *ordering* bug
between locks owned by different modules — exactly what per-statement rules
cannot see. This pass is Eraser/TSan in spirit but AST-driven:

  1. **Inventory** every lock by definition site: ``self._x =
     threading.Lock()`` (class locks, named ``Class.attr``), module-level
     locks (``modstem.NAME``), with alias tracking — ``self.cond =
     threading.Condition(self.lock)`` shares its underlying lock's node, as
     does a plain ``self.a = self.b`` re-binding, and a
     ``lockcheck.wrap(threading.Lock(), ...)`` shim is unwrapped to the
     factory inside.
  2. **Call graph** (:mod:`skyplane_tpu_torch.analysis.callgraph`): class-method
     resolution by receiver-type heuristics, so held-lock sets propagate
     across ``self.store.register(...)``-style edges.
  3. **Propagate held sets** through ``with lock:`` bodies and sequential
     ``acquire()``/``release()`` spans, across call edges, into one global
     lock-acquisition-order graph.

Rules emitted (project-wide, under the standard suppression machinery):

  * ``lock-order-cycle`` — the order graph has a cycle; each participating
    edge gets a finding carrying BOTH witness paths (file:line chains), so
    the two halves of an ABBA deadlock are each visible and suppressible at
    their own acquisition site.
  * ``nested-foreign-lock-call`` — while holding a lock of class C, a call
    resolves into a method of another class D that (transitively) takes D's
    own lock, AND the reverse nesting also exists somewhere in the project.
    One direction alone IS the established order and stays quiet; both
    directions means no order has been established and either side may
    deadlock under the right interleaving.
  * ``lock-held-across-fork`` — ``os.fork`` / ``multiprocessing`` Process or
    Pool construction reachable (directly or through the call graph) while a
    lock is held. The forked child inherits a COPY of the lock in whatever
    state it was in — a child that tries to take it deadlocks forever. This
    is the precondition for the multi-process pump refactor (ROADMAP item 1).

Plus one per-module rule:

  * ``fork-with-threads`` — a module both starts ``threading.Thread``s and
    forks (``os.fork`` / Process / Pool / ProcessPoolExecutor) without a
    ``set_start_method("spawn")`` / ``get_context("spawn")`` guard. With the
    default fork start method, the child inherits every lock/condition in
    whatever state the snapshot caught — including ones held by threads that
    do not exist in the child.

Known over-approximations (the usual deal — a false positive costs one
justified suppression naming the external ordering invariant): a
``cond.wait()`` is modeled as held for its whole ``with`` body even though it
releases the lock while waiting, and nested function bodies are not
summarized (they run on their own thread's time).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import PurePath
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from skyplane_tpu_torch.analysis.callgraph import CallGraph, FunctionDecl, ProjectIndex
from skyplane_tpu_torch.analysis.concurrency import _LOCK_FACTORIES, _is_thread_call, dotted_name
from skyplane_tpu_torch.analysis.core import Checker, Finding, ModuleInfo, ProjectChecker, RuleSpec
from skyplane_tpu_torch.analysis.tracer import canonical_name, import_aliases

_MAX_CHAIN = 6  # witness call-chain depth kept per propagated acquisition


@dataclass(frozen=True)
class LockId:
    owner: str  # class name (class locks) or module stem (module-level)
    attr: str
    is_class: bool

    def __str__(self) -> str:
        return f"{self.owner}.{self.attr}"


# ---------------------------------------------------------------- inventory


def _unwrap_lock_call(value: ast.AST) -> Optional[ast.Call]:
    """The factory call behind an assignment value, seeing through the
    runtime shim: ``lockcheck.wrap(threading.Lock(), "name")`` -> the
    ``threading.Lock()`` call. Returns None for non-calls."""
    if not isinstance(value, ast.Call):
        return None
    terminal = dotted_name(value.func).split(".")[-1]
    if terminal == "wrap" and value.args and isinstance(value.args[0], ast.Call):
        return value.args[0]
    return value


def _factory_name(value: ast.AST) -> str:
    call = _unwrap_lock_call(value)
    if call is None:
        return ""
    return dotted_name(call.func).split(".")[-1]


class LockInventory:
    """Lock definition sites across the project, with alias resolution."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        #: class name -> attr -> LockId (aliases map extra attrs to one node)
        self.class_locks: Dict[str, Dict[str, LockId]] = {}
        #: module path -> name -> LockId
        self.module_locks: Dict[str, Dict[str, LockId]] = {}
        for module in index.modules:
            self._scan_module(module)

    def _scan_module(self, module: ModuleInfo) -> None:
        stem = PurePath(module.path).stem
        mod_locks = self.module_locks.setdefault(module.path, {})
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and _factory_name(node.value) in _LOCK_FACTORIES:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        mod_locks[tgt.id] = LockId(stem, tgt.id, is_class=False)
        for cls_node in [n for n in ast.walk(module.tree) if isinstance(n, ast.ClassDef)]:
            locks = self.class_locks.setdefault(cls_node.name, {})
            # pass 1: direct factory assignments (wrap-shim aware)
            cond_aliases: List[Tuple[str, ast.AST]] = []
            plain_aliases: List[Tuple[str, ast.AST]] = []
            for node in ast.walk(cls_node):
                if not isinstance(node, ast.Assign):
                    continue
                self_attrs = [
                    t.attr
                    for t in node.targets
                    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and t.value.id == "self"
                ]
                if not self_attrs:
                    continue
                factory = _factory_name(node.value)
                call = _unwrap_lock_call(node.value)
                if factory in _LOCK_FACTORIES:
                    # Condition(self.X) shares X's node — resolved in pass 2
                    if factory == "Condition" and call is not None and call.args:
                        for attr in self_attrs:
                            cond_aliases.append((attr, call.args[0]))
                        continue
                    for attr in self_attrs:
                        locks.setdefault(attr, LockId(cls_node.name, attr, is_class=True))
                elif isinstance(node.value, ast.Attribute):
                    # plain alias: self.a = self.b / self.a = obj.b
                    for attr in self_attrs:
                        plain_aliases.append((attr, node.value))
            # pass 2: aliases onto already-inventoried nodes. A Condition over
            # an unresolvable expression is still a lock (own node); a plain
            # attribute copy that resolves to nothing lock-shaped is NOT —
            # `self.conn = cfg.conn` must not mint a phantom lock node that a
            # socket's `with self.conn:` later trips cycles over.
            for attr, expr in cond_aliases:
                target = self._alias_target(cls_node.name, expr)
                locks.setdefault(attr, target if target is not None else LockId(cls_node.name, attr, is_class=True))
            for attr, expr in plain_aliases:
                target = self._alias_target(cls_node.name, expr)
                if target is not None:
                    locks.setdefault(attr, target)

    def _alias_target(self, cls_name: str, expr: ast.AST) -> Optional[LockId]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            return self.class_locks.get(cls_name, {}).get(expr.attr)
        return None

    # ---- lookups ----

    def class_lock(self, cls_name: str, attr: str, _depth: int = 0) -> Optional[LockId]:
        """Class-attr lookup walking bases by name (inherited locks)."""
        if _depth > 6:
            return None
        hit = self.class_locks.get(cls_name, {}).get(attr)
        if hit is not None:
            return hit
        decl = self.index.class_named(cls_name)
        if decl is not None:
            for base in decl.bases:
                if base != cls_name:
                    hit = self.class_lock(base, attr, _depth + 1)
                    if hit is not None:
                        return hit
        return None

    def resolve(self, expr: ast.AST, ctx: FunctionDecl, local_types: Dict[str, str]) -> Optional[LockId]:
        """The LockId an expression denotes in a function's scope, or None."""
        if isinstance(expr, ast.Name):
            return self.module_locks.get(ctx.module.path, {}).get(expr.id)
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        recv = expr.value
        if isinstance(recv, ast.Name):
            if recv.id == "self" and ctx.cls:
                return self.class_lock(ctx.cls, attr)
            recv_cls = local_types.get(recv.id)
            if recv_cls:
                return self.class_lock(recv_cls, attr)
            return None
        # self.store._lock — receiver type from the owning class's attr map
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and ctx.cls
        ):
            owner = self.index.class_named(ctx.cls)
            if owner is not None:
                recv_cls = owner.attr_types.get(recv.attr)
                if recv_cls:
                    return self.class_lock(recv_cls, attr)
        return None


# ------------------------------------------------------------ fork detection

_FORK_EXACT = {"os.fork", "os.forkpty"}
_FORK_FACTORIES = {
    "multiprocessing.Process",
    "multiprocessing.Pool",
    "multiprocessing.pool.Pool",
    "concurrent.futures.ProcessPoolExecutor",
    "concurrent.futures.process.ProcessPoolExecutor",
}
_SPAWN_GUARD_FUNCS = {"set_start_method", "get_context"}


def fork_call_kind(call: ast.Call, aliases: Dict[str, str]) -> str:
    """'' when the call is not fork-shaped; else a short display name."""
    name = canonical_name(call.func, aliases)
    if name in _FORK_EXACT:
        return name
    if name in _FORK_FACTORIES:
        return name
    # mp.Process / mp.Pool through an aliased import
    if name.startswith("multiprocessing.") and name.split(".")[-1] in ("Process", "Pool"):
        return name
    return ""


def has_spawn_guard(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if dotted_name(node.func).split(".")[-1] not in _SPAWN_GUARD_FUNCS:
            continue
        for arg in node.args:
            if isinstance(arg, ast.Constant) and arg.value in ("spawn", "forkserver"):
                return True
    return False


# ------------------------------------------------------------ function scan


@dataclass
class AcqEvent:
    lock: LockId
    line: int
    held: Tuple[Tuple[LockId, int], ...]  # (lock, acquired-at line) snapshot


@dataclass
class CallEvent:
    callee: str  # qualname
    callee_decl: FunctionDecl
    line: int
    held: Tuple[Tuple[LockId, int], ...]


@dataclass
class ForkEvent:
    kind: str
    line: int
    held: Tuple[Tuple[LockId, int], ...]


@dataclass
class FnSummary:
    decl: FunctionDecl
    acquires: List[AcqEvent] = field(default_factory=list)
    calls: List[CallEvent] = field(default_factory=list)
    forks: List[ForkEvent] = field(default_factory=list)


class _FnScanner:
    """One function's walk: held-set tracking over with-blocks and sequential
    acquire()/release() spans, collecting acquisition/call/fork events."""

    def __init__(self, decl: FunctionDecl, inventory: LockInventory, graph: CallGraph, aliases: Dict[str, str]):
        self.decl = decl
        self.inventory = inventory
        self.graph = graph
        self.aliases = aliases
        self.local_types = graph._locals_for(decl)
        self.summary = FnSummary(decl)

    def scan(self) -> FnSummary:
        body = getattr(self.decl.node, "body", [])
        self._scan_stmts(body, [])
        return self.summary

    def _resolve_lock(self, expr: ast.AST) -> Optional[LockId]:
        return self.inventory.resolve(expr, self.decl, self.local_types)

    def _scan_stmts(self, stmts: Sequence[ast.stmt], held: List[Tuple[LockId, int]]) -> None:
        """``held`` is mutated by sequential acquire()/release() statements;
        with-blocks scope their acquisitions to their own body."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # different dynamic scope
            # explicit acquire()/release() as a bare statement
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                call = stmt.value
                if isinstance(call.func, ast.Attribute) and call.func.attr in ("acquire", "release"):
                    lock = self._resolve_lock(call.func.value)
                    if lock is not None:
                        if call.func.attr == "acquire":
                            self._record_acquire(lock, stmt.lineno, held)
                            held.append((lock, stmt.lineno))
                        else:
                            for i in range(len(held) - 1, -1, -1):
                                if held[i][0] == lock:
                                    del held[i]
                                    break
                        continue
            if isinstance(stmt, ast.With):
                inner = list(held)
                for item in stmt.items:
                    self._scan_exprs(item.context_expr, inner)
                    lock = self._resolve_lock(item.context_expr)
                    if lock is not None:
                        self._record_acquire(lock, stmt.lineno, inner)
                        inner.append((lock, stmt.lineno))
                self._scan_stmts(stmt.body, inner)
                continue
            if isinstance(stmt, ast.Try):
                self._scan_stmts(stmt.body, held)
                for handler in stmt.handlers:
                    self._scan_stmts(handler.body, list(held))
                self._scan_stmts(stmt.orelse, list(held))
                self._scan_stmts(stmt.finalbody, held)
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                self._scan_exprs(stmt.test, held)
                self._scan_stmts(stmt.body, list(held))
                self._scan_stmts(stmt.orelse, list(held))
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_exprs(stmt.iter, held)
                self._scan_stmts(stmt.body, list(held))
                self._scan_stmts(stmt.orelse, list(held))
                continue
            self._scan_exprs(stmt, held)

    def _record_acquire(self, lock: LockId, line: int, held: List[Tuple[LockId, int]]) -> None:
        self.summary.acquires.append(AcqEvent(lock=lock, line=line, held=tuple(held)))

    def _scan_exprs(self, node: ast.AST, held: List[Tuple[LockId, int]]) -> None:
        """Collect call/fork events from an expression tree (no nested defs)."""
        stack: List[ast.AST] = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(sub, ast.Call):
                kind = fork_call_kind(sub, self.aliases)
                if kind:
                    self.summary.forks.append(ForkEvent(kind=kind, line=sub.lineno, held=tuple(held)))
                else:
                    callee = self.graph.resolve(sub, self.decl)
                    if callee is not None and callee.qualname != self.decl.qualname:
                        self.summary.calls.append(
                            CallEvent(callee=callee.qualname, callee_decl=callee, line=sub.lineno, held=tuple(held))
                        )
            stack.extend(ast.iter_child_nodes(sub))


# ---------------------------------------------------------- the project pass

#: one step of a witness chain: (path, line, description)
Chain = Tuple[Tuple[str, int, str], ...]


@dataclass
class EdgeWitness:
    path: str
    func: str  # display name of the function holding the order
    held_line: int  # where the FROM lock was acquired
    line: int  # where the TO lock was acquired / the call was made
    chain: Chain = ()

    def render(self, a: LockId, b: LockId) -> str:
        via = f" via {' -> '.join(step[2] for step in self.chain)}" if self.chain else ""
        return (
            f"{self.path}:{self.line} in {self.func} "
            f"(holding {a} since :{self.held_line}){via}"
        )


class LockGraphChecker(ProjectChecker):
    rules = (
        RuleSpec(
            "lock-order-cycle",
            "error",
            "the global lock-acquisition-order graph has a cycle — an ABBA deadlock waiting for its interleaving",
        ),
        RuleSpec(
            "nested-foreign-lock-call",
            "warning",
            "call into another class's lock-taking method while holding a local lock, with the reverse nesting also present (no established order)",
        ),
        RuleSpec(
            "lock-held-across-fork",
            "error",
            "os.fork / multiprocessing Process/Pool reachable while a lock is held — the child inherits the lock mid-state",
        ),
    )

    def check_project(self, modules: Sequence[ModuleInfo]) -> Iterator[Finding]:
        index = ProjectIndex(modules)
        inventory = LockInventory(index)
        graph = CallGraph(index)
        alias_cache: Dict[str, Dict[str, str]] = {}
        summaries: Dict[str, FnSummary] = {}
        for decl in index.functions.values():
            aliases = alias_cache.get(decl.module.path)
            if aliases is None:
                aliases = import_aliases(decl.module.tree)
                alias_cache[decl.module.path] = aliases
            summaries[decl.qualname] = _FnScanner(decl, inventory, graph, aliases).scan()

        acq_star = self._transitive_acquires(summaries)
        fork_star = self._transitive_forks(summaries)

        order: Dict[LockId, Dict[LockId, EdgeWitness]] = {}

        def add_edge(a: LockId, b: LockId, witness: EdgeWitness) -> None:
            order.setdefault(a, {}).setdefault(b, witness)

        # (C, D) -> list of (module path, line, message) nesting sites
        foreign: Dict[Tuple[str, str], List[Tuple[str, int, str]]] = {}
        findings: List[Finding] = []

        for qual in sorted(summaries):
            s = summaries[qual]
            path = s.decl.module.path
            for acq in s.acquires:
                for h, h_line in acq.held:
                    if h != acq.lock:
                        add_edge(h, acq.lock, EdgeWitness(path, s.decl.display, h_line, acq.line))
            for call in s.calls:
                if not call.held:
                    continue
                held_ids = {h for h, _ in call.held}
                callee_acqs = acq_star.get(call.callee, {})
                for lock, chain in callee_acqs.items():
                    if lock in held_ids:
                        continue  # reentrant through the call — not an order edge
                    for h, h_line in call.held:
                        add_edge(
                            h,
                            lock,
                            EdgeWitness(path, s.decl.display, h_line, call.line, chain=chain),
                        )
                # nested-foreign bookkeeping: local lock held, foreign class
                # method that takes its own class's lock
                c_cls, d_cls = s.decl.cls, call.callee_decl.cls
                if c_cls and d_cls and c_cls != d_cls:
                    local_held = [h for h, _ in call.held if h.is_class and h.owner == c_cls]
                    d_locks = [lk for lk in callee_acqs if lk.is_class and lk.owner == d_cls and lk not in held_ids]
                    if local_held and d_locks:
                        foreign.setdefault((c_cls, d_cls), []).append(
                            (
                                path,
                                call.line,
                                f"{s.decl.display} holds {local_held[0]} and calls "
                                f"{call.callee_decl.display} which takes {d_locks[0]}",
                            )
                        )
                # lock-held-across-fork through the call graph
                fork_chain = fork_star.get(call.callee)
                if fork_chain is not None:
                    h, h_line = call.held[0]
                    via = " -> ".join(step[2] for step in fork_chain)
                    findings.append(
                        Finding(
                            "lock-held-across-fork",
                            "error",
                            path,
                            call.line,
                            f"call while holding {h} (acquired :{h_line}) reaches a fork: {via} — "
                            "the forked child inherits the held lock and deadlocks on first acquire",
                        )
                    )
            for fork in s.forks:
                if fork.held:
                    h, h_line = fork.held[0]
                    findings.append(
                        Finding(
                            "lock-held-across-fork",
                            "error",
                            path,
                            fork.line,
                            f"{fork.kind} while holding {h} (acquired :{h_line}) — "
                            "the forked child inherits the held lock and deadlocks on first acquire",
                        )
                    )

        findings.extend(self._cycle_findings(order))
        findings.extend(self._foreign_findings(foreign))
        yield from findings

    # ---- transitive summaries (fixpoint) ----

    @staticmethod
    def _transitive_acquires(summaries: Dict[str, FnSummary]) -> Dict[str, Dict[LockId, Chain]]:
        acq: Dict[str, Dict[LockId, Chain]] = {}
        for qual, s in summaries.items():
            path = s.decl.module.path
            acq[qual] = {
                a.lock: ((path, a.line, f"{s.decl.display} acquires {a.lock} at {path}:{a.line}"),)
                for a in s.acquires
            }
        changed = True
        while changed:
            changed = False
            for qual, s in summaries.items():
                mine = acq[qual]
                path = s.decl.module.path
                for call in s.calls:
                    for lock, chain in acq.get(call.callee, {}).items():
                        if lock in mine or len(chain) >= _MAX_CHAIN:
                            continue
                        step = (path, call.line, f"{s.decl.display} calls {call.callee_decl.display} at {path}:{call.line}")
                        mine[lock] = (step, *chain)
                        changed = True
        return acq

    @staticmethod
    def _transitive_forks(summaries: Dict[str, FnSummary]) -> Dict[str, Chain]:
        forks: Dict[str, Chain] = {}
        for qual, s in summaries.items():
            if s.forks:
                f = s.forks[0]
                path = s.decl.module.path
                forks[qual] = ((path, f.line, f"{s.decl.display} calls {f.kind} at {path}:{f.line}"),)
        changed = True
        while changed:
            changed = False
            for qual, s in summaries.items():
                if qual in forks:
                    continue
                path = s.decl.module.path
                for call in s.calls:
                    chain = forks.get(call.callee)
                    if chain is not None and len(chain) < _MAX_CHAIN:
                        step = (path, call.line, f"{s.decl.display} calls {call.callee_decl.display} at {path}:{call.line}")
                        forks[qual] = (step, *chain)
                        changed = True
                        break
        return forks

    # ---- findings ----

    def _cycle_findings(self, order: Dict[LockId, Dict[LockId, EdgeWitness]]) -> List[Finding]:
        sccs = _tarjan_sccs(order)
        out: List[Finding] = []
        for scc in sccs:
            if len(scc) < 2:
                continue
            scc_set = set(scc)
            for a in sorted(scc, key=str):
                for b, wit in sorted(order.get(a, {}).items(), key=lambda kv: str(kv[0])):
                    if b not in scc_set:
                        continue
                    back = _shortest_path(order, b, a, scc_set)
                    if back is None:
                        continue
                    reverse_bits = []
                    for x, y in zip(back, back[1:]):
                        w = order[x][y]
                        reverse_bits.append(f"{x} -> {y} at {w.path}:{w.line} in {w.func}")
                    out.append(
                        Finding(
                            "lock-order-cycle",
                            "error",
                            wit.path,
                            wit.line,
                            f"lock-order cycle: {a} -> {b} witnessed at {wit.render(a, b)}; "
                            f"reverse path: {'; '.join(reverse_bits)}",
                        )
                    )
        return out

    @staticmethod
    def _foreign_findings(foreign: Dict[Tuple[str, str], List[Tuple[str, int, str]]]) -> List[Finding]:
        out: List[Finding] = []
        for (c_cls, d_cls), sites in sorted(foreign.items()):
            if (d_cls, c_cls) not in foreign:
                continue  # one direction only: that IS the established order
            other = foreign[(d_cls, c_cls)][0]
            for path, line, desc in sites:
                out.append(
                    Finding(
                        "nested-foreign-lock-call",
                        "warning",
                        path,
                        line,
                        f"{desc}; the reverse nesting ({d_cls} -> {c_cls}) also occurs at "
                        f"{other[0]}:{other[1]} — no established lock order between {c_cls} and {d_cls}",
                    )
                )
        return out


def _tarjan_sccs(adj: Dict[LockId, Dict[LockId, EdgeWitness]]) -> List[List[LockId]]:
    """Iterative Tarjan over the order graph (recursion-free: the graph is
    small but depth is unbounded in principle)."""
    nodes: Set[LockId] = set(adj)
    for targets in adj.values():
        nodes.update(targets)
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    on_stack: Set[LockId] = set()
    stack: List[LockId] = []
    sccs: List[List[LockId]] = []
    counter = [0]

    for root in sorted(nodes, key=str):
        if root in index:
            continue
        work: List[Tuple[LockId, Iterator[LockId]]] = []
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        work.append((root, iter(sorted(adj.get(root, {}), key=str))))
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, {}), key=str))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                scc: List[LockId] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)
    return sccs


def _shortest_path(
    adj: Dict[LockId, Dict[LockId, EdgeWitness]], src: LockId, dst: LockId, allowed: Set[LockId]
) -> Optional[List[LockId]]:
    """BFS path src -> dst inside one SCC; None when unreachable."""
    if src == dst:
        return [src]
    prev: Dict[LockId, LockId] = {}
    queue = [src]
    seen = {src}
    while queue:
        cur = queue.pop(0)
        for nxt in sorted(adj.get(cur, {}), key=str):
            if nxt not in allowed or nxt in seen:
                continue
            prev[nxt] = cur
            if nxt == dst:
                path = [dst]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return list(reversed(path))
            seen.add(nxt)
            queue.append(nxt)
    return None


# ------------------------------------------------------- per-module checker


class ForkSafetyChecker(Checker):
    """fork-with-threads: with the default ``fork`` start method, a child
    forked from a threaded parent inherits every lock in whatever state the
    snapshot caught — held by threads that do not exist in the child. Any
    module that both starts threads and forks must pin the spawn (or
    forkserver) start method."""

    rules = (
        RuleSpec(
            "fork-with-threads",
            "warning",
            "module starts threads AND forks (os.fork / Process / Pool) without a set_start_method('spawn') guard",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        aliases = import_aliases(module.tree)
        fork_calls: List[Tuple[ast.Call, str]] = []
        starts_threads = False
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                if _is_thread_call(node):
                    starts_threads = True
                kind = fork_call_kind(node, aliases)
                if kind:
                    fork_calls.append((node, kind))
            elif isinstance(node, ast.ClassDef):
                if any(dotted_name(b).split(".")[-1] == "Thread" for b in node.bases):
                    starts_threads = True
        if not starts_threads or not fork_calls or has_spawn_guard(module.tree):
            return
        for call, kind in fork_calls:
            yield self.finding(
                module,
                "fork-with-threads",
                call,
                f"{kind} in a module that also starts threads, with no set_start_method('spawn')/"
                "get_context('spawn') guard — the fork child inherits thread-held lock states",
            )


LOCKGRAPH_CHECKERS: Tuple[type, ...] = (ForkSafetyChecker,)
LOCKGRAPH_PROJECT_CHECKERS: Tuple[type, ...] = (LockGraphChecker,)
