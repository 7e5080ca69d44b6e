"""Concurrency checkers: races and stalls in the threaded gateway modules.

Heuristic contracts (documented in docs/static-analysis.md): threads enter a
class through ``threading.Thread(target=...)`` or a ``Thread`` subclass
``run``; a lock guard is any ``with`` on a name/attribute whose identifier
contains ``lock``/``mutex``/``cond`` or that was bound from
``threading.Lock/RLock/Condition``. These deliberately over-approximate —
a false positive costs one justified ``# sklint: disable`` comment, a missed
race costs a soak-run postmortem.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

from skyplane_tpu_torch.analysis.core import Checker, Finding, ModuleInfo, RuleSpec

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_LOCKISH_FRAGMENTS = ("lock", "mutex", "cond")


def walk_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT entering nested function/class defs
    (their bodies run in a different dynamic scope, usually a different time)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(child))


def dotted_name(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_lockish(expr: ast.AST, lock_attrs: Set[str]) -> bool:
    name = dotted_name(expr)
    if not name:
        return False
    terminal = name.split(".")[-1].lower()
    if isinstance(expr, ast.Attribute) and name.startswith("self.") and expr.attr in lock_attrs:
        return True
    return any(frag in terminal for frag in _LOCKISH_FRAGMENTS)


def _lock_attr_names(cls: ast.ClassDef) -> Set[str]:
    """self.X attributes bound from a threading lock factory anywhere in the
    class — seeing through the ``lockcheck.wrap(threading.Lock(), ...)``
    runtime-witness shim (obs/lockwitness.py)."""
    attrs: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            factory = dotted_name(call.func).split(".")[-1]
            if factory == "wrap" and call.args and isinstance(call.args[0], ast.Call):
                factory = dotted_name(call.args[0].func).split(".")[-1]
            if factory in _LOCK_FACTORIES:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
                        attrs.add(tgt.attr)
    return attrs


def _is_thread_call(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    return name in ("threading.Thread", "Thread")


def _self_attr_target(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


@dataclass
class _Write:
    attr: str
    node: ast.AST
    func: str  # display name of the writing function
    entry: bool  # runs on a spawned thread
    locked: bool


class SharedStateChecker(Checker):
    """unlocked-shared-write: a ``self.attr`` assigned both on a spawned
    thread's path and from another method, with at least one side unguarded.
    ``__init__`` writes are pre-``start()`` and exempt (happens-before)."""

    rules = (
        RuleSpec(
            "unlocked-shared-write",
            "error",
            "attribute written from a thread entry path and from another method without a lock on every write",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for cls in [n for n in ast.walk(module.tree) if isinstance(n, ast.ClassDef)]:
            yield from self._check_class(module, cls)

    def _check_class(self, module: ModuleInfo, cls: ast.ClassDef) -> Iterator[Finding]:
        lock_attrs = _lock_attr_names(cls)
        methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
        entry_names = self._entry_functions(cls, methods)
        writes: List[_Write] = []
        for meth in methods:
            is_entry = meth.name in entry_names
            writes.extend(self._collect_writes(meth, meth.name, is_entry, lock_attrs))
            # nested defs handed to Thread(target=...) write self.* via closure
            for nested in [n for n in ast.walk(meth) if isinstance(n, ast.FunctionDef) and n is not meth]:
                nested_entry = f"{meth.name}.{nested.name}" in entry_names
                writes.extend(self._collect_writes(nested, f"{meth.name}.{nested.name}", nested_entry, lock_attrs))
        by_attr: Dict[str, List[_Write]] = {}
        for w in writes:
            by_attr.setdefault(w.attr, []).append(w)
        for attr, ws in sorted(by_attr.items()):
            entry_ws = [w for w in ws if w.entry]
            other_ws = [w for w in ws if not w.entry and w.func != "__init__"]
            cross_entry = len({w.func for w in entry_ws}) > 1
            if not entry_ws or not (other_ws or cross_entry):
                continue
            involved = entry_ws + other_ws
            unlocked = [w for w in involved if not w.locked]
            if not unlocked:
                continue
            peers = sorted({w.func for w in involved})
            for w in unlocked:
                yield self.finding(
                    module,
                    "unlocked-shared-write",
                    w.node,
                    f"{cls.name}.{attr} is written by {', '.join(peers)} across threads; this write in {w.func} holds no lock",
                )

    @staticmethod
    def _entry_functions(cls: ast.ClassDef, methods: List[ast.FunctionDef]) -> Set[str]:
        entries: Set[str] = set()
        if any(dotted_name(b).split(".")[-1] == "Thread" for b in cls.bases):
            entries.add("run")
        for meth in methods:
            for node in ast.walk(meth):
                if not (isinstance(node, ast.Call) and _is_thread_call(node)):
                    continue
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    target_attr = _self_attr_target(kw.value)
                    if target_attr:
                        entries.add(target_attr)
                    elif isinstance(kw.value, ast.Name):
                        entries.add(f"{meth.name}.{kw.value.id}")  # nested def target
        return entries

    @staticmethod
    def _collect_writes(fn: ast.FunctionDef, display: str, entry: bool, lock_attrs: Set[str]) -> List[_Write]:
        writes: List[_Write] = []

        def visit(node: ast.AST, locked: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
                return
            if isinstance(node, ast.With):
                inner = locked or any(_is_lockish(item.context_expr, lock_attrs) for item in node.items)
                for child in ast.iter_child_nodes(node):
                    visit(child, inner)
                return
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None:
                targets = [node.target]
            for tgt in targets:
                attr = _self_attr_target(tgt)
                if attr is None or attr in lock_attrs:
                    continue
                # binding a lock/event/queue object is setup, not shared data
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    factory = dotted_name(node.value.func).split(".")[-1]
                    if factory in _LOCK_FACTORIES | {"Event", "Queue", "local"}:
                        continue
                writes.append(_Write(attr=attr, node=node, func=display, entry=entry, locked=locked))
            for child in ast.iter_child_nodes(node):
                visit(child, locked)

        for stmt in fn.body:
            visit(stmt, False)
        return writes


class ThreadLifecycleChecker(Checker):
    """thread-no-daemon: a Thread created with neither ``daemon=`` nor any
    ``join()`` in the same scope leaks past shutdown and can hang exit."""

    rules = (
        RuleSpec(
            "thread-no-daemon",
            "warning",
            "threading.Thread created without daemon= and never joined in the enclosing scope",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        scopes: List[ast.AST] = [module.tree]
        scopes.extend(n for n in ast.walk(module.tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
        seen: Set[ast.Call] = set()
        for scope in scopes:
            calls = [
                n
                for n in walk_scope(scope)
                if isinstance(n, ast.Call) and _is_thread_call(n) and n not in seen
            ]
            if not calls:
                continue
            seen.update(calls)
            # any join()/`.daemon =` in the scope counts as lifecycle handling
            joined = any(
                (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "join")
                or (isinstance(n, ast.Assign) and any(isinstance(t, ast.Attribute) and t.attr == "daemon" for t in n.targets))
                for n in walk_scope(scope)
            )
            for call in calls:
                if any(kw.arg == "daemon" for kw in call.keywords):
                    continue
                if joined:
                    continue
                yield self.finding(
                    module,
                    "thread-no-daemon",
                    call,
                    "Thread has no daemon= and no join() in this scope — it outlives shutdown silently",
                )


_BLOCKING_PREFIXES = ("requests.", "urllib.", "socket.", "subprocess.")
_QUEUEISH_FRAGMENTS = ("queue", "_q")


class BlockingUnderLockChecker(Checker):
    """blocking-under-lock: sleeping or doing network/queue I/O while holding
    a lock turns every peer thread's short critical section into that I/O's
    latency — the gateway's classic whole-daemon stall. Socket-method calls
    are owned by the dedicated ``socket-io-under-lock`` rule (which also
    tracks acquire()/release() spans and matches any receiver object)."""

    rules = (
        RuleSpec(
            "blocking-under-lock",
            "error",
            "blocking call (sleep / network / unbounded queue get) inside a held lock",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        lock_attrs: Set[str] = set()
        for cls in [n for n in ast.walk(module.tree) if isinstance(n, ast.ClassDef)]:
            lock_attrs |= _lock_attr_names(cls)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.With):
                continue
            if not any(_is_lockish(item.context_expr, lock_attrs) for item in node.items):
                continue
            for stmt in node.body:
                for sub in self._walk_with_self(stmt):
                    if isinstance(sub, ast.Call):
                        reason = self._blocking_reason(sub)
                        if reason:
                            yield self.finding(module, "blocking-under-lock", sub, f"{reason} while a lock is held")

    @staticmethod
    def _walk_with_self(node: ast.AST) -> Iterator[ast.AST]:
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            return
        for child in ast.iter_child_nodes(node):
            yield from BlockingUnderLockChecker._walk_with_self(child)

    @staticmethod
    def _blocking_reason(call: ast.Call) -> Optional[str]:
        name = dotted_name(call.func)
        if name in ("time.sleep", "sleep"):
            return "time.sleep"
        if any(name.startswith(p) for p in _BLOCKING_PREFIXES):
            return f"network/process call {name}"
        if isinstance(call.func, ast.Attribute):
            obj = dotted_name(call.func.value).split(".")[-1].lower()
            if (
                call.func.attr == "get"
                and not call.args
                and not any(kw.arg == "timeout" for kw in call.keywords)
                and any(frag in obj for frag in _QUEUEISH_FRAGMENTS)
            ):
                return f"{obj}.get() with no timeout"
        return None


_SOCKET_IO_METHODS = {"recv", "recv_into", "recvfrom", "send", "sendall", "accept", "connect", "do_handshake", "unwrap", "makefile"}


class SocketIOUnderLockChecker(Checker):
    """socket-io-under-lock: a blocking socket call (``recv``/``sendall``/…)
    while holding a lock couples every peer thread's critical section to one
    peer's network latency — a stalled remote stalls the whole operator pool.
    This is the bug class the pipelined sender rewrite must never
    reintroduce (its pump owns the socket and takes its stream lock only for
    deque bookkeeping, never across a socket call).

    Broader than ``blocking-under-lock``'s old socket branch on BOTH axes:
    the receiver object's NAME does not matter (a socket held in ``self.s``
    or ``peer`` still blocks), and explicit ``lock.acquire()``/``release()``
    spans count as held regions alongside ``with lock:`` bodies. Wake-channel
    writes on a non-blocking socketpair are the one legitimate pattern —
    suppress those with a justification per policy."""

    rules = (
        RuleSpec(
            "socket-io-under-lock",
            "error",
            "blocking socket call (recv/sendall/accept/connect/...) while a lock is held",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        lock_attrs: Set[str] = set()
        for cls in [n for n in ast.walk(module.tree) if isinstance(n, ast.ClassDef)]:
            lock_attrs |= _lock_attr_names(cls)
        out: List[Finding] = []
        for fn in [n for n in ast.walk(module.tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            self._scan_stmts(module, fn.body, 0, lock_attrs, out)
        yield from out

    def _scan_stmts(self, module: ModuleInfo, stmts, held: int, lock_attrs: Set[str], out: List[Finding]) -> int:
        """Walk one statement sequence tracking the held-lock depth; returns
        the depth after the sequence (acquire/release are sequential effects)."""
        for stmt in stmts:
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                call = stmt.value
                if isinstance(call.func, ast.Attribute) and _is_lockish(call.func.value, lock_attrs):
                    if call.func.attr == "acquire":
                        held += 1
                        continue
                    if call.func.attr == "release":
                        held = max(0, held - 1)
                        continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # different dynamic scope; scanned as its own function
            if isinstance(stmt, ast.With):
                inner = held + sum(1 for item in stmt.items if _is_lockish(item.context_expr, lock_attrs))
                self._scan_stmts(module, stmt.body, inner, lock_attrs, out)
                continue
            if isinstance(stmt, ast.Try):
                # body runs after any preceding acquire(); finally typically
                # holds the release — scanning in source order models exactly
                # the acquire()/try/finally-release() idiom
                self._scan_stmts(module, stmt.body, held, lock_attrs, out)
                for handler in stmt.handlers:
                    self._scan_stmts(module, handler.body, held, lock_attrs, out)
                self._scan_stmts(module, stmt.orelse, held, lock_attrs, out)
                held = self._scan_stmts(module, stmt.finalbody, held, lock_attrs, out)
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                self._scan_expr(module, stmt.test, held, out)
                self._scan_stmts(module, stmt.body, held, lock_attrs, out)
                self._scan_stmts(module, stmt.orelse, held, lock_attrs, out)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(module, stmt.iter, held, out)
                self._scan_stmts(module, stmt.body, held, lock_attrs, out)
                self._scan_stmts(module, stmt.orelse, held, lock_attrs, out)
                continue
            self._scan_expr(module, stmt, held, out)
        return held

    def _scan_expr(self, module: ModuleInfo, node: ast.AST, held: int, out: List[Finding]) -> None:
        if not held:
            return
        for sub in BlockingUnderLockChecker._walk_with_self(node):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _SOCKET_IO_METHODS
            ):
                out.append(
                    self.finding(
                        module,
                        "socket-io-under-lock",
                        sub,
                        f"socket {sub.func.attr}() on {dotted_name(sub.func.value) or 'object'} while a lock is held",
                    )
                )


_QUEUE_FACTORIES = {"queue.Queue", "Queue", "queue.LifoQueue", "LifoQueue", "queue.PriorityQueue", "PriorityQueue"}
_ALWAYS_UNBOUNDED = {"queue.SimpleQueue", "SimpleQueue"}
_DEQUE_FACTORIES = {"deque", "collections.deque"}


class UnboundedQueueInGatewayChecker(Checker):
    """unbounded-queue-in-gateway: a ``queue.Queue()``/``deque()`` with no
    size bound constructed in gateway code. Unbounded queues are the
    tenant-isolation bug class of the multi-tenant gateway: any point where
    one tenant's backlog can buffer without limit (a NACK storm re-queueing
    chunks, a stalled peer's profile events, a runaway status stream) turns
    into unbounded memory that starves every OTHER tenant on the box —
    backpressure must reach the offender, not the allocator.

    Fires only under a ``gateway`` path segment (the threaded data/control
    plane); library modules that feed it are bounded by their callers. A
    genuinely-bounded-by-protocol structure (e.g. an in-flight deque capped
    by a byte window) takes a justified ``# sklint: disable`` per policy.
    Bounds the checker recognizes: any positional size argument or a
    ``maxsize=``/``maxlen=`` keyword that is not a literal 0/None.
    """

    rules = (
        RuleSpec(
            "unbounded-queue-in-gateway",
            "error",
            "queue.Queue()/deque() in gateway code with no maxsize/maxlen bound",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        from pathlib import PurePath

        if "gateway" not in PurePath(module.path).parts:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in _ALWAYS_UNBOUNDED:
                yield self.finding(
                    module, "unbounded-queue-in-gateway", node, f"{name}() has no bound at all — use queue.Queue(maxsize=...)"
                )
                continue
            if name in _QUEUE_FACTORIES:
                if not self._bounded(node, kw="maxsize", positional_index=0):
                    yield self.finding(
                        module,
                        "unbounded-queue-in-gateway",
                        node,
                        f"{name}() without a maxsize bound — one slow consumer buffers without limit",
                    )
            elif name in _DEQUE_FACTORIES:
                if not self._bounded(node, kw="maxlen", positional_index=1):
                    yield self.finding(
                        module,
                        "unbounded-queue-in-gateway",
                        node,
                        f"{name}() without a maxlen bound — one slow consumer buffers without limit",
                    )

    @staticmethod
    def _bounded(call: ast.Call, kw: str, positional_index: int) -> bool:
        """A literal 0/None bound is unbounded; a non-zero literal or any
        dynamic expression counts as bounded (can't evaluate statically)."""

        def is_unbounded_literal(node: ast.AST) -> bool:
            return isinstance(node, ast.Constant) and (node.value == 0 or node.value is None)

        for k in call.keywords:
            if k.arg == kw:
                return not is_unbounded_literal(k.value)
        if len(call.args) > positional_index:
            return not is_unbounded_literal(call.args[positional_index])
        return False


class BareExceptLoopChecker(Checker):
    """bare-except-in-loop: an ``except:``/``except BaseException`` that does
    not re-raise, inside a service loop, also swallows KeyboardInterrupt /
    SystemExit — the loop can never be shut down."""

    rules = (
        RuleSpec(
            "bare-except-in-loop",
            "warning",
            "bare except (or BaseException without re-raise) inside a loop swallows shutdown",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for loop in [n for n in ast.walk(module.tree) if isinstance(n, (ast.While, ast.For))]:
            for node in walk_scope(loop):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                broad = node.type is None or dotted_name(node.type).split(".")[-1] == "BaseException"
                if not broad:
                    continue
                reraises = any(isinstance(sub, ast.Raise) for sub in ast.walk(node))
                if reraises:
                    continue
                yield self.finding(
                    module,
                    "bare-except-in-loop",
                    node,
                    "bare/BaseException handler in a loop with no re-raise — Ctrl-C and shutdown get eaten",
                )


class FlatSleepInRetryLoopChecker(Checker):
    """flat-sleep-in-retry-loop: a fixed-duration ``time.sleep`` in a retry
    context under the gateway/ or api/ trees — the bug class the fault-
    injection work removed (docs/fault-injection.md). Flat sleeps in retry
    paths have two failure modes: a fleet of workers retrying a recovered
    endpoint re-collides in lockstep (no jitter), and compounding fixed
    waits have no deadline. Retry pacing must come from a
    :class:`~skyplane_tpu_torch.utils.retry.RetryPolicy` (``policy.backoff_s(n)``
    — a call expression, which this rule treats as clean).

    Fires when the sleep sits (a) inside an ``except`` handler, or (b) inside
    a loop that DIRECTLY contains a try/except (the hand-rolled
    ``for attempt in range(n)`` idiom). "Flat" = a numeric literal or pure
    arithmetic over literals/names (``0.5 * (attempt + 1)`` — a deterministic
    ramp is still synchronized); a bare name or any call expression is not
    flagged, since adaptive/jittered durations arrive through those.
    """

    rules = (
        RuleSpec(
            "flat-sleep-in-retry-loop",
            "error",
            "constant/arithmetic time.sleep in an except handler or retry loop — use a jittered RetryPolicy",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        from pathlib import PurePath

        parts = PurePath(module.path).parts
        if "gateway" not in parts and "api" not in parts:
            return
        out: List[Finding] = []
        for fn in [n for n in ast.walk(module.tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            self._scan(module, fn.body, in_except=False, in_retry_loop=False, out=out)
        yield from out

    def _scan(self, module: ModuleInfo, stmts, in_except: bool, in_retry_loop: bool, out: List[Finding]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # scanned as its own function
            if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
                # a retry loop is one that DIRECTLY contains a try/except
                # (not via a nested loop — a poll loop whose body has an
                # inner drain loop with its own except is not retrying)
                retry = self._directly_contains_except(stmt)
                self._scan(module, stmt.body, in_except, retry, out)
                self._scan(module, stmt.orelse, in_except, in_retry_loop, out)
                continue
            if isinstance(stmt, ast.Try):
                self._scan(module, stmt.body, in_except, in_retry_loop, out)
                for handler in stmt.handlers:
                    self._scan(module, handler.body, True, in_retry_loop, out)
                self._scan(module, stmt.orelse, in_except, in_retry_loop, out)
                self._scan(module, stmt.finalbody, in_except, in_retry_loop, out)
                continue
            if isinstance(stmt, (ast.If, ast.With)):
                self._scan(module, stmt.body, in_except, in_retry_loop, out)
                self._scan(module, getattr(stmt, "orelse", []), in_except, in_retry_loop, out)
                continue
            if not (in_except or in_retry_loop):
                continue
            for node in walk_scope(stmt):
                if (
                    isinstance(node, ast.Call)
                    and dotted_name(node.func) in ("time.sleep", "sleep")
                    and node.args
                    and self._is_flat(node.args[0])
                ):
                    where = "except handler" if in_except else "retry loop"
                    out.append(
                        self.finding(
                            module,
                            "flat-sleep-in-retry-loop",
                            node,
                            f"flat time.sleep in an {where} — retries need jitter and a deadline (RetryPolicy)",
                        )
                    )
    @staticmethod
    def _directly_contains_except(loop: ast.AST) -> bool:
        stack = list(ast.iter_child_nodes(loop))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.While, ast.For, ast.AsyncFor, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Try) and node.handlers:
                return True
            stack.extend(ast.iter_child_nodes(node))
        return False

    @staticmethod
    def _is_flat(node: ast.AST) -> bool:
        """Literal durations and pure arithmetic ramps are flat; names and
        call expressions (policy.backoff_s, random jitter) are not."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, (int, float)) and not isinstance(node.value, bool)
        if isinstance(node, (ast.BinOp, ast.UnaryOp)):
            has_const = False
            stack = [node]
            while stack:
                sub = stack.pop()
                if isinstance(sub, ast.BinOp):
                    stack += [sub.left, sub.right]
                elif isinstance(sub, ast.UnaryOp):
                    stack.append(sub.operand)
                elif isinstance(sub, ast.Constant):
                    if not isinstance(sub.value, (int, float)):
                        return False
                    has_const = True
                elif isinstance(sub, (ast.Name, ast.Attribute)):
                    continue
                else:
                    return False  # a Call (or anything dynamic) in the tree: not flat
            return has_const
        return False


class UnjoinedThreadInGatewayChecker(Checker):
    """unjoined-thread-in-gateway: a thread started under ``gateway/`` or
    ``compute/`` with neither ``daemon=`` at construction nor a visible
    joined stop path. The drain/repair work added several long-lived
    control threads (preemption watcher, drain flusher, repair workers) and
    NONE may outlive shutdown: a non-daemon thread nobody joins wedges
    process exit, and even a daemon thread without a join in its owner's
    stop path can race teardown (docs/static-analysis.md).

    Stricter than ``thread-no-daemon`` on scope (error, not warning) but
    wider on evidence: the join may live anywhere in the MODULE, keyed by
    the name the Thread is bound to (``self._watcher = Thread(...)`` +
    ``self._watcher.join()`` in ``stop()`` counts; so does a loop variable
    joined over a collected list). A Thread constructed and started without
    any binding (``Thread(target=...).start()``) can never be joined and
    always fires unless it is a daemon."""

    rules = (
        RuleSpec(
            "unjoined-thread-in-gateway",
            "error",
            "Thread under gateway//compute/ with neither daemon= nor a module-visible join on its binding",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        from pathlib import PurePath

        parts = PurePath(module.path).parts
        if "gateway" not in parts and "compute" not in parts:
            return
        joined = self._joined_names(module.tree)
        bound_calls: Set[ast.Call] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and _is_thread_call(node.value):
                bound_calls.add(node.value)
                if any(kw.arg == "daemon" for kw in node.value.keywords):
                    continue
                names = {self._terminal_of(t) for t in node.targets} - {""}
                if names & joined:
                    continue
                yield self.finding(
                    module,
                    "unjoined-thread-in-gateway",
                    node.value,
                    f"Thread bound to {', '.join(sorted(names)) or 'unnamed target'} has no daemon= and "
                    "no join() anywhere in this module — it outlives shutdown",
                )
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and _is_thread_call(node) and node not in bound_calls):
                continue
            if any(kw.arg == "daemon" for kw in node.keywords):
                continue
            yield self.finding(
                module,
                "unjoined-thread-in-gateway",
                node,
                "Thread constructed without a binding and without daemon= — it can never be joined",
            )

    @staticmethod
    def _terminal_of(node: ast.AST) -> str:
        if isinstance(node, ast.Attribute):
            return node.attr
        if isinstance(node, ast.Name):
            return node.id
        return ""

    @staticmethod
    def _joined_names(tree: ast.Module) -> Set[str]:
        """Names with lifecycle handling anywhere in the module: ``X.join()``
        calls and ``X.daemon = True`` assignments, keyed by terminal name."""
        joined: Set[str] = set()
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
            ):
                name = UnjoinedThreadInGatewayChecker._terminal_of(node.func.value)
                if name:
                    joined.add(name)
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and tgt.attr == "daemon":
                        name = UnjoinedThreadInGatewayChecker._terminal_of(tgt.value)
                        if name:
                            joined.add(name)
        return joined


_TIME_NOW_CALLS = {"time.time", "time.monotonic", "monotonic"}
_DEADLINEISH_FRAGMENTS = ("deadline", "timeout", "budget", "expires", "expiry")


class UnboundedWaitInProvisionerChecker(Checker):
    """unbounded-wait-in-provisioner: a ``while`` poll loop (one that sleeps)
    under ``compute/`` with no deadline bound — the bug class behind the r05
    rc=124 artifact loss (an unbounded tunnel-lock wait spun until the outer
    timeout killed the whole run). A cloud API that never converges
    (operation stuck, instance wedged in PENDING, SSH never up) must surface
    as a TimeoutError with context, not hang the fleet bring-up forever.

    A loop counts as BOUNDED when a deadline comparison is visible either in
    the loop test (``while time.time() < deadline:``) or anywhere directly
    in the loop body (``if time.time() >= deadline: raise``) — a comparison
    involving ``time.time()``/``time.monotonic()`` or any name containing
    deadline/timeout/budget/expires. ``for`` loops are iteration-bounded by
    construction and never flagged; loops that do not sleep (pagination)
    are not waits."""

    rules = (
        RuleSpec(
            "unbounded-wait-in-provisioner",
            "error",
            "while-loop polling with time.sleep under compute/ and no visible deadline bound",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        from pathlib import PurePath

        if "compute" not in PurePath(module.path).parts:
            return
        for loop in [n for n in ast.walk(module.tree) if isinstance(n, ast.While)]:
            body_nodes = [n for n in walk_scope(loop) if n is not loop]
            sleeps = [
                n
                for n in body_nodes
                if isinstance(n, ast.Call) and dotted_name(n.func) in ("time.sleep", "sleep")
            ]
            if not sleeps:
                continue
            if self._has_deadline_compare(loop.test) or any(self._has_deadline_compare(n) for n in body_nodes):
                continue
            yield self.finding(
                module,
                "unbounded-wait-in-provisioner",
                loop,
                "poll loop sleeps with no deadline bound — compare against time.time()/a deadline and raise TimeoutError",
            )

    @staticmethod
    def _has_deadline_compare(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Compare):
                continue
            for side in [sub.left, *sub.comparators]:
                if isinstance(side, ast.Call) and dotted_name(side.func) in _TIME_NOW_CALLS:
                    return True
                name = dotted_name(side)
                terminal = name.split(".")[-1].lower()
                if any(frag in terminal for frag in _DEADLINEISH_FRAGMENTS):
                    return True
        return False


_EVENTISH_FRAGMENTS = ("event", "firing", "journal", "history")
_BOUND_MAINT_METHODS = {"pop", "popleft", "clear"}


def _is_eventish(name: str) -> bool:
    """Terminal attribute names that smell like an append-only event record:
    'events', 'firing_log', 'status_journal', 'chunk_status_log', '_log'.
    Plain '...log'-suffixed words ('catalog') and 'logger' do not match."""
    lowered = name.lower()
    return (
        any(frag in lowered for frag in _EVENTISH_FRAGMENTS)
        or lowered == "log"
        or lowered.endswith("_log")
    )


class UnboundedEventLogChecker(Checker):
    """unbounded-event-log: an event/firing/journal list under ``gateway/``
    or ``obs/`` appended to with no visible bound. The flight-recorder /
    fleet-log bug class (docs/observability.md): an event record nobody
    drains grows for the daemon's lifetime, and on a multi-tenant gateway
    that is unbounded memory charged to every tenant at once. Every journal
    must either be structurally bounded (``deque(maxlen=...)``, a bounded
    ``queue.Queue``) or actively trimmed with the truncation COUNTED
    (``*_dropped`` counters — truncation is never silent).

    Fires on ``<attr>.append(...)`` where the terminal attribute name smells
    like an event record (event / firing / journal / history / *_log).
    Bare-local appends are exempt (function-scoped lists die with the call).
    An attribute counts as bounded when the MODULE shows any of: construction
    as ``deque(maxlen=...)`` / ``Queue(maxsize=...)`` with a nonzero bound,
    ``del X[...]`` trimming, ``X.pop()/popleft()/clear()``, a slice
    assignment to ``X``, or a ``len(X)`` comparison (the cap check guarding a
    trim). A genuinely protocol-bounded list takes a justified
    ``# sklint: disable`` per policy."""

    rules = (
        RuleSpec(
            "unbounded-event-log",
            "error",
            "event/firing/journal attribute appended in gateway//obs/ code with no visible bound or trim",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        from pathlib import PurePath

        parts = PurePath(module.path).parts
        if "gateway" not in parts and "obs" not in parts:
            return
        bounded = self._bounded_names(module.tree)
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and isinstance(node.func.value, ast.Attribute)  # attribute targets only
            ):
                continue
            terminal = node.func.value.attr
            if not _is_eventish(terminal) or terminal in bounded:
                continue
            yield self.finding(
                module,
                "unbounded-event-log",
                node,
                f"append to event record {dotted_name(node.func.value) or terminal!r} with no visible bound — "
                "use deque(maxlen=...) or trim with a counted drop",
            )

    @staticmethod
    def _bounded_names(tree: ast.Module) -> Set[str]:
        """Terminal attribute names with visible bound maintenance anywhere in
        the module (name-keyed: helper methods trimming the same attribute
        count, wherever they live)."""
        bounded: Set[str] = set()

        def terminal_of(node: ast.AST) -> str:
            return node.attr if isinstance(node, ast.Attribute) else (node.id if isinstance(node, ast.Name) else "")

        for node in ast.walk(tree):
            # construction with a structural bound: deque(maxlen=...) /
            # Queue(maxsize=...) where the bound is not a literal 0/None
            # (dynamic expressions can't be evaluated statically: bounded)
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(node.value, ast.Call):
                factory = dotted_name(node.value.func).split(".")[-1]
                kw = {"deque": "maxlen"}.get(factory) or (
                    "maxsize" if factory in ("Queue", "LifoQueue", "PriorityQueue") else None
                )
                if kw:
                    for k in node.value.keywords:
                        if k.arg == kw and not (
                            isinstance(k.value, ast.Constant) and (k.value.value in (0, None))
                        ):
                            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                            for tgt in targets:
                                name = terminal_of(tgt)
                                if name:
                                    bounded.add(name)
            # active trimming: del X[...] / X.pop()/popleft()/clear() /
            # slice assignment / len(X) comparison (the cap check)
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        name = terminal_of(tgt.value)
                        if name:
                            bounded.add(name)
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _BOUND_MAINT_METHODS
            ):
                name = terminal_of(node.func.value)
                if name:
                    bounded.add(name)
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        name = terminal_of(tgt.value)
                        if name:
                            bounded.add(name)
            if isinstance(node, ast.Compare):
                for side in [node.left, *node.comparators]:
                    if (
                        isinstance(side, ast.Call)
                        and dotted_name(side.func) == "len"
                        and side.args
                    ):
                        name = terminal_of(side.args[0])
                        if name:
                            bounded.add(name)
        return bounded


CONCURRENCY_CHECKERS: Tuple[type, ...] = (
    SharedStateChecker,
    ThreadLifecycleChecker,
    BlockingUnderLockChecker,
    SocketIOUnderLockChecker,
    UnboundedQueueInGatewayChecker,
    BareExceptLoopChecker,
    FlatSleepInRetryLoopChecker,
    UnboundedWaitInProvisionerChecker,
    UnboundedEventLogChecker,
    UnjoinedThreadInGatewayChecker,
)
