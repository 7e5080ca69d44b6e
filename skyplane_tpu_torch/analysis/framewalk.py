"""Frame-walk safety checker: sampler-deadlock bug class.

The sampling profiler (obs/profiler.py) snapshots ``sys._current_frames()``
(and ``threading.enumerate()``) on a dedicated thread while every other
thread keeps running. That is only safe when the walk is *pure*: fold the
snapshot into local data, take no locks, call no non-local code. The bug
class this rule guards against is the classic sampler deadlock:

  * **Walking under a lock.** The sampler snapshots frames while holding a
    profiler (or any other) lock; one of the walked threads is blocked
    trying to acquire that same lock inside code the sampler then calls into
    (an allocation hook, a logging handler, a metrics callback) — or the
    export path wants the lock the sampler holds. Either way the process
    the profiler was supposed to observe is now wedged BY the profiler.
  * **Callbacks inside the walk.** Invoking a non-local callable per walked
    thread (``self.on_sample(...)``, a ``callback`` parameter) runs
    arbitrary code — code that may lock, block, or re-enter the profiler —
    once per thread per tick, inside the most delicate loop in the process.

Scope:

  * a ``sys._current_frames()`` / ``threading.enumerate()`` call lexically
    inside a ``with <lock>`` block (lock-ish context expressions per the
    concurrency checker's heuristics) or after a bare ``<lock>.acquire()``
    in the same statement body — flagged;
  * inside a ``for`` loop iterating over either snapshot: acquiring a lock
    (``with <lock>:`` / ``<lock>.acquire()``) or invoking a callback-shaped
    callable (``on_*`` / ``*_cb`` / ``*_callback`` / ``*_hook`` /
    ``*_fn`` attributes, or a bare name that is a parameter of the
    enclosing function) — flagged.

The safe pattern (what obs/profiler.py does): snapshot first, fold into
LOCAL aggregates with pure dict/tuple operations, then merge under the lock
after the walk completes.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from skyplane_tpu_torch.analysis.concurrency import _LOCKISH_FRAGMENTS, dotted_name
from skyplane_tpu_torch.analysis.core import Checker, Finding, ModuleInfo, RuleSpec
from skyplane_tpu_torch.analysis.tracer import canonical_name, import_aliases

_WALK_CALLS = {"sys._current_frames", "threading.enumerate"}
_CALLBACK_SUFFIXES = ("_cb", "_callback", "_hook", "_fn")


def _lockish_name(name: str) -> bool:
    if not name:
        return False
    terminal = name.split(".")[-1].lower()
    return any(frag in terminal for frag in _LOCKISH_FRAGMENTS)


def _is_walk_call(node: ast.AST, aliases) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    name = canonical_name(node.func, aliases)
    return name if name in _WALK_CALLS else None


def _held_lock_of_with(node: ast.With) -> Optional[str]:
    for item in node.items:
        expr = item.context_expr
        # `with self._lock:` / `with lock:` — the acquired object itself
        if _lockish_name(dotted_name(expr)):
            return dotted_name(expr)
        # `with lock.acquire_timeout(...)`-style helpers
        if isinstance(expr, ast.Call) and _lockish_name(dotted_name(expr.func).rsplit(".", 1)[0]):
            return dotted_name(expr.func)
    return None


def _acquire_target(node: ast.AST) -> Optional[str]:
    """``<lock>.acquire(...)`` call -> the lock's dotted name."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "acquire"
        and _lockish_name(dotted_name(node.func.value))
    ):
        return dotted_name(node.func.value)
    return None


def _callback_shaped(call: ast.Call, params: Set[str]) -> Optional[str]:
    """Name of a callback-shaped callee, or None. Attribute calls match by
    naming convention (on_*, *_cb, *_callback, *_hook, *_fn); bare-name
    calls match when the name is a parameter of the enclosing function —
    a caller-supplied callable is non-local by definition."""
    func = call.func
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr.startswith("on_") or attr.endswith(_CALLBACK_SUFFIXES):
            return dotted_name(func) or attr
        return None
    if isinstance(func, ast.Name) and func.id in params:
        return func.id
    return None


class FrameWalkChecker(Checker):
    rules = (
        RuleSpec(
            "frame-walk-under-lock",
            "error",
            "sys._current_frames()/threading.enumerate() walked while holding a lock, or a lock/"
            "non-local callback invoked inside the walk (the sampler-deadlock bug class)",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        aliases = import_aliases(module.tree)
        # --- walking while a lock is held ---
        for with_node in ast.walk(module.tree):
            if not isinstance(with_node, ast.With):
                continue
            lock = _held_lock_of_with(with_node)
            if lock is None:
                continue
            for node in ast.walk(with_node):
                walk = _is_walk_call(node, aliases)
                if walk:
                    yield self.finding(
                        module,
                        "frame-walk-under-lock",
                        node,
                        f"{walk}() snapshotted while holding {lock} — a walked thread blocked on "
                        "that lock deadlocks the sampler (snapshot first, merge under the lock after)",
                    )
        # --- locks / callbacks inside the walk loop ---
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = {a.arg for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs}
            params.discard("self")
            for loop in ast.walk(fn):
                if not isinstance(loop, ast.For):
                    continue
                walk = next(
                    (w for n in ast.walk(loop.iter) if (w := _is_walk_call(n, aliases))),
                    None,
                )
                if walk is None:
                    continue
                for node in self._loop_body(loop):
                    if isinstance(node, ast.With):
                        lock = _held_lock_of_with(node)
                        if lock:
                            yield self.finding(
                                module,
                                "frame-walk-under-lock",
                                node,
                                f"acquiring {lock} inside the {walk}() walk — blocking per walked "
                                "thread starves the sampler and invites lock-order deadlocks",
                            )
                    acquired = _acquire_target(node)
                    if acquired:
                        yield self.finding(
                            module,
                            "frame-walk-under-lock",
                            node,
                            f"{acquired}.acquire() inside the {walk}() walk — blocking per walked "
                            "thread starves the sampler and invites lock-order deadlocks",
                        )
                    if isinstance(node, ast.Call):
                        cb = _callback_shaped(node, params)
                        if cb:
                            yield self.finding(
                                module,
                                "frame-walk-under-lock",
                                node,
                                f"non-local callback {cb}() invoked inside the {walk}() walk — "
                                "arbitrary code per walked thread may lock or re-enter the profiler; "
                                "collect locally and dispatch after the walk",
                            )

    @staticmethod
    def _loop_body(loop: ast.For) -> Iterator[ast.AST]:
        """Walk the loop body only (not the iter expression — the snapshot
        call itself lives there) and stay out of nested function defs, which
        are judged in their own scope."""
        stack: List[ast.AST] = list(loop.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))


FRAMEWALK_CHECKERS: Tuple[type, ...] = (FrameWalkChecker,)
