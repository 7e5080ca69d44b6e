"""IPC-safety checker: objects that must never cross a process boundary.

``unsafe-object-over-ipc`` — the multi-process pump (gateway/pump.py) moves
work between the daemon and its spawn-context workers through explicit
channels. Anything placed on a ``multiprocessing`` queue or pipe is pickled
into ANOTHER PROCESS, where a ``threading.Lock``/``Condition`` loses its
waiters, a ``Thread`` object is a corpse, a socket silently duplicates
kernel state outside the deliberate ``send_fds`` path, and the tracer/
profiler/recorder singletons fork into divergent copies whose counters
never merge back. Every one of these pickles without complaint (or raises
only at runtime on the consumer side) — exactly the bug class a reader
cannot see in a diff, so the linter owns it.

Scope: argument payloads of ``.put()``/``.put_nowait()``/``.send()`` on
receivers this module can statically tie to ``multiprocessing`` queues or
pipe connections (including via a ``get_context(...)`` context object).
Deliberate fd passing (``socket.send_fds`` on an AF_UNIX channel — what the
pump does) is NOT in scope: that is the sanctioned way to move a socket.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Set, Tuple

from skyplane_tpu_torch.analysis.core import Checker, Finding, ModuleInfo, RuleSpec
from skyplane_tpu_torch.analysis.concurrency import dotted_name

#: multiprocessing channel factories (bare, mp-qualified, or ctx-qualified)
_MP_QUEUE_FACTORIES = {"Queue", "SimpleQueue", "JoinableQueue"}
_MP_MODULE_NAMES = {"multiprocessing", "mp"}

#: constructors whose instances must never ride an mp channel
_UNSAFE_FACTORIES: Dict[str, str] = {
    "Lock": "a threading lock has per-process waiter state",
    "RLock": "a threading lock has per-process owner state",
    "Condition": "a Condition's waiters exist only in this process",
    "Semaphore": "a threading semaphore has per-process waiter state",
    "BoundedSemaphore": "a threading semaphore has per-process waiter state",
    "Event": "a threading.Event set in one process is invisible in the other",
    "Barrier": "a threading.Barrier's parties exist only in this process",
    "Thread": "a Thread object is meaningless in another process",
    "socket": "sockets cross processes via socket.send_fds, never via pickle",
    "socketpair": "sockets cross processes via socket.send_fds, never via pickle",
    "wrap_socket": "TLS sockets hold in-process OpenSSL state",
}

#: singleton getters whose results are per-process observability surfaces
_SINGLETON_GETTERS = {"get_tracer", "get_profiler", "get_recorder", "get_registry", "get_injector"}


def _factory_of(call: ast.Call) -> str:
    return dotted_name(call.func).split(".")[-1]


def _is_mp_qualified(name: str) -> bool:
    """True for multiprocessing.Queue / mp.Queue / SPAWN_CTX.Queue-style
    prefixes; False for thread-land ``queue.Queue`` / ``asyncio.Queue``."""
    parts = name.split(".")
    if len(parts) < 2:
        return False
    prefix = parts[0]
    return prefix in _MP_MODULE_NAMES or "ctx" in prefix.lower()


class _ModuleIndex:
    """One pass over the module: which names/attrs are mp channels, pipe
    connection endpoints, or unsafe payload objects."""

    def __init__(self, tree: ast.Module):
        self.mp_channels: Set[str] = set()  # names/self-attrs bound to mp queues
        self.pipe_ends: Set[str] = set()  # names bound from Pipe() unpacking
        self.unsafe: Dict[str, str] = {}  # name/self-attr -> why it is unsafe
        self.imports_mp = False
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mod = getattr(node, "module", None) or ""
                names = [a.name for a in node.names]
                if mod.startswith("multiprocessing") or any(n.split(".")[0] == "multiprocessing" for n in names):
                    self.imports_mp = True
            elif isinstance(node, ast.Assign):
                self._index_assign(node)

    def _targets(self, node: ast.Assign):
        for tgt in node.targets:
            name = dotted_name(tgt)
            if name:
                yield name

    def _index_assign(self, node: ast.Assign) -> None:
        value = node.value
        if isinstance(value, ast.Call):
            name = dotted_name(value.func)
            factory = _factory_of(value)
            if factory in _MP_QUEUE_FACTORIES and _is_mp_qualified(name):
                for tgt in self._targets(node):
                    self.mp_channels.add(tgt)
            elif factory == "Pipe":
                # a, b = mp.Pipe(): both ends are connections with .send()
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Tuple, ast.List)):
                        for el in tgt.elts:
                            n = dotted_name(el)
                            if n:
                                self.pipe_ends.add(n)
                    else:
                        n = dotted_name(tgt)
                        if n:
                            self.pipe_ends.add(n)
            elif factory in _UNSAFE_FACTORIES:
                for tgt in self._targets(node):
                    self.unsafe[tgt] = _UNSAFE_FACTORIES[factory]
            elif factory in _SINGLETON_GETTERS:
                for tgt in self._targets(node):
                    self.unsafe[tgt] = f"{factory}() returns this process's singleton"


class UnsafeObjectOverIpcChecker(Checker):
    """unsafe-object-over-ipc: a lock, socket, Thread/Condition, or a
    tracer/profiler singleton placed on a multiprocessing queue/pipe. These
    objects encode per-process state; pickling them into a pump worker (or
    any mp child) yields a divergent copy at best and a runtime crash at
    worst. Move data (dicts, chunk descriptors) and pass sockets only via
    the explicit ``socket.send_fds`` channel (gateway/pump.py CtrlChannel)."""

    rules = (
        RuleSpec(
            "unsafe-object-over-ipc",
            "error",
            "lock/socket/Thread/Condition or tracer-profiler singleton sent through a multiprocessing queue/pipe",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        index = _ModuleIndex(module.tree)
        if not (index.mp_channels or index.pipe_ends or index.imports_mp):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            method = node.func.attr
            if method not in ("put", "put_nowait", "send"):
                continue
            recv = dotted_name(node.func.value)
            if not self._is_mp_receiver(recv, method, index):
                continue
            for arg in node.args:
                for payload, why in self._unsafe_payloads(arg, index):
                    yield self.finding(
                        module,
                        "unsafe-object-over-ipc",
                        node,
                        f"{recv}.{method}() ships {payload} across a process boundary — {why}",
                    )

    @staticmethod
    def _is_mp_receiver(recv: str, method: str, index: _ModuleIndex) -> bool:
        if not recv:
            return False
        if recv in index.mp_channels:
            return True
        # .send() exists on sockets and many protocols; only pipe ends count
        if method == "send":
            return recv in index.pipe_ends
        # .put() on a name this module never tied to an mp queue: only treat
        # it as an mp channel when the identifier says so AND the module
        # actually uses multiprocessing (keeps thread-queue code out of scope)
        terminal = recv.split(".")[-1].lower()
        return index.imports_mp and ("mp_" in terminal or terminal.endswith("_mpq"))

    @staticmethod
    def _unsafe_payloads(arg: ast.AST, index: _ModuleIndex) -> Iterator[Tuple[str, str]]:
        """Yield (display, why) for unsafe objects in one argument expression
        (looking through tuple/list/dict displays — shipping a lock inside a
        tuple is the same bug)."""
        stack = [arg]
        while stack:
            expr = stack.pop()
            if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
                stack.extend(expr.elts)
                continue
            if isinstance(expr, ast.Dict):
                stack.extend(v for v in expr.values if v is not None)
                continue
            if isinstance(expr, ast.Call):
                factory = _factory_of(expr)
                if factory in _UNSAFE_FACTORIES:
                    yield f"{dotted_name(expr.func)}(...)", _UNSAFE_FACTORIES[factory]
                elif factory in _SINGLETON_GETTERS:
                    yield f"{factory}()", f"{factory}() returns this process's singleton"
                continue
            name = dotted_name(expr)
            if name and name in index.unsafe:
                yield name, index.unsafe[name]


IPC_CHECKERS: Tuple[type, ...] = (UnsafeObjectOverIpcChecker,)
