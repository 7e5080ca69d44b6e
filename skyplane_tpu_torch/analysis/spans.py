"""Span-safety checker: no blocking I/O on the tracer's record path.

The chunk-lifecycle tracer (skyplane_tpu_torch/obs/tracer.py) promises near-zero
overhead: span *record* is a tuple store into a per-thread ring buffer — no
locks, no syscalls. The overhead-regression bug class this rule guards
against is someone "improving" the tracer (or a span-record callback wired
into it) with socket or disk I/O: a flush-to-file in ``__exit__``, a metrics
push in ``record()``, a log write while a ring-buffer slot is held. Any of
those turns every instrumented hot-path operation into a blocking syscall
and silently costs the <2% disabled/enabled overhead budget the bench gates
(scripts/check_bench_json.py ``trace_overhead_pct``).

Scope — a function is "on the span-record path" when it is:

  * a method of a class whose name contains ``Span``, ``Tracer``, or
    ``Ring`` (the tracer machinery itself, including ``__enter__``/
    ``__exit__`` of span context managers), or
  * named like a span-record callback: ``record``, ``record_span``,
    ``on_span``, ``on_span_start``, ``on_span_end``.

Additionally, any statement lexically inside a ``with`` whose context
expression acquires a tracer ring-buffer slot (a call whose dotted name ends
in ``slot``/``acquire_slot`` or mentions ``ring``) is in scope — holding a
slot while blocking starves every later span on that ring.

Flagged calls: ``open()``, ``time.sleep``, ``os.read/write/replace/fsync``,
socket verbs (``send``/``sendall``/``recv``/``recv_into``/``accept``/
``connect``), and Path-style file I/O (``read_bytes``/``write_bytes``/
``read_text``/``write_text``/``flush``/``fsync``).

Instrumenting I/O from the OUTSIDE — ``with tracer.span(...): sock.sendall``
— is the intended use and is NOT in scope: the span merely times the I/O;
the record itself still happens after the body completes.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set, Tuple

from skyplane_tpu_torch.analysis.concurrency import dotted_name
from skyplane_tpu_torch.analysis.core import Checker, Finding, ModuleInfo, RuleSpec
from skyplane_tpu_torch.analysis.tracer import canonical_name, import_aliases

_SPAN_CLASS_MARKERS = ("Span", "Tracer", "Ring")
_CALLBACK_NAMES = {"record", "record_span", "on_span", "on_span_start", "on_span_end"}
_IO_EXACT = {"open"}
_IO_PREFIXES = ("time.sleep", "os.read", "os.write", "os.replace", "os.fsync", "os.pwrite", "os.pread")
_IO_ATTRS = {
    "send",
    "sendall",
    "sendto",
    "recv",
    "recv_into",
    "recvfrom",
    "accept",
    "connect",
    "read_bytes",
    "write_bytes",
    "read_text",
    "write_text",
    "flush",
    "fsync",
}


def _slot_acquiring(expr: ast.AST) -> bool:
    """True when a with-item's context expression acquires a ring-buffer
    slot: ``ring.slot()``, ``buf.acquire_slot()``, ``self._ring.slot()``."""
    if not isinstance(expr, ast.Call):
        return False
    name = dotted_name(expr.func)
    if not name:
        return False
    last = name.rsplit(".", 1)[-1]
    return last in ("slot", "acquire_slot") and ("ring" in name.lower() or last == "acquire_slot")


class SpanIOChecker(Checker):
    rules = (
        RuleSpec(
            "blocking-io-in-span",
            "error",
            "socket/disk I/O inside a span-record callback or while holding a tracer ring-buffer slot",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        aliases = import_aliases(module.tree)
        for fn, why in self._record_path_functions(module.tree):
            # nested function defs get their own scope decision; don't walk
            # into them from the parent (a helper defined inside a Tracer
            # method is flagged via its own class/name, not by lexical luck)
            for node in self._walk_shallow(fn):
                hit = self._io_call(node, aliases)
                if hit:
                    yield self.finding(
                        module,
                        "blocking-io-in-span",
                        node,
                        f"{hit} inside {why} — span record must stay syscall-free "
                        "(flush/export off the hot path instead)",
                    )
        for holder in self._slot_with_blocks(module.tree):
            for node in ast.walk(holder):
                hit = self._io_call(node, aliases)
                if hit:
                    yield self.finding(
                        module,
                        "blocking-io-in-span",
                        node,
                        f"{hit} while holding a tracer ring-buffer slot — blocking here starves "
                        "every later span on this ring",
                    )

    # ---- scope discovery ----

    @staticmethod
    def _record_path_functions(tree: ast.Module) -> List[Tuple[ast.FunctionDef, str]]:
        out: List[Tuple[ast.FunctionDef, str]] = []
        span_methods: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and any(m in node.name for m in _SPAN_CLASS_MARKERS):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        span_methods.add(id(item))
                        out.append((item, f"span/tracer method {node.name}.{item.name}"))
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and id(node) not in span_methods and node.name in _CALLBACK_NAMES:
                out.append((node, f"span-record callback {node.name!r}"))
        return out

    @staticmethod
    def _walk_shallow(fn: ast.FunctionDef) -> Iterator[ast.AST]:
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested scope judged on its own merits
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _slot_with_blocks(tree: ast.Module) -> List[ast.With]:
        return [
            node
            for node in ast.walk(tree)
            if isinstance(node, ast.With) and any(_slot_acquiring(item.context_expr) for item in node.items)
        ]

    # ---- I/O detection ----

    @staticmethod
    def _io_call(node: ast.AST, aliases) -> str:
        if not isinstance(node, ast.Call):
            return ""
        name = canonical_name(node.func, aliases)
        if name in _IO_EXACT:
            return f"{name}()"
        if any(name == p or name.startswith(p + ".") for p in _IO_PREFIXES):
            return f"{name}()"
        if isinstance(node.func, ast.Attribute) and node.func.attr in _IO_ATTRS:
            return f".{node.func.attr}()"
        return ""


SPAN_CHECKERS: Tuple[type, ...] = (SpanIOChecker,)
