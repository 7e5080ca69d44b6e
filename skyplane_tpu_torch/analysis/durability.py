"""Durability checker: torn-state hazards in journal/snapshot landings.

One rule, one bug class — the one the always-on service must never ship
(docs/service-mode.md): an ``os.replace``/``os.rename`` that "atomically"
lands a journal, snapshot, WAL, or state file without fsyncing BOTH the
staged file and the parent directory. The rename is atomic against
concurrent readers, not against power loss: un-fsynced file bytes can still
be write-back cache when the rename lands (a zero-length "snapshot" after a
crash), and an un-fsynced directory can forget the rename entirely. When the
caller then truncates the journal the snapshot supposedly replaced, a badly
timed crash loses both.

The sanctioned fix is :func:`skyplane_tpu_torch.utils.fsio.fsync_replace` (fsync
file → replace → fsync dir); inline ``os.fsync`` pairs also count.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set, Tuple

from skyplane_tpu_torch.analysis.concurrency import dotted_name
from skyplane_tpu_torch.analysis.core import Checker, Finding, ModuleInfo, RuleSpec

#: name fragments that mark a path as DURABLE STATE (vs. scratch/log/output
#: files, whose loss is inconvenient rather than incorrect)
_DURABLE_FRAGMENTS = ("journal", "snap", "wal", "state", "manifest", "index")

_RENAME_CALLS = {"os.replace", "os.rename"}


def _arg_smells_durable(node: ast.AST) -> bool:
    """True when any Name/Attribute terminal or string literal anywhere in
    the argument expression carries a durable-state fragment — catches
    ``self._snap_path``, ``journal_path``, ``p.with_name("jobs.wal")`` and
    friends without needing to evaluate the path."""
    for sub in ast.walk(node):
        text = ""
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            text = sub.value
        elif isinstance(sub, (ast.Name, ast.Attribute)):
            text = dotted_name(sub).split(".")[-1]
        if text and any(frag in text.lower() for frag in _DURABLE_FRAGMENTS):
            return True
    return False


def _fsync_evidence(scope: ast.AST) -> int:
    """Count fsync evidence in one function scope: ``os.fsync(...)`` calls
    plus calls to any helper whose name contains ``fsync`` (``fsync_dir``,
    ``fsync_replace``, a method named ``_fsync_parent`` ...). Two pieces of
    evidence ≈ file + directory; the helper counts double because it does
    both by construction."""
    n = 0
    for sub in ast.walk(scope):
        if not isinstance(sub, ast.Call):
            continue
        name = dotted_name(sub.func)
        terminal = name.split(".")[-1].lower()
        if name == "os.fsync":
            n += 1
        elif "fsync" in terminal:
            n += 2  # a named helper owns the full discipline
    return n


class UnsyncedDurableWriteChecker(Checker):
    """unsynced-durable-write: ``os.replace``/``os.rename`` onto (or from) a
    journal/snapshot/WAL/state/manifest/index path with fewer than two pieces
    of fsync evidence in the enclosing function. Fix with
    ``utils.fsio.fsync_replace`` (preferred) or inline fsyncs of the staged
    file AND the parent directory; a path that is genuinely non-durable
    despite its name takes a justified ``# sklint: disable`` per policy."""

    rules = (
        RuleSpec(
            "unsynced-durable-write",
            "error",
            "os.replace/os.rename of a journal/snapshot/state file without fsync of file and parent dir in the enclosing function",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        # innermost-first scope walk so a nested def owns its body's calls
        scopes: List[ast.AST] = [
            n for n in ast.walk(module.tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        scopes.append(module.tree)
        claimed: Set[Tuple[int, int]] = set()
        for scope in scopes:
            calls = []
            for sub in self._walk_scope_body(scope):
                if not isinstance(sub, ast.Call):
                    continue
                if dotted_name(sub.func) not in _RENAME_CALLS:
                    continue
                key = (sub.lineno, sub.col_offset)
                if key in claimed:
                    continue  # already attributed to an inner function
                claimed.add(key)
                calls.append(sub)
            if not calls:
                continue
            evidence = _fsync_evidence(scope)
            for call in calls:
                if not any(_arg_smells_durable(a) for a in call.args):
                    continue
                if evidence >= 2:
                    continue
                yield self.finding(
                    module,
                    "unsynced-durable-write",
                    call,
                    "durable-state replace without the fsync pair (staged file + parent dir) — "
                    "use utils.fsio.fsync_replace, or fsync both inline",
                )

    @staticmethod
    def _walk_scope_body(scope: ast.AST) -> Iterator[ast.AST]:
        """Walk a scope without descending into nested function/class defs
        (their bodies get their own scope pass)."""
        body = scope.body if hasattr(scope, "body") else []
        stack: List[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))


DURABILITY_CHECKERS: Tuple[type, ...] = (UnsyncedDurableWriteChecker,)
