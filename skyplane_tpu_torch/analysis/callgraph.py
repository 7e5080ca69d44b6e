"""Intra-project call graph for whole-program analyses (the lock-order pass).

The per-statement checkers in ``concurrency.py`` see one function at a time;
deadlock-shaped bugs live in the *composition*: method A takes lock X then
calls method B which takes lock Y, while a peer path nests them the other way
round. This module builds the call edges those analyses propagate over.

Resolution is deliberately heuristic (static Python has no sound receiver
types) and biased the same way as every checker here: over-approximate, let a
false edge cost one justified suppression downstream. A call site resolves to
at most ONE declaration, in this order:

  * ``self.meth()`` / ``cls.meth()`` — the enclosing class, then its bases by
    name (project-wide class registry).
  * ``self.attr.meth()`` — the receiver type recorded for ``self.attr``
    (``self.attr = ClassName(...)`` anywhere in the class, or an
    ``attr: ClassName`` annotation).
  * ``var.meth()`` — the local receiver type (``var = ClassName(...)`` in the
    same function, or a ``var: ClassName`` parameter annotation).
  * ``ClassName.meth()`` — explicit class receiver.
  * ``func()`` — a module-level function in the same module, else (via
    from-imports or uniqueness) the single project-wide function of that name.
  * ``obj.meth()`` with an unknown receiver — the method IF exactly one class
    in the project defines that name (unambiguous by construction); otherwise
    unresolved, and the analysis simply loses that edge.

``ClassName(...)`` constructor calls resolve to ``__init__``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from skyplane_tpu_torch.analysis.concurrency import dotted_name
from skyplane_tpu_torch.analysis.core import ModuleInfo


@dataclass
class FunctionDecl:
    """One function/method declaration, uniquely keyed by ``qualname``."""

    qualname: str  # "<path>::Class.meth" / "<path>::func"
    name: str
    cls: Optional[str]  # owning class name, None for module-level
    module: ModuleInfo
    node: ast.AST  # FunctionDef | AsyncFunctionDef

    @property
    def display(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


@dataclass
class ClassDecl:
    name: str
    module: ModuleInfo
    node: ast.ClassDef
    methods: Dict[str, FunctionDecl] = field(default_factory=dict)
    attr_types: Dict[str, str] = field(default_factory=dict)  # self.attr -> class name
    bases: Tuple[str, ...] = ()


def _iter_functions(tree: ast.Module) -> Iterator[Tuple[Optional[ast.ClassDef], ast.AST]]:
    """(owning class | None, function node) for every def in the module.
    Nested defs are attributed to their enclosing top-level def's owner."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield node, item


class ProjectIndex:
    """Declarations across every module handed to the project pass."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = list(modules)
        self.classes: Dict[str, List[ClassDecl]] = {}
        self.functions: Dict[str, FunctionDecl] = {}  # by qualname
        self.module_functions: Dict[Tuple[str, str], FunctionDecl] = {}
        self.functions_by_name: Dict[str, List[FunctionDecl]] = {}
        self.methods_by_name: Dict[str, List[FunctionDecl]] = {}
        for module in self.modules:
            self._index_module(module)

    def _index_module(self, module: ModuleInfo) -> None:
        for cls_node, fn in _iter_functions(module.tree):
            cls_name = cls_node.name if cls_node is not None else None
            qual = f"{module.path}::{cls_name + '.' if cls_name else ''}{fn.name}"
            decl = FunctionDecl(qualname=qual, name=fn.name, cls=cls_name, module=module, node=fn)
            self.functions[qual] = decl
            if cls_name is None:
                self.module_functions[(module.path, fn.name)] = decl
                self.functions_by_name.setdefault(fn.name, []).append(decl)
            else:
                self.methods_by_name.setdefault(fn.name, []).append(decl)
        for node in module.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            decl = ClassDecl(
                name=node.name,
                module=module,
                node=node,
                bases=tuple(dotted_name(b).split(".")[-1] for b in node.bases),
            )
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    decl.methods[item.name] = self.functions[f"{module.path}::{node.name}.{item.name}"]
            decl.attr_types = self._attr_types(node)
            self.classes.setdefault(node.name, []).append(decl)

    def _attr_types(self, cls: ast.ClassDef) -> Dict[str, str]:
        """``self.attr -> ClassName`` from constructor-call assignments and
        annotations anywhere in the class body."""
        types: Dict[str, str] = {}
        for node in ast.walk(cls):
            if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Attribute):
                tgt = node.target
                if isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
                    ann = dotted_name(node.annotation).split(".")[-1]
                    if ann:
                        types[tgt.attr] = ann
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                factory = dotted_name(node.value.func).split(".")[-1]
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and factory
                        and factory[:1].isupper()  # class-looking constructor only
                    ):
                        types.setdefault(tgt.attr, factory)
        return types

    # ---- class helpers ----

    def class_named(self, name: str) -> Optional[ClassDecl]:
        decls = self.classes.get(name)
        return decls[0] if decls else None

    def method_of(self, cls_name: str, meth: str, _depth: int = 0) -> Optional[FunctionDecl]:
        """Lookup in the class, then its bases by name (bounded walk)."""
        if _depth > 6:
            return None
        cls = self.class_named(cls_name)
        if cls is None:
            return None
        if meth in cls.methods:
            return cls.methods[meth]
        for base in cls.bases:
            if base != cls_name:
                hit = self.method_of(base, meth, _depth + 1)
                if hit is not None:
                    return hit
        return None


def local_receiver_types(fn: ast.AST) -> Dict[str, str]:
    """``var -> ClassName`` for a function scope: constructor-call
    assignments plus parameter annotations (terminal names only)."""
    types: Dict[str, str] = {}
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            if a.annotation is not None:
                ann = dotted_name(a.annotation).split(".")[-1]
                if ann and ann[:1].isupper():
                    types[a.arg] = ann
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            factory = dotted_name(node.value.func).split(".")[-1]
            if factory and factory[:1].isupper():
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        types.setdefault(tgt.id, factory)
    return types


class CallGraph:
    """Call-site resolution over a :class:`ProjectIndex`."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self._local_types: Dict[str, Dict[str, str]] = {}  # per function qualname

    def _locals_for(self, ctx: FunctionDecl) -> Dict[str, str]:
        cached = self._local_types.get(ctx.qualname)
        if cached is None:
            cached = local_receiver_types(ctx.node)
            self._local_types[ctx.qualname] = cached
        return cached

    def resolve(self, call: ast.Call, ctx: FunctionDecl) -> Optional[FunctionDecl]:
        func = call.func
        index = self.index
        if isinstance(func, ast.Name):
            name = func.id
            hit = index.module_functions.get((ctx.module.path, name))
            if hit is not None and hit.qualname != ctx.qualname:
                return hit
            cls = index.class_named(name)
            if cls is not None:  # ClassName(...) -> __init__
                return cls.methods.get("__init__")
            decls = index.functions_by_name.get(name, [])
            if len(decls) == 1 and decls[0].qualname != ctx.qualname:
                return decls[0]
            return None
        if not isinstance(func, ast.Attribute):
            return None
        meth = func.attr
        recv = func.value
        # self.meth() / cls.meth()
        if isinstance(recv, ast.Name) and recv.id in ("self", "cls") and ctx.cls:
            return index.method_of(ctx.cls, meth)
        # self.attr.meth()
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and ctx.cls
        ):
            owner = index.class_named(ctx.cls)
            if owner is not None:
                attr_cls = owner.attr_types.get(recv.attr)
                if attr_cls:
                    return index.method_of(attr_cls, meth)
            return self._unique_method(meth)
        if isinstance(recv, ast.Name):
            # explicit class receiver: ClassName.meth()
            if index.class_named(recv.id) is not None:
                return index.method_of(recv.id, meth)
            # local receiver with an inferred type
            local_cls = self._locals_for(ctx).get(recv.id)
            if local_cls:
                hit = index.method_of(local_cls, meth)
                if hit is not None:
                    return hit
            return self._unique_method(meth)
        return self._unique_method(meth)

    def _unique_method(self, meth: str) -> Optional[FunctionDecl]:
        """Unknown receiver: resolve IFF exactly one project class defines the
        method (dunders and trivially-common names never qualify)."""
        if meth.startswith("__") or meth in _COMMON_METHOD_NAMES:
            return None
        decls = self.index.methods_by_name.get(meth, [])
        return decls[0] if len(decls) == 1 else None


#: method names too generic to resolve by uniqueness — a one-class accident
#: of naming must not wire half the project into that class
_COMMON_METHOD_NAMES = {
    "get",
    "put",
    "pop",
    "add",
    "append",
    "close",
    "start",
    "stop",
    "run",
    "join",
    "send",
    "recv",
    "read",
    "write",
    "update",
    "items",
    "keys",
    "values",
    "acquire",
    "release",
    "wait",
    "notify",
    "notify_all",
    "submit",
    "flush",
    "clear",
    "copy",
    "register",
}
