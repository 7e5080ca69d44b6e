"""Tracer-safety checkers: side effects and overflow hazards in code that is
traced once and then replayed.

Three forms run a Python body ONCE and replay what it recorded:

  * ``@jax.jit`` (recognised exactly as the JAX package's lint does, so the
    two lints agree on JAX sources);
  * ``torch.jit.trace(fn, example)``, which records the tensor operations of
    one call: ``time.time()`` becomes a constant, ``print`` fires once, and
    ``.item()`` / ``float()`` bake one value into the trace;
  * CUDA graph capture — ``torch.cuda.make_graphed_callables(fn, args)`` and
    the body of ``with torch.cuda.graph(g):`` — where a replay re-launches the
    captured kernels only, and ``.item()`` / ``float()`` on a device tensor
    synchronises the device, which raises during capture.

``torch.compile`` is deliberately NOT one of them: Dynamo breaks the graph at
``print`` and ``time.time()`` and keeps the side effects, so every finding
there would be false.

The u32 checker enforces the ``ops/u32.py`` contract. The port's plain
versions carry M31 arithmetic in int64 tensors, reduced by ``fold31``; an
operand is overflow-safe only after an explicit int64 cast
(``p = p.to(torch.int64)``, ``p = p.long()``, ``p = p.astype(np.int64)``),
or the JAX package's ``jnp.uint32`` cast, which the checker also accepts.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

from skyplane_tpu_torch.analysis.core import Checker, Finding, ModuleInfo, RuleSpec
from skyplane_tpu_torch.analysis.concurrency import dotted_name

# matched AFTER import-alias canonicalization (np -> numpy, t -> time, ...)
_IMPURE_EXACT = {"print", "input", "breakpoint", "open"}
_IMPURE_PREFIXES = ("time.", "np.random.", "numpy.random.", "random.", "os.")
_MUTATORS = {"append", "extend", "add", "update", "insert", "setdefault", "pop", "remove", "clear", "put"}

# the torch forms, matched on canonical names (so ``from torch.jit import
# trace`` and ``import torch as th`` cannot dodge them)
_TORCH_TRACE = {"torch.jit.trace"}
_TORCH_GRAPHED = {"torch.cuda.make_graphed_callables", "torch.cuda.graphs.make_graphed_callables"}
_TORCH_GRAPH_BLOCK = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

JAX_JIT = "jax.jit"
TORCH_TRACE = "torch.jit.trace"
TORCH_GRAPHED = "torch.cuda.make_graphed_callables"
TORCH_GRAPH_BLOCK = "torch.cuda.graph"

#: per construct: where the finding is, when the body ran, and what an
#: impure call / a host sync does there. The jax.jit texts are the JAX
#: package's messages, unchanged.
_TEXTS = {
    JAX_JIT: {
        "where": "jit function {name!r}",
        "when": "trace time",
        "impure": "is baked into the trace as a constant/one-shot",
        "item": "concretizes a tracer (crash) or forces a device sync",
        "cast": "raises ConcretizationTypeError under jit",
    },
    TORCH_TRACE: {
        "where": "function {name!r} traced by torch.jit.trace",
        "when": "trace time",
        "impure": "is baked into the trace as a constant/one-shot",
        "item": "bakes one call's value into the trace as a constant",
        "cast": "bakes one call's value into the trace as a constant",
    },
    TORCH_GRAPHED: {
        "where": "function {name!r} graphed by torch.cuda.make_graphed_callables",
        "when": "capture time",
        "impure": "runs once at capture; graph replays skip it",
        "item": "synchronises the device, which raises during CUDA graph capture",
        "cast": "synchronises the device, which raises during CUDA graph capture",
    },
    TORCH_GRAPH_BLOCK: {
        "where": "the torch.cuda.graph capture block at line {line}",
        "when": "capture time",
        "impure": "runs once at capture; graph replays skip it",
        "item": "synchronises the device, which raises during CUDA graph capture",
        "cast": "synchronises the device, which raises during CUDA graph capture",
    },
}


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """alias -> canonical module path, so ``import time as t`` cannot dodge
    the impure-call match (and ``import jax.numpy as jnp`` canonicalizes to
    the jax.* allowlist instead of relying on the conventional alias)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def canonical_name(node: ast.AST, aliases: Dict[str, str]) -> str:
    """dotted_name with the leading segment resolved through import aliases."""
    name = dotted_name(node)
    if not name:
        return ""
    head, _, rest = name.partition(".")
    resolved = aliases.get(head, head)
    return f"{resolved}.{rest}" if rest else resolved


def _decorator_is_jit(dec: ast.AST) -> Tuple[bool, Tuple[str, ...]]:
    """(is_jit, static_argnames) for one decorator node."""
    name = dotted_name(dec)
    if name in ("jax.jit", "jit"):
        return True, ()
    if isinstance(dec, ast.Call):
        fname = dotted_name(dec.func)
        if fname in ("jax.jit", "jit"):
            return True, _static_argnames(dec)
        if fname in ("partial", "functools.partial") and dec.args:
            inner = dotted_name(dec.args[0])
            if inner in ("jax.jit", "jit"):
                return True, _static_argnames(dec)
    return False, ()


def _torch_construct(name: str) -> Optional[str]:
    if name in _TORCH_TRACE:
        return TORCH_TRACE
    if name in _TORCH_GRAPHED:
        return TORCH_GRAPHED
    return None


def _static_argnames(call: ast.Call) -> Tuple[str, ...]:
    for kw in call.keywords:
        if kw.arg in ("static_argnames", "static_argnums") and isinstance(kw.value, (ast.Tuple, ast.List)):
            return tuple(e.value for e in kw.value.elts if isinstance(e, ast.Constant) and isinstance(e.value, str))
        if kw.arg == "static_argnames" and isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str):
            return (kw.value.value,)
    return ()


def find_jit_functions(tree: ast.Module) -> List[Tuple[ast.FunctionDef, Tuple[str, ...]]]:
    """All functions traced by jax.jit: decorated directly, via partial, or
    defined locally and later passed to a ``jax.jit(...)`` call."""
    out: List[Tuple[ast.FunctionDef, Tuple[str, ...]]] = []
    wrapped: Dict[str, Tuple[str, ...]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and dotted_name(node.func) in ("jax.jit", "jit"):
            if node.args and isinstance(node.args[0], ast.Name):
                wrapped[node.args[0].id] = _static_argnames(node)
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            is_jit, statics = _decorator_is_jit(dec)
            if is_jit:
                out.append((node, statics))
                break
        else:
            if node.name in wrapped:
                out.append((node, wrapped[node.name]))
    return out


def find_torch_forms(tree: ast.Module, aliases: Dict[str, str]) -> Tuple[List[Tuple[ast.FunctionDef, str]], List[ast.With]]:
    """In one walk: the functions traced by ``torch.jit.trace`` or graphed by
    ``torch.cuda.make_graphed_callables`` (passed by name, alone or in a
    tuple of callables, as the call's first argument), and the ``with
    torch.cuda.graph(...)`` blocks."""
    wrapped: Dict[str, str] = {}
    fns: List[ast.FunctionDef] = []
    blocks: List[ast.With] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            fns.append(node)
        elif isinstance(node, ast.With):
            if any(
                isinstance(item.context_expr, ast.Call)
                and canonical_name(item.context_expr.func, aliases) in _TORCH_GRAPH_BLOCK
                for item in node.items
            ):
                blocks.append(node)
        elif isinstance(node, ast.Call) and node.args:
            construct = _torch_construct(canonical_name(node.func, aliases))
            if construct is None:
                continue
            first = node.args[0]
            for elt in first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]:
                if isinstance(elt, ast.Name):
                    wrapped.setdefault(elt.id, construct)
    return [(fn, wrapped[fn.name]) for fn in fns if fn.name in wrapped], blocks


def _param_names(fn: ast.FunctionDef) -> Set[str]:
    args = fn.args
    return {a.arg for a in (*args.posonlyargs, *args.args, *args.kwonlyargs)}


def _int_annotated(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for a in (*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs):
        if a.annotation is not None and dotted_name(a.annotation) in ("int", "bool"):
            out.add(a.arg)
    return out


@dataclass
class TracedRegion:
    """Code whose Python body runs once and is then replayed: a function
    (jax.jit, torch.jit.trace, make_graphed_callables) or the body of a
    ``with torch.cuda.graph(...)`` block."""

    node: ast.AST  # the FunctionDef, or the With
    construct: str
    traced: Set[str]  # names that hold tracers / device tensors there

    def text(self, key: str) -> str:
        template = _TEXTS[self.construct][key]
        return template.format(name=getattr(self.node, "name", ""), line=getattr(self.node, "lineno", 0))


def _names_assigned(stmts: List[ast.stmt]) -> Set[str]:
    return {
        sub.id
        for stmt in stmts
        for sub in ast.walk(stmt)
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store)
    }


def find_traced_regions(tree: ast.Module, aliases: Optional[Dict[str, str]] = None) -> List[TracedRegion]:
    """Every traced region of a module: the jax.jit functions first, in the
    JAX package's order, then the torch functions, then the capture blocks.
    A function both forms reach is listed once, under its first form."""
    aliases = import_aliases(tree) if aliases is None else aliases
    regions: List[TracedRegion] = []
    seen: Set[int] = set()
    for fn, statics in find_jit_functions(tree):
        seen.add(id(fn))
        regions.append(TracedRegion(fn, JAX_JIT, _param_names(fn) - set(statics) - _int_annotated(fn)))
    functions, blocks = find_torch_forms(tree, aliases)
    for fn, construct in functions:
        if id(fn) not in seen:
            regions.append(TracedRegion(fn, construct, _param_names(fn) - _int_annotated(fn)))
    if blocks:
        regions.extend(_capture_blocks(tree, blocks))
    return regions


def _capture_blocks(tree: ast.Module, blocks: List[ast.With]) -> List[TracedRegion]:
    """The capture blocks as regions, in source order. The enclosing
    function's parameters and the names the block binds hold device tensors
    there."""
    wanted = {id(b) for b in blocks}
    out: List[TracedRegion] = []
    stack: List[Tuple[ast.AST, Optional[ast.FunctionDef]]] = [(tree, None)]
    while stack:
        node, fn = stack.pop()
        if id(node) in wanted:
            params = _param_names(fn) - _int_annotated(fn) if fn is not None else set()
            out.append(TracedRegion(node, TORCH_GRAPH_BLOCK, params | _names_assigned(node.body)))
        for child in ast.iter_child_nodes(node):
            stack.append((child, child if isinstance(child, ast.FunctionDef) else fn))
    out.sort(key=lambda r: (r.node.lineno, r.node.col_offset))
    return out


class JitPurityChecker(Checker):
    """jit-impure-call / jit-attr-mutation: Python side effects inside traced
    or captured code run once at trace or capture time, not per call."""

    rules = (
        RuleSpec(
            "jit-impure-call",
            "error",
            "impure host call (time/np.random/print/os/...) inside code traced once and replayed "
            "(jax.jit, torch.jit.trace, CUDA graph capture)",
        ),
        RuleSpec(
            "jit-attr-mutation",
            "error",
            "attribute/container mutation inside traced or graph-captured code happens at trace/capture time only",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        aliases = import_aliases(module.tree)
        for region in find_traced_regions(module.tree, aliases):
            where, when = region.text("where"), region.text("when")
            # nested defs inside a traced fn are traced too when called from it
            for node in ast.walk(region.node):
                if isinstance(node, ast.Call):
                    name = canonical_name(node.func, aliases)
                    if self._is_impure(name):
                        yield self.finding(
                            module,
                            "jit-impure-call",
                            node,
                            f"{name}() inside {where} {region.text('impure')}",
                        )
                    elif (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr in _MUTATORS
                        and dotted_name(node.func.value).startswith("self")
                    ):
                        yield self.finding(
                            module,
                            "jit-attr-mutation",
                            node,
                            f"self.{node.func.value.attr if isinstance(node.func.value, ast.Attribute) else '...'}."
                            f"{node.func.attr}() in {where} mutates host state at {when} only",
                        )
                for tgt in self._assign_targets(node):
                    if isinstance(tgt, ast.Attribute):
                        yield self.finding(
                            module,
                            "jit-attr-mutation",
                            node,
                            f"assignment to {dotted_name(tgt)} in {where} happens at {when} only",
                        )

    @staticmethod
    def _assign_targets(node: ast.AST) -> List[ast.AST]:
        if isinstance(node, ast.Assign):
            return list(node.targets)
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)) and getattr(node, "value", None) is not None:
            return [node.target]
        return []

    @staticmethod
    def _is_impure(name: str) -> bool:
        if not name:
            return False
        if name in _IMPURE_EXACT:
            return True
        if name.startswith(("jax.", "jnp.", "lax.")):
            return False  # jax.random etc. is trace-safe by construction (jnp/lax cover unimported-alias fixtures)
        return any(name == p.rstrip(".") or name.startswith(p) for p in _IMPURE_PREFIXES)


class JitHostSyncChecker(Checker):
    """jit-host-sync: float()/int()/bool()/.item() on a traced value — a
    ConcretizationTypeError inside jax.jit, a constant baked into a
    torch.jit.trace, a device sync that raises during CUDA graph capture."""

    rules = (
        RuleSpec(
            "jit-host-sync",
            "error",
            "float()/int()/bool()/.item() on a likely-tracer or device-tensor value inside traced or "
            "graph-captured code",
        ),
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for region in find_traced_regions(module.tree):
            where = region.text("where")
            for node in ast.walk(region.node):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Attribute) and node.func.attr == "item" and not node.args:
                    yield self.finding(module, "jit-host-sync", node, f".item() in {where} {region.text('item')}")
                    continue
                name = dotted_name(node.func)
                if name in ("float", "int", "bool") and node.args:
                    used = {n.id for n in ast.walk(node.args[0]) if isinstance(n, ast.Name)}
                    hit = used & region.traced
                    if hit:
                        yield self.finding(
                            module,
                            "jit-host-sync",
                            node,
                            f"{name}() on traced value {sorted(hit)[0]!r} in {where} {region.text('cast')}",
                        )


class U32CastChecker(Checker):
    """u32-cast-missing: in ops/ modules, a function participating in the
    M31 modular-hash contract (references M31 or calls fold31/addmod31/
    mulmod31) does +, *, or << directly on a parameter that was never cast.
    The port's contract (``ops/u32.py``) is int64 operands reduced by
    ``fold31``: the sanctioned recast is ``p = p.to(torch.int64)``,
    ``p = p.long()`` or ``p = p.astype(np.int64)``; the JAX package's
    ``p = p.astype(jnp.uint32)`` / ``p = jnp.uint32(p)`` count too. An
    uncast operand is right for the int64 a test passes and wraps on an
    int32 or uint8 tensor."""

    rules = (
        RuleSpec(
            "u32-cast-missing",
            "warning",
            "widening arithmetic (+ * <<) on a parameter with no explicit int64 (or jnp.uint32) cast "
            "in an ops/ M31-contract function",
        ),
    )

    _CONTRACT_CALLS = {"fold31", "addmod31", "mulmod31"}
    _WIDENING = (ast.Add, ast.Mult, ast.LShift)

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        if "/ops/" not in path and not path.startswith("ops/"):
            return
        for fn in [n for n in ast.walk(module.tree) if isinstance(n, ast.FunctionDef)]:
            if not self._in_contract(fn):
                continue
            params = _param_names(fn) - _int_annotated(fn)
            recast = self._recast_params(fn)
            for node in ast.walk(fn):
                if not (isinstance(node, ast.BinOp) and isinstance(node.op, self._WIDENING)):
                    continue
                for side in (node.left, node.right):
                    if isinstance(side, ast.Name) and side.id in params and side.id not in recast:
                        op = {"Add": "+", "Mult": "*", "LShift": "<<"}[type(node.op).__name__]
                        yield self.finding(
                            module,
                            "u32-cast-missing",
                            node,
                            f"parameter {side.id!r} used in `{op}` in {fn.name!r} without an explicit int64 cast "
                            f"({side.id} = {side.id}.to(torch.int64); ops/u32.py contract: int64 operands reduced "
                            "by fold31)",
                        )

    def _in_contract(self, fn: ast.FunctionDef) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and node.id == "M31":
                return True
            if isinstance(node, ast.Call) and dotted_name(node.func).split(".")[-1] in self._CONTRACT_CALLS:
                return True
        return False

    @staticmethod
    def _is_int64(arg: ast.AST) -> bool:
        if isinstance(arg, ast.Constant):
            return arg.value == "int64"
        return dotted_name(arg).split(".")[-1] in ("int64", "long")

    @classmethod
    def _recast_params(cls, fn: ast.FunctionDef) -> Set[str]:
        """Params rebound as ``p = p.to(torch.int64)`` / ``p = p.long()`` /
        ``p = p.astype(np.int64)``, or the JAX package's
        ``p = p.astype(jnp.uint32)`` / ``p = jnp.uint32(p)``."""
        out: Set[str] = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            tgt_names = {t.id for t in node.targets if isinstance(t, ast.Name)}
            call = node.value
            func = call.func
            on_target = isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name) and func.value.id in tgt_names
            if isinstance(func, ast.Attribute) and func.attr == "astype":
                args_ok = any("uint32" in dotted_name(a) or cls._is_int64(a) for a in call.args)
                if args_ok and on_target:
                    out |= tgt_names
            elif isinstance(func, ast.Attribute) and func.attr == "to":
                dtypes = [*call.args, *(kw.value for kw in call.keywords if kw.arg == "dtype")]
                if on_target and any(cls._is_int64(a) for a in dtypes):
                    out |= tgt_names
            elif isinstance(func, ast.Attribute) and func.attr == "long" and not call.args:
                if on_target:
                    out |= tgt_names
            elif dotted_name(func).endswith("uint32") and call.args:
                arg = call.args[0]
                if isinstance(arg, ast.Name) and arg.id in tgt_names:
                    out |= tgt_names
        return out


TRACER_CHECKERS: Tuple[type, ...] = (JitPurityChecker, JitHostSyncChecker, U32CastChecker)
