"""Per-function control-flow graphs for the dataflow layer (resources.py).

The other rule families are either per-statement (concurrency, tracer) or
per-call-edge (lockgraph): none can answer "does every PATH from this
acquire reach a release?" — the question behind the window double-dispatch,
the requeue GC race, and every leaked-token/leaked-fd class the chaos soaks
only catch dynamically. This module builds the path
structure those questions need:

  * one node per statement, plus synthetic ``entry`` / ``exit`` /
    ``raise_exit`` nodes (``raise_exit`` is the *uncaught-exception* way out
    of the function — a leak that only exists on that edge is exactly the
    "release belongs in a finally" class).
  * branch edges carry a kind: ``true``/``false`` out of ``if``/``while``
    tests, ``exc`` for exception flow, ``normal`` otherwise. The dataflow
    engine uses the kinds for light path sensitivity (an ``if not
    self.sched_acquire(req):`` early-requeue branch must NOT be treated as
    holding tokens).
  * ``try``/``except``/``finally``: every statement that can raise gets an
    ``exc`` edge to the innermost handler dispatch (then the handlers, then
    the ``finally``); the ``finally`` body is built once and its exits fan
    out to every continuation it can serve (fallthrough, re-raise, routed
    ``return``). That over-approximates paths — the usual deal here: a false
    path costs one justified suppression, a missed path costs a leaked fd.
  * ``with`` bodies get a synthetic ``with_cleanup`` node that both normal
    and exception exits route through — ``__exit__`` runs either way, which
    is why a ``with``-acquired resource can never leak.
  * ``return``/``break``/``continue`` route through enclosing ``finally``
    bodies before reaching their targets; ``return`` nodes are marked so the
    dataflow can treat ``return resource`` as an ownership transfer.

Statements are deemed able to raise when they contain a call (or are a
``raise``/``assert``): attribute/subscript errors exist but modelling them
would drown the signal in paths no reader believes.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: edge kinds
NORMAL = "normal"
TRUE = "true"
FALSE = "false"
EXC = "exc"


@dataclass
class CFGNode:
    idx: int
    kind: str  # "entry" | "exit" | "raise_exit" | "stmt" | "with_cleanup" | "exc_dispatch"
    stmt: Optional[ast.AST] = None  # the governing statement (test/iter/head for compounds)
    succs: List[Tuple[int, str]] = field(default_factory=list)  # (node idx, edge kind)

    @property
    def line(self) -> int:
        return getattr(self.stmt, "lineno", 0)


@dataclass
class _Frame:
    """Builder context: where exceptions, breaks, continues, and returns go."""

    exc_target: int  # node idx exceptions route to (handler dispatch / finally / raise_exit)
    break_target: Optional[int] = None
    continue_target: Optional[int] = None
    #: innermost-first finally entries a return/break must run through
    finally_entries: Tuple[int, ...] = ()


class CFG:
    """Control-flow graph of one function body. ``nodes[0]`` is ``entry``,
    ``nodes[1]`` is ``exit`` (normal return / fallthrough), ``nodes[2]`` is
    ``raise_exit`` (uncaught exception)."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.nodes: List[CFGNode] = []
        self.entry = self._new("entry")
        self.exit = self._new("exit")
        self.raise_exit = self._new("raise_exit")
        #: finally/with_cleanup entry idx -> real targets of the returns and
        #: breaks routed through it; the entry's exits get edges to exactly
        #: these (not an unconditional edge to function exit, which would
        #: invent a "falls off the end" path through every `with` block)
        self._route_targets: Dict[int, set] = {}
        self._build()

    # ---- construction ----

    def _new(self, kind: str, stmt: Optional[ast.AST] = None) -> int:
        node = CFGNode(idx=len(self.nodes), kind=kind, stmt=stmt)
        self.nodes.append(node)
        return node.idx

    def _edge(self, src: int, dst: int, kind: str = NORMAL) -> None:
        if (dst, kind) not in self.nodes[src].succs:
            self.nodes[src].succs.append((dst, kind))

    def _build(self) -> None:
        frame = _Frame(exc_target=self.raise_exit)
        body = getattr(self.fn, "body", [])
        first, exits = self._stmts(body, frame)
        self._edge(self.entry, first if first is not None else self.exit)
        for src, kind in exits:
            self._edge(src, self.exit, kind)

    def _stmts(self, stmts: Sequence[ast.stmt], frame: _Frame) -> Tuple[Optional[int], List[Tuple[int, str]]]:
        """Build a statement sequence. Returns (first node idx or None for an
        empty sequence, open exits as (node, edge kind) pairs to be wired to
        whatever follows)."""
        first: Optional[int] = None
        open_exits: List[Tuple[int, str]] = []
        for stmt in stmts:
            head, exits = self._stmt(stmt, frame)
            if head is None:
                continue
            if first is None:
                first = head
            for src, kind in open_exits:
                self._edge(src, head, kind)
            open_exits = exits
        return first, open_exits

    def _stmt(self, stmt: ast.stmt, frame: _Frame) -> Tuple[Optional[int], List[Tuple[int, str]]]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return None, []  # different dynamic scope; the def itself cannot raise usefully
        if isinstance(stmt, ast.If):
            return self._if(stmt, frame)
        if isinstance(stmt, (ast.While,)):
            return self._while(stmt, frame)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._for(stmt, frame)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, frame)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, frame)
        node = self._new("stmt", stmt)
        if isinstance(stmt, (ast.Return,)):
            self._route_through_finally(node, frame, self.exit)
            return node, []
        if isinstance(stmt, ast.Raise):
            self._edge(node, frame.exc_target, EXC)
            return node, []
        if isinstance(stmt, ast.Break):
            target = frame.break_target if frame.break_target is not None else self.exit
            self._route_through_finally(node, frame, target, loop_bound=True)
            return node, []
        if isinstance(stmt, ast.Continue):
            target = frame.continue_target if frame.continue_target is not None else self.exit
            self._route_through_finally(node, frame, target, loop_bound=True)
            return node, []
        if _can_raise(stmt):
            self._edge(node, frame.exc_target, EXC)
        return node, [(node, NORMAL)]

    def _route_through_finally(self, node: int, frame: _Frame, target: int, loop_bound: bool = False) -> None:
        """A return/break/continue runs enclosing finally bodies first. The
        finally body is shared, so its exits already fan out to every
        continuation — routing to the innermost entry is enough (the
        fan-out inside ``_try`` includes this node's real target)."""
        if frame.finally_entries:
            entry = frame.finally_entries[0]
            self._edge(node, entry)
            self._route_targets.setdefault(entry, set()).add(target)
        else:
            self._edge(node, target)

    def _if(self, stmt: ast.If, frame: _Frame) -> Tuple[int, List[Tuple[int, str]]]:
        head = self._new("stmt", stmt)
        if _expr_can_raise(stmt.test):
            self._edge(head, frame.exc_target, EXC)
        exits: List[Tuple[int, str]] = []
        b_first, b_exits = self._stmts(stmt.body, frame)
        if b_first is not None:
            self._edge(head, b_first, TRUE)
            exits.extend(b_exits)
        else:
            exits.append((head, TRUE))
        o_first, o_exits = self._stmts(stmt.orelse, frame)
        if o_first is not None:
            self._edge(head, o_first, FALSE)
            exits.extend(o_exits)
        else:
            exits.append((head, FALSE))
        return head, exits

    def _while(self, stmt: ast.While, frame: _Frame) -> Tuple[int, List[Tuple[int, str]]]:
        head = self._new("stmt", stmt)
        if _expr_can_raise(stmt.test):
            self._edge(head, frame.exc_target, EXC)
        inner = _Frame(
            exc_target=frame.exc_target,
            break_target=None,  # patched below via exits list
            continue_target=head,
            finally_entries=frame.finally_entries,
        )
        # break targets whatever FOLLOWS the loop; model with a synthetic join
        after = self._new("join", stmt)  # shares the loop line for findings
        inner.break_target = after
        b_first, b_exits = self._stmts(stmt.body, inner)
        if b_first is not None:
            self._edge(head, b_first, TRUE)
            for src, kind in b_exits:
                self._edge(src, head, kind)  # back edge
        else:
            self._edge(head, head, TRUE)
        infinite = isinstance(stmt.test, ast.Constant) and bool(stmt.test.value)
        if not infinite:
            self._edge(head, after, FALSE)
        o_first, o_exits = self._stmts(stmt.orelse, frame)
        if o_first is not None:  # while/else runs on normal loop exit
            self._edge(after, o_first)
            return head, o_exits
        return head, [(after, NORMAL)]

    def _for(self, stmt: ast.stmt, frame: _Frame) -> Tuple[int, List[Tuple[int, str]]]:
        head = self._new("stmt", stmt)
        if _expr_can_raise(stmt.iter):
            self._edge(head, frame.exc_target, EXC)
        after = self._new("join", stmt)
        inner = _Frame(
            exc_target=frame.exc_target,
            break_target=after,
            continue_target=head,
            finally_entries=frame.finally_entries,
        )
        b_first, b_exits = self._stmts(stmt.body, inner)
        if b_first is not None:
            self._edge(head, b_first, TRUE)  # took an item
            for src, kind in b_exits:
                self._edge(src, head, kind)
        self._edge(head, after, FALSE)  # exhausted
        o_first, o_exits = self._stmts(stmt.orelse, frame)
        if o_first is not None:
            self._edge(after, o_first)
            return head, o_exits
        return head, [(after, NORMAL)]

    def _try(self, stmt: ast.Try, frame: _Frame) -> Tuple[Optional[int], List[Tuple[int, str]]]:
        exits: List[Tuple[int, str]] = []
        has_finally = bool(stmt.finalbody)
        # finally body first, so the body/handlers know where exceptions land.
        fin_first: Optional[int] = None
        fin_exits: List[Tuple[int, str]] = []
        if has_finally:
            fin_first, fin_exits = self._stmts(stmt.finalbody, frame)
            if fin_first is None:  # empty finally: degenerate, treat as absent
                has_finally = False
        # where an exception goes after the handlers fail to catch it
        post_handler_exc = fin_first if has_finally else frame.exc_target
        # handler/orelse bodies run OUTSIDE the protection of this try's
        # handlers, but their returns/breaks still run this try's finally
        outer_via_fin = _Frame(
            exc_target=post_handler_exc,
            break_target=frame.break_target,
            continue_target=frame.continue_target,
            finally_entries=((fin_first,) + frame.finally_entries) if has_finally else frame.finally_entries,
        )
        # handler dispatch: body exceptions land here, then fan to handlers
        if stmt.handlers:
            dispatch = self._new("exc_dispatch", stmt)
            handler_exits: List[Tuple[int, str]] = []
            inner_exc = dispatch
            for handler in stmt.handlers:
                h_first, h_exits = self._stmts(handler.body, outer_via_fin)
                if h_first is not None:
                    self._edge(dispatch, h_first)
                    handler_exits.extend(h_exits)
                else:
                    handler_exits.append((dispatch, NORMAL))
            # unmatched exception continues outward — unless a handler is
            # exhaustive (bare `except:` / `except BaseException:`)
            if not any(
                h.type is None or (isinstance(h.type, ast.Name) and h.type.id == "BaseException")
                for h in stmt.handlers
            ):
                self._edge(dispatch, post_handler_exc, EXC)
        else:
            handler_exits = []
            inner_exc = post_handler_exc
        body_frame = _Frame(
            exc_target=inner_exc,
            break_target=frame.break_target,
            continue_target=frame.continue_target,
            finally_entries=((fin_first,) + frame.finally_entries) if has_finally else frame.finally_entries,
        )
        b_first, b_exits = self._stmts(stmt.body, body_frame)
        o_first, o_exits = self._stmts(stmt.orelse, outer_via_fin)
        if o_first is not None:
            for src, kind in b_exits:
                self._edge(src, o_first, kind)
            b_exits = o_exits
        if has_finally:
            # every normal continuation runs the finally
            for src, kind in b_exits:
                self._edge(src, fin_first, kind)
            for src, kind in handler_exits:
                self._edge(src, fin_first, kind)
            # the finally's exits fan out to every continuation it can serve:
            # fallthrough (returned as our exits), the outer exception path
            # (re-raise after cleanup), and the real targets of any
            # return/break routed through it.
            for src, kind in fin_exits:
                self._edge(src, frame.exc_target, EXC)
                for target in self._route_targets.get(fin_first, ()):
                    self._edge(src, target)
            exits.extend(fin_exits)
            head = b_first if b_first is not None else fin_first
        else:
            exits.extend(b_exits)
            exits.extend(handler_exits)
            head = b_first
            if head is None and stmt.handlers:
                head = inner_exc if isinstance(inner_exc, int) else None
        return head, exits

    def _with(self, stmt: ast.stmt, frame: _Frame) -> Tuple[int, List[Tuple[int, str]]]:
        head = self._new("stmt", stmt)
        if any(_expr_can_raise(item.context_expr) for item in stmt.items):
            self._edge(head, frame.exc_target, EXC)
        cleanup = self._new("with_cleanup", stmt)
        inner = _Frame(
            exc_target=cleanup,  # __exit__ runs on the exception path too
            break_target=frame.break_target,
            continue_target=frame.continue_target,
            finally_entries=(cleanup,) + frame.finally_entries,
        )
        b_first, b_exits = self._stmts(stmt.body, inner)
        if b_first is not None:
            self._edge(head, b_first)
            for src, kind in b_exits:
                self._edge(src, cleanup, kind)
        else:
            self._edge(head, cleanup)
        # after __exit__: fall through, or keep propagating the exception /
        # serve a routed return or break (same fan-out rationale as finally)
        self._edge(cleanup, frame.exc_target, EXC)
        for target in self._route_targets.get(cleanup, ()):
            self._edge(cleanup, target)
        return head, [(cleanup, NORMAL)]

    # ---- queries ----

    def preds(self) -> Dict[int, List[Tuple[int, str]]]:
        out: Dict[int, List[Tuple[int, str]]] = {n.idx: [] for n in self.nodes}
        for node in self.nodes:
            for dst, kind in node.succs:
                out[dst].append((node.idx, kind))
        return out


def _replace_exc(frame: _Frame, exc_target: int) -> _Frame:
    return _Frame(
        exc_target=exc_target,
        break_target=frame.break_target,
        continue_target=frame.continue_target,
        finally_entries=frame.finally_entries,
    )


def _expr_can_raise(expr: Optional[ast.AST]) -> bool:
    if expr is None:
        return False
    for node in ast.walk(expr):
        if isinstance(node, (ast.Call, ast.Await)):
            return True
    return False


def _can_raise(stmt: ast.stmt) -> bool:
    """A statement participates in exception flow when it contains a call
    (or asserts). Attribute/subscript faults are real but modelling them
    floods every function with exception edges nobody reviews."""
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    for node in ast.walk(stmt):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Call, ast.Await)):
            return True
    return False


def build_cfg(fn: ast.AST) -> CFG:
    return CFG(fn)
