"""Resource-lifecycle protocols, checked by dataflow over per-function CFGs.

The gateway's hardest bugs were ownership violations, not logic errors:
the window double-dispatch (chunk requeued, then ALSO resolved by the
dead worker's bookkeeping), the requeue GC race (stale terminal
refcount GC'd the staged chunk file under the peer-serve branch), and the
leaked-token / leaked-fd classes the chaos soaks only catch dynamically.
This module is the static sibling of those soaks: it declares the repo's
acquire/release/transfer contracts as data and proves the truth table over
every path of every function that touches one.

The registry (``PROTOCOLS``) describes each protocol as three site lists:

  * **acquire sites** — calls that create an obligation. ``bind`` says what
    carries it: the call ``result`` (``buf = pool.acquire(b)``), the first
    argument (``self.sched_acquire(req)``), or the ``receiver``
    (``self.scheduler.acquire(...)`` — the token accountant itself is the
    stable name across the acquire/release pair). ``conditional`` marks
    boolean acquires: used as an ``if`` test (optionally under ``not``),
    the obligation exists only down the granted edge.
  * **release sites** — calls that discharge it.
  * **transfer sites** — calls after which someone ELSE owns the release.
    ``to_status="transferred"`` is strict (releasing after it is the
    double-dispatch shape and flags); ``to_status="escaped"`` is lenient
    for dup-style moves — ``socket.send_fds`` copies the descriptor into
    the message, so the sender closing its own copy afterwards is correct.

On top of the registered sites, three heuristics keep the pass quiet where
ownership genuinely moves without a registered site (each one biases toward
silence, the direction a lint must err):

  * passing a tracked resource to a ``CapitalizedName(...)`` constructor
    moves it into the constructed object;
  * storing it into ``self.attr`` / a container slot moves it to a
    longer-lived owner;
  * ``return resource`` moves it to the caller — and returning from a
    function whose NAME is itself a registered acquire site (a wrapper like
    ``sched_acquire``) moves every held obligation of that protocol to the
    caller, which is the wrapper's contract.

Interprocedural reach is one level, via :mod:`callgraph`: a function that
feeds a *parameter* into a registered release/transfer site earns a summary
(``CtrlChannel.send`` transfers its ``fds``), applied at resolved call
sites. Releases inside lambdas count (``SCHED_RELEASE_POLICY.call(lambda:
scheduler.release(...))``); acquires inside lambdas do not (deferred
execution creates no obligation here).

Rules emitted (docs/static-analysis.md has the full table):

  * ``resource-leak-on-path`` — an obligation reaches function exit (or the
    uncaught-exception exit: "release belongs in a ``finally``") still open
    on some path. Also carries the function-scoped staged-ref protocol: a
    re-drive admission (``_redriving.add``) with no terminal-refcount reset
    (``_terminal_done.pop``) anywhere in the function is the requeue GC race.
  * ``double-release`` — a release site reached only by paths that already
    released or transferred the resource.
  * ``escape-without-transfer`` — an owned resource shipped through a
    queue/IPC boundary (``put``/``send``/``submit``...) with no registered
    transfer site: sender and receiver now both think they own it.
  * ``uncounted-retry-burns-budget`` — a retry-budget increment reachable
    while some frame is marked ``counted_retry = False`` (shutdown requeues
    must not consume the budget delivery failures are measured against).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from skyplane_tpu_torch.analysis import dataflow as df
from skyplane_tpu_torch.analysis.callgraph import CallGraph, FunctionDecl, ProjectIndex
from skyplane_tpu_torch.analysis.cfg import CFG, EXC, FALSE, TRUE, build_cfg
from skyplane_tpu_torch.analysis.concurrency import dotted_name
from skyplane_tpu_torch.analysis.core import Finding, ModuleInfo, ProjectChecker, RuleSpec

# ---------------------------------------------------------------------------
# protocol registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Site:
    """One call pattern: terminal name(s), optional receiver fragment(s),
    and what the obligation binds to."""

    names: Tuple[str, ...]
    recv_any: Tuple[str, ...] = ()  # receiver dotted name must contain one
    bind: str = "result"  # "result" | "arg0" | "receiver" | "args"
    #: (positional arg index, required dotted-name suffix) — all must hold;
    #: how ChunkState-valued calls are split into acquire vs terminal sites
    arg_filters: Tuple[Tuple[int, str], ...] = ()
    conditional: bool = False  # boolean acquire: holds only on the granted edge
    to_status: str = "transferred"  # transfer sites: strict vs "escaped"

    def matches(self, terminal: str, receiver: str, call: ast.Call) -> bool:
        if terminal not in self.names:
            return False
        if self.recv_any and not any(frag in receiver for frag in self.recv_any):
            return False
        for idx, suffix in self.arg_filters:
            if idx >= len(call.args) or not dotted_name(call.args[idx]).endswith(suffix):
                return False
        return True


@dataclass(frozen=True)
class Protocol:
    name: str  # short id: namespaces abstract-state keys ("fd:sock")
    what: str  # human noun for messages
    acquires: Tuple[Site, ...]
    releases: Tuple[Site, ...]
    transfers: Tuple[Site, ...] = ()
    track_escape: bool = True  # escape-without-transfer applies
    leak_hint: str = ""


PROTOCOLS: Tuple[Protocol, ...] = (
    Protocol(
        name="sched",
        what="scheduler tokens",
        acquires=(
            Site(names=("sched_acquire",), bind="arg0", conditional=True),
            Site(names=("acquire",), recv_any=("scheduler", "sched"), bind="receiver", conditional=True),
        ),
        releases=(
            Site(names=("sched_release",), bind="arg0"),
            Site(names=("release",), recv_any=("scheduler", "sched"), bind="receiver"),
        ),
        leak_hint=" — leaked tokens starve this tenant's own later chunks until job teardown",
    ),
    Protocol(
        name="buf",
        what="pooled buffer",
        acquires=(Site(names=("acquire", "acquire_scratch"), recv_any=("pool", "bufpool"), bind="result"),),
        releases=(
            Site(names=("release", "release_scratch"), recv_any=("pool", "bufpool"), bind="arg0"),
            Site(names=("recycle",), bind="receiver"),
        ),
        leak_hint=" — the pool slot is gone for the process lifetime",
    ),
    Protocol(
        name="fd",
        what="file descriptor",
        acquires=(
            Site(names=("socket", "create_connection"), recv_any=("socket",), bind="result"),
            Site(names=("socketpair",), recv_any=("socket",), bind="result"),
            Site(names=("pipe", "dup", "openpty", "open"), recv_any=("os",), bind="result"),
            # staged-file fd adopted off the pump ctrl channel: popping it
            # moves ownership to the caller (raw-forward fast path)
            Site(names=("take_raw_fd",), bind="result"),
        ),
        releases=(
            Site(names=("close", "shutdown_and_close"), bind="receiver"),
            Site(names=("close", "closerange"), recv_any=("os",), bind="arg0"),
        ),
        transfers=(
            # SCM_RIGHTS dups the descriptor into the message: the receiver
            # owns the new fd, the sender still (correctly) closes its copy
            Site(names=("send_fds",), bind="args", to_status="escaped"),
            Site(names=("send",), recv_any=("ctrl",), bind="args", to_status="escaped"),
            Site(names=("detach",), bind="receiver", to_status="escaped"),
            # os.fdopen(fd) wraps the raw fd in a file object that now owns
            # the close (closing the file closes the descriptor)
            Site(names=("fdopen",), recv_any=("os",), bind="args", to_status="escaped"),
            # raw-forward: the chunk store adopts the staged-file fd (its
            # take_raw_fd consumer closes it); os.sendfile is deliberately
            # NOT listed anywhere — the splice BORROWS the fd, the frame
            # that carries it still owns the close
            Site(names=("adopt_raw_fd",), bind="args", to_status="transferred"),
        ),
        leak_hint=" — leaked descriptors exhaust the process rlimit",
    ),
    Protocol(
        name="sealed",
        what="sealed-frame borrow",
        # sealed_open_by_fp: the dedup fabric's fingerprint-keyed borrow
        # (gateway_daemon segment serve) — same obligation as sealed_open
        acquires=(Site(names=("sealed_open", "sealed_open_by_fp"), bind="result"),),
        releases=(
            Site(names=("close", "release"), recv_any=("ref", "sealed"), bind="receiver"),
        ),
        leak_hint=" — an unreleased borrow pins the sealed frame past its chunk's terminal GC",
    ),
    Protocol(
        name="chunk",
        what="chunk in_progress accounting",
        acquires=(
            Site(names=("log_chunk_state", "set_chunk_state"), arg_filters=((1, "in_progress"),), bind="arg0"),
        ),
        releases=(
            Site(names=("log_chunk_state", "set_chunk_state"), arg_filters=((1, "complete"),), bind="arg0"),
            Site(names=("log_chunk_state", "set_chunk_state"), arg_filters=((1, "failed"),), bind="arg0"),
        ),
        transfers=(
            # requeue / next-hop handoff: the queue's next consumer owns the
            # terminal transition now — resolving it HERE TOO is the double-dispatch
            Site(names=("put_for_handle",), bind="args"),
            Site(names=("log_chunk_state", "set_chunk_state"), arg_filters=((1, "queued"),), bind="arg0"),
            Site(names=("add_chunk_request",), bind="args"),
        ),
        track_escape=False,  # chunk requests legitimately ride queues everywhere
        leak_hint=" — a chunk stuck in_progress is invisible to completion tracking",
    ),
)

RESOURCE_RULES: Tuple[RuleSpec, ...] = (
    RuleSpec(
        "resource-leak-on-path",
        "error",
        "an acquired resource reaches function exit on some path with no release or ownership transfer",
    ),
    RuleSpec(
        "double-release",
        "error",
        "a resource is released again after every path to this line already released or transferred it",
    ),
    RuleSpec(
        "escape-without-transfer",
        "warning",
        "an owned resource is shipped through a queue/IPC boundary with no registered ownership-transfer site",
    ),
    RuleSpec(
        "uncounted-retry-burns-budget",
        "error",
        "retry budget incremented while a frame is marked counted_retry=False (uncounted requeues must not burn it)",
    ),
)

_SEVERITY = {r.name: r.severity for r in RESOURCE_RULES}

#: queue/IPC boundary calls the escape rule watches when nothing else matched
_BOUNDARY_NAMES = {"put", "put_nowait", "send", "send_bytes", "submit"}

#: terminal call names that make a function worth a CFG + dataflow run
_TRIGGER_NAMES: Set[str] = {n for p in PROTOCOLS for s in p.acquires for n in s.names}

#: function names that are themselves acquire sites: returning from one
#: transfers the held obligations to the caller (the wrapper contract)
_WRAPPER_PROTOS: Dict[str, Tuple[str, ...]] = {}
for _p in PROTOCOLS:
    for _s in _p.acquires:
        for _n in _s.names:
            _WRAPPER_PROTOS[_n] = tuple(set(_WRAPPER_PROTOS.get(_n, ())) | {_p.name})

#: every key prefix the abstract state uses ("retry" is the counted_retry
#: pseudo-protocol; it has no Site list, only the special-cased transitions)
_KEY_PREFIXES = tuple(p.name for p in PROTOCOLS) + ("retry",)

_COUNTED_RETRY = ".counted_retry"
#: attribute-name fragments that identify a retry-budget counter
_BUDGET_FRAGMENTS = ("retries", "retry_count", "attempts")


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------


def _terminal_and_receiver(call: ast.Call) -> Tuple[str, str]:
    d = dotted_name(call.func)
    if not d:
        return "", ""
    head, _, tail = d.rpartition(".")
    return tail, head


def _calls_in(root: ast.AST) -> List[Tuple[ast.Call, bool]]:
    """(call, inside_a_lambda) for every call under ``root``, skipping nested
    def/class bodies (different dynamic scope) but descending lambdas —
    deferred releases like ``POLICY.call(lambda: sched.release(...))`` are
    this codebase's standard release idiom."""
    out: List[Tuple[ast.Call, bool]] = []

    def rec(node: ast.AST, in_lambda: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            flag = in_lambda or isinstance(child, ast.Lambda)
            if isinstance(child, ast.Call):
                out.append((child, flag))
            rec(child, flag)

    if isinstance(root, ast.Call):  # the root may itself be the call (`return F(x)`)
        out.append((root, False))
    rec(root, False)
    return out


def _flat_operand_names(call: ast.Call) -> List[str]:
    """Dotted names of a call's operands, looking through list/tuple displays
    and ``list(...)``-style wrappers — ``send_fds(sock, [data], list(fds))``
    must see ``fds``."""
    out: List[str] = []

    def add(expr: ast.AST) -> None:
        if isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
            for e in expr.elts:
                add(e)
        elif isinstance(expr, ast.Starred):
            add(expr.value)
        elif isinstance(expr, ast.Call):
            if dotted_name(expr.func) in ("list", "tuple", "set", "sorted"):
                for a in expr.args:
                    add(a)
        else:
            d = dotted_name(expr)
            if d:
                out.append(d)

    for a in call.args:
        add(a)
    for kw in call.keywords:
        add(kw.value)
    return out


def _bound_operand(site: Site, call: ast.Call, terminal: str, receiver: str) -> List[str]:
    """The dotted name(s) the obligation binds to at a release/transfer site."""
    if site.bind == "arg0":
        if call.args:
            d = dotted_name(call.args[0])
            return [d] if d else []
        return []
    if site.bind == "receiver":
        return [receiver] if receiver else []
    if site.bind == "args":
        return _flat_operand_names(call)
    return []


# ---------------------------------------------------------------------------
# prescan: decide cheaply which functions need the full dataflow run
# ---------------------------------------------------------------------------


@dataclass
class _Prescan:
    names: Set[str]
    counted_retry: bool
    redrive_adds: List[int]
    terminal_pops: bool


def _prescan(fn: ast.AST) -> _Prescan:
    names: Set[str] = set()
    counted_retry = False
    redrive_adds: List[int] = []
    terminal_pops = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            terminal, receiver = _terminal_and_receiver(node)
            if terminal:
                names.add(terminal)
                if terminal == "add" and "redriv" in receiver:
                    redrive_adds.append(node.lineno)
                if terminal in ("pop", "discard", "clear") and "terminal_done" in receiver:
                    terminal_pops = True
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(dotted_name(t).endswith(_COUNTED_RETRY) for t in targets):
                counted_retry = True
    return _Prescan(names, counted_retry, redrive_adds, terminal_pops)


# ---------------------------------------------------------------------------
# one-level interprocedural summaries
# ---------------------------------------------------------------------------


@dataclass
class _Summary:
    releases: Dict[str, str]  # param name -> protocol name
    transfers: Dict[str, Tuple[str, str]]  # param name -> (protocol, to_status)

    def __bool__(self) -> bool:
        return bool(self.releases or self.transfers)


_EMPTY_SUMMARY = _Summary({}, {})


def _params_of(decl: FunctionDecl) -> List[str]:
    a = decl.node.args
    params = [p.arg for p in (*a.posonlyargs, *a.args)]
    if decl.cls and params and params[0] in ("self", "cls"):
        params = params[1:]
    return params + [p.arg for p in a.kwonlyargs]


def _build_summary(decl: FunctionDecl) -> _Summary:
    """A function that feeds a PARAMETER into a registered release/transfer
    site releases/transfers that parameter for its callers (one level; not
    transitive by design — summaries of summaries compound imprecision)."""
    params = set(_params_of(decl))
    if not params:
        return _EMPTY_SUMMARY
    releases: Dict[str, str] = {}
    transfers: Dict[str, Tuple[str, str]] = {}
    for call, _ in _calls_in(decl.node):
        terminal, receiver = _terminal_and_receiver(call)
        for proto in PROTOCOLS:
            for site in proto.releases:
                if site.matches(terminal, receiver, call):
                    for name in _bound_operand(site, call, terminal, receiver):
                        if name in params:
                            releases.setdefault(name, proto.name)
            for site in proto.transfers:
                if site.matches(terminal, receiver, call):
                    for name in _bound_operand(site, call, terminal, receiver):
                        if name in params:
                            transfers.setdefault(name, (proto.name, site.to_status))
    if not (releases or transfers):
        return _EMPTY_SUMMARY
    return _Summary(releases, transfers)


class _SummaryCache:
    def __init__(self) -> None:
        self._cache: Dict[str, _Summary] = {}

    def get(self, decl: FunctionDecl) -> _Summary:
        s = self._cache.get(decl.qualname)
        if s is None:
            s = _build_summary(decl)
            self._cache[decl.qualname] = s
        return s


# ---------------------------------------------------------------------------
# the per-function dataflow analysis
# ---------------------------------------------------------------------------

_OPEN = "open"
_RELEASED = "released"
_TRANSFERRED = "transferred"  # strict: release-after is double-release
_ESCAPED = "escaped"  # lenient move: exempt from leak AND double-release
_UNCOUNTED = "uncounted"  # retry pseudo-protocol


class _FunctionAnalysis:
    def __init__(self, decl: FunctionDecl, graph: CallGraph, summaries: _SummaryCache):
        self.decl = decl
        self.graph = graph
        self.summaries = summaries
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[str, str, int]] = set()

    # ---- reporting ----

    def _emit(self, rule: str, line: int, message: str, dedupe: str) -> None:
        key = (rule, dedupe, line)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(
            Finding(rule=rule, severity=_SEVERITY[rule], path=self.decl.module.path, line=line, message=message)
        )

    # ---- the walk ----

    def run(self) -> List[Finding]:
        cfg = build_cfg(self.decl.node)
        in_states = df.run_dataflow(cfg, lambda n, s: self._transfer(n, s, None))
        # replay each node's transfer on its FINAL in-state to emit findings
        # (during the fixpoint a node runs many times on partial states)
        for node in cfg.nodes:
            state = in_states.get(node.idx)
            if state is not None:
                self._transfer(node, state, True)  # any non-None value arms _emit
        self._check_leaks(cfg, in_states)
        return self.findings

    def _check_leaks(self, cfg: CFG, in_states: Dict[int, df.State]) -> None:
        exit_state = in_states.get(cfg.exit, {})
        raise_state = in_states.get(cfg.raise_exit, {})
        reported: Set[Tuple[str, int]] = set()
        for key, facts in sorted(exit_state.items()):
            for status, line in sorted(facts):
                if status == _OPEN:
                    reported.add((key, line))
                    self._leak(key, line, exceptional=False)
        for key, facts in sorted(raise_state.items()):
            for status, line in sorted(facts):
                if status == _OPEN and (key, line) not in reported:
                    self._leak(key, line, exceptional=True)

    def _leak(self, key: str, line: int, exceptional: bool) -> None:
        proto = _proto_of(key)
        var = key.split(":", 1)[1]
        how = (
            "can reach an uncaught-exception exit still held — release it in a `finally`"
            if exceptional
            else "can reach function exit on some path with no release or ownership transfer"
        )
        self._emit(
            "resource-leak-on-path",
            line,
            f"{proto.what} acquired into `{var}` in {self.decl.display}() {how}{proto.leak_hint}",
            key,
        )

    # ---- the transfer function (both fixpoint and reporting passes) ----

    def _transfer(self, node, state: df.State, report) -> df.TransferResult:
        if node.kind != "stmt" or node.stmt is None:
            return state, {}
        stmt = node.stmt
        line = node.line
        if isinstance(stmt, (ast.If, ast.While)):
            return self._branch(stmt, state, report, line)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._apply_calls([stmt.iter], state, report, line, set()), {}
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            # with-acquired resources are auto-released by __exit__: untracked.
            # But a context expr can CONSUME an already-tracked resource
            # (`with os.fdopen(fd, "a") as f:` hands fd to the file object),
            # so releases/transfers still apply — acquires don't (lambda mode)
            for item in stmt.items:
                for call, _ in _calls_in(item.context_expr):
                    state = self._apply_call(call, True, state, report, line)
            return state, {}
        if isinstance(stmt, ast.Return):
            return self._return(stmt, state, report, line), {}
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            out, pre_bind = self._assign(stmt, state, report, line)
            # the acquire call raising means nothing was acquired: the EXC
            # edge out of `fd = os.open(...)` must not carry the binding
            return out, ({EXC: pre_bind} if pre_bind is not None else {})
        if isinstance(stmt, ast.AugAssign):
            state = self._apply_calls([stmt.value], state, report, line, set())
            self._check_budget_bump(stmt.target, state, report, line)
            return state, {}
        out = self._apply_calls([stmt], state, report, line, set())
        if out != state:
            # the statement's own exception edge: releases/transfers still
            # apply (POSIX close() closes even on error) but acquires do NOT
            # (`store.log_chunk_state(req, in_progress)` raising means the
            # obligation was never recorded) — same contract as Assign's
            # pre_bind, via the no-acquire (lambda) call mode
            exc_out = self._apply_calls([stmt], state, None, line, set(), no_acquire=True)
            if exc_out != out:
                return out, {EXC: exc_out}
        return out, {}

    def _branch(self, stmt, state: df.State, report, line: int) -> df.TransferResult:
        test = stmt.test
        inner, negated = (
            (test.operand, True) if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) else (test, False)
        )
        taken = FALSE if negated else TRUE  # edge where the inner test is truthy
        # counted_retry guard: the truthy-counted edge drops the uncounted mark
        g = dotted_name(inner)
        if g.endswith(_COUNTED_RETRY):
            key = f"retry:{g[: -len(_COUNTED_RETRY)]}"
            if key in state:
                return state, {taken: df.set_facts(state, key, frozenset())}
            return state, {}
        # `x is None` / `x is not None` polarity: the None-implying edge
        # cannot still hold the resource (`arr = pool.acquire(...)` only ever
        # ran on the non-None path), so drop x's facts there
        none_test = self._none_test(inner)
        if none_test is not None:
            name, none_when_truthy = none_test
            none_edge = taken if none_when_truthy else (FALSE if taken == TRUE else TRUE)
            cleared = state
            for prefix in _KEY_PREFIXES:
                cleared = df.set_facts(cleared, f"{prefix}:{name}", frozenset())
            if cleared != state:
                return state, {none_edge: cleared}
            return state, {}
        skip: Set[int] = set()
        cond: Optional[Tuple[Protocol, str]] = None
        if isinstance(inner, ast.Call):
            cond = self._match_conditional_acquire(inner)
            if cond is not None:
                skip.add(id(inner))
        out = self._apply_calls([test], state, report, line, skip)
        if cond is None:
            return out, {}
        proto, key = cond
        granted = df.set_facts(out, key, frozenset({(_OPEN, line)}))
        return out, {taken: granted}

    @staticmethod
    def _none_test(inner) -> Optional[Tuple[str, bool]]:
        """``x is None``/``x is not None`` -> (dotted x, True iff the truthy
        edge is the None edge); anything else -> None."""
        if (
            isinstance(inner, ast.Compare)
            and len(inner.ops) == 1
            and isinstance(inner.ops[0], (ast.Is, ast.IsNot))
            and isinstance(inner.comparators[0], ast.Constant)
            and inner.comparators[0].value is None
        ):
            name = dotted_name(inner.left)
            if name:
                return name, isinstance(inner.ops[0], ast.Is)
        return None

    def _match_conditional_acquire(self, call: ast.Call) -> Optional[Tuple[Protocol, str]]:
        terminal, receiver = _terminal_and_receiver(call)
        for proto in PROTOCOLS:
            for site in proto.acquires:
                if site.conditional and site.matches(terminal, receiver, call):
                    if site.bind == "arg0":
                        names = _bound_operand(site, call, terminal, receiver)
                        if names:
                            return proto, f"{proto.name}:{names[0]}"
                    elif site.bind == "receiver" and receiver:
                        return proto, f"{proto.name}:{receiver}"
        return None

    def _return(self, stmt: ast.Return, state: df.State, report, line: int) -> df.State:
        out = self._apply_calls([stmt.value], state, report, line, set()) if stmt.value is not None else state
        if stmt.value is not None:
            d = dotted_name(stmt.value)
            if d:
                for prefix in _KEY_PREFIXES:
                    key = f"{prefix}:{d}"
                    if _OPEN in df.statuses(out, key):
                        out = df.set_facts(out, key, frozenset({(_ESCAPED, line)}))
        for proto_name in _WRAPPER_PROTOS.get(self.decl.name, ()):
            # a wrapper acquire function returning = obligations go to the caller
            for key in list(out):
                if key.startswith(proto_name + ":") and _OPEN in df.statuses(out, key):
                    out = df.set_facts(out, key, frozenset({(_ESCAPED, line)}))
        return out

    def _assign(
        self, stmt, state: df.State, report, line: int
    ) -> Tuple[df.State, Optional[df.State]]:
        """Returns (out state, state WITHOUT the fresh acquire binding — for
        the statement's own exception edge — or None when nothing was bound)."""
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        value = stmt.value
        # counted_retry marker
        for tgt in targets:
            d = dotted_name(tgt)
            if d.endswith(_COUNTED_RETRY) and isinstance(value, ast.Constant):
                key = f"retry:{d[: -len(_COUNTED_RETRY)]}"
                facts = frozenset() if value.value else frozenset({(_UNCOUNTED, line)})
                state = df.set_facts(state, key, facts)
        if value is None:
            return state, None
        skip: Set[int] = set()
        bound_proto: Optional[Protocol] = None
        if isinstance(value, ast.Call):
            terminal, receiver = _terminal_and_receiver(value)
            for proto in PROTOCOLS:
                for site in proto.acquires:
                    if site.bind == "result" and site.matches(terminal, receiver, value):
                        bound_proto = proto
                        skip.add(id(value))
                        break
                if bound_proto:
                    break
        out = self._apply_calls([stmt], state, report, line, skip)
        # alias facts of a plain name/attr RHS, to be moved or escaped below
        alias_facts: Dict[str, df.Facts] = {}
        rhs = dotted_name(value) if isinstance(value, (ast.Name, ast.Attribute)) else ""
        if rhs:
            for prefix in _KEY_PREFIXES:
                key = f"{prefix}:{rhs}"
                if key in out:
                    alias_facts[key] = out[key]
        # assignment to a bare name is a fresh binding: kill stale facts
        name_targets: List[str] = []
        store_escape = False
        for tgt in targets:
            elems = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
            for el in elems:
                if isinstance(el, ast.Name):
                    name_targets.append(el.id)
                    for prefix in _KEY_PREFIXES:
                        out = df.set_facts(out, f"{prefix}:{el.id}", frozenset())
                elif isinstance(el, (ast.Attribute, ast.Subscript)):
                    store_escape = True
        pre_bind: Optional[df.State] = None
        if bound_proto is not None:
            pre_bind = out
            for name in name_targets:
                out = df.set_facts(out, f"{bound_proto.name}:{name}", frozenset({(_OPEN, line)}))
        elif alias_facts:
            for key, facts in alias_facts.items():
                prefix = key.split(":", 1)[0]
                if store_escape and _OPEN in {s for s, _ in facts}:
                    # stored into self.attr / a container: a longer-lived owner
                    out = df.set_facts(out, key, frozenset({(_ESCAPED, line)}))
                for name in name_targets:
                    out = df.set_facts(out, f"{prefix}:{name}", facts)
                    out = df.set_facts(out, key, frozenset())  # moved, not copied
        self._check_budget_bump_targets(targets, value, out, report, line)
        return out, pre_bind

    # ---- uncounted-retry budget rule ----

    def _check_budget_bump_targets(self, targets, value, state: df.State, report, line: int) -> None:
        if isinstance(value, ast.Constant):
            return  # `req.wire_retries = 0` is a reset, not a bump
        for tgt in targets:
            self._check_budget_bump(tgt, state, report, line)

    def _check_budget_bump(self, target, state: df.State, report, line: int) -> None:
        if report is None:
            return
        d = dotted_name(target)
        terminal = d.rpartition(".")[2]
        if not any(frag in terminal for frag in _BUDGET_FRAGMENTS):
            return
        for key, facts in state.items():
            if not key.startswith("retry:"):
                continue
            for status, set_line in sorted(facts):
                if status == _UNCOUNTED:
                    frame = key.split(":", 1)[1]
                    self._emit(
                        "uncounted-retry-burns-budget",
                        line,
                        f"retry budget `{d}` incremented while `{frame}.counted_retry` is False "
                        f"(set at line {set_line}) — uncounted requeues (shutdown/drain) must not "
                        f"burn the budget; guard the increment with `if {frame}.counted_retry:`",
                        key,
                    )

    # ---- call effects ----

    def _apply_calls(
        self,
        roots: Sequence[Optional[ast.AST]],
        state: df.State,
        report,
        line: int,
        skip: Set[int],
        no_acquire: bool = False,
    ) -> df.State:
        for root in roots:
            if root is None:
                continue
            for call, in_lambda in _calls_in(root):
                if id(call) in skip:
                    continue
                state = self._apply_call(call, in_lambda or no_acquire, state, report, line)
        return state

    def _apply_call(self, call: ast.Call, in_lambda: bool, state: df.State, report, line: int) -> df.State:
        terminal, receiver = _terminal_and_receiver(call)
        if not terminal:
            return state
        # 1) registered release/transfer sites — apply EVERY match: `os.close(fd)`
        #    satisfies both the receiver-bind close site (as "fd:os", untracked,
        #    a no-op) and the arg0-bind os.close site (the one that discharges)
        matched = False
        for proto in PROTOCOLS:
            for site in proto.releases:
                if site.matches(terminal, receiver, call):
                    matched = True
                    for name in _bound_operand(site, call, terminal, receiver):
                        state = self._release(state, proto, f"{proto.name}:{name}", line, report)
            for site in proto.transfers:
                if site.matches(terminal, receiver, call):
                    matched = True
                    for name in _bound_operand(site, call, terminal, receiver):
                        key = f"{proto.name}:{name}"
                        if key in state:
                            state = df.set_facts(state, key, frozenset({(site.to_status, line)}))
        if matched:
            return state
        # 3) one-level summaries via the call graph
        resolved = self.graph.resolve(call, self.decl)
        if resolved is not None:
            summary = self.summaries.get(resolved)
            # an EMPTY summary must not swallow the call: a resolved
            # constructor with a no-effect __init__ still owns its operands
            if summary is not None and (summary.releases or summary.transfers):
                return self._apply_summary(call, resolved, summary, state, report, line)
        # 4) container stores move ownership into the container (a later
        #    `for r in acquired: release(r)` loop is invisible to a var-keyed
        #    analysis, so the append is where tracking hands off)
        if terminal in ("append", "appendleft", "add", "extend", "insert", "push", "setdefault"):
            for name in _flat_operand_names(call):
                for prefix in _KEY_PREFIXES:
                    key = f"{prefix}:{name}"
                    if _OPEN in df.statuses(state, key):
                        state = df.set_facts(state, key, frozenset({(_ESCAPED, line)}))
            return state
        # 5) constructor heuristic: the object owns what it was built from
        #    (private classes like `_Entry` count: look past the underscores).
        #    An ATTRIBUTE operand moves its base object too — passing
        #    `ref.fd` / `release_fn=ref.close` into RawFrameSource(...) hands
        #    the borrow's lifetime to the constructed frame (bias toward
        #    silence, per the module contract)
        if terminal.lstrip("_")[:1].isupper():
            for name in _flat_operand_names(call):
                for cand in {name, name.split(".", 1)[0]}:
                    for prefix in _KEY_PREFIXES:
                        key = f"{prefix}:{cand}"
                        if _OPEN in df.statuses(state, key):
                            state = df.set_facts(state, key, frozenset({(_ESCAPED, line)}))
            return state
        # 6) queue/IPC boundary with an owned operand: escape-without-transfer
        if terminal in _BOUNDARY_NAMES:
            for name in _flat_operand_names(call):
                for proto in PROTOCOLS:
                    if not proto.track_escape:
                        continue
                    key = f"{proto.name}:{name}"
                    if _OPEN in df.statuses(state, key):
                        if report is not None:
                            self._emit(
                                "escape-without-transfer",
                                line,
                                f"{proto.what} `{name}` is still owned here but shipped through "
                                f"`{dotted_name(call.func)}(...)`, which is not a registered "
                                f"ownership-transfer site — sender and receiver now both think "
                                f"they own the release",
                                key,
                            )
                        state = df.set_facts(state, key, frozenset({(_ESCAPED, line)}))
            return state
        # 7) non-conditional acquires that bind an argument/receiver, plus
        #    result-bind acquires whose result is DISCARDED (a leak by birth)
        if not in_lambda:
            for proto in PROTOCOLS:
                for site in proto.acquires:
                    if not site.matches(terminal, receiver, call):
                        continue
                    if site.bind == "arg0":
                        for name in _bound_operand(site, call, terminal, receiver):
                            state = df.set_facts(state, f"{proto.name}:{name}", frozenset({(_OPEN, line)}))
                    elif site.bind == "receiver" and receiver:
                        state = df.set_facts(state, f"{proto.name}:{receiver}", frozenset({(_OPEN, line)}))
                    elif site.bind == "result":
                        # not consumed by an Assign (that path skips the call)
                        state = df.set_facts(
                            state, f"{proto.name}:<discarded@{line}>", frozenset({(_OPEN, line)})
                        )
                    return state
        return state

    def _apply_summary(
        self, call: ast.Call, resolved: FunctionDecl, summary: _Summary, state: df.State, report, line: int
    ) -> df.State:
        params = _params_of(resolved)
        operands: List[Tuple[str, ast.AST]] = []
        for i, arg in enumerate(call.args):
            if i < len(params):
                operands.append((params[i], arg))
        for kw in call.keywords:
            if kw.arg is not None:
                operands.append((kw.arg, kw.value))
        for param, expr in operands:
            names = _flat_operand_names_of_expr(expr)
            if param in summary.releases:
                proto_name = summary.releases[param]
                proto = _PROTO_BY_NAME[proto_name]
                for name in names:
                    state = self._release(state, proto, f"{proto_name}:{name}", line, report)
            elif param in summary.transfers:
                proto_name, to_status = summary.transfers[param]
                for name in names:
                    key = f"{proto_name}:{name}"
                    if key in state:
                        state = df.set_facts(state, key, frozenset({(to_status, line)}))
        return state

    def _release(self, state: df.State, proto: Protocol, key: str, line: int, report) -> df.State:
        facts = state.get(key)
        if not facts:
            return state  # released something this function never acquired: fine
        sts = {s for s, _ in facts}
        if _OPEN not in sts and _ESCAPED not in sts:
            if report is not None:
                prior = ", ".join(f"{s} at line {l}" for s, l in sorted(facts, key=lambda f: f[1]))
                if _TRANSFERRED in sts:
                    msg = (
                        f"{proto.what} `{key.split(':', 1)[1]}` was already handed off ({prior}) — "
                        f"the new owner resolves it; releasing here too double-accounts the resource "
                        f"(the PR-13 double-dispatch shape: requeued AND resolved locally)"
                    )
                else:
                    msg = (
                        f"{proto.what} `{key.split(':', 1)[1]}` is already released on every path "
                        f"reaching this line ({prior})"
                    )
                self._emit("double-release", line, msg, key)
        return df.set_facts(state, key, frozenset({(_RELEASED, line)}))


def _flat_operand_names_of_expr(expr: ast.AST) -> List[str]:
    """Like :func:`_flat_operand_names` but for one already-extracted operand."""
    fake = ast.Call(func=ast.Name(id="_", ctx=ast.Load()), args=[expr], keywords=[])
    return _flat_operand_names(fake)


_PROTO_BY_NAME = {p.name: p for p in PROTOCOLS}


def _proto_of(key: str) -> Protocol:
    return _PROTO_BY_NAME[key.split(":", 1)[0]]


# ---------------------------------------------------------------------------
# the project checker
# ---------------------------------------------------------------------------


class ResourceLifecycleChecker(ProjectChecker):
    """CFG + dataflow over every function that touches a registered protocol,
    plus the function-scoped staged-ref check (the requeue GC race): a re-drive
    admission must reset the staged-file terminal refcount SOMEWHERE in the
    same function — order-insensitive on purpose, the fixed code pops before
    re-registering and either order is race-free within one lock hold."""

    rules = RESOURCE_RULES

    def check_project(self, modules: Sequence[ModuleInfo]) -> Iterator[Finding]:
        index = ProjectIndex(modules)
        graph = CallGraph(index)
        summaries = _SummaryCache()
        for decl in index.functions.values():
            pre = _prescan(decl.node)
            if pre.redrive_adds and not pre.terminal_pops:
                for ln in pre.redrive_adds:
                    yield Finding(
                        rule="resource-leak-on-path",
                        severity=_SEVERITY["resource-leak-on-path"],
                        path=decl.module.path,
                        line=ln,
                        message=(
                            f"{decl.display}() admits a chunk for re-drive (`_redriving.add`) without "
                            f"resetting its staged-file terminal refcount (`_terminal_done.pop`) — a "
                            f"stale full refcount GCs the staged chunk file on the FIRST re-completion, "
                            f"under any branch still serving it (the PR-15 requeue GC race)"
                        ),
                    )
            if not (pre.names & _TRIGGER_NAMES or pre.counted_retry):
                continue
            yield from _FunctionAnalysis(decl, graph, summaries).run()


RESOURCE_PROJECT_CHECKERS = (ResourceLifecycleChecker,)
