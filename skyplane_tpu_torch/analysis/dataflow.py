"""Forward dataflow over :mod:`skyplane_tpu_torch.analysis.cfg` graphs.

A small, deliberately boring fixpoint engine: abstract states are immutable
``{key: frozenset(facts)}`` maps, merge at joins is per-key set union (a MAY
analysis — "on some path" — with MUST facts recoverable as "the only fact
present"), and the transfer function may emit different out-states per edge
kind, which is the whole trick behind light path sensitivity:

    if not self.sched_acquire(req):   # tokens exist ONLY down the false
        requeue(req); return          # branch of this `not` test

The engine knows nothing about resources; :mod:`resources` supplies the
transfer function. Termination: facts per key only grow, the fact universe
per function is finite (statuses x lines that appear in it), so the worklist
drains; ``_MAX_STEPS`` is a belt-and-suspenders bound, never the design.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Mapping, Optional, Tuple

from skyplane_tpu_torch.analysis.cfg import CFG, NORMAL, CFGNode

#: one abstract fact about a tracked key: (status, line it was established)
Fact = Tuple[str, int]
#: a key's fact set, e.g. {("open", 12), ("released", 19)}
Facts = FrozenSet[Fact]
#: whole abstract state
State = Mapping[str, Facts]

#: transfer result: (default out-state, {edge kind: out-state} overrides)
TransferResult = Tuple[State, Dict[str, State]]
Transfer = Callable[[CFGNode, State], TransferResult]

_MAX_STEPS = 200_000  # hard stop for a pathological graph; never hit in practice

EMPTY_STATE: State = {}


def merge(a: State, b: State) -> State:
    """Per-key union; a key absent on one side keeps the other's facts (the
    branch that never touched the resource contributes no claim about it)."""
    if not a:
        return b
    if not b:
        return a
    out = dict(a)
    for key, facts in b.items():
        prev = out.get(key)
        out[key] = facts if prev is None else (prev | facts)
    return out


def set_facts(state: State, key: str, facts: Facts) -> State:
    out = dict(state)
    if facts:
        out[key] = facts
    else:
        out.pop(key, None)
    return out


def statuses(state: State, key: str) -> FrozenSet[str]:
    return frozenset(s for s, _ in state.get(key, ()))


def lines_with_status(state: State, key: str, status: str) -> Tuple[int, ...]:
    return tuple(sorted({line for s, line in state.get(key, ()) if s == status}))


def run_dataflow(cfg: CFG, transfer: Transfer, init: State = EMPTY_STATE) -> Dict[int, State]:
    """Fixpoint: returns the IN state of every node (entry gets ``init``).
    ``transfer`` maps a node's in-state to its out-state(s); the per-edge-kind
    overrides apply to successors reached along that kind."""
    in_states: Dict[int, State] = {cfg.entry: init}
    out_cache: Dict[int, TransferResult] = {}
    worklist = [cfg.entry]
    steps = 0
    while worklist:
        steps += 1
        if steps > _MAX_STEPS:
            break  # over-approximation collapses to "whatever we have so far"
        idx = worklist.pop()
        node = cfg.nodes[idx]
        state = in_states.get(idx, EMPTY_STATE)
        default_out, per_kind = transfer(node, state)
        out_cache[idx] = (default_out, per_kind)
        for dst, kind in node.succs:
            out = per_kind.get(kind, default_out)
            prev = in_states.get(dst)
            merged = out if prev is None else merge(prev, out)
            if prev is None or merged != prev:
                in_states[dst] = merged
                worklist.append(dst)
    return in_states
