"""The plain reference of a checkpoint-blast tree (``docs/blast.md``): the
tree the port's solver must place, found by trying every one.

For K <= 6 sinks, every assignment of a parent (the source or another sink)
to each sink is enumerated; those that are arborescences rooted at the
source (no cycle) within the degree bounds (the source's ``source_degree``,
each sink's ``fanout``) are kept, and the least cost wins, then the least
total depth (the sum of the sinks' hop counts from the source), then the
first assignment in sorted order. Plain Python: no torch, no import of the
port or of JAX.
"""

from __future__ import annotations

from collections import Counter
from itertools import product
from typing import Callable, Dict, NamedTuple, Optional, Tuple

MAX_SINKS = 6


class Tree(NamedTuple):
    cost: float
    depth: int  # total depth: the sum over sinks of the edges from the source
    parent: Dict[str, str]


def total_depth(root: str, parent: Dict[str, str]) -> Optional[int]:
    """The sum of the sinks' depths, or None when a sink does not reach the root."""
    total = 0
    for node in parent:
        d, cur = 0, node
        while cur != root:
            cur = parent.get(cur)
            d += 1
            if cur is None or d > len(parent):
                return None
        total += d
    return total


def score(root: str, parent: Dict[str, str], regions: Dict[str, str],
          cost_fn: Callable[[str, str], float]) -> Tuple[float, Optional[int]]:
    """(cost, total depth) of a tree: each edge's cost between its two
    nodes' regions, summed in sorted order of the sinks."""
    cost = sum(cost_fn(regions[parent[s]], regions[s]) for s in sorted(parent))
    return cost, total_depth(root, parent)


def within_bounds(root: str, parent: Dict[str, str], fanout: int, source_degree: int) -> bool:
    out = Counter(parent.values())
    return out[root] <= source_degree and all(n <= fanout for node, n in out.items() if node != root)


def best_tree(root: str, sink_regions: Dict[str, str], root_region: str, cost_fn: Callable[[str, str], float],
              fanout: int, source_degree: int) -> Tree:
    """The least-cost, then shallowest, tree over ``sink_regions`` (node ->
    region) rooted at ``root`` within the degree bounds."""
    sinks = sorted(sink_regions)
    if not 1 <= len(sinks) <= MAX_SINKS:
        raise ValueError(f"the reference enumerates 1 to {MAX_SINKS} sinks, not {len(sinks)}")
    regions = {root: root_region, **sink_regions}
    best = None
    for parents in product([root] + sinks, repeat=len(sinks)):
        parent = dict(zip(sinks, parents))
        if any(p == s for s, p in parent.items()) or not within_bounds(root, parent, fanout, source_degree):
            continue
        cost, depth = score(root, parent, regions, cost_fn)
        if depth is None:
            continue
        key = (cost, depth, parents)
        if best is None or key < best:
            best = key
    if best is None:
        raise ValueError("no tree within the degree bounds")
    return Tree(best[0], best[1], dict(zip(sinks, best[2])))
