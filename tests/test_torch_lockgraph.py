"""Twins of ``tests/unit/test_lockgraph.py`` for the port's whole-program
lock-order pass (``skyplane_tpu_torch/analysis/lockgraph.py``): cycle /
no-cycle / alias / cross-class / cross-module / suppression fixtures, the
fork-safety rules, and the callgraph-propagated held-set semantics.

Each fixture is a minimal program shape the ABBA-deadlock gate must classify
correctly. Every fixture goes through both packages' analysis
(``tests/torch_analysis_util.py``), which must give equal findings; the
port's are asserted. The port's zero-findings gate lives in
tests/test_torch_analysis.py.
"""

from __future__ import annotations

import pytest

from tests.torch_analysis_util import run_source, run_sources


def rules_of(src: str, path: str = "fixture.py"):
    return sorted({f.rule for f in run_source(src, path) if not f.suppressed})


def findings_of(src: str, rule: str, path: str = "fixture.py"):
    return [f for f in run_source(src, path) if f.rule == rule and not f.suppressed]


# ------------------------------------------------------------ cycle / no-cycle


ABBA_TWO_CLASSES = """
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.peer = None
    def one(self):
        with self._lock:
            self.peer.poke_b()
    def poke_a(self):
        with self._lock:
            pass

class B:
    def __init__(self):
        self._lock = threading.Lock()
        self.friend = A()
    def poke_b(self):
        with self._lock:
            pass
    def two(self):
        with self._lock:
            self.friend.poke_a()
"""


def test_lock_order_cycle_fires_on_cross_class_abba():
    found = findings_of(ABBA_TWO_CLASSES, "lock-order-cycle")
    assert found, "ABBA nesting across two classes must report a cycle"
    # both witness paths present: the forward edge and the reverse path
    assert any("A._lock -> B._lock" in f.message and "reverse path" in f.message for f in found)


def test_lock_order_cycle_reports_both_directions():
    lines = {f.line for f in findings_of(ABBA_TWO_CLASSES, "lock-order-cycle")}
    assert len(lines) >= 2, "each half of the ABBA pair gets its own suppressible finding"


def test_no_cycle_when_order_is_consistent():
    src = """
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.peer = None
    def one(self):
        with self._lock:
            self.peer.poke_b()
    def other(self):
        with self._lock:
            self.peer.poke_b()

class B:
    def __init__(self):
        self._lock = threading.Lock()
    def poke_b(self):
        with self._lock:
            pass
"""
    assert "lock-order-cycle" not in rules_of(src)
    assert "nested-foreign-lock-call" not in rules_of(src)


def test_cycle_through_two_level_call_chain():
    src = """
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.b = None
    def entry(self):
        with self._lock:
            self.hop()
    def hop(self):
        self.b.deep_b()
    def take_a(self):
        with self._lock:
            pass

class B:
    def __init__(self):
        self._lock = threading.Lock()
        self.a = A()
    def deep_b(self):
        with self._lock:
            pass
    def back(self):
        with self._lock:
            self.a.take_a()
"""
    assert "lock-order-cycle" in rules_of(src)


def test_cycle_via_acquire_release_spans():
    src = """
import threading

class C:
    def __init__(self):
        self.alpha = threading.Lock()
        self.beta = threading.Lock()
    def forward(self):
        self.alpha.acquire()
        with self.beta:
            pass
        self.alpha.release()
    def backward(self):
        self.beta.acquire()
        with self.alpha:
            pass
        self.beta.release()
"""
    assert "lock-order-cycle" in rules_of(src)


def test_release_ends_the_held_span():
    src = """
import threading

class C:
    def __init__(self):
        self.alpha = threading.Lock()
        self.beta = threading.Lock()
    def forward(self):
        self.alpha.acquire()
        self.alpha.release()
        with self.beta:
            pass
    def backward(self):
        with self.beta:
            pass
        with self.alpha:
            pass
"""
    assert "lock-order-cycle" not in rules_of(src)


# ------------------------------------------------------------------- aliasing


def test_condition_aliases_its_underlying_lock():
    # cond wraps lock -> same graph node: nesting them is reentrancy, not an
    # order edge, and must NOT report a cycle
    src = """
import threading

class S:
    def __init__(self):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
    def a(self):
        with self.cond:
            pass
    def b(self):
        with self.lock:
            pass
"""
    assert "lock-order-cycle" not in rules_of(src)


def test_attribute_rebinding_aliases_the_same_node():
    src = """
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._alias = self._lock
    def a(self):
        with self._alias:
            self.take()
    def take(self):
        with self._lock:
            pass
"""
    # alias -> same node -> reentrant, not a self-cycle
    assert "lock-order-cycle" not in rules_of(src)


def test_wrap_shim_is_transparent_to_the_inventory():
    # the runtime witness shim must not blind the static pass
    src = ABBA_TWO_CLASSES.replace(
        "self._lock = threading.Lock()",
        'self._lock = lockcheck.wrap(threading.Lock(), "x")',
    )
    assert "lock-order-cycle" in rules_of("from skyplane_tpu_torch.obs import lockwitness as lockcheck\n" + src)


# ------------------------------------------------- nested-foreign-lock-call


def test_nested_foreign_fires_when_both_directions_exist():
    assert findings_of(ABBA_TWO_CLASSES, "nested-foreign-lock-call")


def test_nested_foreign_quiet_on_single_direction():
    src = """
import threading

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.peer = None
    def one(self):
        with self._lock:
            self.peer.poke_b()

class B:
    def __init__(self):
        self._lock = threading.Lock()
    def poke_b(self):
        with self._lock:
            pass
"""
    assert "nested-foreign-lock-call" not in rules_of(src)


def test_nested_foreign_fires_without_a_lock_level_cycle():
    # C holds l1 and calls into D (takes l2); D holds l3 and calls into C
    # (takes l4): no cycle among the four nodes, but the class PAIR nests in
    # both directions — exactly the "no established order" hazard
    src = """
import threading

class C:
    def __init__(self):
        self.l1 = threading.Lock()
        self.l4 = threading.Lock()
        self.d = None
    def go(self):
        with self.l1:
            self.d.enter_d()
    def take_l4(self):
        with self.l4:
            pass

class D:
    def __init__(self):
        self.l2 = threading.Lock()
        self.l3 = threading.Lock()
        self.c = C()
    def enter_d(self):
        with self.l2:
            pass
    def back(self):
        with self.l3:
            self.c.take_l4()
"""
    rules = rules_of(src)
    assert "nested-foreign-lock-call" in rules
    assert "lock-order-cycle" not in rules


# --------------------------------------------------- module-level + multi-file


def test_module_level_lock_participates_in_the_graph():
    src = """
import threading

_GLOBAL = threading.Lock()

class A:
    def __init__(self):
        self._lock = threading.Lock()
    def one(self):
        with self._lock:
            with _GLOBAL:
                pass
    def two(self):
        with _GLOBAL:
            with self._lock:
                pass
"""
    found = findings_of(src, "lock-order-cycle")
    assert found and any("fixture._GLOBAL" in f.message for f in found)


def test_cross_module_cycle_via_run_sources():
    mod_a = """
import threading
from b import B

class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.b = B()
    def one(self):
        with self._lock:
            self.b.poke_b()
    def take_a(self):
        with self._lock:
            pass
"""
    mod_b = """
import threading

class B:
    def __init__(self):
        self._lock = threading.Lock()
        self.a = None
    def poke_b(self):
        with self._lock:
            pass
    def two(self):
        with self._lock:
            self.a.take_a()
"""
    report = run_sources([("a.py", mod_a), ("b.py", mod_b)])
    cycles = [f for f in report.findings if f.rule == "lock-order-cycle"]
    assert cycles, "the pass must stitch call edges across modules"
    assert {f.path for f in cycles} == {"a.py", "b.py"}


# ---------------------------------------------------------------- suppression


def test_suppression_silences_the_cycle_at_its_witness_line():
    src = ABBA_TWO_CLASSES.replace(
        "            self.peer.poke_b()",
        "            self.peer.poke_b()  # sklint: disable=lock-order-cycle,nested-foreign-lock-call -- B is only reachable after A is sealed (construction-ordered)",
    ).replace(
        "            self.friend.poke_a()",
        "            self.friend.poke_a()  # sklint: disable=lock-order-cycle,nested-foreign-lock-call -- same construction-order invariant, reverse half",
    )
    assert "lock-order-cycle" not in rules_of(src)
    assert "nested-foreign-lock-call" not in rules_of(src)
    # the findings still exist, marked suppressed with their reasons
    suppressed = [f for f in run_source(src, "fixture.py") if f.rule == "lock-order-cycle" and f.suppressed]
    assert suppressed and all(f.suppression_reason for f in suppressed)


# ------------------------------------------------------------ fork-with-threads


FORK_AND_THREADS = """
import multiprocessing
import threading

def serve():
    threading.Thread(target=print, daemon=True).start()

def shard():
    p = multiprocessing.Process(target=print)
    p.start()
"""


def test_fork_with_threads_fires_without_spawn_guard():
    assert "fork-with-threads" in rules_of(FORK_AND_THREADS)


def test_fork_with_threads_quiet_with_spawn_guard():
    guarded = 'import multiprocessing\nmultiprocessing.set_start_method("spawn")\n' + FORK_AND_THREADS
    assert "fork-with-threads" not in rules_of(guarded)
    ctx = FORK_AND_THREADS + '\n\ndef make():\n    return multiprocessing.get_context("spawn")\n'
    assert "fork-with-threads" not in rules_of(ctx)


def test_fork_with_threads_quiet_without_threads():
    src = """
import multiprocessing

def shard():
    p = multiprocessing.Process(target=print)
    p.start()
"""
    assert "fork-with-threads" not in rules_of(src)


# -------------------------------------------------------- lock-held-across-fork


def test_lock_held_across_fork_fires_inside_with_block():
    src = """
import os
import threading

_LOCK = threading.Lock()

def bad():
    with _LOCK:
        os.fork()
"""
    found = findings_of(src, "lock-held-across-fork")
    assert found and "os.fork" in found[0].message


def test_lock_held_across_fork_fires_through_a_call_chain():
    src = """
import multiprocessing
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
    def spawn_worker(self):
        p = multiprocessing.Process(target=print)
        p.start()
    def resize(self):
        with self._lock:
            self.spawn_worker()
"""
    found = findings_of(src, "lock-held-across-fork")
    assert found and any("Pump._lock" in f.message for f in found)


def test_lock_held_across_fork_quiet_when_fork_is_outside_the_lock():
    src = """
import multiprocessing
import threading

class Pump:
    def __init__(self):
        self._lock = threading.Lock()
    def resize(self):
        with self._lock:
            n = 2
        p = multiprocessing.Process(target=print)
        p.start()
"""
    assert "lock-held-across-fork" not in rules_of(src)


# --------------------------------------------------------------- rule plumbing


@pytest.mark.parametrize(
    "rule",
    ["lock-order-cycle", "nested-foreign-lock-call", "lock-held-across-fork", "fork-with-threads"],
)
def test_new_rules_are_registered(rule):
    from skyplane_tpu_torch.analysis import iter_rules

    assert rule in {r.name for r in iter_rules()}


def test_plain_attribute_copy_does_not_mint_a_lock_node():
    """`self.conn = cfg.conn` (a socket, a file, anything) must not become a
    phantom lock node — a context-managed non-lock would otherwise produce
    false lock-order-cycle errors on a deadlock-free program."""
    src = """
import threading

class Worker:
    def __init__(self, cfg):
        self._lock = threading.Lock()
        self.conn = cfg.conn
    def a(self):
        with self.conn:
            with self._lock:
                pass
    def b(self):
        with self._lock:
            with self.conn:
                pass
"""
    assert "lock-order-cycle" not in rules_of(src)
