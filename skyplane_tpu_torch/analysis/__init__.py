"""Repo-aware static analysis of the port, the counterpart of the JAX
package's ``analysis/`` (pure standard library: it imports neither jax nor
torch), for the two bug classes unit tests are worst at catching:

  * concurrency — the gateway daemon is ~16 threaded modules sharing state
    through ``self.*`` attributes, locks, queues, and sockets; races and
    blocking-under-lock stalls survive any single-threaded test run.
  * tracer safety — Python side-effects inside code that is traced once and
    replayed (``@jax.jit``, ``torch.jit.trace``, CUDA graph capture) are
    silently baked in at trace or capture time (a ``time.time()`` call
    becomes a constant; a ``print`` fires once), and M31 arithmetic without
    an explicit int64 cast overflows on narrower tensors.

The framework (``core``) is a per-file AST walk with a checker registry,
``file:line`` findings, and ``# sklint: disable=<rule> -- <reason>``
suppressions (the reason is mandatory; a bare disable is itself a finding;
``--check-suppressions`` audits for stale ones). Checker families live in
``concurrency``, ``tracer``, ``spans``, and ``lockgraph`` — the last is a
whole-program pass (``ProjectChecker``): a lock-order graph over the
project-wide call graph (``callgraph``) with deadlock-cycle detection and
fork-safety rules, mirrored at runtime by ``obs/lockwitness.py``. The rule
names and severities are the JAX package's.

Run it as ``python -m skyplane_tpu_torch.analysis [paths...]`` (default:
``skyplane_tpu_torch``) or ``skyplane-tpu-torch lint``; tier-1
``tests/test_torch_analysis.py`` gates the port at zero unsuppressed
findings.
"""

from skyplane_tpu_torch.analysis.core import (  # noqa: F401
    AnalysisReport,
    Checker,
    Finding,
    ProjectChecker,
    RuleSpec,
    all_checkers,
    all_project_checkers,
    audit_suppressions,
    iter_rules,
    run_paths,
    run_source,
    run_sources,
)
