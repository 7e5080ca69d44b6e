"""Twin runners for the port's static analysis: each runs one input through
``skyplane_tpu_torch.analysis`` and through the JAX package's
``skyplane_tpu.analysis``, asserts that the two packages' findings are
equal, and returns the port's.

"Equal" is exact on rule, path, line, severity, suppressed flag and
suppression reason, and on the message once the package name is
normalised. One rule's message is restated for the port and compared
without it: ``u32-cast-missing``, whose port message names the int64 cast
of ``skyplane_tpu_torch/ops/u32.py`` (it is checked to say so). Inputs
written for the port's retargeted forms (``torch.jit.trace``, CUDA graph
capture, the int64 recast) use ``run_both`` and state what differs.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

import skyplane_tpu.analysis as ref_analysis
import skyplane_tpu_torch.analysis as port_analysis
from skyplane_tpu.analysis.__main__ import main as ref_main
from skyplane_tpu_torch.analysis import AnalysisReport, Finding, audit_suppressions, iter_rules  # noqa: F401
from skyplane_tpu_torch.analysis.__main__ import main as port_main

#: rules whose message the port restates (compared on everything else)
RESTATED = {"u32-cast-missing"}


def normalise(finding) -> dict:
    d = finding.as_dict()
    d["message"] = d["message"].replace("skyplane_tpu_torch", "skyplane_tpu")
    if d["rule"] in RESTATED:
        d["message"] = "<restated>"
    return d


def _check_restated(findings) -> None:
    for f in findings:
        if f.rule == "u32-cast-missing":
            assert "int64" in f.message and "fold31" in f.message, f.message


def assert_same(port: Sequence, ref: Sequence, what: str = "") -> None:
    got, want = [normalise(f) for f in port], [normalise(f) for f in ref]
    assert got == want, f"port and JAX analysis differ{' on ' + what if what else ''}:\nport {got}\nref  {want}"
    _check_restated(port)


def run_source(source: str, display: str = "<string>", rules: Optional[Set[str]] = None) -> List:
    port = port_analysis.run_source(source, display, rules=rules)
    assert_same(port, ref_analysis.run_source(source, display, rules=rules), display)
    return port


def run_both(source: str, display: str = "<string>", rules: Optional[Set[str]] = None) -> Tuple[List, List]:
    """(port findings, JAX findings), not compared: for the retargeted forms."""
    return port_analysis.run_source(source, display, rules=rules), ref_analysis.run_source(source, display, rules=rules)


def run_sources(named_sources: Sequence[Tuple[str, str]], rules: Optional[Set[str]] = None):
    port = port_analysis.run_sources(named_sources, rules=rules)
    ref = ref_analysis.run_sources(named_sources, rules=rules)
    assert_same(port.findings, ref.findings, "run_sources")
    assert port.files_checked == ref.files_checked
    return port


def _ref_cache_path(cache_path) -> Optional[Path]:
    # each package keeps its own cache file: they differ in fingerprint, so
    # one shared file would be wiped by each run in turn
    return None if cache_path is None else Path(f"{cache_path}.ref")


def run_paths(paths, rules=None, check_suppressions=False, use_cache=False, cache_path=None):
    port = port_analysis.run_paths(
        paths, rules=rules, check_suppressions=check_suppressions, use_cache=use_cache, cache_path=cache_path
    )
    ref = ref_analysis.run_paths(
        paths,
        rules=rules,
        check_suppressions=check_suppressions,
        use_cache=use_cache,
        cache_path=_ref_cache_path(cache_path),
    )
    assert_same(port.findings, ref.findings, f"run_paths({paths})")
    assert port.files_checked == ref.files_checked
    strip = lambda info: {k: v for k, v in info.items() if k != "path"}  # noqa: E731
    assert strip(port.cache_info) == strip(ref.cache_info)
    return port


def _with_json_path(argv: Sequence[str], suffix: str) -> List[str]:
    out = list(argv)
    if "--json" in out:
        i = out.index("--json") + 1
        if out[i] != "-":
            out[i] = out[i] + suffix
    return out


def lint_main(argv: Sequence[str]) -> int:
    """The JAX CLI on ``argv`` (its output captured and kept apart, a
    ``--json FILE`` written beside FILE), then the port's CLI: the exit
    codes and the JSON reports' findings must be equal. Each package lints
    with a cache file of its own in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        saved = os.environ.get("SKYPLANE_TPU_SKLINT_CACHE")
        try:
            os.environ["SKYPLANE_TPU_SKLINT_CACHE"] = os.path.join(tmp, "ref.json")
            sink = io.StringIO()
            with contextlib.redirect_stdout(sink), contextlib.redirect_stderr(io.StringIO()):
                ref_rc = ref_main(_with_json_path(argv, ".ref"))
            os.environ["SKYPLANE_TPU_SKLINT_CACHE"] = os.path.join(tmp, "port.json")
            rc = port_main(list(argv))
        finally:
            if saved is None:
                os.environ.pop("SKYPLANE_TPU_SKLINT_CACHE", None)
            else:
                os.environ["SKYPLANE_TPU_SKLINT_CACHE"] = saved
    assert rc == ref_rc, f"port lint exit {rc}, JAX lint exit {ref_rc} on {list(argv)}"
    if "--json" in argv:
        path = list(argv)[list(argv).index("--json") + 1]
        if path != "-":
            port_report = json.loads(Path(path).read_text())
            ref_report = json.loads(Path(path + ".ref").read_text())
            assert [_norm_dict(f) for f in port_report["findings"]] == [_norm_dict(f) for f in ref_report["findings"]]
            assert set(port_report["rule_counts"]) == set(ref_report["rule_counts"])
    return rc


def _norm_dict(d: dict) -> dict:
    return normalise(Finding(**d))
