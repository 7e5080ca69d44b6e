"""The port's static analysis against the JAX package's over whole trees,
on the CPU: both packages' ``run_paths`` (cache off) over ``skyplane_tpu/``
and over ``skyplane_tpu_torch/``, compared finding for finding (rule, path,
line, severity, suppression and reason; messages with the package name
normalised, ``u32-cast-missing``'s restated message aside — see
``tests/torch_analysis_util.py``). Each pass's wall time is printed.

Over ``skyplane_tpu/`` the two must be equal. Over ``skyplane_tpu_torch/``
they differ only where the port retargets a rule: the JAX pass flags
``addmod31`` and ``mulmod31`` in ``skyplane_tpu_torch/ops/u32.py`` (their
operands carry the port's int64 cast, which the JAX rule does not know),
and nothing else.
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest

import skyplane_tpu.analysis as ref_analysis
import skyplane_tpu_torch.analysis as port_analysis
from tests.torch_analysis_util import normalise

REPO_ROOT = Path(__file__).resolve().parents[1]


def _passes(tree: str):
    timed = {}
    for name, pkg in (("port", port_analysis), ("ref", ref_analysis)):
        t0 = time.perf_counter()
        report = pkg.run_paths([tree], use_cache=False)
        timed[name] = (report, time.perf_counter() - t0)
    print(
        f"{tree}: port pass {timed['port'][1]:.2f} s, JAX pass {timed['ref'][1]:.2f} s, "
        f"{timed['port'][0].files_checked} files"
    )
    return timed["port"][0], timed["ref"][0]


def _key(f):
    return (f.path, f.line, f.rule, f.message.replace("skyplane_tpu_torch", "skyplane_tpu"))


def _u32_cast_lines():
    """(line, parameter) of every JAX u32-cast-missing finding the port's
    int64 cast retires: the widening line of addmod31 and mulmod31, once
    for each operand, each function carrying ``p = p.to(torch.int64)``."""
    lines = (REPO_ROOT / "skyplane_tpu_torch" / "ops" / "u32.py").read_text().splitlines()
    out = set()
    for fn, op in (("addmod31", "a + b"), ("mulmod31", "a * b")):
        start = next(i for i, line in enumerate(lines) if line.startswith(f"def {fn}("))
        body = lines[start + 1 :]
        end = next(i for i, line in enumerate(body) if f"return fold31({op})" in line)
        casts = [line.split("#")[0].strip() for line in body[:end]]
        assert "a = a.to(torch.int64)" in casts and "b = b.to(torch.int64)" in casts, fn
        out |= {(start + 2 + end, "a", fn), (start + 2 + end, "b", fn)}
    return out


def test_parity_over_the_jax_package():
    port, ref = _passes(str(REPO_ROOT / "skyplane_tpu"))
    assert port.files_checked == ref.files_checked > 100
    got, want = [normalise(f) for f in port.findings], [normalise(f) for f in ref.findings]
    assert got == want
    assert ref.ok() and port.ok()


def test_parity_over_the_port_differs_only_on_the_int64_cast():
    port, ref = _passes(str(REPO_ROOT / "skyplane_tpu_torch"))
    assert port.files_checked == ref.files_checked > 100
    got = {_key(f): normalise(f) for f in port.findings}
    want = {_key(f): normalise(f) for f in ref.findings}
    assert len(got) == len(port.findings) and len(want) == len(ref.findings)
    only_port = [got[k] for k in got if k not in want]
    only_ref = [want[k] for k in want if k not in got]
    assert only_port == [], only_port
    u32 = "skyplane_tpu_torch/ops/u32.py"
    retired = {
        (f.line, f.message.split("'")[1], f.message.split("'")[3])
        for f in ref.findings
        if f.rule == "u32-cast-missing" and f.path.endswith(u32)
    }
    assert retired == _u32_cast_lines()
    assert all(d["rule"] == "u32-cast-missing" and d["path"].endswith(u32) for d in only_ref), only_ref
    assert len(only_ref) == len(retired) == 4
    for k in got:  # everything both report is equal in every field
        assert got[k] == want[k]
    assert port.ok() and [f.rule for f in ref.unsuppressed] == ["u32-cast-missing"] * 4
