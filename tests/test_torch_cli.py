"""The port's command line (``skyplane_tpu_torch/cli``) against the JAX
package's, on the CPU, in process through ``click.testing.CliRunner``.

Both ``click`` trees are walked command by command: names, options, choices,
defaults and ``--help`` are equal once the package and program names are
normalised. The twins of ``tests/unit/test_cli_fallback.py`` run on both
packages. ``config``, ``sync --watch --spool``, the native-tool delegation of
``cp`` and ``cloud ls`` give the same output and the same files from both
CLIs, each over its own temporary config, and so do ``init``,
``deprovision`` and ``ssh`` on a host with no cloud credentials. ``lint``
runs the port's own static analysis and gives the JAX CLI's rules, exit
codes and findings. A fresh process that imports the port's CLI and runs its
commands imports neither jax nor the JAX package, and no ``requests`` before
a cloud command loads the SCP provider.

End-to-end runs (``cp`` through gateway daemons, ``timeline``, the progress
bar, ``serve``) are in ``tests/test_torch_cli_e2e.py``.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import click
import numpy as np
import pytest
from click.testing import CliRunner

REPO = Path(__file__).resolve().parents[1]
_ROOTS = {"port": "skyplane_tpu_torch", "ref": "skyplane_tpu"}
_PROGS = {"port": "skyplane-tpu-torch", "ref": "skyplane-tpu"}
PKGS = ["port", "ref"]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{_ROOTS[pkg]}.{name}")


def _main(pkg: str):
    return _mod(pkg, "cli.cli").main


def _walk(cmd, path=()):
    yield path, cmd
    if isinstance(cmd, click.Group):
        for name in sorted(cmd.commands):
            yield from _walk(cmd.commands[name], path + (name,))


def _normalise(text: str) -> str:
    """Package and program names to the JAX package's, whitespace runs to
    one space (click re-wraps a help line whose words changed length)."""
    text = text.replace(_ROOTS["port"], _ROOTS["ref"]).replace(_PROGS["port"], _PROGS["ref"])
    return " ".join(text.split())


def _invoke(pkg: str, args, **kw):
    return CliRunner().invoke(_main(pkg), list(args), prog_name=_PROGS[pkg], **kw)


_PATHS = [p for p, _ in _walk(_main("ref"))]


def test_both_trees_hold_the_same_commands():
    assert [p for p, _ in _walk(_main("port"))] == _PATHS
    assert len(_PATHS) == 28


def _param_view(p):
    t = p.type
    return {
        "kind": type(p).__name__,
        "name": p.name,
        "opts": p.opts,
        "secondary_opts": p.secondary_opts,
        "required": p.required,
        "nargs": p.nargs,
        "multiple": p.multiple,
        "default": p.default,
        "is_flag": getattr(p, "is_flag", None),
        "type": type(t).__name__,
        "choices": list(getattr(t, "choices", []) or []),
        "help": getattr(p, "help", None),
        "hidden": getattr(p, "hidden", None),
        "expose_value": p.expose_value,
    }


@pytest.mark.parametrize("path", _PATHS, ids=lambda p: "-".join(p) or "main")
def test_command_equals_the_jax_command(path):
    port = dict(_walk(_main("port")))[path]
    ref = dict(_walk(_main("ref")))[path]
    assert type(port) is type(ref)
    assert [_param_view(p) for p in port.params] == [_param_view(p) for p in ref.params]
    assert port.context_settings == ref.context_settings
    assert _normalise(port.help or "") == _normalise(ref.help or "")
    helps = {pkg: _invoke(pkg, path + ("--help",)) for pkg in PKGS}
    assert helps["port"].exit_code == helps["ref"].exit_code == 0
    assert _normalise(helps["port"].output) == _normalise(helps["ref"].output)


def test_version_prints_the_port_version():
    from skyplane_tpu_torch import __version__

    r = _invoke("port", ["--version"])
    assert r.exit_code == 0 and __version__ in r.output


# ---- twins of tests/unit/test_cli_fallback.py, on both packages ----


def _fallback(pkg):
    return _mod(pkg, "cli.impl.cp_replicate_fallback").fallback_cmd


def _with_tools(pkg, *tools):
    return mock.patch(f"{_ROOTS[pkg]}.cli.impl.cp_replicate_fallback._has", side_effect=lambda t: t in tools)


@pytest.mark.parametrize("pkg", PKGS)
def test_local_to_s3_uses_aws_cli(pkg):
    with _with_tools(pkg, "aws"):
        cmd = _fallback(pkg)("local:///data/dir/", "s3://bucket/prefix/", recursive=True, sync=False)
    assert cmd[:3] == ["aws", "s3", "cp"]
    assert "--recursive" in cmd and "/data/dir/" in cmd and "s3://bucket/prefix/" in cmd


@pytest.mark.parametrize("pkg", PKGS)
def test_s3_to_local_sync(pkg):
    with _with_tools(pkg, "aws"):
        cmd = _fallback(pkg)("s3://b/k/", "local:///out/", recursive=True, sync=True)
    assert cmd[:3] == ["aws", "s3", "sync"]
    assert "--recursive" not in cmd  # sync is inherently recursive


@pytest.mark.parametrize("pkg", PKGS)
def test_gs_prefers_gcloud_then_gsutil(pkg):
    with _with_tools(pkg, "gcloud"):
        cmd = _fallback(pkg)("local:///d/", "gs://b/", recursive=True, sync=False)
    assert cmd[:3] == ["gcloud", "storage", "cp"]
    with _with_tools(pkg, "gsutil"):
        cmd = _fallback(pkg)("local:///d/", "gs://b/", recursive=True, sync=False)
    assert cmd[:2] == ["gsutil", "-m"]


@pytest.mark.parametrize("pkg", PKGS)
def test_azure_uses_azcopy(pkg):
    with _with_tools(pkg, "azcopy"):
        cmd = _fallback(pkg)("azure://acct/cont/k", "local:///out", recursive=False, sync=False)
    assert cmd[0] == "azcopy" and cmd[1] == "copy"
    assert "acct.blob.core.windows.net" in cmd[2]


@pytest.mark.parametrize("pkg", PKGS)
def test_no_tool_returns_none(pkg):
    with _with_tools(pkg):
        assert _fallback(pkg)("local:///d/", "s3://b/", recursive=True, sync=False) is None


@pytest.mark.parametrize("pkg", PKGS)
def test_cross_cloud_not_delegated(pkg):
    with _with_tools(pkg, "aws", "gcloud"):
        assert _fallback(pkg)("s3://a/", "gs://b/", recursive=True, sync=False) is None


# ---- commands over a temporary config, both packages ----


@pytest.fixture
def configs(tmp_path, monkeypatch):
    """Each package's ``config_paths`` rebound to its own temporary root (the
    module binds its paths at import) and its lazy config emptied."""
    roots = {}
    for pkg in PKGS:
        cp = _mod(pkg, "config_paths")
        root = tmp_path / f"cfg_{pkg}"
        root.mkdir()
        monkeypatch.setattr(cp, "config_root", root)
        monkeypatch.setattr(cp, "config_path", root / "config")
        monkeypatch.setattr(cp._LazyCloudConfig, "_inner", None)
        roots[pkg] = root
    return roots


_CONFIG_STEPS = [
    ("config", "list"),
    ("config", "set", "max_instances", "3"),
    ("config", "set", "dedup", "no"),
    ("config", "set", "compress", "tpu"),
    ("config", "set", "no_such_flag", "1"),
    ("config", "set", "num_connections", "many"),
    ("config", "get", "max_instances"),
    ("config", "get", "dedup"),
    ("config", "get", "no_such_flag"),
    ("config", "list"),
]


def test_config_set_get_list_match(configs):
    for step in _CONFIG_STEPS:
        got = {}
        for pkg in PKGS:
            _mod(pkg, "config_paths")._LazyCloudConfig._inner = None  # a fresh process per command
            got[pkg] = _invoke(pkg, step)
        assert got["port"].exit_code == got["ref"].exit_code, step
        assert _normalise(got["port"].output) == _normalise(got["ref"].output), step
    files = {pkg: (configs[pkg] / "config").read_bytes() for pkg in PKGS}
    assert files["port"] == files["ref"]
    assert b"max_instances = 3" in files["port"]


_WATCH_CASES = {
    "watch": ["sync", "local:///data/a/", "local:///data/b/", "--watch", "--interval", "2.5", "--spool", "{spool}"],
    "watch_tenant": ["sync", "/data/a", "/data/b", "--watch", "--spool", "{spool}", "--tenant", "00112233aabbccdd"],
    "no_spool": ["sync", "/data/a", "/data/b", "--watch"],
    "two_destinations": ["sync", "/data/a", "/data/b", "/data/c", "--watch", "--spool", "{spool}"],
    "missing_spool": ["sync", "/data/a", "/data/b", "--watch", "--spool", "{spool}/nope"],
}


@pytest.mark.parametrize("case", list(_WATCH_CASES))
def test_sync_watch_spool_file_matches(tmp_path, case):
    got, files = {}, {}
    for pkg in PKGS:
        spool = tmp_path / f"spool_{pkg}"
        spool.mkdir()
        args = [a.replace("{spool}", str(spool)) for a in _WATCH_CASES[case]]
        got[pkg] = _invoke(pkg, args)
        files[pkg] = {p.name: p.read_text() for p in spool.iterdir()}
    assert got["port"].exit_code == got["ref"].exit_code
    outputs = {pkg: got[pkg].output.replace(str(tmp_path / f"spool_{pkg}"), "SPOOL") for pkg in PKGS}
    assert _normalise(outputs["port"]) == _normalise(outputs["ref"])
    assert files["port"] == files["ref"]
    if case.startswith("watch"):
        (name, text), = files["port"].items()
        assert name.startswith("watch_") and name in got["port"].output
        spec = json.loads(text)
        assert spec["type"] == "sync_watch" and ("tenant_id" in spec) == (case == "watch_tenant")
    else:
        assert got["port"].exit_code == 1 and not files["port"]


_DELEGATIONS = {
    "cp_recursive": ["cp", "-r", "local:///{src}/", "local:///{dst}/", "-y"],
    "cp_one_file": ["cp", "local:///{src}/f0.bin", "local:///{dst}/g.bin", "-y"],
    "sync": ["sync", "local:///{src}/", "local:///{dst}/", "-y"],
}


@pytest.mark.parametrize("case", list(_DELEGATIONS))
def test_cp_without_flags_delegates_to_the_same_native_command(tmp_path, configs, monkeypatch, case):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "f0.bin").write_bytes(b"x" * 1000)
    calls = []

    def fake_run(cmd, *a, **kw):
        calls.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    got = {}
    for pkg in PKGS:
        args = [a.replace("{src}", str(tmp_path / "src").lstrip("/")).replace("{dst}", str(tmp_path / "dst").lstrip("/"))
                for a in _DELEGATIONS[case]]
        got[pkg] = _invoke(pkg, args)
    assert len(calls) == 2 and calls[0] == calls[1], calls
    assert calls[0][0] in ("rsync", "cp") and calls[0][-1].startswith(str(tmp_path / "dst"))
    assert got["port"].exit_code == got["ref"].exit_code == 0
    assert _normalise(got["port"].output) == _normalise(got["ref"].output)
    assert "delegating to native tool" in got["port"].output


def _tree(root: Path, seed: int):
    rng = np.random.default_rng(seed)
    for rel, n in (("a.bin", 4096), ("b.bin", 10), ("sub/c.bin", 70000), ("sub/deeper/d.bin", 0)):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        os.utime(root / rel, (1.7e9, 1.7e9))  # listings print the mtime


@pytest.mark.parametrize("args", [
    ("cloud", "ls", "local:///{root}/"),
    ("cloud", "ls", "local:///{root}/sub"),
    ("cloud", "rm", "local:///{root}/b.bin"),
    ("cloud", "rm", "-r", "local:///{root}/sub"),
    ("cloud", "mb", "local:///{root}/newbucket"),
], ids=["ls", "ls_prefix", "rm", "rm_recursive", "mb"])
def test_cloud_posix_commands_match(tmp_path, configs, args):
    root = tmp_path / "site"
    _tree(root, 3)
    got, listings = {}, {}
    for pkg in PKGS:
        got[pkg] = _invoke(pkg, [a.replace("{root}", str(root).lstrip("/")) for a in args])
        listings[pkg] = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        _tree(root, 3)  # the same tree for the other package
    assert got["port"].exit_code == got["ref"].exit_code == 0, got["port"].output
    assert got["port"].output == got["ref"].output
    assert listings["port"] == listings["ref"]
    if args[1] == "ls":
        assert got["port"].output.strip().endswith("objects")


# ---- lint: the port's own static analysis, against the JAX CLI's ----


def test_lint_lists_the_same_rules_and_severities_as_the_jax_cli(configs):
    """``lint --list-rules`` through both CLIs: the same rules, in the same
    order, with the same severities (the descriptions of the retargeted
    rules are restated for the port)."""
    got = {pkg: _invoke(pkg, ["lint", "--list-rules"]) for pkg in PKGS}
    assert got["port"].exit_code == got["ref"].exit_code == 0, got["port"].output
    rules = {pkg: [tuple(line.split()[:2]) for line in got[pkg].output.splitlines() if line.strip()] for pkg in PKGS}
    assert rules["port"] == rules["ref"]
    assert len(rules["port"]) > 20 and {sev for _, sev in rules["port"]} == {"error", "warning"}


_LINT_FIXTURE = """import threading
import time


class Pump:
    def __init__(self):
        self._lock = threading.Lock()

    def start(self):
        threading.Thread(target=self.loop).start()

    def loop(self):
        with self._lock:
            time.sleep(1)
        x = 1  # sklint: disable=bare-except-in-loop -- stale: no loop here
        return x
"""


@pytest.mark.parametrize("flags", [[], ["--check-suppressions"]], ids=["plain", "check_suppressions"])
def test_lint_on_a_fixture_file_exits_and_reports_as_the_jax_cli(configs, monkeypatch, tmp_path, flags):
    """``lint FILE --json REPORT`` through both CLIs on a file with findings
    (and a stale suppression): the same exit code, the same findings in the
    JSON report and the same rendered lines. Each package lints with a cache
    file of its own."""
    src = tmp_path / "fixture.py"
    src.write_text(_LINT_FIXTURE)
    got, reports = {}, {}
    for pkg in PKGS:
        monkeypatch.setenv("SKYPLANE_TPU_SKLINT_CACHE", str(tmp_path / f"cache-{pkg}.json"))
        out = tmp_path / f"report-{pkg}.json"
        got[pkg] = _invoke(pkg, ["lint", str(src), "--json", str(out), *flags])
        reports[pkg] = json.loads(out.read_text())
    assert got["port"].exit_code == got["ref"].exit_code == 1
    # the rendered findings; the summary line carries each run's wall time
    shown = {pkg: [line for line in got[pkg].output.splitlines() if not line.startswith("checked ")] for pkg in PKGS}
    assert shown["port"] == shown["ref"] and len(shown["port"]) >= 2
    assert reports["port"]["findings"] == reports["ref"]["findings"]
    rules = {f["rule"] for f in reports["port"]["findings"]}
    assert {"thread-no-daemon", "blocking-under-lock"} <= rules
    assert ("stale-suppression" in rules) == bool(flags)
    assert set(reports["port"]["rule_counts"]) == set(reports["ref"]["rule_counts"])


# ---- init, deprovision and ssh: the cloud commands the IBM Cloud, SCP and
# Azure providers complete, against the JAX CLI ----


_CLOUD_COMMANDS = {
    "init": (["init"], "n\nn\nn\nn\n"),  # GCP, R2, IBM Cloud, SCP declined (AWS: no boto3)
    "init_non_interactive": (["init", "--non-interactive"], None),
    "deprovision": (["deprovision"], None),
    "ssh": (["ssh"], None),  # Azure enabled: its provider lists no gateway here
}


def _no_outside_host(monkeypatch, pkg):
    """The package's network probes answer nothing and its credential
    detection sees nothing; no socket may connect off the host."""
    import socket

    networking = _mod(pkg, "utils.networking")
    monkeypatch.setattr(networking, "get_public_ip", lambda *a, **k: None)
    monkeypatch.setattr(networking, "query_which_cloud", lambda *a, **k: None)
    cli_init = _mod(pkg, "cli.cli_init")
    monkeypatch.setattr(cli_init, "_detect_aws", lambda: False)
    monkeypatch.setattr(cli_init, "_detect_gcp", lambda: None)
    monkeypatch.setattr(cli_init, "_detect_azure", lambda: False)
    connect = socket.socket.connect

    def local_only(self, address):
        if isinstance(address, tuple) and address[0] not in ("127.0.0.1", "localhost", "::1"):
            raise AssertionError(f"a cloud command connected to {address}")
        return connect(self, address)

    monkeypatch.setattr(socket.socket, "connect", local_only)


@pytest.mark.parametrize("case", list(_CLOUD_COMMANDS))
def test_cloud_commands_run_as_the_jax_cli_does(configs, monkeypatch, tmp_path, case):
    """``init`` (scripted and ``--non-interactive``), ``deprovision`` and
    ``ssh`` with Azure enabled, on a host with no cloud credentials: the
    same exit code, output and written config from both CLIs. No command of
    the port's CLI refuses any more."""
    from types import SimpleNamespace

    for var in ("IBM_API_KEY", "SCP_ACCESS_KEY", "SCP_SECRET_KEY", "SCP_PROJECT_ID", "AZURE_SUBSCRIPTION_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("IBM_CONFIG_FILE", str(tmp_path / "bluemix" / "ibm_credentials"))
    monkeypatch.setenv("SCP_CREDENTIAL_FILE", str(tmp_path / "scp" / "scp_credential"))
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(tmp_path / "aws" / "credentials"))
    monkeypatch.setitem(sys.modules, "boto3", None)
    args, answers = _CLOUD_COMMANDS[case]
    got = {}
    for pkg in PKGS:
        _no_outside_host(monkeypatch, pkg)
        # cli_init binds the config path at its import
        monkeypatch.setattr(_mod(pkg, "cli.cli_init"), "config_path", configs[pkg] / "config")
        if case == "ssh":
            monkeypatch.setattr(_mod(pkg, "cli.cli_cloud"), "cloud_config",
                                SimpleNamespace(aws_enabled=False, gcp_enabled=False, azure_enabled=True))
            provider_mod = _mod(pkg, "compute.azure.azure_cloud_provider")
            monkeypatch.setattr(provider_mod.AzureCloudProvider, "get_matching_instances", lambda self, **kw: [])
        r = _invoke(pkg, args, input=answers)
        config = configs[pkg] / "config"
        # the console wraps long lines where the paths fall: compare without whitespace
        text = "".join(r.output.split()).replace(str(configs[pkg]), "CFG").replace("skyplane_tpu_torch", "skyplane_tpu")
        got[pkg] = (r.exit_code, text, config.read_text() if config.exists() else None)
    assert got["port"] == got["ref"], (got["port"][1], got["ref"][1])
    assert "is not ported" not in got["port"][1]
    if case.startswith("init"):
        assert got["port"][0] == 0 and got["port"][2] is not None, got["port"][1]
    else:
        assert got["port"][0] in (0, 1)


def test_cloud_bucket_refuses_with_the_factory_message(configs, monkeypatch):
    """An S3 bucket with no ``boto3`` (``None`` in ``sys.modules``, both
    packages' S3 backends imported afresh): both CLIs print the factory's
    message naming the SDK, and exit 1."""
    import sys

    monkeypatch.setitem(sys.modules, "boto3", None)
    for root in ("skyplane_tpu_torch", "skyplane_tpu"):
        monkeypatch.delitem(sys.modules, f"{root}.obj_store.s3_interface", raising=False)
    got = {pkg: _invoke(pkg, ["cloud", "ls", "s3://bucket/prefix"]) for pkg in PKGS}
    assert got["port"].exit_code == got["ref"].exit_code == 1
    assert got["port"].output == got["ref"].output
    assert "s3 support requires the boto3 package" in got["port"].output


# ---- a fresh process: no jax, no JAX package, no requests ----


def test_cli_imports_no_jax_nor_requests(tmp_path):
    """Import the port's CLI, run ``--help`` of every command, and run the
    bodies of the commands that need no gateway; then list what was
    imported."""
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "f.bin").write_bytes(b"f" * 100)
    (tmp_path / "spool").mkdir()
    (tmp_path / "fleet").mkdir()
    (tmp_path / "lintme.py").write_text("x = 1\n")
    code = (
        "import sys, click\n"
        "from click.testing import CliRunner\n"
        "from skyplane_tpu_torch.cli.cli import main\n"
        "def walk(cmd, path=()):\n"
        "    yield path\n"
        "    if isinstance(cmd, click.Group):\n"
        "        for n in sorted(cmd.commands):\n"
        "            yield from walk(cmd.commands[n], path + (n,))\n"
        "r = CliRunner()\n"
        "for p in walk(main):\n"
        "    assert r.invoke(main, list(p) + ['--help']).exit_code == 0, p\n"
        f"root = {str(tmp_path)!r}\n"
        "runs = [['config', 'list'], ['cloud', 'ls', 'local://' + root + '/site/'],\n"
        "        ['sync', root + '/site', root + '/out', '--watch', '--spool', root + '/spool'],\n"
        "        ['trace', 'export', '-o', root + '/t.json'], ['timeline', '--fleet-dir', root + '/fleet'],\n"
        "        ['experiments', 'query', 'local:a', 'local:b'], ['lint', root + '/lintme.py']]\n"
        "def run(args):\n"
        "    res = r.invoke(main, args)\n"
        "    print(args, res.exit_code, res.output.strip()[:200])\n"
        "    assert res.exception is None or isinstance(res.exception, SystemExit), (args, repr(res.exception))\n"
        "for args in runs:\n"
        "    run(args)\n"
        "def loaded(*roots):\n"
        "    return sorted(n for n in sys.modules if n.split('.')[0] in roots)\n"
        "print('requests before the cloud commands', loaded('requests'))\n"
        "no_requests = not loaded('requests')\n"
        "# the cloud commands, with the network probes and credential detection\n"
        "# answering nothing and no socket allowed off the host: the SCP\n"
        "# provider signs its open-API calls through requests\n"
        "import socket\n"
        "from skyplane_tpu_torch.utils import networking\n"
        "from skyplane_tpu_torch.cli import cli_init\n"
        "networking.get_public_ip = lambda *a, **k: None\n"
        "networking.query_which_cloud = lambda *a, **k: None\n"
        "cli_init._detect_aws, cli_init._detect_gcp, cli_init._detect_azure = (lambda: False), (lambda: None), (lambda: False)\n"
        "_connect = socket.socket.connect\n"
        "def _local(self, address):\n"
        "    assert not isinstance(address, tuple) or address[0] in ('127.0.0.1', 'localhost', '::1'), address\n"
        "    return _connect(self, address)\n"
        "socket.socket.connect = _local\n"
        "for args in (['init', '--non-interactive'], ['ssh'], ['deprovision']):\n"
        "    run(args)\n"
        "bad = loaded('jax', 'jaxlib', 'skyplane_tpu')\n"
        "print('bad', bad)\n"
        "sys.exit(1 if bad or not no_requests else 0)\n"
    )
    env = {**os.environ, "SKYPLANE_TPU_CONFIG_ROOT": str(tmp_path / "cfg"),
           "SKYPLANE_TPU_SKLINT_CACHE": str(tmp_path / "sklint-cache.json"),
           "IBM_CONFIG_FILE": str(tmp_path / "ibm_credentials"), "SCP_CREDENTIAL_FILE": str(tmp_path / "scp_credential")}
    for var in ("IBM_API_KEY", "SCP_ACCESS_KEY", "SCP_SECRET_KEY", "SCP_PROJECT_ID"):
        env.pop(var, None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "bad []" in r.stdout


# ---- every copied module keeps the reference's names ----

_COPIED = ["cli.cli", "cli.cli_transfer", "cli.cli_cloud", "cli.cli_init", "cli.impl.cp_replicate_fallback",
           "cli.impl.progress_bar", "cli.experiments.latency_grid", "cli.experiments.throughput_grid",
           "utils.networking"]
_ADDED = {
    "utils.networking": {"_request", "_TRANSPORT_ERRORS", "Dict", "Tuple"},
}


def _names(mod):
    return {n for n, v in vars(mod).items() if not n.startswith("__") and not isinstance(v, type(json))}


@pytest.mark.parametrize("name", _COPIED)
def test_copied_module_keeps_the_reference_names(name):
    pn, rn = _names(_mod("port", name)), _names(_mod("ref", name))
    assert pn - rn == _ADDED.get(name, set()), f"added: {sorted(pn - rn)}"
    assert rn - pn == set(), f"missing: {sorted(rn - pn)}"
