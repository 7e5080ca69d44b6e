"""The port's Azure, IBM Cloud and SCP path as a whole, on the CPU.

The provider dispatch of ``get_cloud_provider`` and the storage factory reach
the port's new classes; no refusal of these providers is left in the port; a
fresh process that imports every new module (with the SDK stand-ins of
``tests/torch_cloud_util.py`` on its path) loads neither jax nor the JAX
package; and the CPU rehearsal of ``chip_smoke.py`` phase 13: one
``pipeline("direct")`` multicast of 3 objects of 4 parts of 1 MiB from IBM
COS to Azure Blob and SCP object storage through three port daemons on
sandbox VMs (preinstalled, on the CPU) that the port's
``IBMCloudProvider``, ``AzureCloudProvider`` and ``SCPCloudProvider`` return,
every object checked byte for byte at both destinations.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_cloud_util import fake_sdk_modules, make_sandbox_provider

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "skyplane_tpu_torch"
NEW_MODULES = [
    "obj_store.azure_storage_account", "obj_store.azure_blob_interface", "obj_store.cos_interface",
    "obj_store.scp_interface", "compute.azure", "compute.azure.azure_auth", "compute.azure.azure_setup",
    "compute.azure.azure_cloud_provider", "compute.ibmcloud", "compute.ibmcloud.ibm_cloud_provider",
    "compute.scp", "compute.scp.scp_cloud_provider",
]
_BACKENDS = tuple(f"skyplane_tpu_torch.{m}" for m in (
    "obj_store.s3_interface", "obj_store.cos_interface", "obj_store.scp_interface", "obj_store.azure_blob_interface",
    "compute.azure.", "compute.ibmcloud.", "compute.scp."))


@pytest.fixture()
def sdk(tmp_path, monkeypatch):
    """The SDK stand-ins, the SCP data-plane settings (every endpoint on
    this host) and no SCP management credentials."""
    monkeypatch.setenv("SCP_OBS_ENDPOINT", "http://127.0.0.1:9")
    monkeypatch.setenv("SCP_API_ENDPOINT", "http://127.0.0.1:9")
    monkeypatch.setenv("SCP_ACCESS_KEY", "AK")
    monkeypatch.setenv("SCP_SECRET_KEY", "SK")
    monkeypatch.setenv("SCP_PROJECT_ID", "P1")
    monkeypatch.setenv("SCP_CREDENTIAL_FILE", str(tmp_path / "absent"))
    with fake_sdk_modules(tmp_path / "sdk", tmp_path / "store", also=_BACKENDS) as boto3:
        yield boto3


@pytest.mark.parametrize("name,cls", [("azure", "AzureCloudProvider"), ("ibmcloud", "IBMCloudProvider"),
                                      ("scp", "SCPCloudProvider")])
def test_get_cloud_provider_builds_the_ports_providers(sdk, name, cls):
    from skyplane_tpu_torch.compute.cloud_provider import get_cloud_provider

    provider = get_cloud_provider(name)
    assert type(provider).__name__ == cls
    assert type(provider).__module__.startswith(f"skyplane_tpu_torch.compute.{name}.")
    assert provider.provider_name == name
    sandbox = make_sandbox_provider(name, lambda tag: ("vm", tag))
    assert isinstance(sandbox, type(provider)) and sandbox.provision_instance(f"{name}:r1") == ("vm", f"{name}:r1")
    sandbox.setup_global(), sandbox.setup_region("r1"), sandbox.teardown_global()


@pytest.mark.parametrize("tag,bucket,cls,region_tag", [
    ("azure:infer", "acct/container", "AzureBlobInterface", "azure:infer"),
    ("cos:infer", "eu-de/bucket", "COSInterface", "cos:eu-de"),
    ("cos:us-south", "bucket", "COSInterface", "cos:us-south"),
    ("scp:infer", "bucket", "SCPInterface", "scp:kr-west-1"),
])
def test_factory_builds_the_ports_new_backends(sdk, tag, bucket, cls, region_tag):
    from skyplane_tpu_torch.obj_store.storage_interface import StorageInterface

    iface = StorageInterface.create(tag, bucket)
    assert type(iface).__name__ == cls and type(iface).__module__.startswith("skyplane_tpu_torch.obj_store.")
    assert iface.region_tag() == region_tag


def test_no_refusal_of_these_providers_is_left():
    import skyplane_tpu_torch.cli as cli_pkg

    # no refusal is left anywhere in the port since lint runs the port's
    # analysis: the refusal helper and its ROADMAP table are gone
    assert not hasattr(cli_pkg, "_ROADMAP_ITEMS") and not hasattr(cli_pkg, "not_ported")
    refusing = []
    for f in sorted(PORT.rglob("*.py")):
        text = f.read_text()
        assert '"6b"' not in text and "_NOT_PORTED" not in text, f
        if "not_ported(" in text:
            refusing.append(str(f.relative_to(PORT)))
    assert refusing == []


def test_multicloud_path_imports_no_jax(tmp_path):
    """In a fresh process with the stand-ins on its path: every new module
    imports, ``get_cloud_provider`` builds the three providers, the factory
    the three backends, with neither jax nor the JAX package imported; nor
    does any of these files name one in an import."""
    util = REPO / "tests" / "torch_cloud_util.py"
    code = (
        "import importlib, importlib.util, os, sys\n"
        f"spec = importlib.util.spec_from_file_location('torch_cloud_util', {str(util)!r})\n"
        "util = importlib.util.module_from_spec(spec); spec.loader.exec_module(util)\n"
        f"sys.path.insert(0, str(util.write_fake_sdk({str(tmp_path / 'sdk')!r})))\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module('skyplane_tpu_torch.' + m)\n"
        "from skyplane_tpu_torch.compute.cloud_provider import get_cloud_provider\n"
        "from skyplane_tpu_torch.obj_store.storage_interface import StorageInterface\n"
        "for name in ('azure', 'ibmcloud', 'scp'):\n"
        "    assert type(get_cloud_provider(name)).__module__.startswith('skyplane_tpu_torch.compute.' + name)\n"
        "    util.make_sandbox_provider(name, lambda tag: None)\n"
        "for tag, bucket in (('azure:infer', 'a/c'), ('cos:us-south', 'b'), ('scp:infer', 'b')):\n"
        "    assert type(StorageInterface.create(tag, bucket)).__module__.startswith('skyplane_tpu_torch.obj_store.')\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'skyplane_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO), "SCP_OBS_ENDPOINT": "http://127.0.0.1:9",
           "SCP_API_ENDPOINT": "http://127.0.0.1:9", "SCP_ACCESS_KEY": "AK", "SCP_SECRET_KEY": "SK",
           "SCP_PROJECT_ID": "P1", "SCP_CREDENTIAL_FILE": str(tmp_path / "absent")}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
    files = [PORT / (m.replace(".", "/") + ("/__init__.py" if m.count(".") == 1 and m.startswith("compute.")
                                            else ".py")) for m in NEW_MODULES]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else []
            for mod in names:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "skyplane_tpu"), f"{f.relative_to(REPO)} imports {mod}"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase13_multicast_rehearsal_on_the_cpu(monkeypatch):
    """``chip_smoke.multicloud_phase`` at 1 MiB parts on the CPU: the
    multicast lands every object byte-identical at Azure and SCP (the
    phase's own checks: block and part counts, no daemon error, every daemon
    on its device and gone after deprovisioning)."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "CHUNK_MB", 1)
    names = (*smoke.MULTICLOUD_ENV, "SKYPLANE_FAKE_S3_ROOT", "SKYPLANE_TPU_BOOTSTRAP_PIP_ARGS", "SCP_CREDENTIAL_FILE")
    before = {k: os.environ.get(k) for k in names}
    chunks = smoke.make_corpus(0)
    out = smoke.multicloud_phase(chunks, "cpu", "cpu", preinstalled=True)
    assert set(out["gbps_by_destination"]) == {"azure:infer", "scp:kr-west-1"}
    assert out["split"]["transfer"] > 0 and out["wall_s"] > 0
    assert {k: os.environ.get(k) for k in names} == before  # the phase puts back what it found
