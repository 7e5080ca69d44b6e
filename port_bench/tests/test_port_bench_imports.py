"""The run's check that neither JAX nor the JAX package is loaded compares
top-level module names whole; a run of the harness loads neither; and a
checkout without the program gives no result."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

from pbench.imports import forbidden_modules


def test_names_compared_whole():
    assert forbidden_modules(["skyplane_tpu_torch", "skyplane_tpu_torch.gateway", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["skyplane_tpu", "skyplane_tpu.ops.cdc", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "skyplane_tpu", "skyplane_tpu.ops.cdc"]


def test_a_run_loads_neither_in_a_subprocess():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from pbench.harness import main\n"
        "import skyplane_tpu_torch.gateway.gateway_daemon, skyplane_tpu_torch.ops.batch_runner\n"
        "from reference import recipe_ref\n"
        "from pbench.imports import forbidden_modules\n"
        "print(forbidden_modules())\n"
    ) % (str(ROOT), str(BENCH_DIR))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_fires_when_the_jax_package_is_loaded(tmp_path):
    """A module named ``skyplane_tpu`` in the run's process makes it exit
    non-zero with no result line."""
    fake = tmp_path / "skyplane_tpu"
    fake.mkdir()
    (fake / "__init__.py").write_text("")
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import skyplane_tpu\n"
        "assert skyplane_tpu.__file__.startswith(%r)\n"
        "from pbench.harness import main\n"
        "sys.exit(main(['--workload', 'direct.snapchain.bulk', '--seed', '1', '--seconds', '1', '--trace', '0',"
        " '--device', 'cpu', '--override', %r]))\n"
    ) % (str(tmp_path), str(ROOT), str(BENCH_DIR), str(tmp_path), json.dumps({"mix": {
        "extent_bytes": 262144, "extents_per_snapshot": 2, "object_bytes": 262144, "base_objects": 2,
        "disk_budget_bytes": 6 << 20, "drain_s": 30}}))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "skyplane_tpu" in r.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "direct.snapchain.bulk", "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "skyplane_tpu_torch" in r.stderr
