"""The plain reference works out the same segments and fingerprints as the
program, on the program's host path, for the benchmark's content and for
edge cases; the reference itself imports nothing of the program."""

import ast

import numpy as np
import pytest

from conftest import BENCH_DIR

from pbench import corpus
from reference import recipe_ref

CDC = {"min_bytes": 4096, "avg_bytes": 16384, "max_bytes": 65536}
MIX = {"block_bytes": 4096, "extent_bytes": 1 << 20, "extents_per_snapshot": 2, "object_bytes": 1 << 20,
       "zero_frac": 0.25, "write_site_frac": 0.004, "write_run_blocks": 8, "content": "chain", "layout_seed": 18}


def program_recipe(data: np.ndarray):
    from skyplane_tpu_torch.ops.cdc import CDCParams, cdc_and_fps_host

    ends, fps = cdc_and_fps_host(data, CDCParams(CDC["min_bytes"], CDC["avg_bytes"], CDC["max_bytes"]))
    return list(zip(np.diff(np.concatenate([[0], ends])).tolist(), fps))


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((BENCH_DIR / "reference" / "recipe_ref.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in mods} <= {"__future__", "hashlib", "functools", "typing", "numpy"}


@pytest.mark.parametrize("content", ["chain", "unique"])
def test_reference_equals_program_on_the_content_model(content):
    base, window = corpus.make_objects(2**31 + 11, dict(MIX, content=content), 2, 2)
    for obj in base + window:
        assert recipe_ref.recipe(obj, CDC) == program_recipe(obj)


@pytest.mark.parametrize("data", [
    np.zeros(300_000, np.uint8),
    np.full(200_000, 0xFF, np.uint8),
    np.random.default_rng(1).integers(0, 256, 5000, dtype=np.uint8),
    np.random.default_rng(2).integers(0, 256, 70_000, dtype=np.uint8),
    np.tile(np.arange(256, dtype=np.uint8), 1024),
], ids=["zeros", "ones", "short", "one_past_max", "ramp"])
def test_reference_equals_program_on_edge_cases(data):
    assert recipe_ref.recipe(data, CDC) == program_recipe(data)


def test_gear_hash_equals_the_classic_loop():
    data = np.random.default_rng(3).integers(0, 256, 2000, dtype=np.uint8)
    table, h, want = recipe_ref.gear_table(), 0, []
    for b in data.tolist():
        h = ((h << 1) + int(table[b])) & 0xFFFFFFFF
        want.append(h)
    assert recipe_ref.gear_hashes(data).tolist() == want


def test_lanes_equal_horner():
    data = np.random.default_rng(4).integers(0, 256, 3000, dtype=np.uint8)
    ends = np.asarray([700, 701, 2500, 3000])
    lanes = recipe_ref.segment_lanes(data, ends, 65536)
    start = 0
    for si, end in enumerate(ends.tolist()):
        for li, base in enumerate(recipe_ref.lane_bases()):
            acc = 0
            for b in data[start:end].tolist():
                acc = (acc * base + b) % recipe_ref.M31
            assert lanes[si, li] == acc
        start = end
