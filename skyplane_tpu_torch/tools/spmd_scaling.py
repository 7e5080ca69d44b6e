"""The meshed batch runner's Gbps against device count: the twin of
``bench.py``'s ``bench_spmd_scaling``.

    python -m skyplane_tpu_torch.tools.spmd_scaling [--device cuda] [--counts 1,2,4,8] [--chunk-mb 1] [--reps 3]

For each count n, a ``DeviceBatchRunner(max_batch=8)`` over an n-position
mesh (``default_mesh``; none at n = 1) takes one window of 8 chunks from 8
threads at once, as gateway sender workers submit; the first window is held
byte-identical to the host path (``cdc_and_fps_host``), then ``reps`` windows
are timed by the host clock (each ends when every thread holds its digests).
One JSON line per point. On the card, the positions of a count up to the
cards present lie on distinct cards; a larger count repeats cards
(``entry.mesh_devices``) and its point is labelled as not scaling: a logical
mesh on one card runs its positions one after another.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import List, Sequence

import numpy as np
import torch

from skyplane_tpu_torch.entry import mesh_devices

COUNTS = (1, 2, 4, 8)
MAX_BATCH = 8


def point_label(devices: Sequence[torch.device]) -> str:
    cards = len({str(d) for d in devices})
    if devices[0].type == "cpu":
        return "cpu, not a device measurement"
    if cards == len(devices):
        return f"{cards} distinct card(s)"
    return "one card, not scaling" if cards == 1 else f"{len(devices)} positions on {cards} cards, not scaling"


def scaling_point(devices: Sequence[torch.device], chunk_bytes: int, reps: int) -> dict:
    """One point: the runner over ``devices`` (a mesh when more than one),
    checked byte-identical, then timed over ``reps`` windows."""
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.cdc import CDCParams, cdc_and_fps_host
    from skyplane_tpu_torch.parallel.datapath_spmd import default_mesh

    n = len(devices)
    mesh = default_mesh(list(devices)) if n > 1 else None
    params = CDCParams()
    # the per-window host recompute would be timed too: the check below is
    # this point's own identity pass
    saved = os.environ.pop("SKYPLANE_TPU_SPMD_CHECK", None)
    try:
        runner = DeviceBatchRunner(cdc_params=params, max_batch=MAX_BATCH, mesh=mesh, device=devices[0])
    finally:
        if saved is not None:
            os.environ["SKYPLANE_TPU_SPMD_CHECK"] = saved
    rng = np.random.default_rng(3)
    chunks = [rng.integers(0, 256, chunk_bytes, dtype=np.uint8) for _ in range(runner.max_batch)]

    def one_round():
        results = [None] * len(chunks)

        def sub(i):
            h = runner.submit(chunks[i])
            results[i] = (h.ends(), h.fps())

        threads = [threading.Thread(target=sub, args=(i,)) for i in range(len(chunks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    results = one_round()  # warm-up (the kernels' first launch) and the identity pass
    for i, ((ends, fps), chunk) in enumerate(zip(results, chunks)):
        ref_ends, ref_fps = cdc_and_fps_host(chunk, params)
        if not np.array_equal(np.asarray(ends), np.asarray(ref_ends)) or list(fps) != list(ref_fps):
            raise AssertionError(f"{n} device(s): chunk {i} differs from the host path")
    t0 = time.perf_counter()
    for _ in range(reps):
        one_round()
    dt = time.perf_counter() - t0
    total = reps * sum(len(c) for c in chunks)
    return {
        "n": n,
        "gbps": total * 8 / 1e9 / dt,
        "mesh": "x".join(str(s) for s in mesh.shape.values()) if mesh is not None else "1x1",
        "devices": [str(d) for d in devices],
        "label": point_label(devices),
        "identical": True,
        "windows": runner.counters()["batch_windows"],
    }


def spmd_scaling(device="cuda", counts: Sequence[int] = COUNTS, chunk_mb: float = 1, reps: int = 3) -> List[dict]:
    chunk_bytes = int(chunk_mb * (1 << 20))
    return [scaling_point(mesh_devices(n, device), chunk_bytes, reps) for n in counts]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--counts", default=",".join(str(c) for c in COUNTS))
    ap.add_argument("--chunk-mb", type=float, default=1)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    counts = [int(c) for c in args.counts.split(",") if c]
    for row in spmd_scaling(args.device, counts, args.chunk_mb, args.reps):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
