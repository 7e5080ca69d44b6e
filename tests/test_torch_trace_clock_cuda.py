"""The spans and the device trace share one clock, on the card.

Marked ``cuda``: needs an NVIDIA GPU and nvcc, skips elsewhere (decided in
a fixture, never at import). Run without the repo's conftest, which imports
jax:

    python -m pytest --noconftest -m cuda tests/test_torch_trace_clock_cuda.py -q -s

Windows of one 8 MiB row go through the batch runner at tracer sample 1
under ``torch.profiler``, 20 ms apart. Every device operation a window
enqueued must start after the span that enqueued it (``device.stage`` for
the row's upload, ``fused.dispatch`` for the rest) and end before the span
that waited for it (``device.stage`` for the synchronous upload,
``fused.readback`` for the rest). The test prints the largest skew (how far
any operation fell outside its bracket, 0 when none did) and the tightest
margins, as one JSON line.
"""

import json
import time

import numpy as np
import pytest
import torch

import skyplane_tpu_torch.obs.tracer as tracer_mod
from skyplane_tpu_torch.obs import configure_tracer
from skyplane_tpu_torch.obs.device_trace import device_ops
from skyplane_tpu_torch.ops import kernels
from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
from skyplane_tpu_torch.ops.cdc import CDCParams

pytestmark = pytest.mark.cuda

ROW = 8 << 20
WINDOWS = 12
GAP_S = 0.02
# the clocks agree when no operation falls outside its bracket by more than this
TOLERANCE_NS = 100_000


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    try:
        kernels._nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    kernels.build()
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def traced():
    saved = tracer_mod._tracer
    yield configure_tracer(sample=1.0)
    tracer_mod._tracer = saved


def test_device_operations_fall_inside_the_spans_that_launched_and_awaited_them(dev, traced):
    from torch.profiler import ProfilerActivity, profile

    runner = DeviceBatchRunner(cdc_params=CDCParams(), max_batch=8, device=dev)
    rng = np.random.default_rng(11)
    rows = [rng.integers(0, 256, ROW, dtype=np.uint8) for _ in range(WINDOWS)]
    warm = runner.submit(rows[0])  # the first window builds and loads the kernels
    warm.ends(), warm.fps()
    torch.cuda.synchronize(dev)
    traced.reset()
    ids = [f"{w:032x}" for w in range(WINDOWS)]
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        for w, row in enumerate(rows):
            with traced.span("chunk", trace_id=ids[w], cat="sender"):
                h = runner.submit(row)
                h.ends(), h.fps()
            time.sleep(GAP_S)
        torch.cuda.synchronize(dev)
    finally:
        prof.stop()
    ops = device_ops(prof)
    spans = traced.span_records()

    def one(name, cid):
        (s,) = [s for s in spans if s["name"] == name and s["chunk_id"] == cid]
        return s

    windows = [(one("device.stage", cid), one("fused.dispatch", cid), one("fused.readback", cid)) for cid in ids]
    assert ops, "the profiler recorded no device operation"
    assigned = [[] for _ in range(WINDOWS)]
    for op in ops:
        # the window this operation belongs to: the nearest bracket (windows
        # are GAP_S apart, far wider than any skew this test tolerates)
        _, start, end = op
        w = min(range(WINDOWS), key=lambda i: max(windows[i][0]["start_ns"] - start, end - windows[i][2]["end_ns"], 0))
        assigned[w].append(op)
    skew, margins = 0, {"start": [], "end": []}
    for (stage, dispatch, readback), window_ops in zip(windows, assigned):
        assert len(window_ops) >= 2 and "HtoD" in window_ops[0][0], window_ops  # the row's upload comes first
        for k, (name, start, end) in enumerate(window_ops):
            opened, closed = (stage["start_ns"], stage["end_ns"]) if k == 0 else (dispatch["start_ns"], readback["end_ns"])
            margins["start"].append(start - opened)
            margins["end"].append(closed - end)
            skew = max(skew, opened - start, end - closed)
    per_window = [len(a) for a in assigned]
    report = {
        "device": torch.cuda.get_device_name(dev),
        "torch": torch.__version__,
        "ops": len(ops),
        "ops_per_window": sorted(set(per_window)),
        "largest_skew_ns": skew,
        "tightest_start_margin_ns": min(margins["start"]),
        "tightest_end_margin_ns": min(margins["end"]),
        "median_start_margin_ns": float(np.median(margins["start"])),
        "median_end_margin_ns": float(np.median(margins["end"])),
    }
    print("trace_clock " + json.dumps(report), flush=True)
    assert skew <= TOLERANCE_NS, report
