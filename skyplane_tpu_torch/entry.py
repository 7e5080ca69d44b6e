"""Entry point of the port's flagship step: the twin of ``__graft_entry__.entry()``.

``entry(device)`` returns ``(fn, args)``: ``fn`` is ``datapath_step`` (gear
CDC candidates, blockpack encode and fixed-stride fingerprints over a batch
of chunks, ``ops/pipeline.py``) at the reference entry's parameters, and
``args`` is the reference entry's example batch (seed 0, row 1 half zero) on
``device``. The multi-device dry run (``dryrun_multichip``) comes with the
multi-GPU data path.
"""

from __future__ import annotations

import numpy as np
import torch

from skyplane_tpu_torch.ops.backend import resolve_device
from skyplane_tpu_torch.ops.pipeline import datapath_step
from skyplane_tpu_torch.state import device_tables

BATCH = 2
CHUNK_BYTES = 128 * 1024
BLOCK_BYTES = 512
FP_SEG_BYTES = 64 * 1024
MASK_BITS = 16


def example_batch() -> np.ndarray:
    """The reference entry's input: [2, 128 KiB] uint8, seed 0, row 1's first half zero."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(BATCH, CHUNK_BYTES), dtype=np.uint8)
    x[1, : CHUNK_BYTES // 2] = 0  # exercise the zero-suppression path
    return x


def entry(device="cuda"):
    """Return ``(fn, args)`` for one batch step on ``device`` ("cuda" by default)."""
    dev = resolve_device(device)
    tables = device_tables(dev)

    def fn(batch_u8: torch.Tensor):
        return datapath_step(
            batch_u8, block_bytes=BLOCK_BYTES, fp_seg_bytes=FP_SEG_BYTES, mask_bits=MASK_BITS, tables=tables
        )

    return fn, (torch.from_numpy(example_batch()).to(dev),)
