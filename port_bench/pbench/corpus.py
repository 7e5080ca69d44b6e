"""The benchmark's traffic content, made from the seed.

``clustered_mask`` and ``filesystem_content`` are frozen copies of the
snapshot-chain content model of ``bench.py`` (kept here so that no later
change to the program or to that script moves the yardstick): ~35% text-like
runs, ~25% structured records, the rest incompressible, with clustered zero
extents added by the caller. ``chain_objects`` extends it to a chain of any
length cut into objects of any size; ``unique_objects`` draws every object
afresh from the same model.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def clustered_mask(rng, n_blocks: int, site_frac: float, mean_run: int) -> np.ndarray:
    mask = np.zeros(n_blocks, bool)
    n_sites = max(1, int(n_blocks * site_frac))
    starts = rng.integers(0, n_blocks, n_sites)
    lengths = rng.geometric(1.0 / mean_run, n_sites)
    for s, l in zip(starts, lengths):
        mask[s : s + l] = True
    return mask


def filesystem_content(rng, n_bytes: int, block: int, layout=None) -> np.ndarray:
    """~35% text-like runs, ~25% structured records, the rest incompressible
    (the caller adds ~25% clustered zero extents). ``layout`` (default: ``rng``)
    draws where the text and record runs lie; ``rng`` draws the bytes."""
    layout = rng if layout is None else layout
    out = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    n_blocks = n_bytes // block
    text = clustered_mask(layout, n_blocks, 0.35 / 24, 24)
    tmask = np.repeat(text, block)
    n_text = int(tmask.sum())
    if n_text:
        vocab = ((rng.integers(0, 256, (512, 8), dtype=np.uint8) & 0x3F) | 0x20).reshape(512, 8)
        toks = rng.integers(0, 512, n_text // 8 + 1)
        out[tmask] = vocab[toks].reshape(-1)[:n_text]
    rec = clustered_mask(layout, n_blocks, 0.25 / 24, 24) & ~text
    run_id = np.cumsum(rec & ~np.concatenate([[False], rec[:-1]]))
    out2d = out.reshape(n_blocks, block)
    for rid in np.unique(run_id[rec]):
        blocks = np.flatnonzero(rec & (run_id == rid))
        record = rng.integers(0, 256, 64, dtype=np.uint8)
        span = np.tile(record, (len(blocks) * block) // 64)
        edits = rng.integers(0, len(span), max(1, len(span) // 32))
        span[edits] = rng.integers(0, 256, len(edits), dtype=np.uint8)
        out2d[blocks] = span.reshape(len(blocks), block)
    return out


def _fresh_extent(rng, layout, mix: dict) -> np.ndarray:
    """One extent of a base snapshot, as [n_blocks, block] uint8."""
    block, n = mix["block_bytes"], mix["extent_bytes"]
    blocks = filesystem_content(rng, n, block, layout).reshape(n // block, block)
    blocks[clustered_mask(layout, n // block, mix["zero_frac"] / 16, 16)] = 0
    return blocks


def _cut(extent: np.ndarray, object_bytes: int) -> List[np.ndarray]:
    flat = extent.reshape(-1)
    return [flat[i : i + object_bytes].copy() for i in range(0, len(flat), object_bytes)]


def chain_objects(rng, layout, mix: dict) -> Iterator[List[np.ndarray]]:
    """Snapshots of a disk-image chain, each as its list of objects: the base
    snapshot (``extents_per_snapshot`` fresh extents), then each snapshot the
    previous one with clustered writes (``write_site_frac`` of the blocks
    start a run of mean ``write_run_blocks`` blocks of new content)."""
    n_blocks = mix["extent_bytes"] // mix["block_bytes"]
    snap = [_fresh_extent(rng, layout, mix) for _ in range(mix["extents_per_snapshot"])]
    while True:
        yield [o for e in snap for o in _cut(e, mix["object_bytes"])]
        nxt = []
        for e in snap:
            e2 = e.copy()
            mut = clustered_mask(layout, n_blocks, mix["write_site_frac"], mix["write_run_blocks"])
            e2[mut] = filesystem_content(rng, int(mut.sum()) * mix["block_bytes"], mix["block_bytes"], layout).reshape(-1, mix["block_bytes"])
            nxt.append(e2)
        snap = nxt


def unique_objects(rng, layout, mix: dict) -> Iterator[List[np.ndarray]]:
    """Groups of ``extents_per_snapshot`` fresh extents, cut into objects:
    no object repeats another's content (but for the zero extents that the
    content model itself holds)."""
    while True:
        yield [o for _ in range(mix["extents_per_snapshot"]) for o in _cut(_fresh_extent(rng, layout, mix), mix["object_bytes"])]


def make_objects(seed: int, mix: dict, n_base: int, n_window: int):
    """(base objects, window objects) of a mix: where the zero extents, text
    and record runs and the chain's writes lie, and how long each is, comes
    from the mix's ``layout_seed``, the same for every run; the bytes come
    from ``seed``. So every seed offers the same amounts of each kind of
    content and of new content, in other bytes. The base objects (the
    chain's base snapshot, or fresh warm-up objects) pass through the fleet
    in set-up; the window objects follow them in order."""
    rng, layout = np.random.default_rng(seed), np.random.default_rng(mix["layout_seed"])
    gen = (chain_objects if mix["content"] == "chain" else unique_objects)(rng, layout, mix)
    objs: List[np.ndarray] = []
    while len(objs) < n_base + n_window:
        objs.extend(next(gen))
    return objs[:n_base], objs[n_base : n_base + n_window]
