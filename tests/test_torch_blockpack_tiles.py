"""K-E ``blockpack_encode``'s tile rule, modelled on the CPU.

The kernel runs only on a card. It encodes each row in one pass over tiles
of ``T = bb * max(1, T0 // bb)`` bytes (``kernels.blockpack_tile_bytes``; the
last tile of a row may be shorter, and a block larger than T0 is a tile of
its own). Each tile classifies its blocks, sums its kept bytes (``bb`` for a
literal block, 1 for a constant block, 0 for a zero block), and finds its
offset ``off_u`` in the row by a decoupled look-back over 64-bit status
words (an aggregate, then an inclusive prefix; tile 0 of a row publishes its
inclusive prefix at once). It then writes exactly ``T_u`` output bytes and
waits for no other tile:

- its kept bytes, the literal run ``[off_u, E_u)`` with ``E_u = off_u + kept_u``;
- the mirrored zero range ``[n - (start_u + T_u) + E_u, n - start_u + off_u)``.

Across a row the zero ranges partition ``[n_lit, n)`` from the top down.

This file runs the same rule in a numpy model, with tiles visited in a
shuffled order, counts the writes of every output byte (each must be
written exactly once), and holds tags, literals and ``n_lit`` against the
JAX package's ``encode_device``, vmapped over the rows.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from skyplane_tpu.ops import blockpack as jblockpack
from skyplane_tpu_torch.ops import kernels

WINDOW = 128  # tiles a look-back round reads: four per lane of one warp
BLOCKS = [1, 4, 16, 512, 600, 4096, kernels.BLOCKPACK_TILE + 8192]  # the last: one block per tile
KINDS = ["zero", "const", "random", "mixed", "pattern"]


def _n_for(bb: int, t0: int) -> int:
    """A row length of two full tiles and a short last one (a block larger
    than the tile: three blocks)."""
    tile = bb * max(1, t0 // bb)
    if tile == bb and bb > t0:
        return 3 * bb
    return 2 * tile + bb * max(1, (tile // bb) // 2)


def _rows(kind: str, n: int, bb: int, rng) -> np.ndarray:
    """Two rows of one kind; a mixed row has zero, constant and literal blocks."""
    if kind == "zero":
        return np.zeros((2, n), np.uint8)
    if kind == "const":
        return np.stack([np.full(n, 0x5A, np.uint8), np.full(n, 0xFF, np.uint8)])
    if kind == "pattern":
        unit = rng.integers(0, 256, 1024, dtype=np.uint8)
        return np.stack([np.tile(unit, -(-n // 1024))[:n], np.tile(unit[:100], -(-n // 100))[:n]])
    rows = rng.integers(0, 256, (2, n), dtype=np.uint8)
    if kind == "mixed":
        for row in rows:
            blocks = row.reshape(-1, bb)
            pick = rng.integers(0, 3, len(blocks))
            blocks[pick == 0] = 0
            blocks[pick == 1] = rng.integers(1, 256, int((pick == 1).sum()), dtype=np.uint8)[:, None]
            blocks[-1] = 0  # a zero block after the last kept byte
    return rows


def tile_encode(data: np.ndarray, bb: int, t0: int, rng):
    """[B, n] uint8 -> (tags, literals, n_lit, writes) by the kernel's tile
    rule, tiles in a shuffled order; ``writes`` counts each output byte's
    stores."""
    b, n = data.shape
    tile = bb * max(1, t0 // bb)
    n_tiles = -(-n // tile)
    tags = np.full((b, n // bb), 255, np.uint8)
    literals = np.full((b, n), 0xEE, np.uint8)  # garbage: every byte must be written
    writes = np.zeros((b, n), np.int64)
    n_lit = np.full(b, -1, np.int64)
    flag = np.zeros((b, n_tiles), np.int64)  # 0 none, 1 aggregate, 2 inclusive
    value = np.zeros((b, n_tiles), np.int64)
    agg = np.zeros((b, n_tiles), np.int64)
    pending = [(r, u) for r in range(b) for u in range(n_tiles)]
    classified = {}
    while pending:
        i = int(rng.integers(len(pending)))
        r, u = pending[i]
        start = u * tile
        length = min(tile, n - start)
        if (r, u) not in classified:  # classify, stage the kept bytes, publish the aggregate
            blocks = data[r, start : start + length].reshape(-1, bb)
            same = (blocks == blocks[:, :1]).all(1)
            t = np.where(same, np.where(blocks[:, 0] == 0, 0, 1), 2).astype(np.uint8)
            tags[r, start // bb : start // bb + len(t)] = t  # one contiguous run
            kept = np.where(t == 2, bb, np.where(t == 1, 1, 0))
            run = np.concatenate([blocks[k] if t[k] == 2 else blocks[k, :1] for k in range(len(t)) if t[k]] or [[]])
            classified[(r, u)] = run.astype(np.uint8)
            agg[r, u] = kept.sum()
            flag[r, u], value[r, u] = (2 if u == 0 else 1), agg[r, u]
            continue
        off, base, done = 0, u - 1, u == 0
        while not done:  # the look-back: a window with an unpublished tile waits
            window = [base - k for k in range(WINDOW)]
            if any(idx >= 0 and flag[r, idx] == 0 for idx in window):
                break
            for idx in window:  # tile 0 is inclusive: the walk never passes it
                off += value[r, idx]
                if flag[r, idx] == 2:
                    done = True
                    break
            base -= WINDOW
        if not done:
            continue  # wait: another tile runs
        flag[r, u], value[r, u] = 2, off + agg[r, u]
        end = off + agg[r, u]
        literals[r, off:end] = classified[(r, u)]
        writes[r, off:end] += 1
        lo, hi = n - (start + length) + end, n - start + off
        assert hi - lo == length - agg[r, u]
        literals[r, lo:hi] = 0
        writes[r, lo:hi] += 1
        if start + length == n:
            n_lit[r] = end
        pending.pop(i)
    assert (flag == 2).all()
    return tags, literals, n_lit.astype(np.int32), writes


def _jax_encode(data: np.ndarray, bb: int):
    jtags, jlit, jn = jax.vmap(lambda r: jblockpack.encode_device(r, block_bytes=bb))(jnp.asarray(data))
    return np.asarray(jtags), np.asarray(jlit), np.asarray(jn)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bb", BLOCKS)
def test_tile_rule_writes_once_and_matches_encode_device(bb, kind):
    """The kernel's tile T0, and 1 KiB tiles (many tiles a row, so look-backs
    cross 128-tile windows and tiles run far out of order)."""
    rng = np.random.default_rng(bb * 7 + KINDS.index(kind))
    n = _n_for(bb, kernels.BLOCKPACK_TILE)
    data = _rows(kind, n, bb, rng)
    want = _jax_encode(data, bb)
    for t0 in (kernels.BLOCKPACK_TILE, 1024):
        tags, literals, n_lit, writes = tile_encode(data, bb, t0, rng)
        assert (writes == 1).all(), (t0, np.unique(writes))
        np.testing.assert_array_equal(tags, want[0])
        np.testing.assert_array_equal(literals, want[1])
        np.testing.assert_array_equal(n_lit, want[2])


@pytest.mark.parametrize("bb", BLOCKS)
def test_tile_bytes_and_short_last_tile(bb):
    """T is a whole number of blocks, at most T0 unless one block is larger;
    the model's rows end in a short tile (or three one-block tiles)."""
    tile = kernels.blockpack_tile_bytes(bb)
    assert tile % bb == 0
    assert tile <= kernels.BLOCKPACK_TILE or tile == bb
    n = _n_for(bb, kernels.BLOCKPACK_TILE)
    assert n % bb == 0
    assert n % tile != 0 or tile == bb
