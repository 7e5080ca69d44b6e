"""K-AB ``gear_compact``'s algorithm, modelled on the CPU.

The kernel runs only on a card. It computes call A in one pass. Each thread
owns one 32-byte word and runs its local Gear state from zero,
L_k = (L_{k-1} << 1) + G[b_k]; it takes the left neighbour word's last state
F_prev (lane 0 of each warp forms it from the 32 bytes in front of the warp,
as sum_j G[b_j] << (31 - j)); and it recombines the true hash as
h_k = (F_prev << (k+1)) + L_k mod 2^32. Blocks take 256 KiB chunks of a row
by ticket, count the candidates per (8 KiB sub-tile, warp), and find each
chunk's offset in its row by a decoupled look-back over 64-bit status words
(aggregate, then inclusive prefix), reading 128 chunks a round.

This file holds the same algebra and the same offset rule in a test-local
torch/numpy model, with chunks visited in a shuffled order, and checks it
with exact equality against the JAX package: ``gear_hash(pallas=False)``,
``gear_hash_pallas(interpret=True)`` across its 64 Ki tile boundary, and
``_candidates_impl(_pallas=False)``. ``gear_compact_plain`` (the kernel's
plain version) is held against ``_candidates_impl`` on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skyplane_tpu.ops import fused_cdc as jfused
from skyplane_tpu.ops import gear as jgear
from skyplane_tpu.ops.pallas_kernels import TILE, gear_hash_pallas
from skyplane_tpu_torch import state
from skyplane_tpu_torch.ops import kernels
from skyplane_tpu_torch.ops.cdc import CDCParams
from skyplane_tpu_torch.ops.fused_cdc import candidate_cap

U32 = 0xFFFFFFFF
WORD = 32  # bytes per thread
WARP = 32  # words per warp
SUB_BYTES = 8192  # a sub-tile: one word per thread of a 256-thread block
CHUNK_BYTES = 1 << 18  # the kernel's chunk: 32 sub-tiles
WINDOW = 128  # chunks a look-back round reads: four per lane
TABLES = state.device_tables("cpu")
GEAR = TABLES.gear  # [256] int64
BUCKETS = [1 << 16, 1 << 18]
MASK_BITS = [4, 8, 14]


def _rows(bucket: int, seed: int):
    """Random rows with lens 0, 1, 31, 32, 33, 8191, 8192, 8193 and full, then
    a full row with a zero extent and a constant run. Bytes past a row's
    length stay random: the kernel must mask them by ``lens``."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 31, 32, 33, 8191, 8192, 8193, bucket, bucket]
    rows = rng.integers(0, 256, (len(lens), bucket), dtype=np.uint8)
    rows[-1, 1000:20000] = 0
    rows[-1, 30000:40000] = 0x5A
    return rows, np.array(lens, np.int32)


def word_hashes(rows: np.ndarray) -> np.ndarray:
    """[B, N] bytes -> [B, N] hashes by K-AB's word algebra."""
    b, n = rows.shape
    g = GEAR[torch.from_numpy(rows).long()].view(b, n // WORD, WORD)
    local = torch.empty_like(g)  # L_k of each word, from a zero state
    h = torch.zeros_like(g[..., 0])
    for k in range(WORD):
        h = ((h << 1) + g[..., k]) & U32
        local[..., k] = h
    f = local[..., -1]  # F = L_31: the hash at the word's last byte
    f_prev = torch.zeros_like(f)
    f_prev[:, 1:] = f[:, :-1]  # the shuffle from the left lane
    # lane 0 of each warp: the 32 bytes in front of the warp, one a lane,
    # G[b_j] << (31 - j) summed; zero at the row start
    first = torch.arange(WARP, n // WORD, WARP)
    halo = ((g[:, first - 1, :] << torch.arange(WORD - 1, -1, -1)) & U32).sum(-1) & U32
    assert torch.equal(halo, f[:, first - 1])
    f_prev[:, first] = halo
    out = local.clone()
    for k in range(WORD - 1):  # h_k = (F_prev << (k+1)) + L_k; at k = 31 F_prev shifts out
        out[..., k] = ((f_prev << (k + 1)) + local[..., k]) & U32
    return out.view(b, n).numpy()


def lookback_compact(valid: np.ndarray, cap: int, rng, chunk_bytes: int = CHUNK_BYTES) -> np.ndarray:
    """[B, N] candidate mask -> [B, cap+1] packed rows, by K-AB's offset rule
    with chunks visited in a shuffled order.

    Each chunk counts its candidates per (sub-tile, warp) span of 1 KiB and
    publishes the sum as an aggregate (chunk 0 of a row: an inclusive prefix
    at once), then looks back over windows of 128 chunks in front of it. A
    window with an unpublished chunk waits (here: the chunk is put back and
    another runs); otherwise the chunk adds the values back to the nearest
    inclusive prefix, or all 128 aggregates and the next window. A span
    writes its positions at offset + its prefix in the chunk + their rank
    while below cap, and none when its first slot is past cap; the row's
    last chunk writes the padding and the true count."""
    b, n = valid.shape
    n_chunks = -(-n // chunk_bytes)
    span_bytes = WORD * WARP
    spans = valid.reshape(b, n // span_bytes, span_bytes).sum(-1)
    per_chunk = chunk_bytes // span_bytes
    counts = np.array([[spans[r, c * per_chunk : (c + 1) * per_chunk].sum() for c in range(n_chunks)] for r in range(b)])
    flag = np.zeros((b, n_chunks), np.int64)  # 0 none, 1 aggregate, 2 inclusive
    value = np.zeros((b, n_chunks), np.int64)
    offset = np.full((b, n_chunks), -1, np.int64)
    pending = [(r, c) for r in range(b) for c in range(n_chunks)]
    published = set()
    while pending:
        i = int(rng.integers(len(pending)))
        r, c = pending[i]
        if (r, c) not in published:  # publish the aggregate
            published.add((r, c))
            flag[r, c], value[r, c] = (2 if c == 0 else 1), counts[r, c]
            if c == 0:
                offset[r, c] = 0
                pending.pop(i)
            continue
        excl, base, done = 0, c - 1, False
        while not done:
            window = [base - k for k in range(WINDOW)]
            if any(idx >= 0 and flag[r, idx] == 0 for idx in window):
                break  # a chunk in front is not published yet: wait
            for idx in window:  # chunk 0 is inclusive: the walk never passes it
                excl += value[r, idx]
                if flag[r, idx] == 2:
                    done = True
                    break
            base -= WINDOW
        if done:
            flag[r, c], value[r, c] = 2, excl + counts[r, c]
            offset[r, c] = excl
            pending.pop(i)
    assert (flag == 2).all()
    np.testing.assert_array_equal(value[:, -1], counts.sum(-1))

    out = np.full((b, cap + 1), -1, np.int64)
    for r, c in rng.permutation([(r, c) for r in range(b) for c in range(n_chunks)]):
        first_span = c * per_chunk
        n_spans = min(per_chunk, spans.shape[1] - first_span)
        pre = np.concatenate([[0], np.cumsum(spans[r, first_span : first_span + n_spans])[:-1]])
        for k in range(n_spans):
            first = offset[r, c] + pre[k]
            if spans[r, first_span + k] == 0 or first >= cap:
                continue
            lo = (first_span + k) * span_bytes
            pos = np.flatnonzero(valid[r, lo : lo + span_bytes]) + lo
            slots = first + np.arange(len(pos))
            out[r, slots[slots < cap]] = pos[slots < cap]
        if c == n_chunks - 1:
            total = offset[r, c] + counts[r, c]
            out[r, min(total, cap) : cap] = n
            out[r, cap] = total
    assert (out >= 0).all()  # every slot written exactly by the rule
    return out.astype(np.int32)


def _jax_call_a(rows, lens, mask_bits, cap):
    return np.asarray(
        jfused._candidates_impl(jnp.asarray(rows), jnp.asarray(lens), mask_bits=mask_bits, cap=cap, _pallas=False)
    )


def _caps(bucket: int, count: int):
    """16, exactly the count, the count + 1, and the gateway's cap."""
    return sorted({16, max(1, count), count + 1, candidate_cap(bucket, CDCParams())})


@pytest.mark.parametrize("bucket", BUCKETS)
def test_word_recombination_matches_gear_hash(bucket):
    rows, _ = _rows(bucket, bucket + 1)
    got = word_hashes(rows)
    for i in (0, 8, 9):
        want = np.asarray(jgear.gear_hash(jnp.asarray(rows[i]), pallas=False))
        np.testing.assert_array_equal(got[i], want.astype(np.int64))
    np.testing.assert_array_equal(got[8, :5000], jgear.gear_hash_np(rows[8, :5000]).astype(np.int64))


def test_word_recombination_matches_pallas_interpret_across_tiles():
    """Four 64 Ki Pallas tiles: the kernel's warp halos and word shuffles
    against the Pallas kernel's halo carry at each tile boundary."""
    rows, _ = _rows(4 * TILE, 3)
    got = word_hashes(rows[8:])
    for i in range(2):
        pallas = np.asarray(gear_hash_pallas(jnp.asarray(rows[8 + i]), interpret=True)).astype(np.int64)
        np.testing.assert_array_equal(got[i], pallas)
        for b in (TILE, 2 * TILE, 3 * TILE):
            np.testing.assert_array_equal(got[i, b - 40 : b + 40], pallas[b - 40 : b + 40])


@pytest.mark.parametrize("mask_bits", MASK_BITS)
@pytest.mark.parametrize("bucket", BUCKETS)
def test_lookback_model_matches_candidates_impl(bucket, mask_bits):
    rows, lens = _rows(bucket, 10 * bucket + mask_bits)
    h = word_hashes(rows)
    valid = ((h >> (32 - mask_bits)) == 0) & (np.arange(bucket)[None, :] < lens[:, None])
    rng = np.random.default_rng(mask_bits)
    count = int(valid[8].sum())
    for cap in _caps(bucket, count):
        want = _jax_call_a(rows, lens, mask_bits, cap)
        np.testing.assert_array_equal(lookback_compact(valid, cap, rng), want)
    # 1 KiB chunks: 64 or 256 a row, so look-backs cross 128-chunk windows
    np.testing.assert_array_equal(lookback_compact(valid, cap, rng, chunk_bytes=1024), want)


@pytest.mark.parametrize("mask_bits", MASK_BITS)
@pytest.mark.parametrize("bucket", BUCKETS)
def test_gear_compact_plain_matches_candidates_impl(bucket, mask_bits):
    rows, lens = _rows(bucket, 20 * bucket + mask_bits)
    batch, lens_t = torch.from_numpy(rows), torch.from_numpy(lens)
    full = kernels.gear_compact_plain(batch, lens_t, TABLES, mask_bits, bucket).numpy()
    caps = _caps(bucket, int(full[8, bucket]))
    for cap in caps:
        got = kernels.gear_compact(batch, lens_t, TABLES, mask_bits, cap).numpy()  # a CPU batch: the plain version
        np.testing.assert_array_equal(got, _jax_call_a(rows, lens, mask_bits, cap))
    if mask_bits == 4:  # dense: the full rows overflow the gateway's cap and keep their true count
        assert (full[8:, bucket] > candidate_cap(bucket, CDCParams())).all()
