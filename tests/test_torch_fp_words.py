"""The fingerprint kernels' word arithmetic, modelled on the CPU.

K-C ``segment_fp`` and K-D ``segment_fp_fixed`` take the 8 lanes of each
64-byte word from an integer tensor-core product with the constant
``word_limbs`` matrix, then scale each word by one power read from
``word_powers``; a word that a segment end cuts in two goes through the
product twice (its second piece with the first zeroed) and takes
``inverse_powers`` for its first piece; words where more than one end falls,
or where the power clamp begins, go byte by byte. The kernels run only on a
card, so this file holds the same algebra in a test-local torch model (int64
matmul, limb recombination, fold, per-word powers) and checks it, with exact
equality, against the JAX package: ``_fp_impl`` (K-C's layout) and
``fixed_stride_lanes(pallas=False)`` (K-D's), on seeded adversarial rows.
It also checks the derived tables against the JAX package's power tables.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skyplane_tpu.ops import fingerprint as jfp
from skyplane_tpu.ops import fused_cdc as jfused
from skyplane_tpu_torch import state

M31 = (1 << 31) - 1
MAX = jfp.MAX_SEGMENT_BYTES
TABLES = state.device_tables("cpu")
POWERS = torch.from_numpy(jfp._power_tables().astype(np.int64))  # [8, MAX], the reference's own
ORDER = list(state.WORD_LANE_ORDER)


def _word_values(words: torch.Tensor) -> torch.Tensor:
    """[n, 64] bytes -> [n, 8] W_l = sum_k b_k r_l^(63-k) mod M31, as the
    kernels form it: a u8 x u8 product with word_limbs, then the limbs."""
    d = words.long() @ TABLES.word_limbs.long()  # [n, 32], each < 64 * 255 * 255 < 2^22
    assert d.numel() == 0 or int(d.max()) < 1 << 22
    w = sum(d[:, q::4] << (8 * q) for q in range(4))  # [n, 8] (column 4l + q)
    return w % M31


def _power(x: torch.Tensor) -> torch.Tensor:
    """[n] power indices -> [n, 8] r_l^x, read from the kernels' word_powers table."""
    rows = TABLES.word_powers.long() & 0xFFFFFFFF  # [64, MAX / 64, 8] in ORDER
    got = rows[x % 64, x // 64]
    out = torch.empty_like(got)
    out[:, ORDER] = got
    return out


def _inverse(d: torch.Tensor) -> torch.Tensor:
    got = (TABLES.inverse_powers.long() & 0xFFFFFFFF)[d]
    out = torch.empty_like(got)
    out[:, ORDER] = got
    return out


def _per_byte(row: np.ndarray, lo: int, hi: int, ends: np.ndarray, acc: torch.Tensor) -> None:
    """Bytes [lo, hi) one at a time: slot = first end past the byte."""
    for i in range(lo, hi):
        b = int(row[i])
        j = int(np.searchsorted(ends, i, side="right"))
        if b == 0 or j >= len(ends):
            continue
        idx = min(int(ends[j]) - 1 - i, MAX - 1)
        acc[j] += b * POWERS[:, idx]


def model_segment_fp(batch: np.ndarray, ends_slots: np.ndarray) -> np.ndarray:
    """K-C's layout by words: [B, bucket] u8 + [B, n_slots] ascending ends -> [B, n_slots, 8] u32."""
    b, bucket = batch.shape
    out = np.zeros((b, ends_slots.shape[1], 8), np.uint32)
    for r in range(b):
        row = batch[r]
        c = np.clip(ends_slots[r].astype(np.int64), 0, bucket)
        n_slots = len(c)
        words = torch.from_numpy(row.reshape(-1, 64).astype(np.int64))
        w0 = torch.arange(len(words)) * 64
        w = _word_values(words)
        acc = torch.zeros((n_slots, 8), dtype=torch.int64)
        fs = torch.from_numpy(np.searchsorted(c, w0.numpy(), side="right"))  # first end past the word's first byte
        has = fs < n_slots
        cf = torch.from_numpy(c)[fs.clamp(max=n_slots - 1)]
        rem = cf - w0
        whole = has & (rem >= 64) & (rem <= MAX)
        clamped = has & (rem - 64 >= MAX - 1)
        cf2 = torch.from_numpy(c)[(fs + 1).clamp(max=n_slots - 1)]
        rem2 = cf2 - w0
        split = has & (rem < 64) & (fs + 1 < n_slots) & (rem2 >= 64) & (rem2 <= MAX)
        special = has & ~whole & ~clamped & ~split

        acc.index_add_(0, fs[whole], w[whole] * _power(rem[whole] - 64) % M31)
        bsum = words[clamped].sum(1, keepdim=True)
        acc.index_add_(0, fs[clamped], bsum * POWERS[:, MAX - 1] % M31)
        m = rem[split]
        keep = torch.arange(64)[None, :] >= m[:, None]
        w2 = _word_values(words[split] * keep)  # the second piece: bytes before the end zeroed
        first = (w[split] - w2) % M31 * _inverse(64 - m) % M31
        acc.index_add_(0, fs[split], first)
        acc.index_add_(0, fs[split] + 1, w2 * _power(rem2[split] - 64) % M31)
        for k in torch.nonzero(special).flatten().tolist():
            _per_byte(row, 64 * k, 64 * k + 64, c, acc)
        out[r] = (acc % M31).numpy().astype(np.uint32)
    return out


def model_segment_fp_fixed(batch: np.ndarray, seg: int) -> np.ndarray:
    """K-D's word path: [B, n] u8, seg % 64 == 0 -> [B, n/seg, 8] u32."""
    assert seg % 64 == 0
    b, n = batch.shape
    words = torch.from_numpy(batch.reshape(-1, 64).astype(np.int64))
    w0 = torch.arange(len(words)) * 64  # flat: segment s of row r is flat segment r * n/seg + s
    slot, off = w0 // seg, w0 % seg
    rem = seg - off  # a multiple of 64: a word is wholly clamped or not at all
    clamped = rem > MAX
    w = _word_values(words)
    acc = torch.zeros((b * n // seg, 8), dtype=torch.int64)
    acc.index_add_(0, slot[~clamped], w[~clamped] * _power(rem[~clamped] - 64) % M31)
    acc.index_add_(0, slot[clamped], words[clamped].sum(1, keepdim=True) * POWERS[:, MAX - 1] % M31)
    return (acc % M31).numpy().astype(np.uint32).reshape(b, n // seg, 8)


# ---- the derived tables ----


def test_word_limbs_match_power_tables():
    p = jfp._power_tables().astype(np.int64)
    limbs = TABLES.word_limbs.numpy()
    assert limbs.shape == (64, 32) and limbs.dtype == np.uint8
    for k in range(64):
        for lane in range(8):
            for q in range(4):
                assert limbs[k, 4 * lane + q] == (p[lane, 63 - k] >> (8 * q)) & 0xFF
    # W by the product equals the word's lane polynomial
    rng = np.random.default_rng(0)
    words = np.concatenate([rng.integers(0, 256, (64, 64)), np.full((1, 64), 255), np.arange(1, 65)[None]])
    want = np.stack([(words * p[lane, 63 - np.arange(64)]).sum(1) % M31 for lane in range(8)], 1)
    np.testing.assert_array_equal(_word_values(torch.from_numpy(words)).numpy(), want)


def test_word_and_inverse_powers_match_power_tables():
    p = jfp._power_tables()
    wp = TABLES.word_powers.numpy().view(np.uint32)
    assert wp.shape == (64, MAX // 64, 8)
    for x in (0, 1, 63, 64, 65, 4095, 65536 + 17, MAX - 64, MAX - 1):
        np.testing.assert_array_equal(wp[x % 64, x // 64], p[ORDER, x])
    x = np.random.default_rng(1).integers(0, MAX, 1000)
    np.testing.assert_array_equal(wp[x % 64, x // 64], p[ORDER][:, x].T)
    inv = TABLES.inverse_powers.numpy().view(np.uint32).astype(np.int64)
    assert inv.shape == (64, 8)
    for d in range(64):
        np.testing.assert_array_equal(inv[d] * p[ORDER, d].astype(np.int64) % M31, np.ones(8, np.int64))


# ---- K-C's layout ----


def _fp_reference(batch: np.ndarray, ends: np.ndarray) -> np.ndarray:
    return np.asarray(jfused._fp_impl(jnp.asarray(batch), jnp.asarray(ends), n_slots=ends.shape[1]))


def _kc_case(name: str):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "residues":  # an end at every residue mod 64, ends 1 byte apart, ends at 64k - 1, 64k, 64k + 1
        bucket = 1 << 17
        batch = rng.integers(0, 256, (2, bucket), dtype=np.uint8)
        near = {5000, 5001, 4095, 4096, 4097, 8191, 8193, 70000, 70001, 70002}
        e = sorted({64 * (31 * k + 3) + k for k in range(64)} | near)
        ends = np.full((2, 96), bucket, np.int32)
        ends[0, : len(e)] = e
        ends[1, : len(e)] = e
        ends[1, len(e)] = bucket - 1  # the last real end one byte short of the bucket
        batch[1, bucket - 1 :] = 7
        return batch, ends
    if name == "all_ff":  # the largest limb sums
        bucket = 1 << 16
        batch = np.full((2, bucket), 0xFF, np.uint8)
        ends = np.full((2, 24), bucket, np.int32)
        e = np.sort(rng.choice(np.arange(1, bucket), 16, replace=False))
        ends[0, :16] = e
        ends[1, :3] = [64, 127, 40000]
        return batch, ends
    if name == "clamp":  # a segment of 2^19 bytes: its head past the power table
        bucket = 1 << 20
        batch = rng.integers(0, 256, (1, bucket), dtype=np.uint8)
        ends = np.full((1, 8), bucket, np.int32)
        ends[0, :3] = [1000, 1000 + (1 << 19), 1000 + (1 << 19) + 333]
        return batch, ends
    if name == "only_bucket":  # one segment: the whole row
        bucket = 1 << 16
        return rng.integers(0, 256, (2, bucket), dtype=np.uint8), np.full((2, 4), bucket, np.int32)
    if name == "garbage_end":  # a short chunk: its garbage end covers nonzero bytes past n
        bucket = 1 << 18
        batch = rng.integers(0, 256, (3, bucket), dtype=np.uint8)
        batch[1, 90000:] = 0
        ends = np.full((3, 40), bucket, np.int32)
        e = np.cumsum(rng.integers(1024, 16384, 30))
        e = e[e < bucket]
        ends[0, : len(e)] = e
        ends[1, :4] = [4096, 40000, 90000, bucket]
        ends[2, :2] = [0, 0]
        return batch, ends
    raise KeyError(name)


@pytest.mark.parametrize("case", ["residues", "all_ff", "clamp", "only_bucket", "garbage_end"])
def test_word_model_matches_reference_segment_fp(case):
    batch, ends = _kc_case(case)
    np.testing.assert_array_equal(model_segment_fp(batch, ends), _fp_reference(batch, ends))


# ---- K-D's layout ----


@pytest.mark.parametrize(
    "n, seg", [(1 << 16, 64), (1 << 17, 4096), (1 << 18, 1 << 16), (3 << 14, 3 << 12), (1 << 20, 1 << 19)]
)
def test_word_model_matches_reference_fixed_stride(n, seg):
    rng = np.random.default_rng(seg)
    rows = rng.integers(0, 256, (2, n), dtype=np.uint8)
    rows[1, : n // 2] = 0xFF
    if n <= 1 << 18:
        rows = np.concatenate([rows, np.tile(np.arange(1, 65, dtype=np.uint8), (1, n // 64))])
    got = model_segment_fp_fixed(rows, seg)
    for r in range(len(rows)):
        want = np.asarray(jfp.fixed_stride_lanes(jnp.asarray(rows[r]), seg, pallas=False))
        np.testing.assert_array_equal(got[r], want)
