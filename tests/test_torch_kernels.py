"""The port's device functions against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function (Pallas in
interpret mode, or the XLA path with ``_pallas=False``) and through the
port's counterpart, which on CPU tensors runs each kernel's plain PyTorch
version. Tolerance is zero: every output is an integer. Nothing here sets
environment variables or touches the JAX package's backend state.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skyplane_tpu.ops import fingerprint as jfp
from skyplane_tpu.ops import fused_cdc as jfused
from skyplane_tpu.ops import gear as jgear
from skyplane_tpu.ops import u32 as ju32
from skyplane_tpu.ops.cdc import CDCParams as JCDCParams
from skyplane_tpu.ops.pallas_kernels import TILE, gear_hash_pallas
from skyplane_tpu_torch import state
from skyplane_tpu_torch.ops import fingerprint as tfp
from skyplane_tpu_torch.ops import fused_cdc as tfused
from skyplane_tpu_torch.ops import gear as tgear
from skyplane_tpu_torch.ops import kernels
from skyplane_tpu_torch.ops import u32 as tu32
from skyplane_tpu_torch.ops.cdc import CDCParams, select_boundaries

PARAMS = CDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)
JPARAMS = JCDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)
TABLES = state.device_tables("cpu")


def _reference_arrays():
    return {"GEAR_TABLE": jgear.GEAR_TABLE, "LANE_BASES": jfp.LANE_BASES, "power_tables": jfp._power_tables()}


# ---- constants and carried state ----


def test_constants_equal():
    np.testing.assert_array_equal(tgear.GEAR_TABLE, jgear.GEAR_TABLE)
    assert tgear.GEAR_TABLE.dtype == jgear.GEAR_TABLE.dtype
    np.testing.assert_array_equal(tfp.LANE_BASES, jfp.LANE_BASES)
    np.testing.assert_array_equal(tfp._power_tables(), jfp._power_tables())
    assert (tfp.N_LANES, tfp.MAX_SEGMENT_BYTES, tgear.GEAR_WINDOW) == (jfp.N_LANES, jfp.MAX_SEGMENT_BYTES, jgear.GEAR_WINDOW)
    assert tu32.M31 == ju32.M31


def test_from_reference_accepts_jax_state():
    t = state.from_reference(_reference_arrays(), device="cpu")
    np.testing.assert_array_equal(t.gear.numpy(), jgear.GEAR_TABLE.astype(np.int64))
    np.testing.assert_array_equal(t.powers.numpy(), jfp._power_tables().astype(np.int64))
    np.testing.assert_array_equal(t.gear_bits.numpy().view(np.uint32), jgear.GEAR_TABLE)
    np.testing.assert_array_equal(t.powers_bits.numpy().view(np.uint32), jfp._power_tables())


@pytest.mark.parametrize("key", ["GEAR_TABLE", "LANE_BASES", "power_tables"])
def test_from_reference_refuses_other_state(key):
    arrays = {k: np.array(v) for k, v in _reference_arrays().items()}
    arrays[key].reshape(-1)[3] ^= 1
    with pytest.raises(ValueError, match=key):
        state.from_reference(arrays, device="cpu")
    del arrays[key]
    with pytest.raises(ValueError, match="lacks"):
        state.from_reference(arrays, device="cpu")


def test_u32_helpers_match_reference():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.integers(0, ju32.M31, 4096), [0, 1, ju32.M31 - 1]]).astype(np.uint32)
    b = np.concatenate([rng.integers(0, ju32.M31, 4096), [ju32.M31 - 1, ju32.M31 - 1, ju32.M31 - 1]]).astype(np.uint32)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    np.testing.assert_array_equal(tu32.mulmod31(ta, tb).numpy(), np.asarray(ju32.mulmod31(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(tu32.addmod31(ta, tb).numpy(), np.asarray(ju32.addmod31(jnp.asarray(a), jnp.asarray(b))))
    x = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint64), [ju32.M31, 2 * ju32.M31, (1 << 32) - 1]]).astype(np.uint32)
    np.testing.assert_array_equal(tu32.fold31(torch.from_numpy(x.astype(np.int64))).numpy(), np.asarray(ju32.fold31(jnp.asarray(x))))
    for base in (2, int(tfp.LANE_BASES[0])):
        np.testing.assert_array_equal(tu32.powmod31_table(base, 1000), ju32.powmod31_table(base, 1000))


# ---- P1: the gear hash, and the candidate mask of K-AB's plain version ----


def test_gear_hash_matches_pallas_interpret_and_sequential():
    rng = np.random.default_rng(123)
    data = rng.integers(0, 256, 4 * TILE, dtype=np.uint8)
    got = tgear.gear_hash(torch.from_numpy(data), TABLES.gear).numpy()
    pallas = np.asarray(gear_hash_pallas(jnp.asarray(data), interpret=True))
    np.testing.assert_array_equal(got, pallas.astype(np.int64))
    for b in (TILE, 2 * TILE, 3 * TILE):  # the halo carry at each tile boundary
        np.testing.assert_array_equal(got[b - 40 : b + 40], pallas[b - 40 : b + 40])
    np.testing.assert_array_equal(got, tgear.gear_hash_np(data))
    np.testing.assert_array_equal(tgear.gear_hash_np(data[:5000]), jgear.gear_hash_np(data[:5000]))


def test_gear_candidates_plain_mask_and_counts():
    rng = np.random.default_rng(5)
    bucket = 1 << 16
    data = rng.integers(0, 256, (3, bucket), dtype=np.uint8)
    lens = np.array([bucket, 40000, 0], np.int32)
    mask, counts = kernels.gear_candidates_plain(torch.from_numpy(data), torch.from_numpy(lens), TABLES, 8)
    for i in range(3):
        h = np.asarray(jgear.gear_hash(jnp.asarray(data[i]), pallas=False))
        want = np.asarray(jgear.boundary_candidate_mask(jnp.asarray(h), 8)) & (np.arange(bucket) < lens[i])
        bits = np.unpackbits(mask[i].numpy().view(np.uint8), bitorder="little").astype(bool)
        np.testing.assert_array_equal(bits, want)
        np.testing.assert_array_equal(counts[i].numpy(), want.reshape(-1, kernels.GEAR_TILE).sum(1))


# ---- call A (K-AB) ----


def _call_a(batch, lens, cap, mask_bits=PARAMS.mask_bits):
    got = tfused._candidates_impl(
        torch.from_numpy(batch), torch.from_numpy(lens), TABLES, mask_bits=mask_bits, cap=cap
    ).numpy()
    want = np.asarray(
        jfused._candidates_impl(jnp.asarray(batch), jnp.asarray(lens), mask_bits=mask_bits, cap=cap, _pallas=False)
    )
    return got, want


@pytest.mark.parametrize("bucket", [1 << 16, 1 << 18])
def test_call_a_matches_reference(bucket):
    rng = np.random.default_rng(bucket)
    batch = rng.integers(0, 256, (4, bucket), dtype=np.uint8)
    lens = np.array([bucket, bucket // 2 + 7, 1, 0], np.int32)
    for i, n in enumerate(lens):
        batch[i, n:] = 0
    batch[0, 100:30000] = 0
    cap = tfused.candidate_cap(bucket, PARAMS)
    got, want = _call_a(batch, lens, cap)
    np.testing.assert_array_equal(got, want)


def test_call_a_overflow_keeps_true_count():
    rng = np.random.default_rng(9)
    bucket = 1 << 16
    batch = rng.integers(0, 256, (2, bucket), dtype=np.uint8)
    lens = np.array([bucket, 5000], np.int32)
    batch[1, 5000:] = 0
    got, want = _call_a(batch, lens, cap=16, mask_bits=8)
    np.testing.assert_array_equal(got, want)
    assert got[0, 16] > 16  # truncated list, true count


def test_compact_candidates_plain_orders_positions():
    rng = np.random.default_rng(4)
    bucket = 1 << 16
    valid = rng.random((2, bucket)) < 0.002
    words = np.packbits(valid, axis=1, bitorder="little").view(np.int32)
    for cap in (8, 400):
        out = kernels.compact_candidates_plain(torch.from_numpy(words.copy()), bucket, cap).numpy()
        for i in range(2):
            pos = np.flatnonzero(valid[i])
            want = np.full(cap, bucket)
            want[: min(cap, len(pos))] = pos[:cap]
            np.testing.assert_array_equal(out[i, :cap], want)
            assert out[i, cap] == len(pos)


# ---- call B (K-C) ----


def _ends_slots(packed, lens, bucket, cap):
    n_slots = tfused.slots_cap(bucket, PARAMS)
    ends = np.full((len(lens), n_slots), bucket, np.int32)
    for i, n in enumerate(lens):
        e = select_boundaries(packed[i, : packed[i, cap]].astype(np.int64), int(n), PARAMS)
        ends[i, : len(e)] = e
        if n < bucket:
            ends[i, len(e)] = bucket
    return ends


def test_call_b_matches_reference_full_slots():
    rng = np.random.default_rng(77)
    bucket = 1 << 17
    lens = np.array([bucket, 70001, 0, 4096], np.int32)
    batch = rng.integers(0, 256, (4, bucket), dtype=np.uint8)
    for i, n in enumerate(lens):
        batch[i, n:] = 0
    batch[0, 20000:60000] = 0
    cap = tfused.candidate_cap(bucket, PARAMS)
    packed, _ = _call_a(batch, lens, cap)
    ends = _ends_slots(packed, lens, bucket, cap)
    got = tfused._fp_impl(torch.from_numpy(batch), torch.from_numpy(ends), TABLES).numpy().view(np.uint32)
    want = np.asarray(jfused._fp_impl(jnp.asarray(batch), jnp.asarray(ends), n_slots=ends.shape[1]))
    assert got.shape == want.shape == (4, ends.shape[1], 8)
    np.testing.assert_array_equal(got, want)


def test_segment_fingerprint_scatter_oracle_matches_reference():
    from skyplane_tpu.ops.cdc import segment_ids_and_rev_pos

    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, 50_000, dtype=np.uint8)
    ends = np.array([3000, 9000, 9001, 30000, 50_000])
    seg_ids, rev_pos = segment_ids_and_rev_pos(ends, len(data))
    want = np.asarray(jfp.segment_fingerprint_device(jnp.asarray(data), jnp.asarray(seg_ids), jnp.asarray(rev_pos), n_segments=len(ends)))
    got = tfp.segment_fingerprint_device(torch.from_numpy(data), torch.from_numpy(seg_ids), torch.from_numpy(rev_pos), len(ends), TABLES.powers)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(want[:3], tfp.segment_fingerprint_np(data, ends[:3]))  # Horner with python ints


def test_host_fingerprints_match_reference():
    rng = np.random.default_rng(12)
    arr = rng.integers(0, 256, 120_000, dtype=np.uint8)
    arr[10_000:40_000] = 0
    ends = np.array([1, 5000, 64_000, 64_001, 120_000])
    assert tfp.segment_fingerprints_host_batch(arr, ends) == jfp.segment_fingerprints_host_batch(arr, ends)
    for seg in (b"", b"\x00" * 100, arr[:7777].tobytes()):
        assert tfp.segment_fingerprint_host(seg) == jfp.segment_fingerprint_host(seg)
    lanes = rng.integers(0, tu32.M31, (3, 8)).astype(np.uint32)
    assert tfp.digests_from_lanes(lanes, [5, 9, 20]) == jfp.digests_from_lanes(lanes, [5, 9, 20])
    assert tfp.finalize_fingerprint(lanes[0], 5) == jfp.finalize_fingerprint(lanes[0], 5)
