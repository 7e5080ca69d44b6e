"""The port's fused batch step against the JAX package's, on the CPU.

``datapath_step`` and its parts (``encode_device``/``decode_device``,
``fixed_stride_lanes``, the full-width candidate mask) and the ``entry()``
twin get the same seeded numpy inputs as the JAX functions: the XLA paths
(``_datapath_step_impl(..., _pallas_gear=False, _pallas_fp=False)``,
``fixed_stride_lanes(..., pallas=False)``) and the Pallas fixed-stride
kernel in interpret mode. On CPU tensors the port runs each kernel's plain
PyTorch version. Tolerance is zero: every output is an integer or a bool.
Nothing here sets environment variables or touches the JAX package's
backend state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skyplane_tpu.ops import blockpack as jblockpack
from skyplane_tpu.ops import fingerprint as jfp
from skyplane_tpu.ops.pallas_kernels import segment_fp_fixed_pallas
from skyplane_tpu.ops.pipeline import _datapath_step_impl
from skyplane_tpu_torch import entry as tentry
from skyplane_tpu_torch import state
from skyplane_tpu_torch.ops import blockpack as tblockpack
from skyplane_tpu_torch.ops import fingerprint as tfp
from skyplane_tpu_torch.ops import kernels
from skyplane_tpu_torch.ops.host_fallback import blockpack_decode_host
from skyplane_tpu_torch.ops.pipeline import datapath_step

TABLES = state.device_tables("cpu")


def _rows(rng, n, kinds, block=512):
    """One row per kind: random, zero, const, mixed (zero/const/literal
    blocks), pattern (a repeated 1 KiB run)."""
    out = []
    for kind in kinds:
        if kind == "zero":
            row = np.zeros(n, np.uint8)
        elif kind == "const":
            row = np.full(n, 0x5A, np.uint8)
        elif kind == "pattern":
            row = np.tile(rng.integers(0, 256, 1024, dtype=np.uint8), -(-n // 1024))[:n]
        elif kind == "mixed":
            row = rng.integers(0, 256, n, dtype=np.uint8)
            blocks = row.reshape(-1, block)
            pick = rng.integers(0, 3, len(blocks))
            blocks[pick == 0] = 0
            blocks[pick == 1] = rng.integers(1, 256, int((pick == 1).sum()), dtype=np.uint8)[:, None]
            row[-block:] = 0  # a zero block after the last kept byte
        else:
            row = rng.integers(0, 256, n, dtype=np.uint8)
        out.append(row)
    return np.stack(out)


KINDS = ["random", "zero", "const", "mixed", "pattern"]


# ---- blockpack encode_device / decode_device ----


@pytest.mark.parametrize("block_bytes", [256, 512, 4096])
def test_encode_device_matches_reference(block_bytes):
    rng = np.random.default_rng(block_bytes)
    data = _rows(rng, 16384, KINDS, block_bytes)
    tags, literals, n_lit = tblockpack.encode_device(torch.from_numpy(data), block_bytes)
    jtags, jlit, jn = jax.vmap(lambda r: jblockpack.encode_device(r, block_bytes=block_bytes))(jnp.asarray(data))
    np.testing.assert_array_equal(tags.numpy(), np.asarray(jtags))
    np.testing.assert_array_equal(literals.numpy(), np.asarray(jlit))
    np.testing.assert_array_equal(n_lit.numpy(), np.asarray(jn))
    assert tags.dtype == torch.uint8 and literals.dtype == torch.uint8 and n_lit.dtype == torch.int32
    assert set(np.unique(tags.numpy())) == {0, 1, 2}
    assert n_lit[1] == 0 and n_lit[2] == data.shape[1] // block_bytes


@pytest.mark.parametrize("block_bytes", [256, 512, 4096])
def test_decode_device_matches_reference_and_inverts(block_bytes):
    rng = np.random.default_rng(block_bytes + 1)
    data = _rows(rng, 16384, KINDS, block_bytes)
    tags, literals, n_lit = tblockpack.encode_device(torch.from_numpy(data), block_bytes)
    out = tblockpack.decode_device(tags, literals, block_bytes)
    np.testing.assert_array_equal(out.numpy(), data)
    for i in range(len(data)):
        want = np.asarray(jblockpack.decode_device(jnp.asarray(tags[i].numpy()), jnp.asarray(literals[i].numpy()), block_bytes))
        np.testing.assert_array_equal(out[i].numpy(), want)
        # literals cut to n_lit: a trailing zero block indexes past the end (clamped)
        cut = literals[i, : int(n_lit[i])]
        np.testing.assert_array_equal(tblockpack.decode_device(tags[i], cut, block_bytes).numpy(), data[i])
        np.testing.assert_array_equal(blockpack_decode_host(tags[i].numpy(), cut.numpy(), block_bytes), data[i])


def test_encode_device_block_not_a_power_of_two():
    rng = np.random.default_rng(5)
    data = _rows(rng, 12000, ["random", "mixed", "zero"], 600)
    tags, literals, n_lit = tblockpack.encode_device(torch.from_numpy(data), 600)
    jtags, jlit, jn = jax.vmap(lambda r: jblockpack.encode_device(r, block_bytes=600))(jnp.asarray(data))
    np.testing.assert_array_equal(tags.numpy(), np.asarray(jtags))
    np.testing.assert_array_equal(literals.numpy(), np.asarray(jlit))
    np.testing.assert_array_equal(n_lit.numpy(), np.asarray(jn))
    with pytest.raises(ValueError):
        tblockpack.encode_device(torch.from_numpy(data), 7)


# ---- fixed_stride_lanes ----


def _jax_fixed(row, seg):
    return np.asarray(jfp.fixed_stride_lanes(jnp.asarray(row), seg, pallas=False))


@pytest.mark.parametrize("seg", [2048, 4096, 16384])
def test_fixed_stride_lanes_match_xla_and_pallas(seg):
    rng = np.random.default_rng(seg)
    data = _rows(rng, 1 << 16, ["random", "mixed", "pattern"])
    got = tfp.fixed_stride_lanes(torch.from_numpy(data), seg, TABLES)
    assert got.shape == (3, (1 << 16) // seg, 8) and got.dtype == torch.int32
    for i, row in enumerate(data):
        want = _jax_fixed(row, seg)
        np.testing.assert_array_equal(got[i].numpy().astype(np.uint32), want)
        pallas = np.asarray(segment_fp_fixed_pallas(jnp.asarray(row), seg, interpret=True))
        np.testing.assert_array_equal(got[i].numpy().astype(np.uint32), pallas)


@pytest.mark.parametrize("seg, n", [(1 << 17, 1 << 18), (1000, 64000), (3 * 8192, 6 * 8192)])
def test_fixed_stride_lanes_outside_the_pallas_domain(seg, n):
    """Strides the Pallas kernel refuses: past 2^16, not a multiple of 8192
    (the port's kernel covers them; the reference falls through to XLA)."""
    rng = np.random.default_rng(seg)
    data = _rows(rng, n, ["random", "mixed"], 64)
    got = tfp.fixed_stride_lanes(torch.from_numpy(data), seg, TABLES)
    for i, row in enumerate(data):
        np.testing.assert_array_equal(got[i].numpy().astype(np.uint32), _jax_fixed(row, seg))


def test_fixed_stride_lanes_clamp_past_the_power_table():
    """S = 2^19 > MAX_SEGMENT_BYTES: the reference's gather clamps the power
    index at 2^18 - 1, and so does the port."""
    seg = 1 << 19
    rng = np.random.default_rng(19)
    row = rng.integers(0, 256, 2 * seg, dtype=np.uint8)
    row[seg : seg + 1000] = 0
    got = tfp.fixed_stride_lanes(torch.from_numpy(row[None]), seg, TABLES)[0].numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, _jax_fixed(row, seg))
    # and the clamp is what decides it: only bytes at rev_pos >= 2^18 take the
    # clamped power, so changing byte 0 moves every lane by b * r^(2^18 - 1)
    bumped = row.copy()
    bumped[0] ^= 1
    delta = (int(bumped[0]) - int(row[0])) % tfp.M31
    tables = tfp._power_tables().astype(object)
    want = (got[0].astype(object) + delta * tables[:, tfp.MAX_SEGMENT_BYTES - 1]) % tfp.M31
    got2 = tfp.fixed_stride_lanes(torch.from_numpy(bumped[None]), seg, TABLES)[0].numpy()
    np.testing.assert_array_equal(got2[0].astype(object), want)


def test_fixed_stride_lanes_refuse_bad_strides():
    x = torch.zeros((1, 12288), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple"):
        tfp.fixed_stride_lanes(x, 5000, TABLES)  # N % S
    with pytest.raises(ValueError):  # the reference's kernel refuses it the same way
        segment_fp_fixed_pallas(jnp.zeros(12288, jnp.uint8), 5000, interpret=True)
    with pytest.raises(ValueError, match="exceeds"):  # past 2^24 the reference's limb sums wrap
        kernels.segment_fp_fixed(torch.zeros((1, 1 << 25), dtype=torch.uint8), 1 << 25, TABLES)


# ---- the full-width candidate mask (K-A's byte mode) ----


@pytest.mark.parametrize("n, mask_bits", [(1 << 16, 10), (3 * 4096, 8), (8192 + 40, 6)])
def test_gear_mask_matches_packed_mode_and_reference(n, mask_bits):
    rng = np.random.default_rng(n)
    data = _rows(rng, n, ["random", "pattern", "zero"], 8)
    batch = torch.from_numpy(data)
    got = kernels.gear_mask(batch, TABLES, mask_bits)
    assert got.dtype == torch.bool and got.shape == (3, n)
    # the reference's mask, row by row
    from skyplane_tpu.ops.gear import boundary_candidate_mask, gear_hash

    for i, row in enumerate(data):
        want = np.asarray(boundary_candidate_mask(gear_hash(jnp.asarray(row), pallas=False), mask_bits))
        np.testing.assert_array_equal(got[i].numpy(), want)
    # the packed mask of K-AB's plain version over the same bytes (padded to its tile), unpacked
    n_pad = -(-n // kernels.GEAR_TILE) * kernels.GEAR_TILE
    padded = torch.zeros((3, n_pad), dtype=torch.uint8)
    padded[:, :n] = batch
    words, counts = kernels.gear_candidates_plain(padded, torch.full((3,), n, dtype=torch.int32), TABLES, mask_bits)
    bits = ((words.long()[:, :, None] >> torch.arange(32)) & 1).bool().view(3, n_pad)
    assert torch.equal(bits[:, :n], got)
    assert torch.equal(counts.sum(-1), got.sum(-1).to(torch.int32))


# ---- datapath_step and the entry twin ----


def _spmd_batch():
    """The SPMD test's shapes and mix: 4 x 64 KiB, random / zero / pattern / random."""
    rng = np.random.default_rng(0)
    return _rows(rng, 64 * 1024, ["random", "zero", "pattern", "random"])


def _assert_step_equal(got, want):
    assert set(got) == set(want) == {"candidates", "tags", "literals", "n_lit", "fp_lanes"}
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)


@pytest.mark.parametrize(
    "shape, block, fp, mask_bits",
    [((4, 64 * 1024), 512, 4096, 10), ((3, 3 * 4096), 512, 4096, 8), ((2, 3 * 4096), 1024, 6144, 12)],
)
def test_datapath_step_matches_reference(shape, block, fp, mask_bits):
    if shape == (4, 64 * 1024):
        data = _spmd_batch()
    else:  # N not a multiple of the mask kernel's 8 KiB tile: the padding path
        data = _rows(np.random.default_rng(shape[1] + block), shape[1], ["random", "mixed", "pattern"][: shape[0]], block)
    got = datapath_step(torch.from_numpy(data), block_bytes=block, fp_seg_bytes=fp, mask_bits=mask_bits, tables=TABLES)
    want = _datapath_step_impl(
        jnp.asarray(data), block_bytes=block, fp_seg_bytes=fp, mask_bits=mask_bits, _pallas_gear=False, _pallas_fp=False
    )
    _assert_step_equal(got, want)
    assert got["candidates"].dtype == torch.bool and got["fp_lanes"].dtype == torch.int32


def test_datapath_step_refuses_indivisible_n():
    x = torch.zeros((2, 12288), dtype=torch.uint8)
    with pytest.raises(ValueError, match="divisible"):
        datapath_step(x, block_bytes=512, fp_seg_bytes=8192, tables=TABLES)
    with pytest.raises(ValueError, match="divisible"):
        datapath_step(x, block_bytes=5000, fp_seg_bytes=4096, tables=TABLES)


def test_entry_twin_matches_reference_entry():
    import __graft_entry__

    jfn, (jx,) = __graft_entry__.entry()
    fn, (x,) = tentry.entry(device="cpu")
    cells = dict(zip(jfn.__code__.co_freevars, (c.cell_contents for c in jfn.__closure__)))
    params = {k: cells[k] for k in ("block_bytes", "fp_seg_bytes", "mask_bits")}
    assert params == {"block_bytes": tentry.BLOCK_BYTES, "fp_seg_bytes": tentry.FP_SEG_BYTES, "mask_bits": tentry.MASK_BITS}
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert x.device.type == "cpu"
    want = _datapath_step_impl(
        jx,
        block_bytes=tentry.BLOCK_BYTES,
        fp_seg_bytes=tentry.FP_SEG_BYTES,
        mask_bits=tentry.MASK_BITS,
        _pallas_gear=False,
        _pallas_fp=False,
    )
    _assert_step_equal(fn(x), want)


def test_entry_defaults_to_the_card():
    """``entry()`` asks for CUDA unless told otherwise: without a card it
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
