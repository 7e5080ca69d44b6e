"""The port's native host library and its codecs against the JAX package's, on the CPU.

``skyplane_tpu_torch.native`` (the C++ CDC, fingerprints and blockpack, and
the ``native_lz`` codec) and ``skyplane_tpu_torch.utils.lz4ref`` must give
exactly the JAX package's outputs (tolerance 0: every output is bytes or
integers), and exactly the port's own numpy host paths. Every load of the
JAX package's library builds into a temporary directory, never beside its
sources.
"""

import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from skyplane_tpu.native import datapath as jndp
from skyplane_tpu.native import lz as jlz
from skyplane_tpu.ops import blockpack as jblockpack
from skyplane_tpu.ops import cdc as jcdc
from skyplane_tpu.ops import fingerprint as jfingerprint
from skyplane_tpu.utils import lz4ref as jlz4ref
from skyplane_tpu_torch import native
from skyplane_tpu_torch.chunk import MAX_CHUNK_BYTES
from skyplane_tpu_torch.exceptions import CodecException, MissingDependencyException
from skyplane_tpu_torch.native import datapath as ndp
from skyplane_tpu_torch.native import lz
from skyplane_tpu_torch.ops import blockpack, fused_cdc
from skyplane_tpu_torch.ops.cdc import CDCParams, cdc_and_fps_host, cdc_segment_ends
from skyplane_tpu_torch.ops.codecs import get_codec
from skyplane_tpu_torch.ops.fingerprint import (
    M31,
    MAX_SEGMENT_BYTES,
    _power_tables,
    segment_fingerprint_host,
    segment_fingerprints_host_batch,
)
from skyplane_tpu_torch.ops.host_fallback import boundary_candidates_host, gear_hash_host
from skyplane_tpu_torch.utils import lz4ref

REPO = Path(__file__).resolve().parents[1]
PARAMS = CDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)
JPARAMS = jcdc.CDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)
# the JAX package's native tests' corpora, and one 8 MiB chunk with zero extents
CORPORA = ("random_64k", "zero_extent_256k", "repetitive_32k", "zeros_4k", "ones_4k", "tiny_3", "chunk_8m")


def corpus(name: str) -> np.ndarray:
    rng = np.random.default_rng(13 + CORPORA.index(name))
    if name == "random_64k":
        return rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    if name == "zero_extent_256k":
        z = rng.integers(0, 256, 1 << 18, dtype=np.uint8)
        z[: 1 << 17] = 0
        return z
    if name == "repetitive_32k":
        return np.tile(rng.integers(0, 256, 512, dtype=np.uint8), 64)
    if name == "zeros_4k":
        return np.zeros(4096, np.uint8)
    if name == "ones_4k":
        return np.full(4096, 255, np.uint8)
    if name == "tiny_3":
        return rng.integers(0, 256, 3, dtype=np.uint8)
    c = rng.integers(0, 256, 8 << 20, dtype=np.uint8)
    for start in rng.integers(0, (8 << 20) - (1 << 20), 6):
        c[start : start + int(rng.integers(4096, 1 << 20))] = 0
    c[: 1 << 16] = np.tile(rng.integers(0, 256, 64, dtype=np.uint8), 1 << 10)  # a record run
    return c


@pytest.fixture(scope="module", autouse=True)
def jax_native_build_dir(tmp_path_factory):
    """The JAX package's loader writes its library and host tag beside its
    sources unless told otherwise: send every build of it to a temporary dir."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKYPLANE_TPU_NATIVE_BUILD_DIR", str(tmp_path_factory.mktemp("jax_native")))
        assert jndp.available(), "the JAX package's native library did not build"
        yield


def _numpy(monkeypatch, fn, *args):
    """``fn(*args)`` through the port's numpy host paths (library switched off)."""
    assert ndp.available(), "the port's native library did not build"
    with monkeypatch.context() as mp:
        mp.setattr(ndp, "_available", False)
        return fn(*args)


def _needs_lz4():
    if not lz4ref.available():
        pytest.skip("the system liblz4 (liblz4.so.1) is not present on this host")


# ---- gear candidates and CDC ----


@pytest.mark.parametrize("mask_bits", [1, 10, 16, 31])
@pytest.mark.parametrize("name", CORPORA)
def test_gear_candidates_equal_reference_and_numpy(name, mask_bits):
    data = corpus(name)
    got = ndp.gear_candidates(data, mask_bits)
    assert got.dtype == bool and got.shape == data.shape
    np.testing.assert_array_equal(got, jndp.gear_candidates(data, mask_bits))
    np.testing.assert_array_equal(got, boundary_candidates_host(gear_hash_host(data), mask_bits))


@pytest.mark.parametrize("mask_bits", [0, 32])
def test_gear_candidates_rejects_bad_mask_bits(mask_bits):
    with pytest.raises(ValueError, match="mask_bits"):
        ndp.gear_candidates(np.zeros(8, np.uint8), mask_bits)
    with pytest.raises(ValueError, match="mask_bits"):
        ndp.cdc_fp(np.zeros(8, np.uint8), mask_bits, 64, 1024)


@pytest.mark.parametrize("name", CORPORA)
def test_cdc_fp_equals_reference_numpy_and_fused(name, monkeypatch):
    data = corpus(name)
    ends, lanes = ndp.cdc_fp(data, PARAMS.mask_bits, PARAMS.min_bytes, PARAMS.max_bytes)
    j_ends, j_lanes = jndp.cdc_fp(data, JPARAMS.mask_bits, JPARAMS.min_bytes, JPARAMS.max_bytes)
    np.testing.assert_array_equal(ends, j_ends)
    np.testing.assert_array_equal(lanes, j_lanes)
    assert ends.dtype == np.int64 and lanes.dtype == np.uint32 and ends[-1] == len(data)

    got = cdc_and_fps_host(data, PARAMS)
    want = jcdc.cdc_and_fps_host(data, JPARAMS)
    np.testing.assert_array_equal(got[0], ends)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) == len(ends)
    np.testing.assert_array_equal(cdc_segment_ends(data, PARAMS), ends)  # the two-stage native path

    np_ends, np_fps = _numpy(monkeypatch, cdc_and_fps_host, data, PARAMS)
    np.testing.assert_array_equal(np_ends, ends)
    assert np_fps == got[1]

    bucket = max(1 << 16, 1 << (len(data) - 1).bit_length())
    padded = np.zeros(bucket, np.uint8)
    padded[: len(data)] = data
    (f_ends, f_fps), = fused_cdc.FusedCDCFP(PARAMS, device="cpu")(padded[None, :], [len(data)])
    np.testing.assert_array_equal(f_ends, ends)
    assert f_fps == got[1]


def test_cdc_fp_of_an_empty_chunk():
    ends, lanes = ndp.cdc_fp(np.zeros(0, np.uint8), 12, 1024, 16384)
    assert ends.tolist() == [0] and lanes.shape == (1, 8)
    assert cdc_and_fps_host(b"", PARAMS)[0].tolist() == [0]


def test_chunks_of_4_gib_or_more_take_the_two_stage_path(monkeypatch):
    """The fused call keeps positions in u32: a chunk of 2^32 bytes must not
    reach it (checked on a view that claims that length)."""
    def fused(*args):
        raise AssertionError("a chunk of 4 GiB reached the fused call")

    monkeypatch.setattr(ndp, "cdc_fp", fused)
    monkeypatch.setattr("skyplane_tpu_torch.ops.cdc.cdc_segment_ends", lambda arr, p: np.asarray([len(arr)], np.int64))
    monkeypatch.setattr("skyplane_tpu_torch.ops.fingerprint.segment_fingerprints_host_batch", lambda arr, ends: ["fp"])
    big = np.lib.stride_tricks.as_strided(np.zeros(1, np.uint8), shape=(1 << 32,), strides=(0,))
    ends, fps = cdc_and_fps_host(big, PARAMS)
    assert ends.tolist() == [1 << 32] and fps == ["fp"]


# ---- segment fingerprints ----


@pytest.mark.parametrize("length", [1, 63, 64, 65, MAX_SEGMENT_BYTES])
def test_segment_fp_lanes_and_host_fingerprint(length, monkeypatch):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, length + 300, dtype=np.uint8)
    ends = np.asarray([length, length + 100, length + 300], np.int64)
    lanes = ndp.segment_fp_lanes(data, ends)
    np.testing.assert_array_equal(lanes, jndp.segment_fp_lanes(data, ends))
    t64 = _power_tables().astype(np.uint64)
    for li in range(8):  # the definition: sum b_i r^(L-1-i) mod M31, first segment
        want = int((data[:length].astype(np.uint64) * t64[li, :length][::-1] % np.uint64(M31)).sum()) % M31
        assert lanes[0, li] == want
    seg = data[:length].tobytes()
    fp = segment_fingerprint_host(seg)
    assert fp == jfingerprint.segment_fingerprint_host(seg) == _numpy(monkeypatch, segment_fingerprint_host, seg)
    batch = segment_fingerprints_host_batch(data, ends)
    assert batch[0] == fp
    assert batch == jfingerprint.segment_fingerprints_host_batch(data, ends)
    assert batch == _numpy(monkeypatch, segment_fingerprints_host_batch, data, ends)


def test_segment_fingerprint_host_limits():
    with pytest.raises(ValueError, match="MAX_SEGMENT_BYTES"):
        segment_fingerprint_host(bytes(MAX_SEGMENT_BYTES + 1))
    assert segment_fingerprint_host(b"") == jfingerprint.segment_fingerprint_host(b"")


# ---- blockpack containers ----


@pytest.mark.parametrize("name", CORPORA)
def test_blockpack_container_equals_reference_both_ways(name, monkeypatch):
    data = corpus(name)
    data[len(data) // 3 : len(data) // 3 + 2048] = 7  # constant blocks
    for raw in (data.tobytes(), data[: len(data) - 17].tobytes()):  # a padded tail block
        enc = blockpack.encode_container(raw)
        assert enc == jblockpack.encode_container(raw)
        assert enc == _numpy(monkeypatch, blockpack.encode_container, raw)
        assert blockpack.decode_container(enc) == raw == jblockpack.decode_container(enc)
        assert _numpy(monkeypatch, blockpack.decode_container, enc) == raw
    tags, lits, n_lit = ndp.blockpack_encode(data[: len(data) // 512 * 512], 512)
    j_tags, j_lits, j_n = jndp.blockpack_encode(data[: len(data) // 512 * 512], 512)
    np.testing.assert_array_equal(tags, j_tags)
    np.testing.assert_array_equal(lits, j_lits)
    assert n_lit == j_n
    np.testing.assert_array_equal(ndp.blockpack_decode(tags, lits, 512), data[: len(data) // 512 * 512])


def _corrupt(enc: bytes, how: str) -> bytes:
    head = 2 + blockpack._HEAD.size
    n_lit = int.from_bytes(enc[12:20], "little")
    if how == "tags_all_literal":  # the tags demand more literal bytes than were shipped
        n_blocks = -(-int.from_bytes(enc[4:12], "little") // 512)
        return enc[:head] + b"\xaa" * (-(-n_blocks // 4)) + enc[head + -(-n_blocks // 4) :]
    if how == "literal_length_short":  # one literal byte fewer, declared and shipped
        return enc[:12] + (n_lit - 1).to_bytes(8, "little") + enc[20:-1]
    return enc[:-1]  # literal_region_truncated


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("how", ["tags_all_literal", "literal_length_short", "literal_region_truncated"])
def test_corrupt_blockpack_container_raises(how, path, monkeypatch):
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, 5000, dtype=np.uint8)
    raw[:1024] = 0
    enc = blockpack.encode_container(raw.tobytes())
    bad = _corrupt(enc, how)
    if path == "numpy":
        monkeypatch.setattr(ndp, "_available", False)
    with pytest.raises(CodecException):
        blockpack.decode_container(bad)


# ---- native_lz frames ----


@pytest.mark.parametrize("name", CORPORA)
def test_native_lz_frames_equal_reference_both_ways(name):
    raw = corpus(name).tobytes()
    frame = lz.compress(raw)
    assert frame == jlz.compress(raw)
    assert frame[:3] == b"SL\x01" and int.from_bytes(frame[3:11], "little") == len(raw)
    assert lz.decompress(jlz.compress(raw)) == raw == jlz.decompress(frame)
    codec = get_codec("native_lz")
    assert codec.encode(raw) == frame and codec.decode(frame) == raw
    for seed in (0, 0x5EED, (1 << 64) - 1):
        assert lz.checksum64(raw, seed) == jlz.checksum64(raw, seed)


@pytest.mark.parametrize("how", ["short_header", "bad_magic", "bad_version", "over_cap", "truncated", "corrupt_length"])
def test_native_lz_bad_frames_raise(how):
    raw = b"snapshot block " * 4000
    frame = lz.compress(raw)
    bad = {
        "short_header": frame[:10],
        "bad_magic": b"SX" + frame[2:],
        "bad_version": frame[:2] + b"\x02" + frame[3:],
        "over_cap": frame[:3] + (MAX_CHUNK_BYTES + 1).to_bytes(8, "little") + frame[11:],
        "truncated": frame[: len(frame) // 2],
        "corrupt_length": frame[:3] + (len(raw) + 1).to_bytes(8, "little") + frame[11:],
    }[how]
    with pytest.raises(CodecException):
        lz.decompress(bad)
    with pytest.raises(CodecException):
        get_codec("native_lz").decode(bad)


# ---- lz4 frames ----


@pytest.mark.parametrize("name", CORPORA)
def test_lz4_frames_equal_reference_both_ways(name):
    _needs_lz4()
    raw = corpus(name).tobytes()
    frame = lz4ref.compress(raw)
    assert frame == jlz4ref.compress(raw) and frame.startswith(lz4ref.LZ4F_MAGIC)
    assert lz4ref.decompress(jlz4ref.compress(raw), len(raw)) == raw == jlz4ref.decompress(frame, len(raw))
    codec = get_codec("lz4")
    assert codec.encode(raw) == frame and codec.decode(frame) == raw


@pytest.mark.parametrize("how", ["corrupt", "truncated", "trailing", "over_cap"])
def test_lz4_bad_frames_raise(how):
    _needs_lz4()
    raw = b"truncate me " * 5000
    frame = lz4ref.compress(raw)
    if how == "over_cap":
        with pytest.raises(ValueError, match="cap"):
            lz4ref.decompress(frame, len(raw) - 1)
        return
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0xFF
    bad = {"corrupt": bytes(flipped), "truncated": frame[:-10], "trailing": frame + b"GARBAGE"}[how]
    with pytest.raises(ValueError):
        lz4ref.decompress(bad, 1 << 20)
    with pytest.raises(CodecException, match="lz4"):
        get_codec("lz4").decode(bad)


def test_lz4_without_the_library_fails_at_first_use(monkeypatch):
    monkeypatch.setattr(lz4ref, "_lib", None)
    monkeypatch.setattr(lz4ref, "_load_failed", True)
    assert not lz4ref.available()
    codec = get_codec("lz4")  # still registered
    with pytest.raises(RuntimeError, match="liblz4"):
        codec.encode(b"x")
    with pytest.raises(RuntimeError, match="liblz4"):
        codec.decode(b"x")


# ---- opt-out, missing compiler, host tag, concurrent builds ----


@pytest.mark.parametrize("value", ["0", "false", "off"])
def test_opt_out_serves_the_same_outputs_from_numpy(value, monkeypatch):
    data = corpus("zero_extent_256k")
    want_cdc = cdc_and_fps_host(data, PARAMS)
    want_enc = blockpack.encode_container(data.tobytes())
    calls = []
    real = gear_hash_host
    monkeypatch.setattr("skyplane_tpu_torch.ops.host_fallback.gear_hash_host", lambda a: calls.append(1) or real(a))
    monkeypatch.setenv("SKYPLANE_TPU_NATIVE_DATAPATH", value)
    monkeypatch.setattr(ndp, "_available", None)
    assert ndp.available() is False
    ends, fps = cdc_and_fps_host(data, PARAMS)
    assert calls, "the opt-out did not take the numpy path"
    np.testing.assert_array_equal(ends, want_cdc[0])
    assert fps == want_cdc[1]
    assert blockpack.encode_container(data.tobytes()) == want_enc
    assert blockpack.decode_container(want_enc) == data.tobytes()


def test_no_compiler_raises_missing_dependency_and_numpy_serves(monkeypatch, tmp_path):
    def no_gpp(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setenv("SKYPLANE_TPU_NATIVE_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", no_gpp)
    with pytest.raises(MissingDependencyException, match="g\\+\\+"):
        native.load_library()
    monkeypatch.setattr(ndp, "_available", None)
    assert ndp.available() is False
    data = corpus("random_64k")
    ends, fps = cdc_and_fps_host(data, PARAMS)
    j_ends, j_fps = jcdc.cdc_and_fps_host(data, JPARAMS)
    np.testing.assert_array_equal(ends, j_ends)
    assert fps == j_fps
    assert not list(tmp_path.iterdir())


def test_library_built_for_another_host_tag_is_not_loaded(monkeypatch, tmp_path):
    monkeypatch.setenv("SKYPLANE_TPU_NATIVE_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_info", {})
    mine = native.library_path()
    foreign = native.library_path(tag="x86_64-another-cpu")
    assert mine != foreign and mine.parent == foreign.parent == tmp_path
    assert native.host_tag().startswith(platform.machine())
    foreign.write_bytes(b"not a library for this CPU")
    native.load_library()
    assert native.build_info["path"] == str(mine) and mine.exists()
    assert native.build_info["march_native"] in (True, False)
    assert foreign.read_bytes() == b"not a library for this CPU"
    assert mine.name.startswith("libskydp-") and mine.suffix == ".so"


def test_processes_building_at_once_never_load_a_torn_library(tmp_path):
    code = (
        "from skyplane_tpu_torch.native import lz, build_info\n"
        "raw = b'x' * 100000\n"
        "assert lz.decompress(lz.compress(raw)) == raw\n"
        "print(lz.checksum64(raw), build_info['path'])\n"
    )
    env = dict(os.environ, SKYPLANE_TPU_NATIVE_BUILD_DIR=str(tmp_path))
    procs = [
        subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(out.split())
    assert len({tuple(o) for o in outs}) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == [Path(outs[0][1]).name]  # no temporary left behind
