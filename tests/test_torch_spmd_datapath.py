"""The port's SPMD step against the JAX package's, on the CPU.

Twins of ``tests/unit/test_spmd_datapath.py`` at its shapes (CHUNK 64 KiB,
BATCH 4, BLOCK 512, FP_SEG 4096, mask bits 10): the port's mesh runs over
``["cpu"] * 8`` (2x4), the JAX ``make_spmd_datapath`` over the 8 forced host
devices the repo's conftest provides, on the same seeded numpy rows, and
every output is compared exactly. Also the halo arithmetic per shard (the
port's plain K-A' with a halo against ``_gear_hash_halo`` under
``shard_map``), the trap of a zero-byte halo on shard 0, ``spmd_mode`` and
``maybe_default_mesh``. Tolerance is zero: every output is an integer or a
bool.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from skyplane_tpu.ops.gear import boundary_candidate_mask as jboundary_candidate_mask
from skyplane_tpu.ops.pipeline import datapath_step as jdatapath_step
from skyplane_tpu.parallel import datapath_spmd as jspmd
from skyplane_tpu_torch.ops import kernels
from skyplane_tpu_torch.ops.blockpack import decode_device
from skyplane_tpu_torch.ops.gear import gear_hash_halo
from skyplane_tpu_torch.ops.pipeline import datapath_step
from skyplane_tpu_torch.parallel import datapath_spmd
from skyplane_tpu_torch.parallel.datapath_spmd import Mesh, default_mesh, make_spmd_datapath
from skyplane_tpu_torch.state import device_tables

CHUNK = 64 * 1024
BATCH = 4
BLOCK = 512
FP_SEG = 4096
MASK_BITS = 10
TABLES = device_tables("cpu")
OUTPUTS = ("candidates", "tags", "literals", "n_lit", "fp_lanes")


def _batch(seed: int = 11):
    """The JAX test's mixed rows: random, zeros, a repeated 1 KiB pattern, random."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(BATCH):
        if i % 4 == 1:
            rows.append(np.zeros(CHUNK, np.uint8))
        elif i % 4 == 2:
            rows.append(np.tile(rng.integers(0, 256, 1024, dtype=np.uint8), CHUNK // 1024))
        else:
            rows.append(rng.integers(0, 256, CHUNK, dtype=np.uint8))
    return np.stack(rows)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return default_mesh(["cpu"] * 8), jspmd.default_mesh()


@pytest.fixture(scope="module")
def outputs(meshes):
    """Both packages' sharded step on the same rows, as numpy."""
    mesh, jmesh = meshes
    batch = _batch()
    out = make_spmd_datapath(mesh, CHUNK, BATCH, BLOCK, FP_SEG, MASK_BITS)(torch.from_numpy(batch))
    step, in_sharding = jspmd.make_spmd_datapath(jmesh, CHUNK, BATCH, BLOCK, FP_SEG, MASK_BITS)
    jout = step(jax.device_put(jnp.asarray(batch), in_sharding))
    return batch, {k: out[k].numpy() for k in OUTPUTS}, {k: np.asarray(jout[k]) for k in OUTPUTS}


def test_mesh_shape(meshes):
    mesh, jmesh = meshes
    assert mesh.shape["data"] * mesh.shape["seq"] == 8
    assert list(mesh.shape.items()) == list(dict(jmesh.shape).items())  # same axes, same order
    assert mesh.devices == [torch.device("cpu")] * 8


@pytest.mark.parametrize("key", OUTPUTS)
def test_spmd_matches_single_device(outputs, key):
    """Every output of the port's sharded step equals the JAX package's
    exactly (literals and n_lit per shard too); candidates, tags and
    fingerprints also equal the unsharded step, and n_lit sums to its count."""
    batch, port, ref = outputs
    got = port[key].view(np.uint32) if key == "fp_lanes" else port[key]  # int32 carriers of uint32 lanes
    assert got.dtype == ref[key].dtype
    np.testing.assert_array_equal(got, ref[key])
    single = datapath_step(torch.from_numpy(batch), BLOCK, FP_SEG, MASK_BITS)
    jsingle = jdatapath_step(jnp.asarray(batch), block_bytes=BLOCK, fp_seg_bytes=FP_SEG, mask_bits=MASK_BITS)
    if key in ("candidates", "tags", "fp_lanes"):
        np.testing.assert_array_equal(port[key], single[key].numpy())
    if key == "n_lit":
        np.testing.assert_array_equal(port["n_lit"].sum(1), single["n_lit"].numpy())
        np.testing.assert_array_equal(port["n_lit"].sum(1), np.asarray(jsingle["n_lit"]))


def test_spmd_literals_reconstruct(outputs, meshes):
    """Per-shard literal buffers + tags fully reconstruct each chunk."""
    batch, port, _ = outputs
    seq = meshes[0].shape["seq"]
    n_local = CHUNK // seq
    tags = port["tags"].reshape(BATCH, seq, n_local // BLOCK)
    literals = port["literals"].reshape(BATCH, seq, n_local)
    for b in range(BATCH):
        rebuilt = [decode_device(torch.from_numpy(tags[b, s]), torch.from_numpy(literals[b, s]), BLOCK).numpy()
                   for s in range(seq)]
        np.testing.assert_array_equal(np.concatenate(rebuilt), batch[b])


def test_meshed_batch_runner_matches_host_path():
    """The gateway's batch runner sharded over the mesh gives the host
    pipeline's boundaries and fingerprints, bit for bit (the JAX package's
    host functions, too)."""
    from skyplane_tpu.ops.cdc import cdc_segment_ends as jcdc_segment_ends
    from skyplane_tpu.ops.fingerprint import segment_fingerprints_host_batch as jfps
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.cdc import CDCParams, cdc_segment_ends
    from skyplane_tpu_torch.ops.fingerprint import segment_fingerprints_host_batch

    cdc = CDCParams()
    runner = DeviceBatchRunner(cdc_params=cdc, max_batch=8, mesh=default_mesh(["cpu"] * 8), device="cpu")
    local = np.random.default_rng(5)
    for trial in range(3):
        n = 1 << 16
        chunk = local.integers(0, 256, size=n, dtype=np.uint8)
        if trial == 1:
            chunk[: n // 3] = 0  # zero extents
        ends, fps = runner.cdc_and_fps(chunk, chunk)
        want_ends = cdc_segment_ends(chunk, cdc)
        np.testing.assert_array_equal(ends, want_ends)
        np.testing.assert_array_equal(ends, jcdc_segment_ends(chunk))
        assert fps == segment_fingerprints_host_batch(chunk, want_ends) == jfps(chunk, want_ends)
    assert runner.counters()["spmd_batches"] == 3


def test_spmd_mode_parsing(monkeypatch):
    monkeypatch.delenv("SKYPLANE_TPU_SPMD", raising=False)
    assert datapath_spmd.spmd_mode() == jspmd.spmd_mode() == "auto"
    for raw, want in (("0", "off"), ("off", "off"), ("no", "off"), ("1", "on"),
                      ("ON", "on"), ("force", "on"), ("auto", "auto"), ("bogus", "auto")):
        monkeypatch.setenv("SKYPLANE_TPU_SPMD", raw)
        assert datapath_spmd.spmd_mode() == jspmd.spmd_mode() == want, raw
    from skyplane_tpu_torch.gateway import gateway_daemon

    assert gateway_daemon.spmd_mode is datapath_spmd.spmd_mode  # one parser


def test_maybe_default_mesh_off_and_memoized_warning(monkeypatch):
    """SKYPLANE_TPU_SPMD=off always yields None; no cards yields None; a
    broken CUDA runtime warns ONCE per process, then stays silent."""
    from skyplane_tpu_torch.utils.logger import logger

    monkeypatch.setenv("SKYPLANE_TPU_SPMD", "off")
    monkeypatch.setattr(datapath_spmd.torch.cuda, "device_count", lambda: 4)
    assert datapath_spmd.maybe_default_mesh() is None
    monkeypatch.delenv("SKYPLANE_TPU_SPMD", raising=False)
    for n in (0, 1, 3, 6):  # not 2^k >= 2: unsharded
        monkeypatch.setattr(datapath_spmd.torch.cuda, "device_count", lambda n=n: n)
        assert datapath_spmd.maybe_default_mesh() is None

    warnings = []
    monkeypatch.setattr(datapath_spmd, "_warned_mesh_unavailable", False)
    monkeypatch.setattr(
        datapath_spmd.torch.cuda, "device_count", lambda: (_ for _ in ()).throw(RuntimeError("no runtime"))
    )
    monkeypatch.setattr(logger.fs, "warning", lambda msg, *a, **k: warnings.append(msg))
    assert datapath_spmd.maybe_default_mesh() is None
    assert datapath_spmd.maybe_default_mesh() is None
    assert len(warnings) == 1, f"mesh-unavailable warning must be memoized per process, got {warnings}"


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_maybe_default_mesh_gives_a_cpu_caller_no_card_mesh(monkeypatch, mode):
    """A CPU caller (a daemon asked for ``device="cpu"``) gets no mesh of
    cards, whatever the card count: its batches must not shard onto cards."""
    monkeypatch.setenv("SKYPLANE_TPU_SPMD", mode)
    monkeypatch.setattr(datapath_spmd.torch.cuda, "device_count", lambda: 4)
    built = []
    monkeypatch.setattr(datapath_spmd, "default_mesh", lambda *a, **k: built.append(a) or "mesh")
    assert datapath_spmd.maybe_default_mesh("cpu") is None
    assert datapath_spmd.maybe_default_mesh(torch.device("cpu")) is None
    assert not built
    assert datapath_spmd.maybe_default_mesh() == "mesh"  # no caller's device: the cards' mesh


def test_repeated_devices_stand_in_for_forced_host_devices():
    """The JAX package forces n host devices through XLA_FLAGS
    (``force_host_devices_env``); the port has no such knob: a mesh over a
    repeated device list is its counterpart, with JAX's default shapes."""
    assert not hasattr(datapath_spmd, "force_host_devices_env")
    for n, want in ((1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (8, (2, 4)), (6, (2, 3))):
        mesh = default_mesh(["cpu"] * n)
        assert tuple(mesh.shape.values()) == want
        assert mesh.positions() == list(range(n))
    mesh = default_mesh(["cpu"] * 8)
    assert mesh.positions(("data",)) == [0, 4]
    assert mesh.positions(("seq",)) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="does not hold"):
        Mesh(["cpu"] * 3, (2, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            default_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            Mesh(["cuda:0", "cpu"], (1, 2))


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(chunk_bytes=CHUNK + 512), "must split over seq"),
        (dict(fp_seg_bytes=CHUNK // 2), "must split over seq"),
        (dict(block_bytes=3 * 512), "must split over seq"),
        (dict(batch_chunks=3), "must divide over data"),
    ],
    ids=["chunk", "stride", "block", "batch"],
)
def test_step_refuses_the_reference_shapes(meshes, kw, match):
    """The same ValueErrors as the JAX package's for shapes that do not shard."""
    mesh, jmesh = meshes
    args = dict(chunk_bytes=CHUNK, batch_chunks=BATCH, block_bytes=BLOCK, fp_seg_bytes=FP_SEG, mask_bits=MASK_BITS)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        make_spmd_datapath(mesh, **args)
    with pytest.raises(ValueError, match=match):
        jspmd.make_spmd_datapath(jmesh, **args)


# ---- the halo, per shard ----


def _jax_shard_hashes(batch: np.ndarray, seq: int):
    """``_gear_hash_halo`` (and its candidate mask) of every seq shard under
    ``shard_map`` on a 1 x seq mesh of the forced host devices, as [B, N]."""
    from jax.sharding import Mesh as JMesh

    jmesh = JMesh(np.asarray(jax.devices()[:seq]).reshape(1, seq), ("data", "seq"))

    def per_shard(rows):
        return jax.vmap(lambda row: jspmd._gear_hash_halo(row, "seq", seq))(rows)

    fn = jax.jit(jspmd.shard_map_compat()(per_shard, mesh=jmesh, in_specs=P("data", "seq"), out_specs=P("data", "seq")))
    h = fn(jnp.asarray(batch))
    return np.asarray(h), np.asarray(jboundary_candidate_mask(h, MASK_BITS))


@pytest.mark.parametrize("seq", [2, 4, 8])
def test_gear_mask_plain_halo_matches_gear_hash_halo(seq):
    """Per shard: the port's plain K-A' with the left shard's last 32 bytes
    as its halo (none on shard 0) equals the JAX per-shard hash and mask."""
    batch = _batch(3)
    batch[0, CHUNK // seq - 40 : CHUNK // seq + 40] = 7  # a shard boundary inside a run of equal bytes
    jh, jmask = _jax_shard_hashes(batch, seq)
    n_local = CHUNK // seq
    t = torch.from_numpy(batch)
    for s in range(seq):
        rows = t[:, s * n_local : (s + 1) * n_local].contiguous()
        halo = t[:, s * n_local - 32 : s * n_local].contiguous() if s else None
        cols = slice(s * n_local, (s + 1) * n_local)
        np.testing.assert_array_equal(gear_hash_halo(rows, halo, TABLES.gear).numpy(), jh[:, cols].astype(np.int64))
        np.testing.assert_array_equal(kernels.gear_mask(rows, TABLES, MASK_BITS, halo=halo).numpy(), jmask[:, cols])
        np.testing.assert_array_equal(kernels.gear_mask_plain(rows, TABLES, MASK_BITS, halo).numpy(), jmask[:, cols])


def test_zero_byte_halo_is_not_no_halo():
    """The trap: the JAX halo of shard 0 is zero GEAR VALUES; 32 zero BYTES
    hash to the table's nonzero entry for byte 0. Shard 0 must pass no halo."""
    rows = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (4, 8192), dtype=np.uint8))
    zeros = torch.zeros((4, 32), dtype=torch.uint8)
    none_h, zero_h = gear_hash_halo(rows, None, TABLES.gear), gear_hash_halo(rows, zeros, TABLES.gear)
    assert not torch.equal(none_h[:, :31], zero_h[:, :31])
    assert torch.equal(none_h[:, 31:], zero_h[:, 31:])  # the window forgets the halo after 31 bytes
    none_m = kernels.gear_mask_plain(rows, TABLES, 1)
    zero_m = kernels.gear_mask_plain(rows, TABLES, 1, zeros)
    assert not torch.equal(none_m, zero_m)
    jh, _ = _jax_shard_hashes(np.tile(rows.numpy(), (1, 2)), 2)
    np.testing.assert_array_equal(none_h.numpy(), jh[:, :8192].astype(np.int64))


def test_halo_operand_is_checked():
    rows = torch.zeros((2, 8192), dtype=torch.uint8)
    with pytest.raises(ValueError, match="halo"):
        kernels.gear_mask(rows, TABLES, MASK_BITS, halo=torch.zeros((2, 31), dtype=torch.uint8))
    with pytest.raises(ValueError, match="halo"):
        kernels.gear_mask(rows, TABLES, MASK_BITS, halo=torch.zeros((3, 32), dtype=torch.uint8))
