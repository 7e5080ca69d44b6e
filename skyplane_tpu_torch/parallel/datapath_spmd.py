"""SPMD data-path step over a (data, seq) grid of devices: the counterpart of
``skyplane_tpu/parallel/datapath_spmd.py``.

Parallel axes, as in the JAX package:

  data — chunk parallelism: different chunks on different devices.
  seq  — intra-chunk byte-range parallelism: a chunk's bytes split across
         devices; the gear rolling hash of a shard's first 31 positions needs
         the bytes in front of it from the left neighbour (the halo).

Fingerprint segments and blockpack blocks are aligned to the shard size, so
tags, fingerprints and literal compaction are local to a shard once it has
its halo; literals are dense per shard and ``n_lit`` is [B, seq].

The JAX package has one controller, and so has the port: one process drives
every position of the grid, each position with a CUDA stream of its own on
its device. The halo is the left shard's last 32 bytes of each row, carried
by a ``Tensor.to(device)`` (a peer copy between cards); no communicator is
involved. K-A' (``kernels.gear_mask``) takes it as an operand and reads it
for the row's first word. Shard 0 has no halo: its hash has a zero prefix
(``ppermute`` leaves the JAX halo at zero gear values, which 32 zero bytes
would not give). The plain per-shard hash, the counterpart of
``_gear_hash_halo``, is ``ops.gear.gear_hash_halo``, beside ``gear_hash``.

A ``Mesh`` may repeat a device (``["cpu"] * 8``, ``["cuda:0"] * 4``): the
counterpart of JAX's forced host devices, so the CPU tests run every grid
shape in one process and one card runs the sharded code with its kernels. A
repeated device runs its positions one after another and buys no
parallelism. Only a caller's device list builds such a grid; the daemon's
``maybe_default_mesh`` uses each card once.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch

from skyplane_tpu_torch.ops import kernels
from skyplane_tpu_torch.ops.backend import on_stream, record_event, resolve_device
from skyplane_tpu_torch.ops.gear import HALO_BYTES

AXES = ("data", "seq")


def spmd_mode() -> str:
    """Parse SKYPLANE_TPU_SPMD into one of "off" / "auto" / "on".

    "off" disables mesh sharding entirely; "on" builds the daemon's batch
    runner even off the card (a CPU daemon); anything else (including unset)
    is "auto": shard when maybe_default_mesh() finds a viable mesh,
    single-device otherwise.
    """
    v = os.environ.get("SKYPLANE_TPU_SPMD", "auto").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "off"
    if v in ("1", "on", "true", "yes", "force"):
        return "on"
    return "auto"


class Mesh:
    """A 2-D grid of ``torch.device``s with the axes ("data", "seq").

    ``shape`` is an ordered dict ``{"data": d, "seq": s}``, as
    ``jax.sharding.Mesh.shape`` is; ``devices`` is the flat list in row-major
    order (position ``(i, j)`` is ``devices[i * s + j]``). Every device has
    one type; a device may repeat.
    """

    def __init__(self, devices: Sequence, shape: Sequence[int]):
        devs = [resolve_device(d) for d in devices]
        if len(shape) != len(AXES) or any(int(x) < 1 for x in shape):
            raise ValueError(f"mesh shape {tuple(shape)} must be two positive sizes for {AXES}")
        if shape[0] * shape[1] != len(devs):
            raise ValueError(f"mesh shape {tuple(shape)} does not hold {len(devs)} devices")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mesh devices mix types: {devs}")
        self.devices: List[torch.device] = devs
        self.shape: Dict[str, int] = OrderedDict(zip(AXES, (int(x) for x in shape)))

    def positions(self, axes: Optional[Sequence[str]] = None) -> List[int]:
        """Flat indexes of the positions that shard over ``axes`` (default:
        every axis), in row-major order over those axes, with every other
        axis at 0 (where JAX replicates the work, the port runs it once)."""
        axes = tuple(self.shape) if axes is None else tuple(axes)
        if not set(axes) <= set(self.shape):
            raise ValueError(f"axes {axes} not in the mesh's {tuple(self.shape)}")
        data, seq = self.shape["data"], self.shape["seq"]
        rows = range(data) if "data" in axes else range(1)
        cols = range(seq) if "seq" in axes else range(1)
        return [i * seq + j for i in rows for j in cols]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self.devices]})"


_warned_mesh_unavailable = False


def maybe_default_mesh(device=None) -> Optional[Mesh]:
    """A (data, seq) mesh over the machine's cards when sharding is viable
    (more than one card, a power-of-two count), else None. ``device`` is the
    caller's (a daemon's): a CPU caller gets no mesh of cards. Never raises —
    a mesh is an optimization, not a requirement. Honors SKYPLANE_TPU_SPMD=off."""
    global _warned_mesh_unavailable
    if spmd_mode() == "off":
        return None
    if device is not None and resolve_device(device).type != "cuda":
        return None
    try:
        n = torch.cuda.device_count()
        if n > 1 and (n & (n - 1)) == 0:
            return default_mesh()
    except Exception as e:  # noqa: BLE001 — no usable CUDA runtime => unsharded
        if not _warned_mesh_unavailable:
            _warned_mesh_unavailable = True
            from skyplane_tpu_torch.utils.logger import logger

            logger.fs.warning(f"multi-device mesh unavailable ({e}); running single-device")
    return None


def default_mesh(devices: Optional[Sequence] = None, data_parallel: Optional[int] = None) -> Mesh:
    """A (data, seq) mesh over ``devices`` (default: every CUDA device)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device for a default mesh (pass devices, e.g. ['cpu'] * 8)")
    n = len(devices)
    if data_parallel is None:
        # favor seq-parallel for big-chunk throughput; keep data >= 1
        data_parallel = 2 if n >= 4 and n % 2 == 0 else 1
    seq = n // data_parallel
    return Mesh(list(devices)[: data_parallel * seq], (data_parallel, seq))


def make_spmd_datapath(
    mesh: Mesh,
    chunk_bytes: int,
    batch_chunks: int,
    block_bytes: int = 512,
    fp_seg_bytes: int = 1 << 16,
    mask_bits: int = 16,
):
    """The full batched data-path step sharded over ``mesh``.

    Returns ``step``: [batch_chunks, chunk_bytes] uint8 (on the host or any
    device) -> dict on the mesh's first device, in its current stream's order:
      candidates [B, N] bool, tags [B, N/block] uint8,
      literals [B, N] uint8 (dense per seq shard), n_lit [B, seq] int32 (per
      seq shard), fp_lanes [B, N/fp_seg, 8] int32 (uint32 values).

    Each position makes its [B/data, N/seq] slab contiguous on its own device
    (a column slice is strided; the kernels take contiguous rows), takes its
    halo from its left seq neighbour, and launches K-A' (``gear_mask``), K-E
    (``blockpack_encode``) and K-D (``segment_fp_fixed``) on a stream of its
    own; on the CPU the same wrappers run their plain versions.
    """
    from skyplane_tpu_torch.state import device_tables

    data, seq = mesh.shape["data"], mesh.shape["seq"]
    n_local = chunk_bytes // seq
    if chunk_bytes % seq or n_local % fp_seg_bytes or n_local % block_bytes:
        raise ValueError(
            f"chunk_bytes={chunk_bytes} must split over seq={seq} into shards divisible by "
            f"fp_seg_bytes={fp_seg_bytes} and block_bytes={block_bytes}"
        )
    if batch_chunks % data:
        raise ValueError(f"batch_chunks={batch_chunks} must divide over data={data}")
    if seq > 1 and n_local < HALO_BYTES:
        raise ValueError(f"seq shards of {n_local} bytes are shorter than the {HALO_BYTES}-byte halo")
    b_local = batch_chunks // data
    devices = mesh.devices
    tables = {str(d): device_tables(d) for d in devices}
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]  # one per position
    dev0 = devices[0]

    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        if batch.dtype != torch.uint8 or tuple(batch.shape) != (batch_chunks, chunk_bytes):
            raise ValueError(
                f"batch must be [{batch_chunks}, {chunk_bytes}] uint8, got {batch.dtype} {tuple(batch.shape)}"
            )
        source = torch.cuda.current_stream(batch.device) if batch.device.type == "cuda" else None
        caller = torch.cuda.current_stream(dev0) if dev0.type == "cuda" else None
        out = dict(
            candidates=torch.empty((batch_chunks, chunk_bytes), dtype=torch.bool, device=dev0),
            tags=torch.empty((batch_chunks, chunk_bytes // block_bytes), dtype=torch.uint8, device=dev0),
            literals=torch.empty((batch_chunks, chunk_bytes), dtype=torch.uint8, device=dev0),
            n_lit=torch.empty((batch_chunks, seq), dtype=torch.int32, device=dev0),
            fp_lanes=torch.empty((batch_chunks, chunk_bytes // fp_seg_bytes, 8), dtype=torch.int32, device=dev0),
        )
        # 1. every position's slab, contiguous on its device
        slabs, ready = [], []
        for i, (dev, st) in enumerate(zip(devices, streams)):
            r, c = divmod(i, seq)
            view = batch[r * b_local : (r + 1) * b_local, c * n_local : (c + 1) * n_local]
            with on_stream(st):
                if st is not None and source is not None:
                    st.wait_stream(source)  # the batch is ready in its caller's order
                    if batch.device == dev:
                        batch.record_stream(st)
                slabs.append(view.to(dev).contiguous())
                ready.append(record_event(st))
        # 2. the halo from the left seq neighbour, then the three kernels
        results, done = [], []
        for i, (dev, st) in enumerate(zip(devices, streams)):
            halo = None
            if i % seq:
                left = slabs[i - 1]
                with on_stream(streams[i - 1]), on_stream(st):
                    if st is not None:
                        st.wait_event(ready[i - 1])
                        left.record_stream(st)
                    halo = left[:, -HALO_BYTES:].to(dev).contiguous()
            with on_stream(st):
                t = tables[str(dev)]
                cand = kernels.gear_mask(slabs[i], t, mask_bits, halo=halo)
                tags, literals, n_lit = kernels.blockpack_encode(slabs[i], block_bytes)
                fp = kernels.segment_fp_fixed(slabs[i], fp_seg_bytes, t)
                results.append((cand, tags, literals, n_lit, fp))
                done.append(record_event(st))
        # 3. assemble on the first device, in its caller's stream order
        nb, nf = n_local // block_bytes, n_local // fp_seg_bytes
        for i, (st, res) in enumerate(zip(streams, results)):
            r, c = divmod(i, seq)
            rows = slice(r * b_local, (r + 1) * b_local)
            with on_stream(st), on_stream(caller):
                if caller is not None:
                    caller.wait_event(done[i])
                dests = (
                    out["candidates"][rows, c * n_local : (c + 1) * n_local],
                    out["tags"][rows, c * nb : (c + 1) * nb],
                    out["literals"][rows, c * n_local : (c + 1) * n_local],
                    out["n_lit"][rows, c],
                    out["fp_lanes"][rows, c * nf : (c + 1) * nf],
                )
                for dst, src in zip(dests, res):
                    dst.copy_(src)
                    if caller is not None and src.device == dev0:
                        src.record_stream(caller)
        return out

    return step
