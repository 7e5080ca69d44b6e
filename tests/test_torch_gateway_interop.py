"""A port gateway and a JAX-package gateway exchange chunks over real sockets.

Level 4 of "held against the reference": a port sender feeds a JAX-package
receiver, and a JAX-package sender feeds a port receiver, with TLS on the
data sockets, AES-GCM end-to-end encryption, dedup and codec ``tpu``; every
chunk lands byte-identical at its destination file, and REF recipes emitted
by one package resolve in the other's segment store. One port -> port pair,
wired as ``chip_smoke.py``'s gateway phase wires it (batch runners on both
sides, paranoid verification), runs from source files to destination files.
"""

from __future__ import annotations

import numpy as np
import pytest

from skyplane_tpu_torch.chunk import Chunk, ChunkRequest
from skyplane_tpu_torch.gateway.loopback import LoopbackPair
from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
from skyplane_tpu_torch.ops.cdc import CDCParams
from tests.torch_gateway_util import cross_pair, file_requests, jax_native_build_dir, make_sender, pkg_ns, write_sources  # noqa: F401

KEY = bytes(range(32))


def _corpus(seed: int):
    """Five files: random, a repeat (all REF), a shifted partial repeat, a zero
    run beside random bytes, and a repeat of the partial."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, 120_000, dtype=np.uint8).tobytes()
    b = a[7_000:90_000] + rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
    return [a, a, b, bytes(50_000) + rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(), b]


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_cross_package_transfer_with_tls_and_e2ee(tmp_path, src, dst):
    datas = _corpus(31)
    files = write_sources(tmp_path, datas)
    cdc = pkg_ns(src).CDCParams(min_bytes=2048, avg_bytes=8192, max_bytes=32768)
    rcdc = pkg_ns(dst).CDCParams(min_bytes=2048, avg_bytes=8192, max_bytes=32768)
    pair = cross_pair(
        src, dst, tmp_path,
        sender_kw=dict(codec_name="tpu", dedup=True, use_tls=True, e2ee_key=KEY, cdc_params=cdc, window=4),
        receiver_kw=dict(dedup=True, use_tls=True, e2ee_key=KEY, cdc_params=rcdc, decode_workers=2),
    )
    try:
        reqs = file_requests(src, files)
        pair.submit(reqs[:1])  # the first literals land before any REF to them is framed
        assert len(pair.wait_written(1, timeout=60.0)) == 1
        pair.submit(reqs[1:])
        written = pair.wait_written(len(files) - 1, timeout=60.0)
        errors = pair.errors()
        assert len(written) == len(files) - 1 and not errors, errors
        for (_, dest, _), data in zip(files, datas):
            assert dest.read_bytes() == data, f"{src} -> {dst}: {dest.name} differs from its source"
        stats = pair.sender.datapath_counters()
        assert stats["ref_segments"] > 0, "no REF crossed the wire: the cross-package resolution is untested"
        counters = pair.receiver.decode_counters()
        assert counters["decode_nacks"] == 0 and counters["store_mem_hits"] > 0
        assert pair.sender.wire_counters()["nacks_reaped"] == 0
    finally:
        pair.stop()


def test_port_pair_from_source_files_to_destination_files(tmp_path, monkeypatch):
    """Source files -> read_local -> sender (runner, dedup, codec tpu) ->
    TCP -> receiver (runner, paranoid verify) -> wait_receiver -> write_local."""
    monkeypatch.setenv("SKYPLANE_TPU_PARANOID_VERIFY", "1")
    datas = _corpus(41) + _corpus(42)
    files = write_sources(tmp_path, datas)
    params = CDCParams()
    sender_runner = DeviceBatchRunner(cdc_params=params, max_batch=8, device="cpu")
    receiver_runner = DeviceBatchRunner(cdc_params=params, max_batch=8, device="cpu")
    pair = LoopbackPair(
        tmp_path / "gw",
        sender_kw=dict(codec_name="tpu", dedup=True, use_tls=False, batch_runner=sender_runner, window=16, device="cpu"),
        receiver_kw=dict(dedup=True, use_tls=False, batch_runner=receiver_runner, decode_workers=2, device="cpu"),
        n_read=4, n_send=4,
    )
    pair.start()
    try:
        pair.submit([
            ChunkRequest(chunk=Chunk(src_key=str(s), dest_key=str(d), chunk_id=f"{i:032x}", chunk_length_bytes=n, file_offset_bytes=0))
            for i, (s, d, n) in enumerate(files)
        ])
        written = pair.wait_written(len(files), timeout=60.0)
        assert len(written) == len(files), pair.errors()
        assert not pair.error_event.is_set()
        for (_, dest, _), data in zip(files, datas):
            assert dest.read_bytes() == data, f"{dest.name} differs from its source"
        verify = pair.receiver.decode_counters()
        assert verify["verify_total"] > 0, "paranoid verification never ran"
        assert verify["verify_batched"] == 0  # counted only on the card
        assert pair.sender.datapath_counters()["batch_rows"] == len(files)
        assert receiver_runner.counters()["batch_rows"] == verify["verify_total"]
    finally:
        pair.stop()


def test_sender_and_receiver_refuse_a_runner_on_another_device(tmp_path):
    import queue
    import threading

    class OtherRunner:
        device = "cuda:0"

    with pytest.raises(ValueError, match="runner"):
        make_sender("port", tmp_path, 0, batch_runner=OtherRunner())
    ns = pkg_ns("port")
    with pytest.raises(ValueError, match="runner"):
        ns.GatewayReceiver(
            "local:dst", ns.ChunkStore(str(tmp_path / "rx")), threading.Event(), queue.Queue(),
            use_tls=False, dedup=True, batch_runner=OtherRunner(), device="cpu",
        )
