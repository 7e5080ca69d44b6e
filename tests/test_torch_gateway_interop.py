"""A port gateway and a JAX-package gateway exchange chunks over real sockets.

Level 4 of "held against the reference": a port daemon sends to a JAX-package
daemon, and a JAX-package daemon sends to a port daemon, with TLS on the data
sockets and the control API, AES-GCM end-to-end encryption, dedup and codec
``tpu``; every chunk lands byte-identical at its destination file, and REF
recipes emitted by one package resolve in the other's segment store. One
port -> port daemon pair, wired as ``chip_smoke.py``'s gateway phase wires it
(batch runners on both sides, paranoid verification), runs from source files
to destination files.
"""

from __future__ import annotations

import numpy as np
import pytest

from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
from skyplane_tpu_torch.ops.cdc import CDCParams
from tests.torch_gateway_util import (  # noqa: F401
    dispatch, jax_native_build_dir, make_pair, make_sender, pkg_ns, stop_all, wait_complete, write_sources,
)

KEY = bytes(range(32))


def _corpus(seed: int):
    """Five files: random, a repeat (all REF), a shifted partial repeat, a zero
    run beside random bytes, and a repeat of the partial."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, 120_000, dtype=np.uint8).tobytes()
    b = a[7_000:90_000] + rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()
    return [a, a, b, bytes(50_000) + rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(), b]


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_cross_package_transfer_with_tls_and_e2ee(tmp_path, monkeypatch, src, dst):
    monkeypatch.setenv("SKYPLANE_TPU_DECODE_WORKERS", "2")
    datas = _corpus(31)
    files = write_sources(tmp_path, datas)
    cdc = {"min_bytes": 2048, "avg_bytes": 8192, "max_bytes": 32768}
    s, d = make_pair(
        tmp_path, src, dst, compress="tpu", dedup=True, encrypt=True, use_tls=True, key=KEY, window=4,
        src_kw={"cdc_params": pkg_ns(src).CDCParams(**cdc)}, dst_kw={"cdc_params": pkg_ns(dst).CDCParams(**cdc)},
    )
    try:
        wait_complete(d, dispatch(s, files[:1]))  # the first literals land before any REF to them is framed
        wait_complete(d, dispatch(s, files[1:]))
        for (_, dest, _), data in zip(files, datas):
            assert dest.read_bytes() == data, f"{src} -> {dst}: {dest.name} differs from its source"
        stats = s.sender().datapath_counters()
        assert stats["ref_segments"] > 0, "no REF crossed the wire: the cross-package resolution is untested"
        counters = d.daemon.receiver.decode_counters()
        assert counters["decode_nacks"] == 0 and counters["store_mem_hits"] > 0
        assert s.sender().wire_counters()["nacks_reaped"] == 0
    finally:
        stop_all(s, d)


def test_port_pair_from_source_files_to_destination_files(tmp_path, monkeypatch):
    """Source files -> read_local -> sender (runner, dedup, codec tpu) ->
    TCP -> receiver (runner, paranoid verify) -> wait_receiver -> write_local,
    through two port daemons."""
    monkeypatch.setenv("SKYPLANE_TPU_PARANOID_VERIFY", "1")
    monkeypatch.setenv("SKYPLANE_TPU_DECODE_WORKERS", "2")
    datas = _corpus(41) + _corpus(42)
    files = write_sources(tmp_path, datas)
    params = CDCParams()
    sender_runner = DeviceBatchRunner(cdc_params=params, max_batch=8, device="cpu")
    receiver_runner = DeviceBatchRunner(cdc_params=params, max_batch=8, device="cpu")
    s, d = make_pair(
        tmp_path / "gw", compress="tpu", dedup=True, num_connections=4, window=16,
        src_kw={"cdc_params": params, "batch_runner": sender_runner},
        dst_kw={"cdc_params": params, "batch_runner": receiver_runner},
    )
    try:
        wait_complete(d, dispatch(s, files))
        for (_, dest, _), data in zip(files, datas):
            assert dest.read_bytes() == data, f"{dest.name} differs from its source"
        verify = d.daemon.receiver.decode_counters()
        assert verify["verify_total"] > 0, "paranoid verification never ran"
        assert verify["verify_batched"] == 0  # counted only on the card
        assert s.sender().datapath_counters()["batch_rows"] == len(files)
        assert receiver_runner.counters()["batch_rows"] == verify["verify_total"]
    finally:
        stop_all(s, d)


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
