"""The port's fleet dedup fabric (``skyplane_tpu_torch/dedup_fabric/``) against
the JAX package's: ring owners for the same members and vnodes, the results of
a summary-exchange round, and cross-gateway dedup by peer fetch between port
daemons (the twin of ``tests/integration/test_dedup_fabric.py``).
"""

from __future__ import annotations

import random
import time

import numpy as np
import pytest

from skyplane_tpu import dedup_fabric as ref_fabric
from skyplane_tpu_torch import dedup_fabric as port_fabric
from tests.torch_gateway_util import (  # noqa: F401
    dispatch, jax_native_build_dir, program, read_local_op, receive_op, send_op, start_gateway, stop_all,
    wait_complete,
)

PKGS = {"port": port_fabric, "ref": ref_fabric}


def _owners(mod, members, vnodes: int, fps):
    ring = mod.ConsistentHashRing(vnodes=vnodes)
    for i, m in enumerate(members):
        ring.add_node(m, seat=f"seat{i}" if i % 2 else None)
    excl = members[:1] if len(members) > 1 else []
    return ([ring.owner(fp) for fp in fps], [ring.owners(fp, 2) for fp in fps[:2000]],
            [ring.owner(fp, exclude=excl) for fp in fps[:2000]], ring.nodes())


@pytest.mark.parametrize("n_members", [1, 2, 3, 4, 5])
def test_ring_owners_equal_the_jax_package(n_members):
    rng = np.random.default_rng(n_members)
    fps = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(10_000)]
    members = [f"gw_{i}" for i in range(n_members)]
    for vnodes in (port_fabric.ConsistentHashRing().vnodes, 16):
        got = _owners(port_fabric, members, vnodes, fps)
        assert got == _owners(ref_fabric, members, vnodes, fps)
        assert set(got[0]) == set(members)


class _FakeSession:
    """The two routes of a gossip round, served by in-memory fabrics."""

    class _Resp:
        def __init__(self, doc):
            self._doc = doc

        def raise_for_status(self):
            pass

        def json(self):
            return self._doc

    def __init__(self, fabric):
        self.fabric = fabric

    def get(self, url, timeout=None):
        assert url.endswith("/fabric/summary")
        return self._Resp(self.fabric.summary())

    def post(self, url, json=None, timeout=None):
        return self._Resp({"absorbed": self.fabric.absorb(json)})


def _exchange(mod):
    """Three fabrics of one package, each proving its own seeded segments,
    one all-pairs summary round; returns what every fabric absorbed."""
    members = {"members": [{"id": f"gw_{i}"} for i in range(3)], "draining": []}  # no url: no pushes
    fabrics = []
    for i in range(3):
        fab = mod.DedupFabric(f"gw_{i}")
        fab.configure(members)
        rng = random.Random(i)
        for _ in range(50 + 25 * i):
            data = rng.randbytes(rng.randrange(64, 2048))
            fab.note_put(rng.randbytes(16), data)
        fabrics.append(fab)
    stats = mod.run_summary_exchange([(f"http://127.0.0.1:{9000 + i}", _FakeSession(f)) for i, f in enumerate(fabrics)])
    out = [stats]
    for fab in fabrics:
        c = fab.counters()
        out.append((sorted(fab.absorbed_fps()), c["fabric_fps_absorbed"], c["fabric_summaries_absorbed"]))
        fab.close()
    return out


def test_summary_exchange_equals_the_jax_package():
    got = _exchange(port_fabric)
    assert got == _exchange(ref_fabric)
    assert got[0]["posted"] == 6 and got[0]["failed"] == 0 and got[0]["fps"] > 0


# ---- the twin of test_cross_gateway_dedup_via_peer_fetch, on port daemons ----


def _start_fleet(tmp):
    """Two disjoint src -> dst pairs of port daemons; both receivers joined
    into one fabric ring before any data moves."""
    dst_prog = program(receive_op(dedup=True))
    dstA = start_gateway("port", dst_prog, {}, "gw_dstA", tmp / "dstA_chunks", use_tls=False)
    dstB = start_gateway("port", dst_prog, {}, "gw_dstB", tmp / "dstB_chunks", use_tls=False)
    srcs = []
    for name, dst in (("A", dstA), ("B", dstB)):
        target = f"gw_dst{name}"
        srcs.append(start_gateway(
            "port", program(read_local_op(send_op(target, dedup=True))),
            {target: {"public_ip": "127.0.0.1", "control_port": dst.control_port}},
            f"gw_src{name}", tmp / f"src{name}_chunks", use_tls=False,
        ))
    membership = {
        "members": [
            {"id": "gw_dstA", "url": f"http://127.0.0.1:{dstA.control_port}", "seat": "gw_dstA"},
            {"id": "gw_dstB", "url": f"http://127.0.0.1:{dstB.control_port}", "seat": "gw_dstB"},
        ],
        "draining": [],
    }
    for gw in (dstA, dstB):
        resp = gw.post("fabric/membership", json=membership, timeout=10)
        resp.raise_for_status()
        assert resp.json()["members"] == 2
    return srcs[0], dstA, srcs[1], dstB


def _metric(gw, sample: str) -> float:
    for line in gw.get("metrics", timeout=10).text.splitlines():
        if line.startswith(f"{sample} "):
            return float(line.split()[-1])
    return 0.0


def test_cross_gateway_dedup_via_peer_fetch(tmp_path):
    data = random.Random(7).randbytes(1536 << 10)
    f = tmp_path / "corpus.bin"
    f.write_bytes(data)
    outA, outB = tmp_path / "out" / "a.bin", tmp_path / "out" / "b.bin"
    srcA, dstA, srcB, dstB = _start_fleet(tmp_path)
    try:
        ids = dispatch(srcA, [(f, outA, len(data))], chunk_bytes=256 << 10)
        wait_complete(srcA, ids, timeout=120)
        wait_complete(dstA, ids, timeout=120)
        assert outA.read_bytes() == data
        deadline = time.time() + 30
        while dstA.daemon.fabric.counters()["fabric_push_queue_depth"] and time.time() < deadline:
            time.sleep(0.2)
        time.sleep(0.3)  # let an in-flight push finish landing

        stats = port_fabric.run_summary_exchange(
            [(f"http://127.0.0.1:{gw.control_port}/api/v1", gw.session()) for gw in (dstA, dstB, srcB)]
        )
        assert stats["failed"] == 0 and stats["fps"] > 0
        sender = srcB.sender()
        assert sender.dedup_index.counters()["index_remote_entries"] > 0

        ids2 = dispatch(srcB, [(f, outB, len(data))], chunk_bytes=256 << 10)
        wait_complete(srcB, ids2, timeout=180)
        wait_complete(dstB, ids2, timeout=180)
        assert outB.read_bytes() == data
        s = sender.processor.stats.as_dict()
        assert s["segments"] > 0 and s["ref_segments"] == s["segments"]
        fab = dstB.daemon.fabric.counters()
        assert fab["fabric_peer_fetch_hits"] > 0, fab
        assert dstB.daemon.receiver.nacks_total == 0
        assert fab["fabric_land_rejects"] == 0
        assert _metric(dstB, 'skyplane_peer_fetch_total{result="hit"}') > 0
        assert _metric(dstB, "skyplane_peer_fetch_seconds_count") > 0
        assert _metric(srcB, "skyplane_cross_shard_nacks_total") == 0
        assert _metric(dstB, "skyplane_fabric_peer_fetch_hits") == fab["fabric_peer_fetch_hits"]
    finally:
        stop_all(srcA, srcB, dstA, dstB)
