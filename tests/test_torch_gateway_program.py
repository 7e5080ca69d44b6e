"""The port's gateway program IR and egress price grid against the JAX package's.

``GatewayProgram.to_dict()`` gives the same JSON for a direct, a multicast
(``mux_and``) and a relay program built through the same calls, and
``op_from_dict`` round-trips each op; ``planner/pricing.py`` prices the same
region pairs alike, with the built-in grid and with both overrides.
"""

from __future__ import annotations

import json

import pytest

from skyplane_tpu.gateway import gateway_program as ref_gp
from skyplane_tpu.planner import pricing as ref_pricing
from skyplane_tpu_torch.gateway import gateway_program as port_gp
from skyplane_tpu_torch.planner import pricing as port_pricing


def _direct(gp, src: bool):
    prog = gp.GatewayProgram()
    for pid in ("p0", "p1"):
        if src:
            h = prog.add_operator(gp.GatewayReadLocal(num_connections=8), partition_id=pid)
            prog.add_operator(
                gp.GatewaySend("gw_dst", "aws:us-east-1", num_connections=16, compress="tpu", encrypt=True, dedup=True),
                parent_handle=h, partition_id=pid,
            )
        else:
            h = prog.add_operator(gp.GatewayReceive(decrypt=True, dedup=True), partition_id=pid)
            prog.add_operator(gp.GatewayWriteLocal(path="/out"), parent_handle=h, partition_id=pid)
    return prog


def _multicast(gp):
    prog = gp.GatewayProgram()
    h = prog.add_operator(gp.GatewayReadObjectStore("bkt", "aws:us-east-1", num_connections=4))
    mux = prog.add_operator(gp.GatewayMuxAnd(), parent_handle=h)
    for i, region in enumerate(("gcp:us-central1", "azure:eastus")):
        prog.add_operator(gp.GatewaySend(f"gw_{i}", region, peer_serve=bool(i), raw_eligible=i == 0), parent_handle=mux)
    prog.add_operator(gp.GatewayWriteObjectStore("bkt2", "aws:us-east-1"), parent_handle=mux)
    other = prog.add_operator(gp.GatewayGenData(size_mb=64), partition_id="p9")
    orx = prog.add_operator(gp.GatewayMuxOr(handle="or"), parent_handle=other, partition_id="p9")
    prog.add_operator(gp.GatewaySend("gw_x", "aws:eu-west-1", private_ip=True), parent_handle=orx, partition_id="p9")
    return prog


def _relay(gp):
    prog = gp.GatewayProgram()
    h = prog.add_operator(gp.GatewayReceive(decrypt=False))
    prog.add_operator(gp.GatewaySend("gw_next", "gcp:europe-west4", compress="none"), parent_handle=h)
    return prog


PROGRAMS = {
    "direct_source": lambda gp: _direct(gp, True),
    "direct_destination": lambda gp: _direct(gp, False),
    "multicast": _multicast,
    "relay": _relay,
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_json_equals_the_jax_package(name):
    port, ref = PROGRAMS[name](port_gp), PROGRAMS[name](ref_gp)
    assert port.to_json() == ref.to_json()
    d = port.to_dict()
    for group in d["plan"]:
        for root in group["value"]:
            assert port_gp.GatewayProgram.op_from_dict(root).to_dict() == ref_gp.GatewayProgram.op_from_dict(root).to_dict() == root
    assert json.loads(port.to_json()) == d


def test_duplicate_and_unknown_handles_raise_alike():
    for gp in (port_gp, ref_gp):
        prog = gp.GatewayProgram()
        prog.add_operator(gp.GatewayReceive(handle="r"))
        with pytest.raises(ValueError, match="duplicate"):
            prog.add_operator(gp.GatewayReceive(handle="r"))
        with pytest.raises(ValueError, match="unknown parent"):
            prog.add_operator(gp.GatewayWriteLocal(), parent_handle="nope")
        with pytest.raises(ValueError, match="unknown op_type"):
            gp.GatewayProgram.op_from_dict({"op_type": "teleport"})


REGIONS = ["aws:us-east-1", "aws:eu-west-1", "gcp:us-central1", "gcp:asia-east1", "azure:eastus", "local:local",
           "ibmcloud:us-south", "aws:ap-southeast-2"]


@pytest.mark.parametrize("override", [None, "grid", "file"])
def test_egress_prices_equal_the_jax_package(tmp_path, monkeypatch, override):
    if override == "grid":
        grid = tmp_path / "grid.csv"
        grid.write_text("src_region,dst_region,cost_per_gb\naws:us-east-1,gcp:us-central1,0.0123\ngcp:asia-east1,internet,0.5\n")
        monkeypatch.setenv(port_pricing.GRID_ENV, str(grid))
    elif override == "file":
        f = tmp_path / "prices.json"
        f.write_text(json.dumps({"aws:us-east-1->azure:eastus": 0.07}))
        monkeypatch.setenv("SKYPLANE_TPU_PRICING_FILE", str(f))
    for mod in (port_pricing, ref_pricing):
        mod.reset_pricing_caches()
    try:
        for a in REGIONS:
            for vm in (None, "m5.8xlarge", "n2-standard-8", "Standard_D4_v5"):
                assert port_pricing.get_instance_cost_per_hr(a, vm) == ref_pricing.get_instance_cost_per_hr(a, vm)
            for b in REGIONS:
                assert port_pricing.get_egress_cost_per_gb(a, b) == ref_pricing.get_egress_cost_per_gb(a, b), (a, b)
                assert port_pricing.get_flat_egress_cost_per_gb(a, b) == ref_pricing.get_flat_egress_cost_per_gb(a, b)
    finally:
        for mod in (port_pricing, ref_pricing):
            mod.reset_pricing_caches()
