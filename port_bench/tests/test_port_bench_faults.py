"""A whole run with the timed path broken underneath (the chip's look
skipped: the run is on the CPU) must come out not correct, once for each
fault a gateway cell can have. Cells on one chip have no exchange between
chips to leave out."""

import pytest

from conftest import run_in_process


def _shift_first_end(select):
    """A boundary moved by one byte where it is produced: the recipe stays
    self-consistent (the files still land right), the segments are wrong."""
    def shifted(candidates, n, params):
        ends = select(candidates, n, params).copy()
        if len(ends) > 1 and ends[0] + 1 < ends[1]:
            ends[0] += 1
        return ends
    return shifted


def _staging(transform):
    """The source's ``read_local`` stages each chunk through ``transform``
    (data, request) -> the bytes it writes to its chunk store."""
    def process(self, chunk_req, worker_id):
        chunk = chunk_req.chunk
        with open(chunk.src_key, "rb") as f:
            f.seek(chunk.file_offset_bytes or 0)
            data = f.read(chunk.chunk_length_bytes)
        self.chunk_store.chunk_path(chunk.chunk_id).write_bytes(transform(data, chunk_req))
        return True
    return process


def _flip_first_byte(data, chunk_req):
    return bytes([data[0] ^ 0xFF]) + data[1:] if data else data


def _first_half_only(data, chunk_req):
    """Half of each chunk's bytes left out: the second half is staged as zeros."""
    half = len(data) // 2
    return data[:half] + bytes(len(data) - half)


def plant(monkeypatch, fault: str) -> None:
    """Break the timed path where it runs in this process: the source
    daemon (the sinks are processes of their own)."""
    from skyplane_tpu_torch.gateway.operators import gateway_operator
    from skyplane_tpu_torch.ops import fused_cdc

    read = gateway_operator.GatewayReadLocalOperator
    if fault == "segment_boundary_altered":
        monkeypatch.setattr(fused_cdc, "select_boundaries", _shift_first_end(fused_cdc.select_boundaries))
    elif fault == "chunk_byte_altered":
        monkeypatch.setattr(read, "process", _staging(_flip_first_byte))
    elif fault == "half_of_each_chunk_left_out":
        monkeypatch.setattr(read, "process", _staging(_first_half_only))
    elif fault == "staging_returns_state_unchanged":
        # the step reports success and leaves its buffer as it found it
        monkeypatch.setattr(read, "process", _staging(lambda data, chunk_req: bytes(len(data))))
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault", ["segment_boundary_altered", "chunk_byte_altered", "half_of_each_chunk_left_out",
                                   "staging_returns_state_unchanged"])
def test_fault_makes_the_run_not_correct(monkeypatch, fault):
    plant(monkeypatch, fault)
    rc, result, err = run_in_process("direct.snapchain.bulk", seed=2**31 + 3)
    assert rc == 0 and result is not None and not result["correct"], err[-3000:]
    assert "check landed_bad" in err and "check recipe_bad" in err
