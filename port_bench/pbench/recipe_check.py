"""The recipes the source put on the wire, against the reference.

A tap on each source sender keeps the recipe head (magic, version, entry
count, and every entry: kind, 16-byte fingerprint, segment length) of
every frame it built for a sample of the window's chunks, before
encryption seals it. After the window the reference works the segments
and fingerprints out again from the offered bytes, and each tapped recipe
must list exactly them. A sampled chunk that reached the wire by a path
that built no recipe has no head, and counts as wrong.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Set, Tuple

MAGIC = b"\xde\xd1"
_HEAD = struct.Struct("<BI")
_ENTRY = struct.Struct("<B16sQ")


class FrameTap:
    """Wraps ``_frame_chunk`` of each sender operator and keeps the recipe
    heads of the chunks in ``sample``: every frame built for them, by
    stream (``list.append`` and ``dict.setdefault`` are atomic, so the
    senders' threads take no lock here)."""

    def __init__(self, senders, sample: Set[str]):
        self.sample = sample
        self.heads: Dict[str, List[Tuple[str, bytes]]] = {}
        for op in senders:
            self._wrap(op)

    def _wrap(self, op) -> None:
        inner = op._frame_chunk
        stream = op.target_gateway_id

        def frame_chunk(chunk_req, view, n_left):
            payload, wire, header = inner(chunk_req, view, n_left)
            cid = chunk_req.chunk.chunk_id
            if cid in self.sample and payload is not None:
                head = payload.wire_bytes[: len(MAGIC) + _HEAD.size + _ENTRY.size * payload.n_segments]
                self.heads.setdefault(cid, []).append((stream, bytes(head)))
            return payload, wire, header

        op._frame_chunk = frame_chunk


def parse_head(head: bytes) -> List[Tuple[int, bytes]]:
    """(segment length, fingerprint) per entry of a recipe head."""
    if head[:2] != MAGIC:
        raise ValueError("not a recipe")
    ver, n = _HEAD.unpack_from(head, 2)
    if ver != 1 or len(head) < 2 + _HEAD.size + n * _ENTRY.size:
        raise ValueError("truncated recipe head")
    out = []
    for i in range(n):
        _, fp, seg_len = _ENTRY.unpack_from(head, 2 + _HEAD.size + i * _ENTRY.size)
        out.append((seg_len, fp))
    return out


def count_bad(heads: Dict[str, List[Tuple[str, bytes]]], expected: Dict[str, List[Tuple[int, bytes]]],
              streams: List[str]) -> Tuple[int, List[str]]:
    """Sampled (chunk, stream) pairs whose every frame does not list the
    reference's segments: a frame that differs, or no frame at all."""
    bad, notes = 0, []
    for cid, want in expected.items():
        frames = heads.get(cid, [])
        for stream in streams:
            mine = [h for s, h in frames if s == stream]
            ok = bool(mine)
            for h in mine:
                try:
                    ok = ok and parse_head(h) == want
                except ValueError:
                    ok = False
            if not ok:
                bad += 1
                if len(notes) < 5:
                    notes.append(f"chunk {cid} stream {stream}: {len(mine)} frames, none or not all equal to the reference's {len(want)} segments")
    return bad, notes
