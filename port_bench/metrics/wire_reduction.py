"""Raw bytes of the window's chunks, once per stream, over the bytes the loopback link carried from the window's start until the last of them landed (frames, TLS, TCP and IP headers, acks: the egress paid for)."""

from pbench import readers


def read(run):
    return readers.wire_reduction(run)
