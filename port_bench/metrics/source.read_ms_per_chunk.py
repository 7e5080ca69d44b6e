"""Sender operator queue and read (operators/gateway_operator.py): read ns (the framer's chunk-file read, the chunk.read span) over chunks encoded, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "sender", "read_ns", "chunks")
