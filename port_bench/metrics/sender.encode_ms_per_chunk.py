"""Sender data path (ops/pipeline.py DataPathProcessor): encode ns (process(), the datapath.encode span) over chunks encoded, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "sender", "encode_ns", "chunks")
