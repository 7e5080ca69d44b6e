"""Relay (blast interior gateway): encode ns of its peer-serve senders (process(), the datapath.encode span) over the chunks they encoded, one a child, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "relay", "encode_ns", "chunks")
