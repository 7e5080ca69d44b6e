"""Receiver decode pool and restore (operators/gateway_receiver.py): restore ns (the codec and recipe restore, the decode.restore span) over chunks decoded at the sinks, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "decode", "restore_ns", "decode_chunks")
