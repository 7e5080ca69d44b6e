"""Receiver decode pool and restore (operators/gateway_receiver.py): queue ns (a frame's last byte received to a decode worker starting it, the decode.queue span) over chunks decoded at the sinks, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "decode", "decode_queue_ns", "decode_chunks")
