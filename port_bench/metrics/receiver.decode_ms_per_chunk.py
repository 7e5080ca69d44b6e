"""Receiver decode pool and restore (operators/gateway_receiver.py): decode ns over chunks decoded at the sinks, in ms."""

from pbench import readers


def read(run):
    return readers.decode_ms_per_chunk(run)
