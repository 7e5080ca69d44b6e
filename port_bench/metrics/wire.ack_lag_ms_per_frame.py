"""Sender wire engine (operators/sender_wire.py): ack lag ns over frames sent, in ms."""

from pbench import readers


def read(run):
    return readers.ack_lag_ms_per_frame(run)
