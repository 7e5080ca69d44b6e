"""Sender operator queue and read (operators/gateway_operator.py): admit_wait ns (the POST to a sender worker's dequeue, the chunk.admit span) over chunks encoded, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "sender", "admit_wait_ns", "chunks")
