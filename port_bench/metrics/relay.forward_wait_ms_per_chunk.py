"""Relay (blast interior gateway): forward wait ns (relay.forward: its receive operator handing a landed chunk on, to a peer-serve sender worker dequeuing it) over the chunks so counted, once a sender operator, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "relay", "forward_wait_ns", "forward_chunks")
