"""Relay (blast interior gateway): rows over batch windows of the relay's own batch runner."""

from pbench import readers


def read(run):
    if "batch_rows" not in run.after.get("relay", {}):
        return None
    return readers.ratio(run.delta("relay", "batch_rows"), run.delta("relay", "batch_windows"))
