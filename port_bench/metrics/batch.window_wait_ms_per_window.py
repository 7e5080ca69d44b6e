"""Micro-batching (ops/batch_runner.py): the leaders' window wait ns (the batch.window_wait span) over batch windows of the source daemon's runner, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "runner", "window_wait_ns", "batch_windows")
