"""Micro-batching (ops/batch_runner.py): rows over batch windows of the source daemon's runner."""

from pbench import readers


def read(run):
    return readers.rows_per_window(run)
