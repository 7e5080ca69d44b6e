"""Micro-batching (ops/batch_runner.py): host-to-device upload ns of the rows staged at submit (the device.stage span) over rows staged, in ms."""

from pbench import stages


def read(run):
    return stages.ms_per(run, "runner", "stage_ns", "stage_rows")
