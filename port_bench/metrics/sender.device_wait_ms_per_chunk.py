"""Sender data path (ops/pipeline.py DataPathProcessor): device wait ns over chunks encoded, in ms."""

from pbench import readers


def read(run):
    return readers.device_wait_ms_per_chunk(run)
