"""Seconds from process start to the first due chunk."""


def read(run):
    return run.setup_s
