"""Raw Gbps of the chunks due in the window that were complete at every sink when it closed (the benchmark's own query) and byte-identical."""

from pbench import readers


def read(run):
    return readers.goodput_gbps(run)
