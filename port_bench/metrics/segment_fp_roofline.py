"""K-C segment_fp: bytes bound (rows read once, lanes written once, 3.35 TB/s) over its traced device time, in %."""

from pbench import readers


def read(run):
    return readers.kernel_roofline_pct(run, "segment_fp")
