"""K-AB gear_compact: bytes bound (rows read once, candidates written once, 3.35 TB/s) over its traced device time, in %."""

from pbench import readers


def read(run):
    return readers.kernel_roofline_pct(run, "gear_compact")
