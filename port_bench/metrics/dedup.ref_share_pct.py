"""Recipe and index (ops/dedup.py): REF segments over all segments the source's senders emitted, in %."""

from pbench import readers


def read(run):
    return readers.ref_share_pct(run)
