"""Durable filesystem landings: the fsync discipline behind every
journal/snapshot/state-file replace in the codebase.

``os.replace`` alone is atomic against CONCURRENT readers but not against
POWER LOSS: without an fsync of the staged file, the rename can land while
the file's bytes are still in the page cache (a zero-length or partial
"snapshot" after a crash), and without an fsync of the parent DIRECTORY the
rename itself can be forgotten. The ``unsynced-durable-write`` lint rule
(docs/static-analysis.md) enforces that every durable replace either calls
:func:`fsync_replace` or does both fsyncs inline.
"""

from __future__ import annotations

import os
from pathlib import Path


def fsync_dir(path) -> None:
    """fsync a DIRECTORY so a rename/replace inside it survives power loss —
    both inodes' contents being synced does not make the *rename* durable."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_replace(tmp, dst) -> None:
    """Durable atomic replace: fsync the staged file, ``os.replace`` it over
    the destination, fsync the parent directory."""
    tmp, dst = Path(tmp), Path(dst)
    fd = os.open(str(tmp), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dst)
    fsync_dir(dst.parent)
