"""Dual console/file logger (reference: skyplane/utils/logger.py:1-60).

``logger`` logs to the console; ``logger.fs`` logs to a per-run file under
``$TMPDIR/skyplane_tpu_torch`` (quiet on console) for post-mortem debugging;
``SKYPLANE_TPU_LOG_DIR`` moves it.
"""

from __future__ import annotations

import logging
import os
import sys
import tempfile
from pathlib import Path

_LOG_DIR = Path(os.environ.get("SKYPLANE_TPU_LOG_DIR") or Path(tempfile.gettempdir()) / "skyplane_tpu_torch")
_FMT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def _make_console_logger() -> logging.Logger:
    log = logging.getLogger("skyplane_tpu_torch")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT))
        log.addHandler(handler)
        log.setLevel(os.environ.get("SKYPLANE_TPU_LOG_LEVEL", "WARNING").upper())
    return log


def _make_fs_logger() -> logging.Logger:
    log = logging.getLogger("skyplane_tpu_torch.fs")
    if not log.handlers:
        log.propagate = False
        try:
            _LOG_DIR.mkdir(parents=True, exist_ok=True)
            handler: logging.Handler = logging.FileHandler(_LOG_DIR / "client.log")
        except OSError:
            handler = logging.NullHandler()
        handler.setFormatter(logging.Formatter(_FMT))
        log.addHandler(handler)
        log.setLevel(logging.DEBUG)
    return log


class _Logger:
    def __init__(self):
        self._console = _make_console_logger()
        self.fs = _make_fs_logger()

    def __getattr__(self, name):
        return getattr(self._console, name)


logger = _Logger()
