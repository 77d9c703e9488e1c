"""Logging (counterpart of ``sopht_mpi_tpu/utils/logging_utils.py``).

One Python process drives the card, so the reference's rank-filtered
logger is a plain one: console output, and a logfile on request
(optionally with a timestamped name). Every module of the package logs
through the one ``logging.Logger`` named ``"sopht_mpi_tpu_torch"``.
"""

from __future__ import annotations

import logging
import sys
from datetime import datetime

LOGGER_NAME = "sopht_mpi_tpu_torch"


class FlowLogger:
    """Console (+ optional file) logger; every instance wraps the one
    package logger."""

    def __init__(self, level=logging.INFO):
        self._logger = logging.getLogger(LOGGER_NAME)
        self._logger.setLevel(level)
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
            self._logger.addHandler(handler)

    def enable_write_to_logfile(self, filename: str | None = None,
                                timestamp: bool = True):
        """Also write to ``<filename>[_YYYYmmdd_HHMMSS].log``."""
        if filename is None:
            filename = "sopht_torch"
        if timestamp:
            filename = f"{filename}_{datetime.now():%Y%m%d_%H%M%S}"
        handler = logging.FileHandler(f"{filename}.log")
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
        )
        self._logger.addHandler(handler)

    def debug(self, msg, *a, **k):
        self._logger.debug(msg, *a, **k)

    def info(self, msg, *a, **k):
        self._logger.info(msg, *a, **k)

    def warning(self, msg, *a, **k):
        self._logger.warning(msg, *a, **k)

    def error(self, msg, *a, **k):
        self._logger.error(msg, *a, **k)

    def setLevel(self, level):
        self._logger.setLevel(level)


# the package's logger
logger = FlowLogger()
