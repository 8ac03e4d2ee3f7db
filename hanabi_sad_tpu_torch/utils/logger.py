"""Stdout tee logger (counterpart of `hanabi_sad_tpu/utils/logger.py`).

The training log doubles as the record of the run's config: the driver
pretty-prints its config dict at startup."""

from __future__ import annotations

import sys


class Logger:
    def __init__(self, path: str, mode: str = "w"):
        assert mode in {"w", "a"}
        self.terminal = sys.stdout
        self.log = open(path, mode)

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()
