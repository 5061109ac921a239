"""Stdout tee (the JAX package's ``utils/logger.Logger``, after the
reference's utils/logger.py:4-21): the training entry point copies its
console output into ``log/<name>.stdout``."""

from __future__ import annotations

import sys


class Logger:
    """Tees writes to the real stdout and a log file. Use:
        sys.stdout = Logger("log/run.stdout")
    """

    def __init__(self, path: str, mode: str = "a"):
        self.terminal = sys.stdout
        self.log = open(path, mode, encoding="utf-8")

    def write(self, message: str) -> int:
        n = self.terminal.write(message)
        self.log.write(message)
        return n  # TextIOBase contract: chars written

    def flush(self) -> None:
        self.terminal.flush()
        self.log.flush()

    def close(self) -> None:
        self.log.close()

    def __getattr__(self, name):
        # the rest of the stream protocol (isatty, encoding, fileno, ...)
        # goes to the real stdout, so libraries probing sys.stdout work
        return getattr(self.terminal, name)
