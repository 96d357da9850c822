"""Stdout tee and file/console logger (the port's copy of
``pnode_tpu/utils/logging.py``).

``Tee`` duplicates stdout writes into a log file (assign it to
``sys.stdout``); ``get_logger`` returns a ``logging`` logger with a file
handler and a console handler.
"""

from __future__ import annotations

import logging
import os
import sys


def makedirs(dirname: str) -> None:
    os.makedirs(dirname, exist_ok=True)


class Tee:
    """Duplicate stdout writes into a log file (assign to sys.stdout)."""

    def __init__(self, fname: str, mode: str = "a"):
        self.stdout = sys.stdout
        self.file = open(fname, mode)

    def write(self, message):
        self.stdout.write(message)
        self.file.write(message)
        self.file.flush()

    def flush(self):
        self.stdout.flush()
        self.file.flush()

    def close(self):
        try:
            self.file.close()
        finally:
            sys.stdout = self.stdout


def get_logger(logpath: str | None = None, displaying: bool = True,
               saving: bool = True, debug: bool = False,
               name: str = "pnode_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    logger.handlers.clear()
    if saving and logpath is not None:
        makedirs(os.path.dirname(logpath) or ".")
        fh = logging.FileHandler(logpath)
        fh.setLevel(logging.DEBUG)
        logger.addHandler(fh)
    if displaying:
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO)
        logger.addHandler(ch)
    return logger
