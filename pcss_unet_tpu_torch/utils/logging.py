"""Logging setup with content-keyed ANSI coloring (port of
``pcss_unet_tpu/utils/logging.py``).

Reference: colorama ``ColoredFormatter`` keyed on message content — GPU
memory lines cyan, validation-loss lines magenta (main.py:48-70) — plus a
timestamped file+stream logger (main.py:116-126).  Plain ANSI codes here
(no colorama dependency), disabled automatically when not a TTY.
"""

from __future__ import annotations

import logging
import os
import sys
import time

ANSI = {"cyan": "\x1b[36m", "magenta": "\x1b[35m", "yellow": "\x1b[33m",
        "red": "\x1b[31m", "green": "\x1b[32m", "reset": "\x1b[0m"}

_CONTENT_COLORS = (
    ("memory", "cyan"),        # main.py:56-61 GPU-memory lines
    ("val", "magenta"),        # main.py:62-66 validation-loss lines
    ("epoch", "green"),
)
_LEVEL_COLORS = {logging.WARNING: "yellow", logging.ERROR: "red",
                 logging.CRITICAL: "red"}


class ContentColoredFormatter(logging.Formatter):
    def __init__(self, fmt: str, use_color: bool = True):
        super().__init__(fmt)
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        text = super().format(record)
        if not self.use_color:
            return text
        color = _LEVEL_COLORS.get(record.levelno)
        if color is None:
            lower = record.getMessage().lower()
            for needle, c in _CONTENT_COLORS:
                if needle in lower:
                    color = c
                    break
        if color:
            return f"{ANSI[color]}{text}{ANSI['reset']}"
        return text


def setup_logger(log_dir: str | None = None, level=logging.INFO,
                 name: str | None = None) -> logging.Logger:
    """Timestamped file + colored stream logging (main.py:116-126 role)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = "%(asctime)s - %(levelname)s - %(message)s"
    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(ContentColoredFormatter(fmt, sys.stdout.isatty()))
    logger.addHandler(stream)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"train_{stamp}.log"))
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    return logger
