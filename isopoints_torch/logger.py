"""Colored logging (own copy of isopoints_tpu/logger.py)."""

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[35m",
}
_RESET = "\x1b[0m"


class ColorFormatter(logging.Formatter):
    """ANSI-colored formatter; colors only the level name."""

    def __init__(self, use_color: bool = True):
        super().__init__(fmt="%(asctime)s %(levelname)s %(name)s: %(message)s",
                         datefmt="%H:%M:%S")
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelno, "") if self.use_color else ""
        return f"{color}{msg}{_RESET}" if color else msg


def get_logger(name: str = "isopoints_torch",
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(ColorFormatter(use_color=sys.stdout.isatty()))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger
