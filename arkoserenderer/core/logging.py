"""Leveled logging for the framework.

Equivalent role to the reference's fmt-based ``ARKOSE_LOG`` macro family
(reference: arkcore/core/Logging.h:15-32): leveled, counts warnings/errors so
observability UIs can surface them, and ``fatal`` exits the process with a
distinct exit code.
"""

from __future__ import annotations

import logging
import os
import sys

FATAL_EXIT_CODE = 13

_COUNTS = {"warning": 0, "error": 0}


class _CountingHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        if record.levelno >= logging.ERROR:
            _COUNTS["error"] += 1
        elif record.levelno >= logging.WARNING:
            _COUNTS["warning"] += 1


_root = logging.getLogger("arkose")
_root.setLevel(os.environ.get("ARKOSE_LOG_LEVEL", "INFO").upper())
_handler = logging.StreamHandler(sys.stderr)
_handler.setFormatter(logging.Formatter("[%(levelname).1s] %(name)s: %(message)s"))
_root.addHandler(_handler)
_root.addHandler(_CountingHandler())
_root.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    return _root.getChild(name) if name else _root


def warning_count() -> int:
    return _COUNTS["warning"]


def error_count() -> int:
    return _COUNTS["error"]


def fatal(msg: str, *args) -> None:
    """Log at CRITICAL and exit with the framework's fatal exit code."""
    _root.critical(msg, *args)
    raise SystemExit(FATAL_EXIT_CODE)
