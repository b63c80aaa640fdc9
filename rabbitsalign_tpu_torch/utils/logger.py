"""Leveled stderr logger (role of reference src/logger.hpp)."""

from __future__ import annotations

import sys

_LEVELS = {"debug": 0, "info": 1, "warning": 2, "error": 3}


class Logger:
    def __init__(self):
        self.level = _LEVELS["info"]

    def set_level(self, level: str) -> None:
        self.level = _LEVELS[level]

    def _log(self, level: str, msg: str) -> None:
        if _LEVELS[level] >= self.level:
            print(msg, file=sys.stderr)

    def debug(self, msg: str) -> None:
        self._log("debug", msg)

    def info(self, msg: str) -> None:
        self._log("info", msg)

    def warning(self, msg: str) -> None:
        self._log("warning", msg)

    def error(self, msg: str) -> None:
        self._log("error", msg)


logger = Logger()
