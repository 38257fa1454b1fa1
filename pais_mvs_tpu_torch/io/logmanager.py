"""Run log file, mirroring the reference LogManager
(TMVS/io/logmanager.{h,cpp}): lazily-opened ``log.txt`` receiving
``[Log]/[Warning]/[Error]`` prefixed lines, duplicated to stdout. Explicit
instance instead of the reference's global singleton. The port's copy of
``pais_mvs_tpu/io/logmanager.py``."""

from __future__ import annotations

import os
import time
from typing import Optional, TextIO


class LogManager:
    def __init__(self, path: str = "log.txt", echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh: Optional[TextIO] = None

    def _ensure(self) -> TextIO:
        if self._fh is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            self._fh = open(self.path, "a")
            self._fh.write(f"[Log] ---- run @ "
                           f"{time.strftime('%Y-%m-%d %H:%M:%S')} ----\n")
        return self._fh

    def _write(self, tag: str, msg: str):
        fh = self._ensure()
        fh.write(f"[{tag}] {msg}\n")
        fh.flush()
        if self.echo:
            print(f"[{tag}] {msg}" if tag != "Log" else msg, flush=True)

    def log(self, msg: str):
        self._write("Log", msg)

    def warning(self, msg: str):
        self._write("Warning", msg)

    def error(self, msg: str):
        self._write("Error", msg)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
