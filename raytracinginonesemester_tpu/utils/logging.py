"""Structured metrics logging.

Upgrade over the reference's printf status lines (``main.cu:171-188``,
``render.cpp:118-121``): human-readable stderr lines plus machine-parsable
JSON-lines records (per SURVEY §5: per-step scalar logging — rays/s,
chips, spp, loss for inverse rendering).
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

__all__ = ["MetricsLogger", "progress_bar"]


class MetricsLogger:
    """Append-only JSON-lines metrics writer with stderr echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh: Optional[IO] = open(path, "a") if path else None

    def log(self, event: str, **fields):
        rec = {"event": event, "time": time.time(), **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            body = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{event}] {body}", file=sys.stderr)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def progress_bar(done: int, total: int, width: int = 40) -> str:
    """The reference's console progress bar (``CPUOnly/src/render.cpp:118-121``)."""
    filled = done * width // max(total, 1)
    pct = done * 100 // max(total, 1)
    return f"\r[{'=' * filled}{' ' * (width - filled)}] {pct}%"
