"""Structured metrics logging (port of ``raytracinginonesemester_tpu.utils.logging``).

Human-readable stderr lines plus JSON-lines records (per-step scalars:
rays/s, spp, the loss of inverse rendering), the reference's console
progress bar, and ``warn_once``, the renderer's warning when a scene
falls off the fused kernels onto the staged integrator.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

__all__ = ["MetricsLogger", "progress_bar", "warn_once"]

_WARNED: set = set()


def warn_once(key: str, message: str) -> None:
    """One stderr warning per distinct ``key`` for the process lifetime."""
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"[warn] {message}", file=sys.stderr)


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
