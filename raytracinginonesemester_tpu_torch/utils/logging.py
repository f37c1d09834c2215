"""Structured logging helpers (port of ``raytracinginonesemester_tpu.utils.logging``).

``warn_once`` is the renderer's warning when a scene falls off the fused
kernels onto the staged integrator."""

from __future__ import annotations

import sys

__all__ = ["warn_once"]

_WARNED: set = set()


def warn_once(key: str, message: str) -> None:
    """One stderr warning per distinct ``key`` for the process lifetime."""
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"[warn] {message}", file=sys.stderr)
