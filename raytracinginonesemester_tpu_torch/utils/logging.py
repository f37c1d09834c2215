"""Structured logging helpers (port of ``raytracinginonesemester_tpu.utils.logging``).

Nothing on the ported slice warns yet; ``warn_once`` is kept as the
counterpart of the JAX helper for the paths still to port."""

from __future__ import annotations

import sys

__all__ = ["warn_once"]

_WARNED: set = set()


def warn_once(key: str, message: str) -> None:
    """One stderr warning per distinct ``key`` for the process lifetime."""
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"[warn] {message}", file=sys.stderr)
