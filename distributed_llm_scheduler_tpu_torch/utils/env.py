"""Environment seam: the port's one reader of ``os.environ``.

A copy of ``env_str``/``env_flag`` from the JAX package's
``utils/config.py``, so every env-tunable of the port (``DLS_TRACE``,
``DLS_FLIGHT``) reads through one greppable place without importing the
JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

_TRUTHY = ("1", "true", "yes", "on")


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw environment read."""
    return os.environ.get(name, default)


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean environment read: unset -> ``default``; set -> truthy iff
    the value is one of ``1/true/yes/on`` (case-insensitive)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in _TRUTHY


__all__ = ["env_flag", "env_str"]
