"""Small helpers shared by the port."""

from __future__ import annotations


def str_bool(val) -> bool:
    """Coerce kohya-style string kwargs to bool (reference utils str_bool)."""
    if isinstance(val, str):
        return val.lower() not in ("false", "0", "none", "")
    return bool(val)
