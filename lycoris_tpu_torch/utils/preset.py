"""TOML preset loader -- reference lycoris/utils/preset.py:4-9.

Uses the stdlib ``tomllib``; schema documented in reference
docs/Preset.md:35-53.
"""

from __future__ import annotations

import tomllib


def read_preset(path):
    try:
        with open(path, "rb") as f:
            return tomllib.load(f)
    except Exception as e:
        from ..logging import logger

        logger.error(f"Error: Failed to read preset file {path}: {e}")
        return None
