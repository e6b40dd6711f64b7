"""Small helpers shared by the port (counterpart of ``lycoris_tpu/utils/__init__.py``)."""

from __future__ import annotations

import hashlib
import math


def str_bool(val) -> bool:
    """Coerce kohya-style string kwargs to bool (reference utils str_bool)."""
    if isinstance(val, str):
        return val.lower() not in ("false", "0", "none", "")
    return bool(val)


def product(xs):
    return math.prod(xs)


def precalculate_safetensors_hashes(tensors, metadata):
    """(model_hash, legacy_hash): the first 8 hex digits of the sha256 of the
    ``.safetensors`` bytes of ``tensors`` and ``metadata``
    (:func:`.safetensors_io.serialize`), and of the 64 KiB at 1 MiB into
    them (reference utils/__init__.py:19-41)."""
    from .safetensors_io import serialize

    data = serialize(tensors, metadata)
    model_hash = hashlib.sha256(data).hexdigest()[0:8]
    legacy_hash = hashlib.sha256(data[0x100000: 0x100000 + 0x10000]).hexdigest()[0:8]
    return model_hash, legacy_hash
