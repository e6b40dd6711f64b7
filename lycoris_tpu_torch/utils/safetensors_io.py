"""Read and write ``.safetensors`` files without the ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON (padded
with spaces to a multiple of 8), then the tensors' raw little-endian bytes,
one after another. The header maps each tensor's name to its ``dtype``,
``shape`` and ``data_offsets`` (begin, end) into the bytes after the
header, and may hold ``__metadata__``, a str -> str map. The writer puts
the tensors in the ``safetensors`` package's order (wider dtypes first,
then by name), so every tensor starts at a multiple of its item size.

Counterpart of the JAX package's ``safetensors.numpy`` calls
(``lycoris_tpu/wrapper.py`` ``load_file_sd``/``save_weights``) and of its
header parser (``lycoris_tpu/data.py`` ``parse_safetensors_header``).
"""

from __future__ import annotations

import json
import struct
import sys

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}
# the safetensors package's dtype order, the widest first: it writes tensors
# in this order, then by name
_ORDER = ["I64", "F64", "F32", "I32", "BF16", "F16", "I16", "I8", "U8", "BOOL"]


def _check_host() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors_io reads and writes little-endian bytes on "
                           "little-endian hosts only")


def read_header(path) -> tuple[dict, int]:
    """(header, offset of the first tensor byte in the file), the header's
    ``__metadata__`` included, without reading the tensors."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
    return json.loads(raw), 8 + n


def load_file(path) -> dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU, each with its own memory."""
    _check_host()
    header, start = read_header(path)
    header.pop("__metadata__", None)
    with open(path, "rb") as f:
        f.seek(start)
        data = memoryview(bytearray(f.read()))
    out = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which "
                             f"safetensors_io does not read")
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} for "
                             f"{count} elements of {itemsize} bytes in {len(data)} bytes")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(data[begin:end], dtype=dtype).reshape(shape).clone()
    return out


def serialize(tensors: dict, metadata: dict | None = None) -> bytes:
    """The file's bytes for ``tensors`` (name -> tensor, any device) and
    ``metadata`` (str -> str, or None): the bytes ``safetensors.numpy.save``
    gives for the same arrays and metadata (an empty dict is written as an
    empty ``__metadata__``, None as none)."""
    _check_host()
    if metadata is not None:
        bad = [k for k, v in metadata.items() if not (isinstance(k, str) and isinstance(v, str))]
        if bad:
            raise TypeError(f"metadata must map str to str; not so for {bad}")
    items = []
    for name, t in tensors.items():
        if not isinstance(name, str):
            raise TypeError(f"tensor names must be str, got {name!r}")
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, which safetensors_io "
                             f"does not write")
        items.append((name, t.detach().to("cpu").contiguous()))
    items.sort(key=lambda it: (_ORDER.index(NAMES[it[1].dtype]), it[0]))
    header: dict = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset = 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * (-len(raw) % 8)
    parts = [struct.pack("<Q", len(raw)), raw]
    parts += [t.reshape(-1).view(torch.uint8).numpy().tobytes() for _, t in items if t.numel()]
    return b"".join(parts)


def save_file(tensors: dict, path, metadata: dict | None = None) -> None:
    """Write :func:`serialize`'s bytes for ``tensors`` and ``metadata`` to ``path``."""
    data = serialize(tensors, metadata)
    with open(path, "wb") as f:
        f.write(data)
