"""Training data pipeline: the native (C++) safetensors shard loader
(counterpart of ``lycoris_tpu/data.py``).

- Python parses the shards' headers (:func:`parse_safetensors_header`, the
  port's own reader) and registers raw (file, offset, nbytes) records of the
  tensors whose key starts with a prefix, all of one shape and dtype;
- ``native/loader.cpp`` (a copy of the JAX package's, with the same C ABI)
  mmaps the shards and assembles batches on a worker thread pool with a
  bounded prefetch queue, holding no GIL on the data plane. :func:`build`
  compiles it with ``g++`` at first use into ``build/native/`` at the
  repository root, under a name that carries the hash of the source and
  flags. A failed build raises: there is no slower path to fall back on.

:meth:`ShardDataset.epoch` yields CPU tensors (B, *shape) in the shards'
dtype (BF16 as ``torch.bfloat16``, the same bits) in the order the workers
finish them; :meth:`ShardDataset.epoch_plain`, one file read a record in
the permutation's order, is its plain version, which the tests hold it to.
Both shuffle with ``np.random.default_rng(seed).permutation`` and drop the
last partial batch.

Usage::

    ds = ShardDataset.from_dir("latents/", key_prefix="latents")
    for batch in ds.epoch(batch_size=8, seed=0):   # torch.Tensor (B, *shape)
        ...
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from .utils import safetensors_io

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "native" / "loader.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB = None
_P, _U32, _U64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
_SIGNATURES = {  # name: (restype, argtypes)
    "loader_create": (_P, [_U64, _U32, _U32, _U32]),
    "loader_add_file": (ctypes.c_int, [_P, ctypes.c_char_p]),
    "loader_add_record": (ctypes.c_int, [_P, _U32, _U64, _U64]),
    "loader_start": (ctypes.c_int, [_P, ctypes.POINTER(ctypes.c_int64), _U64]),
    "loader_next": (ctypes.c_int64, [_P, _P]),
    "loader_n_batches": (_U64, [_P]),
    "loader_destroy": (None, [_P]),
}


def parse_safetensors_header(path) -> tuple[dict, int]:
    """(header dict, offset of the first tensor byte) without reading tensor data."""
    return safetensors_io.read_header(path)


def build() -> Path:
    """Compile the loader if this source's library is not built yet; return its path."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libloader_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the native loader ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded loader library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = handle
    return _LIB


class ShardDataset:
    """Tensors of one shape and dtype spread across safetensors shards."""

    def __init__(self, records, shape, dtype, files):
        self.records = records  # [(file_idx, offset, nbytes)]
        self.shape = tuple(shape)
        self.dtype = dtype
        self.files = files
        self.item_nbytes = math.prod(self.shape) * torch.empty((), dtype=dtype).element_size()

    @staticmethod
    def from_dir(path, key_prefix: str = "", ext: str = ".safetensors") -> "ShardDataset":
        """The tensors whose key starts with ``key_prefix`` in the ``ext``
        files of ``path``, in the order of sorted file names, then of each
        header. Raises ``FileNotFoundError`` if there is no such file and
        ``ValueError`` if a tensor's shape or dtype differs from the first's."""
        files, records = [], []
        shape = dtype = None
        names = sorted(f for f in os.listdir(path) if f.endswith(ext))
        if not names:
            raise FileNotFoundError(f"no {ext} shards in {path}")
        for fname in names:
            full = os.path.join(path, fname)
            header, base = parse_safetensors_header(full)
            fidx = len(files)
            files.append(full)
            for key, info in header.items():
                if key == "__metadata__" or not key.startswith(key_prefix):
                    continue
                if shape is None:
                    shape = tuple(info["shape"])
                    dtype = safetensors_io.DTYPES[info["dtype"]]
                elif tuple(info["shape"]) != shape:
                    raise ValueError(f"{key}: shape {info['shape']} != {shape}")
                elif safetensors_io.DTYPES[info["dtype"]] != dtype:
                    raise ValueError(f"{key}: dtype {info['dtype']} != {dtype}")
                off0, off1 = info["data_offsets"]
                records.append((fidx, base + off0, off1 - off0))
        return ShardDataset(records, shape, dtype, files)

    def __len__(self):
        return len(self.records)

    def order(self, seed: int) -> np.ndarray:
        """The epoch's permutation of the records for ``seed`` (int64)."""
        return np.random.default_rng(seed).permutation(len(self.records)).astype(np.int64)

    def _batch(self, batch_size: int) -> torch.Tensor:
        return torch.empty((batch_size, *self.shape), dtype=self.dtype)

    def epoch(self, batch_size: int, seed: int = 0, n_threads: int = 4, queue_depth: int = 4):
        """Yield shuffled (B, *shape) batches from the native loader
        (drop-remainder), each written by it into a new tensor."""
        order = self.order(seed)
        loader = lib()
        h = loader.loader_create(self.item_nbytes, batch_size, n_threads, queue_depth)
        try:
            for f in self.files:
                if loader.loader_add_file(h, os.fsencode(f)) < 0:
                    raise OSError(f"mmap failed: {f}")
            for fidx, off, nb in self.records:
                if loader.loader_add_record(h, fidx, off, nb) < 0:
                    raise ValueError(f"bad record {(fidx, off, nb)}")
            loader.loader_start(h, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                len(order))
            for _ in range(loader.loader_n_batches(h)):
                out = self._batch(batch_size)
                if loader.loader_next(h, out.data_ptr()) < 0:
                    break
                yield out
        finally:
            loader.loader_destroy(h)

    def epoch_plain(self, batch_size: int, seed: int = 0):
        """:meth:`epoch`'s plain version: the same batches, in the order of
        the permutation, each record read from its file in turn."""
        order = self.order(seed)
        with contextlib.ExitStack() as stack:
            handles = [stack.enter_context(open(f, "rb")) for f in self.files]
            for b in range(len(order) // batch_size):
                out = self._batch(batch_size)
                rows = out.reshape(-1).view(torch.uint8).view(batch_size, self.item_nbytes)
                for i in range(batch_size):
                    fidx, off, nb = self.records[order[b * batch_size + i]]
                    handles[fidx].seek(off)
                    if handles[fidx].readinto(rows[i].numpy()) != nb:
                        raise OSError(f"short read of {nb} bytes at {off} in {self.files[fidx]}")
                yield out
