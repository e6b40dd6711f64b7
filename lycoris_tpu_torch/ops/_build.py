"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with :mod:`ctypes`. No PyTorch headers are included, so a
build takes seconds. The library lands in ``build/kernels/``
at the repository root under a name that carries the hash of the sources
and flags: editing a source rebuilds it, an unchanged tree reuses it.

Nothing here runs at import time; :func:`lib` builds on the first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
build_log = ""  # compiler output of this library's build (ptxas register/spill report)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "lyc_ln_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "lyc_hada_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
    "lyc_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.POINTER(_L), _F, _I, _P],
    "lyc_ln_bwd": [_P] * 8 + [_I, _I, _I, _I, _F, _I, _P],
    "lyc_flash_bwd": [_P] * 10 + [_I] * 4 + [ctypes.POINTER(_L), _F, _I, _P],
    "lyc_hada_bwd": [_P] * 7 + [_I] * 4 + [_F, _I, _I, _P],
    "lyc_gn_fwd": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _P],
    "lyc_gn_bwd": [_P] * 14 + [_I] * 9 + [_P],
    "lyc_gn_fwd_fast": [_P] * 6 + [_I] * 9 + [_F, _I, _I, _P],
    "lyc_gn_bwd_fast": [_P] * 11 + [_I] * 11 + [_P],
    "lyc_gn_fwd_fast_clusters": [_I] * 4 + [ctypes.POINTER(_I)],
    "lyc_gn_bwd_fast_clusters": [_I] * 4 + [ctypes.POINTER(_I)],
    "lyc_geglu_bwd": [_P] * 3 + [_I] * 4 + [_P],
    "lyc_lora_fused_nt": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
    "lyc_lora_fused_nn": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
    "lyc_lora_fused_fast": [_P] * 6 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    "lyc_hada_bwd_split": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
    "lyc_kron_merge": [_P] * 4 + [_F, _P] + [_I] * 5 + [_P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this tree's library is not built yet; return its path."""
    global build_log
    out = BUILD_DIR / f"liblycoris_kernels_{_digest()}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources(), objs)
    ]
    logs, failed = [], []
    for src, p in zip(sources(), procs):
        text = p.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    for obj in objs:
        obj.unlink()
    log.write_text(build_log)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused or failed launch)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_ptr(t) -> int:
    """The raw handle of the current stream on ``t``'s device, from
    PyTorch's own getter (the one its generated kernels launch with): a
    fraction of a microsecond of host time, against several for
    ``torch.cuda.current_stream(device).cuda_stream``."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


def check_cuda_inputs(name: str, *tensors) -> None:
    """Shared wrapper checks: one CUDA device and one dtype. Autograd goes
    through each kernel's ``torch.autograd.Function``, whose backward is a
    kernel too."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {tensors[0].dtype}")


def ptr(t) -> int | None:
    """A tensor's data pointer for a C entry, None (NULL) for None."""
    return None if t is None else t.data_ptr()
