"""What the CLIs share: the ``--device`` flag, file gathering and saving."""

from __future__ import annotations

import os

import torch

from ..utils import safetensors_io


def add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where the tool's tensor work runs (cuda by default; cpu)")


def device(name: str) -> torch.device:
    """``name`` as a device that exists: the tools never fall back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device here (pass --device cpu to run on the CPU)")
    return dev


def gather(paths, exts=(".safetensors", ".pt"), recursive=False) -> list:
    """The files of ``paths`` (files, or directories walked to one level
    unless ``recursive``) that end in one of ``exts``."""
    files = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(tuple(exts)):
            files.append(p)
        elif os.path.isdir(p):
            for root, _, fns in os.walk(p):
                files += [os.path.join(root, f) for f in fns if f.endswith(tuple(exts))]
                if not recursive:
                    break
    return files


def save(sd: dict, path) -> None:
    """Write ``sd`` (tensors on any device) as a ``.safetensors`` file."""
    safetensors_io.save_file({k: v.detach().cpu().contiguous() for k, v in sd.items()}, path)
