"""Bundle format: textual-inversion embeddings packed into a LoRA file
(counterpart of ``lycoris_tpu/utils/bundle.py``; reference
tools/pack_bundle.py:56-90 and tools/batch_bundle_convert.py:32-99, the
webui PR #13568 format). Embeddings are stored under
``bundle_emb.{name}.{key}`` (nested dicts flatten to
``bundle_emb.{name}.{key}.{subkey}``); unpacking reverses the flattening.
Dict code over torch tensors: the values are passed through as they are.
"""

from __future__ import annotations

import os
from collections import defaultdict



def _is_tensor(v):
    return hasattr(v, "shape") and hasattr(v, "dtype")


def pack_bundle(lora: dict, emb_dict: dict, verbose: bool = False) -> dict:
    """Add ``bundle_emb.*`` keys for every embedding state dict."""
    for emb, emb_sd in emb_dict.items():
        for key, value in emb_sd.items():
            if isinstance(value, dict):
                for subkey, subvalue in value.items():
                    lora[f"bundle_emb.{emb}.{key}.{subkey}"] = subvalue
            elif _is_tensor(value):
                lora[f"bundle_emb.{emb}.{key}"] = value
    if verbose:
        for key in lora:
            if key.startswith("bundle_emb"):
                print(f" {key}")
    return lora


def unpack_bundle(lora: dict, verbose: bool = False, step="", emb_format=".pt"):
    """Split bundle keys back out; returns (lora_without_bundle, emb_dict).

    ``emb_format='.pt'`` keeps the nested {key: {subkey: tensor}} layout (and
    adds the ``name`` field) like A1111 .pt embeddings; '.safetensors' keeps
    flat subkeys (reference batch_bundle_convert.py:52-84).
    """
    assert emb_format in (".pt", ".safetensors")
    step_s = f"-{step}" if step != "" else ""
    emb_dict: dict = {}
    bundle_keys = []
    for lora_key, value in lora.items():
        if not lora_key.startswith("bundle_emb"):
            continue
        bundle_keys.append(lora_key)
        _, emb, *rest = lora_key.split(".")
        emb = emb + step_s
        emb_dict.setdefault(emb, {})
        if len(rest) == 2:
            key, subkey = rest
            if emb_format == ".pt":
                emb_dict[emb].setdefault(key, {})[subkey] = value
            else:
                emb_dict[emb][subkey] = value
        elif len(rest) == 1:
            emb_dict[emb][rest[0]] = value
    lora = {k: v for k, v in lora.items() if k not in bundle_keys}
    if emb_format == ".pt":
        for emb, emb_sd in emb_dict.items():
            emb_sd["name"] = emb
    return lora, emb_dict


def extract_step(file_path: str):
    """Parse ``{name}-{step}.{ext}`` pairing (batch_bundle_convert.py:100-110)."""
    filename = os.path.splitext(os.path.basename(file_path))[0]
    step = filename.split("-")[-1].replace("step", "")
    if step.isdigit():
        return "-".join(filename.split("-")[:-1]), int(step)
    return filename, ""


def pair_loras_with_embeddings(lora_files, emb_files):
    """Associate lora files with embeddings by step count
    (batch_bundle_convert.py:148-180)."""
    lora_embs = defaultdict(lambda: {"lora": None, "embs": []})
    for network_path in lora_files:
        _, step = extract_step(network_path)
        if step in lora_embs:
            raise ValueError(f"Find two Lora files with the same step count {step}, abort")
        lora_embs[step]["lora"] = network_path
    for emb_path in emb_files:
        _, step = extract_step(emb_path)
        if step in lora_embs:
            lora_embs[step]["embs"].append(emb_path)
    return dict(lora_embs)
