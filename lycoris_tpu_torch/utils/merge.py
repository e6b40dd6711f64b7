"""Merge a LyCORIS state dict into a model's weights (counterpart of
``lycoris_tpu/utils/merge.py``; reference lycoris/utils/__init__.py:356-483).

:func:`convert_diffusers_name_to_compvis` is the diffusers -> SGM/compvis
remap of UNet layer names used for SDXL/kohya files. :func:`merge` builds
each layer's adapter from the state dict (``modules.get_module`` and
``make_module``) and returns its merged weight, W + dW formed in fp32 on
``device`` and cast back to the layer's dtype, without touching the graph;
a LoHa layer forms its dW through the ``hada_fwd`` kernel on the card.
"""

from __future__ import annotations

import re

import torch

from ..logging import logger
from ..modules import get_module, make_module

re_digits = re.compile(r"\d+")
_re_compiled: dict = {}

suffix_conversion = {
    "attentions": {},
    "resnets": {
        "conv1": "in_layers_2",
        "conv2": "out_layers_3",
        "norm1": "in_layers_0",
        "norm2": "out_layers_0",
        "time_emb_proj": "emb_layers_1",
        "conv_shortcut": "skip_connection",
    },
}


def convert_diffusers_name_to_compvis(key: str) -> str:
    """diffusers -> compvis (SGM) UNet key remap (utils/__init__.py:372-417)."""

    def match(match_list, regex_text):
        regex = _re_compiled.get(regex_text)
        if regex is None:
            regex = re.compile(regex_text)
            _re_compiled[regex_text] = regex
        r = re.match(regex, key)
        if not r:
            return False
        match_list.clear()
        match_list.extend([int(x) if re.match(re_digits, x) else x for x in r.groups()])
        return True

    m = []
    if match(m, r"lora_unet_conv_in(.*)"):
        return f"lora_unet_input_blocks_0_0{m[0]}"
    if match(m, r"lora_unet_conv_out(.*)"):
        return f"lora_unet_out_2{m[0]}"
    if match(m, r"lora_unet_time_embedding_linear_(\d+)(.*)"):
        return f"lora_unet_time_embed_{m[0] * 2 - 2}{m[1]}"
    if match(m, r"lora_unet_down_blocks_(\d+)_(attentions|resnets)_(\d+)_(.+)"):
        suffix = suffix_conversion.get(m[1], {}).get(m[3], m[3])
        return f"lora_unet_input_blocks_{1 + m[0] * 3 + m[2]}_{1 if m[1] == 'attentions' else 0}_{suffix}"
    if match(m, r"lora_unet_mid_block_(attentions|resnets)_(\d+)_(.+)"):
        suffix = suffix_conversion.get(m[0], {}).get(m[2], m[2])
        return f"lora_unet_middle_block_{1 if m[0] == 'attentions' else m[1] * 2}_{suffix}"
    if match(m, r"lora_unet_up_blocks_(\d+)_(attentions|resnets)_(\d+)_(.+)"):
        suffix = suffix_conversion.get(m[1], {}).get(m[3], m[3])
        return f"lora_unet_output_blocks_{m[0] * 3 + m[2]}_{1 if m[1] == 'attentions' else 0}_{suffix}"
    if match(m, r"lora_unet_down_blocks_(\d+)_downsamplers_0_conv"):
        return f"lora_unet_input_blocks_{3 + m[0] * 3}_0_op"
    if match(m, r"lora_unet_up_blocks_(\d+)_upsamplers_0_conv"):
        return f"lora_unet_output_blocks_{2 + m[0] * 3}_2_conv"
    return key


def merge(tes, unet, lyco_state_dict: dict, scale: float = 1.0, device="cuda"):
    """Merge the adapters of ``lyco_state_dict`` into every matched layer of
    the text encoders ``tes`` (one, a list, or None) and ``unet``, each a
    :class:`~lycoris_tpu_torch.graph.ModelGraph` (of a module or of a state
    dict) or an ``nn.Module``.

    Returns ``(merged, merged_count)``: ``merged`` is ``{"lora_te" or
    "lora_te{i}": ..., "lora_unet": ...}``, each ``{layer name: {"weight":
    w, "bias": b}}`` (bias only where the layer has one) of the merged
    layers' new tensors on ``device``, in their layers' dtypes (the JAX
    function returns the whole params tree; here the unmerged layers are
    the graph's own). Nothing is written into the graphs.
    """
    from ..wrapper import _as_graph

    dev = torch.device(device)
    tes = [_as_graph(t) for t in (tes if isinstance(tes, (list, tuple)) else [tes] if tes else [])]
    unet = _as_graph(unet)
    merged = 0
    lyco_state_dict = dict(lyco_state_dict)

    # SDXL/kohya: diffusers-style UNet keys to SGM naming when there is more
    # than one text encoder
    key_dict: dict = {}
    for k in list(lyco_state_dict):
        module_name, weight_key = k.split(".", 1)
        convert_key = convert_diffusers_name_to_compvis(module_name)
        if convert_key != module_name and len(tes) > 1:
            v = lyco_state_dict.pop(k)
            key_dict[convert_key] = key_dict.get(convert_key, []) + [k]
            lyco_state_dict[f"{convert_key}.{weight_key}"] = v
        else:
            key_dict[module_name] = key_dict.get(module_name, []) + [k]

    @torch.no_grad()
    def merge_graph(prefix, graph):
        nonlocal merged
        out = {}
        for child_name, node in graph.named_modules():
            if not node.is_leaf:
                continue
            lora_name = (prefix + "." + child_name).replace(".", "_")
            lyco_type, params = get_module(lyco_state_dict, lora_name)
            if lyco_type is None:
                continue
            module = make_module(lyco_type, params, lora_name, node.layer_info, device=dev)
            if module is None:
                continue
            w, b = node.weights()
            # in fp32, then back to the layer's dtype (a bf16 base is not merged in bf16)
            merged_w, merged_b = module.get_merged_weight(
                w.detach().to(dev, torch.float32),
                None if b is None else b.detach().to(dev, torch.float32),
                multiplier=scale,
            )
            sub = {"weight": merged_w.to(w.dtype)}
            if b is not None and merged_b is not None:
                sub["bias"] = merged_b.to(b.dtype)
            out[child_name] = sub
            key_dict.pop(convert_diffusers_name_to_compvis(lora_name), None)
            key_dict.pop(lora_name, None)
            merged += 1
        return out

    out = {}
    for idx, te in enumerate(tes):
        prefix = f"lora_te{idx + 1}" if len(tes) > 1 else "lora_te"
        out[prefix] = merge_graph(prefix, te)
    out["lora_unet"] = merge_graph("lora_unet", unet)
    if key_dict:
        logger.warning(f"Unused state dict keys: {list(key_dict)[:8]}{'...' if len(key_dict) > 8 else ''}")
    logger.info(f"{merged} modules merged")
    return out, merged
