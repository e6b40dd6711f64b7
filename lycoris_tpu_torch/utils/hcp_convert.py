"""HCP-diffusion ⇄ webui key-format converters (counterpart of
``lycoris_tpu/utils/hcp_convert.py``; reference tools/batch_hcp_convert.py:16-389,
LoraConverter and BaseConverter). String and dict transforms on flat state
dicts of torch tensors:

- webui keys: ``{prefix}{model_path_underscored}.{lora_key}`` with prefixes
  ``lora_unet_`` / ``lora_te_`` (``lora_te1_/lora_te2_`` for SDXL);
- HCP keys: ``{model.path}.___.{lora_key}`` (``.___.layer.W_down/W_up`` for
  the post-9fdce2d LoRA layout);
- the SDXL UNet block-index remap tables (input/output blocks ⇄
  down/up_blocks attentions);
- ``alpha_scale``: ×√dim applied on up/down factors in both directions.

``BaseConverter`` turns a full fine-tuned state dict into ``diff/diff_b``
(FullModule) webui keys against a base state dict.
"""

from __future__ import annotations

import math
import re

import torch

DOWN_WEIGHT = "lora_down.weight"
UP_WEIGHT = "lora_up.weight"


class LoraConverter:
    com_name_unet = [
        "down_blocks",
        "up_blocks",
        "mid_block",
        "transformer_blocks",
        "to_q",
        "to_k",
        "to_v",
        "to_out",
        "proj_in",
        "proj_out",
        "input_blocks",
        "middle_block",
        "output_blocks",
    ]
    com_name_te = ["self_attn", "q_proj", "v_proj", "k_proj", "out_proj", "text_model"]
    prefix_unet = "lora_unet_"
    prefix_te = "lora_te_"
    prefix_te_xl_clip_B = "lora_te1_"
    prefix_te_xl_clip_bigG = "lora_te2_"

    lora_w_map = {DOWN_WEIGHT: "W_down", UP_WEIGHT: "W_up"}

    # SDXL UNet block-index remaps (batch_hcp_convert.py:217-246)
    _xl_down = {"4": (1, 0), "5": (1, 1), "7": (2, 0), "8": (2, 1)}
    _xl_up = {"0": (0, 0), "1": (0, 1), "2": (0, 2), "3": (1, 0), "4": (1, 1), "5": (1, 2)}

    def __init__(self, save_fp16: bool = False):
        self.com_name_unet_tmp = [x.replace("_", "%") for x in self.com_name_unet]
        self.com_name_te_tmp = [x.replace("_", "%") for x in self.com_name_te]
        self.save_fp16 = save_fp16

    # -- public API -----------------------------------------------------------
    def convert_from_webui(self, state, network_type="lora", auto_scale_alpha=False, sdxl=False):
        assert network_type in ("lora", "plugin")
        if not sdxl:
            sd_unet = self._from_webui(state, network_type, self.prefix_unet,
                                       self.com_name_unet, self.com_name_unet_tmp)
            sd_te = self._from_webui(state, network_type, self.prefix_te,
                                     self.com_name_te, self.com_name_te_tmp)
        else:
            sd_unet = self._from_webui_xl_unet(state, network_type, self.prefix_unet,
                                               self.com_name_unet, self.com_name_unet_tmp)
            sd_te = self._from_webui_xl_te(state, network_type, self.prefix_te_xl_clip_B,
                                           self.com_name_te, self.com_name_te_tmp)
            sd_te.update(
                self._from_webui_xl_te(state, network_type, self.prefix_te_xl_clip_bigG,
                                       self.com_name_te, self.com_name_te_tmp)
            )
        if auto_scale_alpha and network_type == "lora":
            sd_unet = self.alpha_scale_from_webui(sd_unet)
            sd_te = self.alpha_scale_from_webui(sd_te)
        return {network_type: sd_unet}, {network_type: sd_te}

    def convert_to_webui(self, sd_unet, sd_te, network_type="lora", auto_scale_alpha=False, sdxl=False):
        assert network_type in ("lora", "plugin")
        sd_unet = self._to_webui(sd_unet, network_type, self.prefix_unet)
        if sdxl:
            sd_te = self._to_webui_xl(sd_te, network_type, self.prefix_te)
        else:
            sd_te = self._to_webui(sd_te, network_type, self.prefix_te)
        sd_unet.update(sd_te)
        if auto_scale_alpha and network_type == "lora":
            sd_unet = self.alpha_scale_to_webui(sd_unet)
        return sd_unet

    # -- directions -----------------------------------------------------------
    def _cast(self, v):
        return v.to(torch.float16) if self.save_fp16 else v

    def _from_webui(self, state, network_type, prefix, com_name, com_name_tmp):
        state = {k: v for k, v in state.items() if k.startswith(prefix)}
        out = {}
        for k, v in state.items():
            model_k, lora_k = k[len(prefix):].split(".", 1)
            model_k = self.replace_all(model_k, com_name, com_name_tmp).replace("_", ".").replace("%", "_")
            v = self._cast(v)
            if lora_k == "alpha" or network_type == "plugin":
                out[f"{model_k}.___.{lora_k}"] = v
            else:
                out[f"{model_k}.___.layer.{self.lora_w_map[lora_k]}"] = v
        return out

    def _split_hcp_key(self, k, network_type):
        if network_type == "plugin" or "alpha" in k or "scale" in k:
            model_k, lora_k = k.split(".___.", 1)
        elif k.endswith("W_down"):
            model_k, lora_k = k.split(".___.", 1)[0], DOWN_WEIGHT
        elif k.endswith("W_up"):
            model_k, lora_k = k.split(".___.", 1)[0], UP_WEIGHT
        else:
            model_k, lora_k = k.split(".___.layer.", 1)
        return model_k, lora_k

    def _to_webui(self, state, network_type, prefix):
        out = {}
        for k, v in state.items():
            model_k, lora_k = self._split_hcp_key(k, network_type)
            out[f"{prefix}{model_k.replace('.', '_')}.{lora_k}"] = self._cast(v)
        return out

    def _to_webui_xl(self, state, network_type, prefix):
        out = {}
        for k, v in state.items():
            model_k, lora_k = self._split_hcp_key(k, network_type)
            new_k = f"{prefix}{model_k.replace('.', '_')}.{lora_k}"
            if "clip" in new_k:
                new_k = (
                    new_k.replace("_clip_B", "1") if "clip_B" in new_k else new_k.replace("_clip_bigG", "2")
                )
            out[new_k] = self._cast(v)
        return out

    def _from_webui_xl_te(self, state, network_type, prefix, com_name, com_name_tmp):
        state = {k: v for k, v in state.items() if k.startswith(prefix)}
        out = {}
        for k, v in state.items():
            model_k, lora_k = k[len(prefix):].split(".", 1)
            model_k = self.replace_all(model_k, com_name, com_name_tmp).replace("_", ".").replace("%", "_")
            model_k = f"clip_B.{model_k}" if prefix == self.prefix_te_xl_clip_B else f"clip_bigG.{model_k}"
            v = self._cast(v)
            if lora_k == "alpha" or network_type == "plugin":
                out[f"{model_k}.___.{lora_k}"] = v
            else:
                out[f"{model_k}.___.layer.{self.lora_w_map[lora_k]}"] = v
        return out

    def _from_webui_xl_unet(self, state, network_type, prefix, com_name, com_name_tmp):
        state = {k: v for k, v in state.items() if k.startswith(prefix)}
        out = {}
        for k, v in state.items():
            model_k, lora_k = k[len(prefix):].split(".", 1)
            model_k = self.replace_all(model_k, com_name, com_name_tmp).replace("_", ".").replace("%", "_")
            if (m := re.match(r"input_blocks.(\d+).1.(.+)", model_k)):
                d = self._xl_down[m.group(1)]
                new_k = f"down_blocks.{d[0]}.attentions.{d[1]}.{m.group(2)}"
            elif (m := re.match(r"middle_block.1.(.+)", model_k)):
                new_k = f"mid_block.attentions.0.{m.group(1)}"
            elif (m := re.match(r"output_blocks.(\d+).(\d+).(.+)", model_k)):
                u = self._xl_up[m.group(1)]
                new_k = f"up_blocks.{u[0]}.attentions.{u[1]}.{m.group(3)}"
            else:
                raise NotImplementedError(model_k)
            v = self._cast(v)
            if lora_k == "alpha" or network_type == "plugin":
                out[f"{new_k}.___.{lora_k}"] = v
            else:
                out[f"{new_k}.___.layer.{lora_k}"] = v
        return out

    @staticmethod
    def replace_all(data: str, srcs, dsts):
        for src, dst in zip(srcs, dsts):
            data = data.replace(src, dst)
        return data

    @staticmethod
    def alpha_scale_from_webui(state):
        """×√dim on up/down to prevent fp16 overflow (hcp convention)."""
        for k, v in state.items():
            if "lora_up" in k or "W_up" in k:
                state[k] = v * math.sqrt(v.shape[1])
            elif "lora_down" in k or "W_down" in k:
                state[k] = v * math.sqrt(v.shape[0])
        return state

    @staticmethod
    def alpha_scale_to_webui(state):
        for k, v in state.items():
            if "lora_up" in k:
                state[k] = v * math.sqrt(v.shape[1])
            elif "lora_down" in k:
                state[k] = v * math.sqrt(v.shape[0])
        return state


class BaseConverter:
    """Full fine-tuned model → webui ``diff/diff_b`` keys
    (batch_hcp_convert.py:323-389)."""

    prefix_unet = "lora_unet_"
    prefix_te = "lora_te_"

    def __init__(self, unet_state_dict, text_enc_dict, save_fp16=False, sdxl=False):
        self.unet_state_dict = unet_state_dict
        self.text_enc_dict = text_enc_dict
        self.save_fp16 = save_fp16
        self.sdxl = sdxl

    def convert_to_webui(self, sd_unet, sd_te):
        sd_unet = self._convert(sd_unet, self.unet_state_dict, self.prefix_unet)
        sd_te = self._convert(sd_te, self.text_enc_dict, self.prefix_te)
        sd_unet.update(sd_te)
        return sd_unet

    def _convert(self, ft_state, base_state, prefix):
        out = {}
        for k, v in ft_state.items():
            v_base = base_state[k]
            model_k, lora_k = k.rsplit(".", 1)
            lora_k = "diff" if lora_k == "weight" else "diff_b"
            v_diff = v - v_base
            if self.save_fp16:
                v_diff = v_diff.to(torch.float16)
            new_k = f"{prefix}{model_k.replace('.', '_')}.{lora_k}"
            if self.sdxl and "clip" in new_k:
                new_k = (
                    new_k.replace("_clip_B", "1") if "clip_B" in new_k else new_k.replace("_clip_bigG", "2")
                )
            out[new_k] = v_diff
        return out
