"""kohya-ss/sd-scripts trainer contract (counterpart of ``lycoris_tpu/kohya.py``;
reference lycoris/kohya.py:30-772).

- ``create_network(multiplier, network_dim, network_alpha, vae, text_encoder,
  unet, **network_args)`` with the whole network_args string grammar
  (``deprecated_arg_dict``, rs_lora, train_t5xxl, the LoRA+ ratios, ...);
- dual-tree targeting with ``UNET_TARGET_REPLACE_MODULE/NAME`` and
  ``TEXT_ENCODER_TARGET_REPLACE_MODULE/NAME``; prefixes ``lora_unet`` and
  ``lora_te``, or ``lora_te1``/``lora_te2`` for a list of text encoders;
- ``prepare_optimizer_params(te_lr, unet_lr, lr)`` with LoRA+ (parameters
  named ``lora_up`` get lr x ratio in a group of their own);
- ``save_weights`` with ``sshs_model_hash`` in the metadata.

``text_encoder`` and ``unet`` are torch modules (or :class:`ModelGraph`s of
them); ``vae`` is accepted and ignored, as in the reference. Each tree gets a
:class:`LycorisNetwork` of its own (``sub_networks[prefix]``); this network
holds their adapter modules once, in ``loras``, and the sub-networks hold the
same objects without being registered as its submodules, so every adapter
tensor appears once in ``parameters()`` and ``state_dict()``.
:meth:`LycorisNetworkKohya.apply_to` patches the forwards of the trees it
keeps and :meth:`~LycorisNetworkKohya.merge_to` folds each tree's adapters
into its weights in place, as the reference does (the JAX package, being
functional, returns the merged parameters instead). The trainer takes the
UNet's sub-network (``sub_networks["lora_unet"]``), as ``train.py`` does.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch import nn

from .config import PRESET
from .logging import logger
from .utils import precalculate_safetensors_hashes, safetensors_io, str_bool
from .utils.preset import read_preset
from .wrapper import (LycorisNetwork, _as_graph, create_lycoris_from_weights, deprecated_arg_dict,
                      load_file_sd)


def create_network(multiplier, network_dim, network_alpha, vae, text_encoder, unet, **kwargs):
    """network_args parsing of reference kohya.py:30-145. ``seed`` seeds the
    adapters' init; each adapter lies on its layer's device, in fp32."""
    for key, value in list(kwargs.items()):
        if key in deprecated_arg_dict:
            logger.warning(f"{key} is deprecated. Please use {deprecated_arg_dict[key]} instead.")
            kwargs[deprecated_arg_dict[key]] = value
    if network_dim is None:
        network_dim = 4
    conv_dim = int(kwargs.get("conv_dim", network_dim) or network_dim)
    conv_alpha = float(kwargs.get("conv_alpha", network_alpha) or network_alpha)
    dropout = float(kwargs.get("dropout", 0.0) or 0.0)
    rank_dropout = float(kwargs.get("rank_dropout", 0.0) or 0.0)
    module_dropout = float(kwargs.get("module_dropout", 0.0) or 0.0)
    algo = (kwargs.get("algo", "lora") or "lora").lower()
    use_tucker = str_bool(
        not kwargs.get("disable_conv_cp", True)
        or kwargs.get("use_conv_cp", False)
        or kwargs.get("use_cp", False)
        or kwargs.get("use_tucker", False)
    )
    use_scalar = str_bool(kwargs.get("use_scalar", False))
    block_size = int(kwargs.get("block_size", None) or 4)
    train_norm = str_bool(kwargs.get("train_norm", False))
    constraint = float(kwargs.get("constraint", None) or 0)
    rescaled = str_bool(kwargs.get("rescaled", False))
    weight_decompose = str_bool(kwargs.get("dora_wd", False))
    wd_on_output = str_bool(kwargs.get("wd_on_output", True))
    full_matrix = str_bool(kwargs.get("full_matrix", False))
    bypass_mode = str_bool(kwargs.get("bypass_mode", False))
    rs_lora = str_bool(kwargs.get("rs_lora", False))
    unbalanced_factorization = str_bool(kwargs.get("unbalanced_factorization", False))
    train_t5xxl = str_bool(kwargs.get("train_t5xxl", False))

    def _ratio(key):
        v = kwargs.get(key, None)
        return float(v) if v is not None else None

    loraplus_lr_ratio = _ratio("loraplus_lr_ratio")
    loraplus_unet_lr_ratio = _ratio("loraplus_unet_lr_ratio")
    loraplus_text_encoder_lr_ratio = _ratio("loraplus_text_encoder_lr_ratio")

    preset_str = kwargs.get("preset", "full")
    preset = PRESET[preset_str] if preset_str in PRESET else read_preset(preset_str)
    assert preset is not None
    LycorisNetworkKohya.apply_preset(preset)

    logger.info(f"Using rank adaptation algo: {algo}")
    if algo == "ia3" and preset_str != "ia3":
        logger.warning("It is recommended to use preset ia3 for IA^3 algorithm")

    network = LycorisNetworkKohya(
        text_encoder,
        unet,
        multiplier=multiplier,
        lora_dim=network_dim,
        conv_lora_dim=conv_dim,
        alpha=network_alpha,
        conv_alpha=conv_alpha,
        dropout=dropout,
        rank_dropout=rank_dropout,
        module_dropout=module_dropout,
        use_tucker=use_tucker,
        use_scalar=use_scalar,
        network_module=algo,
        train_norm=train_norm,
        decompose_both=kwargs.get("decompose_both", False),
        factor=kwargs.get("factor", -1),
        block_size=block_size,
        constraint=constraint,
        rescaled=rescaled,
        weight_decompose=weight_decompose,
        wd_on_out=wd_on_output,
        full_matrix=full_matrix,
        bypass_mode=bypass_mode,
        rs_lora=rs_lora,
        unbalanced_factorization=unbalanced_factorization,
        train_t5xxl=train_t5xxl,
        seed=int(kwargs.get("seed", 0)),
    )
    if (
        loraplus_lr_ratio is not None
        or loraplus_unet_lr_ratio is not None
        or loraplus_text_encoder_lr_ratio is not None
    ):
        network.set_loraplus_lr_ratio(
            loraplus_lr_ratio, loraplus_unet_lr_ratio, loraplus_text_encoder_lr_ratio
        )
    return network


def create_network_from_weights(
    multiplier, file, vae, text_encoder, unet, weights_sd=None, for_inference=False, **kwargs
):
    """Reference kohya.py:148-234: each tree's adapters from ``weights_sd``,
    or if that is None from the adapter file ``file``, the algorithm of each
    detected from its keys (``create_lycoris_from_weights`` under the
    tree's prefix). Each adapter goes to ``device`` if given, else to its
    layer's device, its tensors in fp32. Returns ``(network, weights_sd)``."""
    if weights_sd is None:
        weights_sd = load_file_sd(file)
    network = LycorisNetworkKohya(text_encoder, unet, init_only=True)
    network.te_graphs_list = network._te_graphs(text_encoder)
    network.unet_graph = network.graph = _as_graph(unet)
    for prefix, graph in [*network.te_graphs_list,
                          (LycorisNetworkKohya.LORA_PREFIX_UNET, network.unet_graph)]:
        network.sub_networks[prefix], _ = create_lycoris_from_weights(
            multiplier, None, graph, weights_sd=weights_sd, lora_prefix=prefix,
            device=kwargs.get("device"))
    network._gather()
    network.multiplier = multiplier
    logger.info(f"{len(network.loras)} Modules Loaded")
    return network, weights_sd


class LycorisNetworkKohya(LycorisNetwork):
    """Dual-tree (text encoders + UNet) targeting network (reference
    kohya.py:237-772)."""

    ENABLE_CONV = True
    UNET_TARGET_REPLACE_MODULE = PRESET["full"]["unet_target_module"]
    UNET_TARGET_REPLACE_NAME = PRESET["full"]["unet_target_name"]
    TEXT_ENCODER_TARGET_REPLACE_MODULE = PRESET["full"]["text_encoder_target_module"]
    TEXT_ENCODER_TARGET_REPLACE_NAME = []
    LORA_PREFIX_UNET = "lora_unet"
    LORA_PREFIX_TEXT_ENCODER = "lora_te"
    MODULE_ALGO_MAP = {}
    NAME_ALGO_MAP = {}
    USE_FNMATCH = False

    _KOHYA_DEFAULTS = None

    @classmethod
    def apply_preset(cls, preset):
        """Mutates class attributes like the reference; :meth:`reset_preset`
        restores the defaults."""
        if cls._KOHYA_DEFAULTS is None:
            cls._KOHYA_DEFAULTS = {
                "ENABLE_CONV": cls.ENABLE_CONV,
                "UNET_TARGET_REPLACE_MODULE": list(cls.UNET_TARGET_REPLACE_MODULE),
                "UNET_TARGET_REPLACE_NAME": list(cls.UNET_TARGET_REPLACE_NAME),
                "TEXT_ENCODER_TARGET_REPLACE_MODULE": list(cls.TEXT_ENCODER_TARGET_REPLACE_MODULE),
                "TEXT_ENCODER_TARGET_REPLACE_NAME": list(cls.TEXT_ENCODER_TARGET_REPLACE_NAME),
                "MODULE_ALGO_MAP": dict(cls.MODULE_ALGO_MAP),
                "NAME_ALGO_MAP": dict(cls.NAME_ALGO_MAP),
                "USE_FNMATCH": cls.USE_FNMATCH,
            }
        attrs = {
            "enable_conv": "ENABLE_CONV", "unet_target_module": "UNET_TARGET_REPLACE_MODULE",
            "unet_target_name": "UNET_TARGET_REPLACE_NAME",
            "text_encoder_target_module": "TEXT_ENCODER_TARGET_REPLACE_MODULE",
            "text_encoder_target_name": "TEXT_ENCODER_TARGET_REPLACE_NAME",
            "module_algo_map": "MODULE_ALGO_MAP", "name_algo_map": "NAME_ALGO_MAP",
            "use_fnmatch": "USE_FNMATCH",
        }
        for key, attr in attrs.items():
            if key in preset:
                setattr(cls, attr, preset[key])
        return cls

    @classmethod
    def reset_preset(cls):
        if cls._KOHYA_DEFAULTS is not None:
            for k, v in cls._KOHYA_DEFAULTS.items():
                setattr(cls, k, v)

    def _te_graphs(self, text_encoder):
        """[(prefix, graph)] of the text encoders: ``lora_te`` for one,
        ``lora_te1``, ``lora_te2``, ... for a list."""
        if not text_encoder:
            return []
        tes = text_encoder if isinstance(text_encoder, list) else [text_encoder]
        use_index = isinstance(text_encoder, list)
        return [
            (self.LORA_PREFIX_TEXT_ENCODER + (f"{i + 1}" if use_index else ""), _as_graph(te))
            for i, te in enumerate(tes)
        ]

    def __init__(self, text_encoder, unet, train_t5xxl=False, init_only=False, **kwargs):
        super().__init__(None, init_only=True)
        self.train_t5xxl = train_t5xxl
        self.loraplus_lr_ratio = None
        self.loraplus_unet_lr_ratio = None
        self.loraplus_text_encoder_lr_ratio = None
        self.unet_loras: list = []
        self.text_encoder_loras: list = []
        self.sub_networks: dict = {}  # a plain dict: the sub-networks are not submodules
        self.te_graphs_list: list = []
        if init_only:
            return

        cls = type(self)
        network_module = kwargs.get("network_module", "locon")
        # NOTE: the reference compares ``network_module == GLoRAModule`` (a
        # class) against the algo STRING (kohya.py:498-505), so its GLoRA
        # target-narrowing is dead code; the JAX package and the port honor
        # the evident intent.
        if network_module == "glora":
            logger.info("GLoRA enabled, only train transformer")
            unet_targets = ["Transformer2DModel", "Attention"]
            unet_target_names = []
        else:
            unet_targets = list(cls.UNET_TARGET_REPLACE_MODULE)
            unet_target_names = list(cls.UNET_TARGET_REPLACE_NAME)

        self.te_graphs_list = self._te_graphs(text_encoder)
        for prefix, g in self.te_graphs_list:
            sub = LycorisNetwork(
                g,
                lora_prefix_override=prefix,
                target_module_override=list(cls.TEXT_ENCODER_TARGET_REPLACE_MODULE),
                target_name_override=list(cls.TEXT_ENCODER_TARGET_REPLACE_NAME),
                **kwargs,
            )
            self.sub_networks[prefix] = sub
        logger.info(f"create LyCORIS for Text Encoder: "
                    f"{sum(len(self.sub_networks[p].loras) for p, _ in self.te_graphs_list)} "
                    f"modules.")

        self.unet_graph = _as_graph(unet)
        unet_sub = LycorisNetwork(
            self.unet_graph,
            lora_prefix_override=cls.LORA_PREFIX_UNET,
            target_module_override=unet_targets,
            target_name_override=unet_target_names,
            **kwargs,
        )
        self.sub_networks[cls.LORA_PREFIX_UNET] = unet_sub
        logger.info(f"create LyCORIS for U-Net: {len(unet_sub.loras)} modules.")
        self._gather()
        logger.info(f"module type table: {self.algo_table}")
        self.multiplier = kwargs.get("multiplier", 1.0)
        self.graph = self.unet_graph

        names = set()
        for lora in self.loras:
            assert lora.lora_name not in names, f"duplicated lora name: {lora.lora_name}"
            names.add(lora.lora_name)

    def _gather(self):
        """The base-network fields over every tree's sub-network (text
        encoders first), each adapter module once, so that every inherited
        method sees every tree."""
        self.text_encoder_loras = [lora for p, _ in self.te_graphs_list
                                   for lora in self.sub_networks[p].loras]
        self.unet_loras = list(self.sub_networks[self.LORA_PREFIX_UNET].loras)
        self.loras = nn.ModuleList(self.text_encoder_loras + self.unet_loras)
        for sub in self.sub_networks.values():
            self.lora_map.update(sub.lora_map)
            self.node_map.update(sub.node_map)
            for name, n in sub.algo_table.items():
                self.algo_table[name] = self.algo_table.get(name, 0) + n

    # -- lifecycle (reference kohya.py:589-650) ------------------------------------
    def apply_to(self, text_encoder=None, unet=None, apply_text_encoder=None, apply_unet=None):
        """Drop the adapters of the trees not asked for, then patch the
        forwards of the kept trees' targeted layers on the merged route (one
        op with W + dW a layer, the trainer's route)."""
        assert apply_text_encoder is not None and apply_unet is not None, "internal error: flag not set"
        if apply_text_encoder:
            logger.info("enable LyCORIS for text encoder")
        else:
            self.text_encoder_loras = []
        if apply_unet:
            logger.info("enable LyCORIS for U-Net")
        else:
            self.unet_loras = []
        self.loras = nn.ModuleList(self.text_encoder_loras + self.unet_loras)
        keep = {lora.lora_name for lora in self.loras}
        self.lora_map = {k: v for k, v in self.lora_map.items() if k in keep}
        for sub in self.sub_networks.values():
            if any(lora.lora_name in keep for lora in sub.loras):
                sub.apply_to(merged_forward=True)
        return self

    def restore(self):
        """Give every patched layer of every tree its own forward back."""
        for sub in self.sub_networks.values():
            sub.restore()
        return self

    def set_multiplier(self, multiplier):
        super().set_multiplier(multiplier)
        for sub in self.sub_networks.values():
            sub.multiplier = multiplier
        return self

    @torch.no_grad()
    def merge_to(self, text_encoder=None, unet=None, weights_sd=None, dtype=None, device=None,
                 weight=1.0):
        """Fold each tree's adapters into its layers' weights, in place; a
        patched tree gets its layers' own forwards back first, so the trees
        then run as plain models on the merged weights."""
        if weights_sd is not None:
            self.load_state_dict(weights_sd)
        for sub in self.sub_networks.values():
            sub.restore()
            sub.merge_to(weight)
        return self

    # -- LoRA+ optimizer groups (reference kohya.py:666-731) ------------------------
    def set_loraplus_lr_ratio(self, loraplus_lr_ratio, loraplus_unet_lr_ratio,
                              loraplus_text_encoder_lr_ratio):
        self.loraplus_lr_ratio = loraplus_lr_ratio
        self.loraplus_unet_lr_ratio = loraplus_unet_lr_ratio
        self.loraplus_text_encoder_lr_ratio = loraplus_text_encoder_lr_ratio
        logger.info(f"LoRA+ UNet LR Ratio: {self.loraplus_unet_lr_ratio or self.loraplus_lr_ratio}")
        logger.info(
            f"LoRA+ Text Encoder LR Ratio: {self.loraplus_text_encoder_lr_ratio or self.loraplus_lr_ratio}"
        )

    def prepare_optimizer_params(self, text_encoder_lr=None, unet_lr: float = 1e-4,
                                 learning_rate=None):
        """(torch optimizer param groups, descriptions): per tree, a group of
        the adapter parameters and, with a LoRA+ ratio, one of those named
        ``lora_up`` at lr x ratio; a group whose lr is 0 or None is left
        out. Each group's ``names`` lists its parameters' qualified names
        (``{lora_name}.{key}``)."""
        all_params = []
        lr_descriptions = []

        def assemble_params(loras, lr, ratio):
            groups = {"lora": {}, "plus": {}}
            for lora in loras:
                for name, param in lora.named_parameters():
                    qual = f"{lora.lora_name}.{name}"
                    if ratio is not None and "lora_up" in name:
                        groups["plus"][qual] = param
                    else:
                        groups["lora"][qual] = param
            params, descriptions = [], []
            for key, group in groups.items():
                if not group:
                    continue
                param_data = {"params": list(group.values()), "names": list(group)}
                if lr is not None:
                    param_data["lr"] = lr * ratio if key == "plus" else lr
                if param_data.get("lr", None) in (0, None):
                    logger.info("NO LR skipping!")
                    continue
                params.append(param_data)
                descriptions.append("plus" if key == "plus" else "")
            return params, descriptions

        if self.text_encoder_loras:
            params, descriptions = assemble_params(
                self.text_encoder_loras,
                text_encoder_lr if text_encoder_lr is not None else learning_rate,
                self.loraplus_text_encoder_lr_ratio or self.loraplus_lr_ratio,
            )
            all_params.extend(params)
            lr_descriptions.extend(["textencoder" + (" " + d if d else "") for d in descriptions])

        if self.unet_loras:
            params, descriptions = assemble_params(
                self.unet_loras,
                unet_lr if unet_lr is not None else learning_rate,
                self.loraplus_unet_lr_ratio or self.loraplus_lr_ratio,
            )
            all_params.extend(params)
            lr_descriptions.extend(["unet" + (" " + d if d else "") for d in descriptions])

        return all_params, lr_descriptions

    # -- the kohya trainer's callbacks (reference kohya.py:733-747) -------------------
    def enable_gradient_checkpointing(self):
        """kohya's train_network.py calls this when ``--gradient_checkpointing``
        is set (the reference's is a no-op). The port checkpoints by the
        model's config (``UNetConfig.remat``)."""

    def prepare_grad_etc(self, *args):
        """Every adapter parameter trains (reference kohya.py:737-738)."""
        self.requires_grad_(True)

    def on_epoch_start(self, *args):
        """Reference kohya.py:740-741."""
        self.train()

    def on_step_start(self, *args):
        pass

    def get_trainable_params(self):
        return self.trainable_params()

    def save_weights(self, file, dtype=None, metadata=None):
        """Write :meth:`state_dict` to ``file``: ``.safetensors`` with
        ``metadata`` and ``sshs_model_hash``, the hash of the tensors'
        bytes with empty metadata; any other extension through
        ``torch.save`` of CPU tensors."""
        if metadata is not None and len(metadata) == 0:
            metadata = None
        sd = {k: v.detach().cpu().contiguous() for k, v in self.state_dict(dtype=dtype).items()}
        if os.path.splitext(file)[1] == ".safetensors":
            metadata = dict(metadata or {})
            model_hash, _ = precalculate_safetensors_hashes(sd, {})
            metadata["sshs_model_hash"] = model_hash
            safetensors_io.save_file(sd, file, metadata)
        else:
            torch.save(sd, file)

    # -- runtime ---------------------------------------------------------------
    def _run(self, prefix, *args, **kw):
        """The tree of ``prefix`` called on ``args`` with its adapters live:
        patched for the call if :meth:`apply_to` has not patched it."""
        sub = self.sub_networks[prefix]
        with contextlib.ExitStack() as stack:
            if not sub._patched:
                sub.apply_to()
                stack.callback(sub.restore)
            return sub.graph.model(*args, **kw)

    def apply_unet(self, *args, **kw):
        """The UNet's forward with its adapters."""
        return self._run(type(self).LORA_PREFIX_UNET, *args, **kw)

    def apply_text_encoder(self, idx_or_ids, *args, **kw):
        """Text encoder ``idx`` (an int) on ``args``, or the first one on
        ``idx_or_ids`` and ``args``, with its adapters."""
        if isinstance(idx_or_ids, int):
            prefix, _ = self.te_graphs_list[idx_or_ids]
            return self._run(prefix, *args, **kw)
        prefix, _ = self.te_graphs_list[0]
        return self._run(prefix, idx_or_ids, *args, **kw)
