"""LycorisNetwork -- targeting and lifecycle over a whole model (counterpart
of ``lycoris_tpu/wrapper.py``; reference lycoris/wrapper.py:64-648).

Targeting is the JAX package's: TARGET_REPLACE_MODULE class matching with
recursion, TARGET_REPLACE_NAME / NAME_ALGO_MAP regex-or-fnmatch matching,
MODULE_ALGO_MAP per-class overrides, exclusion first, the same
``lora_name`` for every layer. Every ``algo=`` of the JAX package builds
(``network_module_dict``), and with ``train_norm`` each targeted layer
whose class name holds "Norm" gets a :class:`~.modules.norms.NormModule`
(JAX wrapper.py:388-397).

Lifecycle follows the reference LyCORIS: :meth:`LycorisNetwork.apply_to`
puts an adapted forward in place of each targeted layer's ``forward`` and
:meth:`~LycorisNetwork.restore` puts the layer's own back. With
``merged_forward=True`` the adapted forward runs the layer once with
``W + dW`` (the JAX interceptor's merged path, wrapper.py:646-718);
otherwise, and always for bypass modules, it is delta over base. With
grad enabled, a linear layer whose adapter has a factored cotangent
(LoRA/LoCon, LoKr) and whose harmonic dimension passes ``worth_factoring``
trains through the factored backward of ``functional/merged.py``, which
never forms the dense weight gradient; every other layer trains by
autograd through ``W + dW``.
Inside :meth:`~LycorisNetwork.training_step` (``DiffusionTrainer.train_step``
enters it around the forward and the backward) the forwards train: an
adapter with a nonzero ``dropout``, ``rank_dropout`` or ``module_dropout``
then leaves the merged and factored routes for its own delta-over-base
forward with the dropout trio, its draws seeded from the step's seed and its
``lora_name`` (the JAX interceptor's ``train=True, rng=...``,
wrapper.py:635-651). Everywhere else the route is the one above. A DoRA
layer (``dora_wd``) takes the merged route with plain autograd: its modules
decline the factored backward, as the JAX modules do.
:meth:`~LycorisNetwork.merge_to` folds the adapters into the layers'
weights in place; :meth:`~LycorisNetwork.onfly_merge` does the same and
keeps the layers' own weights for :meth:`~LycorisNetwork.onfly_restore`.
:meth:`~LycorisNetwork.premerged` is the premerge route of the trainer:
inside it every mergeable layer holds its merged weight, formed with
autograd from the adapters, and the model runs as a plain model.
A quantized base layer (``utils/quant.py``: ``Int8Linear``, or a class of
``QUANT_CLASSES``) gets its adapter in bypass mode, also when it is loaded
from a file, and takes neither the merged route nor premerge nor
``merge_to``; ``algo="full"`` refuses it (JAX wrapper.py:414-424, 786).
State dicts use the reference key grammar, and
:meth:`~LycorisNetwork.save_weights`, :meth:`~LycorisNetwork.load_weights`
and ``create_lycoris_from_weights(file=...)`` read and write them as
``.safetensors`` (``utils/safetensors_io.py``) or as a ``torch.save`` file of
CPU tensors for any other extension, as the JAX package does.
"""

from __future__ import annotations

import contextlib
import fnmatch
import os
import re
import zlib
from typing import Any

import torch
from torch import nn

from .config import PRESET
from .functional import merged as fm
from .graph import ModelGraph
from .logging import logger
from .modules import (ButterflyOFTModule, DiagOFTModule, DyLoraModule, FullModule, GLoRAModule,
                      IA3Module, LoConModule, LohaModule, LokrModule, NormModule, get_module,
                      make_module)
from .modules.base import fold_in
from .observability import span
from .utils import safetensors_io, str_bool
from .utils.preset import read_preset
from .utils.quant import log_bypass

VALID_PRESET_KEYS = [
    "enable_conv",
    "target_module",
    "target_name",
    "module_algo_map",
    "name_algo_map",
    "lora_prefix",
    "use_fnmatch",
    "unet_target_module",
    "unet_target_name",
    "text_encoder_target_module",
    "text_encoder_target_name",
    "exclude_name",
]

def _merged(lyco, w, b, multiplier, dtype):
    """``lyco``'s merged weight for a layer of weight ``w`` and bias ``b``
    (``get_merged_weight``), the weight cast to ``dtype``, and its bias: one
    ``lycoris.merge`` span, the one every route that forms W + dW opens."""
    with span("lycoris.merge"):
        w_m, b_m = lyco.get_merged_weight(w, b, multiplier=multiplier)
        return w_m.to(dtype), b_m


network_module_dict = {
    "lora": LoConModule,
    "locon": LoConModule,
    "loha": LohaModule,
    "dylora": DyLoraModule,
    "glora": GLoRAModule,
    "lokr": LokrModule,
    "ia3": IA3Module,
    "full": FullModule,
    "diag-oft": DiagOFTModule,
    "boft": ButterflyOFTModule,
}

deprecated_arg_dict = {
    "disable_conv_cp": "use_tucker",
    "use_cp": "use_tucker",
    "use_conv_cp": "use_tucker",
    "constrain": "constraint",
}


def _module_class(algo: str):
    cls = network_module_dict.get(algo)
    if cls is None:
        raise ValueError(f"unknown algorithm {algo!r}")
    return cls


def _as_graph(model_or_graph) -> ModelGraph:
    if isinstance(model_or_graph, ModelGraph):
        return model_or_graph
    if isinstance(model_or_graph, nn.Module):
        return ModelGraph.from_torch(model_or_graph)
    raise TypeError("expected a torch nn.Module or a ModelGraph")


def _model_device(graph: ModelGraph) -> torch.device:
    """The device of the wrapped model's layer weights (the CPU if none)."""
    for node in graph.nodes:
        w = getattr(node.module, "weight", None) if node.is_leaf else None
        if isinstance(w, torch.Tensor):
            return w.device
    return torch.device("cpu")


def create_lycoris(module, multiplier=1.0, linear_dim=4, linear_alpha=1, **kwargs):
    """kwargs parsing of reference wrapper.py:64-145. ``device``/``dtype``
    place the adapter tensors (by default on the device of the model's
    weights); ``seed`` seeds their init."""
    for key, value in list(kwargs.items()):
        if key in deprecated_arg_dict:
            logger.warning(f"{key} is deprecated. Please use {deprecated_arg_dict[key]} instead.")
            kwargs[deprecated_arg_dict[key]] = value
    if linear_dim is None:
        linear_dim = 4
    conv_dim = int(kwargs.get("conv_dim", linear_dim) or linear_dim)
    conv_alpha = float(kwargs.get("conv_alpha", linear_alpha) or linear_alpha)
    algo = (kwargs.get("algo", "lora") or "lora").lower()
    use_tucker = str_bool(
        not kwargs.get("disable_conv_cp", True)
        or kwargs.get("use_conv_cp", False)
        or kwargs.get("use_cp", False)
        or kwargs.get("use_tucker", False)
    )
    preset = kwargs.get("preset", "full")
    if preset not in PRESET:
        preset = read_preset(preset)
    else:
        preset = PRESET[preset]
    assert preset is not None
    LycorisNetwork.apply_preset(preset)
    logger.info(f"Using rank adaptation algo: {algo}")
    return LycorisNetwork(
        module,
        multiplier=multiplier,
        lora_dim=linear_dim,
        conv_lora_dim=conv_dim,
        alpha=linear_alpha,
        conv_alpha=conv_alpha,
        dropout=float(kwargs.get("dropout", 0.0) or 0.0),
        rank_dropout=float(kwargs.get("rank_dropout", 0.0) or 0.0),
        module_dropout=float(kwargs.get("module_dropout", 0.0) or 0.0),
        use_tucker=use_tucker,
        use_scalar=str_bool(kwargs.get("use_scalar", False)),
        network_module=algo,
        train_norm=str_bool(kwargs.get("train_norm", False)),
        decompose_both=kwargs.get("decompose_both", False),
        factor=kwargs.get("factor", -1),
        block_size=int(kwargs.get("block_size", 4) or 4),
        constraint=float(kwargs.get("constraint", 0) or 0),
        rescaled=str_bool(kwargs.get("rescaled", False)),
        weight_decompose=str_bool(kwargs.get("dora_wd", False)),
        wd_on_out=str_bool(kwargs.get("wd_on_output", True)),
        full_matrix=str_bool(kwargs.get("full_matrix", False)),
        bypass_mode=str_bool(kwargs.get("bypass_mode", False)),
        unbalanced_factorization=str_bool(kwargs.get("unbalanced_factorization", False)),
        train_on_input=str_bool(kwargs.get("train_on_input", False)),
        seed=int(kwargs.get("seed", 0)),
        device=kwargs.get("device"),
        dtype=kwargs.get("dtype", torch.float32),
    )


def create_lycoris_from_weights(multiplier, file, module, weights_sd=None, lora_prefix=None,
                                **kwargs):
    """Build a network from a state dict in the reference key grammar, the
    algorithm of each layer detected from its keys (reference wrapper.py:148-194):
    ``weights_sd``, or if that is None the adapter file ``file``
    (:func:`load_file_sd`); ``lora_prefix`` (the class's ``LORA_PREFIX`` by
    default) is the prefix of its layers' keys. Each adapter goes to
    ``device`` if given, else to its layer's device, its tensors in fp32.
    Returns ``(network, weights_sd)``."""
    if weights_sd is None:
        weights_sd = load_file_sd(file)
    lora_prefix = lora_prefix or LycorisNetwork.LORA_PREFIX
    graph = _as_graph(module)
    prefixes: dict[str, Any] = {}
    for key in weights_sd:
        if "." in key:
            prefixes[key.split(".")[0]] = None
    for name, node in graph.named_modules():
        lora_name = f"{lora_prefix}_{name}".replace(".", "_")
        if lora_name in prefixes:
            prefixes[lora_name] = node

    network = LycorisNetwork(graph, init_only=True, lora_prefix_override=lora_prefix)
    network.multiplier = multiplier
    loras = []
    for lora_name, node in prefixes.items():
        if node is None or not node.is_leaf:
            continue
        lyco_type, params = get_module(weights_sd, lora_name)
        if lyco_type is None:
            continue
        device = kwargs.get("device") or node.weights()[0].device
        mod = make_module(lyco_type, params, lora_name, node.layer_info, device=device)
        if mod is None:
            continue
        if node.is_quant:
            mod.bypass_mode = True  # dW never touches a quantized weight
        mod.multiplier = multiplier
        loras.append(mod)
        network.lora_map[lora_name] = mod
        network.node_map[lora_name] = node
        name = mod.__class__.__name__
        network.algo_table[name] = network.algo_table.get(name, 0) + 1
    network.loras = nn.ModuleList(loras)
    logger.info(f"{len(network.loras)} Modules Loaded")
    return network, weights_sd


def load_file_sd(file) -> dict:
    """A flat state dict of CPU tensors from ``.safetensors`` or, for any
    other extension, a ``torch.save`` file (JAX wrapper.py:214-223)."""
    if os.path.splitext(file)[1] == ".safetensors":
        return safetensors_io.load_file(file)
    return torch.load(file, map_location="cpu", weights_only=True)


class LycorisNetwork(nn.Module):
    ENABLE_CONV = True
    TARGET_REPLACE_MODULE = [
        "Linear", "Conv1d", "Conv2d", "Conv3d", "GroupNorm", "LayerNorm", "RMSNorm",
        "Dense", "Conv", "Int8Linear", "QuantLinear", "Linear8bitLt", "LinearFP4", "LinearNF4",
    ]
    TARGET_REPLACE_NAME = []
    LORA_PREFIX = "lycoris"
    MODULE_ALGO_MAP = {}
    NAME_ALGO_MAP = {}
    USE_FNMATCH = False
    TARGET_EXCLUDE_NAME = []

    _DEFAULTS = None  # snapshot for reset_preset

    @classmethod
    def apply_preset(cls, preset):
        """Mutates class attributes like the reference (wrapper.py:214-238);
        :meth:`reset_preset` restores the defaults."""
        if cls._DEFAULTS is None:
            cls._DEFAULTS = {
                "ENABLE_CONV": cls.ENABLE_CONV,
                "TARGET_REPLACE_MODULE": list(cls.TARGET_REPLACE_MODULE),
                "TARGET_REPLACE_NAME": list(cls.TARGET_REPLACE_NAME),
                "LORA_PREFIX": cls.LORA_PREFIX,
                "MODULE_ALGO_MAP": dict(cls.MODULE_ALGO_MAP),
                "NAME_ALGO_MAP": dict(cls.NAME_ALGO_MAP),
                "USE_FNMATCH": cls.USE_FNMATCH,
                "TARGET_EXCLUDE_NAME": list(cls.TARGET_EXCLUDE_NAME),
            }
        for preset_key in preset.keys():
            if preset_key not in VALID_PRESET_KEYS:
                raise KeyError(f'Unknown preset key "{preset_key}". Valid keys: {VALID_PRESET_KEYS}')
        attrs = {
            "enable_conv": "ENABLE_CONV", "target_module": "TARGET_REPLACE_MODULE",
            "target_name": "TARGET_REPLACE_NAME", "module_algo_map": "MODULE_ALGO_MAP",
            "name_algo_map": "NAME_ALGO_MAP", "lora_prefix": "LORA_PREFIX",
            "use_fnmatch": "USE_FNMATCH", "exclude_name": "TARGET_EXCLUDE_NAME",
        }
        for key, attr in attrs.items():
            if key in preset:
                setattr(cls, attr, preset[key])
        return cls

    @classmethod
    def reset_preset(cls):
        if cls._DEFAULTS is not None:
            for k, v in cls._DEFAULTS.items():
                setattr(cls, k, v)

    def __init__(self, module, multiplier=1.0, lora_dim=4, conv_lora_dim=4, alpha=1,
                 conv_alpha=1, use_tucker=False, dropout=0, rank_dropout=0, module_dropout=0,
                 network_module: str = "locon", train_norm=False, init_only=False, seed: int = 0,
                 device=None, dtype=torch.float32, lora_prefix_override=None,
                 target_module_override=None, target_name_override=None, **kwargs):
        """``*_override`` replace the preset's lora prefix, target classes
        and target names for this network alone (the kohya sub-networks').
        With ``init_only`` the network is an empty shell and ``module`` may
        be None."""
        super().__init__()
        root_kwargs = kwargs
        self.loras = nn.ModuleList()
        self.lora_map: dict[str, Any] = {}
        self.node_map: dict[str, Any] = {}
        self.algo_table: dict[str, int] = {}
        self.merged_forward = False
        self._patched: dict[str, Any] = {}
        self._drop_seed: int | None = None
        self._batch_shard = (0, 1)  # (data rank, data ranks) of a training forward's batch
        cls = type(self)
        self.enable_conv = cls.ENABLE_CONV
        self.target_replace_module = list(cls.TARGET_REPLACE_MODULE)
        self.target_replace_name = list(cls.TARGET_REPLACE_NAME)
        self.lora_prefix = cls.LORA_PREFIX
        self.module_algo_map = dict(cls.MODULE_ALGO_MAP)
        self.name_algo_map = dict(cls.NAME_ALGO_MAP)
        self.use_fnmatch = cls.USE_FNMATCH
        self.target_exclude_name = list(cls.TARGET_EXCLUDE_NAME)
        if lora_prefix_override is not None:
            self.lora_prefix = lora_prefix_override
        if target_module_override is not None:
            self.target_replace_module = list(target_module_override)
        if target_name_override is not None:
            self.target_replace_name = list(target_name_override)
        self.graph = None if module is None and init_only else _as_graph(module)
        self.multiplier = multiplier if not init_only else 1
        if init_only:
            self.lora_dim = 0
            return

        self.lora_dim = lora_dim
        if not self.enable_conv:
            conv_lora_dim = 0
        self.conv_lora_dim = int(conv_lora_dim)
        self.alpha = alpha
        self.conv_alpha = float(conv_alpha)
        self.dropout = dropout
        self.rank_dropout = rank_dropout
        self.module_dropout = module_dropout
        self.use_tucker = use_tucker
        device = torch.device(device) if device is not None else _model_device(self.graph)

        def module_generator(lora_name):
            g = torch.Generator(device=device)
            return g.manual_seed(seed * 1_000_003 + zlib.crc32(lora_name.encode()))

        def create_single_module(lora_name, node, algo_name, dim=None, alpha_=None,
                                 use_tucker_=None, **cfg):
            """dim/alpha by layer kind, then algorithm dispatch (wrapper.py:301-354)."""
            for k, v in root_kwargs.items():
                if k not in cfg:
                    cfg[k] = v
            cfg.pop("algo", None)
            alpha_ = cfg.pop("alpha", alpha_)
            dim = cfg.pop("dim", dim)
            if use_tucker_ is None:
                use_tucker_ = cfg.pop("use_tucker", self.use_tucker)
            li = node.layer_info
            if li is None:
                return None
            if train_norm and "Norm" in node.class_name:
                return NormModule(lora_name, li, self.multiplier, self.rank_dropout,
                                  self.module_dropout, device=device, dtype=dtype, **cfg)
            if li.is_norm:
                return None
            if li.module_type == "linear" and lora_dim > 0:
                dim = dim or lora_dim
                alpha_ = alpha_ or self.alpha
            elif li.is_conv:
                k_size = li.shape[2] if len(li.shape) > 2 else 1
                if k_size == 1 and lora_dim > 0:
                    dim = dim or lora_dim
                    alpha_ = alpha_ or self.alpha
                elif self.conv_lora_dim > 0 or dim:
                    dim = dim or self.conv_lora_dim
                    alpha_ = alpha_ or self.conv_alpha
                else:
                    return None
            else:
                return None
            if node.is_quant:
                # QLyCORIS: dW never touches a quantized weight (JAX wrapper.py:414-424)
                if algo_name == "full":
                    raise ValueError("Quant layers are not supported in Full algo.")
                log_bypass()
                cfg["bypass_mode"] = True
            return _module_class(algo_name)(
                lora_name, li, self.multiplier, dim, alpha_, self.dropout, self.rank_dropout,
                self.module_dropout, use_tucker=use_tucker_,
                generator=module_generator(lora_name), device=device, dtype=dtype,
                org_weight=node.weights()[0], **cfg,
            )

        def create_modules_(prefix, root_name, algo, current_lora_map, configs={}):
            """Recursive class-scope walk (wrapper.py:356-405)."""
            loras_ = current_lora_map
            lora_names = []
            for name, node in self.graph.named_modules(root_name):
                if node.class_name in self.module_algo_map and name != "":
                    next_config = dict(self.module_algo_map[node.class_name])
                    next_algo = next_config.get("algo", algo)
                    full_name = f"{root_name}.{name}" if root_name else name
                    new_loras, new_names, new_map = create_modules_(
                        f"{prefix}_{name}" if name else prefix, full_name, next_algo, loras_,
                        configs=next_config,
                    )
                    loras_ = {**loras_, **new_map}
                    for ln, lora in zip(new_names, new_loras):
                        if ln not in loras_ and ln not in current_lora_map:
                            loras_[ln] = lora
                        if ln not in lora_names:
                            lora_names.append(ln)
                    continue
                lora_name = prefix + "." + name if name else prefix
                if f"{self.lora_prefix}_." in lora_name:
                    lora_name = lora_name.replace(f"{self.lora_prefix}_.", f"{self.lora_prefix}.")
                lora_name = lora_name.replace(".", "_")
                if lora_name in loras_:
                    continue
                lora = create_single_module(lora_name, node, algo, **configs)
                if lora is not None:
                    loras_[lora_name] = lora
                    lora_names.append(lora_name)
                    self.node_map[lora_name] = node
            return [loras_[ln] for ln in lora_names], lora_names, loras_

        def create_modules(prefix, target_replace_modules, target_replace_names=[],
                           target_exclude_names=[]):
            """Top-level walk (wrapper.py:408-468)."""
            loras_ = []
            lora_map = {}
            next_config = {}
            for name, node in self.graph.named_modules():
                if name == "":
                    continue
                if name in target_exclude_names or any(
                    self.match_fn(t, name) for t in target_exclude_names
                ):
                    continue
                module_name = node.class_name
                if module_name in target_replace_modules and not any(
                    self.match_fn(t, name) for t in target_replace_names
                ):
                    if module_name in self.module_algo_map:
                        next_config = dict(self.module_algo_map[module_name])
                        algo = next_config.get("algo", network_module)
                    else:
                        algo = network_module
                    lora_lst, _, _map = create_modules_(
                        f"{prefix}_{name}", name, algo, lora_map, configs=next_config
                    )
                    lora_map = {**lora_map, **_map}
                    loras_.extend(lora_lst)
                    next_config = {}
                elif name in target_replace_names or any(
                    self.match_fn(t, name) for t in target_replace_names
                ):
                    conf = self.find_conf_for_name(name)
                    if conf is not None:
                        next_config = dict(conf)
                        algo = next_config.get("algo", network_module)
                    elif module_name in self.module_algo_map:
                        next_config = dict(self.module_algo_map[module_name])
                        algo = next_config.get("algo", network_module)
                    else:
                        algo = network_module
                    lora_name = (prefix + "." + name).replace(".", "_")
                    if lora_name in lora_map:
                        continue
                    lora = create_single_module(lora_name, node, algo, **next_config)
                    next_config = {}
                    if lora is not None:
                        lora_map[lora_name] = lora
                        loras_.append(lora)
                        self.node_map[lora_name] = node
            return loras_, lora_map

        loras, self.lora_map = create_modules(
            self.lora_prefix,
            list(set([*self.target_replace_module, *self.module_algo_map.keys()])),
            list(set([*self.target_replace_name, *self.name_algo_map.keys()])),
            target_exclude_names=self.target_exclude_name,
        )
        self.loras = nn.ModuleList(loras)
        logger.info(f"create LyCORIS: {len(self.loras)} modules.")
        for lora in self.loras:
            name = lora.__class__.__name__
            self.algo_table[name] = self.algo_table.get(name, 0) + 1
        names = set()
        for lora in self.loras:
            assert lora.lora_name not in names, f"duplicated lora name: {lora.lora_name}"
            names.add(lora.lora_name)

    # -- targeting helpers ----------------------------------------------------
    def match_fn(self, pattern: str, name: str) -> bool:
        if self.use_fnmatch:
            return fnmatch.fnmatch(name, pattern)
        return bool(re.match(pattern, name))

    def find_conf_for_name(self, name: str):
        if name in self.name_algo_map:
            return self.name_algo_map[name]
        for key, value in self.name_algo_map.items():
            if self.match_fn(key, name):
                return value
        return None

    def trainable_params(self) -> dict:
        """The adapters' trainable parameters, ``{lora_name: {key: Parameter}}``."""
        return {lyco.lora_name: dict(lyco.named_parameters()) for lyco in self.loras}

    def get_trainable_params(self) -> dict:
        return self.trainable_params()

    def prepare_optimizer_params(self, lr=None) -> list:
        """One torch optimizer parameter group of every trainable adapter
        tensor, with ``lr`` if given (JAX wrapper.py:860-864)."""
        group = {"params": [p for sub in self.trainable_params().values() for p in sub.values()]}
        if lr is not None:
            group["lr"] = lr
        return [group]

    def set_multiplier(self, multiplier):
        self.multiplier = multiplier
        for lyco in self.loras:
            lyco.multiplier = multiplier

    def is_mergeable(self) -> bool:
        return True

    # -- lifecycle ------------------------------------------------------------
    def _factored_apply(self, lyco, node, x, w, b, mult):
        """The layer through ``factored_merged_apply`` (dense-dW-free
        backward), or None where that path does not apply: no grad wanted,
        not a linear layer, below the ``worth_factoring`` threshold, or an
        adapter without a factored cotangent (LoHa; LoRA/LoCon and LoKr
        decline convolutions, tucker and rank dropout)."""
        fns_of = getattr(lyco, "factored_merged_fns", None)
        if (fns_of is None or not torch.is_grad_enabled() or lyco.module_type != "linear"
                or not any(p.requires_grad for p in lyco.parameters())):
            return None
        out_dim, in_dim = lyco.shape[0], lyco.shape[1]
        if not fm.worth_factoring(out_dim, in_dim, fm.FACTORED_MIN):
            return None
        fns = fns_of(mult)
        if fns is None:
            return None
        recon_fn, dtheta_fn = fns
        return fm.factored_merged_apply(
            x, w, None if b is None else b.to(x.dtype), dict(lyco.params),
            recon_fn=recon_fn, dtheta_fn=dtheta_fn,
            apply_fn=lambda xx, ww, bb: node.apply(xx, ww.to(xx.dtype), bb),
            # the layer's output layout -> (..., T, out): dx = g W, dy2d = g
            dx_fn=lambda g, ww: node.from_native(g) @ ww.to(g.dtype),
            dy2d_fn=lambda g: node.from_native(g).reshape(-1, out_dim),
        )

    @contextlib.contextmanager
    def training_step(self, seed: int, batch_shard=(0, 1)):
        """Forwards inside the block are training forwards whose dropout
        draws come from ``seed`` and each adapter's ``lora_name``. Keep the
        backward inside it too: the recompute of a checkpointed block reads
        the seed again and draws the same masks. ``batch_shard = (i, n)``:
        the batch is data rank i's rows of one split over n ranks (plain
        dropout draws its mask for the whole batch and takes those rows)."""
        prev = self._drop_seed, self._batch_shard
        self._drop_seed, self._batch_shard = int(seed), tuple(batch_shard)
        try:
            yield self
        finally:
            self._drop_seed, self._batch_shard = prev

    def _adapted_forward(self, lora_name):
        lyco = self.lora_map[lora_name]
        node = self.node_map[lora_name]
        org_forward = node.module.forward

        def forward(x, *args, **kwargs):
            w, b = node.weights()
            mult = self.multiplier
            train = self._drop_seed is not None
            drops = train and bool(lyco.dropout or lyco.rank_dropout or lyco.module_dropout)
            if (self.merged_forward and not lyco.bypass_mode and not lyco.not_supported
                    and not node.is_quant and not drops):
                out = self._factored_apply(lyco, node, x, w, b, mult)
                if out is not None:
                    return out
                # one op with W + dW, in the layer's own output layout
                w_m, b_m = _merged(lyco, w, b, mult, x.dtype)
                return node.apply(x, w_m, None if b_m is None else b_m.to(x.dtype))
            out = lyco.forward(
                x, org_weight=w, org_bias=b, multiplier=mult,
                org_forward=lambda z: node.from_native(org_forward(z, *args, **kwargs)),
                train=train, seed=fold_in(self._drop_seed, lora_name) if train else None,
                shard=self._batch_shard,
            )
            return node.to_native(out)

        return forward

    def apply_to(self, merged_forward: bool | None = None):
        """Put each adapter's forward in place of its layer's ``forward``."""
        if merged_forward is not None:
            self.merged_forward = merged_forward
        for lora_name in self.lora_map:
            if lora_name in self._patched:
                continue
            mod = self.node_map[lora_name].module
            self._patched[lora_name] = mod.__dict__.get("forward")
            mod.forward = self._adapted_forward(lora_name)
        return self

    def restore(self):
        """Give every patched layer its own forward back."""
        for lora_name, prev in self._patched.items():
            mod = self.node_map[lora_name].module
            del mod.forward
            if prev is not None:
                mod.forward = prev
        self._patched = {}
        return self

    @contextlib.contextmanager
    def premerged(self, multiplier=1.0):
        """Inside the block every mergeable, non-bypass adapted layer holds
        its merged weight (``get_merged_weight``: W + dW, or DoRA's rescale
        of it), cast to its weight's dtype and formed with autograd from the
        adapter tensors, in place of its own; the model runs as a plain
        model on them (the JAX trainer's premerge, ``traced_merge``,
        wrapper.py:765-799). Keep the backward inside the block too: the
        recompute of a checkpointed block reads the layers' weights again.
        The network must not be applied at the same time."""
        if self._patched:
            raise RuntimeError("premerged on an applied network: call restore() first")
        swapped = []
        try:
            for lora_name, lyco in self.lora_map.items():
                node = self.node_map[lora_name]
                if lyco.not_supported or lyco.bypass_mode or node.is_quant:
                    continue
                w, b = node.weights()
                w_m, b_m = _merged(lyco, w, b, multiplier, w.dtype)
                merged = {"weight": w_m}
                if b_m is not None and b_m is not b:
                    merged["bias"] = b_m.to(b.dtype)
                # in place in the module's parameter dict, as torch.func's
                # functional_call swaps them, so that their order stays
                for name, t in merged.items():
                    swapped.append((node.module, name, node.module._parameters[name]))
                    node.module._parameters[name] = t
            yield self
        finally:
            for mod, name, param in reversed(swapped):
                mod._parameters[name] = param

    @torch.no_grad()
    def merge_to(self, weight=1.0):
        """Fold every adapter into its layer's weight, in place (reference
        ``merge_to``); a quantized layer keeps its weight (JAX wrapper.py:786).
        The network must not be applied at the same time."""
        if self._patched:
            raise RuntimeError("merge_to on an applied network: call restore() first")
        for lora_name, lyco in self.lora_map.items():
            node = self.node_map[lora_name]
            if lyco.not_supported or node.is_quant:
                continue
            w, b = node.weights()
            w_m, b_m = _merged(lyco, w, b, weight, w.dtype)
            # a leaf sharded over a model axis takes this rank's slice
            node.write("weight", w_m)
            if b is not None and b_m is not None:
                node.write("bias", b_m.to(b.dtype))
        return self

    def onfly_merge(self, weight=1.0):
        """:meth:`merge_to` that keeps a copy of every adapted layer's
        weight and bias for :meth:`onfly_restore` (JAX wrapper.py:813-823)."""
        if self._patched:
            raise RuntimeError("onfly_merge on an applied network: call restore() first")
        self._onfly_saved = [
            (t, t.detach().clone())
            for n in (self.node_map[ln] for ln in self.lora_map) if not n.is_quant
            for t in n.stored() if t is not None]
        return self.merge_to(weight)

    @torch.no_grad()
    def onfly_restore(self):
        """Copy back the layers' weights and biases :meth:`onfly_merge` kept."""
        for t, t0 in self._onfly_saved:
            t.copy_(t0)
        del self._onfly_saved
        return self

    @torch.no_grad()
    def apply_max_norm_stacked(self, max_norm):
        """Max-norm over every module that has it, in place: ``(scaled,
        norms)``, one slot a module, fp32 tensors on the adapters' device
        with no host sync (the counterpart of the JAX
        ``apply_max_norm_traced``, wrapper.py:825-848)."""
        flags, norms = [], []
        for lyco in self.loras:
            _, scaled, norm = lyco.apply_max_norm(max_norm)
            if scaled is not None:
                flags.append(scaled)
                norms.append(norm)
        if not flags:
            z = torch.zeros(0, device=_model_device(self.graph))
            return z, z
        return torch.stack(flags).float(), torch.stack(norms).float()

    def apply_max_norm_regularization(self, max_norm):
        """Max-norm over every module, in place: ``(keys_scaled, mean_norm,
        max_norm)`` as host numbers, ``(0, 0, 0)`` if no module was scaled
        (JAX wrapper.py:850-858)."""
        flags, norms = self.apply_max_norm_stacked(max_norm)
        keys_scaled = int(flags.sum())
        if keys_scaled == 0:
            return 0, 0, 0
        return keys_scaled, float(norms.mean()), float(norms.max())

    # -- checkpoint I/O ---------------------------------------------------------
    def state_dict(self, *args, dtype=None, **kwargs) -> dict:
        """Flat ``{lora_name}.{key}`` tensors in the reference key grammar,
        cast to ``dtype`` if given."""
        return {f"{lyco.lora_name}.{k}": v if dtype is None else v.to(dtype)
                for lyco in self.loras for k, v in lyco.custom_state_dict().items()}

    def save_weights(self, file, dtype=None, metadata=None):
        """Write :meth:`state_dict` to ``file``: ``.safetensors`` with
        ``metadata`` (an empty one written as none), any other extension
        through ``torch.save`` of CPU tensors (JAX wrapper.py:905-916)."""
        if metadata is not None and len(metadata) == 0:
            metadata = None
        sd = {k: v.detach().cpu().contiguous() for k, v in self.state_dict(dtype=dtype).items()}
        if os.path.splitext(file)[1] == ".safetensors":
            safetensors_io.save_file(sd, file, metadata)
        else:
            torch.save(sd, file)

    def load_weights(self, file):
        """Load the adapter file ``file`` into this network's modules."""
        return self.load_state_dict(load_file_sd(file), strict=False)

    def load_state_dict(self, sd: dict, strict: bool = False):
        missing, loaded = [], 0
        for lyco in self.loras:
            prefix = f"{lyco.lora_name}."
            local = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            if not local:
                missing.append(lyco.lora_name)
                continue
            lyco.load_state_dict(local)
            loaded += 1
        if strict and missing:
            raise KeyError(f"missing adapters in state dict: {missing}")
        return {"loaded": loaded, "missing": missing}
