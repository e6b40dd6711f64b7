"""Adapter module base (counterpart of ``lycoris_tpu/modules/base.py``).

An adapter is an ``nn.Module`` that owns its tensors under the reference
state-dict keys (``lokr_w1``, ``hada_w1_a``, ...): trainable factors are
``nn.Parameter``s, ``alpha`` and a fixed ``scalar`` are buffers. Its
``forward(x, org_weight, org_bias, org_forward=...)`` returns the adapted
layer's output; the network wrapper puts it in place of the layer's own
forward (``LycorisNetwork.apply_to``), as the reference LyCORIS does.

In training (``train=True`` with a ``seed``) the forward applies the
dropout trio as the JAX modules do: ``rank_dropout`` masks rows of the
rebuilt dW (or LoCon's rank in bypass mode), ``dropout`` drops elements of
the bypass output, ``module_dropout`` returns the base output alone. With
``train`` off the forward is the inference forward.

The parametrize API (JAX modules/base.py:388-416): :meth:`LycorisBaseModule.parametrize`
builds an adapter over a bare weight tensor, and :meth:`~LycorisBaseModule.parametrization`
gives the ``nn.Module`` whose ``forward(W)`` is the adapted weight, for
``torch.nn.utils.parametrize.register_parametrization`` on a plain
``nn.Linear``/``nn.Conv*d`` (reference base.py:199-234).

Random draws. The JAX package folds a PRNG key with a hash of the module's
name and with a per-use salt (``0x72616E6B`` rank, ``0x64726F70``
dropout, ``0x6D6F64`` module). The port does the same with integers: the
module's ``seed`` (the train step's seed folded with its name by the
wrapper) folded with the salt reseeds the tensors' device's
``torch.Generator`` just before each draw (:func:`draw_generator`). A draw
thus depends on the step, the module and the use alone, never on what was
drawn before it, so the recompute of a checkpointed block in the backward
draws the same masks as its forward. The two packages' random streams differ: the tests fix the
masks to compare them.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
from torch import nn

from ..functional import general
from ..functional.general import convnd, in_norm, layer_norm, linear, out_norm, rms_norm


def _hashable_kw(kw: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in kw.items()))


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    """Static description of a wrapped layer: kind, torch weight shape and
    the op's keyword arguments (reference modules/base.py:88-158)."""

    module_type: str  # linear | conv1d | conv2d | conv3d | layernorm | groupnorm | rmsnorm
    shape: tuple  # torch weight shape
    kw_dict: tuple = ()
    has_bias: bool = False
    name: str = ""

    @property
    def kw(self) -> dict:
        return {k: v for k, v in self.kw_dict}

    @property
    def is_conv(self) -> bool:
        return self.module_type.startswith("conv")

    @property
    def is_norm(self) -> bool:
        return self.module_type in ("layernorm", "groupnorm", "rmsnorm")

    @staticmethod
    def linear(out_features: int, in_features: int, bias: bool = True, name: str = "") -> "LayerInfo":
        return LayerInfo("linear", (out_features, in_features), (), bias, name)

    @staticmethod
    def conv(nd: int, out_channels: int, in_channels: int, kernel_size, stride=1, padding=0,
             dilation=1, groups: int = 1, bias: bool = True, name: str = "") -> "LayerInfo":
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
        kw = _hashable_kw(dict(stride=stride, padding=padding, dilation=dilation, groups=groups))
        return LayerInfo(f"conv{nd}d", (out_channels, in_channels // groups, *kernel_size),
                         kw, bias, name)

    @staticmethod
    def layer_norm(normalized_shape, eps: float = 1e-5, bias: bool = True, name: str = "") -> "LayerInfo":
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        kw = _hashable_kw(dict(normalized_shape=tuple(normalized_shape), eps=eps))
        return LayerInfo("layernorm", tuple(normalized_shape), kw, bias, name)

    @staticmethod
    def rms_norm(normalized_shape, eps: float = 1e-6, bias: bool = False,
                 name: str = "") -> "LayerInfo":
        """torch ``nn.RMSNorm`` and the duck-typed modules with a ``weight``
        and a stats-only ``_norm`` (JAX modules/base.py:106-113)."""
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        kw = _hashable_kw(dict(normalized_shape=tuple(normalized_shape), eps=eps))
        return LayerInfo("rmsnorm", tuple(normalized_shape), kw, bias, name)

    @staticmethod
    def group_norm(num_groups: int, num_channels: int, eps: float = 1e-5, bias: bool = True,
                   name: str = "", act: str | None = None) -> "LayerInfo":
        """``act``: an activation folded into the layer (``models/layers.py``
        GroupNorm(act=...)), applied after the norm unless ``op`` is asked
        for the act-less output."""
        kw = dict(num_groups=num_groups, eps=eps)
        if act is not None:
            kw["act"] = act
        return LayerInfo("groupnorm", (num_channels,), _hashable_kw(kw), bias, name)

    @property
    def act(self) -> str | None:
        """The activation folded into a GroupNorm layer, else None."""
        return self.kw.get("act") if self.module_type == "groupnorm" else None

    def op(self, x, weight, bias=None, with_act: bool = True):
        t = self.module_type
        if t == "linear":
            return linear(x, weight, bias)
        if t.startswith("conv"):
            return convnd(x, weight, bias, **self.kw)
        if t == "layernorm":
            kw = self.kw
            return layer_norm(x, kw["normalized_shape"], weight, bias, kw["eps"])
        if t == "rmsnorm":
            # op(x, dw, db) == org_norm(x) * dw + db, the Norm delta
            kw = self.kw
            return rms_norm(x, kw["normalized_shape"], weight, bias, kw["eps"])
        if t == "groupnorm":
            kw = self.kw
            return general.group_norm_act(
                x, kw["num_groups"], weight, bias, kw["eps"],
                act=kw.get("act") if with_act else None,
            )
        raise ValueError(f"unsupported module_type {t}")


# per-use salts of the dropout draws (the JAX modules' fold_in constants)
RANK_SALT, DROP_SALT, MODULE_SALT = 0x72616E6B, 0x64726F70, 0x6D6F64


def fold_in(seed: int, data) -> int:
    """A 63-bit seed from ``seed`` and ``data`` (an int or a str), the
    integer counterpart of ``jax.random.fold_in``."""
    digest = hashlib.blake2b(f"{seed}/{data}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


_GENERATORS: dict = {}  # one per device, reseeded for every draw


def draw_generator(seed: int, salt: int, device) -> torch.Generator:
    """The generator of ``device`` seeded from ``seed`` and ``salt`` alone.
    There is one per device, reseeded by each call (no generator is built
    per draw), so it serves the draw it was called for and no later one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = _GENERATORS.get(device)
    if gen is None:
        gen = _GENERATORS[device] = torch.Generator(device=device)
    return gen.manual_seed(fold_in(seed, salt))


def rank_dropout_mask(gen, n: int, p: float, scale: bool, dtype, device):
    """(n,) keep mask, 1 where ``uniform > p``; with ``scale`` divided by its
    mean (at least 1e-6), as reference locon.py:198-219."""
    drop = (torch.rand(n, generator=gen, device=device) > p).to(dtype)
    if scale:
        drop = drop / drop.mean().clamp(min=1e-6)
    return drop


def module_keep(gen, p: float):
    """0-dim 0/1 keep flag of module dropout, 1 where ``uniform >= p``."""
    return (torch.rand((), generator=gen, device=gen.device) >= p).float()


def dropout(gen, x, p: float, shard=(0, 1)):
    """Inverted dropout: ``x / (1 - p)`` where kept (probability 1 - p), else 0.
    ``shard = (i, n)``: ``x`` is rank i's rows of a batch split over n data
    ranks, and its mask is those rows of the mask drawn for the whole batch,
    so the ranks together drop as one process would."""
    (i, n), b = shard, x.shape[0]
    draw = torch.rand((n * b, *x.shape[1:]), generator=gen, device=x.device)
    keep = draw[i * b:(i + 1) * b] < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def apply_weight_decompose(weight, dora_scale, wd_on_out: bool, multiplier=1.0):
    """DoRA's norm rescale of ``weight`` (W + dW) with the multiplier
    interpolating between ``weight`` and the rescaled one (JAX
    modules/base.py:181-205). The eps is that of ``dora_scale``'s dtype, the
    dtype ``weight`` is cast to first."""
    weight = weight.to(dora_scale.dtype)
    eps = torch.finfo(weight.dtype).eps
    scale = dora_scale / ((out_norm(weight) if wd_on_out else in_norm(weight)) + eps)
    return weight * (multiplier * (scale - 1) + 1)


def infer_wd_on_out(dora_scale, out_dim: int) -> bool:
    """``wd_on_out`` from a saved ``dora_scale``'s shape: (O, 1, ...) on the
    output, (1, I, ...) on the input (JAX modules/base.py:208-216)."""
    shape = tuple(getattr(dora_scale, "shape", ()))
    if len(shape) == 0:
        return True
    return shape[0] != 1 or out_dim == 1


def init_dora_scale(org_weight, wd_on_out: bool):
    """The row (``wd_on_out``) or column norms of the layer's weight, fp32
    (JAX modules/base.py:219-234)."""
    w = org_weight.detach().float()
    return out_norm(w) if wd_on_out else in_norm(w)


def max_norm_ratio(orig_norm, max_norm: float):
    """(scaled, ratio) of max-norm for a dW of norm ``orig_norm``: the
    norm clipped below at half the limit, then ``ratio`` = min(norm, limit)
    / norm, ``scaled`` where that is not 1 (JAX locon.py:223-231)."""
    norm = orig_norm.clamp(min=max_norm / 2)
    desired = norm.clamp(max=max_norm)
    return norm != desired, desired / norm


def _need_org_forward(org_forward):
    """The base forward a bypass delta of the layer's output needs (OFT,
    (IA)^3, GLoRA): those modules cannot form it from x alone."""
    if org_forward is None:
        raise ValueError("bypass_forward_diff of this module needs org_forward, the layer's "
                         "own forward")
    return org_forward


def as_float(alpha) -> float:
    if alpha is None:
        return 0.0
    if isinstance(alpha, torch.Tensor):
        return float(alpha.detach().float().reshape(-1)[0].cpu())
    if isinstance(alpha, np.ndarray) or hasattr(alpha, "__array__"):
        return float(np.asarray(alpha).reshape(-1)[0])
    return float(alpha)


def to_tensor(v) -> torch.Tensor:
    """A state-dict value (numpy array, torch tensor or array-like) as a tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.as_tensor(np.asarray(v))


class LycorisBaseModule(nn.Module):
    """Base adapter: static layer info plus the adapter's tensors."""

    name: str = "base"
    support_module: frozenset = frozenset()
    weight_list: list = []
    weight_list_det: list = []

    def __init__(self, lora_name: str, layer: LayerInfo, multiplier: float = 1.0,
                 dropout: float = 0.0, rank_dropout: float = 0.0, module_dropout: float = 0.0,
                 rank_dropout_scale: bool = False, bypass_mode: bool | None = None, **kwargs):
        super().__init__()
        self.lora_name = lora_name
        self.layer = layer
        self.multiplier = multiplier
        self.dropout = dropout
        self.rank_dropout = rank_dropout
        self.rank_dropout_scale = rank_dropout_scale
        self.module_dropout = module_dropout
        self.bypass_mode = bool(bypass_mode)
        self.not_supported = layer.module_type not in self.support_module
        self.trainable: set[str] = set()
        self.wd = False
        self.wd_on_out = True

    def _init_dora(self, weight_decompose, wd_on_out, org_weight, device):
        """DoRA's ``dora_scale``, trainable, from the layer's weight (zeros
        without one, as the JAX modules)."""
        self.wd, self.wd_on_out = bool(weight_decompose), bool(wd_on_out)
        if not self.wd:
            return
        if org_weight is None:
            org_weight = torch.zeros(self.shape)
        self.trainable.add("dora_scale")
        self._set("dora_scale", init_dora_scale(org_weight, self.wd_on_out).to(device))

    # -- tensors under their reference keys ----------------------------------
    def _owner(self, key: str, create: bool = False):
        """(module, name) that holds ``key``: a dotted key (``lora_up.weight``)
        lives on a child module named by its prefix, as in the reference, so
        ``named_parameters()`` gives the state-dict key."""
        if "." not in key:
            return self, key
        child, name = key.split(".", 1)
        mod = self._modules.get(child)
        if mod is None and create:
            mod = nn.Module()
            self.add_module(child, mod)
        return mod, name

    def _set(self, key: str, value: torch.Tensor, trainable: bool | None = None):
        """Register ``value`` under ``key``: a Parameter if trainable, else a buffer."""
        mod, name = self._owner(key, create=True)
        if name in mod._parameters:
            del mod._parameters[name]
        if name in mod._buffers:
            del mod._buffers[name]
        if trainable is None:
            trainable = key in self.trainable
        if trainable:
            mod.register_parameter(name, nn.Parameter(value, requires_grad=True))
        else:
            mod.register_buffer(name, value)

    def _p(self, key):
        mod, name = self._owner(key)
        if mod is None:
            return None
        if name in mod._parameters:
            return mod._parameters[name]
        return mod._buffers.get(name)

    @property
    def params(self) -> dict:
        """Every tensor of the adapter by key (parameters and buffers)."""
        return {**dict(self.named_buffers()), **dict(self.named_parameters())}

    @property
    def module_type(self) -> str:
        return self.layer.module_type

    @property
    def shape(self) -> tuple:
        return self.layer.shape

    def op(self, x, weight, bias=None):
        return self.layer.op(x, weight, bias)

    # -- checkpoint API -------------------------------------------------------
    @classmethod
    def algo_check(cls, state_dict, lora_name) -> bool:
        """First-match detection by key presence (reference base.py:236-238)."""
        return any(f"{lora_name}.{k}" in state_dict for k in cls.weight_list_det)

    @classmethod
    def extract_state_dict(cls, state_dict, lora_name) -> list:
        return [state_dict.get(f"{lora_name}.{k}", None) for k in cls.weight_list]

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer: LayerInfo, *weights):
        raise NotImplementedError

    def custom_state_dict(self) -> dict:
        raise NotImplementedError

    def state_dict(self, *args, **kwargs) -> dict:
        """The reference's saved form (``scalar`` folded in), keys unprefixed."""
        return self.custom_state_dict()

    def load_state_dict(self, sd: dict, strict: bool = False):
        """Copy values from a flat unprefixed state dict; reset ``scalar`` to 1
        like the reference load hook (locon.py:184-196)."""
        with torch.no_grad():
            for k, v in sd.items():
                cur = self._p(k)
                if cur is None:
                    continue
                cur.copy_(to_tensor(v).reshape(cur.shape).to(cur.dtype))
            scalar = self._p("scalar")
            if scalar is not None:
                scalar.fill_(1.0)

    # -- compute API ------------------------------------------------------------
    def get_weight(self, train=False, seed=None):
        raise NotImplementedError

    def get_diff_weight(self, multiplier=1.0):
        return self.get_weight() * self._p("scalar") * multiplier, None

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0):
        """W + dW * multiplier, or under DoRA the rescale of W + dW."""
        diff = self.get_diff_weight(1.0)[0].reshape(org_weight.shape)
        if self.wd:
            return apply_weight_decompose(org_weight + diff, self._p("dora_scale"),
                                          self.wd_on_out, multiplier), org_bias
        return org_weight + diff * multiplier, org_bias

    def apply_max_norm(self, max_norm):
        """Scale this module's tensors in place so that the norm of its dW is
        at most ``max_norm``; ``(params, scaled, norm after scaling)`` with
        0-dim device tensors, or ``(params, None, None)`` for a module
        without max-norm (JAX modules/base.py:350-353)."""
        return self.params, None, None

    @torch.no_grad()
    def _max_norm_on_scalar(self, max_norm):
        """Max-norm through ``scalar``: the norm of dW = get_weight * scalar
        (LoCon, LoHa)."""
        scalar = self._p("scalar")
        orig = (self.get_weight() * scalar).norm()
        scaled, ratio = max_norm_ratio(orig, max_norm)
        scalar.mul_(torch.where(scaled, ratio, 1.0).to(scalar.dtype))
        return self.params, scaled, orig * ratio

    def bypass_forward_diff(self, x, scale=1.0, train=False, seed=None, org_forward=None,
                            shard=(0, 1)):
        """The adapter's delta of the layer's output for ``x`` times
        ``scale``, never forming dW where the algorithm allows; the modules
        whose delta is a function of the base output take ``org_forward``.
        ``shard = (i, n)``: ``x`` is data rank i's rows of a batch split over
        n ranks (plain dropout's mask is those rows of the whole batch's)."""
        raise NotImplementedError

    def _draws(self, train, seed, p) -> bool:
        """Whether a training forward draws for a dropout of rate ``p``."""
        return bool(train and p and seed is not None)

    def _rank_mask(self, n: int, dtype, device, seed):
        """The (n,) rank-dropout mask of this module's training forward."""
        return rank_dropout_mask(draw_generator(seed, RANK_SALT, device), n, self.rank_dropout,
                                 self.rank_dropout_scale, dtype, device)

    def _rank_masked(self, weight, train, seed):
        """``weight`` with its dim-0 rows masked by rank dropout in training."""
        if not self._draws(train, seed, self.rank_dropout):
            return weight
        drop = self._rank_mask(weight.shape[0], weight.dtype, weight.device, seed)
        return weight * drop.reshape(-1, *[1] * (weight.ndim - 1))

    def _dropped(self, out, train, seed, shard=(0, 1)):
        """``out`` through plain dropout in training (``shard`` as in
        :meth:`bypass_forward_diff`)."""
        if not self._draws(train, seed, self.dropout):
            return out
        return dropout(draw_generator(seed, DROP_SALT, out.device), out, self.dropout, shard)

    def _module_dropout_mix(self, seed, train, base, full):
        """Module dropout: ``base`` alone with probability p, else ``full``
        (``base + (full - base) * keep``, JAX base.py:366-371)."""
        if not self._draws(train, seed, self.module_dropout):
            return full
        keep = module_keep(draw_generator(seed, MODULE_SALT, base.device), self.module_dropout)
        return base + (full - base) * keep.to(base.dtype)

    def forward(self, x, org_weight=None, org_bias=None, multiplier=None, org_forward=None,
                train=False, seed=None, shard=(0, 1)):
        """Delta over base: ``org_forward(x) + op(x, dW)`` (or the bypass
        path); in training (``train`` and an int ``seed``) with the dropout
        trio applied (``shard`` as in :meth:`bypass_forward_diff`)."""
        multiplier = self.multiplier if multiplier is None else multiplier
        if org_forward is None:
            org_forward = lambda z: self.op(z, org_weight, org_bias)  # noqa: E731
        base = org_forward(x)
        if self.bypass_mode:
            full = base + self.bypass_forward_diff(x, scale=multiplier, train=train, seed=seed,
                                                   shard=shard)
        else:
            diff = self.get_weight(train, seed).to(org_weight.dtype) * self._p("scalar")
            if self.wd:
                new_weight = apply_weight_decompose(org_weight + diff, self._p("dora_scale"),
                                                    self.wd_on_out, multiplier)
            else:
                new_weight = org_weight + diff * multiplier
            full = base + self.op(x, (new_weight - org_weight).to(x.dtype))
        return self._module_dropout_mix(seed, train, base, full)

    # -- parametrize API --------------------------------------------------------
    @classmethod
    def parametrize(cls, org_param, *args, generator=None, **kwargs):
        """An adapter of this class over the bare weight ``org_param`` (2-d:
        linear, 3-5-d: conv), never in bypass mode, on its device unless
        ``device`` is given. Full cannot parametrize (it holds a delta of
        the layer's bias too)."""
        from .full import FullModule

        if cls is FullModule:
            raise RuntimeError("FullModule cannot be used for parametrize.")
        shape = tuple(org_param.shape)
        if len(shape) == 2:
            li = LayerInfo.linear(shape[0], shape[1], bias=False)
        elif len(shape) in (3, 4, 5):
            li = LayerInfo.conv(len(shape) - 2, shape[0], shape[1], shape[2:], bias=False)
        else:
            raise ValueError(f"cannot parametrize a {len(shape)}-d parameter")
        kwargs["bypass_mode"] = False
        kwargs.setdefault("device", org_param.device)
        return cls("", li, *args, generator=generator, org_weight=org_param.detach(), **kwargs)

    def parametrize_forward(self, org_param, multiplier=None):
        """The adapted value of the parameter ``org_param``, in its dtype."""
        multiplier = self.multiplier if multiplier is None else multiplier
        w, _ = self.get_merged_weight(org_param, None, multiplier=multiplier)
        return w.to(org_param.dtype)

    def parametrization(self) -> "LycorisParametrization":
        """The module to register with ``register_parametrization``."""
        return LycorisParametrization(self)


class LycorisParametrization(nn.Module):
    """``forward(W)`` = ``lyco.parametrize_forward(W)``; the adapter is a
    submodule, so its parameters belong to the parametrized layer."""

    def __init__(self, lyco: LycorisBaseModule):
        super().__init__()
        self.lyco = lyco

    def forward(self, weight):
        return self.lyco.parametrize_forward(weight)
