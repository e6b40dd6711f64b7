"""DyLoRA adapter module (counterpart of ``lycoris_tpu/modules/dylora.py``;
reference lycoris/modules/dylora.py).

A LoRA of rank ``lora_dim`` in ``block_count = lora_dim / block_size``
blocks. A forward with block index b uses blocks 0..b with scale
alpha / (b + 1), and only block b gets gradients (the others enter
detached). Saved as ``lora_up.weight / lora_down.weight / alpha``, so its
files load as LoCon; there are no keys of its own to detect, it cannot be
made from a state dict, and its ``load_state_dict`` is a no-op (reference
dylora.py:81-82).

Which b: the delta and bypass routes draw it per training forward from
the module's seed (JAX salt ``0x64796C6F``; a 0-dim device tensor, no host
sync), and use the last block otherwise. The merged route, the one
``DiffusionTrainer`` takes, forms dW without a draw, so there b is always
``block_count - 1`` and only the last block trains, as in the JAX package
(both differ here from the reference, which samples b every step).
No max-norm; module dropout as in ``modules/base.py``.
"""

from __future__ import annotations

import math

import torch

from ..functional.general import convnd, kaiming_uniform, linear
from .base import LayerInfo, LycorisBaseModule, as_float, draw_generator

BLOCK_SALT = 0x64796C6F


class DyLoraModule(LycorisBaseModule):
    name = "dylora"
    support_module = frozenset({"linear", "conv1d", "conv2d", "conv3d"})
    weight_list: list = []  # saved files are detected as LoCon, as in the reference
    weight_list_det: list = []

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, lora_dim=4, alpha=1,
                 dropout=0.0, rank_dropout=0.0, module_dropout=0.0, block_size=4,
                 rank_dropout_scale=False, bypass_mode=None, generator=None, device=None,
                 dtype=torch.float32, **kwargs):
        super().__init__(lora_name, layer, multiplier, dropout, rank_dropout, module_dropout,
                         rank_dropout_scale, bypass_mode)
        if self.not_supported:
            raise ValueError(f"{self.module_type} is not supported in DyLoRA algo.")
        assert lora_dim % block_size == 0, "lora_dim must be a multiple of block_size"
        self.block_count = lora_dim // block_size
        self.block_size = block_size
        self.lora_dim = lora_dim
        out_dim, in_flat = self.shape[0], math.prod(self.shape[1:])
        self.trainable |= {"lora_down.weight", "lora_up.weight"}
        self._set("lora_down.weight", kaiming_uniform((lora_dim, in_flat), dtype=dtype,
                                                      generator=generator, device=device))
        self._set("lora_up.weight", torch.zeros((out_dim, lora_dim), dtype=dtype, device=device))
        alpha = as_float(alpha)
        alpha = lora_dim if alpha == 0.0 else alpha
        self._set("alpha", torch.tensor(alpha, dtype=torch.float32, device=device),
                  trainable=False)

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, *weights):
        """None: DyLoRA files load as LoCon (reference behaviour)."""
        return None

    def custom_state_dict(self):
        src = self.params
        return {
            "alpha": src["alpha"].detach(),
            "lora_up.weight": src["lora_up.weight"].detach(),
            "lora_down.weight": src["lora_down.weight"].detach().reshape(
                self.lora_dim, -1, *self.shape[2:]),
        }

    def load_state_dict(self, sd: dict, strict: bool = False):
        """A no-op, as the reference's (dylora.py:81-82)."""

    def _block(self, train, seed, device):
        """b: drawn in training (a 0-dim tensor), else the last block."""
        if train and seed is not None:
            gen = draw_generator(seed, BLOCK_SALT, device)
            return torch.randint(0, self.block_count, (), generator=gen, device=device)
        return self.block_count - 1

    def get_weight(self, b=None):
        """(down, up, gamma) of block index ``b`` (the last if None): blocks
        past b zeroed, blocks before it detached, gamma = alpha / (b + 1)."""
        if b is None:
            b = self.block_count - 1
        down, up = self._p("lora_down.weight"), self._p("lora_up.weight")
        blk = torch.arange(self.lora_dim, device=down.device) // self.block_size
        grad_blk = (blk == b).to(down.dtype)
        frozen_blk = (blk <= b).to(down.dtype) - grad_blk
        down = down * grad_blk[:, None] + down.detach() * frozen_blk[:, None]
        up = up * grad_blk[None, :] + up.detach() * frozen_blk[None, :]
        return down, up, self._p("alpha") / (b + 1)

    def get_diff_weight(self, multiplier=1.0, train=False, seed=None, rank=None):
        if rank is not None:
            b = math.ceil(rank / self.block_size)
        else:
            b = self._block(train, seed, self._p("alpha").device)
        down, up, gamma = self.get_weight(b)
        return (up @ (down * (gamma * multiplier))).reshape(self.shape), None

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0):
        dw, _ = self.get_diff_weight(multiplier)
        return org_weight + dw.reshape(org_weight.shape), org_bias

    def bypass_forward_diff(self, x, scale=1.0, train=False, seed=None):
        down, up, gamma = self.get_weight(self._block(train, seed, x.device))
        down = down.reshape(self.lora_dim, -1, *self.shape[2:]).to(x.dtype)
        up = up.reshape(-1, self.lora_dim, *[1] * (len(self.shape) - 2)).to(x.dtype)
        if self.layer.is_conv:
            kw = self.layer.kw
            mid = convnd(x, down, stride=kw.get("stride", 1), padding=kw.get("padding", 0))
            out = convnd(mid, up)
        else:
            out = linear(linear(x, down), up)
        return out * (gamma * scale)

    def forward(self, x, org_weight=None, org_bias=None, multiplier=None, org_forward=None,
                train=False, seed=None, shard=(0, 1)):
        multiplier = self.multiplier if multiplier is None else multiplier
        if org_forward is None:
            org_forward = lambda z: self.op(z, org_weight, org_bias)  # noqa: E731
        base = org_forward(x)
        if self.bypass_mode:
            full = base + self.bypass_forward_diff(x, multiplier, train, seed)
        else:
            dw = self.get_diff_weight(multiplier, train, seed)[0]
            full = base + self.op(x, dw.to(x.dtype))
        return self._module_dropout_mix(seed, train, base, full)
