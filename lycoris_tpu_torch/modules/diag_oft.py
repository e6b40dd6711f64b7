"""Diag-OFT adapter module (counterpart of ``lycoris_tpu/modules/diag_oft.py``;
reference lycoris/modules/diag_oft.py).

``block_size, block_num = factorization(out_dim, lora_dim)``; zero-init
``oft_blocks`` (num, b, b), a trainable all-ones ``rescale`` with
``rescaled``; the constraint is ``constraint * out_dim``, the raw value kept
in the ``alpha`` buffer. Keys ``oft_blocks, rescale, alpha``, detected by a
3-d ``oft_blocks`` (BOFT's is 4-d). The merged weight rotates the layer's
output blocks by the Cayley R (``functional/diag_oft.py``), the identity at
init; the bypass rotates the base outputs instead (the reference's delta
bypass reads ``out`` before assigning it). In training, rank
dropout drops elements of the scaled R (JAX salt ``0x72616E6B``); module
dropout as in ``modules/base.py``. Max-norm scales ``oft_blocks``.
"""

from __future__ import annotations

import torch

from ..functional import diag_oft
from ..functional.general import factorization
from .base import (LayerInfo, LycorisBaseModule, RANK_SALT, _need_org_forward, as_float,
                   draw_generator, dropout, max_norm_ratio, to_tensor)


class DiagOFTModule(LycorisBaseModule):
    name = "diag-oft"
    support_module = frozenset({"linear", "conv1d", "conv2d", "conv3d"})
    weight_list = ["oft_blocks", "rescale", "alpha"]
    weight_list_det = ["oft_blocks"]
    blocks_ndim = 3  # of a saved ``oft_blocks``: what tells Diag-OFT from BOFT
    algo_title = "Diag-OFT"

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, lora_dim=4, alpha=1,
                 dropout=0.0, rank_dropout=0.0, module_dropout=0.0, rank_dropout_scale=False,
                 constraint=0, rescaled=False, bypass_mode=None, generator=None, device=None,
                 dtype=torch.float32, **kwargs):
        super().__init__(lora_name, layer, multiplier, dropout, rank_dropout, module_dropout,
                         rank_dropout_scale, bypass_mode)
        if self.not_supported:
            raise ValueError(f"{self.module_type} is not supported in {self.algo_title} algo.")
        out_dim = self.shape[0]
        self._init_blocks(out_dim, lora_dim)
        self.rescaled = rescaled
        self.constraint = float(constraint) * out_dim
        self._set("alpha", torch.tensor(float(constraint), dtype=torch.float32, device=device),
                  trainable=False)
        self.trainable.add("oft_blocks")
        self._set("oft_blocks", torch.zeros(self.blocks_shape, dtype=dtype, device=device))
        if rescaled:
            self.trainable.add("rescale")
            self._set("rescale", torch.ones((out_dim, *[1] * (len(self.shape) - 1)),
                                            dtype=dtype, device=device))

    def _init_blocks(self, out_dim, lora_dim):
        self.block_size, self.block_num = factorization(out_dim, lora_dim)
        self.blocks_shape = (self.block_num, self.block_size, self.block_size)

    @classmethod
    def algo_check(cls, state_dict, lora_name) -> bool:
        v = state_dict.get(f"{lora_name}.oft_blocks")
        return v is not None and len(v.shape) == cls.blocks_ndim

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, oft_blocks, rescale, alpha):
        module = cls(lora_name, layer, 1, lora_dim=oft_blocks.shape[-1],
                     constraint=as_float(alpha), rescaled=rescale is not None)
        module._set("oft_blocks", to_tensor(oft_blocks).clone())
        if rescale is not None:
            module._set("rescale", to_tensor(rescale).reshape(module._p("rescale").shape).clone())
        return module

    @property
    def _constraint(self):
        return self.constraint if self.constraint > 0 else None

    def get_r(self):
        blocks = self._p("oft_blocks")
        I = torch.eye(self.block_size, dtype=blocks.dtype, device=blocks.device)
        return diag_oft.get_r(blocks, I, self._constraint)

    def make_weight(self, org_weight, scale=1.0, train=False, seed=None):
        """The rotated weight, R blended toward I by ``scale``, in
        ``org_weight``'s dtype."""
        r = self.get_r()
        I = torch.eye(self.block_size, dtype=r.dtype, device=r.device)
        shape = org_weight.shape[1:]
        org = org_weight.to(r.dtype).reshape(self.block_num, self.block_size, -1)
        rs = r * scale
        if self._draws(train, seed, self.rank_dropout):
            rs = dropout(draw_generator(seed, RANK_SALT, rs.device), rs, self.rank_dropout)
        rot = rs - scale * I + I
        # rot^T per block as one batched matmul: the result has the layer's
        # own strides (an einsum's may read as channels-last to cuDNN)
        weight = (rot.transpose(1, 2) @ org).reshape(-1, *shape)
        if self.rescaled:
            weight = self._p("rescale") * weight
        return weight.to(org_weight.dtype)

    def get_merged_weight(self, org_weight, org_bias=None, multiplier=1.0):
        return self.make_weight(org_weight, scale=multiplier), org_bias

    def custom_state_dict(self):
        src = self.params
        dest = {"oft_blocks": src["oft_blocks"], "alpha": src["alpha"]}
        if self.rescaled:
            dest["rescale"] = src["rescale"]
        return {k: v.detach() for k, v in dest.items()}

    @torch.no_grad()
    def apply_max_norm(self, max_norm):
        """Max-norm on the norm of ``oft_blocks`` (JAX diag_oft.py:141-149)."""
        blocks = self._p("oft_blocks")
        orig = blocks.norm()
        scaled, ratio = max_norm_ratio(orig, max_norm)
        blocks.mul_(torch.where(scaled, ratio, 1.0).to(blocks.dtype))
        return self.params, scaled, orig * ratio

    def _bypass(self, x, scale, org_forward, diff=False):
        """The base output plus its rotation's delta times ``scale`` (with
        ``diff``, the delta alone)."""
        org_out = org_forward(x)
        delta = diag_oft.bypass_forward_diff(
            org_out, self._p("oft_blocks"), self._p("rescale") if self.rescaled else None,
            constraint=self._constraint, need_transpose=self.layer.is_conv)
        # the rotation runs in fp32; the delta joins the base in its dtype
        delta = (delta * scale).to(org_out.dtype)
        return delta if diff else org_out + delta

    def bypass_forward_diff(self, x, scale=1.0, train=False, seed=None, org_forward=None):
        """The rotation's delta of the base output ``org_forward(x)``, times
        ``scale`` (JAX diag_oft.py:175); no draws."""
        return self._bypass(x, scale, _need_org_forward(org_forward), diff=True)

    def forward(self, x, org_weight=None, org_bias=None, multiplier=None, org_forward=None,
                train=False, seed=None):
        multiplier = self.multiplier if multiplier is None else multiplier
        if org_forward is None:
            org_forward = lambda z: self.op(z, org_weight, org_bias)  # noqa: E731
        if self.bypass_mode:
            out = self._bypass(x, multiplier, org_forward)
            return self._module_dropout_mix(seed, train, org_forward(x), out)
        base = org_forward(x)
        new_weight = self.make_weight(org_weight, scale=multiplier, train=train, seed=seed)
        delta = self.op(x, (new_weight - org_weight).to(x.dtype))
        return self._module_dropout_mix(seed, train, base, base + delta)
