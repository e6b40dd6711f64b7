"""LoRA / LoCon adapter module (counterpart of
``lycoris_tpu/modules/locon.py``; reference lycoris/modules/locon.py).

Keys ``lora_up.weight / lora_down.weight / lora_mid.weight / alpha /
dora_scale``, detected by ``lora_up.weight``. Linear and conv1d/2d/3d
layers; a tucker mid core only where a kernel dimension is not 1. dW =
(alpha / r) * up @ down * scalar, with ``rs_lora`` scaling by alpha / sqrt(r)
(the ``alpha`` buffer then stores alpha * r / sqrt(r)) and ``use_scalar``
starting up from kaiming and a trainable scalar from 0. The scalar is
folded into ``lora_up.weight`` in the saved state dict. The bypass path
runs x through the down op with the layer's stride and padding only, as
the JAX package does.

In training, rank dropout masks the out-dim rows of the rebuilt dW, or in
bypass mode the rank of the down output, and plain dropout applies to the
bypass output only (JAX locon.py:186-194, 314-331); module dropout as in
``modules/base.py``. DoRA (``weight_decompose``) and max-norm (through
``scalar``) as in ``modules/base.py``; a DoRA layer takes no factored
backward.
"""

from __future__ import annotations

import math

import torch

from ..functional import locon
from ..functional.general import kaiming_uniform
from ..functional.merged import lora_dtheta
from .base import LayerInfo, LycorisBaseModule, as_float, infer_wd_on_out, to_tensor


class LoConModule(LycorisBaseModule):
    name = "locon"
    support_module = frozenset({"linear", "conv1d", "conv2d", "conv3d"})
    weight_list = ["lora_up.weight", "lora_down.weight", "lora_mid.weight", "alpha", "dora_scale"]
    weight_list_det = ["lora_up.weight"]

    def __init__(self, lora_name, layer: LayerInfo, multiplier=1.0, lora_dim=4, alpha=1,
                 dropout=0.0, rank_dropout=0.0, module_dropout=0.0, use_tucker=False,
                 use_scalar=False, rank_dropout_scale=False, weight_decompose=False,
                 wd_on_out=True, bypass_mode=None, rs_lora=False, generator=None, device=None,
                 dtype=torch.float32, org_weight=None, **kwargs):
        super().__init__(lora_name, layer, multiplier, dropout, rank_dropout, module_dropout,
                         rank_dropout_scale, bypass_mode)
        if self.not_supported:
            raise ValueError(f"{self.module_type} is not supported in LoRA/LoCon algo.")
        self.lora_dim = lora_dim
        self.tucker = False
        self.rs_lora = rs_lora
        self.use_scalar = use_scalar

        out_dim, in_dim, *k_size = self.shape
        ones = tuple(1 for _ in k_size)
        if self.layer.is_conv:
            if use_tucker and any(k != 1 for k in k_size):
                self.tucker = True
                down_shape = (lora_dim, in_dim, *ones)
            else:
                down_shape = (lora_dim, in_dim, *k_size)
            up_shape = (out_dim, lora_dim, *ones)
        else:
            down_shape, up_shape = (lora_dim, in_dim), (out_dim, lora_dim)

        kw = dict(dtype=dtype, generator=generator, device=device)
        self.trainable |= {"lora_down.weight", "lora_up.weight"}
        self._set("lora_down.weight", kaiming_uniform(down_shape, **kw))
        self._set("lora_up.weight", kaiming_uniform(up_shape, **kw) if use_scalar
                  else torch.zeros(up_shape, dtype=dtype, device=device))
        if self.tucker:
            self.trainable.add("lora_mid.weight")
            self._set("lora_mid.weight", kaiming_uniform((lora_dim, lora_dim, *k_size), **kw))
        self._init_dora(weight_decompose, wd_on_out, org_weight, device)

        alpha = as_float(alpha)
        alpha = lora_dim if alpha == 0.0 else alpha
        r_factor = math.sqrt(lora_dim) if rs_lora else lora_dim
        self.scale = alpha / r_factor
        self._set("alpha", torch.tensor(alpha * (lora_dim / r_factor), dtype=torch.float32,
                                        device=device), trainable=False)
        if use_scalar:
            self.trainable.add("scalar")
        self._set("scalar", torch.tensor(0.0 if use_scalar else 1.0, dtype=dtype, device=device))

    @classmethod
    def make_module_from_state_dict(cls, lora_name, layer, up, down, mid, alpha, dora_scale):
        """The module for saved tensors (reference locon.py:144-168): rank from
        ``down``, tucker from ``mid``, DoRA's side from ``dora_scale``'s
        shape, shapes re-inferred from the layer."""
        module = cls(lora_name, layer, 1, down.shape[0], alpha, use_tucker=mid is not None,
                     weight_decompose=dora_scale is not None,
                     wd_on_out=infer_wd_on_out(dora_scale, layer.shape[0]))
        for key, val in (("lora_up.weight", up), ("lora_down.weight", down),
                         ("lora_mid.weight", mid), ("dora_scale", dora_scale)):
            if val is not None and module._p(key) is not None:
                v = to_tensor(val)
                module._set(key, v.reshape(module._p(key).shape).clone())
        return module

    # -- weight reconstruction ------------------------------------------------
    def get_weight(self, train=False, seed=None):
        """(alpha / r) * up @ down (or the tucker rebuild) in the layer's
        shape, without the scalar (``functional.locon.diff_weight``); its
        rows rank-dropped in training."""
        weight = locon.diff_weight(self._p("lora_down.weight"), self._p("lora_up.weight"),
                                   self._p("lora_mid.weight") if self.tucker else None,
                                   gamma=self.scale).reshape(self.shape)
        return self._rank_masked(weight, train, seed)

    def custom_state_dict(self):
        src = self.params
        dest = {
            "alpha": src["alpha"],
            "lora_up.weight": src["lora_up.weight"] * src["scalar"],
            "lora_down.weight": src["lora_down.weight"],
        }
        if self.tucker:
            dest["lora_mid.weight"] = src["lora_mid.weight"]
        if self.wd:
            dest["dora_scale"] = src["dora_scale"]
        return {k: v.detach() for k, v in dest.items()}

    def apply_max_norm(self, max_norm):
        """Max-norm through ``scalar`` (JAX locon.py:223-231)."""
        return self._max_norm_on_scalar(max_norm)

    def factored_merged_fns(self, multiplier):
        """(recon_fn, dtheta_fn) for the dense-dW-free merged backward
        (functional/merged.py), or None where this configuration needs plain
        autograd (convolutions, tucker, DoRA, rank dropout). The fused one-kernel
        product (``ops/lora_fused.py``) is not dispatched here, as in the JAX
        package: the merged path stays the default."""
        if self.layer.is_conv or self.tucker or self.wd or self.rank_dropout:
            return None
        c = self.scale * multiplier
        want_scalar = "scalar" in self.trainable

        def recon_fn(theta, out_dtype=None):
            # scale * scalar folded into the (out, r) up factor: an r-column
            # multiply instead of a full (out, in) pass
            w = (theta["lora_up.weight"] * (theta["scalar"] * c)) @ theta["lora_down.weight"]
            return w if out_dtype is None else w.to(out_dtype)

        def dtheta_fn(x2d, dy2d, theta):
            d_up, d_down, d_s = lora_dtheta(x2d, dy2d, theta["lora_up.weight"],
                                            theta["lora_down.weight"], want_scalar)
            cc = c * theta["scalar"]
            grads = {"lora_up.weight": d_up * cc, "lora_down.weight": d_down * cc}
            if want_scalar:
                grads["scalar"] = d_s * c
            return grads

        return recon_fn, dtheta_fn

    # -- forward paths ----------------------------------------------------------
    def bypass_forward_diff(self, x, scale=1.0, train=False, seed=None, shard=(0, 1)):
        """up(down(x)) * scalar * (alpha / r) * scale in x's dtype, never
        forming dW (``functional.locon.bypass_forward_diff``); the down op,
        or the mid core under tucker, carries the layer's stride and padding
        only. In training the rank of the down output is masked and the
        output goes through dropout."""
        kw = self.layer.kw if self.layer.is_conv else {}
        extra = {k: kw[k] for k in ("stride", "padding") if k in kw}
        mid = self._p("lora_mid.weight").to(x.dtype) if self.tucker else None
        rank_mask = None
        if self._draws(train, seed, self.rank_dropout):
            rank_mask = self._rank_mask(self.lora_dim, x.dtype, x.device, seed)
        out = locon.bypass_forward_diff(
            x, None, self._p("lora_down.weight").to(x.dtype),
            self._p("lora_up.weight").to(x.dtype), mid,
            gamma=self._p("scalar") * self.scale * scale, extra_args=extra, rank_mask=rank_mask)
        return self._dropped(out.to(x.dtype), train, seed, shard)
