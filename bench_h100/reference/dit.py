"""Plain fp32 Flux-style DiT, as the port's ``models/dit.py`` computes it:
AdaLN-modulated double-stream blocks with one joint attention (text tokens
first), then single-stream blocks over the joined sequence; bias-free
LayerNorms (eps 1e-5), a per-head RMSNorm on q and k (eps 1e-6), the tanh
GELU, no rotary positions.

Sizes are the port's DiT config keys: ``hidden_size``, ``num_heads``,
``mlp_ratio``, ``depth_double``, ``depth_single``, ``in_channels``,
``context_dim``, ``qk_norm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Ops, WeightStore, gelu_tanh, timestep_embedding


def dit_spec(sizes: dict) -> list:
    """[(name, shape, kind, fan_in, block)] as :func:`.unet.unet_spec`."""
    d = sizes["hidden_size"]
    mlp = int(d * sizes["mlp_ratio"])
    hd = d // sizes["num_heads"]
    out = []

    def linear(name, i, o, block=""):
        out.append((f"{name}.weight", (o, i), "w", i, block))
        out.append((f"{name}.bias", (o,), "b", i, block))

    def norm(name, c, block):
        out.append((f"{name}.weight", (c,), "nw", c, block))

    linear("img_in", sizes["in_channels"], d)
    linear("txt_in", sizes["context_dim"], d)
    linear("time_in_1", 256, d)
    linear("time_in_2", d, d)
    for i in range(sizes["depth_double"]):
        p, blk = f"double_blocks_{i}", "DoubleStreamBlock"
        for s in ("img", "txt"):
            linear(f"{p}.{s}_mod.lin", d, 6 * d, blk)
            norm(f"{p}.{s}_norm1", d, blk)
            linear(f"{p}.{s}_attn.qkv", d, 3 * d, blk)
            if sizes.get("qk_norm", True):
                norm(f"{p}.{s}_attn.norm.query_norm", hd, blk)
                norm(f"{p}.{s}_attn.norm.key_norm", hd, blk)
            linear(f"{p}.{s}_attn_proj", d, d, blk)
            norm(f"{p}.{s}_norm2", d, blk)
            linear(f"{p}.{s}_mlp_0", d, mlp, blk)
            linear(f"{p}.{s}_mlp_2", mlp, d, blk)
    for i in range(sizes["depth_single"]):
        p, blk = f"single_blocks_{i}", "SingleStreamBlock"
        linear(f"{p}.modulation.lin", d, 3 * d, blk)
        norm(f"{p}.pre_norm", d, blk)
        linear(f"{p}.linear1", d, 3 * d + mlp, blk)
        if sizes.get("qk_norm", True):
            norm(f"{p}.norm.query_norm", hd, blk)
            norm(f"{p}.norm.key_norm", hd, blk)
        linear(f"{p}.linear2", d + mlp, d, blk)
    linear("final_mod.lin", d, 3 * d)
    norm("final_norm", d, "")
    linear("final_proj", d, sizes["in_channels"])
    return out


class _DiT:
    def __init__(self, sizes, store: WeightStore, ops: Ops):
        self.s, self.ws, self.o = sizes, store, ops
        self.nh = sizes["num_heads"]
        self.qk = sizes.get("qk_norm", True)

    def lin(self, name, x):
        return self.o.linear(x, self.ws.w(name), self.ws.b(name))

    def ln(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.ws.base[f"{name}.weight"].float(), None, 1e-5)

    def rms(self, name, x):
        w = self.ws.base[f"{name}.weight"].float()
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6) * w

    def heads(self, x):
        return x.unflatten(-1, (self.nh, -1)).transpose(1, 2)  # (B, H, T, D)

    def qk_norm(self, name, q, k):
        q, k = self.heads(q), self.heads(k)
        if self.qk:
            q, k = self.rms(f"{name}.query_norm", q), self.rms(f"{name}.key_norm", k)
        return q, k

    def mods(self, name, vec, n):
        return self.lin(name, F.silu(vec))[:, None, :].chunk(n, dim=-1)

    def double(self, p, img, txt, vec):
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.mods(f"{p}.img_mod.lin", vec, 6)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.mods(f"{p}.txt_mod.lin", vec, 6)
        iq, ik, iv = self.lin(f"{p}.img_attn.qkv",
                              self.ln(f"{p}.img_norm1", img) * (1 + i_sc1) + i_sh1).chunk(3, -1)
        tq, tk, tv = self.lin(f"{p}.txt_attn.qkv",
                              self.ln(f"{p}.txt_norm1", txt) * (1 + t_sc1) + t_sh1).chunk(3, -1)
        iq, ik = self.qk_norm(f"{p}.img_attn.norm", iq, ik)
        tq, tk = self.qk_norm(f"{p}.txt_attn.norm", tq, tk)
        o = self.o.attention(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2),
                             torch.cat([self.heads(tv), self.heads(iv)], 2))
        o = o.transpose(1, 2).flatten(-2)
        n = txt.shape[1]
        img = img + i_g1 * self.lin(f"{p}.img_attn_proj", o[:, n:])
        txt = txt + t_g1 * self.lin(f"{p}.txt_attn_proj", o[:, :n])
        ih = gelu_tanh(self.lin(f"{p}.img_mlp_0", self.ln(f"{p}.img_norm2", img) * (1 + i_sc2) + i_sh2))
        img = img + i_g2 * self.lin(f"{p}.img_mlp_2", ih)
        th = gelu_tanh(self.lin(f"{p}.txt_mlp_0", self.ln(f"{p}.txt_norm2", txt) * (1 + t_sc2) + t_sh2))
        txt = txt + t_g2 * self.lin(f"{p}.txt_mlp_2", th)
        return img, txt

    def single(self, p, x, vec):
        d = self.s["hidden_size"]
        mlp = int(d * self.s["mlp_ratio"])
        shift, scale, gate = self.mods(f"{p}.modulation.lin", vec, 3)
        x_n = self.ln(f"{p}.pre_norm", x) * (1 + scale) + shift
        q, k, v, h = self.lin(f"{p}.linear1", x_n).split((d, d, d, mlp), dim=-1)
        q, k = self.qk_norm(f"{p}.norm", q, k)
        attn = self.o.attention(q, k, self.heads(v)).transpose(1, 2).flatten(-2)
        return x + gate * self.lin(f"{p}.linear2", torch.cat([attn, gelu_tanh(h)], dim=-1))

    def __call__(self, img, txt, t):
        s = self.s
        img = self.lin("img_in", img)
        txt = self.lin("txt_in", txt)
        vec = timestep_embedding(t, 256)
        vec = self.lin("time_in_2", F.silu(self.lin("time_in_1", vec)))
        for i in range(s["depth_double"]):
            img, txt = self.double(f"double_blocks_{i}", img, txt, vec)
        x = torch.cat([txt, img], dim=1)
        for i in range(s["depth_single"]):
            x = self.single(f"single_blocks_{i}", x, vec)
        x = x[:, txt.shape[1]:]
        shift, scale, _ = self.mods("final_mod.lin", vec, 3)
        return self.lin("final_proj", self.ln("final_norm", x) * (1 + scale) + shift)


@torch.no_grad()
def dit_forward(sizes, store: WeightStore, img, txt, t, precision="fp32"):
    """The DiT's output (B, N, in_channels) on fp32 inputs."""
    return _DiT(sizes, store, Ops(precision))(img.float(), txt.float(), t)
