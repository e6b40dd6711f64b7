"""Plain fp32 SD/SDXL UNet (diffusers topology) and its eps-MSE training
step, as the port's ``models/unet.py`` and ``trainer.py`` compute them.

``unet_spec`` lists every parameter under the port's names with its shape
and kind; ``unet_forward`` runs the model on a :class:`WeightStore`;
``TrainReference`` follows the trainer's first steps: the same noise and
timestep draws from a generator of its own, the loss over the batch in
blocks of rows, the adapter gradients, its own AdamW.

Sizes are the port's UNet config keys: ``in_channels``, ``out_channels``,
``block_out_channels``, ``layers_per_block``, ``transformer_depth``,
``mid_transformer_depth``, ``context_dim``, ``head_dim`` (or
``num_heads``), ``norm_groups``, ``addition_embed_dim``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import AdamW, Ops, WeightStore, alphas_cumprod, gelu_tanh, timestep_embedding


def _heads(sizes, ch):
    return ch // sizes["head_dim"] if sizes.get("head_dim") else sizes["num_heads"]


def unet_spec(sizes: dict) -> list:
    """[(name, shape, kind, fan_in, block)] for every parameter: kind "w"/"b"
    for a linear or conv weight/bias, "nw"/"nb" for a norm's; ``block`` is
    the class of the enclosing block (Transformer2DModel, ResnetBlock2D,
    ...) or "" at the top."""
    out = []

    def linear(name, i, o, bias=True, block=""):
        out.append((f"{name}.weight", (o, i), "w", i, block))
        if bias:
            out.append((f"{name}.bias", (o,), "b", i, block))

    def conv(name, i, o, k, block=""):
        out.append((f"{name}.weight", (o, i, k, k), "w", i * k * k, block))
        out.append((f"{name}.bias", (o,), "b", i * k * k, block))

    def norm(name, c, block="", bias=True):
        out.append((f"{name}.weight", (c,), "nw", c, block))
        if bias:
            out.append((f"{name}.bias", (c,), "nb", c, block))

    def resnet(name, c_in, c_out):
        blk = "ResnetBlock2D"
        norm(f"{name}.norm1", c_in, blk)
        conv(f"{name}.conv1", c_in, c_out, 3, blk)
        linear(f"{name}.time_emb_proj", temb, c_out, block=blk)
        norm(f"{name}.norm2", c_out, blk)
        conv(f"{name}.conv2", c_out, c_out, 3, blk)
        if c_in != c_out:
            conv(f"{name}.conv_shortcut", c_in, c_out, 1, blk)

    def transformer(name, c, depth):
        blk = "Transformer2DModel"
        norm(f"{name}.norm", c, blk)
        conv(f"{name}.proj_in", c, c, 1, blk)
        for i in range(depth):
            p = f"{name}.transformer_blocks_{i}"
            norm(f"{p}.norm1", c, blk)
            for a, ctx in (("attn1", c), ("attn2", sizes["context_dim"])):
                linear(f"{p}.{a}.to_q", c, c, False, blk)
                linear(f"{p}.{a}.to_k", ctx, c, False, blk)
                linear(f"{p}.{a}.to_v", ctx, c, False, blk)
                linear(f"{p}.{a}.to_out_0", c, c, True, blk)
                norm(f"{p}.norm{2 if a == 'attn1' else 3}", c, blk)
            linear(f"{p}.ff.net_0_proj", c, 8 * c, block=blk)
            linear(f"{p}.ff.net_2", 4 * c, c, block=blk)
        conv(f"{name}.proj_out", c, c, 1, blk)

    chs = sizes["block_out_channels"]
    ch0 = chs[0]
    temb = sizes.get("time_embed_dim") or 4 * ch0
    linear("time_embedding.linear_1", ch0, temb)
    linear("time_embedding.linear_2", temb, temb)
    if sizes.get("addition_embed_dim"):
        linear("add_embedding.linear_1", sizes["addition_embed_dim"], temb)
        linear("add_embedding.linear_2", temb, temb)
    conv("conv_in", sizes["in_channels"], ch0, 3)
    skips, ch_in = [ch0], ch0
    for bi, ch in enumerate(chs):
        for li in range(sizes["layers_per_block"]):
            resnet(f"down_blocks_{bi}_resnets_{li}", ch_in, ch)
            ch_in = ch
            if sizes["transformer_depth"][bi]:
                transformer(f"down_blocks_{bi}_attentions_{li}", ch, sizes["transformer_depth"][bi])
            skips.append(ch)
        if bi < len(chs) - 1:
            conv(f"down_blocks_{bi}_downsamplers_0.conv", ch, ch, 3, "Downsample2D")
            skips.append(ch)
    resnet("mid_block_resnets_0", ch_in, ch_in)
    if sizes["mid_transformer_depth"]:
        transformer("mid_block_attentions_0", ch_in, sizes["mid_transformer_depth"])
    resnet("mid_block_resnets_1", ch_in, ch_in)
    for bi in reversed(range(len(chs))):
        ui = len(chs) - 1 - bi
        for li in range(sizes["layers_per_block"] + 1):
            resnet(f"up_blocks_{ui}_resnets_{li}", ch_in + skips.pop(), chs[bi])
            ch_in = chs[bi]
            if sizes["transformer_depth"][bi]:
                transformer(f"up_blocks_{ui}_attentions_{li}", ch_in, sizes["transformer_depth"][bi])
        if bi > 0:
            conv(f"up_blocks_{ui}_upsamplers_0.conv", ch_in, ch_in, 3, "Upsample2D")
    norm("conv_norm_out", ch0)
    conv("conv_out", ch0, sizes["out_channels"], 3)
    return out


class _UNet:
    """The forward on a weight store, in one precision; ``remat``: each
    Transformer2DModel is checkpointed when a gradient is recorded."""

    def __init__(self, sizes, store: WeightStore, ops: Ops, remat: bool):
        self.s, self.ws, self.o, self.remat = sizes, store, ops, remat
        self.has = {name.rsplit(".", 1)[0] for name in store.base}

    def lin(self, name, x):
        return self.o.linear(x, self.ws.w(name), self.ws.b(name))

    def conv(self, name, x, stride=1):
        w = self.ws.w(name)
        return self.o.conv(x, w, self.ws.b(name), stride=stride, padding=w.shape[-1] // 2)

    def gn(self, name, x, eps, silu):
        y = F.group_norm(x, self.s["norm_groups"], self.ws.base[f"{name}.weight"].float(),
                         self.ws.b(name), eps)
        return F.silu(y) if silu else y

    def ln(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.ws.base[f"{name}.weight"].float(),
                            self.ws.b(name), 1e-5)

    def resnet(self, name, x, temb):
        h = self.conv(f"{name}.conv1", self.gn(f"{name}.norm1", x, 1e-5, True))
        h = h + self.lin(f"{name}.time_emb_proj", F.silu(temb))[:, :, None, None]
        h = self.conv(f"{name}.conv2", self.gn(f"{name}.norm2", h, 1e-5, True))
        if f"{name}.conv_shortcut" in self.has:
            x = self.conv(f"{name}.conv_shortcut", x)
        return x + h

    def attn(self, name, x, ctx):
        b, t, c = x.shape
        h = _heads(self.s, c)
        split = lambda y: y.unflatten(-1, (h, -1)).transpose(1, 2)  # noqa: E731
        q = split(self.lin(f"{name}.to_q", x))
        k = split(self.lin(f"{name}.to_k", ctx))
        v = split(self.lin(f"{name}.to_v", ctx))
        o = self.o.attention(q, k, v).transpose(1, 2).reshape(b, t, c)
        return self.lin(f"{name}.to_out_0", o)

    def transformer(self, name, x, ctx):
        b, c, hh, ww = x.shape
        res = x
        y = self.conv(f"{name}.proj_in", self.gn(f"{name}.norm", x, 1e-6, False))
        y = y.reshape(b, c, hh * ww).transpose(1, 2)
        i = 0
        while f"{name}.transformer_blocks_{i}.norm1" in self.has:
            p = f"{name}.transformer_blocks_{i}"
            n1 = self.ln(f"{p}.norm1", y)
            y = y + self.attn(f"{p}.attn1", n1, n1)
            y = y + self.attn(f"{p}.attn2", self.ln(f"{p}.norm2", y), ctx)
            hf = self.lin(f"{p}.ff.net_0_proj", self.ln(f"{p}.norm3", y))
            hv, gate = hf.chunk(2, dim=-1)
            y = y + self.lin(f"{p}.ff.net_2", hv * gelu_tanh(gate))
            i += 1
        y = y.transpose(1, 2).reshape(b, c, hh, ww)
        return res + self.conv(f"{name}.proj_out", y)

    def run_transformer(self, name, x, ctx):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self.transformer, name, x, ctx, use_reentrant=False)
        return self.transformer(name, x, ctx)

    def __call__(self, x, t, ctx, added=None):
        s = self.s
        chs = s["block_out_channels"]
        temb = timestep_embedding(t, chs[0])
        temb = self.lin("time_embedding.linear_2", F.silu(self.lin("time_embedding.linear_1", temb)))
        if added is not None and "add_embedding.linear_1" in self.has:
            temb = temb + self.lin("add_embedding.linear_2",
                                   F.silu(self.lin("add_embedding.linear_1", added)))
        h = self.conv("conv_in", x)
        skips = [h]
        for bi in range(len(chs)):
            for li in range(s["layers_per_block"]):
                h = self.resnet(f"down_blocks_{bi}_resnets_{li}", h, temb)
                if s["transformer_depth"][bi]:
                    h = self.run_transformer(f"down_blocks_{bi}_attentions_{li}", h, ctx)
                skips.append(h)
            if bi < len(chs) - 1:
                h = self.conv(f"down_blocks_{bi}_downsamplers_0.conv", h, stride=2)
                skips.append(h)
        h = self.resnet("mid_block_resnets_0", h, temb)
        if s["mid_transformer_depth"]:
            h = self.run_transformer("mid_block_attentions_0", h, ctx)
        h = self.resnet("mid_block_resnets_1", h, temb)
        for ui in range(len(chs)):
            bi = len(chs) - 1 - ui
            for li in range(s["layers_per_block"] + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = self.resnet(f"up_blocks_{ui}_resnets_{li}", h, temb)
                if s["transformer_depth"][bi]:
                    h = self.run_transformer(f"up_blocks_{ui}_attentions_{li}", h, ctx)
            if bi > 0:
                h = self.conv(f"up_blocks_{ui}_upsamplers_0.conv",
                              F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv("conv_out", self.gn("conv_norm_out", h, 1e-5, True))


def unet_forward(sizes, store: WeightStore, x, t, ctx, added=None, precision="fp32",
                 remat=False):
    """eps prediction of the UNet on fp32 inputs."""
    return _UNet(sizes, store, Ops(precision), remat)(x, t, ctx, added)


class TrainReference:
    """The trainer's first steps in plain fp32 (or the fp8 control):
    ``adapters`` {layer: {key: fp32 tensor}} train (dW by ``delta``), the
    base is frozen.
    ``step(batch)`` draws noise then timesteps from ``generator`` as the
    trainer does, forms the loss over the batch in blocks of ``block`` rows
    (their gradients summed), and takes an AdamW step; it returns the loss
    and the gradients by (layer, key)."""

    def __init__(self, sizes, base: dict, adapters: dict, scales: dict, delta, generator,
                 lr: float = 1e-4, precision: str = "fp32", block: int = 4,
                 num_train_timesteps: int = 1000):
        self.sizes, self.gen, self.block = sizes, generator, block
        self.keys = [(layer, k) for layer in sorted(adapters) for k in sorted(adapters[layer])]
        self.leaves = [adapters[layer][k].detach().clone().float().requires_grad_(True)
                       for layer, k in self.keys]
        theta = {}
        for (layer, k), p in zip(self.keys, self.leaves):
            theta.setdefault(layer, {})[k] = p
        self.net = _UNet(sizes, WeightStore(base, theta, scales, delta), Ops(precision), remat=True)
        self.opt = AdamW(self.leaves, lr)
        dev = self.leaves[0].device
        self.alphas = torch.from_numpy(alphas_cumprod(num_train_timesteps)).to(dev)
        self.num_train_timesteps = num_train_timesteps

    def step(self, batch: dict):
        lat = batch["latents"].float()
        b = lat.shape[0]
        dev = lat.device
        noise = torch.randn(lat.shape, generator=self.gen, device=dev, dtype=torch.float32)
        t = torch.randint(0, self.num_train_timesteps, (b,), generator=self.gen, device=dev)
        grads = [torch.zeros_like(p) for p in self.leaves]
        total = 0.0
        n_all = lat.numel()
        for lo in range(0, b, self.block):
            sl = slice(lo, lo + self.block)
            a = self.alphas[t[sl]].reshape(-1, 1, 1, 1)
            noisy = torch.sqrt(a) * lat[sl] + torch.sqrt(1 - a) * noise[sl]
            added = batch.get("added_cond")
            pred = self.net(noisy, t[sl], batch["context"][sl].float(),
                            None if added is None else added[sl].float())
            loss = ((pred - noise[sl]) ** 2).sum() / n_all
            part = torch.autograd.grad(loss, self.leaves)
            for g, p in zip(grads, part):
                g.add_(p)
            total += float(loss.detach())
        self.opt.step(grads)
        return total, grads
