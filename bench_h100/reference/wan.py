"""Plain fp32 Wan2.1 text-to-video DiT (Wan-Video/Wan2.1, ``wan/modules/model.py``)
and its flow-matching training step, as the port's ``models/wan.py`` and
``trainer.py`` (``objective="flow"``) compute them.

``wan_spec`` lists every parameter under the official names with its shape
and kind; ``wan_forward`` runs the model on a :class:`WeightStore`;
``TrainReference`` follows the trainer's first steps: the same noise and
sigma draws from a generator of its own, the loss, the adapter gradients,
its own AdamW.

Written from the published model, not from the port: the patch embedding
is a linear map of each (1, 2, 2) patch, the 3-D rotary positions a
complex product with the official ``rope_params`` tables, the head's
unpatchify the official einsum. Everything runs in fp32 (the residual
stream too, as the official code keeps it). Each block is checkpointed when
a gradient is recorded, and the attention runs in blocks of ``qblock``
queries, each checkpointed too, so that a 14,040-token step fits beside
the bf16 base weights.

Sizes are the port's ``WanConfig`` keys: ``dim``, ``ffn_dim``, ``freq_dim``,
``text_dim``, ``in_dim``, ``out_dim``, ``num_heads``, ``num_layers``,
``patch_size``, ``eps``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import AdamW, Ops, WeightStore, gelu_tanh, timestep_embedding


def wan_spec(sizes: dict) -> list:
    """[(name, shape, kind, fan_in, block)] as :func:`.unet.unet_spec`;
    kind "mod" for a modulation table."""
    d, ffn = sizes["dim"], sizes["ffn_dim"]
    patch = tuple(sizes["patch_size"])
    out = []

    def linear(name, i, o, block=""):
        out.append((f"{name}.weight", (o, i), "w", i, block))
        out.append((f"{name}.bias", (o,), "b", i, block))

    def norm(name, bias=False, block=""):
        out.append((f"{name}.weight", (d,), "nw", d, block))
        if bias:
            out.append((f"{name}.bias", (d,), "nb", d, block))

    fan = sizes["in_dim"] * math.prod(patch)
    out.append(("patch_embedding.weight", (d, sizes["in_dim"], *patch), "w", fan, ""))
    out.append(("patch_embedding.bias", (d,), "b", fan, ""))
    linear("text_embedding.0", sizes["text_dim"], d)
    linear("text_embedding.2", d, d)
    linear("time_embedding.0", sizes["freq_dim"], d)
    linear("time_embedding.2", d, d)
    linear("time_projection.1", d, 6 * d)
    blk = "WanAttentionBlock"
    for i in range(sizes["num_layers"]):
        p = f"blocks.{i}"
        for a in ("self_attn", "cross_attn"):
            for n in ("q", "k", "v", "o"):
                linear(f"{p}.{a}.{n}", d, d, blk)
            norm(f"{p}.{a}.norm_q", block=blk)
            norm(f"{p}.{a}.norm_k", block=blk)
            if a == "self_attn":
                norm(f"{p}.norm3", bias=True, block=blk)
        linear(f"{p}.ffn.0", d, ffn, blk)
        linear(f"{p}.ffn.2", ffn, d, blk)
        out.append((f"{p}.modulation", (1, 6, d), "mod", d, blk))
    out.append(("head.modulation", (1, 2, d), "mod", d, ""))
    linear("head.head", d, sizes["out_dim"] * math.prod(patch))
    return out


def rope_freqs(grid, head_dim: int, device):
    """(L, head_dim / 2) complex64 rotations of the tokens of a (f, h, w)
    grid, as the official ``rope_params`` tables and ``rope_apply`` make
    them: frame, row and column pairs (c - 4 (c // 6), 2 (c // 6), 2 (c // 6)
    channels), float64 angles."""
    c = head_dim

    def params(n):
        ang = torch.outer(torch.arange(1024, dtype=torch.float64),
                          1.0 / torch.pow(10000, torch.arange(0, n, 2, dtype=torch.float64) / n))
        return torch.polar(torch.ones_like(ang), ang)

    pf, ph, pw = params(c - 4 * (c // 6)), params(2 * (c // 6)), params(2 * (c // 6))
    f, h, w = grid
    fr = torch.cat([pf[:f].view(f, 1, 1, -1).expand(f, h, w, -1),
                    ph[:h].view(1, h, 1, -1).expand(f, h, w, -1),
                    pw[:w].view(1, 1, w, -1).expand(f, h, w, -1)], dim=-1)
    return fr.reshape(f * h * w, -1).to(torch.complex64).to(device)


def rope_apply(x, freqs):
    """(B, L, H, D) fp32 ``x``, each pair (x_2j, x_2j+1) a complex number
    multiplied by its rotation."""
    xc = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(xc * freqs[:, None]).flatten(-2)


class _Wan:
    def __init__(self, sizes, store: WeightStore, ops: Ops, qblock: int = 1024):
        self.s, self.ws, self.o, self.qblock = sizes, store, ops, qblock
        self.nh, self.eps = sizes["num_heads"], sizes["eps"]

    def lin(self, name, x):
        return self.o.linear(x, self.ws.w(name), self.ws.b(name))

    def ln(self, x, name=None):
        w = None if name is None else self.ws.base[f"{name}.weight"].float()
        return F.layer_norm(x, (x.shape[-1],), w, None if name is None else self.ws.b(name),
                            self.eps)

    def rms(self, name, x):
        w = self.ws.base[f"{name}.weight"].float()
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.eps) * w

    def _rows(self, q, k, v):
        return self.o.attention(q, k, v)

    def attention(self, q, k, v):
        """(B, T, H, D) each -> (B, T, H * D), in blocks of ``qblock`` queries."""
        q, k, v = (y.transpose(1, 2) for y in (q, k, v))
        outs = []
        for lo in range(0, q.shape[2], self.qblock):
            qb = q[:, :, lo:lo + self.qblock]
            if torch.is_grad_enabled():
                outs.append(checkpoint(self._rows, qb, k, v, use_reentrant=False))
            else:
                outs.append(self._rows(qb, k, v))
        return torch.cat(outs, dim=2).transpose(1, 2).flatten(-2)

    def attn(self, p, x, src, freqs=None):
        heads = lambda y: y.unflatten(-1, (self.nh, -1))  # noqa: E731
        q = heads(self.rms(f"{p}.norm_q", self.lin(f"{p}.q", x)))
        k = heads(self.rms(f"{p}.norm_k", self.lin(f"{p}.k", src)))
        if freqs is not None:
            q, k = rope_apply(q, freqs), rope_apply(k, freqs)
        return self.lin(f"{p}.o", self.attention(q, k, heads(self.lin(f"{p}.v", src))))

    def block(self, i, x, e0, ctx, freqs):
        p = f"blocks.{i}"
        e = (self.ws.base[f"{p}.modulation"].float() + e0).chunk(6, dim=1)
        h = self.ln(x) * (1 + e[1]) + e[0]
        x = x + self.attn(f"{p}.self_attn", h, h, freqs) * e[2]
        x = x + self.attn(f"{p}.cross_attn", self.ln(x, f"{p}.norm3"), ctx)
        h = gelu_tanh(self.lin(f"{p}.ffn.0", self.ln(x) * (1 + e[4]) + e[3]))
        return x + self.lin(f"{p}.ffn.2", h) * e[5]

    def __call__(self, x, t, context):
        s = self.s
        pf, ph, pw = s["patch_size"]
        b, c, f, h, w = x.shape
        grid = (f // pf, h // ph, w // pw)
        patches = x.reshape(b, c, grid[0], pf, grid[1], ph, grid[2], pw).permute(
            0, 2, 4, 6, 1, 3, 5, 7).reshape(b, math.prod(grid), -1)
        wp = self.ws.w("patch_embedding")
        x = self.o.linear(patches, wp.reshape(wp.shape[0], -1), self.ws.b("patch_embedding"))
        e = self.lin("time_embedding.2", F.silu(self.lin("time_embedding.0",
                                                         timestep_embedding(t, s["freq_dim"]))))
        e0 = self.lin("time_projection.1", F.silu(e)).unflatten(1, (6, s["dim"]))
        ctx = self.lin("text_embedding.2", gelu_tanh(self.lin("text_embedding.0", context)))
        freqs = rope_freqs(grid, s["dim"] // self.nh, x.device)
        for i in range(s["num_layers"]):
            if torch.is_grad_enabled():
                x = checkpoint(self.block, i, x, e0, ctx, freqs, use_reentrant=False)
            else:
                x = self.block(i, x, e0, ctx, freqs)
        hm = (self.ws.base["head.modulation"].float() + e[:, None]).chunk(2, dim=1)
        y = self.lin("head.head", self.ln(x) * (1 + hm[1]) + hm[0])
        y = y.reshape(b, *grid, pf, ph, pw, s["out_dim"])
        y = torch.einsum("bfhwpqrc->bcfphqwr", y)
        return y.reshape(b, s["out_dim"], f, h, w)


@torch.no_grad()
def wan_forward(sizes, store: WeightStore, x, t, context, precision="fp32", qblock=1024):
    """The model's output (B, out_dim, F, H, W) on fp32 inputs."""
    return _Wan(sizes, store, Ops(precision), qblock)(x.float(), t, context.float())


class TrainReference:
    """The flow-matching trainer's first steps in plain fp32 (or the fp8
    control): ``adapters`` {layer: {key: fp32 tensor}} train (dW by
    ``delta``), the base is frozen. ``step(batch)`` draws noise then sigmas
    U(0, 1) from ``generator`` as the trainer does, forms x_sigma = (1 -
    sigma) x0 + sigma noise, calls the model at 1000 sigma, takes the MSE
    against noise - x0 and an AdamW step; it returns the loss and the
    gradients by (layer, key)."""

    def __init__(self, sizes, base: dict, adapters: dict, scales: dict, delta, generator,
                 lr: float = 1e-4, precision: str = "fp32", qblock: int = 1024):
        self.gen = generator
        self.keys = [(layer, k) for layer in sorted(adapters) for k in sorted(adapters[layer])]
        self.leaves = [adapters[layer][k].detach().clone().float().requires_grad_(True)
                       for layer, k in self.keys]
        theta = {}
        for (layer, k), p in zip(self.keys, self.leaves):
            theta.setdefault(layer, {})[k] = p
        self.net = _Wan(sizes, WeightStore(base, theta, scales, delta), Ops(precision), qblock)
        self.opt = AdamW(self.leaves, lr)

    def step(self, batch: dict):
        x0 = batch["latents"].float()
        b, dev = x0.shape[0], x0.device
        noise = torch.randn(x0.shape, generator=self.gen, device=dev, dtype=torch.float32)
        sigma = torch.rand((b,), generator=self.gen, device=dev)
        s = sigma.reshape(b, *(1,) * (x0.ndim - 1))
        pred = self.net((1 - s) * x0 + s * noise, sigma * 1000.0, batch["context"].float())
        loss = ((pred - (noise - x0)) ** 2).mean()
        grads = torch.autograd.grad(loss, self.leaves)
        self.opt.step(grads)
        return float(loss.detach()), grads
