"""Everything a run feeds the port, made from ``--seed`` on the device: base
weights, adapter tensors, batches and requests. The same seed gives the
same tensors on the same kind of card, so the reference regenerates them
rather than reading anything the port holds.

Weights come from one uniform draw over a flat buffer in the served dtype
(in chunks of 2**30 elements), each leaf a view at an offset aligned to 256
bytes, scaled in place: linear and conv weights and biases U(-b, b) with
b = 1 / sqrt(fan_in) (the port's kaiming-uniform), norm weights
1 + U(-0.1, 0.1), norm biases U(-0.1, 0.1). Every adapter tensor is
U(-b, b) with b = 1 / sqrt(its second dimension), none zero (a LoKr's dW is
then some 16% of W by RMS, as a trained adapter's can be). The adapter
algorithm named by the mix is a file of ``algos/``, found by name.
"""

from __future__ import annotations

import hashlib
import math
from pathlib import Path

ALIGN = 128  # elements: 256 bytes in bf16
CHUNK = 1 << 30


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one kind of draw, from the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()[:8], "little") >> 1


def _generator(seed: int, tag: str, device):
    import torch

    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _uniform_flat(n: int, seed: int, tag: str, dtype, device):
    import torch

    flat = torch.empty(n, dtype=dtype, device=device)
    gen = _generator(seed, tag, device)
    for lo in range(0, n, CHUNK):
        flat[lo:lo + CHUNK].uniform_(-1.0, 1.0, generator=gen)
    return flat


def make_weights(spec: list, seed: int, dtype, device) -> dict:
    """{name: tensor} for every entry of a reference spec
    ``[(name, shape, kind, fan_in, block)]``."""
    import torch

    offsets, n = [], 0
    for _, shape, *_ in spec:
        offsets.append(n)
        n += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = _uniform_flat(n, seed, "weights", dtype, device)
    out = {}
    with torch.no_grad():
        for (name, shape, kind, fan_in, _), off in zip(spec, offsets):
            t = flat[off:off + math.prod(shape)].view(shape)
            if kind in ("w", "b"):
                t.mul_(fan_in ** -0.5)
            elif kind == "nw":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.1)
            out[name] = t
    return out


def adapted_layers(spec: list, targets: list) -> list:
    """[(layer, weight shape, block)] of the linear and conv layers inside a
    block whose class ``targets`` names, in spec order."""
    return [(name[:-len(".weight")], shape, block) for name, shape, kind, _, block in spec
            if kind == "w" and block in targets]


def algo(name: str, root=None):
    """The adapter algorithm's module, ``bench_h100/algos/<name>.py`` under
    ``root`` (a checkout; this one by default): ``shapes``, ``delta``,
    ``port_kwargs`` and ``census``."""
    from .harness import load_module

    root = Path(root) if root is not None else Path(__file__).resolve().parent.parent
    return load_module(root / "bench_h100" / "algos" / f"{name}.py", f"algo_{name}")


def make_adapters(spec: list, adapter: dict, seed: int, device, algo_mod=None) -> tuple[dict, dict]:
    """({layer: {key: fp32 tensor}}, {layer: scale}) of the mix's adapter on
    the adapted layers of ``spec``."""
    import torch

    mod = algo_mod or algo(adapter["algo"])
    plan, n = [], 0
    for layer, shape, _ in adapted_layers(spec, adapter["targets"]):
        lk = mod.shapes(shape[0], math.prod(shape[1:]), adapter)
        for key, sub in lk["shapes"].items():
            plan.append((layer, key, sub, n, lk["scale"]))
            n += math.prod(sub)
    flat = _uniform_flat(n, seed, "adapters", torch.float32, device)
    theta, scales = {}, {}
    with torch.no_grad():
        for layer, key, sub, off, scale in plan:
            theta.setdefault(layer, {})[key] = flat[off:off + math.prod(sub)].view(sub).mul_(
                sub[1] ** -0.5)
            scales[layer] = scale
    return theta, scales


def lora_name(layer: str) -> str:
    """The port's adapter name of a layer (its module path, dots to '_')."""
    return "lycoris_" + layer.replace(".", "_")


def port_network(model, adapter: dict, device, algo_mod=None):
    """The port's LyCORIS network on ``model``'s ``targets`` blocks."""
    from lycoris_tpu_torch import LycorisNetwork, create_lycoris

    mod = algo_mod or algo(adapter["algo"])
    LycorisNetwork.apply_preset({"target_module": list(adapter["targets"])})
    try:
        return create_lycoris(model, 1.0, linear_dim=adapter["dim"], linear_alpha=adapter["alpha"],
                              algo=adapter["algo"], device=device, **mod.port_kwargs(adapter))
    finally:
        LycorisNetwork.reset_preset()


def load_adapters(net, theta: dict) -> list:
    """Copy the benchmark's adapter tensors into the port's network;
    [(layer, key, parameter)] of every trainable tensor, in a fixed order.
    Fails unless the network adapts exactly ``theta``'s layers with exactly
    its keys."""
    import torch

    by_name = {lora_name(layer): layer for layer in theta}
    if set(net.lora_map) != set(by_name):
        missing, extra = set(by_name) - set(net.lora_map), set(net.lora_map) - set(by_name)
        raise RuntimeError(f"the port adapts other layers than the reference: missing "
                           f"{sorted(missing)[:4]}, extra {sorted(extra)[:4]}")
    leaves = []
    with torch.no_grad():
        for name in sorted(by_name):
            layer, lyco = by_name[name], net.lora_map[name]
            trainable = {k for k, p in lyco.params.items() if p.requires_grad}
            if trainable != set(theta[layer]):
                raise RuntimeError(f"{name}: port tensors {sorted(trainable)}, reference "
                                   f"{sorted(theta[layer])}")
            for key in sorted(trainable):
                p = lyco.params[key]
                p.copy_(theta[layer][key].reshape(p.shape))
                leaves.append((layer, key, p))
    return leaves


def unet_batches(sizes: dict, traffic: dict, seed: int, dtype, device) -> list:
    """``pool_batches`` distinct batches: latents (B, C, hw, hw) fp32,
    context (B, 77, context_dim) and added_cond (B, addition_embed_dim) in
    ``dtype``, as cached latents and text-encoder outputs would be."""
    import torch

    gen = _generator(seed, "batches", device)
    p, b, hw = traffic["pool_batches"], traffic["batch"], traffic["latent_hw"]
    lat = torch.randn((p, b, sizes["in_channels"], hw, hw), generator=gen, device=device)
    ctx = torch.randn((p, b, traffic["context_tokens"], sizes["context_dim"]), generator=gen,
                      device=device).to(dtype)
    out = [{"latents": lat[i], "context": ctx[i]} for i in range(p)]
    if sizes.get("addition_embed_dim"):
        add = torch.randn((p, b, sizes["addition_embed_dim"]), generator=gen,
                          device=device).to(dtype)
        for i, batch in enumerate(out):
            batch["added_cond"] = add[i]
    return out


def dit_requests(sizes: dict, traffic: dict, seed: int, dtype, device) -> tuple[list, object]:
    """``pool_requests`` distinct (image tokens, text tokens) at the mix's
    batch and lengths in ``dtype``, and ``timesteps`` x batch timesteps
    U[0, 1000) fp32: call i takes request i mod pool and timestep row i mod
    ``timesteps``."""
    import torch

    gen = _generator(seed, "requests", device)
    p, b = traffic["pool_requests"], traffic["batch"]
    img = torch.randn((p, b, traffic["img_tokens"], sizes["in_channels"]), generator=gen,
                      device=device).to(dtype)
    txt = torch.randn((p, b, traffic["txt_tokens"], sizes["context_dim"]), generator=gen,
                      device=device).to(dtype)
    ts = torch.rand((traffic["timesteps"], b), generator=gen, device=device) * 1000.0
    return [(img[i], txt[i]) for i in range(p)], ts
