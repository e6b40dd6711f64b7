"""What the port's work costs, from shapes alone: the FLOPs and bytes of each
of its kernels at a launch's shape, the base model's FLOPs a step, and the
census of which kernel launches at which shape in one UNet or DiT call.

The census is a frozen copy of the one the smoke script keeps beside the
port (``unet_census``/``path_shapes``/``want_counts``, ``dit_census``): the
benchmark holds the port's launch counters to it and reads the rooflines
from it, so it must not move when the port's own scripts do. The
kernel-name rules that sort a profiler's kernels into buckets are frozen
here too.

A launch's bound is max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s), the H100
SXM's dense bf16 peak and HBM bandwidth from NVIDIA's data sheet at 700 W,
counting each input byte read once and each output byte written once.
"""

from __future__ import annotations

from collections import Counter

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
HBM_BYTES_PER_S = 3.35e12
CONTEXT_TOKENS = 77  # the text encoder's tokens a UNet cross-attention reads


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# a kernel's (FLOPs, bytes) at one launch's shape; e is the element size
# ---------------------------------------------------------------------------


def flash_fwd(bh: int, t: int, d: int, e: int = 2) -> tuple[float, float]:
    """q, k, v read and o written (bh, t, d), lse written (bh, t) fp32;
    QK^T and PV over every (query, key) pair."""
    return 4.0 * bh * t * t * d, 4.0 * bh * t * d * e + 4.0 * bh * t


def flash_bwd(bh: int, t: int, d: int, e: int = 2) -> tuple[float, float]:
    """q, k, v, o, dO and lse read, dq, dk, dv and di written; five
    (t, t, d) products (S again, dV, dP, dQ, dK)."""
    return 10.0 * bh * t * t * d, 8.0 * bh * t * d * e + 8.0 * bh * t


def layer_norm_fwd(rows: int, c: int, bias: bool = True, e: int = 2) -> tuple[float, float]:
    """x read and y written, weight (and bias) read once."""
    return 8.0 * rows * c, (2.0 * rows * c + c * (2 if bias else 1)) * e


def layer_norm_bwd(rows: int, c: int, e: int = 2) -> tuple[float, float]:
    """x and dy read, dx written, weight read once (frozen: no dw, db)."""
    return 12.0 * rows * c, (3.0 * rows * c + c) * e


def group_norm_fwd(n: int, c: int, s: int, groups: int = 32, e: int = 2) -> tuple[float, float]:
    """x read and y written, gamma and beta read, mean and rstd written fp32."""
    return 10.0 * n * c * s, (2.0 * n * c * s + 2 * c) * e + 8.0 * n * groups


def group_norm_bwd(n: int, c: int, s: int, groups: int = 32, e: int = 2) -> tuple[float, float]:
    """x and dh read, dx written, gamma, beta, mean and rstd read once."""
    return 16.0 * n * c * s, (3.0 * n * c * s + 2 * c) * e + 8.0 * n * groups


def geglu_bwd(rows: int, f2: int, e: int = 2) -> tuple[float, float]:
    """h_full (rows, 2F) and dy (rows, F) read, d_hfull (rows, 2F) written."""
    return 20.0 * rows * f2 / 2, (2.5 * rows * f2) * e


def hada_fwd(o: int, i: int, r: int = 8, e: int = 4) -> tuple[float, float]:
    """LoHa's dW = (w1a w1b) * (w2a w2b): four factors read, dW (o, i) written."""
    return 4.0 * o * i * r + o * i, (2.0 * r * (o + i) + o * i) * e


KERNELS = {"flash_fwd": flash_fwd, "flash_bwd": flash_bwd, "layer_norm_fwd": layer_norm_fwd,
           "layer_norm_bwd": layer_norm_bwd, "group_norm_fwd": group_norm_fwd,
           "group_norm_bwd": group_norm_bwd, "geglu_bwd": geglu_bwd, "hada_fwd": hada_fwd}

# profiler kernel names -> the port's kernels (csrc/*.cu), then the library
# buckets; a kernel matching none of them is elementwise, copy or other work
# (profile_serving.KINDS and chip_smoke.DIT_BUCKETS, frozen)
OWN_KERNELS = ("flash_fwd", "flash_bwd", "flash_di", "ln_fwd", "ln_bwd", "hada_", "gn_fwd",
               "gn_bwd", "geglu_bwd", "lora_fused", "lora_fast")
# the device kernels of each census entry with a bound (csrc/*.cu's __global__ names)
KERNEL_NAMES = {"flash_fwd": ("flash_fwd_",), "flash_bwd": ("flash_bwd_", "flash_di_"),
                "layer_norm_fwd": ("ln_fwd_",), "layer_norm_bwd": ("ln_bwd_",),
                "group_norm_fwd": ("gn_fwd_",), "group_norm_bwd": ("gn_bwd_",),
                "geglu_bwd": ("geglu_bwd_",), "hada_fwd": ("hada_fwd_",)}
GEMM = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")
CONV = ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "winograd", "cudnn", "implicit_")
COLLECTIVE = ("nccl",)


def census_kernel(name: str) -> str | None:
    """The census entry a device kernel's name belongs to, or None."""
    for kernel, keys in KERNEL_NAMES.items():
        if any(k in name for k in keys):
            return kernel
    return None


def bucket(name: str) -> str:
    """``own``, ``gemm``, ``conv``, ``collective`` or ``elementwise`` for a
    device kernel's name."""
    low = name.lower()
    for kind, keys in (("own", OWN_KERNELS), ("conv", CONV), ("gemm", GEMM),
                       ("collective", COLLECTIVE)):
        if any(k in low for k in keys):
            return kind
    return "elementwise"


# ---------------------------------------------------------------------------
# the census of one UNet call (frozen from the port's smoke script)
# ---------------------------------------------------------------------------


def unet_heads(sizes: dict, ch: int) -> int:
    return ch // sizes["head_dim"] if sizes.get("head_dim") else sizes["num_heads"]


def unet_walk(sizes: dict, hw: int) -> dict:
    """The GroupNorms, Transformer2DModels, resnets and samplers of one UNet
    call on ``hw`` x ``hw`` latents, block by block as the forward runs:
    "gn" counts (C, S, act) of every GroupNorm, "gn_grad" those a gradient
    reaches when only the Transformer2DModels are adapted (every one after
    the first such model's own norm), "transformers" lists (channels,
    resolution, depth), "resnets" (in, out, resolution), "samplers" (kind,
    channels, resolution of the output)."""
    gn, gn_grad = Counter(), Counter()
    transformers, resnets, samplers = [], [], []
    grad = False

    def norm(c, res, act):
        gn[(c, res * res, act)] += 1
        if grad:
            gn_grad[(c, res * res, act)] += 1

    def resnet(c_in, c_out, res):
        norm(c_in, res, "silu")
        norm(c_out, res, "silu")
        resnets.append((c_in, c_out, res))

    def transformer(c, res, depth):
        nonlocal grad
        norm(c, res, None)
        transformers.append((c, res, depth))
        grad = True

    chs, lpb, depths = sizes["block_out_channels"], sizes["layers_per_block"], \
        sizes["transformer_depth"]
    res, ch_in = hw, chs[0]
    skips = [ch_in]
    for bi, ch in enumerate(chs):
        for _ in range(lpb):
            resnet(ch_in, ch, res)
            ch_in = ch
            if depths[bi]:
                transformer(ch, res, depths[bi])
            skips.append(ch)
        if bi < len(chs) - 1:
            res //= 2
            samplers.append(("down", ch, res))
            skips.append(ch)
    resnet(ch_in, ch_in, res)
    if sizes["mid_transformer_depth"]:
        transformer(ch_in, res, sizes["mid_transformer_depth"])
    resnet(ch_in, ch_in, res)
    for bi in reversed(range(len(chs))):
        for _ in range(lpb + 1):
            resnet(ch_in + skips.pop(), chs[bi], res)
            ch_in = chs[bi]
            if depths[bi]:
                transformer(ch_in, res, depths[bi])
        if bi > 0:
            res *= 2
            samplers.append(("up", ch_in, res))
    norm(chs[0], res, "silu")  # conv_norm_out
    return {"gn": gn, "gn_grad": gn_grad, "transformers": transformers, "resnets": resnets,
            "samplers": samplers}


def use_flash(tq: int, tk: int, d: int) -> bool:
    """The port's attention dispatch rule (ops/attention.py, frozen)."""
    return tq == tk and tq >= 1024 and tq % 512 == 0 and d <= 128


def unet_passes(sizes: dict, block: str, train: bool) -> int:
    """Forward passes a call of a layer inside a ``block`` (its class name):
    two in training where ``sizes["remat"]`` checkpoints the
    Transformer2DModels and the layer is inside one."""
    remat = train and sizes.get("remat") in ("transformer", True)
    return 2 if remat and block == "Transformer2DModel" else 1


def unet_census(sizes: dict, batch: int, hw: int, train: bool) -> dict:
    """Launches of each of the port's kernels in one UNet call (``train``:
    one training step, with the Transformer2DModels checkpointed where
    ``sizes["remat"]`` says so), as {kernel: Counter(shape -> launches)};
    an adapter's own part comes from its algorithm (:func:`with_adapter`)."""
    walk = unet_walk(sizes, hw)
    again = unet_passes(sizes, "Transformer2DModel", train)
    out = {k: Counter() for k in ("flash_fwd", "flash_bwd", "layer_norm_fwd", "layer_norm_bwd",
                                  "group_norm_fwd", "group_norm_bwd", "geglu_bwd")}
    for ch, res, depth in walk["transformers"]:
        t = res * res
        heads = unet_heads(sizes, ch)
        d = ch // heads
        if use_flash(t, t, d):
            out["flash_fwd"][(batch * heads, t, d)] += again * depth
            if train:
                out["flash_bwd"][(batch * heads, t, d)] += depth
        out["layer_norm_fwd"][(batch * t, ch)] += again * 3 * depth
        if train:
            out["layer_norm_bwd"][(batch * t, ch)] += 3 * depth
            out["geglu_bwd"][(batch * t, 8 * ch)] += depth
    for (c, s, act), n in walk["gn"].items():
        out["group_norm_fwd"][(batch, c, s)] += n
    if train:
        for (c, s, act), n in walk["gn"].items():
            if act is None and again == 2:
                out["group_norm_fwd"][(batch, c, s)] += n  # the checkpointed model's norm again
        for (c, s, act), n in walk["gn_grad"].items():
            out["group_norm_bwd"][(batch, c, s)] += n
    return out


def dit_census(sizes: dict, batch: int, txt: int, img: int) -> dict:
    """Launches of each of the port's kernels in one DiT call:
    {kernel: Counter(shape -> launches)}."""
    d, t = sizes["hidden_size"], txt + img
    dd, ds = sizes["depth_double"], sizes["depth_single"]
    hd = d // sizes["num_heads"]
    out = {"flash_fwd": Counter(), "layer_norm_fwd": Counter()}
    if use_flash(t, t, hd):
        out["flash_fwd"][(batch * sizes["num_heads"], t, hd)] += dd + ds
    out["layer_norm_fwd"][(batch * img, d)] += 2 * dd + 1
    out["layer_norm_fwd"][(batch * txt, d)] += 2 * dd
    out["layer_norm_fwd"][(batch * t, d)] += ds
    return out


def with_adapter(census: dict, extra: dict) -> dict:
    """The model's census with an adapter algorithm's part added."""
    out = {k: (Counter(v) if isinstance(v, Counter) else v) for k, v in census.items()}
    for k, v in extra.items():
        if isinstance(v, Counter):
            out[k] = out.get(k, Counter()) + v
        else:
            out[k] = out.get(k, 0) + v
    return out


def census_bounds_s(census: dict, bias: bool = True) -> dict:
    """{kernel: Σ bound over one call's launches} of each census kernel
    with a bound formula."""
    out = {}
    for kernel, shapes in census.items():
        if kernel not in KERNELS:
            continue
        total = 0.0
        for shape, n in shapes.items():
            if kernel == "layer_norm_fwd":
                total += n * bound_s(*layer_norm_fwd(*shape, bias=bias))
            else:
                total += n * bound_s(*KERNELS[kernel](*shape))
        out[kernel] = total
    return out


def census_bound_s(census: dict, bias: bool = True) -> float:
    """Σ bound over one call's launches of the port's kernels."""
    return sum(census_bounds_s(census, bias).values())


def census_launches(census: dict) -> dict:
    return {k: (sum(v.values()) if isinstance(v, Counter) else v) for k, v in census.items()}


def census_disagreeing(got: dict, census: dict, calls: int) -> list:
    """The names whose launch counters over ``calls`` calls, ``got``, differ
    from the census's launches (0 for a name the census lacks)."""
    want = census_launches(census)
    return sorted(k for k in set(got) | set(want) if got.get(k, 0) != calls * want.get(k, 0))


def census_agrees(got: dict, census: dict, calls: int) -> bool:
    """The port's launch counters over ``calls`` calls, ``got``, equal the
    census's launches (0 for a kernel the census does not name)."""
    return not census_disagreeing(got, census, calls)


# ---------------------------------------------------------------------------
# the base model's FLOPs a call: matmuls, convolutions, attention
# ---------------------------------------------------------------------------


def conv_flops(c_in, c_out, k, res, batch):
    return 2.0 * c_in * c_out * k * k * res * res * batch


def linear_flops(i, o, rows):
    return 2.0 * i * o * rows


def attention_flops(batch, tq, tk, width):
    return 4.0 * batch * tq * tk * width


def unet_flops(sizes: dict, batch: int, hw: int) -> float:
    """One UNet forward at ``batch`` x ``hw`` x ``hw`` latents."""
    walk = unet_walk(sizes, hw)
    ch0 = sizes["block_out_channels"][0]
    temb = sizes.get("time_embed_dim") or 4 * ch0
    ctx = sizes["context_dim"]
    f = linear_flops(ch0, temb, batch) + linear_flops(temb, temb, batch)
    if sizes.get("addition_embed_dim"):
        f += linear_flops(sizes["addition_embed_dim"], temb, batch) + linear_flops(temb, temb, batch)
    f += conv_flops(sizes["in_channels"], ch0, 3, hw, batch)
    for c_in, c_out, res in walk["resnets"]:
        f += conv_flops(c_in, c_out, 3, res, batch) + conv_flops(c_out, c_out, 3, res, batch)
        f += linear_flops(temb, c_out, batch)
        if c_in != c_out:
            f += conv_flops(c_in, c_out, 1, res, batch)
    for ch, res, depth in walk["transformers"]:
        t = res * res
        rows = batch * t
        f += 2 * conv_flops(ch, ch, 1, res, batch)  # proj_in, proj_out
        per_block = (linear_flops(ch, ch, rows) * 4 + attention_flops(batch, t, t, ch)
                     + linear_flops(ch, ch, rows) * 2 + linear_flops(ctx, ch, batch * CONTEXT_TOKENS) * 2
                     + attention_flops(batch, t, CONTEXT_TOKENS, ch)
                     + linear_flops(ch, 8 * ch, rows) + linear_flops(4 * ch, ch, rows))
        f += depth * per_block
    for kind, ch, res in walk["samplers"]:
        f += conv_flops(ch, ch, 3, res, batch)
    f += conv_flops(ch0, sizes["out_channels"], 3, hw, batch)
    return f


def dit_flops(sizes: dict, batch: int, txt: int, img: int) -> float:
    """One DiT forward on ``batch`` x (``txt`` + ``img``) tokens."""
    d, mlp = sizes["hidden_size"], int(sizes["hidden_size"] * sizes["mlp_ratio"])
    t = txt + img
    b = batch
    f = (linear_flops(sizes["in_channels"], d, b * img) + linear_flops(sizes["context_dim"], d, b * txt)
         + linear_flops(256, d, b) + linear_flops(d, d, b))
    double = (2 * linear_flops(d, 6 * d, b) + linear_flops(d, 3 * d, b * t)
              + attention_flops(b, t, t, d) + linear_flops(d, d, b * t)
              + linear_flops(d, mlp, b * t) + linear_flops(mlp, d, b * t))
    single = (linear_flops(d, 3 * d, b) + linear_flops(d, 3 * d + mlp, b * t)
              + attention_flops(b, t, t, d) + linear_flops(d + mlp, d, b * t))
    f += sizes["depth_double"] * double + sizes["depth_single"] * single
    f += linear_flops(d, 3 * d, b) + linear_flops(d, sizes["in_channels"], b * img)
    return f


def flux_departure_flops(sizes: dict, batch: int, txt: int, img: int) -> dict:
    """FLOPs a call of what the port's DiT leaves out of FLUX.1-dev: rotary
    positions on q and k (a multiply-add pair, 3 FLOPs an element, in every
    block), the guidance embedder (MLP 256 -> d -> d) and the pooled-text
    embedder (MLP 768 -> d -> d)."""
    d, t, b = sizes["hidden_size"], txt + img, batch
    blocks = sizes["depth_double"] + sizes["depth_single"]
    return {"rope": blocks * 2 * 3.0 * b * t * d,
            "guidance_in": linear_flops(256, d, b) + linear_flops(d, d, b),
            "vector_in": linear_flops(768, d, b) + linear_flops(d, d, b)}
