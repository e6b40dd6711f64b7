#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lycoris_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; the first failure ends the run with a
nonzero exit code, and no phase falls back to the CPU:

1. build  -- compile the CUDA kernels from ``lycoris_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and print the card's name and power
   limit (nvidia-smi);
2. kernels -- each forward kernel against its plain PyTorch version at the
   serving path's shapes, in bf16 and fp32 (MSE, relative L2 and max-abs
   bounds), with device times (calls captured in a CUDA graph and replayed
   between CUDA events) of both and of the PyTorch library call where one
   computes the same function, and the wrapper's host-clocked time beside;
3. kernels_bwd -- each backward kernel likewise at the training path's
   shapes (batch 8): flash dq/dk/dv, LayerNorm dx/dw/db, LoHa's four grads;
4. lokr  -- full-width SD1.5 UNet (bf16, random seeded weights), a LoKr
   attn-mlp adapter loaded from a state dict, DDIM 20 steps with CFG for
   3 requests of 2 prompts; counts the kernel launches per UNet call and
   holds the live-adapter output against the merged-weight output;
5. loha  -- the same with a LoHa adapter, fewer steps;
6. e2e   -- one UNet call on the card (bf16, kernels) against the port on
   the CPU (fp32, plain versions) with the same weights;
7. train_lokr -- ``DiffusionTrainer`` AdamW steps on the LoKr adapter at
   batch 8, 64x64 latents: launches per step of every kernel and of the
   factored backward, finite loss, every adapter changed, base unchanged;
8. train_loha -- the same with the LoHa adapter;
9. train_e2e -- one loss and every adapter gradient at batch 1, card (bf16,
   kernels) against the port on the CPU (fp32, plain versions).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# bounds of a kernel against its plain version on the same inputs, per dtype:
# - MSE: the ROADMAP's bounds;
# - relative L2, ||got - want|| / ||want||, and max-abs in units of the
#   reference's largest magnitude, so that a small output (flash O has a std
#   near sqrt(e/T)) is held as tightly as a large one. bf16 outputs carry 8
#   significant bits (flash also rounds P before P.V): rel L2 1e-2, max-abs
#   2**-6 of max|want|, i.e. about four roundings at the top magnitude. fp32
#   differs only in summation order and exp: 1e-4 for both.
MSE_BOUND = {"float32": 5e-6, "bfloat16": 5e-4}
REL_L2_BOUND = {"float32": 1e-4, "bfloat16": 1e-2}
MAX_ABS_REL_BOUND = {"float32": 1e-4, "bfloat16": 2**-6}

SD15_CHANNELS = (320, 640, 1280)
UNET_BATCH = 4  # 2 prompts with classifier-free guidance
TRAIN_BATCH = 8

# published peaks of one H100 SXM (dense): the least time a kernel could take
# is the larger of its operations over the peak for their type and the bytes
# it must move (each input read once, each output written once) over HBM's rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def bound(flops: float, nbytes: float, dt: str) -> tuple[float, str]:
    """(least ms on an H100, "operations" or "bytes": which limit sets it)."""
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Host-clocked ms per call: CUDA events around back-to-back calls, so a
    call whose kernels are shorter than its Python dispatch reads the
    dispatch."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_TIMING_STREAM = None


def timing_stream():
    """The side stream that :func:`graph_ms` captures on; work whose
    autograd backward is timed is recorded on it, since a backward runs on
    its forward's stream."""
    global _TIMING_STREAM
    import torch

    if _TIMING_STREAM is None:
        _TIMING_STREAM = torch.cuda.Stream()
    return _TIMING_STREAM


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph after
    two warm-up calls, the graph replayed ``replays`` times between CUDA
    events, so the host's dispatch of each call is not counted."""
    import torch

    s = timing_stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (iters * replays)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_build():
    from lycoris_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    secs = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[build] {path.name} in {secs:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or ("spill" in line and "0 bytes spill stores" not in line):
            log(f"[build] ptxas: {line.strip()}")
    log(card)
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _hada_shapes():
    """(O, I, launches per UNet call) of the LoHa attn-mlp adapters on SD1.5:
    per Transformer2DModel 8 square layers (proj_in/out, attn1 q/k/v/out,
    attn2 q/out), attn2 k/v from the 768-wide context, ff net_0 (8C, C) and
    net_2 (C, 4C); 5 transformers at 320 and 640, 6 at 1280 (with the mid)."""
    out = []
    for c, n in zip(SD15_CHANNELS, (5, 5, 6)):
        out += [(c, c, 8 * n), (c, 768, 2 * n), (8 * c, c, n), (c, 4 * c, n)]
    return out


def compare(dtype, got, want):
    """(ok, mse, max_abs, rel_l2, max|want|, dtype name) of ``got`` against
    ``want`` under the per-dtype bounds above."""
    import torch

    err = got.float() - want.float()
    mse = float((err * err).mean())
    mx = float(err.abs().max())
    rel = float(err.norm() / want.float().norm())
    scale = float(want.float().abs().max())
    dt = str(dtype).replace("torch.", "")
    ok = (bool(torch.isfinite(got.float()).all()) and mse <= MSE_BOUND[dt]
          and rel <= REL_L2_BOUND[dt] and mx <= MAX_ABS_REL_BOUND[dt] * scale)
    return ok, mse, mx, rel, scale, dt


def compare_all(dtype, gots, wants):
    """:func:`compare` over several outputs: ok if all are, the worst of each
    statistic (max-abs reported for the output nearest its bound)."""
    stats = [compare(dtype, g, w) for g, w in zip(gots, wants)]
    worst = max(stats, key=lambda s: s[2] / max(s[4], 1e-30))
    return (all(s[0] for s in stats), max(s[1] for s in stats), worst[2],
            max(s[3] for s in stats), worst[4], stats[0][5])


def record(results, name, ok, mse, mx, rel, scale, dt, shape_s, ms, host_ms, plain_ms,
           per_call, bnd, lib_ms=None):
    """Log one kernel check and add its times, weighted by its launches per
    UNet call or train step (``per_call``; 0 for a check off the path), to
    the kernel's row. ``ms``, ``plain_ms`` and ``lib_ms`` are device times
    (:func:`graph_ms`), ``host_ms`` the wrapper's back-to-back host-clocked
    time (:func:`time_ms`); ``bnd`` is (bound ms, bound_by) of one launch."""
    lib_s = "" if lib_ms is None else f" library {lib_ms:.4f} ms"
    log(f"[kernels] {name} {dt} {shape_s}: mse {mse:.3e} rel_l2 {rel:.3e} "
        f"max_abs {mx:.3e} (max|ref| {scale:.3e}) kernel {ms:.4f} ms (host-clocked "
        f"{host_ms:.4f} ms) plain {plain_ms:.4f} ms{lib_s} bound {bnd[0]:.4f} ms ({bnd[1]})")
    if not ok:
        fail(f"{name} {dt} {shape_s}: mse {mse:.3e} / rel_l2 {rel:.3e} / "
             f"max_abs {mx:.3e} of max|ref| {scale:.3e} over bound")
    r = results[name]
    r["max_abs_err"] = max(r["max_abs_err"], mx)
    if per_call:
        r["ms"] += ms * per_call
        r["host_ms"] += host_ms * per_call
        r["plain_ms"] += plain_ms * per_call
        r["bound_ms"] += bnd[0] * per_call
        r["bound_parts"][bnd[1]] = r["bound_parts"].get(bnd[1], 0.0) + bnd[0] * per_call
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms * per_call


def _rnd(gen, dev):
    import torch

    def rnd(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    return rnd


def phase_kernels(results: dict):
    import torch
    import torch.nn.functional as F
    from lycoris_tpu_torch.ops import flash, hada, layer_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = _rnd(gen, dev)

    # flash: B*H = 32 (UNet batch 4 x 8 heads) at the two flash levels
    for (t, d, per_call) in ((4096, 40, 5), (1024, 80, 5)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (rnd((UNET_BATCH, 8, t, d), dtype) for _ in range(3))
            sm = 1.0 / d**0.5
            with torch.no_grad():
                o, lse = flash.flash_attention(q, k, v, sm)
                o_ref, lse_ref = flash.flash_attention_plain(q, k, v, sm)
            torch.cuda.synchronize()
            ok, mse, mx, rel, scale, dt = compare(dtype, o, o_ref)
            lse_err = float((lse - lse_ref).abs().max())
            ok = ok and lse_err <= 1e-3
            log(f"[kernels] flash_fwd {dt} lse max_abs {lse_err:.3e}")
            iters = 10 if t == 4096 else 30
            ms = graph_ms(lambda: flash.flash_attention(q, k, v, sm), iters)
            host = time_ms(lambda: flash.flash_attention(q, k, v, sm), iters)
            pms = graph_ms(lambda: flash.flash_attention_plain(q, k, v, sm), iters)
            lib = None
            if dtype == torch.bfloat16:
                with torch.no_grad():
                    lib = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sm),
                                   iters)
            bh = UNET_BATCH * 8
            bnd = bound(4.0 * bh * t * t * d, 4 * bh * t * d * q.element_size() + 4 * bh * t, dt)
            record(results, "flash_fwd", ok, mse, mx, rel, scale, dt, f"(32,{t},{d})", ms, host,
                   pms, per_call if dtype == torch.bfloat16 else 0, bnd, lib)

    # LayerNorm: rows = UNet batch x tokens, per UNet call 15 + 15 + 15 + 3
    for (t, c, per_call) in ((4096, 320, 15), (1024, 640, 15), (256, 1280, 15), (64, 1280, 3)):
        for dtype in (torch.bfloat16, torch.float32):
            x = rnd((UNET_BATCH * t, c), dtype, 2.0) + 0.5
            w = rnd((c,), dtype, 0.5) + 1.0
            b = rnd((c,), dtype, 0.5)
            y = layer_norm.layer_norm(x, w, b, 1e-5)
            y_ref = layer_norm.layer_norm_plain(x, w, b, 1e-5)
            torch.cuda.synchronize()
            ok, mse, mx, rel, scale, dt = compare(dtype, y, y_ref)
            ms = graph_ms(lambda: layer_norm.layer_norm(x, w, b, 1e-5), 100)
            host = time_ms(lambda: layer_norm.layer_norm(x, w, b, 1e-5), 100)
            pms = graph_ms(lambda: layer_norm.layer_norm_plain(x, w, b, 1e-5), 100)
            lib = graph_ms(lambda: F.layer_norm(x, (c,), w, b, 1e-5), 100)
            n = x.numel()
            bnd = bound(8.0 * n, 2 * n * x.element_size() + 2 * c * x.element_size(), dt)
            record(results, "layer_norm_fwd", ok, mse, mx, rel, scale, dt,
                   f"({UNET_BATCH * t},{c})", ms, host, pms,
                   per_call if dtype == torch.bfloat16 else 0, bnd, lib)

    # LoHa dW: rank 8, adapter params fp32 on the path (bf16 checked too)
    for (o_, i_, per_call) in _hada_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            w1d, w2d = rnd((8, i_), dtype), rnd((8, i_), dtype)
            w1u, w2u = rnd((o_, 8), dtype, 0.1), rnd((o_, 8), dtype, 0.1)
            out = hada.hada_weight(w1d, w1u, w2d, w2u, 0.5)
            ref = hada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5)
            torch.cuda.synchronize()
            ok, mse, mx, rel, scale, dt = compare(dtype, out, ref)
            ms = graph_ms(lambda: hada.hada_weight(w1d, w1u, w2d, w2u, 0.5), 100)
            host = time_ms(lambda: hada.hada_weight(w1d, w1u, w2d, w2u, 0.5), 100)
            pms = graph_ms(lambda: hada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5), 100)
            es = w1d.element_size()
            bnd = bound(2.0 * o_ * i_ * (2 * 8 + 2),
                        (o_ * i_ + 2 * 8 * (o_ + i_)) * es, "float32")
            record(results, "hada_fwd", ok, mse, mx, rel, scale, dt, f"({o_},{i_})", ms, host,
                   pms, per_call if dtype == torch.float32 else 0, bnd)


def _library_bwd_ms(fwd, inputs, dy, iters: int) -> float:
    """Device ms of the autograd backward of the library call ``fwd(*inputs)``
    for the cotangent ``dy`` (:func:`graph_ms`). The forward runs on the
    timing stream, so that its backward runs, and is captured, there."""
    import torch

    s = timing_stream()
    s.wait_stream(torch.cuda.current_stream())
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    with torch.cuda.stream(s):
        out = fwd(*leaves)
    return graph_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True), iters)


def phase_kernels_bwd(results: dict):
    """Each backward kernel against its plain version at the training path's
    shapes (batch 8), bf16 and fp32, with per-step times (bf16 flash and
    LayerNorm, fp32 hada, weighted by launches per train step)."""
    import torch
    import torch.nn.functional as F
    from lycoris_tpu_torch.ops import flash, hada, layer_norm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = _rnd(gen, dev)

    # flash: B*H = 64 (batch 8 x 8 heads), 5 + 5 launches per step
    for (t, d, per_step) in ((4096, 40, 5), (1024, 80, 5)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (rnd((TRAIN_BATCH, 8, t, d), dtype) for _ in range(4))
            sm = 1.0 / d**0.5
            with torch.no_grad():
                o, lse = flash.flash_fwd(q, k, v, sm)
                got = flash.flash_bwd(q, k, v, o, lse, do, sm)
                want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, sm)
                torch.cuda.synchronize()
                stats = compare_all(dtype, got, want)
                del got, want
                iters = 5 if t == 4096 else 20
                ms = graph_ms(lambda: flash.flash_bwd(q, k, v, o, lse, do, sm), iters)
                host = time_ms(lambda: flash.flash_bwd(q, k, v, o, lse, do, sm), iters)
                pms = graph_ms(lambda: flash.flash_attention_bwd_plain(q, k, v, o, lse, do, sm),
                               3 if t == 4096 else 10, replays=1)
            lib = None
            if dtype == torch.bfloat16:
                lib = _library_bwd_ms(lambda *xs: F.scaled_dot_product_attention(*xs, scale=sm),
                                      (q, k, v), do, iters)
            bh, es = TRAIN_BATCH * 8, q.element_size()
            # five matmuls (S, dP, dV, dK, dQ) of 2*T*T*D each per head; q, k,
            # v, o, dO, lse, di read and dq, dk, dv written once
            bnd = bound(10.0 * bh * t * t * d, 8 * bh * t * d * es + 8 * bh * t, str(dtype)[6:])
            record(results, "flash_bwd", *stats, f"({bh},{t},{d})", ms, host, pms,
                   per_step if dtype == torch.bfloat16 else 0, bnd, lib)

    # LayerNorm: rows = batch 8 x tokens, 15 + 15 + 15 + 3 launches per step;
    # the path needs dx only (frozen weights), dw/db are checked as well
    for (t, c, per_step) in ((4096, 320, 15), (1024, 640, 15), (256, 1280, 15), (64, 1280, 3)):
        for dtype in (torch.bfloat16, torch.float32):
            x = rnd((TRAIN_BATCH * t, c), dtype, 2.0) + 0.5
            w = rnd((c,), dtype, 0.5) + 1.0
            dy = rnd((TRAIN_BATCH * t, c), dtype)
            got = layer_norm.layer_norm_bwd(x, w, dy, 1e-5)
            dx_only = layer_norm.layer_norm_bwd(x, w, dy, 1e-5, want_wb=False)[0]
            want = layer_norm.layer_norm_bwd_plain(x, w, dy, 1e-5)
            torch.cuda.synchronize()
            stats = compare_all(dtype, (*got, dx_only), (*want, want[0]))
            ms = graph_ms(lambda: layer_norm.layer_norm_bwd(x, w, dy, 1e-5, want_wb=False), 100)
            host = time_ms(lambda: layer_norm.layer_norm_bwd(x, w, dy, 1e-5, want_wb=False), 100)
            pms = graph_ms(lambda: layer_norm.layer_norm_bwd_plain(x, w, dy, 1e-5), 100)
            b = rnd((c,), dtype, 0.5)
            lib = _library_bwd_ms(lambda xl: F.layer_norm(xl, (c,), w, b, 1e-5), (x,), dy, 100)
            n, es = x.numel(), x.element_size()
            bnd = bound(12.0 * n, 3 * n * es + c * es, str(dtype)[6:])
            record(results, "layer_norm_bwd", *stats, f"({TRAIN_BATCH * t},{c})", ms, host, pms,
                   per_step if dtype == torch.bfloat16 else 0, bnd, lib)

    # LoHa: the fp32 cotangent of W + dW (bf16 checked too), rank 8, one
    # launch per adapted layer per step
    for (o_, i_, per_step) in _hada_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            w1d, w2d = rnd((8, i_), dtype), rnd((8, i_), dtype)
            w1u, w2u = rnd((o_, 8), dtype, 0.1), rnd((o_, 8), dtype, 0.1)
            g = rnd((o_, i_), dtype, 1e-3)
            got = hada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, g)
            want = hada.hada_weight_bwd_plain(w1d, w1u, w2d, w2u, 0.5, g)
            torch.cuda.synchronize()
            stats = compare_all(dtype, got, want)
            ms = graph_ms(lambda: hada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, g), 100)
            host = time_ms(lambda: hada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, g), 100)
            pms = graph_ms(lambda: hada.hada_weight_bwd_plain(w1d, w1u, w2d, w2u, 0.5, g), 100)
            es = g.element_size()
            # per element of g, 6 R multiply-adds: R for each of the two
            # products and R for each of the four contractions; g and the
            # factors read, the four grads written
            bnd = bound(2.0 * 6 * 8 * o_ * i_, (o_ * i_ + 4 * 8 * (o_ + i_)) * es, "float32")
            record(results, "hada_bwd", *stats, f"({o_},{i_})", ms, host, pms,
                   per_step if dtype == torch.float32 else 0, bnd)


KERNELS = {
    "flash_fwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "lycoris_tpu/ops/flash.py:87",
    },
    "layer_norm_fwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/ln_fwd.cu",
        "replaces": "lycoris_tpu/ops/layer_norm.py:84",
    },
    "hada_fwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/hada_fwd.cu",
        "replaces": "lycoris_tpu/ops/hada.py:76",
    },
    "flash_bwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "lycoris_tpu/ops/flash.py:238",
    },
    "layer_norm_bwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/ln_bwd.cu",
        "replaces": "lycoris_tpu/ops/layer_norm.py:104",
    },
    "hada_bwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/hada_bwd.cu",
        "replaces": "lycoris_tpu/ops/hada.py:188",
    },
}

# ---------------------------------------------------------------------------
# phases 3-5: the serving path
# ---------------------------------------------------------------------------

ADAPTER_FILL_STD = 0.02  # seeded values added to every trainable factor


def build_unet(device, dtype, seed):
    import torch
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel, sd15_config

    gen = torch.Generator(device=device).manual_seed(seed)
    model = UNet2DConditionModel(sd15_config(dtype), device=device, param_dtype=dtype,
                                 generator=gen)
    return model.eval()


def adapter_state_dict(model, algo: str, device, seed: int) -> dict:
    """A LyCORIS attn-mlp adapter (dim 8, alpha 4; LoKr factor 8) in the
    reference key grammar, with seeded nonzero factors: LoKr's lokr_w2(_b)
    and LoHa's hada_w2_a start at zero, which would make dW = 0."""
    import torch
    from lycoris_tpu_torch import LycorisNetwork, create_lycoris

    LycorisNetwork.apply_preset({"target_module": ["Transformer2DModel"]})
    try:
        src = create_lycoris(model, 1.0, linear_dim=8, linear_alpha=4.0, algo=algo, factor=8,
                             device=device, seed=seed)
    finally:
        LycorisNetwork.reset_preset()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=device) * ADAPTER_FILL_STD)
    return src.state_dict()


def reset_counts():
    from lycoris_tpu_torch.functional import merged
    from lycoris_tpu_torch.ops import flash, hada, layer_norm

    flash.launches = layer_norm.launches = hada.launches = 0
    flash.bwd_launches = layer_norm.bwd_launches = hada.bwd_launches = 0
    merged.applications = 0


def read_counts() -> dict:
    """Launches of every kernel, and factored layer applications."""
    from lycoris_tpu_torch.functional import merged
    from lycoris_tpu_torch.ops import flash, hada, layer_norm

    return {"flash_fwd": flash.launches, "layer_norm_fwd": layer_norm.launches,
            "hada_fwd": hada.launches, "flash_bwd": flash.bwd_launches,
            "layer_norm_bwd": layer_norm.bwd_launches, "hada_bwd": hada.bwd_launches,
            "factored": merged.applications}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def serve(model, algo, sd, requests, steps, results, card):
    """Serve ``requests`` requests of 2 prompts through DDIM + CFG with the
    adapter live (merged forward: one op with W + dW per adapted layer);
    check launch counts, finiteness, and live == merge_to."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.sampler import make_ddim_sampler

    dev = torch.device("cuda")
    tag = f"[{algo}]"
    net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
    net.to(dev)
    n_mod = len(net.loras)
    if n_mod != 192:
        fail(f"{tag} {n_mod} adapter modules, want 192 (16 transformers x 12 layers)")
    net.apply_to(merged_forward=True)
    sampler = make_ddim_sampler(lambda x, t, c: model(x, t, c), num_inference_steps=steps,
                                guidance_scale=7.5)
    gen = torch.Generator(device=dev).manual_seed(7)
    reqs = [
        (torch.randn(2, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16),
         torch.randn(2, 77, 768, generator=gen, device=dev).to(torch.bfloat16),
         torch.randn(2, 77, 768, generator=gen, device=dev).to(torch.bfloat16))
        for _ in range(requests)
    ]
    torch.cuda.synchronize()
    reset_counts()
    outs, secs = [], []
    for lat, ctx, unc in reqs:
        t0 = time.perf_counter()
        out = sampler(lat, ctx, unc)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    counts = read_counts()
    calls = requests * steps
    want = {"flash_fwd": 10 * calls, "layer_norm_fwd": 48 * calls,
            "hada_fwd": (n_mod * calls) if algo == "loha" else 0, "flash_bwd": 0,
            "layer_norm_bwd": 0, "hada_bwd": 0, "factored": 0}
    log(f"{tag} launches {counts} over {calls} UNet calls (want {want})")
    if counts != want:
        fail(f"{tag} launch counts {counts} != {want}")
    for name in KERNELS:  # each kernel's count from the first leg that runs it
        if want.get(name) and not results[name]["launches"]:
            results[name]["launches"] = counts[name]
    for o in outs:
        if o.shape != (2, 4, 64, 64) or not bool(torch.isfinite(o.float()).all()):
            fail(f"{tag} output not finite / wrong shape {tuple(o.shape)}")
    steady = secs[1:]
    log(f"{tag} {requests} requests x 2 prompts, DDIM {steps} steps CFG 7.5: "
        f"s/request {[round(x, 4) for x in secs]} (the first includes warm-up); "
        f"steady {min(steady):.4f}-{max(steady):.4f} s/request, "
        f"{2 / max(steady):.3f}-{2 / min(steady):.3f} images/s ({card}; host-bound smoke "
        f"reading, not a benchmark)")
    results["serving"][algo] = {"s_per_request": secs, "steps": steps}

    # live adapters == merge_to: the same bf16 W + dW either way
    net.restore()
    adapted = [n.module for n in net.node_map.values()]
    saved = [(m.weight.detach().clone(), None if m.bias is None else m.bias.detach().clone())
             for m in adapted]
    net.merge_to(1.0)
    merged = sampler(*reqs[0])
    torch.cuda.synchronize()
    err = rel_l2(outs[0], merged)
    log(f"{tag} live vs merge_to: rel L2 {err:.3e} (bound 1e-3)")
    if not err <= 1e-3:
        fail(f"{tag} live adapter output differs from merge_to: rel L2 {err:.3e}")
    with torch.no_grad():
        for m, (w, b) in zip(adapted, saved):
            m.weight.copy_(w)
            if b is not None:
                m.bias.copy_(b)
    return net


def phase_e2e(model, sd):
    """One UNet call at full width (batch 1, 64x64, LoKr live): the card
    (bf16, kernels) against the port on the CPU (fp32, plain versions)."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel, sd15_config

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(1, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, 77, 768, generator=gen, device=dev).to(torch.bfloat16)
    t = torch.tensor([501], dtype=torch.int32, device=dev)

    net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
    net.apply_to(merged_forward=True)
    with torch.no_grad():
        got = model(x, t, ctx).float().cpu()
    net.restore()

    cpu = UNet2DConditionModel(sd15_config(torch.float32), device="meta")
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()}, assign=True)
    cpu.eval()
    net_cpu, _ = create_lycoris_from_weights(
        1.0, None, cpu, weights_sd={k: v.float().cpu() for k, v in sd.items()})
    net_cpu.apply_to(merged_forward=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu(x.float().cpu(), t.cpu(), ctx.float().cpu())
    err = rel_l2(got, want)
    # bound: the card keeps activations and weights in bf16 (8-bit mantissa,
    # ~4e-3 relative per rounding) through ~100 layers; the CPU run is fp32
    log(f"[e2e] UNet call card bf16 vs CPU fp32 plain: rel L2 {err:.3e} (bound 3e-2; "
        f"CPU call {time.perf_counter() - t0:.1f} s)")
    if not (err <= 3e-2 and bool(torch.isfinite(got).all())):
        fail(f"e2e rel L2 {err:.3e} over 3e-2")


# ---------------------------------------------------------------------------
# phases 7-9: the training path
# ---------------------------------------------------------------------------


def train(model, algo, sd, steps, results, card):
    """``steps`` AdamW steps of ``DiffusionTrainer`` on the adapter in ``sd``
    at batch 8 (the first a warm-up); per step: launches of every kernel and
    factored layer, finite loss; then every adapter parameter changed and the
    base weights bit-identical."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    dev = torch.device("cuda")
    tag = f"[train_{algo}]"
    net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
    tr = DiffusionTrainer(model, net, lr=1e-4, weight_dtype=torch.bfloat16,
                          generator=torch.Generator(device=dev).manual_seed(21))
    gen = torch.Generator(device=dev).manual_seed(17)
    batch = {
        "latents": torch.randn(TRAIN_BATCH, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16),
        "context": torch.randn(TRAIN_BATCH, 77, 768, generator=gen, device=dev).to(torch.bfloat16),
    }
    base = [p.detach().clone() for p in model.parameters()]
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    loha = algo == "loha"
    want = {"flash_fwd": 10, "flash_bwd": 10, "layer_norm_fwd": 48, "layer_norm_bwd": 48,
            "hada_fwd": 192 if loha else 0, "hada_bwd": 192 if loha else 0,
            "factored": 0 if loha else 12}
    secs, losses, totals = [], [], {}
    for _ in range(steps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss = tr.train_step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = read_counts()
        if counts != want:
            fail(f"{tag} launch counts per step {counts} != {want}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        losses.append(float(loss))
        if not math.isfinite(losses[-1]):
            fail(f"{tag} loss {losses[-1]} at step {len(losses)}")
    log(f"{tag} launches per step {want} over {steps} steps")
    for name in KERNELS:
        if want.get(name) and not results[name]["launches"]:
            results[name]["launches"] = totals[name]
    unchanged = [k for k, p in net.named_parameters() if torch.equal(p.detach(), before[k])]
    if unchanged:
        fail(f"{tag} {len(unchanged)} adapter parameters did not change, e.g. {unchanged[:3]}")
    if not all(torch.equal(p, b) for p, b in zip(model.parameters(), base)):
        fail(f"{tag} the frozen base weights changed")
    steady = secs[1:]
    log(f"{tag} SD1.5 b{TRAIN_BATCH} 64x64, {len(net.loras)} adapters: losses "
        f"{[round(x, 5) for x in losses]}; s/step {[round(x, 4) for x in secs]} (the first "
        f"includes warm-up); steady {min(steady):.4f}-{max(steady):.4f} s/step, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card}; host-bound smoke "
        f"reading, not a benchmark)")
    results["training"][algo] = {"s_per_step": secs, "losses": losses}
    net.restore()
    del tr, net, base, before
    torch.cuda.empty_cache()


def phase_train_e2e(model, sd):
    """One eps-MSE loss and every LoKr adapter gradient at full width,
    batch 1: the card (bf16, kernels, factored backward) against the port on
    the CPU (fp32, plain versions), with the same noise and timestep."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel, sd15_config
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    lat = torch.randn(1, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, 77, 768, generator=gen, device=dev).to(torch.bfloat16)
    noise = torch.randn(1, 4, 64, 64, generator=gen, device=dev)
    t = torch.tensor([501], dtype=torch.long, device=dev)

    def loss_and_grads(m, net, wd, args):
        tr = DiffusionTrainer(m, net, weight_dtype=wd)
        loss = tr.loss_fn(*args)
        loss.backward()
        grads = {f"{ln}.{k}": p.grad.float().cpu()
                 for ln, sub in net.trainable_params().items() for k, p in sub.items()}
        net.restore()
        return float(loss.detach()), grads

    net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
    got_loss, got = loss_and_grads(model, net, torch.bfloat16, (lat, ctx, noise, t))
    del net
    torch.cuda.empty_cache()

    cpu = UNet2DConditionModel(sd15_config(torch.float32), device="meta")
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()}, assign=True)
    net_cpu, _ = create_lycoris_from_weights(
        1.0, None, cpu, weights_sd={k: v.float().cpu() for k, v in sd.items()}, device="cpu")
    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(
        cpu, net_cpu, torch.float32, (lat.float().cpu(), ctx.float().cpu(), noise.cpu(), t.cpu()))
    secs = time.perf_counter() - t0
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    g = torch.cat([got[k].reshape(-1) for k in want])
    w = torch.cat([want[k].reshape(-1) for k in want])
    grad_rel = float((g - w).norm() / w.norm())
    per_module = {}
    for k in want:
        ln = k.rsplit(".", 1)[0]
        e, n = per_module.get(ln, (0.0, 0.0))
        per_module[ln] = (e + float((got[k] - want[k]).norm()) ** 2,
                          n + float(want[k].norm()) ** 2)
    worst = max(per_module, key=lambda ln: per_module[ln][0] / max(per_module[ln][1], 1e-30))
    e, n = per_module[worst]
    # bounds: bf16 activations and weights through the forward and the
    # backward of ~100 layers (8-bit mantissa, ~4e-3 per rounding), against fp32
    log(f"[train_e2e] loss card bf16 {got_loss:.6f} vs CPU fp32 {want_loss:.6f}: rel "
        f"{loss_rel:.3e} (bound 3e-2); adapter gradient ({g.numel()} values, "
        f"{len(per_module)} modules) rel L2 {grad_rel:.3e} (bound 5e-2); worst module "
        f"{worst} rel L2 {(e / n) ** 0.5:.3e}; CPU loss+backward {secs:.1f} s")
    if not (loss_rel <= 3e-2 and grad_rel <= 5e-2 and bool(torch.isfinite(g).all())):
        fail(f"train_e2e loss rel {loss_rel:.3e} / gradient rel L2 {grad_rel:.3e} over bound")


def main() -> int:
    if not (ROOT / "lycoris_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: lycoris_tpu_torch/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1

    results = {name: {"launches": 0, "max_abs_err": 0.0, "ms": 0.0, "host_ms": 0.0,
                      "plain_ms": 0.0, "bound_ms": 0.0, "bound_parts": {}, "library_ms": None}
               for name in KERNELS}
    results["serving"], results["training"] = {}, {}
    card = phase_build()
    phase_kernels(results)
    phase_kernels_bwd(results)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = build_unet(torch.device("cuda"), torch.bfloat16, seed=0)
    log(f"[unet] SD1.5 full width, bf16, {sum(p.numel() for p in model.parameters())} "
        f"params drawn on the card in {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        sd_lokr = adapter_state_dict(model, "lokr", torch.device("cuda"), seed=1)
        sd_loha = adapter_state_dict(model, "loha", torch.device("cuda"), seed=2)
    serve(model, "lokr", sd_lokr, requests=3, steps=20, results=results, card=card)
    serve(model, "loha", sd_loha, requests=3, steps=10, results=results, card=card)
    phase_e2e(model, sd_lokr)
    train(model, "lokr", sd_lokr, steps=5, results=results, card=card)
    train(model, "loha", sd_loha, steps=3, results=results, card=card)
    phase_train_e2e(model, sd_lokr)

    for name in KERNELS:
        if results[name]["launches"] <= 0:
            fail(f"{name} was never launched on the main path")
    log(f"[serving] {json.dumps(results['serving'])}")
    log(f"[training] {json.dumps(results['training'])}")
    table = []
    for name, meta in KERNELS.items():
        r = results[name]
        table.append({"name": name, "route": meta["route"], "source": meta["source"],
                      "replaces": meta["replaces"], "launches": r["launches"],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                      "host_ms": r["host_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": max(r["bound_parts"], key=r["bound_parts"].get),
                      "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
