#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lycoris_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; the first failure ends the run with a
nonzero exit code, and no phase falls back to the CPU:

1. build  -- compile the CUDA kernels from ``lycoris_tpu_torch/csrc`` and
   print the card's name and power limit (nvidia-smi);
2. kernels -- each kernel against its plain PyTorch version at the serving
   path's shapes, in bf16 and fp32 (MSE and max-abs bounds), with CUDA-event
   timings of both;
3. lokr  -- full-width SD1.5 UNet (bf16, random seeded weights), a LoKr
   attn-mlp adapter loaded from a state dict, DDIM 20 steps with CFG for
   3 requests of 2 prompts; counts the kernel launches per UNet call and
   holds the live-adapter output against the merged-weight output;
4. loha  -- the same with a LoHa adapter, fewer steps;
5. e2e   -- one UNet call on the card (bf16, kernels) against the port on
   the CPU (fp32, plain versions) with the same weights.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def phase_kernels(results: dict):
    import torch
    from lycoris_tpu_torch.ops import flash, hada, layer_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def compare(dtype, got, want):
        err = got.float() - want.float()
        mse = float((err * err).mean())
        mx = float(err.abs().max())
        rel = float(err.norm() / want.float().norm())
        scale = float(want.float().abs().max())
        dt = str(dtype).replace("torch.", "")
        ok = (bool(torch.isfinite(got.float()).all()) and mse <= MSE_BOUND[dt]
              and rel <= REL_L2_BOUND[dt] and mx <= MAX_ABS_REL_BOUND[dt] * scale)
        return ok, mse, mx, rel, scale, dt

    def record(name, ok, mse, mx, rel, scale, dt, shape_s, ms, plain_ms, per_call):
        log(f"[kernels] {name} {dt} {shape_s}: mse {mse:.3e} rel_l2 {rel:.3e} "
            f"max_abs {mx:.3e} (max|ref| {scale:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not ok:
            fail(f"{name} {dt} {shape_s}: mse {mse:.3e} / rel_l2 {rel:.3e} / "
                 f"max_abs {mx:.3e} of max|ref| {scale:.3e} over bound")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], mx)
        if per_call:
            r["ms"] += ms * per_call
            r["plain_ms"] += plain_ms * per_call

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
            ms = time_ms(lambda: flash.flash_attention(q, k, v, sm), iters)
            pms = time_ms(lambda: flash.flash_attention_plain(q, k, v, sm), iters)
            record("flash_fwd", ok, mse, mx, rel, scale, dt, f"(32,{t},{d})", ms, pms,
                   per_call if dtype == torch.bfloat16 else 0)

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
            ms = time_ms(lambda: layer_norm.layer_norm(x, w, b, 1e-5), 100)
            pms = time_ms(lambda: layer_norm.layer_norm_plain(x, w, b, 1e-5), 100)
            record("layer_norm_fwd", ok, mse, mx, rel, scale, dt, f"({UNET_BATCH * t},{c})",
                   ms, pms, per_call if dtype == torch.bfloat16 else 0)

    # LoHa dW: rank 8, adapter params fp32 on the path (bf16 checked too)
    for (o_, i_, per_call) in _hada_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            w1d, w2d = rnd((8, i_), dtype), rnd((8, i_), dtype)
            w1u, w2u = rnd((o_, 8), dtype, 0.1), rnd((o_, 8), dtype, 0.1)
            out = hada.hada_weight(w1d, w1u, w2d, w2u, 0.5)
            ref = hada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5)
            torch.cuda.synchronize()
            ok, mse, mx, rel, scale, dt = compare(dtype, out, ref)
            ms = time_ms(lambda: hada.hada_weight(w1d, w1u, w2d, w2u, 0.5), 100)
            pms = time_ms(lambda: hada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5), 100)
            record("hada_fwd", ok, mse, mx, rel, scale, dt, f"({o_},{i_})", ms, pms,
                   per_call if dtype == torch.float32 else 0)


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
    from lycoris_tpu_torch.ops import flash, hada, layer_norm

    flash.launches = layer_norm.launches = hada.launches = 0


def read_counts() -> dict:
    from lycoris_tpu_torch.ops import flash, hada, layer_norm

    return {"flash_fwd": flash.launches, "layer_norm_fwd": layer_norm.launches,
            "hada_fwd": hada.launches}


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
            "hada_fwd": (n_mod * calls) if algo == "loha" else 0}
    log(f"{tag} launches {counts} over {calls} UNet calls (want {want})")
    if counts != want:
        fail(f"{tag} launch counts {counts} != {want}")
    for name in KERNELS:  # each kernel's count from the first leg that runs it
        if want[name] and not results[name]["launches"]:
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


def main() -> int:
    if not (ROOT / "lycoris_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: lycoris_tpu_torch/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1

    results = {name: {"launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for name in KERNELS}
    results["serving"] = {}
    card = phase_build()
    phase_kernels(results)
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

    for name in KERNELS:
        if results[name]["launches"] <= 0:
            fail(f"{name} was never launched on the main path")
    log(f"[serving] {json.dumps(results['serving'])}")
    table = []
    for name, meta in KERNELS.items():
        r = results[name]
        table.append({"name": name, "route": meta["route"], "source": meta["source"],
                      "replaces": meta["replaces"], "launches": r["launches"],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
