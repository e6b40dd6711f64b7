#!/usr/bin/env python3
"""Where one UNet call of the serving loop spends its time, on one CUDA card.

    python3 profile_serving.py

Uses ``chip_smoke.py``'s SD1.5 UNet (full width, bf16, seeded random
weights) and its seeded LoKr attn-mlp adapter, at the serving batch of 4
(2 prompts with classifier-free guidance), 64x64 latents, 77 context tokens.

1. Host clock and CUDA events per UNet call, base model / LoKr live
   (merged forward) / weights merged with ``merge_to``: 3 warm-up calls, then
   10 timed calls each, every call ending in ``torch.cuda.synchronize()``.
2. torch.profiler over 3 calls with LoKr live: device time per call by kind
   of kernel and kernels per call. The full kernel list goes to
   ``chiprun_out/profile_serving.json``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIMED_CALLS = 10
PROFILED_CALLS = 3

# kernel kinds, matched in order against the lower-cased kernel name
KINDS = (
    ("flash_fwd (ours)", ("flash_fwd",)),
    ("flash_bwd (ours)", ("flash_bwd", "flash_di")),  # with its di = rowsum(dO * O) kernel
    ("LayerNorm (ours)", ("ln_fwd",)),  # both variants
    ("LayerNorm bwd (ours)", ("ln_bwd",)),
    ("hada (ours)", ("hada_fwd",)),
    ("hada bwd (ours)", ("hada_bwd",)),
    ("GroupNorm (ours)", ("gn_fwd_",)),
    ("GroupNorm bwd (ours)", ("gn_bwd_",)),
    ("GEGLU bwd (ours)", ("geglu_bwd",)),
    ("convolution (cuDNN)", ("fprop", "convolve", "conv2d", "winograd", "cudnn")),
    ("GEMM (cuBLAS/CUTLASS)", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
)
OTHER = "elementwise, copy and other"


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return OTHER


def time_calls(model, args, n):
    """Host ms and CUDA-event ms of ``n`` synchronized UNet calls."""
    import torch

    host, dev = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        model(*args)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return host, dev


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from lycoris_tpu_torch import create_lycoris_from_weights

    card = chip_smoke.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = chip_smoke.build_unet(dev, torch.bfloat16, seed=0)
    gen = torch.Generator(device=dev).manual_seed(3)
    args = (torch.randn(4, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16),
            torch.full((4,), 501, dtype=torch.int32, device=dev),
            torch.randn(4, 77, 768, generator=gen, device=dev).to(torch.bfloat16))

    with torch.no_grad():
        sd = chip_smoke.adapter_state_dict(model, "lokr", dev, seed=1)
        net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
        net.to(dev)
        report = {"card": card, "calls": {}}
        for mode in ("base", "lokr_live", "merged"):
            if mode == "lokr_live":
                net.apply_to(merged_forward=True)
            elif mode == "merged":
                net.restore()
                net.merge_to(1.0)
            time_calls(model, args, 3)
            host, event = time_calls(model, args, TIMED_CALLS)
            report["calls"][mode] = {"host_ms": host, "event_ms": event}
            print(f"[time] {mode}: host ms per UNet call median {statistics.median(host):.2f} "
                  f"(min {min(host):.2f}, max {max(host):.2f}); CUDA events median "
                  f"{statistics.median(event):.2f} ({card})", flush=True)
            if mode == "lokr_live":
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(PROFILED_CALLS):
                        model(*args)
                    torch.cuda.synchronize()

    kernels = []
    for evt in prof.key_averages():
        # user annotations (e.g. ``Optimizer.step#AdamW.step``) span kernels
        # listed on their own: counting them too would count that time twice
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append({"name": evt.key, "device_us": us, "count": evt.count})
    if not kernels:
        print("profile_serving: the profiler recorded no device kernels", file=sys.stderr)
        return 1
    kernels.sort(key=lambda k: -k["device_us"])
    by_kind: dict[str, float] = {}
    for k in kernels:
        by_kind[kind_of(k["name"])] = by_kind.get(kind_of(k["name"]), 0.0) + k["device_us"]
    total_ms = sum(by_kind.values()) / 1e3 / PROFILED_CALLS
    n_per_call = sum(k["count"] for k in kernels) / PROFILED_CALLS
    print(f"[profile] LoKr live, device ms per UNet call by kind ({card}):", flush=True)
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {kind}: {us / 1e3 / PROFILED_CALLS:.3f}")
    print(f"[profile] all kernels {total_ms:.3f} ms per call, {n_per_call:.0f} kernels per call")
    report["profile"] = {"by_kind_ms_per_call": {k: v / 1e3 / PROFILED_CALLS
                                                 for k, v in by_kind.items()},
                         "kernels_per_call": n_per_call, "kernels": kernels}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_serving.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
