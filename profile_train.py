#!/usr/bin/env python3
"""Where one adapter train step spends its time, on one CUDA card.

    python3 profile_train.py

Uses ``chip_smoke.py``'s SD1.5 UNet (full width, bf16, seeded random
weights) and its seeded LoKr, LoHa and LoRA attn-mlp adapters, trained by
``DiffusionTrainer`` at batch 8, 64x64 latents, 77 context tokens. Legs:
LoKr (its 12 widest layers through the factored backward), LoHa, LoKr
with the factored backward off (``FACTORED_MIN`` above every layer, so all
192 layers train by autograd through W + dW), LoKr with
``chip_smoke.DROPOUT_RATES`` (rank and module dropout: every layer on its
delta-over-base forward), and LoRA (dim 8, the same 12 layers factored);
then, the SD1.5 model freed, ``sdxl_lokr``, ``sdxl_lora`` and
``sdxl_loha``: the SDXL UNet (``remat="transformer"``) with a LoKr, LoRA
or LoHa adapter at batch 4, 128x128 latents, context (4, 77, 2048) and
``added_cond`` (4, 2816). For each leg:

1. host clock per step over 5 steps after 2 warm-up steps, every step
   ending in ``torch.cuda.synchronize()``;
2. torch.profiler over 2 steps: device time per step by kind of kernel and
   kernels per step;
3. for the dropout leg, the dropout draws per step and the host
   microseconds of one draw's generator: reseeding the device's generator
   (``modules.base.draw_generator``) beside building a fresh CUDA generator
   for each draw.

The full kernel lists go to ``chiprun_out/profile_train.json``.
"""

from __future__ import annotations

import json
import statistics
import timeit
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WARMUP_STEPS = 2
TIMED_STEPS = 5
PROFILED_STEPS = 2


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from profile_serving import kind_of
    from lycoris_tpu_torch.functional import merged
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    card = chip_smoke.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = chip_smoke.build_unet(dev, torch.bfloat16, seed=0)
    gen = torch.Generator(device=dev).manual_seed(3)
    b = chip_smoke.TRAIN_BATCH
    batch = {"latents": torch.randn(b, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16),
             "context": torch.randn(b, 77, 768, generator=gen, device=dev).to(torch.bfloat16)}
    report = {"card": card, "batch": {"sd15": b, "sdxl": chip_smoke.SDXL_BATCH}, "steps": {}}
    factored_min = merged.FACTORED_MIN

    sds = {}
    with torch.no_grad():
        for seed, algo in ((1, "lokr"), (2, "loha"), (6, "lora")):
            sds[algo] = chip_smoke.adapter_state_dict(model, algo, dev, seed=seed)
    legs = [("lokr", "lokr"), ("loha", "loha"), ("lokr_dense", "lokr"),
            ("lokr_dropout", "lokr"), ("lora", "lora"), ("sdxl_lokr", "lokr"),
            ("sdxl_lora", "lora"), ("sdxl_loha", "loha")]
    for leg, algo in legs:
        if leg == "sdxl_lokr":  # the SD1.5 model freed first
            del model, sds, batch
            torch.cuda.empty_cache()
            model = chip_smoke.build_unet(dev, torch.bfloat16, seed=3, config="sdxl",
                                          remat="transformer")
            with torch.no_grad():
                sds = {"lokr": chip_smoke.adapter_state_dict(model, "lokr", dev, seed=4),
                       "lora": chip_smoke.adapter_state_dict(model, "lora", dev, seed=8),
                       "loha": chip_smoke.adapter_state_dict(model, "loha", dev, seed=5)}
            batch = chip_smoke.sdxl_batch()
        net = chip_smoke.make_net(model, sds[algo], algo,
                                  chip_smoke.DROPOUT_RATES if leg == "lokr_dropout" else None)
        merged.FACTORED_MIN = 1 << 30 if leg == "lokr_dense" else factored_min
        tr = DiffusionTrainer(model, net, lr=1e-4, weight_dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WARMUP_STEPS):
            tr.train_step(batch)
        torch.cuda.synchronize()
        host = []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                tr.train_step(batch)
            torch.cuda.synchronize()
        if leg == "lokr_dropout":
            report["draws"] = draw_costs(tr, batch, card)
        net.restore()
        del tr, net

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
            print("profile_train: the profiler recorded no device kernels", file=sys.stderr)
            return 1
        kernels.sort(key=lambda k: -k["device_us"])
        by_kind: dict[str, float] = {}
        for k in kernels:
            by_kind[kind_of(k["name"])] = by_kind.get(kind_of(k["name"]), 0.0) + k["device_us"]
        total_ms = sum(by_kind.values()) / 1e3 / PROFILED_STEPS
        n_per_step = sum(k["count"] for k in kernels) / PROFILED_STEPS
        med = statistics.median(host)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[time] {leg}: host ms per step median {med:.2f} (min {min(host):.2f}, "
              f"max {max(host):.2f}); peak memory {peak:.2f} GiB ({card})", flush=True)
        print(f"[profile] {leg}: device ms per train step by kind ({card}):", flush=True)
        for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"[profile]   {kind}: {us / 1e3 / PROFILED_STEPS:.3f}")
        print(f"[profile] {leg}: all kernels {total_ms:.3f} ms per step, {n_per_step:.0f} "
              f"kernels per step", flush=True)
        report["steps"][leg] = {
            "host_ms": host, "peak_gib": peak,
            "by_kind_ms_per_step": {k: v / 1e3 / PROFILED_STEPS for k, v in by_kind.items()},
            "kernels_per_step": n_per_step, "kernels": kernels,
        }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_train.json").write_text(json.dumps(report, indent=1))
    return 0


def draw_costs(tr, batch, card) -> dict:
    """Dropout draws in one train step of ``tr``, and host us per draw of
    its generator: the device's generator reseeded, as the modules draw,
    beside a fresh CUDA generator built and seeded."""
    import torch
    from lycoris_tpu_torch.modules import base

    draw_generator, draws = base.draw_generator, [0]

    def counted(*args):
        draws[0] += 1
        return draw_generator(*args)

    base.draw_generator = counted
    try:
        tr.train_step(batch)
        torch.cuda.synchronize()
    finally:
        base.draw_generator = draw_generator
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 2000
    reseed_us = timeit.timeit(lambda: draw_generator(7, base.RANK_SALT, dev), number=n) / n * 1e6
    fresh_us = timeit.timeit(lambda: torch.Generator(device=dev).manual_seed(
        base.fold_in(7, base.RANK_SALT)), number=n) / n * 1e6
    print(f"[draws] lokr_dropout: {draws[0]} draws per train step; host us per draw's "
          f"generator: reseeded {reseed_us:.2f}, built fresh {fresh_us:.2f} ({card})",
          flush=True)
    return {"per_step": draws[0], "reseed_us": reseed_us, "fresh_us": fresh_us}


if __name__ == "__main__":
    sys.exit(main())
