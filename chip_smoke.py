#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lycoris_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines and its wall time; the first failure
ends the run with a nonzero exit code, and no phase falls back to the CPU:

1. build  -- compile the CUDA kernels from ``lycoris_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once), print each flash and LayerNorm
   forward kernel's registers and spilled bytes from the ptxas report (a
   spill fails the run), and
   print the card's name and power limit (nvidia-smi);
2. kernels -- each forward kernel against its plain PyTorch version at the
   shapes of two paths: SD1.5 serving (UNet batch 4, 64x64 latents; bf16
   and fp32) and SDXL training (batch 4, 128x128 latents; the path's
   dtype), under MSE, relative L2 and max-abs bounds; the path's dtype is
   timed: device times (calls captured in a CUDA graph and replayed between
   CUDA events) of the kernel, its plain version and the PyTorch library
   call where one computes the same function, and the wrapper's
   host-clocked time beside.
   Flash is checked on the UNet's layout (q, k, v head-split views of a
   (B, T, H*D) tensor; its times fill the row, with the share of the bound
   and the ratio to SDPA) and on contiguous inputs (kernel time logged).
   The timed flash and LayerNorm rows run on rotating copies of their
   inputs over 200 MB with the outputs held (the plain version and the
   library call on the same copies), so the inputs come from HBM.
   Every LayerNorm shape must take the vectorised variant in bf16; its
   rows add the generic variant's time on the same copies, the plan
   (lanes, warps a block, blocks) and the launches per call or step.
   The fused LoRA matmul (nt) at every adapted linear shape (M, N, K) of
   the SD1.5 b8 and SDXL b4 LoRA training legs, bf16 (the fast variant,
   which every bf16 call must take) and fp32 (the generic one), its
   library time the merged route the path runs (W + dW merged in fp32,
   then one bf16 matmul); the bf16 rows are timed on rotating copies of
   x, W and the factors with the outputs held, the library on the same
   copies;
3. kernels_bwd -- each backward kernel likewise at SD1.5 training (batch 8)
   and SDXL training (batch 4) shapes: flash dq/dk/dv, LayerNorm dx/dw/db
   (every path shape through the vectorised variant; the dx-only call timed
   against ``F.layer_norm``'s backward, the dw/db call once per dtype, each
   timed call on its own copy of x and dy, in turn, so that the inputs
   come from HBM and not from L2),
   LoHa's four grads (fused1; and the split form, fp32 and bf16, its fast
   variant, which every path shape must take, also held to the fused1
   kernel's grads and its generic variant to the plain version, the fp32
   rows timed on rotating copies: fast, generic, plain and fused1, and the
   fast variant's three launches by torch.profiler), GroupNorm dx/dgamma/dbeta (fast and generic
   variants; every path shape on the fast one, and the dx-only call of
   each, the path's, timed on rotating copies of x and dh as the LayerNorm
   backward, beside the generic variant and the library call on the same
   copies; the forward likewise in phase 2, also at the SD1.5 b8 train
   shapes), GEGLU d_hfull (timed on rotating copies of h_full and dy), the
   fused LoRA matmul's dx (nn; its library the merged route's dx GEMM,
   timed as nt's). Every LoHa path shape must take the fast
   (rank-8) variant of the forward and the fused backward; their rows are
   timed as the LayerNorm backward's, on rotating copies of the factors
   and g with the outputs held, so inputs and outputs are not in L2. The
   phase ends with LoHa at rank 128 (1280, 1280) through the generic
   forward and fused backward and the split backward, and both fused LoRA
   kernels at rank 320 (4096, 1280, 1280), against their plain versions,
   then logs the LoRA route rows: per SDXL b4 and SD1.5 b8 step, the fused
   nt at each layer's forwards plus nn, against the merged route's merge
   and matmul as often plus its dx GEMM;
4. lora_fused_op -- the public differentiable op ``fused_lora_matmul`` at
   those shapes, forward and backward (bf16), against autograd of its
   plain version: the path its kernels' launches are read from (neither
   package dispatches it on the adapter path); fails unless every launch
   took the fast variant;
5. lokr  -- full-width SD1.5 UNet (bf16, random seeded weights), a LoKr
   attn-mlp adapter loaded from a state dict, DDIM 20 steps with CFG for
   3 requests of 2 prompts; counts the kernel launches per UNet call and
   holds the live-adapter output against the merged-weight output;
6. loha  -- the same with a LoHa adapter, fewer steps;
7. lora  -- the same with a LoRA adapter (the default algorithm), 20 steps;
8. e2e   -- one UNet call on the card (bf16, kernels) against the port on
   the CPU (fp32, plain versions) with the same weights;
9. train_lokr -- ``DiffusionTrainer`` AdamW steps on the LoKr adapter at
   batch 8, 64x64 latents: launches per step of every kernel and of the
   factored backward, finite loss, every adapter changed, base unchanged;
10. train_loha, train_lora -- the same with the LoHa and LoRA adapters;
11. train_locon_conv -- LoCon on the kohya "full" UNet targets (the
   transformers, resnets, down/upsamplers, conv_in/out, the time
   embedding; 3x3 convs with conv_dim 8): the adapted-layer hand count and
   the checks of phase 9;
12. train_loha_split -- LoHa with ``ops.hada.BWD = "split"``: the split
   kernels in place of fused1 (every launch on the fast variant), then one
   loss and the adapter grads at b8 held to fused1's;
13. train_lokr_dropout -- LoKr with rank dropout 0.25 and module dropout
   0.1, 3 steps: every adapted layer takes its delta forward (the LoKr
   launch counts with factored 0); the parameters of every module kept in
   some step change, those of a module dropped in all stay; one step's
   adapter gradients repeat for one drop seed and differ for another;
14. train_e2e, train_e2e_lora -- one loss and every adapter gradient (LoKr,
   LoRA) at batch 1, card (bf16, kernels) against the port on the CPU
   (fp32, plain versions);
15. train_e2e_dora -- phase 14 for DoRA LoHa and DoRA LoKr (``dora_wd``;
   the merged route with plain autograd, ``dora_scale`` among the
   gradients);
16. files -- the LoKr adapter trained in phase 9 and a DoRA LoHa adapter
   saved by ``save_weights`` (.safetensors fp32 with metadata and bf16, .pt
   fp32): keys, dtypes and metadata read back (the safetensors header
   parsed by the port's own reader), a network built on the card from each
   file (bit for bit from the fp32 files; one UNet call against the live
   adapters' within rel L2 1e-3, bf16 within 3e-2), ``onfly_merge`` against
   the live adapters and ``onfly_restore`` bit for bit; then a trainer
   checkpoint after 2 LoKr steps loaded into a fresh trainer: adapter
   tensors, AdamW state, step and both generators bit for bit;
17. train_ia3, train_glora, train_dylora, train_full -- (IA)^3 (the ``ia3``
   preset), GLoRA, DyLoRA (block_size 2) and Full on the attn-mlp targets
   at b8, 2 steps each with the checks of phase 9 (no adapter kernel,
   factored 0; DyLoRA's network trained as built, its files load as LoCon),
   then one step under torch.profiler: s/step, device ms and kernels a
   step, and peak memory (Full's fp32 deltas and their AdamW moments);
18. train_e2e_oft -- phase 14 for Diag-OFT (dim 8, constraint 1e-4,
   rescaled), BOFT (dim 16) and LoRA with ``train_norm``;
19. train_sdxl_lora -- the SD1.5 model freed, a full-width SDXL UNet (bf16,
   random seeded weights, ``remat="transformer"``) trains LoRA at batch 4,
   128x128 latents, context (4, 77, 2048), ``added_cond`` (4, 2816): the
   checks of phase 9, and the peak memory;
20. train_sdxl_lokr, train_sdxl_loha -- the same with LoKr and LoHa;
21. train_sdxl_dora_loha -- DoRA LoHa with the trainer's max-norm
   (``scale_weight_norms``) at half the median of the modules' dW norms, 3
   steps: the checks of phase 9 with the max-norm pass's LoHa forwards in
   the hand count (on the fast variant), at least one module scaled and
   every module's norm at most the limit after each step; then one step
   without the pass, one with it, and the pass alone, host-clocked;
22. train_sdxl_premerge -- LoKr with ``merge_mode="premerge"``: one loss and
   every adapter gradient against the interceptor route (phase 14's
   bounds), then 2 steps with the checks of phase 9 (factored 0), s/step
   and peak memory beside train_sdxl_lokr's;
23. train_sdxl_oft -- Diag-OFT (dim 8, constraint 1e-4, rescaled) on the
   SDXL attn-mlp targets at b4: 3 steps with the checks of phase 9 (the
   UNet's own launches, factored 0), one profiled step (s/step, device ms
   and kernels a step, peak memory), and the adapters' own work alone: the
   722 merged weights (Cayley transform and rotation) formed, and formed
   and differentiated, device ms and kernels by torch.profiler;
24. train_sdxl_boft -- the same for BOFT at dim 16 (blocks of 10, 7 to 11
   stages), then its two forms of the rotation (the dense Q and the direct
   chain) forward and backward at the weights (1280, 1280) and (10240,
   1280), each form at each, timed and held to each other;
25. train_sdxl_norm -- LoRA (dim 8) with ``train_norm``: 722 LoRA layers
   and 221 Norm modules (210 LayerNorms, 11 Transformer2DModel
   GroupNorms), 3 steps with the checks of phase 9 and every norm backward
   on the dw/db side of its fast variant (GroupNorm backward 40 a step: the
   first Transformer2DModel's norm now trains), one profiled step; then
   the LayerNorm and GroupNorm backwards with dw/db at the step's shapes
   against their plain versions, timed on rotating copies against
   ``F.layer_norm``'s and ``F.group_norm``'s autograd backwards for x,
   weight and bias (the ``*_bwd_wb`` rows of the kernel line);
26. train_sdxl_e2e, train_sdxl_e2e_lora -- phase 14 on the SDXL model at
   64x64 latents;
27. kohya_sdxl -- the kohya front end at full width: ``create_network``
   (LoKr factor 8, attn-mlp) over CLIP-L, CLIP-G (bf16) and the SDXL UNet,
   the adapters of each tree held to its config (72, 192, 722); the
   encoders on b4 x 77 token ids, each call's LayerNorms on the variant
   ``fwd_plan`` names (CLIP-L's C = 768 generic, CLIP-G's 1280 vectorised);
   3 UNet steps through ``sub_networks["lora_unet"]`` with the checks of
   phase 9; ``save_weights`` (fp16) with ``sshs_model_hash`` equal to the
   hash of the file's tensors; ``create_network_from_weights`` on fresh
   models: the encoders and a UNet call within rel L2 3e-2 of the live
   network; ``merge_to``: the plain encoders within 1e-3 of the live ones;
28. train_toml_sdxl_lokr -- ``python -m lycoris_tpu_torch.train`` (its
   ``main``) on ``example_configs/training_configs/lokr_sdxl_tpu.toml``
   (SDXL, remat=True, b2, 128x128) for 3 steps, ``output_dir`` in a
   temporary copy: finite losses, every kernel on its planned variant, the
   saved file reloaded by ``create_network_from_weights``;
29. train_toml_sd15_loha -- the same on ``loha_tpu.toml`` (SD1.5 b8, LoHa
   dim 16): every LoHa launch on the generic variant (the fast one is rank
   8);
30. tools_sdxl -- the tools. Extract on full-width SD1.5 in fp32 (the full
   SDXL extract's SVDs alone outlast this phase; ``profile_tools.py`` times
   it): a tuned copy with LoRA dim 8 on the attn-mlp targets and conv
   LoCon dim 4 on the ResNet 3x3 convs merged in by ``merge_to``;
   ``extract_diff`` on the card (fixed, dims 8 and 4, no CP pass; its SVD
   groups, seconds and peak memory logged, and torch's default driver,
   cuSOLVER gesvdj, timed beside the extract's gesvd on the slowest
   group), the file
   reloaded by ``create_lycoris_from_weights``, one layer per adapted
   layer, each dW within rel L2 1e-2 of the true delta; the CP pass
   (``small_conv``) on two 3x3 convs of each shape group, card against the
   CPU within 1e-3; both state dicts saved and the extract_locon and merge
   CLIs run on them as subprocesses beside the CP pass, the extracted file
   equal to the in-process one bit for bit, the merged one within fp32
   rounding. Then on full-width SDXL in bf16: seeded LoHa and
   LoKr files merged into its state dict by ``utils.merge.merge`` (each
   layer within 1e-3 of ``merge_to`` on a copy; the LoHa merge's
   ``hada_fwd`` launches one a layer ``ops.hada.supported`` admits, 722,
   and the kernel held to ``hada_weight_plain`` at the merge shapes, fp32
   bounds, and timed), one b4 UNet call on the merged weights within 3e-2
   of the live network; the transformer blocks' 700 Linears swapped for
   ``Int8Linear`` with LoKr over them (each quantized layer's adapter in
   bypass mode, a b4 call within 3e-2 of the dequantized bf16 model with
   the same adapters live, ``merge_to`` leaving the int8 weights bit for
   bit); a bundle pack/unpack and an HCP round trip of the LoHa file bit
   for bit.

Phase 2 also holds the LayerNorm forward at the CLIP encoders' shapes (b4
x 77 rows; C = 768 and 1280; bf16 timed), whose rows join the kernel line's
``shapes`` under path "clip" with their sums per CLIP-L + CLIP-G call
(``clip``), outside the UNet sums.

Every serving and training leg fails if a flash input took the padded
copy (``flash.pad_copies``): the UNets' layouts are read by TMA in place.
Every serving and training leg (and the e2e comparisons) fails unless each
UNet LayerNorm forward and backward took the vectorised variant, every LoHa
leg (serving and training) unless each LoHa forward, fused backward and split
backward took the fast variant (the generic one in train_toml_sd15_loha), and
every serving and training leg unless each GroupNorm forward and backward
took the fast variant.

The line before the last is the kernel table as JSON. Each kernel names the
path its launches are read from (``path``): SDXL training (the first SDXL
leg that runs it) for the kernels of the adapter path, ``lora_fused_op`` for
the fused LoRA matmul, ``train_loha_split`` for the split LoHa backward,
``train_sdxl_norm`` for the LayerNorm and GroupNorm backwards that form dw
and db (``layer_norm_bwd_wb``, ``group_norm_bwd_wb``); the run fails if a
kernel was never launched there. The ``hada_fwd`` entry also has
``merge``: the LoHa file merge's launches, its seconds, and the kernel's,
plain version's and bound's device ms per merge, in total and per shape. Times are device ms per SDXL
train step (kernel, plain, library, bound; each shape's time weighted by
its launches, or for the fused LoRA matmul and the split LoHa backward,
which no SDXL step dispatches, its layers per step: ``per`` says which), with the
SD1.5 sums (per serving UNet call for the forward kernels, per batch-8 train
step for the backward ones and the fused LoRA matmul) under "sd15"; the
LayerNorm forward row adds the generic variant's sums (``generic_ms``),
per-shape ``shapes`` and ``variants``; the
GroupNorm rows add the generic variant's sums (``generic_ms``), per-shape
``shapes`` and ``variants``, and the forward the SD1.5 b8 step's sums
(``sd15_b8``); the split LoHa row adds ``variants``, ``shapes`` (each with
the profiler's ``passes_ms``), and the generic variant's and fused1's sums
(``generic_ms``, ``fused1_ms``, also under "sd15"). The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
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

UNET_BATCH = 4  # SD1.5 serving: 2 prompts with classifier-free guidance
TRAIN_BATCH = 8  # SD1.5 training
SDXL_BATCH = 4  # SDXL training, 128x128 latents
SDXL_HW = 128
SDXL_ADDED = 2816  # SDXL's add_embedding input: pooled text and time ids
CONTEXT_TOKENS = 77  # text-encoder tokens of the context (attn2 k/v rows per sample)
LORA_RANK = 8  # every smoke adapter: dim 8, alpha 4

# published peaks of one H100 SXM (dense): the least time a kernel could take
# is the larger of its operations over the peak for their type and the bytes
# it must move (each input read once, each output written once) over HBM's rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# inputs a rotating timing walks through in one pass: four times the H100's
# 50 MB L2, so that each timed call reads its inputs from HBM, as on the path
ROTATE_BYTES = 200e6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"[{name}] phase wall time {time.perf_counter() - t0:.2f} s")


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


def iters_for(nbytes: float) -> int:
    """Calls per timing graph: about 2 GB of traffic, between 3 and 100."""
    return max(3, min(100, int(2e9 / max(nbytes, 1.0))))


def device_events(fn, calls: int, warmup: int) -> list:
    """The device events (kernels, copies, sets) of ``calls`` calls of ``fn``
    after ``warmup``, traced by torch.profiler. Only the device activity is
    traced, and its raw events are read: a step of 10^5 kernels traced with
    its host ops and read through ``key_averages()`` took minutes to
    post-process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def kernel_totals(fn, calls: int, warmup: int = 1) -> tuple:
    """(device ms, kernels) per call of ``fn``: the device time of every
    event of :func:`device_events` summed; (None, 0) if the profiler saw no
    device time."""
    device = device_events(fn, calls, warmup)
    ns = sum(e.duration_ns() for e in device)
    if not ns:
        return None, 0
    return ns / 1e6 / calls, len(device) / calls


def device_ms_by_kernel(fn, calls: int = 20) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, by the
    kernel's name (:func:`device_events` after two warm-up calls); empty if
    the profiler saw no device time."""
    out = {}
    for e in device_events(fn, calls, 2):
        if e.duration_ns():
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6 / calls
    return out


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
    named = kernel_ptxas(_build.build_log)
    for prefix in ("flash", "ln_fwd"):
        if not any(name.startswith(prefix) for name, _, _ in named):
            fail(f"no {prefix} kernel in the ptxas report")
    for name, regs, spill in named:
        log(f"[build] {name}: {regs} registers, {spill} bytes spilled")
    spilled = [name for name, _, spill in named if spill]
    if spilled:
        fail(f"kernels spill registers: {spilled}")
    log(card)
    return card


def kernel_ptxas(build_log: str) -> list:
    """(kernel, registers, spill bytes stored + loaded) of every flash and
    LayerNorm forward kernel in the ptxas report (``-Xptxas -v``), the
    template argument in <>."""
    out, name, spill = [], None, 0
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"\d+((?:flash|ln_fwd)_[a-z0-9_]+?)"
                          r"I(?:Li(\d+)E|13__nv_(bfloat16)|(f))E", entry.group(1))
            name = m and f"{m.group(1)}<{m.group(2) or m.group(3) or 'float'}>"
            spill = 0
            continue
        st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if st and name:
            spill = int(st.group(1)) + int(st.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append((name, int(regs.group(1)), spill))
            name = None
    return out


# ---------------------------------------------------------------------------
# what the paths run: kernel shapes and launch counts from the UNet config
# ---------------------------------------------------------------------------


def unet_census(cfg, batch: int, hw: int) -> dict:
    """The GroupNorms and Transformer2DModels of one UNet call on ``batch`` x
    4 x ``hw`` x ``hw`` latents, walked block by block as
    ``UNet2DConditionModel.forward`` walks them: "gn" counts (C, S, act) of
    every GroupNorm, "gn_grad" those a gradient reaches under attn-mlp
    adapters (every one after the first adapted layer, the first
    Transformer2DModel's proj_in, which follows that model's own norm),
    "gn_grad_norm" those it reaches when each Transformer2DModel's own norm
    trains too (``train_norm``), "transformers" lists (channels, tokens,
    depth), "resnets" (in, out channels), "samplers" counts the down- and
    upsamplers."""
    gn, gn_grad, gn_grad_norm = Counter(), Counter(), Counter()
    transformers, resnets = [], []
    samplers = 0
    grad = False

    def norm(c, res, act, trained=False):
        gn[(c, res * res, act)] += 1
        if grad:
            gn_grad[(c, res * res, act)] += 1
        if grad or trained:
            gn_grad_norm[(c, res * res, act)] += 1

    def resnet(c_in, c_out, res):
        norm(c_in, res, "silu")
        norm(c_out, res, "silu")
        resnets.append((c_in, c_out))

    def transformer(c, res, depth):
        nonlocal grad
        norm(c, res, None, trained=True)
        transformers.append((c, res * res, depth))
        grad = True

    chs, lpb = cfg.block_out_channels, cfg.layers_per_block
    res, ch_in = hw, chs[0]
    skips = [ch_in]
    for bi, ch in enumerate(chs):
        for _ in range(lpb):
            resnet(ch_in, ch, res)
            ch_in = ch
            if cfg.transformer_depth[bi]:
                transformer(ch, res, cfg.transformer_depth[bi])
            skips.append(ch)
        if bi < len(chs) - 1:
            res //= 2
            skips.append(ch)
            samplers += 1
    resnet(ch_in, ch_in, res)
    if cfg.mid_transformer_depth:
        transformer(ch_in, res, cfg.mid_transformer_depth)
    resnet(ch_in, ch_in, res)
    for bi in reversed(range(len(chs))):
        for _ in range(lpb + 1):
            resnet(ch_in + skips.pop(), chs[bi], res)
            ch_in = chs[bi]
            if cfg.transformer_depth[bi]:
                transformer(ch_in, res, cfg.transformer_depth[bi])
        if bi > 0:
            res *= 2
            samplers += 1
    norm(chs[0], res, "silu")  # conv_norm_out
    return {"gn": gn, "gn_grad": gn_grad, "gn_grad_norm": gn_grad_norm,
            "transformers": transformers, "resnets": resnets, "samplers": samplers}


def path_shapes(cfg, batch: int, hw: int) -> dict:
    """Each kernel's shapes in one UNet call, as Counters of shape ->
    launches: "flash" (B*H, T, D) of the self-attentions that take the flash
    kernel, "ln" (rows, C), "geglu" (B, T, 2F), "hada" (O, I) of the
    attn-mlp adapted layers, "lora" (M, N, K) of their linear layers (M
    rows of x, W (N, K)), "gn"/"gn_grad"/"gn_grad_norm" (C, S, act); "factored" counts the
    LoKr/LoRA layers whose harmonic dimension takes the factored backward,
    "full_adapted" the layers the kohya "full" UNet targets adapt."""
    from lycoris_tpu_torch.functional.merged import worth_factoring
    from lycoris_tpu_torch.ops.attention import use_flash

    census = unet_census(cfg, batch, hw)
    flash, ln, geglu, hada, lora = Counter(), Counter(), Counter(), Counter(), Counter()
    factored = 0
    for ch, t, depth in census["transformers"]:
        heads = ch // cfg.head_dim if cfg.head_dim else cfg.num_heads
        if use_flash(t, t, ch // heads):
            flash[(batch * heads, t, ch // heads)] += depth
        ln[(batch * t, ch)] += 3 * depth
        geglu[(batch, t, 8 * ch)] += depth
        hada[(ch, ch)] += 2  # proj_in, proj_out (1x1 convs)
        # attn1 q/k/v/out and attn2 q/out; attn2 k/v from the context; ff net_0, net_2
        for shape, n, rows in (((ch, ch), 6 * depth, batch * t),
                               ((ch, cfg.context_dim), 2 * depth, batch * CONTEXT_TOKENS),
                               ((8 * ch, ch), depth, batch * t), ((ch, 4 * ch), depth, batch * t)):
            hada[shape] += n
            lora[(rows, *shape)] += n
            factored += n if worth_factoring(*shape) else 0
    # kohya "full": each transformer's 10 linears per block and proj_in/out;
    # each resnet's conv1, conv2, time_emb_proj and a conv_shortcut where the
    # channels change; the down/upsampler convs; conv_in, conv_out and the
    # time embedding's linear_1, linear_2
    full = (sum(10 * depth + 2 for _, _, depth in census["transformers"])
            + sum(3 + (c_in != c_out) for c_in, c_out in census["resnets"])
            + census["samplers"] + 4)
    return {"gn": census["gn"], "gn_grad": census["gn_grad"],
            "gn_grad_norm": census["gn_grad_norm"], "flash": flash, "ln": ln,
            "geglu": geglu, "hada": hada, "lora": lora, "factored": factored,
            "full_adapted": full}


def want_counts(shapes: dict, algo: str, train: bool, remat: bool, split: bool = False,
                full: bool = False, max_norm: bool = False, premerge: bool = False,
                norm: bool = False) -> dict:
    """Launches of every kernel, and factored layer applications, per UNet
    call (serving, no gradient) or per train step. With ``remat`` (the
    Transformer2DModels checkpointed) the backward runs each
    Transformer2DModel's forward again: its flash, LayerNorm and hada
    forwards, its factored layers and its GroupNorm (the act-free one) run
    twice per step. ``split``: LoHa's backward is the split form. ``full``:
    the kohya "full" targets adapt conv_in, so a gradient reaches every
    GroupNorm. ``max_norm``: the trainer's max-norm pass forms every LoHa
    layer's dW once more a step. ``premerge``: every adapter is merged once a
    step before the model runs (no recompute of a merge, no factored
    layer). ``norm`` (``train_norm``): every LayerNorm and each
    Transformer2DModel's GroupNorm train, so their backwards also form dw
    and db, and the first Transformer2DModel's GroupNorm, before any adapted
    layer, runs its backward too. Only LoKr and LoRA/LoCon take the factored
    backward; the other algorithms launch no adapter kernel. The fused LoRA
    matmul is never dispatched on this path."""
    def tot(key):
        return sum(shapes[key].values())

    again = 2 if train and remat else 1
    loha = algo == "loha"
    hada_bwd = tot("hada") if train and loha else 0
    merges = (1 if premerge else again) + (1 if train and max_norm else 0)
    gn_in_transformers = sum(n for (_, _, act), n in shapes["gn"].items() if act is None)
    return {
        "flash_fwd": again * tot("flash"), "layer_norm_fwd": again * tot("ln"),
        "hada_fwd": merges * tot("hada") if loha else 0,
        "group_norm_fwd": tot("gn") + (again - 1) * gn_in_transformers,
        "flash_bwd": tot("flash") if train else 0, "layer_norm_bwd": tot("ln") if train else 0,
        "hada_bwd": 0 if split else hada_bwd,
        "group_norm_bwd": tot("gn" if full else "gn_grad_norm" if norm else "gn_grad")
        if train else 0,
        "geglu_bwd": tot("geglu") if train else 0,
        "lora_fused_nt": 0, "lora_fused_nn": 0,
        "hada_bwd_split": hada_bwd if split else 0,
        "layer_norm_bwd_wb": tot("ln") if train and norm else 0,
        "group_norm_bwd_wb": gn_in_transformers if train and norm else 0,
        "factored": (again * shapes["factored"]
                     if train and has_factored(algo) and not premerge else 0),
    }


# SD1.5 (sd15_config), per UNet call: 16 Transformer2DModels of depth 1 (5 at
# 320 with T4096, 5 at 640 with T1024, 5 at 1280 with T256, the mid at T64):
# flash 10 (the T256/T64 levels take the plain path), LayerNorm 48, GEGLU 16,
# adapted layers 16 x 12 = 192, factored LoKr layers 6 x 2 = 12 (the 1280 ff
# pair); GroupNorm 22 resnets x 2 + 16 transformer norms + conv_norm_out =
# 61, of which the first 3 (down 0's first resnet, its transformer's norm)
# come before any adapted layer and get no gradient: 58 backward.
#
# SDXL (sdxl_config), per UNet call:
# - Transformer2DModels: 2 at 640 (down 1, depth 2) + 2 at 1280 (down 2,
#   depth 10) + the mid (1280, depth 10) + 3 at 1280 (up 0, depth 10) + 3 at
#   640 (up 1, depth 2) = 11, holding 2*2 + 2*10 + 10 + 3*10 + 3*2 = 70
#   BasicTransformerBlocks (10 at 640, 60 at 1280);
# - flash: one self-attention per block, 70 (10 at T4096 with 10 heads, 60
#   at T1024 with 20 heads, D64); LayerNorm 3 per block, 210; GEGLU 70;
# - GroupNorm: 17 resnets (6 down, 2 mid, 9 up) x 2 + 11 transformer norms +
#   conv_norm_out = 46; a gradient reaches all but the 7 before the first
#   adapted layer (down 0's two resnets, down 1's first resnet and its
#   transformer's norm): 39;
# - adapted layers: 70 blocks x 10 (attn1 q/k/v/out, attn2 q/k/v/out, ff
#   net_0 and net_2) + 11 x 2 (proj_in, proj_out) = 722;
# - factored LoKr layers: the ff pair at 1280, harmonic dimensions
#   10240*1280/11520 = 1137 and 1280*5120/6400 = 1024 reach the threshold of
#   1024 (640's pair, 568 and 512, and 1280's attention, 640 and 787, do
#   not): 60 x 2 = 120.
# A train step with remat="transformer" runs each Transformer2DModel forward
# twice: flash fwd 2 x 70 = 140, LayerNorm fwd 2 x 210 = 420, hada fwd 2 x 722
# = 1444, factored 2 x 120 = 240, GroupNorm fwd 46 + 11 = 57; and each
# backward once: flash 70, LayerNorm 210, hada 722, GroupNorm 39, GEGLU 70.
# DoRA LoHa takes the same route (the merged weight, rescaled); with the
# trainer's max-norm pass each LoHa layer's dW is formed once more after
# the optimizer step: hada fwd 1444 + 722 = 2166. Premerge merges every
# layer once before the model runs and takes no factored layer: LoKr
# factored 0 (a LoHa premerge step would run hada fwd 722).
#
# LoRA (attn-mlp) has no kernel of its own on the merged path: its layers
# run W + dW through cuBLAS, and its factored layers are the linear ones
# whose harmonic dimension reaches 1024, as for LoKr (the 1x1-conv
# proj_in/out are declined by factored_merged_fns): 12 per SD1.5 step, 240
# per SDXL step (120 per UNet forward, run twice).
#
# LoCon on the kohya "full" SD1.5 targets: 16 transformers x 12 = 192; 22
# resnets (8 down, 2 mid, 12 up) x 3 (conv1, conv2, time_emb_proj) = 66;
# conv_shortcut where the channels change: down 320->640 and 640->1280, and
# all 12 up resnets (their inputs carry a skip) = 14; 3 downsamplers + 3
# upsamplers = 6; conv_in, conv_out, time_embedding.linear_1/_2 = 4; in all
# 282 layers, 52 of them 3x3 convs (conv_dim 8). conv_in is adapted, so a
# gradient reaches all 61 GroupNorms; the factored layers are the same 12
# (no resnet or time-embedding linear reaches the threshold).
SD15_CALL = {"flash_fwd": 10, "layer_norm_fwd": 48, "group_norm_fwd": 61}
SD15_STEP = {"flash_fwd": 10, "layer_norm_fwd": 48, "group_norm_fwd": 61, "flash_bwd": 10,
             "layer_norm_bwd": 48, "group_norm_bwd": 58, "geglu_bwd": 16}
SD15_STEP_FULL = {**SD15_STEP, "group_norm_bwd": 61}
SDXL_STEP = {"flash_fwd": 140, "layer_norm_fwd": 420, "group_norm_fwd": 57, "flash_bwd": 70,
             "layer_norm_bwd": 210, "group_norm_bwd": 39, "geglu_bwd": 70}
# With train_norm (LoRA on attn-mlp) every LayerNorm and each
# Transformer2DModel's GroupNorm train: their backwards form dw and db too
# (SDXL: LayerNorm 210, GroupNorm 11 a step; SD1.5: 48 and 16), and the first
# Transformer2DModel's GroupNorm, which comes before any adapted layer, now
# runs its backward: GroupNorm bwd SDXL 39 + 1 = 40, SD1.5 58 + 1 = 59. The
# adapted layers are the 722 (192) linear/1x1-conv layers plus those norms:
# SDXL 722 + 210 + 11 = 943, SD1.5 192 + 48 + 16 = 256.
#
# Diag-OFT, BOFT, (IA)^3, GLoRA, DyLoRA and Full launch no adapter kernel
# and take no factored backward (their merged weights run through cuBLAS):
# the UNet's own counts, factored 0.


SD15_ADAPTED, SD15_FACTORED = 192, 12
SDXL_ADAPTED, SDXL_FACTORED = 722, 120
SD15_FULL_ADAPTED = 282
SDXL_STEP_NORM = {**SDXL_STEP, "group_norm_bwd": 40, "layer_norm_bwd_wb": 210,
                  "group_norm_bwd_wb": 11}
SD15_STEP_NORM = {**SD15_STEP, "group_norm_bwd": 59, "layer_norm_bwd_wb": 48,
                  "group_norm_bwd_wb": 16}
SDXL_NORM_ADAPTED, SD15_NORM_ADAPTED = 943, 256


def has_factored(algo: str) -> bool:
    """Whether ``algo``'s module class has a factored cotangent
    (``factored_merged_fns``: LoRA/LoCon and LoKr)."""
    from lycoris_tpu_torch.wrapper import network_module_dict

    return hasattr(network_module_dict[algo], "factored_merged_fns")


def hand_counts(base: dict, adapted: int, factored: int, algo: str, train: bool,
                again: int, split: bool = False, max_norm: bool = False,
                premerge: bool = False) -> dict:
    """The launch counts above for one algorithm (hada for LoHa, fused1 or
    split backward, one more forward a layer for max-norm, one forward a
    layer under premerge; factored layers for LoKr and LoRA when training
    on the interceptor route)."""
    loha = algo == "loha"
    out = {name: base.get(name, 0) for name in KERNELS}
    merges = (1 if premerge else again) + (1 if train and max_norm else 0)
    out["hada_fwd"] = merges * adapted if loha else 0
    out["hada_bwd"] = adapted if train and loha and not split else 0
    out["hada_bwd_split"] = adapted if train and loha and split else 0
    out["factored"] = (again * factored if train and has_factored(algo) and not premerge
                       else 0)
    return out


def checked_counts(cfg, batch, hw, algo, train, remat, base, adapted, factored,
                   split=False, full=False, max_norm=False, premerge=False,
                   norm=False) -> dict:
    """The census's launch counts, failed unless they equal the hand count
    (``base``: the hand count of the kernels of the UNet itself)."""
    got = want_counts(path_shapes(cfg, batch, hw), algo, train, remat, split=split, full=full,
                      max_norm=max_norm, premerge=premerge, norm=norm)
    want = hand_counts(base, adapted, factored, algo, train, 2 if train and remat else 1,
                       split=split, max_norm=max_norm, premerge=premerge)
    if got != want:
        fail(f"the UNet census gives {got}, the hand count {want}")
    return got


# ---------------------------------------------------------------------------
# phases 2-4: every kernel against its plain version, the fused LoRA op
# ---------------------------------------------------------------------------


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


def new_results() -> dict:
    def acc():
        return {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_parts": {}, "library_ms": None}

    return {name: {"launches": 0, "max_abs_err": 0.0, "sd15": acc(), "sdxl": acc()}
            for name in KERNELS}


def record(results, name, path, stats, shape_s, times=None, per_call=0):
    """Log one kernel check (``stats`` from :func:`compare`) and fail if it
    is over a bound. ``times`` = (kernel ms, host ms, plain ms, library ms or
    None, (bound ms, bound_by)) of one launch: ms, plain and library are
    device times (:func:`graph_ms`), host the wrapper's back-to-back
    host-clocked time (:func:`time_ms`). They are added to the kernel's row
    for ``path``, weighted by ``per_call``, the shape's launches per UNet
    call or train step on that path."""
    ok, mse, mx, rel, scale, dt = stats
    msg = (f"[kernels] {name} {path} {dt} {shape_s}: mse {mse:.3e} rel_l2 {rel:.3e} "
           f"max_abs {mx:.3e} (max|ref| {scale:.3e})")
    if times is not None:
        ms, host, plain, lib, bnd = times
        lib_s = "" if lib is None else f" library {lib:.4f} ms"
        msg += (f" kernel {ms:.4f} ms (host-clocked {host:.4f} ms) plain {plain:.4f} ms"
                f"{lib_s} bound {bnd[0]:.4f} ms ({bnd[1]}) x {per_call} per call/step")
    log(msg)
    if not ok:
        fail(f"{name} {dt} {shape_s}: mse {mse:.3e} / rel_l2 {rel:.3e} / "
             f"max_abs {mx:.3e} of max|ref| {scale:.3e} over bound")
    r = results[name]
    r["max_abs_err"] = max(r["max_abs_err"], mx)
    if times is None or not per_call:
        return
    a = r[path]
    a["ms"] += ms * per_call
    a["host_ms"] += host * per_call
    a["plain_ms"] += plain * per_call
    a["bound_ms"] += bnd[0] * per_call
    a["bound_parts"][bnd[1]] = a["bound_parts"].get(bnd[1], 0.0) + bnd[0] * per_call
    if lib is not None:
        a["library_ms"] = (a["library_ms"] or 0.0) + lib * per_call


def _rnd(gen, dev):
    import torch

    def rnd(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    return rnd


def _library_bwd_ms(fwd, inputs, dy, iters: int, copies=None) -> float:
    """Device ms of the autograd backward of the library call ``fwd(*inputs)``
    for the cotangent ``dy`` (:func:`graph_ms`); with ``copies``, a list of
    (inputs, dy), the timed calls take them in turn (:func:`rotating`). The
    forwards run on the timing stream, so that their backwards run, and are
    captured, there."""
    import torch

    s = timing_stream()
    s.wait_stream(torch.cuda.current_stream())
    cases = []
    with torch.cuda.stream(s):
        for ins, g in copies or [(inputs, dy)]:
            leaves = [x.detach().requires_grad_(True) for x in ins]
            cases.append((fwd(*leaves), leaves, g))
    return graph_ms(rotating(lambda out, leaves, g: torch.autograd.grad(
        out, leaves, g, retain_graph=True), cases), iters)


def rotating(fn, cases, hold=False):
    """A callable that calls ``fn(*case)`` for each of ``cases`` in turn.
    Captured in a timing graph, each call keeps its own case's buffers, so
    copies of the inputs larger together than L2 (:data:`ROTATE_BYTES`)
    make every call read its inputs from HBM. With ``hold``, each call's
    result is kept until its case comes round again, so the outputs rotate
    over as many buffers (a freed output would be the next call's, still in
    L2)."""
    turn = [0]
    held = [None] * len(cases)

    def call():
        k = turn[0] % len(cases)
        turn[0] += 1
        out = fn(*cases[k])
        if hold:
            held[k] = out
        return out

    return call


def _times(kernel, plain, it, bnd, lib=None, plain_iters=None, plain_replays=3, host=None):
    """(kernel, host, plain, library, bound) ms of one launch, each timing
    over ``it`` calls; ``lib`` is a callable of ``it`` returning the
    library's device ms, or None; ``host``, if given, is the call whose
    host-clocked ms is taken in place of ``kernel``'s (one on the same
    inputs each time, where ``kernel`` holds rotating outputs whose first
    round would time their allocation)."""
    return (graph_ms(kernel, it), time_ms(host or kernel, it),
            graph_ms(plain, plain_iters or it, replays=plain_replays),
            None if lib is None else lib(it), bnd)


def flash_ratios(name, path, bh, t, d, times):
    """Log a flash timing's share of its bound and its ratio to SDPA."""
    ms, _, _, lib, (bnd, _) = times
    log(f"[kernels] {name} {path} ({bh},{t},{d}): {bnd / ms:.1%} of its bound, "
        f"{ms / lib:.2f}x SDPA ({ms:.4f} against {lib:.4f} ms)")


class Checks:
    """Each kernel against its plain version on seeded inputs at one shape;
    ``timed`` (the path's dtype) adds the timings of :func:`_times`."""

    def __init__(self, results, seed):
        import torch

        self.results = results
        self.dev = torch.device("cuda")
        self.rnd = _rnd(torch.Generator(device=self.dev).manual_seed(seed), self.dev)
        self.wb_timed = set()  # dtypes whose LayerNorm dw/db call is timed

    def _flash_inputs(self, layout, b, h, t, d, dtype, n):
        """``n`` (B, H, T, D) operands: "strided", head-split views of (B, T,
        H*D) tensors as the UNet's attention projections give them (the
        path's layout), or "contiguous"."""
        if layout == "strided":
            return [self.rnd((b, t, h * d), dtype).unflatten(-1, (h, d)).transpose(1, 2)
                    for _ in range(n)]
        return [self.rnd((b, h, t, d), dtype) for _ in range(n)]

    def flash_fwd(self, path, bh, t, d, dtype, per_call, timed):
        """Checked on the path's strided layout and on contiguous inputs; the
        strided one's times go into the kernel's row, the contiguous kernel
        time is logged beside."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import flash

        b = UNET_BATCH if path == "sd15" else SDXL_BATCH
        sm = 1.0 / d**0.5
        for layout in ("strided", "contiguous"):
            q, k, v = self._flash_inputs(layout, b, bh // b, t, d, dtype, 3)
            with torch.no_grad():
                o, lse = flash.flash_attention(q, k, v, sm)
                o_ref, lse_ref = flash.flash_attention_plain(q, k, v, sm)
            torch.cuda.synchronize()
            ok, *stats = compare(dtype, o, o_ref)
            lse_err = float((lse - lse_ref).abs().max())
            log(f"[kernels] flash_fwd {path} {layout} lse max_abs {lse_err:.3e} (bound 1e-3)")
            del o, o_ref, lse, lse_ref
            times = None
            if timed and layout == "strided":
                # rotating copies of q, k, v (the path's layout) with the
                # outputs held, the plain version and SDPA on the same copies
                es = q.element_size()
                nbytes = 4 * bh * t * d * es + 4 * bh * t
                copies = [tuple(self._flash_inputs(layout, b, bh // b, t, d, dtype, 3))
                          for _ in range(max(2, math.ceil(ROTATE_BYTES / nbytes)))]
                it = max(10 if t >= 4096 else 30, len(copies))
                with torch.no_grad():
                    times = _times(
                        rotating(lambda *a: flash.flash_attention(*a, sm), copies, hold=True),
                        rotating(lambda *a: flash.flash_attention_plain(*a, sm), copies,
                                 hold=True),
                        it, bound(4.0 * bh * t * t * d, nbytes, str(dtype)[6:]),
                        lambda n: graph_ms(rotating(
                            lambda *a: F.scaled_dot_product_attention(*a, scale=sm), copies,
                            hold=True), n),
                        plain_iters=len(copies), plain_replays=1,
                        host=lambda: flash.flash_attention(q, k, v, sm))
                del copies
                flash_ratios("flash_fwd", path, bh, t, d, times)
            elif timed:
                with torch.no_grad():
                    ms = graph_ms(lambda: flash.flash_attention(q, k, v, sm),
                                  10 if t >= 4096 else 30)
                log(f"[kernels] flash_fwd {path} contiguous ({bh},{t},{d}): kernel {ms:.4f} ms")
            record(self.results, "flash_fwd", path, (ok and lse_err <= 1e-3, *stats),
                   f"({bh},{t},{d}) {layout}", times, per_call if layout == "strided" else 0)

    def layer_norm_fwd(self, path, rows, c, dtype, per_call, timed):
        """Both variants against the plain version; the call must take the
        variant :func:`layer_norm.fwd_plan` names, the vectorised one at
        every UNet shape in bf16 (the path's dtype; on the "clip" path,
        CLIP-L's C = 768 takes the generic one, and its rows go into no
        UNet sum). Timed on rotating copies of
        x over :data:`ROTATE_BYTES` with the outputs held, so each call reads
        x from HBM, as on the path: the vectorised and generic variants, the
        plain version and ``F.layer_norm`` on the same copies; each shape's
        row keeps them with the bound, the plan, the launches and the time
        of a device copy of x (the same bytes moved, no arithmetic)."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import layer_norm

        x = self.rnd((rows, c), dtype, 2.0) + 0.5
        w = self.rnd((c,), dtype, 0.5) + 1.0
        b = self.rnd((c,), dtype, 0.5)
        n0 = (layer_norm.fwd_vec_launches, layer_norm.fwd_generic_launches)
        y = layer_norm.layer_norm(x, w, b, 1e-5)
        got = (layer_norm.fwd_vec_launches - n0[0], layer_norm.fwd_generic_launches - n0[1])
        vec = int(layer_norm.vec_lanes(c, x.element_size()) > 0)
        if got != (vec, 1 - vec) or (dtype == torch.bfloat16 and not vec and path != "clip"):
            fail(f"layer_norm_fwd {path} ({rows},{c}) {dtype}: {got[0]} vectorised and "
                 f"{got[1]} generic launches, want the vectorised variant {bool(vec)}")
        y_gen = layer_norm.layer_norm_fwd(x, w, b, 1e-5, vectorised=False)
        y_ref = layer_norm.layer_norm_plain(x, w, b, 1e-5)
        torch.cuda.synchronize()
        times = None
        if timed:
            # rotating copies of x with the outputs held (the kernel, the
            # plain version and the library alike), so x comes from HBM
            n, es = x.numel(), x.element_size()
            nbytes = 2 * n * es + 2 * c * es
            copies = [(x.clone(),) for _ in range(max(2, math.ceil(ROTATE_BYTES / nbytes)))]
            it = max(iters_for(nbytes), len(copies))
            times = _times(
                rotating(lambda xc: layer_norm.layer_norm(xc, w, b, 1e-5), copies, hold=True),
                rotating(lambda xc: layer_norm.layer_norm_plain(xc, w, b, 1e-5), copies,
                         hold=True),
                it, bound(8.0 * n, nbytes, str(dtype)[6:]),
                lambda it: graph_ms(rotating(lambda xc: F.layer_norm(xc, (c,), w, b, 1e-5),
                                             copies, hold=True), it),
                host=lambda: layer_norm.layer_norm(x, w, b, 1e-5))
            generic_ms = graph_ms(rotating(lambda xc: layer_norm.layer_norm_fwd(
                xc, w, b, 1e-5, vectorised=False), copies, hold=True), it)
            # a yardstick of the bytes alone: a device copy of each x into
            # its own output buffer (one read, one write, no arithmetic)
            outs = [torch.empty_like(x) for _ in copies]
            copy_ms = graph_ms(rotating(lambda xc, yc: yc.copy_(xc),
                                        [(xc, yc) for (xc,), yc in zip(copies, outs)]), it)
            del outs
            ms, host, plain, lib, (bnd, by) = times
            plan = layer_norm.fwd_plan(rows, c, es, layer_norm._sms(x.get_device()))
            share = (f"{bnd / ms:.1%} of its bound" if ms >= bnd else
                     "UNDER its HBM bound: the timing did not reach HBM")
            log(f"[kernels] layer_norm_fwd {path} ({rows},{c}) "
                f"{'vectorised' if plan.lanes else 'generic'} (lanes {plan.lanes}, "
                f"{plan.warps} warps a block, {plan.grid} blocks), {len(copies)} rotating "
                f"copies: kernel {ms:.4f} ms, {share} {bnd:.4f} ms ({by}); generic variant "
                f"{generic_ms:.4f} ms ({generic_ms / ms:.2f}x); F.layer_norm {lib:.4f} ms "
                f"({lib / ms:.2f}x); a copy of x {copy_ms:.4f} ms; plain {plain:.4f} ms; "
                f"host-clocked {host:.4f} ms; x {per_call} per call/step")
            self.results["layer_norm_fwd"].setdefault("shapes", []).append(
                {"path": path, "shape": [rows, c], "ms": ms, "generic_ms": generic_ms,
                 "host_ms": host, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
                 "copy_ms": copy_ms, "per": per_call, "plan": list(plan)})
            del copies
        record(self.results, "layer_norm_fwd", path, compare(dtype, y, y_ref), f"({rows},{c})",
               times, per_call if path in ("sd15", "sdxl") else 0)
        record(self.results, "layer_norm_fwd", path, compare(dtype, y_gen, y_ref),
               f"({rows},{c}) generic variant")

    def _hada_factors(self, o_, i_, r, dtype):
        """w1d, w1u, w2d, w2u of rank ``r`` and a cotangent g (O, I)."""
        return (self.rnd((r, i_), dtype), self.rnd((o_, r), dtype, 0.1), self.rnd((r, i_), dtype),
                self.rnd((o_, r), dtype, 0.1), self.rnd((o_, i_), dtype, 1e-3))

    def _hada_copies(self, o_, i_, dtype, nbytes):
        """Copies of rank-8 factors and g, over :data:`ROTATE_BYTES` together
        at ``nbytes`` a case, for a rotating timing."""
        return [self._hada_factors(o_, i_, 8, dtype)
                for _ in range(max(2, math.ceil(ROTATE_BYTES / nbytes)))]

    def _fast_variant(self, name, ops, counter, fn):
        """Run ``fn`` and fail unless it launched the fast variant (counted
        in ``ops.<counter>``, ``ops`` a module of ``lycoris_tpu_torch.ops``):
        every LoHa layer of the paths is rank 8, every GroupNorm shape holds
        whole 16-byte rows."""
        import importlib

        mod = importlib.import_module(f"lycoris_tpu_torch.ops.{ops}")
        n = getattr(mod, counter)
        out = fn()
        if getattr(mod, counter) != n + 1:
            fail(f"{name}: a path shape took the generic variant")
        return out

    def _hada_share(self, name, path, o_, i_, times, per_call):
        """Log a hada timing's share of its bound and keep the shape's row."""
        ms, host, plain, _, (bnd, by) = times
        share = (f"{bnd / ms:.1%} of its bound" if ms >= bnd else
                 "UNDER its bound: the timing did not reach HBM")
        log(f"[kernels] {name} {path} ({o_},{i_}) fast variant, rotating copies: kernel "
            f"{ms:.4f} ms, {share} {bnd:.4f} ms ({by}); plain {plain:.4f} ms; the wrapper's "
            f"host-clocked {host:.4f} ms")
        self.results[name].setdefault("shapes", []).append(
            {"path": path, "shape": [o_, i_], "ms": ms, "host_ms": host, "plain_ms": plain,
             "bound_ms": bnd, "per": per_call})

    def hada_fwd(self, path, o_, i_, dtype, per_call, timed):
        """The forward, fast variant, against its plain version. Timed on
        rotating copies of the factors with the outputs held, so each call
        writes a buffer that is not in L2."""
        import torch
        from lycoris_tpu_torch.ops import hada

        w1d, w1u, w2d, w2u, _ = self._hada_factors(o_, i_, 8, dtype)
        out = self._fast_variant("hada_fwd", "hada", "fast_launches",
                                 lambda: hada.hada_weight(w1d, w1u, w2d, w2u, 0.5))
        ref = hada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5)
        torch.cuda.synchronize()
        times = None
        if timed:
            es = w1d.element_size()
            nbytes = (o_ * i_ + 2 * 8 * (o_ + i_)) * es
            copies = [c[:4] for c in self._hada_copies(o_, i_, dtype, nbytes)]
            it = max(iters_for(nbytes), len(copies))
            times = _times(rotating(lambda *f: hada.hada_weight(*f, 0.5), copies, hold=True),
                           rotating(lambda *f: hada.hada_weight_plain(*f, 0.5), copies, hold=True),
                           it, bound(2.0 * o_ * i_ * (2 * 8 + 2), nbytes, "float32"),
                           host=lambda: hada.hada_weight(w1d, w1u, w2d, w2u, 0.5))
            self._hada_share("hada_fwd", path, o_, i_, times, per_call)
            del copies
        record(self.results, "hada_fwd", path, compare(dtype, out, ref), f"({o_},{i_})", times,
               per_call)

    def _gn_inputs(self, n, c, s, dtype, bwd):
        """x (N, C, H, W) and gamma, beta, and with ``bwd`` a cotangent dh."""
        hw = math.isqrt(s)
        x = self.rnd((n, c, hw, hw), dtype, 2.0) + 0.5
        w = self.rnd((c,), dtype, 0.5) + 1.0
        b = self.rnd((c,), dtype, 0.5)
        return x, w, b, (self.rnd((n, c, hw, hw), dtype) if bwd else None)

    def _gn_row(self, name, path, shape, act, dtype, direction, times, generic_ms, per):
        """Log a GroupNorm timing (fast variant, generic variant, plain,
        library, bound) and keep the shape's row, with the fast plan's
        cluster size, re-read and the clusters the card holds at once."""
        from lycoris_tpu_torch.ops import group_norm as gn

        ms, host, plain, lib, (bnd, by) = times
        n, c, s = shape
        pl = gn.plan(n, c, s, 32, dtype, direction)
        clusters = gn.fast_clusters(pl, direction, dtype, act)
        share = (f"{bnd / ms:.1%} of its bound" if ms >= bnd else
                 "UNDER its HBM bound: the timing did not reach HBM")
        log(f"[kernels] {name} {path} ({n},{c},{s}) act={act} fast variant (k {pl.k}, "
            f"re-read {pl.reread} vectors, {clusters} clusters at once), rotating copies: "
            f"kernel {ms:.4f} ms, {share} {bnd:.4f} ms ({by}); generic variant "
            f"{generic_ms:.4f} ms ({generic_ms / ms:.2f}x); library {lib:.4f} ms; plain "
            f"{plain:.4f} ms; the wrapper's host-clocked {host:.4f} ms")
        self.results[name].setdefault("shapes", []).append(
            {"path": path, "shape": [n, c, s], "act": act, "ms": ms, "generic_ms": generic_ms,
             "host_ms": host, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
             "per": per, "k": pl.k, "reread": pl.reread, "clusters": clusters})

    def group_norm_fwd(self, path, n, c, s, act, dtype, per_call, timed):
        """The forward, fast variant (and the generic one), against the plain
        version. Timed on rotating copies of x over :data:`ROTATE_BYTES` with
        the outputs held, so each call reads x from HBM, as on the path: the
        fast and generic variants, the plain version and the library call
        (``F.group_norm`` + ``F.silu``) on the same copies. ``path``
        "sd15_b8" (the SD1.5 train step's forwards) is logged and kept per
        shape only, apart from the serving sums of "sd15"."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import group_norm as gn

        eps = 1e-5 if act else 1e-6
        x, w, b, _ = self._gn_inputs(n, c, s, dtype, False)
        y, _, _ = self._fast_variant("group_norm_fwd", "group_norm", "fast_launches",
                                     lambda: gn.group_norm_fwd(x, 32, w, b, eps, act))
        y_ref = gn.group_norm_plain(x, 32, w, b, eps, act)
        y_gen = gn.fwd_generic(x, 32, w, b, eps, act)[0]
        torch.cuda.synchronize()
        times = None
        if timed:
            e, es = x.numel(), x.element_size()
            nbytes = 2 * e * es + 2 * c * es
            copies = [(x.clone(),) for _ in range(max(2, math.ceil(ROTATE_BYTES / (e * es))))]
            it = max(iters_for(nbytes), len(copies))

            def lib_fwd(xc):
                z = F.group_norm(xc, 32, w, b, eps)
                return F.silu(z) if act else z

            times = _times(
                rotating(lambda xc: gn.group_norm_fwd(xc, 32, w, b, eps, act), copies, hold=True),
                rotating(lambda xc: gn.group_norm_plain(xc, 32, w, b, eps, act), copies,
                         hold=True),
                it, bound((10.0 if act else 5.0) * e, nbytes, "float32"),
                lambda it: graph_ms(rotating(lib_fwd, copies, hold=True), it),
                host=lambda: gn.group_norm_fwd(x, 32, w, b, eps, act))
            generic_ms = graph_ms(rotating(lambda xc: gn.fwd_generic(xc, 32, w, b, eps, act),
                                           copies, hold=True), it)
            self._gn_row("group_norm_fwd", path, (n, c, s), act, dtype, "fwd", times,
                         generic_ms, per_call)
            del copies
        record(self.results, "group_norm_fwd", path, compare(dtype, y, y_ref),
               f"({n},{c},{math.isqrt(s)},{math.isqrt(s)}) act={act}", times,
               0 if path == "sd15_b8" else per_call)
        record(self.results, "group_norm_fwd", path, compare(dtype, y_gen, y_ref),
               f"({n},{c},{math.isqrt(s)},{math.isqrt(s)}) act={act} generic variant")

    def flash_bwd(self, path, bh, t, d, dtype, per_call, timed):
        """As :meth:`flash_fwd`: the strided layout's times go into the row."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import flash

        b = TRAIN_BATCH if path == "sd15" else SDXL_BATCH
        sm = 1.0 / d**0.5
        for layout in ("strided", "contiguous"):
            q, k, v, do = self._flash_inputs(layout, b, bh // b, t, d, dtype, 4)
            o, lse = flash.flash_fwd(q, k, v, sm)
            got = flash.flash_bwd(q, k, v, o, lse, do, sm)
            want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, sm)
            torch.cuda.synchronize()
            stats = compare_all(dtype, got, want)
            del got, want
            times = None
            if timed and layout == "strided":
                es = q.element_size()
                # five matmuls (S, dP, dV, dK, dQ) of 2*T*T*D each per head; q, k,
                # v, o, dO, lse read and dq, dk, dv written once
                nbytes = 8 * bh * t * d * es + 4 * bh * t
                times = _times(
                    lambda: flash.flash_bwd(q, k, v, o, lse, do, sm),
                    lambda: flash.flash_attention_bwd_plain(q, k, v, o, lse, do, sm),
                    5 if t >= 4096 else 20, bound(10.0 * bh * t * t * d, nbytes, str(dtype)[6:]),
                    lambda it: _library_bwd_ms(
                        lambda *xs: F.scaled_dot_product_attention(*xs, scale=sm), (q, k, v), do,
                        it),
                    plain_iters=3 if t >= 4096 else 10, plain_replays=1)
                flash_ratios("flash_bwd", path, bh, t, d, times)
            elif timed:
                ms = graph_ms(lambda: flash.flash_bwd(q, k, v, o, lse, do, sm),
                              5 if t >= 4096 else 20)
                log(f"[kernels] flash_bwd {path} contiguous ({bh},{t},{d}): kernel {ms:.4f} ms")
            record(self.results, "flash_bwd", path, stats, f"({bh},{t},{d}) {layout}", times,
                   per_call if layout == "strided" else 0)

    def layer_norm_bwd(self, path, rows, c, dtype, per_call, timed):
        """dx/dw/db and dx alone against the plain backward; both calls must
        take the variant :func:`layer_norm.bwd_lanes` names, the vectorised
        one at every shape in bf16 (the path's dtype). The dx-only call (the
        path's) is timed against ``F.layer_norm``'s backward for dx, and the
        dw/db call once per dtype against the library's dx/dw/db. Every
        timed call, the kernel's, the plain version's and the library's,
        takes its own copy of x and dy in turn, the copies over 4x the L2
        together (:func:`rotating`), so the times are those of inputs read
        from HBM, as on the path, where the activations of other layers run
        between two LayerNorm backwards."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import layer_norm

        x = self.rnd((rows, c), dtype, 2.0) + 0.5
        w = self.rnd((c,), dtype, 0.5) + 1.0
        dy = self.rnd((rows, c), dtype)
        vec0 = layer_norm.bwd_vec_launches
        got = layer_norm.layer_norm_bwd(x, w, dy, 1e-5)
        wb_vec = layer_norm.bwd_vec_launches - vec0
        dx_only = layer_norm.layer_norm_bwd(x, w, dy, 1e-5, want_wb=False)[0]
        dx_vec = layer_norm.bwd_vec_launches - vec0 - wb_vec
        want_vec = int(layer_norm.bwd_lanes(c, x.element_size()) > 0)
        if (dx_vec, wb_vec) != (want_vec, want_vec) or (dtype == torch.bfloat16
                                                         and not want_vec):
            fail(f"layer_norm_bwd {path} ({rows},{c}) {dtype}: the vectorised variant ran for "
                 f"{dx_vec} of 1 dx-only and {wb_vec} of 1 dw/db calls, want {want_vec}")
        want = layer_norm.layer_norm_bwd_plain(x, w, dy, 1e-5)
        torch.cuda.synchronize()
        n, es = x.numel(), x.element_size()
        b = self.rnd((c,), dtype, 0.5)
        copies = [(x.clone(), dy.clone()) for _ in range(
            max(2, math.ceil(ROTATE_BYTES / (2 * n * es))))] if timed or (
            dtype not in self.wb_timed) else []
        times = None
        if timed:
            nbytes = 3 * n * es + c * es
            it = max(iters_for(nbytes), len(copies))
            # the path needs dx only (frozen weights): that call is timed
            kernel = rotating(lambda xc, gc: layer_norm.layer_norm_bwd(xc, w, gc, 1e-5,
                                                                       want_wb=False), copies)
            plain = rotating(lambda xc, gc: layer_norm.layer_norm_bwd_plain(xc, w, gc, 1e-5),
                             copies)
            times = _times(kernel, plain, it, bound(12.0 * n, nbytes, str(dtype)[6:]),
                           lambda it: _library_bwd_ms(
                               lambda xl: F.layer_norm(xl, (c,), w, b, 1e-5), None, None, it,
                               copies=[((xc,), gc) for xc, gc in copies]))
            ms, lib, bnd = times[0], times[3], times[4][0]
            verdict = "no slower than" if ms <= lib else "SLOWER than"
            share = (f"{bnd / ms:.1%} of its bound" if ms >= bnd else
                     "UNDER its HBM bound: the timing did not reach HBM")
            log(f"[kernels] layer_norm_bwd {path} ({rows},{c}) dx, {len(copies)} rotating "
                f"copies: kernel {ms:.4f} ms {verdict} F.layer_norm's backward {lib:.4f} ms "
                f"({ms / lib:.2f}x), {share}")
            self.results["layer_norm_bwd"].setdefault("shapes", []).append(
                {"path": path, "shape": [rows, c], "ms": ms, "library_ms": lib,
                 "bound_ms": bnd, "per": per_call})
        if dtype not in self.wb_timed:
            self.wb_timed.add(dtype)
            it = max(iters_for(3 * n * es), len(copies))
            wb_ms = graph_ms(rotating(lambda xc, gc: layer_norm.layer_norm_bwd(
                xc, w, gc, 1e-5), copies), it)
            dx_ms = graph_ms(rotating(lambda xc, gc: layer_norm.layer_norm_bwd(
                xc, w, gc, 1e-5, want_wb=False), copies), it)
            lib_wb = _library_bwd_ms(lambda xl, wl, bl: F.layer_norm(xl, (c,), wl, bl, 1e-5),
                                     None, None, it,
                                     copies=[((xc, w, b), gc) for xc, gc in copies])
            log(f"[kernels] layer_norm_bwd {path} ({rows},{c}) {str(dtype)[6:]}, rotating "
                f"copies: dx+dw+db {wb_ms:.4f} ms beside dx only {dx_ms:.4f} ms; "
                f"F.layer_norm's backward for dx, dw and db {lib_wb:.4f} ms")
            self.results["layer_norm_bwd"].setdefault("with_dw_db", []).append(
                {"path": path, "shape": [rows, c], "dtype": str(dtype)[6:], "ms": wb_ms,
                 "dx_only_ms": dx_ms, "library_ms": lib_wb})
        del copies
        record(self.results, "layer_norm_bwd", path,
               compare_all(dtype, (*got, dx_only), (*want, want[0])), f"({rows},{c})", times,
               per_call)

    def hada_bwd(self, path, o_, i_, dtype, per_call, timed):
        """The fused backward, fast variant, against its plain version.
        Timed on rotating copies of g and the factors, over 4x the L2
        together, with the outputs held, so that each call reads its inputs
        from HBM, as on the path (the kernel, the plain version alike)."""
        import torch
        from lycoris_tpu_torch.ops import hada

        w1d, w1u, w2d, w2u, g = self._hada_factors(o_, i_, 8, dtype)
        got = self._fast_variant("hada_bwd", "hada", "bwd_fast_launches",
                                 lambda: hada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, g))
        want = hada.hada_weight_bwd_plain(w1d, w1u, w2d, w2u, 0.5, g)
        torch.cuda.synchronize()
        times = None
        if timed:
            es = g.element_size()
            nbytes = (o_ * i_ + 4 * 8 * (o_ + i_)) * es
            copies = self._hada_copies(o_, i_, dtype, nbytes)
            it = max(iters_for(nbytes), len(copies))
            # per element of g, 6 R multiply-adds: R for each of the two
            # products and R for each of the four contractions; g and the
            # factors read, the four grads written
            times = _times(
                rotating(lambda *f: hada.hada_bwd(*f[:4], 0.5, f[4]), copies, hold=True),
                rotating(lambda *f: hada.hada_weight_bwd_plain(*f[:4], 0.5, f[4]), copies,
                         hold=True),
                it, bound(2.0 * 6 * 8 * o_ * i_, nbytes, "float32"),
                host=lambda: hada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, g))
            self._hada_share("hada_bwd", path, o_, i_, times, per_call)
            del copies
        record(self.results, "hada_bwd", path, compare_all(dtype, got, want), f"({o_},{i_})",
               times, per_call)

    def hada_any_rank(self, o_, i_, r):
        """Rank ``r`` (not the fast variants' 8) through the generic forward
        and fused backward, and through the split backward, against their
        plain versions (fp32)."""
        import torch
        from lycoris_tpu_torch.ops import hada

        w1d, w1u, w2d, w2u, g = self._hada_factors(o_, i_, r, torch.float32)
        n = (hada.generic_launches, hada.bwd_generic_launches)
        out = hada.hada_weight(w1d, w1u, w2d, w2u, 0.5)
        got = hada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, g)
        split = hada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, g)
        torch.cuda.synchronize()
        if (hada.generic_launches - n[0], hada.bwd_generic_launches - n[1]) != (1, 1):
            fail(f"hada rank {r}: the generic variants did not take it")
        shape = f"({o_},{i_}) R{r} generic"
        record(self.results, "hada_fwd", "sdxl",
               compare(torch.float32, out, hada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5)), shape)
        record(self.results, "hada_bwd", "sdxl", compare_all(
            torch.float32, got, hada.hada_weight_bwd_plain(w1d, w1u, w2d, w2u, 0.5, g)), shape)
        record(self.results, "hada_bwd_split", "sdxl", compare_all(
            torch.float32, split, hada.hada_weight_bwd_split_plain(w1d, w1u, w2d, w2u, 0.5, g)),
            f"({o_},{i_}) R{r}")

    def group_norm_bwd(self, path, n, c, s, act, dtype, per_call, timed):
        """dx/dgamma/dbeta and dx alone, fast variant (and dx of the generic
        one), against the plain backward. The dx-only call (the path's:
        frozen gamma and beta) is timed as the forward, on rotating copies of
        x and dh with the outputs held: fast and generic variants, plain,
        and the library call's autograd backward on the same copies."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import group_norm as gn

        eps = 1e-5 if act else 1e-6
        x, w, b, dh = self._gn_inputs(n, c, s, dtype, True)
        _, mean, rstd = gn.group_norm_fwd(x, 32, w, b, eps, act)
        got = self._fast_variant("group_norm_bwd", "group_norm", "bwd_fast_launches",
                                 lambda: gn.group_norm_bwd(x, dh, 32, w, b, mean, rstd, act))
        dx_only = self._fast_variant("group_norm_bwd", "group_norm", "bwd_fast_launches",
                                     lambda: gn.group_norm_bwd(x, dh, 32, w, b, mean, rstd,
                                                               act, want_wb=False))[0]
        dx_gen = gn.bwd_generic(x, dh, 32, w, b, mean, rstd, act, False)[0]
        want = gn.group_norm_bwd_plain(x, dh, 32, w, b, eps, act)
        torch.cuda.synchronize()
        times = None
        if timed:
            e, es = x.numel(), x.element_size()
            nbytes = 3 * e * es + 2 * c * es
            copies = [(x.clone(), dh.clone()) for _ in range(
                max(2, math.ceil(ROTATE_BYTES / (2 * e * es))))]
            it = max(iters_for(nbytes), len(copies))

            def lib_fwd(xl):
                z = F.group_norm(xl, 32, w, b, eps)
                return F.silu(z) if act else z

            times = _times(
                rotating(lambda xc, dc: gn.group_norm_bwd(xc, dc, 32, w, b, mean, rstd, act,
                                                          want_wb=False), copies, hold=True),
                rotating(lambda xc, dc: gn.group_norm_bwd_plain(xc, dc, 32, w, b, eps, act),
                         copies, hold=True),
                it, bound((30.0 if act else 12.0) * e, nbytes, "float32"),
                lambda it: _library_bwd_ms(lib_fwd, None, None, it,
                                           copies=[((xc,), dc) for xc, dc in copies]),
                host=lambda: gn.group_norm_bwd(x, dh, 32, w, b, mean, rstd, act, want_wb=False))
            generic_ms = graph_ms(rotating(lambda xc, dc: gn.bwd_generic(
                xc, dc, 32, w, b, mean, rstd, act, False), copies, hold=True), it)
            self._gn_row("group_norm_bwd", path, (n, c, s), act, dtype, "bwd", times,
                         generic_ms, per_call)
            del copies
        shape = f"({n},{c},{math.isqrt(s)},{math.isqrt(s)}) act={act}"
        record(self.results, "group_norm_bwd", path,
               compare_all(dtype, (*got, dx_only), (*want, want[0])), shape, times, per_call)
        record(self.results, "group_norm_bwd", path, compare(dtype, dx_gen, want[0]),
               f"{shape} generic variant")

    def layer_norm_bwd_wb(self, rows, c, per_call, path="sdxl"):
        """dx, dw and db in one call (the train_norm path's: the vectorised
        variant, bf16) against the plain backward, timed on rotating copies
        of x and dy with the outputs held: the kernel, the plain version and
        ``F.layer_norm``'s autograd backward for x, w and b on the same
        copies."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import layer_norm as ln

        dtype = torch.bfloat16
        x = self.rnd((rows, c), dtype, 2.0) + 0.5
        w = self.rnd((c,), dtype, 0.5) + 1.0
        b = self.rnd((c,), dtype, 0.5)
        dy = self.rnd((rows, c), dtype)
        n0 = (ln.bwd_vec_launches, ln.bwd_wb_launches)
        got = ln.layer_norm_bwd(x, w, dy, 1e-5)
        if (ln.bwd_vec_launches - n0[0], ln.bwd_wb_launches - n0[1]) != (1, 1):
            fail(f"layer_norm_bwd_wb ({rows},{c}): not the vectorised variant's dw/db call")
        want = ln.layer_norm_bwd_plain(x, w, dy, 1e-5)
        n, es = x.numel(), x.element_size()
        copies = [(x.clone(), dy.clone()) for _ in range(
            max(2, math.ceil(ROTATE_BYTES / (2 * n * es))))]
        # x and dy read, dx written, w read, dw and db (fp32) written
        nbytes = 3 * n * es + c * es + 8 * c
        it = max(iters_for(nbytes), len(copies))
        times = _times(
            rotating(lambda xc, gc: ln.layer_norm_bwd(xc, w, gc, 1e-5), copies, hold=True),
            rotating(lambda xc, gc: ln.layer_norm_bwd_plain(xc, w, gc, 1e-5), copies, hold=True),
            it, bound(16.0 * n, nbytes, "float32"),
            lambda it: _library_bwd_ms(lambda xl, wl, bl: F.layer_norm(xl, (c,), wl, bl, 1e-5),
                                       None, None, it,
                                       copies=[((xc, w, b), gc) for xc, gc in copies]),
            host=lambda: ln.layer_norm_bwd(x, w, dy, 1e-5))
        del copies
        record(self.results, "layer_norm_bwd_wb", path, compare_all(dtype, got, want),
               f"({rows},{c}) dx+dw+db", times, per_call)

    def group_norm_bwd_wb(self, n, c, s, per_call, path="sdxl"):
        """dx, dgamma and dbeta (a Transformer2DModel's act-free GroupNorm
        under train_norm: the fast variant, bf16, eps 1e-6) against the plain
        backward, timed as :meth:`layer_norm_bwd_wb`, the library being
        ``F.group_norm``'s autograd backward for x, gamma and beta."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import group_norm as gn

        dtype, eps = torch.bfloat16, 1e-6
        x, w, b, dh = self._gn_inputs(n, c, s, dtype, True)
        _, mean, rstd = gn.group_norm_fwd(x, 32, w, b, eps, None)
        n0 = (gn.bwd_fast_launches, gn.bwd_wb_launches)
        got = gn.group_norm_bwd(x, dh, 32, w, b, mean, rstd, None)
        if (gn.bwd_fast_launches - n0[0], gn.bwd_wb_launches - n0[1]) != (1, 1):
            fail(f"group_norm_bwd_wb ({n},{c},{s}): not the fast variant's dgamma/dbeta call")
        want = gn.group_norm_bwd_plain(x, dh, 32, w, b, eps, None)
        e, es = x.numel(), x.element_size()
        copies = [(x.clone(), dh.clone()) for _ in range(
            max(2, math.ceil(ROTATE_BYTES / (2 * e * es))))]
        nbytes = 3 * e * es + 2 * c * es + 8 * c
        it = max(iters_for(nbytes), len(copies))
        times = _times(
            rotating(lambda xc, dc: gn.group_norm_bwd(xc, dc, 32, w, b, mean, rstd, None),
                     copies, hold=True),
            rotating(lambda xc, dc: gn.group_norm_bwd_plain(xc, dc, 32, w, b, eps, None),
                     copies, hold=True),
            it, bound(16.0 * e, nbytes, "float32"),
            lambda it: _library_bwd_ms(lambda xl, wl, bl: F.group_norm(xl, 32, wl, bl, eps),
                                       None, None, it,
                                       copies=[((xc, w, b), dc) for xc, dc in copies]),
            host=lambda: gn.group_norm_bwd(x, dh, 32, w, b, mean, rstd, None))
        del copies
        record(self.results, "group_norm_bwd_wb", path, compare_all(dtype, got, want),
               f"({n},{c},{math.isqrt(s)},{math.isqrt(s)}) dx+dgamma+dbeta", times, per_call)

    def _lora_inputs(self, m, n, k, dtype, r=LORA_RANK):
        """x (M, K) and g (M, N) in ``dtype``, scaled so that y and dx are
        O(1); W (N, K) in ``dtype``; the rank-r factors fp32, as the path
        keeps them."""
        import torch

        x = self.rnd((m, k), dtype)
        g = self.rnd((m, n), dtype, min(1.0, (k / n) ** 0.5))
        w = self.rnd((n, k), dtype, k**-0.5)
        down = self.rnd((r, k), torch.float32, k**-0.5)
        up = self.rnd((n, r), torch.float32, 0.1)
        return x, g, w, down, up

    def _lora_variant(self, name, nn, dtype, fn):
        """Run ``fn`` (one launch of the nt or nn kernel) and fail unless a
        bf16 call took the fast variant (every LoRA leg's dtypes) and an
        fp32 one the generic variant."""
        import torch
        from lycoris_tpu_torch.ops import lora_fused as lf

        counter = "dx_launches_fast" if nn else "launches_fast"
        n = getattr(lf, counter)
        out = fn()
        if getattr(lf, counter) - n != int(dtype == torch.bfloat16):
            fail(f"{name} {dtype}: the wrong variant took the call")
        return out

    def _lora_times(self, name, path, m, n, k, dtype, per_call, nn):
        """Times of the nt (``nn`` False) or nn kernel at one shape, each
        timed call on its own copy of x or g, W and the factors, the copies
        over :data:`ROTATE_BYTES` together and the outputs held, so inputs
        and outputs are not in L2 (the kernel, the plain version and the
        library call alike); the wrapper's host ms on one input. nt's
        library call is the merged route (the fp32 merge, then one matmul:
        the plain version, timed again); nn's is the dx GEMM of the merged
        route's autograd backward, the merge having run in its forward."""
        import torch
        import torch.nn.functional as F
        from lycoris_tpu_torch.ops import lora_fused as lf

        gamma = 0.5
        es = 2 if dtype == torch.bfloat16 else 4
        nbytes = (m * k + n * k + m * n) * es + 4 * LORA_RANK * (n + k)
        copies = [self._lora_inputs(m, n, k, dtype)
                  for _ in range(max(2, math.ceil(ROTATE_BYTES / nbytes)))]
        it = max(iters_for(nbytes), len(copies))
        bnd = bound(2.0 * m * n * k + 2.0 * n * k * LORA_RANK, nbytes, str(dtype)[6:])
        if nn:
            def call(x, g, w, d, u):
                return lf.lora_fused_nn(g, w, d, u, gamma)

            def plain_fn(x, g, w, d, u):
                return lf.fused_lora_dx_plain(g, w, d, u, gamma)

            def lib(it):
                s = timing_stream()
                s.wait_stream(torch.cuda.current_stream())
                cases = []
                with torch.cuda.stream(s):
                    for x, g, w, d, u in copies:
                        xl = x.detach().requires_grad_(True)
                        weff = lf.effective_weight_plain(w, d, u, gamma, dtype)
                        cases.append((F.linear(xl, weff), xl, g))
                return graph_ms(rotating(lambda out, xl, g: torch.autograd.grad(
                    out, xl, g, retain_graph=True), cases, hold=True), it)
        else:
            def call(x, g, w, d, u):
                return lf.lora_fused_nt(x, w, d, u, gamma)

            def plain_fn(x, g, w, d, u):
                return lf.fused_lora_matmul_plain(x, w, d, u, gamma)

            def lib(it):
                return graph_ms(rotating(plain_fn, copies, hold=True), it)
        times = _times(rotating(call, copies, hold=True), rotating(plain_fn, copies, hold=True),
                       it, bnd, lib, host=lambda: call(*copies[0]))
        ms, hms, pms, lms, (b, by) = times
        share = (f"{b / ms:.1%} of its bound" if ms >= b else
                 "UNDER its bound: the timing did not reach HBM")
        log(f"[kernels] {name} {path} ({m},{n},{k}) fast variant, {len(copies)} rotating copies: "
            f"kernel {ms:.4f} ms, {share} {b:.4f} ms ({by}); {ms / lms:.2f}x the library "
            f"{lms:.4f} ms; plain {pms:.4f} ms; the wrapper's host-clocked {hms:.4f} ms")
        self.results[name].setdefault("shapes", []).append(
            {"path": path, "shape": [m, n, k], "ms": ms, "host_ms": hms, "plain_ms": pms,
             "library_ms": lms, "bound_ms": b, "per": per_call})
        del copies
        return times

    def lora_fused_nt(self, path, m, n, k, dtype, per_call, timed):
        """The forward kernel against its plain version; the bf16 call
        (the path's dtypes) takes the fast variant and is timed."""
        import torch
        from lycoris_tpu_torch.ops import lora_fused as lf

        x, _, w, down, up = self._lora_inputs(m, n, k, dtype)
        gamma = 0.5
        y = self._lora_variant("lora_fused_nt", False, dtype,
                               lambda: lf.lora_fused_nt(x, w, down, up, gamma))
        y_ref = lf.fused_lora_matmul_plain(x, w, down, up, gamma)
        torch.cuda.synchronize()
        stats = compare(dtype, y, y_ref)
        del y, y_ref
        times = (self._lora_times("lora_fused_nt", path, m, n, k, dtype, per_call, False)
                 if timed else None)
        record(self.results, "lora_fused_nt", path, stats, f"({m},{n},{k})", times, per_call)

    def lora_fused_nn(self, path, m, n, k, dtype, per_call, timed):
        """The input-gradient kernel likewise."""
        import torch
        from lycoris_tpu_torch.ops import lora_fused as lf

        _, g, w, down, up = self._lora_inputs(m, n, k, dtype)
        gamma = 0.5
        dx = self._lora_variant("lora_fused_nn", True, dtype,
                                lambda: lf.lora_fused_nn(g, w, down, up, gamma))
        dx_ref = lf.fused_lora_dx_plain(g, w, down, up, gamma)
        torch.cuda.synchronize()
        stats = compare(dtype, dx, dx_ref)
        del dx, dx_ref
        times = (self._lora_times("lora_fused_nn", path, m, n, k, dtype, per_call, True)
                 if timed else None)
        record(self.results, "lora_fused_nn", path, stats, f"({m},{n},{k})", times, per_call)

    def lora_any_rank(self, m, n, k, r):
        """Rank ``r`` through both kernels (bf16, the fast variant's chunk
        loop) against their plain versions."""
        import torch
        from lycoris_tpu_torch.ops import lora_fused as lf

        x, g, w, down, up = self._lora_inputs(m, n, k, torch.bfloat16, r)
        y = self._lora_variant("lora_fused_nt", False, torch.bfloat16,
                               lambda: lf.lora_fused_nt(x, w, down, up, 0.5))
        dx = self._lora_variant("lora_fused_nn", True, torch.bfloat16,
                                lambda: lf.lora_fused_nn(g, w, down, up, 0.5))
        torch.cuda.synchronize()
        record(self.results, "lora_fused_nt", "sdxl", compare(
            torch.bfloat16, y, lf.fused_lora_matmul_plain(x, w, down, up, 0.5)),
            f"({m},{n},{k}) R{r} fast")
        record(self.results, "lora_fused_nn", "sdxl", compare(
            torch.bfloat16, dx, lf.fused_lora_dx_plain(g, w, down, up, 0.5)),
            f"({m},{n},{k}) R{r} fast")

    @staticmethod
    def _off16(t):
        """A contiguous copy of ``t`` one element past a 16-byte boundary,
        which the generic LoHa variants take."""
        import torch

        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    def hada_bwd_split(self, path, o_, i_, dtype, per_call, timed):
        """The split backward, fast variant, against its plain version and
        against the fused1 kernel (rel L2 1e-5), and its generic variant (on
        copies one element off 16 bytes) against the plain version. Timed
        like the fused backward, on rotating copies with the outputs held:
        the fast variant, the generic one ("gen", on copies off 16 bytes),
        the plain version and fused1; then each launch of the fast variant
        by torch.profiler (:func:`device_ms_by_kernel`)."""
        import torch
        from lycoris_tpu_torch.ops import hada

        w1d, w1u, w2d, w2u, g = self._hada_factors(o_, i_, 8, dtype)
        got = self._fast_variant("hada_bwd_split", "hada", "split_fast_launches",
                                 lambda: hada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, g))
        want = hada.hada_weight_bwd_split_plain(w1d, w1u, w2d, w2u, 0.5, g)
        fused = hada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, g)
        n = hada.split_generic_launches
        gen = hada.hada_bwd_split(*map(self._off16, (w1d, w1u, w2d, w2u)), 0.5, self._off16(g))
        if hada.split_generic_launches != n + 1:
            fail(f"hada_bwd_split ({o_},{i_}): copies off 16 bytes did not take the generic "
                 f"variant")
        torch.cuda.synchronize()
        # fp32: the two forms differ only in summation order; bf16 grads are
        # rounded, so a sum one side of a rounding boundary is a bf16 step
        vs_fused = max(rel_l2(a, f) for a, f in zip(got, fused))
        ok_fused = (vs_fused <= 1e-5 if dtype == torch.float32
                    else compare_all(dtype, got, fused)[0])
        gate = "1e-5" if dtype == torch.float32 else "the bf16 gates"
        ok_gen, _, _, rel_gen, _, _ = compare_all(dtype, gen, want)
        log(f"[kernels] hada_bwd_split {path} {str(dtype)[6:]} ({o_},{i_}) against the fused1 "
            f"kernel: rel L2 {vs_fused:.3e} (bound {gate}); generic variant against the plain "
            f"version: rel L2 {rel_gen:.3e}")
        del gen, fused
        times = None
        if timed:
            nbytes = (o_ * i_ + 4 * 8 * (o_ + i_)) * g.element_size()
            copies = self._hada_copies(o_, i_, dtype, nbytes)
            it = max(iters_for(nbytes), len(copies))
            # the function's own cost, as for hada_bwd: g and the factors
            # read once, the four grads written, 6R multiply-adds per element
            # of g (the split form reads g twice and forms both products in
            # each pass: its extra work, not the function's)
            times = _times(
                rotating(lambda *f: hada.hada_bwd_split(*f[:4], 0.5, f[4]), copies, hold=True),
                rotating(lambda *f: hada.hada_weight_bwd_split_plain(*f[:4], 0.5, f[4]), copies,
                         hold=True),
                it, bound(2.0 * 6 * 8 * o_ * i_, nbytes, "float32"),
                host=lambda: hada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, g))
            fused_ms = graph_ms(rotating(lambda *f: hada.hada_bwd(*f[:4], 0.5, f[4]), copies,
                                         hold=True), it)
            copies = [tuple(map(self._off16, c)) for c in copies]
            generic_ms = graph_ms(rotating(lambda *f: hada.hada_bwd_split(*f[:4], 0.5, f[4]),
                                           copies, hold=True), it)
            del copies
            passes = device_ms_by_kernel(lambda: hada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, g))
            parts = {"u_pass": 0.0, "d_pass": 0.0, "adder": 0.0}
            for name, ms in passes.items():
                key = ("adder" if "reduce" in name else "u_pass" if "true, false" in name
                       else "d_pass" if "false, true" in name else None)
                if key:
                    parts[key] += ms
            self._hada_share("hada_bwd_split", path, o_, i_, times, per_call)
            self.results["hada_bwd_split"]["shapes"][-1].update(
                generic_ms=generic_ms, fused1_ms=fused_ms,
                passes_ms=parts if passes else "not measured")
            ms = times[0]
            log(f"[kernels] hada_bwd_split {path} ({o_},{i_}) rotating copies: fast {ms:.4f} ms, "
                f"generic {generic_ms:.4f} ms, plain {times[2]:.4f} ms, fused1 {fused_ms:.4f} ms "
                f"({ms / fused_ms:.2f}x fused1); the fast variant's launches by the profiler "
                f"(one input): {parts if passes else 'not measured'}")
        ok, *stats = compare_all(dtype, got, want)
        record(self.results, "hada_bwd_split", path, (ok and ok_gen and ok_fused, *stats),
               f"({o_},{i_})", times, per_call)

    def geglu_bwd(self, path, b, t, f2, dtype, per_call, timed):
        import torch
        from lycoris_tpu_torch.ops import geglu

        h_full = self.rnd((b, t, f2), dtype, 2.0)
        dy = self.rnd((b, t, f2 // 2), dtype)
        got = geglu.geglu_bwd(h_full, dy)
        want = geglu.geglu_bwd_plain(h_full, dy)
        torch.cuda.synchronize()
        times = None
        if timed:
            n = b * t * f2 // 2
            nbytes = 5 * n * h_full.element_size()  # h, gate, dy read; two halves written
            # rotating copies of h_full and dy with the outputs held; no
            # single PyTorch call computes this backward: library_ms stays None
            copies = [(h_full.clone(), dy.clone())
                      for _ in range(max(2, math.ceil(ROTATE_BYTES / nbytes)))]
            it = max(iters_for(nbytes), len(copies))
            times = _times(rotating(geglu.geglu_bwd, copies, hold=True),
                           rotating(geglu.geglu_bwd_plain, copies, hold=True), it,
                           bound(25.0 * n, nbytes, "float32"),
                           host=lambda: geglu.geglu_bwd(h_full, dy))
            del copies
        record(self.results, "geglu_bwd", path, compare(dtype, got, want), f"({b},{t},{f2})",
               times, per_call)


def _paths(train: bool):
    """(path, shapes, activation dtypes, hada dtypes, per-step factor of the
    transformer kernels' forwards) of the two paths: SD1.5 serving (b4) or
    training (b8), and SDXL training (b4, 128x128, remat="transformer")."""
    import torch
    from lycoris_tpu_torch.models.unet import sd15_config, sdxl_config

    both = (torch.bfloat16, torch.float32)
    return (("sd15", path_shapes(sd15_config(), TRAIN_BATCH if train else UNET_BATCH, 64),
             both, both[::-1], 1),
            ("sdxl", path_shapes(sdxl_config(), SDXL_BATCH, SDXL_HW), both[:1], both[1:], 2))


def clip_ln_shapes() -> dict:
    """(rows, C) -> launches of the LayerNorm forward in one call of CLIP-L
    and one of CLIP-G on ``SDXL_BATCH`` x 77 token ids."""
    from lycoris_tpu_torch.models.clip import clip_g_config, clip_l_config

    return {(SDXL_BATCH * CONTEXT_TOKENS, c.hidden_size): 2 * c.num_layers + 1
            for c in (clip_l_config(), clip_g_config())}


def phase_kernels(results: dict):
    """Each forward kernel at the SD1.5 serving shapes (per UNet call) and the
    SDXL training shapes (per train step: the transformers' forwards twice),
    and the GroupNorm forward at the SD1.5 training shapes (batch 8)."""
    import torch
    from lycoris_tpu_torch.models.unet import sd15_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ck = Checks(results, seed=0)
    for path, sh, dts, hada_dts, again in _paths(train=False):
        for (bh, t, d), n in sh["flash"].items():
            for dt in dts:
                ck.flash_fwd(path, bh, t, d, dt, n * again, dt == dts[0])
        for (rows, c), n in sh["ln"].items():
            for dt in dts:
                ck.layer_norm_fwd(path, rows, c, dt, n * again, dt == dts[0])
        for (o_, i_), n in sh["hada"].items():
            for dt in hada_dts:
                ck.hada_fwd(path, o_, i_, dt, n * again, dt == hada_dts[0])
        b = UNET_BATCH if path == "sd15" else SDXL_BATCH
        for (c, s, act), n in sh["gn"].items():
            for dt in dts:
                ck.group_norm_fwd(path, b, c, s, act, dt, n * (again if act is None else 1),
                                  dt == dts[0])
    # the LayerNorms of the CLIP-L and CLIP-G encoders at b4 x 77 tokens,
    # per encoder call (two a layer and the final one)
    for (rows, c), n in clip_ln_shapes().items():
        for dt in (torch.bfloat16, torch.float32):
            ck.layer_norm_fwd("clip", rows, c, dt, n, dt == torch.bfloat16)
    # the GroupNorm forwards of a SD1.5 train step (batch 8), timed per shape
    for (c, s, act), n in path_shapes(sd15_config(), TRAIN_BATCH, 64)["gn"].items():
        ck.group_norm_fwd("sd15_b8", TRAIN_BATCH, c, s, act, torch.bfloat16, n, True)
    # the fused LoRA matmul at the LoRA training legs' linear shapes (SD1.5
    # b8, SDXL b4), weighted by the layers of each shape per train step
    for path, sh, _, _, again in _paths(train=True):
        for (m, n, k), layers in sh["lora"].items():
            for dt in (torch.bfloat16, torch.float32):
                ck.lora_fused_nt(path, m, n, k, dt, layers * again, dt == torch.bfloat16)


def phase_kernels_bwd(results: dict):
    """Each backward kernel at the SD1.5 training shapes (batch 8) and the
    SDXL training shapes (batch 4), per train step."""
    import torch

    ck = Checks(results, seed=1)
    for path, sh, dts, hada_dts, _ in _paths(train=True):
        for (bh, t, d), n in sh["flash"].items():
            for dt in dts:
                ck.flash_bwd(path, bh, t, d, dt, n, dt == dts[0])
        for (rows, c), n in sh["ln"].items():
            for dt in dts:
                ck.layer_norm_bwd(path, rows, c, dt, n, dt == dts[0])
        for (o_, i_), n in sh["hada"].items():
            for dt in hada_dts:
                ck.hada_bwd(path, o_, i_, dt, n, dt == hada_dts[0])
        b = TRAIN_BATCH if path == "sd15" else SDXL_BATCH
        for (c, s, act), n in sh["gn_grad"].items():
            for dt in dts:
                ck.group_norm_bwd(path, b, c, s, act, dt, n, dt == dts[0])
        for (bb, t, f2), n in sh["geglu"].items():
            for dt in dts:
                ck.geglu_bwd(path, bb, t, f2, dt, n, dt == dts[0])
        for (o_, i_), n in sh["hada"].items():
            for dt in (torch.float32, torch.bfloat16):
                ck.hada_bwd_split(path, o_, i_, dt, n, dt == torch.float32)
        for (m, n_, k), layers in sh["lora"].items():
            for dt in (torch.bfloat16, torch.float32):
                ck.lora_fused_nn(path, m, n_, k, dt, layers, dt == torch.bfloat16)
    # LoHa at rank 128: the rank JAX's hada_weight gate takes and the shared
    # memory of the old fused backward could not hold
    ck.hada_any_rank(1280, 1280, 128)
    # the fused LoRA matmul at rank 320, which its old shared memory refused
    ck.lora_any_rank(4096, 1280, 1280, 320)
    lora_route(results)


def lora_route(results: dict):
    """The fused route against the merged one, per SDXL b4 and SD1.5 b8
    step, from the rotating-copy rows: the fused nt at each LoRA layer's
    forwards (twice a step under SDXL's checkpointing) plus the nn kernel
    once, against the merged route's merge + ``F.linear`` as often plus
    its dx GEMM. Logged and kept under the nn row's "route_rows" (its
    "route" names the kernel's language, as every row's does)."""
    route = {}
    for path in ("sdxl", "sd15"):
        fused = merged = 0.0
        for name in ("lora_fused_nt", "lora_fused_nn"):
            for sh in results[name].get("shapes", []):
                if sh["path"] == path:
                    fused += sh["ms"] * sh["per"]
                    merged += sh["library_ms"] * sh["per"]
        route[path] = {"fused_ms": fused, "merged_ms": merged}
        step = "SDXL b4" if path == "sdxl" else "SD1.5 b8"
        log(f"[kernels] LoRA route per {step} step (rotating copies): fused nt + nn {fused:.3f} "
            f"ms against the merged route {merged:.3f} ms ({fused / merged:.2f}x)")
    results["lora_fused_nn"]["route_rows"] = route


def phase_lora_fused_op(results: dict):
    """The public op ``fused_lora_matmul`` (forward kernel, then its
    backward: the dx kernel and the fp32 factor gradients) at every linear
    shape of the SD1.5 b8 and SDXL b4 LoRA legs in bf16, against autograd of
    its plain version. Neither package dispatches it on the adapter path, so
    this is the path its kernels' launches are read from: the counts are
    set to 0 just before and read just after."""
    import torch
    from lycoris_tpu_torch.ops import lora_fused as lf

    ck = Checks(results, seed=2)
    cases = []
    for path, sh, _, _, _ in _paths(train=True):
        for m, n, k in sh["lora"]:
            x, g, w, down, up = ck._lora_inputs(m, n, k, torch.bfloat16)
            cases.append((path, (m, n, k), w, g, [x, down, up]))
    outs = []
    torch.cuda.synchronize()
    lf.launches = lf.dx_launches = lf.launches_fast = lf.dx_launches_fast = 0
    for _, _, w, g, inputs in cases:
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        y = lf.fused_lora_matmul(leaves[0], w, leaves[1], leaves[2], 0.5)
        outs.append((y.detach(), *torch.autograd.grad(y, leaves, g)))
    torch.cuda.synchronize()
    launches = {"lora_fused_nt": lf.launches, "lora_fused_nn": lf.dx_launches}
    if launches != {"lora_fused_nt": len(cases), "lora_fused_nn": len(cases)}:
        fail(f"[lora_fused_op] launches {launches}, want {len(cases)} of each")
    fast = {"lora_fused_nt": lf.launches_fast, "lora_fused_nn": lf.dx_launches_fast}
    if fast != launches:
        fail(f"[lora_fused_op] fast-variant launches {fast} of {launches}: every bf16 launch "
             f"must take the fast variant")
    for name, n in launches.items():
        results[name]["launches"] = n
        results[name]["variants"] = {"fast": fast[name], "generic": n - fast[name]}
    worst = 0.0
    for (path, shape, w, g, inputs), got in zip(cases, outs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        y = lf.fused_lora_matmul_plain(leaves[0], w, leaves[1], leaves[2], 0.5)
        want = (y.detach(), *torch.autograd.grad(y, leaves, g))
        # each output in units of its reference's RMS: the factor gradients
        # sum over up to 32768 tokens, so the bf16 MSE bound, written for O(1)
        # outputs, is applied relative to their size
        rms = [float(b.float().pow(2).mean().sqrt()) for b in want]
        ok, _, _, rel, _, _ = compare_all(torch.bfloat16, [a.float() / r for a, r in zip(got, rms)],
                                          [b.float() / r for b, r in zip(want, rms)])
        worst = max(worst, rel)
        if not ok:
            fail(f"[lora_fused_op] {path} {shape}: y or a gradient over its bf16 bound "
                 f"(rel L2 {rel:.3e})")
    log(f"[lora_fused_op] fused_lora_matmul forward + backward at {len(cases)} shapes: "
        f"launches {launches}, all fast; worst rel L2 of y, dx, d_down, d_up against autograd of the "
        f"plain version {worst:.3e} (bound 1e-2)")


# each kernel: its route and source, the TPU kernel it replaces, and the path
# its launches are read from: "train_sdxl" (the SDXL LoRA, LoKr and LoHa
# legs, the adapter training path of bench.py's headline case),
# "lora_fused_op" (the public fused_lora_matmul op, which neither package
# dispatches on the adapter path), "train_loha_split" (SD1.5 LoHa with
# ops.hada.BWD = "split")
KERNELS = {
    "flash_fwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/flash_fwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/flash.py:87",
    },
    "layer_norm_fwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/ln_fwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/layer_norm.py:84",
    },
    "hada_fwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/hada_fwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/hada.py:76",
    },
    "flash_bwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/flash_bwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/flash.py:238",
    },
    "layer_norm_bwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/ln_bwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/layer_norm.py:104",
    },
    "hada_bwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/hada_bwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/hada.py:188",
    },
    "group_norm_fwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/gn_fwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/group_norm_v2.py:125",
    },
    "group_norm_bwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/gn_bwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/group_norm_v2.py:125",
    },
    "geglu_bwd": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/geglu_bwd.cu",
        "path": "train_sdxl",
        "replaces": "lycoris_tpu/ops/geglu.py:58",
    },
    "lora_fused_nt": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/lora_fused.cu",
        "path": "lora_fused_op",
        "replaces": "lycoris_tpu/ops/lora_fused.py:97",
        "per": "the LoRA linear layers of one SDXL b4 train step (the op is not dispatched there)",
    },
    "lora_fused_nn": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/lora_fused.cu",
        "path": "lora_fused_op",
        "replaces": "lycoris_tpu/ops/lora_fused.py:97",
        "per": "the LoRA linear layers of one SDXL b4 train step (the op is not dispatched there)",
    },
    "hada_bwd_split": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/hada_bwd_split.cu",
        "path": "train_loha_split",
        "replaces": "lycoris_tpu/ops/hada.py:225",
        "per": "the LoHa layers of one SDXL b4 train step (launches: the SD1.5 b8 split leg)",
    },
    # the LayerNorm and GroupNorm backwards that also form dw and db (train_norm)
    "layer_norm_bwd_wb": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/ln_bwd.cu",
        "path": "train_sdxl_norm",
        "replaces": "lycoris_tpu/ops/layer_norm.py:104",
        "per": "one SDXL b4 train_norm step: every LayerNorm's dx, dw and db (under \"sd15\": "
               "one SD1.5 b8 train_norm step)",
    },
    "group_norm_bwd_wb": {
        "route": "cuda",
        "source": "lycoris_tpu_torch/csrc/gn_bwd.cu",
        "path": "train_sdxl_norm",
        "replaces": "lycoris_tpu/ops/group_norm_v2.py:125",
        "per": "one SDXL b4 train_norm step: each Transformer2DModel GroupNorm's dx, dgamma, "
               "dbeta (under \"sd15\": one SD1.5 b8 train_norm step)",
    },
}

# what a kernel's times in the kernel line are summed over, unless its entry
# names another denominator
PER_SDXL_STEP = "one SDXL b4 train step (launches: the first SDXL leg that runs the kernel)"

# ---------------------------------------------------------------------------
# phases 5-8: the serving path
# ---------------------------------------------------------------------------

ADAPTER_FILL_STD = 0.02  # seeded values added to every trainable factor


def build_unet(device, dtype, seed, config="sd15", remat=False):
    import torch
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel, sd15_config, sdxl_config

    cfg = (sd15_config if config == "sd15" else sdxl_config)(dtype, remat=remat)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = UNet2DConditionModel(cfg, device=device, param_dtype=dtype, generator=gen)
    return model.eval()


# the kohya "full" UNet targets (config.py PRESET["full"]'s unet_* lists),
# given to the standalone wrapper as target_module / target_name
FULL_UNET_TARGETS = {
    "target_module": ["Transformer2DModel", "ResnetBlock2D", "Downsample2D", "Upsample2D"],
    "target_name": ["conv_in", "conv_out", "time_embedding.linear_1", "time_embedding.linear_2"],
}


def adapter_net(model, algo: str, device, seed: int, targets=None, dora=False, **net_kw):
    """A LyCORIS network (dim 8, alpha 4; LoKr factor 8; 3x3 convs conv_dim 8,
    conv_alpha 4; with ``dora``, DoRA on the output side; ``net_kw`` to
    ``create_lycoris``, a ``preset`` among them) on the attn-mlp targets, or
    ``targets`` (target_module / target_name), with seeded
    nonzero factors: LoKr's lokr_w2(_b), LoHa's hada_w2_a, LoRA's lora_up,
    the OFT blocks and the other algorithms' deltas start at zero, which
    would make dW = 0 (DoRA's dora_scale, the row norms of the layer's
    weight, moves by the same noise)."""
    import torch
    from lycoris_tpu_torch import LycorisNetwork, create_lycoris

    LycorisNetwork.apply_preset(targets or {"target_module": ["Transformer2DModel"]})
    try:
        net = create_lycoris(model, 1.0, **{
            "linear_dim": LORA_RANK, "linear_alpha": 4.0, "algo": algo, "factor": 8,
            "conv_dim": LORA_RANK, "conv_alpha": 4.0, "device": device, "seed": seed,
            "dora_wd": dora, **net_kw})
    finally:
        LycorisNetwork.reset_preset()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=device) * ADAPTER_FILL_STD)
    return net


def adapter_state_dict(model, algo: str, device, seed: int, targets=None, dora=False,
                       **net_kw) -> dict:
    """:func:`adapter_net`'s network in the reference key grammar."""
    return adapter_net(model, algo, device, seed, targets, dora, **net_kw).state_dict()


def reset_counts():
    from lycoris_tpu_torch.functional import merged
    from lycoris_tpu_torch.ops import flash, geglu, group_norm, hada, layer_norm, lora_fused

    flash.launches = layer_norm.launches = hada.launches = group_norm.launches = 0
    flash.bwd_launches = layer_norm.bwd_launches = hada.bwd_launches = 0
    group_norm.bwd_launches = geglu.bwd_launches = group_norm.copies = flash.pad_copies = 0
    lora_fused.launches = lora_fused.dx_launches = hada.split_launches = 0
    hada.split_fast_launches = hada.split_generic_launches = 0
    lora_fused.launches_fast = lora_fused.dx_launches_fast = 0
    layer_norm.fwd_vec_launches = layer_norm.fwd_generic_launches = 0
    layer_norm.bwd_vec_launches = layer_norm.bwd_generic_launches = 0
    hada.fast_launches = hada.generic_launches = 0
    hada.bwd_fast_launches = hada.bwd_generic_launches = 0
    group_norm.fast_launches = group_norm.generic_launches = 0
    group_norm.bwd_fast_launches = group_norm.bwd_generic_launches = 0
    layer_norm.bwd_wb_launches = group_norm.bwd_wb_launches = 0
    merged.applications = 0


def read_counts() -> dict:
    """Launches of every kernel (and of the LayerNorm and GroupNorm
    backwards, those that also formed dw and db), and factored layer
    applications."""
    from lycoris_tpu_torch.functional import merged
    from lycoris_tpu_torch.ops import flash, geglu, group_norm, hada, layer_norm, lora_fused

    return {"flash_fwd": flash.launches, "layer_norm_fwd": layer_norm.launches,
            "hada_fwd": hada.launches, "group_norm_fwd": group_norm.launches,
            "flash_bwd": flash.bwd_launches, "layer_norm_bwd": layer_norm.bwd_launches,
            "hada_bwd": hada.bwd_launches, "group_norm_bwd": group_norm.bwd_launches,
            "geglu_bwd": geglu.bwd_launches, "lora_fused_nt": lora_fused.launches,
            "lora_fused_nn": lora_fused.dx_launches, "hada_bwd_split": hada.split_launches,
            "layer_norm_bwd_wb": layer_norm.bwd_wb_launches,
            "group_norm_bwd_wb": group_norm.bwd_wb_launches, "factored": merged.applications}


def check_fast(tag: str, counts: dict, hada_variant: str = "fast") -> None:
    """Fail unless every LoHa forward, fused backward and split backward,
    and every GroupNorm forward and backward, since the last reset took the
    fast variant, and every LayerNorm forward and backward the vectorised
    one (every LoHa layer of the SD1.5 and SDXL paths is rank 8, every
    GroupNorm shape holds whole 16-byte rows, every UNet LayerNorm width is
    one the vectorised variant takes in bf16). ``hada_variant="generic"``:
    every LoHa forward and fused backward took the generic variant instead
    (a LoHa of another rank than 8)."""
    from lycoris_tpu_torch.ops import group_norm, hada
    from lycoris_tpu_torch.ops import layer_norm as ln

    for what, ops, fwd, bwd in (("LoHa", hada, "hada_fwd", "hada_bwd"),
                                ("GroupNorm", group_norm, "group_norm_fwd", "group_norm_bwd")):
        got = (ops.fast_launches, ops.generic_launches, ops.bwd_fast_launches,
               ops.bwd_generic_launches)
        want = (counts[fwd], 0, counts[bwd], 0)
        if ops is hada and hada_variant == "generic":
            want = (0, counts[fwd], 0, counts[bwd])
        if got != want:
            fail(f"{tag} {what}: forward {got[0]} fast and {got[1]} generic of {counts[fwd]}, "
                 f"backward {got[2]} fast and {got[3]} generic of {counts[bwd]} (want "
                 f"{hada_variant if ops is hada else 'fast'})")
    split = (hada.split_fast_launches, hada.split_generic_launches)
    if split != (counts["hada_bwd_split"], 0):
        fail(f"{tag} LoHa split backward: {split[0]} fast and {split[1]} generic of "
             f"{counts['hada_bwd_split']}")
    for what, vec, generic, key in (
            ("forward", ln.fwd_vec_launches, ln.fwd_generic_launches, "layer_norm_fwd"),
            ("backward", ln.bwd_vec_launches, ln.bwd_generic_launches, "layer_norm_bwd")):
        if vec != counts[key] or generic:
            fail(f"{tag} LayerNorm {what}: {vec} vectorised and {generic} generic launches "
                 f"of {counts[key]}")


def gn_copies() -> int:
    """GroupNorm inputs the wrappers had to make contiguous since the last reset."""
    from lycoris_tpu_torch.ops import group_norm

    return group_norm.copies


def check_no_pad_copies(tag: str) -> None:
    """Fail if a flash input needed the padded copy since the last reset:
    the UNets' head-split layouts are read by TMA in place."""
    from lycoris_tpu_torch.ops import flash

    if flash.pad_copies:
        fail(f"{tag} {flash.pad_copies} flash inputs were copied for TMA (want 0)")


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def serve(model, algo, sd, requests, steps, results, card):
    """Serve ``requests`` requests of 2 prompts through DDIM + CFG with the
    adapter live (merged forward: one op with W + dW per adapted layer);
    check launch counts, finiteness, and live == merge_to."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.models.unet import sd15_config
    from lycoris_tpu_torch.sampler import make_ddim_sampler

    dev = torch.device("cuda")
    tag = f"[{algo}]"
    net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
    net.to(dev)
    n_mod = len(net.loras)
    if n_mod != SD15_ADAPTED:
        fail(f"{tag} {n_mod} adapter modules, want {SD15_ADAPTED} (16 transformers x 12 layers)")
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
    per_call = checked_counts(sd15_config(), UNET_BATCH, 64, algo, False, False, SD15_CALL,
                              SD15_ADAPTED, SD15_FACTORED)
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
    want = {k: v * calls for k, v in per_call.items()}
    check_no_pad_copies(tag)
    log(f"{tag} launches {counts} over {calls} UNet calls (want {want}); GroupNorm input "
        f"copies {gn_copies()}; flash pad copies 0")
    if counts != want:
        fail(f"{tag} launch counts {counts} != {want}")
    check_fast(tag, counts)
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


def cpu_copy(model, cfg):
    """The port's UNet on the CPU in fp32 with ``model``'s weights."""
    import torch
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel

    cpu = UNet2DConditionModel(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu().float() for k, v in model.state_dict().items()},
                        assign=True)
    return cpu.eval()


def phase_e2e(model, sd):
    """One UNet call at full width (batch 1, 64x64, LoKr live): the card
    (bf16, kernels) against the port on the CPU (fp32, plain versions)."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.models.unet import sd15_config

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(1, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, 77, 768, generator=gen, device=dev).to(torch.bfloat16)
    t = torch.tensor([501], dtype=torch.int32, device=dev)

    net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
    net.apply_to(merged_forward=True)
    reset_counts()
    with torch.no_grad():
        got = model(x, t, ctx).float().cpu()
    check_no_pad_copies("[e2e]")
    check_fast("[e2e]", read_counts())
    net.restore()

    cpu = cpu_copy(model, sd15_config(torch.float32))
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
# phases 9-26: the training paths
# ---------------------------------------------------------------------------


def make_net(model, sd, algo=None, rates=None):
    """The network of the adapter in ``sd``: loaded from it as a file would
    be, or, with dropout ``rates``, built by ``create_lycoris`` with them on
    the attn-mlp targets (as ``adapter_state_dict``) and given its values."""
    from lycoris_tpu_torch import LycorisNetwork, create_lycoris, create_lycoris_from_weights

    if not rates:
        return create_lycoris_from_weights(1.0, None, model, weights_sd=sd)[0]
    LycorisNetwork.apply_preset({"target_module": ["Transformer2DModel"]})
    try:
        net = create_lycoris(model, 1.0, linear_dim=LORA_RANK, linear_alpha=4.0, algo=algo,
                             factor=8, **rates)
    finally:
        LycorisNetwork.reset_preset()
    net.load_state_dict(sd, strict=True)
    return net


def train(model, algo, sd, batch, want, steps, results, card, tag, path=None, adapted=None,
          rates=None, drop_seed=None, trainer_kw=None, step_check=None, after=None, net=None,
          profile=False):
    """``steps`` AdamW steps of ``DiffusionTrainer`` on the adapter in ``sd``
    (the first a warm-up); per step: launches of every kernel and factored
    layer (``want``), every LayerNorm backward vectorised, finite loss; then
    the base weights bit-identical and every adapter parameter changed, or
    with module dropout in ``rates``, those of every module the trainer's
    drop seeds keep in some step (a module dropped in every step gets zero
    gradients, and AdamW's decay of 1e-8 rounds away in fp32).
    ``adapted``: the adapter-module count the network must have. The
    launches of the kernels whose ``path`` is ``path`` go into the kernel
    table. ``drop_seed``, if given, reseeds the trainer's drop-seed
    generator. ``trainer_kw`` goes to the trainer (``merge_mode``,
    ``scale_weight_norms``); ``step_check(tr, net)`` runs after each step's
    checks, ``after(tr, net)`` after the last step's. ``net``: a network to
    train in place of the one made from ``sd``. ``profile``: one more step
    under torch.profiler, its device ms and kernels logged beside the steps'
    host-clocked ms (:func:`step_profile`). Returns the trained adapter's
    state dict."""
    import torch
    from lycoris_tpu_torch.modules import base as mbase
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    dev = torch.device("cuda")
    if net is None:
        net = make_net(model, sd, algo, rates)
    if adapted is not None and len(net.loras) != adapted:
        fail(f"{tag} {len(net.loras)} adapter modules, want {adapted}")
    tr = DiffusionTrainer(model, net, lr=1e-4, weight_dtype=torch.bfloat16,
                          generator=torch.Generator(device=dev).manual_seed(21),
                          **(trainer_kw or {}))
    if drop_seed is not None:
        tr.drop_generator.manual_seed(drop_seed)
    kept = set(net.lora_map)
    if rates and rates.get("module_dropout"):
        # the trainer's step seeds, then each module's keep flag per step
        gen = torch.Generator()
        gen.set_state(tr.drop_generator.get_state())
        seeds = [int(torch.randint(0, 2**62, (), generator=gen)) for _ in range(steps)]
        kept = {ln for ln in net.lora_map if any(
            float(mbase.module_keep(mbase.draw_generator(mbase.fold_in(s, ln), mbase.MODULE_SALT,
                                                         dev), rates["module_dropout"]))
            for s in seeds)}
    base = [p.detach().clone() for p in model.parameters()]
    before = {(ln, k): p.detach().clone()
              for ln, sub in net.trainable_params().items() for k, p in sub.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses, totals, copies = [], [], Counter(), 0
    for _ in range(steps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss = tr.train_step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = read_counts()
        copies += gn_copies()
        if counts != want:
            fail(f"{tag} launch counts per step {counts} != {want}")
        check_no_pad_copies(tag)
        check_fast(tag, counts)
        totals.update(counts)
        losses.append(float(loss))
        if not math.isfinite(losses[-1]):
            fail(f"{tag} loss {losses[-1]} at step {len(losses)}")
        if step_check is not None:
            step_check(tr, net)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} launches per step {want} over {steps} steps, every LayerNorm forward and "
        f"backward vectorised, every LoHa and GroupNorm kernel on its fast variant; "
        f"GroupNorm input copies {copies}; flash pad copies 0")
    for name, meta in KERNELS.items():
        if meta["path"] == path and want.get(name) and not results[name]["launches"]:
            results[name]["launches"] = totals[name]
            # every one vectorised or fast (checked per step)
            if name in ("layer_norm_fwd", "layer_norm_bwd"):
                results[name]["variants"] = {"vectorised": totals[name], "generic": 0}
            if name in ("hada_fwd", "hada_bwd", "hada_bwd_split", "group_norm_fwd",
                        "group_norm_bwd"):
                results[name]["variants"] = {"fast": totals[name], "generic": 0}
    changed = {(ln, k) for ln, sub in net.trainable_params().items() for k, p in sub.items()
               if not torch.equal(p.detach(), before[ln, k])}
    unchanged = [k for k in before if k not in changed and k[0] in kept]
    if unchanged:
        fail(f"{tag} {len(unchanged)} adapter parameters did not change, e.g. {unchanged[:3]}")
    if len(kept) < len(net.lora_map):
        stale = [k for k in changed if k[0] not in kept]
        log(f"{tag} {len(net.lora_map) - len(kept)} modules dropped in all {steps} steps "
            f"(module dropout), {len(stale)} of their parameters changed")
        if stale:
            fail(f"{tag} parameters of modules dropped in every step changed: {stale[:3]}")
    if not all(torch.equal(p, b) for p, b in zip(model.parameters(), base)):
        fail(f"{tag} the frozen base weights changed")
    steady = secs[1:]
    shape = tuple(batch["latents"].shape)
    log(f"{tag} latents {shape}, {len(net.loras)} adapters: losses "
        f"{[round(x, 5) for x in losses]}; s/step {[round(x, 4) for x in secs]} (the first "
        f"includes warm-up); steady {min(steady):.4f}-{max(steady):.4f} s/step, peak memory "
        f"{peak:.2f} GiB ({card}; host-clocked smoke reading, not a benchmark)")
    results["training"][tag.strip("[]")] = {"s_per_step": secs, "losses": losses,
                                            "peak_gib": peak, "gn_copies": copies,
                                            "launches_per_step": want}
    if profile:
        results["training"][tag.strip("[]")].update(step_profile(tr, batch, tag, steady, card))
    if after is not None:
        after(tr, net)
    trained = {k: v.clone() for k, v in net.state_dict().items()}
    net.restore()
    del tr, net, base, before
    torch.cuda.empty_cache()
    return trained


def step_profile(tr, batch, tag, steady, card) -> dict:
    """One more train step of ``tr`` under torch.profiler: its kernels'
    summed device ms and their count, beside the fastest steady step's
    host-clocked ms (to the device's end); the device's busy share of a
    step is their ratio."""
    dev_ms, kernels = kernel_totals(lambda: tr.train_step(batch), calls=1, warmup=0)
    host_ms = min(steady) * 1e3
    if dev_ms is None:
        log(f"{tag} one profiled step: the profiler saw no device time (device ms not "
            f"measured); host-clocked {host_ms:.2f} ms a step ({card})")
        return {"host_ms_per_step": host_ms, "device_ms_per_step": None,
                "kernels_per_step": None}
    log(f"{tag} one profiled step: {kernels:.0f} kernels, device {dev_ms:.2f} ms; host-clocked "
        f"{host_ms:.2f} ms a step (the fastest steady step): the device busy {dev_ms / host_ms:.1%}"
        f" of it ({card})")
    return {"host_ms_per_step": host_ms, "device_ms_per_step": dev_ms, "kernels_per_step": kernels}


def sd15_batch():
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    return {
        "latents": torch.randn(TRAIN_BATCH, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16),
        "context": torch.randn(TRAIN_BATCH, 77, 768, generator=gen, device=dev).to(torch.bfloat16),
    }


def sdxl_batch():
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    b = SDXL_BATCH
    return {
        "latents": torch.randn(b, 4, SDXL_HW, SDXL_HW, generator=gen, device=dev).to(torch.bfloat16),
        "context": torch.randn(b, 77, 2048, generator=gen, device=dev).to(torch.bfloat16),
        "added_cond": torch.randn(b, SDXL_ADDED, generator=gen, device=dev).to(torch.bfloat16),
    }


def phase_loha_split(model, sd, batch, results, card):
    """LoHa at b8 with ``ops.hada.BWD = "split"``: 3 train steps whose LoHa
    backwards all take the split kernels (hada_bwd 0, hada_bwd_split 192 a
    step), then one loss and every adapter gradient under split against
    fused1 on the same batch, noise and timesteps (rel 1e-3: the two forms
    differ in summation order, and cuDNN's backward may differ run to
    run). The selection is reset in a ``finally``."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.models.unet import sd15_config
    from lycoris_tpu_torch.ops import hada
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    want = checked_counts(sd15_config(), TRAIN_BATCH, 64, "loha", True, False, SD15_STEP,
                          SD15_ADAPTED, SD15_FACTORED, split=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    noise = torch.randn(batch["latents"].shape, generator=gen, device=dev)
    t = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
    got = {}
    try:
        hada.BWD = "split"
        train(model, "loha", sd, batch, want, 3, results, card, "[train_loha_split]",
              path="train_loha_split")
        for mode in ("split", "fused1"):
            hada.BWD = mode
            net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
            tr = DiffusionTrainer(model, net, weight_dtype=torch.bfloat16)
            loss = tr.loss_fn(batch["latents"], batch["context"], noise, t)
            loss.backward()
            grads = torch.cat([p.grad.float().reshape(-1)
                               for _, sub in sorted(net.trainable_params().items())
                               for _, p in sorted(sub.items())])
            got[mode] = (float(loss.detach()), grads)
            net.restore()
            del tr, net, loss
    finally:
        hada.BWD = "fused1"
    (loss_s, g_s), (loss_f, g_f) = got["split"], got["fused1"]
    loss_rel, grad_rel = abs(loss_s - loss_f) / abs(loss_f), rel_l2(g_s, g_f)
    log(f"[train_loha_split] b{TRAIN_BATCH} loss split {loss_s:.6f} vs fused1 {loss_f:.6f}: rel "
        f"{loss_rel:.3e}; adapter gradient ({g_f.numel()} values) rel L2 {grad_rel:.3e} "
        f"(bounds 1e-3)")
    if not (loss_rel <= 1e-3 and grad_rel <= 1e-3 and bool(torch.isfinite(g_s).all())):
        fail(f"[train_loha_split] split vs fused1: loss rel {loss_rel:.3e}, gradient rel L2 "
             f"{grad_rel:.3e}")
    torch.cuda.empty_cache()


DROPOUT_RATES = {"rank_dropout": 0.25, "module_dropout": 0.1}


def phase_dropout(model, sd, batch, results, card):
    """LoKr at b8 with rank and module dropout: 3 train steps whose every
    adapted layer leaves the merged and factored routes for its delta
    forward (the LoKr launch counts with factored 0), then one step's
    adapter gradients for drop seeds 5, 5 and 6: the same seed gives the
    same gradients (rel L2 1e-3: cuDNN's backward may differ run to run),
    another seed other masks and gradients far apart (rel L2 above 1e-2)."""
    import torch
    from lycoris_tpu_torch.models.unet import sd15_config
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    tag = "[train_lokr_dropout]"
    want = {**checked_counts(sd15_config(), TRAIN_BATCH, 64, "lokr", True, False, SD15_STEP,
                             SD15_ADAPTED, SD15_FACTORED), "factored": 0}
    train(model, "lokr", sd, batch, want, 3, results, card, tag, rates=DROPOUT_RATES,
          drop_seed=5)
    dev = torch.device("cuda")

    def step_grads(drop_seed):
        net = make_net(model, sd, "lokr", DROPOUT_RATES)
        tr = DiffusionTrainer(model, net, lr=1e-4, weight_dtype=torch.bfloat16,
                              generator=torch.Generator(device=dev).manual_seed(21))
        tr.drop_generator.manual_seed(drop_seed)
        loss = float(tr.train_step(batch))
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float()
                           .reshape(-1) for _, sub in sorted(net.trainable_params().items())
                           for _, p in sorted(sub.items())])
        net.restore()
        del tr, net
        return loss, grads

    (loss_a, g_a), (loss_r, g_r), (loss_b, g_b) = (step_grads(s) for s in (5, 5, 6))
    same, other = rel_l2(g_r, g_a), rel_l2(g_b, g_a)
    log(f"{tag} one step's adapter gradient ({g_a.numel()} values): drop seed 5 twice rel L2 "
        f"{same:.3e} (bound 1e-3), seeds 5 and 6 rel L2 {other:.3e} (want above 1e-2); "
        f"losses {loss_a:.6f} {loss_r:.6f} {loss_b:.6f}")
    finite = all(math.isfinite(x) for x in (loss_a, loss_r, loss_b)) and all(
        bool(torch.isfinite(g).all()) for g in (g_a, g_r, g_b))
    if not (finite and same <= 1e-3 and other > 1e-2):
        fail(f"{tag} dropout gradients: same seed rel L2 {same:.3e}, other seed {other:.3e}, "
             f"finite {finite}")
    torch.cuda.empty_cache()


def phase_train_e2e(model, sd, cfg_cpu, tag, ctx_dim=768, added_dim=None, kinds=None):
    """One eps-MSE loss and every adapter gradient (LoKr or LoRA) at full width,
    batch 1, 64x64 latents: the card (bf16, kernels, factored backward)
    against the port on the CPU (fp32, plain versions), with the same noise
    and timestep. ``kinds``, if given, is the count of adapter modules by
    class name that the network must hold."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    lat = torch.randn(1, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, 77, ctx_dim, generator=gen, device=dev).to(torch.bfloat16)
    noise = torch.randn(1, 4, 64, 64, generator=gen, device=dev)
    t = torch.tensor([501], dtype=torch.long, device=dev)
    added = (None if added_dim is None else
             torch.randn(1, added_dim, generator=gen, device=dev).to(torch.bfloat16))

    def loss_and_grads(m, net, wd, args):
        tr = DiffusionTrainer(m, net, weight_dtype=wd)
        loss = tr.loss_fn(*args)
        loss.backward()
        grads = {f"{ln}.{k}": p.grad.float().cpu()
                 for ln, sub in net.trainable_params().items() for k, p in sub.items()}
        net.restore()
        return float(loss.detach()), grads

    net, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=sd)
    if kinds is not None and Counter(type(lyco).__name__ for lyco in net.loras) != kinds:
        fail(f"{tag} adapter modules {dict(Counter(type(lyco).__name__ for lyco in net.loras))}")
    reset_counts()
    got_loss, got = loss_and_grads(model, net, torch.bfloat16, (lat, ctx, noise, t, added))
    check_no_pad_copies(tag)
    check_fast(tag, read_counts())
    del net
    torch.cuda.empty_cache()

    cpu = cpu_copy(model, cfg_cpu)
    net_cpu, _ = create_lycoris_from_weights(
        1.0, None, cpu, weights_sd={k: v.float().cpu() for k, v in sd.items()}, device="cpu")
    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(
        cpu, net_cpu, torch.float32,
        (lat.float().cpu(), ctx.float().cpu(), noise.cpu(), t.cpu(),
         None if added is None else added.float().cpu()))
    secs = time.perf_counter() - t0
    del cpu, net_cpu
    gc.collect()
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
    ranked = sorted(per_module, key=lambda ln: -per_module[ln][0] / max(per_module[ln][1], 1e-30))
    e, n = per_module[ranked[0]]
    # bounds: bf16 activations and weights through the forward and the
    # backward of ~100 (SD1.5) or ~400 (SDXL) layers (8-bit mantissa, ~4e-3
    # per rounding), against fp32
    log(f"{tag} loss card bf16 {got_loss:.6f} vs CPU fp32 {want_loss:.6f}: rel "
        f"{loss_rel:.3e} (bound 3e-2); adapter gradient ({g.numel()} values, "
        f"{len(per_module)} modules) rel L2 {grad_rel:.3e} (bound 5e-2); worst module "
        f"{ranked[0]} rel L2 {(e / n) ** 0.5:.3e}; CPU loss+backward {secs:.1f} s")
    if not (loss_rel <= 3e-2 and grad_rel <= 5e-2 and bool(torch.isfinite(g).all())):
        for ln in ranked[:10]:
            e, n = per_module[ln]
            log(f"{tag} module {ln}: rel L2 {(e / n) ** 0.5:.3e} (|grad| {n ** 0.5:.3e})")
        fail(f"{tag} loss rel {loss_rel:.3e} / gradient rel L2 {grad_rel:.3e} over bound")


# ---------------------------------------------------------------------------
# phases 16, 21 and 22: adapter files, a trainer checkpoint, DoRA with
# max-norm, premerge
# ---------------------------------------------------------------------------


def adapter_tensors(net) -> dict:
    """Every tensor of every adapter module (parameters and buffers)."""
    return {f"{lyco.lora_name}.{k}": v for lyco in net.loras for k, v in lyco.params.items()}


def phase_files(model, sds, batch, card):
    """Adapter files and a trainer checkpoint at full SD1.5 width. For each
    adapter in ``sds`` (the LoKr trained in phase 9, a DoRA LoHa):
    ``save_weights`` to .safetensors in fp32 (with metadata) and bf16 and to
    .pt in fp32; each file's keys and dtypes (the safetensors header parsed
    by ``utils/safetensors_io``) and metadata; a network built on the card
    from each file: its tensors bit for bit the live network's from the
    fp32 files, and one UNet call (batch 1, 64x64) within rel L2 1e-3 of the
    live adapters' (fp32 files) or 3e-2 (bf16); then ``onfly_merge``: the
    plain model's call within 1e-3 of the live adapters', and every base
    weight bit for bit after ``onfly_restore``. Then ``save_checkpoint``
    after 2 LoKr steps at b8 and ``load_checkpoint`` into a fresh trainer:
    adapter tensors, AdamW state, step and both generators' states bit for
    bit, and the next noise and timestep draws the same."""
    import os
    import tempfile

    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.trainer import DiffusionTrainer
    from lycoris_tpu_torch.utils import safetensors_io
    from lycoris_tpu_torch.wrapper import load_file_sd

    tag = "[files]"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(1, 4, 64, 64, generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, 77, 768, generator=gen, device=dev).to(torch.bfloat16)
    t = torch.tensor([501], dtype=torch.int32, device=dev)

    def call(net):
        net.apply_to(merged_forward=True)
        with torch.no_grad():
            out = model(x, t, ctx).float()
        net.restore()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        for name, sd in sds.items():
            live = make_net(model, sd)
            live_sd = live.state_dict()
            y_live = call(live)
            for fname, dtype, metadata in (("fp32.safetensors", None, {"adapter": name}),
                                           ("bf16.safetensors", torch.bfloat16, None),
                                           ("fp32.pt", None, None)):
                path = os.path.join(tmp, f"{name}_{fname}")
                t0 = time.perf_counter()
                live.save_weights(path, dtype=dtype, metadata=metadata)
                save_s = time.perf_counter() - t0
                want_dtype = dtype or torch.float32
                if path.endswith(".safetensors"):
                    header, _ = safetensors_io.read_header(path)
                    got_meta = header.pop("__metadata__", None)
                    dtypes = {h["dtype"] for h in header.values()}
                    if got_meta != metadata or dtypes != {safetensors_io.NAMES[want_dtype]}:
                        fail(f"{tag} {name}_{fname}: metadata {got_meta} dtypes {dtypes}")
                else:
                    header = load_file_sd(path)
                    if {v.dtype for v in header.values()} != {want_dtype}:
                        fail(f"{tag} {name}_{fname}: dtypes {({v.dtype for v in header.values()})}")
                if set(header) != set(live_sd):
                    fail(f"{tag} {name}_{fname}: keys differ from state_dict()'s")
                t0 = time.perf_counter()
                net, _ = create_lycoris_from_weights(1.0, path, model)
                load_s = time.perf_counter() - t0
                if any(v.device.type != "cuda" for v in adapter_tensors(net).values()):
                    fail(f"{tag} {name}_{fname}: an adapter tensor is not on the card")
                exact = dtype is None
                if exact:
                    got_sd = net.state_dict()
                    diff = [k for k in live_sd if not torch.equal(got_sd[k], live_sd[k])]
                    if diff:
                        fail(f"{tag} {name}_{fname}: {len(diff)} tensors differ, e.g. {diff[:3]}")
                err, bnd = rel_l2(call(net), y_live), 1e-3 if exact else 3e-2
                log(f"{tag} {name}_{fname}: {len(header)} tensors, saved in {save_s:.3f} s, "
                    f"loaded on the card in {load_s:.3f} s; tensors bit for bit "
                    f"{'yes' if exact else 'n/a (bf16)'}; UNet call vs the live adapters rel "
                    f"L2 {err:.3e} (bound {bnd:g})")
                if not err <= bnd:
                    fail(f"{tag} {name}_{fname}: UNet call rel L2 {err:.3e} over {bnd:g}")
                del net
            base = [p.detach().clone() for p in model.parameters()]
            live.onfly_merge(1.0)
            with torch.no_grad():
                y_merged = model(x, t, ctx).float()
            live.onfly_restore()
            err = rel_l2(y_merged, y_live)
            same = all(torch.equal(p, b) for p, b in zip(model.parameters(), base))
            log(f"{tag} {name} onfly_merge: plain model vs live adapters rel L2 {err:.3e} "
                f"(bound 1e-3); base weights bit for bit after onfly_restore: {same}")
            if not (err <= 1e-3 and same):
                fail(f"{tag} {name} onfly_merge rel L2 {err:.3e}, restored {same}")
            del live, base
            torch.cuda.empty_cache()

        # a trainer checkpoint: 2 LoKr steps, save, load into a fresh trainer
        path = os.path.join(tmp, "trainer.pt")
        net = make_net(model, sds["lokr"])
        tr = DiffusionTrainer(model, net, lr=1e-4, weight_dtype=torch.bfloat16,
                              generator=torch.Generator(device=dev).manual_seed(31))
        for _ in range(2):
            tr.train_step(batch)
        t0 = time.perf_counter()
        tr.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        net.restore()
        net2 = make_net(model, sds["lokr"])
        tr2 = DiffusionTrainer(model, net2, lr=1e-4, weight_dtype=torch.bfloat16,
                               generator=torch.Generator(device=dev).manual_seed(32))
        t0 = time.perf_counter()
        tr2.load_checkpoint(path)
        load_s = time.perf_counter() - t0
        a, b = adapter_tensors(net), adapter_tensors(net2)
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        sa, sb = tr.optimizer.state_dict()["state"], tr2.optimizer.state_dict()["state"]
        bad += [f"adamw {i} {k}" for i in sa for k in sa[i]
                if i not in sb or not torch.equal(sa[i][k], sb[i][k])]
        bad += [f"generator {g}" for g in ("generator", "drop_generator")
                if not torch.equal(getattr(tr, g).get_state(), getattr(tr2, g).get_state())]
        if tr2.step != tr.step:
            bad.append(f"step {tr2.step} != {tr.step}")
        shape = tuple(batch["latents"].shape)
        draws = [(torch.randn(shape, generator=g, device=dev),
                  torch.randint(0, 1000, (shape[0],), generator=g, device=dev))
                 for g in (tr.generator, tr2.generator)]
        if not (torch.equal(draws[0][0], draws[1][0]) and torch.equal(draws[0][1], draws[1][1])):
            bad.append("the next noise or timestep draws")
        log(f"{tag} trainer checkpoint after {tr.step} LoKr steps ({len(a)} adapter tensors, "
            f"{len(sa)} AdamW states): saved in {save_s:.3f} s, loaded in {load_s:.3f} s; "
            f"differences after the load: {bad or 'none'}; next draws equal")
        if bad:
            fail(f"{tag} the resumed trainer differs: {bad[:5]}")
        net2.restore()
        del tr, tr2, net, net2
    torch.cuda.empty_cache()


def dw_norms(net):
    """Each adapter module's dW norm (its ``get_diff_weight``), on the card."""
    import torch

    with torch.no_grad():
        return torch.stack([lyco.get_diff_weight()[0].float().norm() for lyco in net.loras])


def phase_sdxl_dora_max_norm(model, sd, batch, results, card):
    """SDXL DoRA LoHa with the trainer's max-norm at half the median of the
    modules' dW norms: 3 steps with the checks of phase 9 (the max-norm
    pass's LoHa forwards in the hand count, every one on the fast variant,
    dora_scale among the tensors that must change), and after each step at
    least one module scaled and every module's norm at most the limit x
    (1 + 1e-3); then one step without the pass and one with it, and the
    pass alone, host-clocked."""
    import torch
    from lycoris_tpu_torch.models.unet import sdxl_config

    tag = "[train_sdxl_dora_loha]"
    net = make_net(model, sd)
    if not all(lyco.wd for lyco in net.loras):
        fail(f"{tag} a module without DoRA")
    norms = dw_norms(net)
    limit = 0.5 * float(norms.median())
    log(f"{tag} max-norm limit {limit:.6e}: half the median of the {norms.numel()} modules' "
        f"dW norms ({float(norms.min()):.4e}..{float(norms.max()):.4e})")
    del net
    want = checked_counts(sdxl_config(), SDXL_BATCH, SDXL_HW, "loha", True, True, SDXL_STEP,
                          SDXL_ADAPTED, SDXL_FACTORED, max_norm=True)
    scaled = []

    def step_check(tr, net):
        n_scaled = int(tr.max_norm_stats[0])
        worst = float(dw_norms(net).max())
        scaled.append(n_scaled)
        if not (n_scaled > 0 and worst <= limit * (1 + 1e-3)):
            fail(f"{tag} max-norm: {n_scaled} modules scaled, largest norm {worst:.6e} "
                 f"against the limit {limit:.6e}")

    def timing(tr, net):
        secs = {}
        for label, lim in (("without", None), ("with", limit)):
            tr.scale_weight_norms = lim
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(batch)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.apply_max_norm_stacked(limit)
        torch.cuda.synchronize()
        pass_ms = (time.perf_counter() - t0) * 1e3
        log(f"{tag} one step without the max-norm pass {secs['without']:.4f} s, one with it "
            f"{secs['with']:.4f} s: the pass adds {(secs['with'] - secs['without']) * 1e3:.1f} "
            f"ms a step by that difference; the pass alone ({len(net.loras)} modules, "
            f"synchronised) {pass_ms:.1f} host ms ({card}; single host-clocked readings)")
        results["training"][tag.strip("[]")].update(
            limit=limit, modules_scaled=scaled, step_without_s=secs["without"],
            step_with_s=secs["with"], max_norm_pass_ms=pass_ms)

    train(model, "loha", sd, batch, want, 3, results, card, tag,
          trainer_kw={"scale_weight_norms": limit}, step_check=step_check, after=timing)
    log(f"{tag} modules scaled per step {scaled} of {SDXL_ADAPTED}")


def phase_sdxl_premerge(model, sd, batch, results, card):
    """SDXL LoKr with ``merge_mode="premerge"``: one loss and every adapter
    gradient against the interceptor route on the same batch, noise and
    timesteps (both bf16 on the card; phase 14's bounds), then 2 steps with
    the checks of phase 9 (factored 0), and s/step and peak memory beside
    ``train_sdxl_lokr``'s."""
    import torch
    from lycoris_tpu_torch.models.unet import sdxl_config
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    tag = "[train_sdxl_premerge]"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    noise = torch.randn(batch["latents"].shape, generator=gen, device=dev)
    t = torch.randint(0, 1000, (SDXL_BATCH,), generator=gen, device=dev)
    got = {}
    for mode in ("premerge", "interceptor"):
        net = make_net(model, sd)
        tr = DiffusionTrainer(model, net, weight_dtype=torch.bfloat16, merge_mode=mode)
        reset_counts()
        with tr.adapted():
            loss = tr.loss_fn(batch["latents"], batch["context"], noise, t, batch["added_cond"])
            loss.backward()
        factored = read_counts()["factored"]
        grads = torch.cat([p.grad.float().reshape(-1)
                           for _, sub in sorted(net.trainable_params().items())
                           for _, p in sorted(sub.items())])
        got[mode] = (float(loss.detach()), grads, factored)
        net.restore()
        del tr, net, loss
        torch.cuda.empty_cache()
    (loss_p, g_p, f_p), (loss_i, g_i, f_i) = got["premerge"], got["interceptor"]
    loss_rel, grad_rel = abs(loss_p - loss_i) / abs(loss_i), rel_l2(g_p, g_i)
    log(f"{tag} b{SDXL_BATCH} loss premerge {loss_p:.6f} vs interceptor {loss_i:.6f}: rel "
        f"{loss_rel:.3e} (bound 3e-2); adapter gradient ({g_i.numel()} values) rel L2 "
        f"{grad_rel:.3e} (bound 5e-2); factored layers premerge {f_p}, interceptor {f_i}")
    if not (loss_rel <= 3e-2 and grad_rel <= 5e-2 and bool(torch.isfinite(g_p).all())
            and f_p == 0 and f_i == 2 * SDXL_FACTORED):
        fail(f"{tag} premerge vs interceptor: loss rel {loss_rel:.3e}, gradient rel L2 "
             f"{grad_rel:.3e}, factored {f_p} / {f_i}")
    want = checked_counts(sdxl_config(), SDXL_BATCH, SDXL_HW, "lokr", True, True, SDXL_STEP,
                          SDXL_ADAPTED, SDXL_FACTORED, premerge=True)
    train(model, "lokr", sd, batch, want, 2, results, card, tag,
          trainer_kw={"merge_mode": "premerge"})
    for leg in ("train_sdxl_lokr", "train_sdxl_premerge"):
        r = results["training"][leg]
        log(f"{tag} {leg}: steady s/step {min(r['s_per_step'][1:]):.4f}, peak memory "
            f"{r['peak_gib']:.2f} GiB ({card})")


# ---------------------------------------------------------------------------
# phases 17-18 and 23-25: the other algorithms, (IA)^3, GLoRA, DyLoRA and
# Full on SD1.5, Diag-OFT, BOFT and LoRA with train_norm on SDXL and against
# the CPU port
# ---------------------------------------------------------------------------

SD15_ALGO_STEPS = 2
SDXL_ALGO_STEPS = 3
OFT_CONSTRAINT = 1e-4
BOFT_DIM = 16  # the least dim with a BOFT factorisation at SD widths (blocks of 10)


def check_kinds(tag, net, want: str) -> None:
    """Fail unless every adapter of ``net`` is a ``want`` module."""
    kinds = {type(lyco).__name__ for lyco in net.loras}
    if kinds != {want}:
        fail(f"{tag} adapter modules {sorted(kinds)}, want {want}")


def phase_sd15_algos(model, batch, results, card):
    """(IA)^3 (the ``ia3`` preset over the attn-mlp targets), GLoRA, DyLoRA
    (block_size 2) and Full at b8, 64x64, each with phase 9's checks for
    ``SD15_ALGO_STEPS`` steps (the UNet's own launches: no adapter kernel,
    factored 0) and one profiled step; Full's peak memory holds its fp32
    deltas and their AdamW moments. Each network is loaded from its state
    dict as a file would be, but DyLoRA's, whose files load as LoCon: it is
    trained as built."""
    import torch
    from lycoris_tpu_torch.models.unet import sd15_config

    dev = torch.device("cuda")
    for algo, kw, seed, kind in (("ia3", {"preset": "ia3"}, 30, "IA3Module"),
                                 ("glora", {}, 31, "GLoRAModule"),
                                 ("dylora", {"block_size": 2}, 32, "DyLoraModule"),
                                 ("full", {}, 33, "FullModule")):
        tag = f"[train_{algo}]"
        with phase(tag.strip("[]")):
            want = checked_counts(sd15_config(), TRAIN_BATCH, 64, algo, True, False, SD15_STEP,
                                  SD15_ADAPTED, SD15_FACTORED)
            with torch.no_grad():
                net = adapter_net(model, algo, dev, seed, **kw)
            sd = None
            if algo != "dylora":
                sd, net = net.state_dict(), None
            train(model, algo, sd, batch, want, SD15_ALGO_STEPS, results, card, tag,
                  adapted=SD15_ADAPTED, net=net, profile=True,
                  after=lambda tr, n, tag=tag, kind=kind: check_kinds(tag, n, kind))
            del sd, net


def phase_e2e_oft(model):
    """Phase 14's card-against-CPU check (batch 1, SD1.5) for Diag-OFT
    (dim 8, the constraint, rescaled), BOFT (dim 16) and LoRA with
    ``train_norm``."""
    import torch
    from lycoris_tpu_torch.models.unet import sd15_config

    dev = torch.device("cuda")
    for name, algo, kw, seed, kinds in (
            ("oft", "diag-oft", dict(constraint=OFT_CONSTRAINT, rescaled=True), 34,
             {"DiagOFTModule": SD15_ADAPTED}),
            ("boft", "boft", dict(linear_dim=BOFT_DIM), 35, {"ButterflyOFTModule": SD15_ADAPTED}),
            ("norm", "lora", dict(train_norm=True), 36,
             {"LoConModule": SD15_ADAPTED, "NormModule": SD15_NORM_ADAPTED - SD15_ADAPTED})):
        with torch.no_grad():
            sd = adapter_state_dict(model, algo, dev, seed, **kw)
        phase_train_e2e(model, sd, sd15_config(torch.float32), f"[train_e2e_{name}]",
                        kinds=kinds)
        del sd
        torch.cuda.empty_cache()


def adapter_pass(net, tag, card) -> dict:
    """The device ms and kernels of the adapters' own work: every module's
    merged weight formed once without a gradient ("fwd"), and formed and
    differentiated for a cotangent of ones ("fwd_bwd"). A step with
    remat="transformer" forms each merged weight twice (the forward and the
    recompute) and differentiates it once: about fwd + fwd_bwd."""
    import torch

    pairs = [(lyco, net.node_map[ln].weights()[0]) for ln, lyco in net.lora_map.items()]
    params = [p for lyco, _ in pairs for p in lyco.parameters()]

    def fwd():
        with torch.no_grad():
            for lyco, w in pairs:
                lyco.get_merged_weight(w)

    def fwd_bwd():
        outs = [lyco.get_merged_weight(w)[0] for lyco, w in pairs]
        torch.autograd.grad(outs, params, [torch.ones_like(o) for o in outs], allow_unused=True)

    out = {}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        ms, kernels = kernel_totals(fn, calls=1, warmup=0)
        out[name] = {"device_ms": ms, "kernels": kernels, "host_s": host}
    f, fb = out["fwd"], out["fwd_bwd"]
    if f["device_ms"] is not None:
        log(f"{tag} the adapters' merged weights ({len(pairs)} modules, Cayley and rotation): "
            f"formed {f['device_ms']:.2f} device ms in {f['kernels']:.0f} kernels "
            f"(host-clocked {f['host_s'] * 1e3:.1f} ms); formed and differentiated "
            f"{fb['device_ms']:.2f} device ms in {fb['kernels']:.0f} kernels (host-clocked "
            f"{fb['host_s'] * 1e3:.1f} ms); a step's share about "
            f"{f['device_ms'] + fb['device_ms']:.2f} device ms in "
            f"{f['kernels'] + fb['kernels']:.0f} kernels ({card})")
    return out


def boft_forms(card, dev=None, shapes=(((1280, 1280), False), ((10240, 1280), False),
                                      ((4096, 1280), True), ((4096, 10240), True))) -> dict:
    """BOFT's two forms of the rotation (dim 16: blocks of 10), the Cayley
    transform, the rotation and the backward to the blocks (fp32, as the
    module runs them, less the checkpoint's replay): of a weight, features
    on axis 0, at an SDXL attention weight (1280, 1280), where the shape rule
    takes the dense Q, and the SDXL ff net_0 weight (10240, 1280), where it
    takes the chain; and of the bypass route's outputs, features last, at
    SDXL b4 activations of the 1280 level (B*T = 4 * 1024 rows) of an
    attention projection (1280 features: dense) and of ff net_0 (10240:
    chain). Device ms by torch.profiler, each form at each shape, and the
    two forms' results against each other."""
    import torch
    from lycoris_tpu_torch.functional import boft
    from lycoris_tpu_torch.functional.general import power2factorization

    dev = dev or torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(44)
    out = {}
    for shape, last in shapes:
        dim = shape[-1] if last else shape[0]
        b, n = power2factorization(dim, BOFT_DIM)
        m = (n - 1).bit_count() + 1
        blocks = (torch.randn(m, n, b, b, generator=gen, device=dev) * ADAPTER_FILL_STD
                  ).requires_grad_(True)
        w = torch.randn(*shape, generator=gen, device=dev) * shape[1] ** -0.5
        g = torch.randn(*shape, generator=gen, device=dev)
        rule = "dense" if boft.use_dense(shape, dim, last) else "chain"
        row = {"blocks": [m, n, b, b], "rule": rule, "features": "last" if last else "first"}
        results = {}
        for form in ("dense", "chain"):
            def step(form=form):
                # each form as ``functional.boft._rotate_impl`` runs it, no checkpoint
                r = boft._scaled_r(blocks, None, 1.0)
                if form == "dense":
                    q = boft.dense_rotation(r)
                    y = w @ q.T if last else q @ w
                elif last:
                    y = boft._chain(w.movedim(-1, 0), r).movedim(0, -1)
                else:
                    y = boft._chain(w, r)
                return y.detach(), torch.autograd.grad(y, blocks, g)[0]

            results[form] = step()
            ms, kernels = kernel_totals(step, calls=3)
            row[form] = {"device_ms": ms, "kernels": kernels}
        err = max(rel_l2(results["dense"][k], results["chain"][k]) for k in (0, 1))
        what = f"activations {shape} (features last)" if last else f"weight {shape}"
        if not err <= 1e-4:
            fail(f"[boft_forms] {what}: the dense and the chain forms differ by rel L2 {err:.3e}")
        d, c = row["dense"]["device_ms"], row["chain"]["device_ms"]
        if d is not None:
            log(f"[boft_forms] {what}, blocks {tuple(row['blocks'])}, forward and "
                f"backward: dense Q {d:.3f} ms ({row['dense']['kernels']:.0f} kernels), chain "
                f"{c:.3f} ms ({row['chain']['kernels']:.0f} kernels); the shape rule takes "
                f"{rule}; forms agree to rel L2 {err:.1e} ({card})")
        out[("act " if last else "") + "x".join(map(str, shape))] = row
        del blocks, w, g, results
    torch.cuda.empty_cache()
    return out


def phase_sdxl_oft(model, batch, results, card, algo):
    """Diag-OFT (dim 8) or BOFT (dim 16) on the attn-mlp targets of the
    SDXL UNet at b4, 128x128, constraint 1e-4 and rescaled:
    ``SDXL_ALGO_STEPS`` steps with phase 9's checks (the UNet's own
    launches, factored 0) and one profiled step; then the adapters' own
    work (:func:`adapter_pass`), and for BOFT its two forms at two shapes
    (:func:`boft_forms`)."""
    import torch
    from lycoris_tpu_torch.models.unet import sdxl_config

    dev = torch.device("cuda")
    name = "oft" if algo == "diag-oft" else "boft"
    tag = f"[train_sdxl_{name}]"
    kind = "DiagOFTModule" if algo == "diag-oft" else "ButterflyOFTModule"
    want = checked_counts(sdxl_config(), SDXL_BATCH, SDXL_HW, algo, True, True, SDXL_STEP,
                          SDXL_ADAPTED, SDXL_FACTORED)
    kw = dict(constraint=OFT_CONSTRAINT, rescaled=True)
    if algo == "boft":
        kw["linear_dim"] = BOFT_DIM
    with torch.no_grad():
        sd = adapter_state_dict(model, algo, dev, 40 if algo == "diag-oft" else 41, **kw)

    def after(tr, net):
        check_kinds(tag, net, kind)
        results["training"][tag.strip("[]")]["adapter_pass"] = adapter_pass(net, tag, card)

    train(model, algo, sd, batch, want, SDXL_ALGO_STEPS, results, card, tag, path="train_sdxl",
          adapted=SDXL_ADAPTED, profile=True, after=after)
    copies = results["training"][tag.strip("[]")]["gn_copies"]
    if copies:
        fail(f"{tag} {copies} GroupNorm inputs or cotangents were copied (a merged conv "
             "weight read as channels-last makes cuDNN return a channels-last gradient)")
    if algo == "boft":
        results["training"][tag.strip("[]")]["forms"] = boft_forms(card)
    del sd
    torch.cuda.empty_cache()


def phase_sdxl_norm(model, batch, results, card):
    """LoRA (dim 8) with ``train_norm`` on the SDXL attn-mlp targets at b4:
    the 722 LoRA layers and a Norm module on each of the 210 LayerNorms and
    11 Transformer2DModel GroupNorms, ``SDXL_ALGO_STEPS`` steps with phase
    9's checks, every norm backward on the dw/db side of its fast variant
    (``bwd_wb_launches``), one profiled step; then the LayerNorm and
    GroupNorm backwards with dw/db at the shapes of this step and of an
    SD1.5 b8 train_norm step, against the plain versions and timed against
    ``F.layer_norm``'s and ``F.group_norm``'s autograd backwards (the kernel
    line's ``*_bwd_wb`` rows, the SD1.5 sums under "sd15")."""
    import torch
    from lycoris_tpu_torch.models.unet import sd15_config, sdxl_config

    dev = torch.device("cuda")
    tag = "[train_sdxl_norm]"
    want = checked_counts(sdxl_config(), SDXL_BATCH, SDXL_HW, "lora", True, True,
                          SDXL_STEP_NORM, SDXL_ADAPTED, SDXL_FACTORED, norm=True)
    with torch.no_grad():
        sd = adapter_state_dict(model, "lora", dev, 42, train_norm=True)

    def after(tr, net):
        kinds = Counter(type(lyco).__name__ for lyco in net.loras)
        if kinds != {"LoConModule": SDXL_ADAPTED, "NormModule": SDXL_NORM_ADAPTED - SDXL_ADAPTED}:
            fail(f"{tag} adapter modules {dict(kinds)}")

    train(model, "lora", sd, batch, want, SDXL_ALGO_STEPS, results, card, tag,
          path="train_sdxl_norm", adapted=SDXL_NORM_ADAPTED, profile=True, after=after)
    del sd
    torch.cuda.empty_cache()
    ck = Checks(results, seed=43)
    # the SD1.5 b8 train_norm step's shapes (no remat: one backward per norm)
    checked_counts(sd15_config(), TRAIN_BATCH, 64, "lora", True, False, SD15_STEP_NORM,
                   SD15_ADAPTED, SD15_FACTORED, norm=True)
    for path, where, b, sh in (
            ("sdxl", "SDXL b4", SDXL_BATCH, path_shapes(sdxl_config(), SDXL_BATCH, SDXL_HW)),
            ("sd15", "SD1.5 b8", TRAIN_BATCH, path_shapes(sd15_config(), TRAIN_BATCH, 64))):
        for (rows, c), n in sh["ln"].items():
            ck.layer_norm_bwd_wb(rows, c, n, path)
        for (c, s, act), n in sh["gn"].items():
            if act is None:
                ck.group_norm_bwd_wb(b, c, s, n, path)
        for name, lib in (("layer_norm_bwd_wb", "F.layer_norm"),
                          ("group_norm_bwd_wb", "F.group_norm")):
            a = results[name][path]
            log(f"[kernels] {name} per {where} train_norm step (rotating copies): "
                f"{a['ms']:.3f} ms, {a['bound_ms'] / a['ms']:.1%} of its bound "
                f"{a['bound_ms']:.3f} ms; plain {a['plain_ms']:.3f} ms; {lib}'s autograd "
                f"backward for x, weight and bias {a['library_ms']:.3f} ms ({card})")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 27-29: the kohya front end and the TOML trainer
# ---------------------------------------------------------------------------


def build_clips(device, seed):
    """CLIP-L and CLIP-G (bf16, full width and depth) with seeded weights."""
    import torch
    from lycoris_tpu_torch.models.clip import CLIPTextModel, clip_g_config, clip_l_config

    return [CLIPTextModel(cfg, device=device, param_dtype=torch.bfloat16,
                          generator=torch.Generator(device=device).manual_seed(seed + i)).eval()
            for i, cfg in enumerate((clip_l_config(torch.bfloat16),
                                     clip_g_config(torch.bfloat16)))]


def run_encoders(tag, encoders, call, card) -> list:
    """``call(i)`` for each encoder (no grad), each output finite and of
    shape (b, 77, hidden); each call's LayerNorm forwards counted by
    variant, all on the one ``fwd_plan`` names for the width (CLIP-L's 768:
    generic; CLIP-G's 1280: vectorised). Returns the outputs in fp32."""
    import torch
    from lycoris_tpu_torch.ops import layer_norm as ln

    outs = []
    for i, te in enumerate(encoders):
        c, n = te.cfg.hidden_size, 2 * te.cfg.num_layers + 1
        lanes = ln.fwd_plan(SDXL_BATCH * CONTEXT_TOKENS, c, 2).lanes
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = call(i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = (ln.launches, ln.fwd_vec_launches, ln.fwd_generic_launches)
        want = (n, n, 0) if lanes else (n, 0, n)
        log(f"{tag} encoder {i + 1} (C = {c}): {secs * 1e3:.2f} host ms a call; LayerNorm "
            f"forwards {got[1]} vectorised, {got[2]} generic of {got[0]} (want "
            f"{'vectorised' if lanes else 'generic'}, fwd_plan lanes {lanes}) ({card})")
        if got != want:
            fail(f"{tag} encoder {i + 1} LayerNorm launches {got}, want {want}")
        if (out.shape != (SDXL_BATCH, CONTEXT_TOKENS, c)
                or not bool(torch.isfinite(out.float()).all())):
            fail(f"{tag} encoder {i + 1} output not finite / shape {tuple(out.shape)}")
        outs.append(out.float())
    return outs


def clip_cpu_copy(te):
    """The port's CLIP on the CPU in fp32 with ``te``'s weights."""
    import dataclasses

    import torch
    from lycoris_tpu_torch.models.clip import CLIPTextModel

    cpu = CLIPTextModel(dataclasses.replace(te.cfg, dtype=torch.float32), device="meta")
    cpu.load_state_dict({k: v.cpu().float() for k, v in te.state_dict().items()}, assign=True)
    return cpu.eval()


def file_rounding(sd16: dict, sd32: dict) -> tuple[float, float]:
    """(rel L2 of the fp16 file's tensors against the fp32 file's over all
    of them, the share of nonzero fp32 values under fp16's smallest normal)."""
    import torch

    num = sum(float((sd16[k].double() - v.double()).square().sum()) for k, v in sd32.items())
    den = sum(float(v.double().square().sum()) for v in sd32.values())
    tiny = sum(int(((v != 0) & (v.abs() < torch.finfo(torch.float16).tiny)).sum())
               for v in sd32.values())
    return math.sqrt(num / den), tiny / sum(v.numel() for v in sd32.values())


def phase_kohya_sdxl(model, batch, results, card):
    """The kohya front end at full width: ``create_network`` (LoKr factor 8,
    attn-mlp) over CLIP-L, CLIP-G and the SDXL UNet (``model``), each tree's
    adapter count held to its config's (12 x 6, 32 x 6, 722); the encoders
    on b4 x 77 token ids and a UNet call with no adapters, then with the
    adapters live, each live output at least rel L2 6e-2 from its base (2x
    the fp16 reload bound, so a reload that drops a tree's adapters fails
    it; 60x the fp32 reload's); 3 UNet
    steps through ``sub_networks["lora_unet"]`` with the launch counts of
    ``train_sdxl_lokr``; ``save_weights`` (fp16) with ``sshs_model_hash``,
    the hash of the file's tensors, and an fp32 copy of the file;
    ``create_network_from_weights`` of each file on fresh models of the
    same weights: both encoders and a UNet call within rel L2 3e-2 of the
    live network's from the fp16 file (PR 13's bound for a reduced-precision
    file), within 1e-3 from the fp32 one (predicted 0); then ``merge_to``:
    the plain encoders within rel L2 1e-3 of the live ones, and within 3e-2
    of the port's fp32 CLIP on the CPU with the same merged weights (the
    bound of the UNet's ``e2e`` phase). ``model`` keeps the merged weights."""
    import os
    import tempfile

    import torch
    from lycoris_tpu_torch.kohya import (LycorisNetworkKohya, create_network,
                                         create_network_from_weights)
    from lycoris_tpu_torch.models.unet import sdxl_config
    from lycoris_tpu_torch.trainer import DiffusionTrainer
    from lycoris_tpu_torch.utils import precalculate_safetensors_hashes, safetensors_io

    tag = "[kohya_sdxl]"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(43)
    encoders = build_clips(dev, 40)
    try:
        net = create_network(1.0, LORA_RANK, 4.0, None, encoders, model, algo="lokr", factor=8,
                             preset="attn-mlp", seed=41)
    finally:
        LycorisNetworkKohya.reset_preset()
    census = {p: len(sub.loras) for p, sub in net.sub_networks.items()}
    want_census = {"lora_te1": 6 * encoders[0].cfg.num_layers,
                   "lora_te2": 6 * encoders[1].cfg.num_layers, "lora_unet": SDXL_ADAPTED}
    log(f"{tag} adapters by tree {census} (want {want_census}: q, k, v, out, fc1, fc2 a CLIP "
        f"layer; the UNet's attn-mlp census); {len(list(net.parameters()))} parameter tensors "
        f"in {len(net.loras)} modules, each registered once")
    if census != want_census or len(net.loras) != sum(want_census.values()):
        fail(f"{tag} adapter census {census} != {want_census}")
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=dev) * ADAPTER_FILL_STD)
    ids = torch.randint(0, encoders[0].cfg.vocab_size, (SDXL_BATCH, CONTEXT_TOKENS),
                        generator=gen, device=dev)
    x = torch.randn(1, 4, SDXL_HW, SDXL_HW, generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, CONTEXT_TOKENS, 2048, generator=gen, device=dev).to(torch.bfloat16)
    added = torch.randn(1, SDXL_ADDED, generator=gen, device=dev).to(torch.bfloat16)
    t = torch.tensor([501], dtype=torch.int32, device=dev)
    base = run_encoders(f"{tag} base", encoders, lambda i: encoders[i](ids), card)
    with torch.no_grad():
        base.append(model(x, t, ctx, added_cond=added).float())
    net.apply_to(apply_text_encoder=True, apply_unet=True)

    # 3 UNet steps through the UNet's sub-network, as the TOML trainer runs it
    want = checked_counts(sdxl_config(), SDXL_BATCH, SDXL_HW, "lokr", True, True, SDXL_STEP,
                          SDXL_ADAPTED, SDXL_FACTORED)
    tr = DiffusionTrainer(model, net.sub_networks["lora_unet"], lr=1e-4,
                          weight_dtype=torch.bfloat16,
                          generator=torch.Generator(device=dev).manual_seed(44))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for _ in range(3):
        reset_counts()
        t0 = time.perf_counter()
        loss = tr.train_step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = read_counts()
        if counts != want:
            fail(f"{tag} launch counts per step {counts} != {want}")
        check_no_pad_copies(tag)
        check_fast(tag, counts)
        losses.append(float(loss))
        if not math.isfinite(losses[-1]):
            fail(f"{tag} loss {losses[-1]}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} UNet steps through sub_networks['lora_unet']: launches per step as "
        f"train_sdxl_lokr ({want}); losses {[round(x, 5) for x in losses]}; s/step "
        f"{[round(x, 4) for x in secs]} (the first includes warm-up), peak memory {peak:.2f} "
        f"GiB ({card}; host-clocked)")
    results["training"]["kohya_sdxl"] = {"s_per_step": secs, "losses": losses,
                                         "peak_gib": peak}
    del tr

    live = run_encoders(f"{tag} live", encoders,
                        lambda i: net.apply_text_encoder(i, ids), card)
    with torch.no_grad():
        live.append(net.apply_unet(x, t, ctx, added_cond=added).float())
    moved = [rel_l2(lv, b) for lv, b in zip(live, base)]
    log(f"{tag} live adapters vs no adapters: CLIP-L, CLIP-G, UNet call rel L2 "
        f"{', '.join(f'{e:.3e}' for e in moved)} (each at least 6e-2, 2x the fp16 reload "
        f"bound)")
    if not all(e >= 6e-2 for e in moved):
        fail(f"{tag} the adapters move the outputs by rel L2 {moved}, under 6e-2")
    del base

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kohya_sdxl.safetensors")
        t0 = time.perf_counter()
        net.save_weights(path, dtype=torch.float16, metadata={"ss_network_module": "kohya"})
        save_s = time.perf_counter() - t0
        header, _ = safetensors_io.read_header(path)
        meta = header.pop("__metadata__")
        file_hash, _ = precalculate_safetensors_hashes(safetensors_io.load_file(path), {})
        log(f"{tag} save_weights fp16: {len(header)} tensors in {save_s:.3f} s; metadata "
            f"{meta}; the hash of the file's tensors {file_hash}")
        if meta.get("sshs_model_hash") != file_hash or meta.get("ss_network_module") != "kohya":
            fail(f"{tag} sshs_model_hash {meta.get('sshs_model_hash')} != {file_hash}")
        if {v["dtype"] for v in header.values()} != {"F16"}:
            fail(f"{tag} the file is not fp16 throughout")
        path32 = os.path.join(tmp, "kohya_sdxl_fp32.safetensors")
        net.save_weights(path32, dtype=torch.float32)
        rounding, tiny = file_rounding(safetensors_io.load_file(path),
                                       safetensors_io.load_file(path32))
        log(f"{tag} the fp16 file against the fp32 one: rel L2 {rounding:.3e} over every "
            f"tensor; {tiny:.3e} of the nonzero values under fp16's smallest normal")

        # each file reloaded on fresh models with the same weights
        fresh = build_unet(dev, torch.bfloat16, seed=3, config="sdxl", remat="transformer")
        fresh_encoders = build_clips(dev, 40)
        for f, name, bound_ in ((path, "fp16", 3e-2), (path32, "fp32", 1e-3)):
            t0 = time.perf_counter()
            net2, _ = create_network_from_weights(1.0, f, None, fresh_encoders, fresh)
            load_s = time.perf_counter() - t0
            census2 = {p: len(sub.loras) for p, sub in net2.sub_networks.items()}
            if census2 != want_census:
                fail(f"{tag} reloaded census {census2} != {want_census}")
            net2.apply_to(apply_text_encoder=True, apply_unet=True)
            again = run_encoders(f"{tag} reloaded {name}", fresh_encoders,
                                 lambda i: net2.apply_text_encoder(i, ids), card)
            with torch.no_grad():
                again.append(net2.apply_unet(x, t, ctx, added_cond=added).float())
            errs = [rel_l2(a, b) for a, b in zip(again, live)]
            log(f"{tag} create_network_from_weights ({name} file) on fresh models in "
                f"{load_s:.3f} s: CLIP-L, CLIP-G, UNet call vs the live network rel L2 "
                f"{', '.join(f'{e:.3e}' for e in errs)} (bound {bound_:g})")
            if not all(e <= bound_ for e in errs):
                fail(f"{tag} network reloaded from the {name} file differs: rel L2 {errs}")
            net2.restore()
            del net2, again
        del fresh, fresh_encoders
        torch.cuda.empty_cache()

    net.merge_to()
    merged = run_encoders(f"{tag} merged", encoders, lambda i: encoders[i](ids), card)
    errs = [rel_l2(m, lv) for m, lv in zip(merged, live)]
    log(f"{tag} merge_to: plain CLIP-L, CLIP-G vs live adapters rel L2 "
        f"{', '.join(f'{e:.3e}' for e in errs)} (bound 1e-3)")
    if not all(e <= 1e-3 for e in errs):
        fail(f"{tag} merged encoders differ from the live adapters: rel L2 {errs}")

    # the card's bf16 encoders against the port's fp32 CLIP on the CPU
    errs = []
    for te, got in zip(encoders, merged):
        cpu = clip_cpu_copy(te)
        t0 = time.perf_counter()
        with torch.no_grad():
            want_out = cpu(ids.cpu())
        errs.append(rel_l2(got.cpu(), want_out))
        log(f"{tag} merged encoder C = {te.cfg.hidden_size}: card bf16 vs CPU fp32 plain rel "
            f"L2 {errs[-1]:.3e} (bound 3e-2; CPU call {time.perf_counter() - t0:.1f} s)")
        del cpu
    if not all(e <= 3e-2 for e in errs):
        fail(f"{tag} the card's bf16 encoders differ from the CPU fp32 port: rel L2 {errs}")
    del net, encoders, live, merged
    torch.cuda.empty_cache()


@contextlib.contextmanager
def step_events(rows: list):
    """While open, a row per ``DiffusionTrainer.train_step``: its seconds
    (to the device's end), the seconds Python's garbage collector ran in
    it, and the caching allocator's device allocations, frees and retries
    in it, to name the cause of a slow step."""
    import torch
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    gc_s, gc_t0 = [0.0], [0.0]

    def on_gc(what, info):
        if what == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]

    def snap():
        m = torch.cuda.memory_stats()
        return (gc_s[0], m.get("num_device_alloc", 0), m.get("num_device_free", 0),
                m.get("num_alloc_retries", 0))

    train_step = DiffusionTrainer.train_step

    def timed_step(self, *args, **kw):
        before, t0 = snap(), time.perf_counter()
        out = train_step(self, *args, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        d = [b - a for a, b in zip(before, snap())]
        rows.append({"s": round(secs, 4), "gc_s": round(d[0], 4), "device_allocs": d[1],
                     "device_frees": d[2], "alloc_retries": d[3]})
        return out

    DiffusionTrainer.train_step = timed_step
    gc.callbacks.append(on_gc)
    try:
        yield
    finally:
        DiffusionTrainer.train_step = train_step
        gc.callbacks.remove(on_gc)


def phase_train_toml(name, tag, results, card, adapted, hada_variant="fast"):
    """``python -m lycoris_tpu_torch.train`` (its ``main``, in this process)
    on a copy of ``example_configs/training_configs/<name>`` with
    ``output_dir`` in a temporary directory, ``--max_steps 3``: every loss
    finite, the launches of the run on the variants the planners name
    (``hada_variant`` for LoHa), and the saved fp16 file reloaded by
    ``create_network_from_weights`` (``adapted`` modules, every tensor as in
    the file) on a UNet of the config on the meta device."""
    import os
    import tempfile

    import torch
    from lycoris_tpu_torch import train as front
    from lycoris_tpu_torch.kohya import create_network_from_weights
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel, sd15_config, sdxl_config
    from lycoris_tpu_torch.utils import safetensors_io

    text = (ROOT / "example_configs" / "training_configs" / name).read_text()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "out")
        text, n = re.subn(r"(?m)^output_dir\s*=.*$", f"output_dir = {json.dumps(out_dir)}", text)
        if n != 1:
            fail(f"{tag} {name}: {n} output_dir lines")
        cfg = os.path.join(tmp, name)
        with open(cfg, "w") as f:
            f.write(text)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        events = []
        t0 = time.perf_counter()
        with step_events(events):
            res = front.main(["--config", cfg, "--max_steps", "3"])
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses, secs = res["losses"], res["seconds"]
        log(f"{tag} {name}, 3 steps: losses {[round(x, 5) for x in losses]}; s/step "
            f"{[round(x, 4) for x in secs]} (the first includes warm-up); {wall:.2f} s in all "
            f"(model built, trained, saved); peak memory {peak:.2f} GiB; launches {counts} "
            f"({card}; host-clocked)")
        log(f"{tag} each train_step (its share of the s/step above): {events}")
        if len(losses) != 3 or res["start_step"] != 0 or not all(map(math.isfinite, losses)):
            fail(f"{tag} losses {losses} from step {res['start_step']}")
        check_no_pad_copies(tag)
        check_fast(tag, counts, hada_variant)
        if hada_variant == "generic" and not (counts["hada_fwd"] and counts["hada_bwd"]):
            fail(f"{tag} no LoHa launches: {counts}")
        results["training"][tag.strip("[]")] = {"s_per_step": secs, "losses": losses,
                                                "peak_gib": peak, "launches": counts,
                                                "train_step_events": events}
        gc.collect()
        torch.cuda.empty_cache()

        cfg_fn = sdxl_config if "sdxl" in name else sd15_config
        meta_unet = UNet2DConditionModel(cfg_fn(torch.bfloat16), device="meta")
        net, sd = create_network_from_weights(1.0, res["saved"], None, None, meta_unet,
                                              device="cuda")
        got = net.state_dict(dtype=torch.float16)
        same = set(got) == set(sd) and all(torch.equal(got[k].cpu(), sd[k]) for k in sd)
        header, _ = safetensors_io.read_header(res["saved"])
        log(f"{tag} {res['saved'].rsplit('/', 1)[-1]}: {len(net.loras)} adapters reloaded "
            f"(want {adapted}), tensors as in the file: {same}; sshs_model_hash "
            f"{header['__metadata__'].get('sshs_model_hash')}")
        if len(net.loras) != adapted or not same:
            fail(f"{tag} the saved file reloads as {len(net.loras)} adapters, tensors same {same}")
        del net, sd, got
    torch.cuda.empty_cache()


def ln_fwd_sums(row: dict, card: str) -> None:
    """The LayerNorm forward row's sums over its rotating-copy shapes, each
    weighted by its launches: the generic variant's ms per SDXL b4 step and
    SD1.5 serving call beside the vectorised one's, logged with the share of
    the bound and the library's; then the UNet path shapes where the
    vectorised variant is slower than ``F.layer_norm`` or than the generic
    one; then the CLIP sums (per CLIP-L and CLIP-G call at b4, ``clip``)."""
    keys = ("ms", "generic_ms", "plain_ms", "library_ms", "bound_ms", "copy_ms")

    def tot(path):
        return {k: sum(sh[k] * sh["per"] for sh in row["shapes"] if sh["path"] == path)
                for k in keys}

    row["generic_ms"] = tot("sdxl")["generic_ms"]
    row["sd15"]["generic_ms"] = tot("sd15")["generic_ms"]
    for where, r in (("SDXL b4 step", tot("sdxl")), ("SD1.5 serving call", tot("sd15"))):
        log(f"[kernels] layer_norm_fwd per {where} (rotating copies): vectorised "
            f"{r['ms']:.3f} ms, {r['bound_ms'] / r['ms']:.1%} of its bound "
            f"{r['bound_ms']:.3f} ms; generic {r['generic_ms']:.3f} ms; F.layer_norm "
            f"{r['library_ms']:.3f} ms; plain {r['plain_ms']:.3f} ms; copies of x "
            f"{r['copy_ms']:.3f} ms")
    unet = [sh for sh in row["shapes"] if sh["path"] in ("sd15", "sdxl")]
    for other, what in (("library_ms", "F.layer_norm"), ("generic_ms", "the generic variant")):
        slower = [f"{sh['path']} {tuple(sh['shape'])}" for sh in unet if sh["ms"] > sh[other]]
        log(f"[kernels] layer_norm_fwd path shapes where the vectorised variant is slower "
            f"than {what}: {slower or 'none'} of {len(unet)}")
    row["clip"] = tot("clip")
    for sh in row["shapes"]:
        if sh["path"] == "clip":
            log(f"[kernels] layer_norm_fwd CLIP {tuple(sh['shape'])} bf16, "
                f"{'vectorised' if sh['plan'][0] else 'generic'} variant: {sh['ms']:.4f} ms a "
                f"launch ({sh['bound_ms'] / sh['ms']:.1%} of its bound {sh['bound_ms']:.4f}); "
                f"generic {sh['generic_ms']:.4f}, F.layer_norm {sh['library_ms']:.4f}, plain "
                f"{sh['plain_ms']:.4f}; x {sh['per']} a call ({card})")
    r = row["clip"]
    log(f"[kernels] layer_norm_fwd per CLIP-L + CLIP-G call at b{SDXL_BATCH} (rotating "
        f"copies): {r['ms']:.3f} ms, {r['bound_ms'] / r['ms']:.1%} of its bound "
        f"{r['bound_ms']:.3f} ms; generic {r['generic_ms']:.3f} ms; F.layer_norm "
        f"{r['library_ms']:.3f} ms; plain {r['plain_ms']:.3f} ms ({card})")


def gn_step_sums(row: dict) -> None:
    """A GroupNorm row's sums over its rotating-copy shapes, each weighted by
    its launches a step: the generic variant's ms per SDXL step and SD1.5
    sum beside the fast one's, and for the forward the SD1.5 b8 train step's
    sums (``sd15_b8``); logged per SDXL b4 and SD1.5 b8 step with the share
    of the bound, then the path shapes where the fast variant is slower than
    the generic one."""
    keys = ("ms", "generic_ms", "plain_ms", "library_ms", "bound_ms")

    def tot(path):
        return {k: sum(sh[k] * sh["per"] for sh in row["shapes"] if sh["path"] == path)
                for k in keys}

    fwd = row["name"] == "group_norm_fwd"
    row["generic_ms"] = tot("sdxl")["generic_ms"]
    row["sd15"]["generic_ms"] = tot("sd15")["generic_ms"]
    if fwd:
        row["sd15_b8"] = tot("sd15_b8")
    for where, r in (("SDXL b4 step", tot("sdxl")),
                     ("SD1.5 b8 step", tot("sd15_b8" if fwd else "sd15"))):
        log(f"[kernels] {row['name']} per {where} (rotating copies): fast {r['ms']:.3f} ms, "
            f"{r['bound_ms'] / r['ms']:.1%} of its bound {r['bound_ms']:.3f} ms; generic "
            f"{r['generic_ms']:.3f} ms; library {r['library_ms']:.3f} ms; plain "
            f"{r['plain_ms']:.3f} ms")
    slower = [f"{sh['path']} {tuple(sh['shape'])} {sh['act']}" for sh in row["shapes"]
              if sh["ms"] > sh["generic_ms"]]
    log(f"[kernels] {row['name']} path shapes where the fast variant is slower than the "
        f"generic one: {slower or 'none'} of {len(row['shapes'])}")


def split_step_sums(row: dict) -> None:
    """The split backward's sums over its rotating-copy shapes, each weighted
    by its layers a step: the generic variant's and fused1's ms beside the
    fast one's, per SDXL b4 step (``generic_ms``, ``fused1_ms``) and SD1.5
    b8 step (under "sd15"); logged with the share of the bound, then the
    path shapes where the fast variant is slower than the generic one or
    the plain version, and the profiler's split of the fast variant's
    device time between the u-pass, the d-pass and the adder (the d-pass
    and the adder are dependent launches: their times overlap the kernel
    before, and the adder's include its wait)."""
    keys = ("ms", "generic_ms", "fused1_ms", "plain_ms", "bound_ms")

    def tot(path):
        return {k: sum(sh[k] * sh["per"] for sh in row["shapes"] if sh["path"] == path)
                for k in keys}

    for where, path, r in (("SDXL b4 step", "sdxl", row), ("SD1.5 b8 step", "sd15", row["sd15"])):
        t = tot(path)
        r["generic_ms"], r["fused1_ms"] = t["generic_ms"], t["fused1_ms"]
        parts = [sh["passes_ms"] for sh in row["shapes"]
                 if sh["path"] == path and isinstance(sh.get("passes_ms"), dict)]
        split = ("not measured" if not parts else ", ".join(
            f"{k} {sum(p[k] for p in parts) / sum(sum(p.values()) for p in parts):.1%}"
            for k in ("u_pass", "d_pass", "adder")))
        log(f"[kernels] hada_bwd_split per {where} (rotating copies): fast {t['ms']:.3f} ms, "
            f"{t['bound_ms'] / t['ms']:.1%} of its bound {t['bound_ms']:.3f} ms; generic "
            f"{t['generic_ms']:.3f} ms; fused1 {t['fused1_ms']:.3f} ms "
            f"({t['ms'] / t['fused1_ms']:.2f}x); plain {t['plain_ms']:.3f} ms; the fast "
            f"variant's device time over its path shapes (profiler, unweighted): {split}")
    slower = [f"{sh['path']} {tuple(sh['shape'])}" for sh in row["shapes"]
              if sh["ms"] > min(sh["generic_ms"], sh["plain_ms"])]
    log(f"[kernels] hada_bwd_split path shapes where the fast variant is slower than the "
        f"generic one or the plain version: {slower or 'none'} of {len(row['shapes'])}")


# ---------------------------------------------------------------------------
# phase 30: the tools (extract, merge, quant, files, CLIs)
# ---------------------------------------------------------------------------

# the tuned model of the extract leg: LoRA dim 8 on the attn-mlp targets and
# conv LoCon dim 4 on the ResNet 3x3 convs, merged in fp32
TOOLS_EXTRACT_TARGETS = {"target_module": ["Transformer2DModel"],
                         "target_name": [r".*resnets_\d+\.conv[12]$"]}
EXTRACT_LINEAR_DIM, EXTRACT_CONV_DIM = 8, 4
SDXL_QUANT_LINEARS = 700  # the Linear layers of SDXL's 70 transformer blocks


def tools_prefix(sd: dict) -> dict:
    """A network's state dict (prefix ``lycoris``) under the tools' UNet
    prefix ``lora_unet``, as a kohya or extracted file names its layers."""
    return {"lora_unet_" + k[len("lycoris_"):]: v for k, v in sd.items()}


def lora_rebuild(sd: dict, name: str):
    """An extracted module's dW (O, I*k) in fp32 from its fp16 factors,
    ``lora_mid`` included."""
    import torch

    up, down = sd[f"{name}.lora_up.weight"].float(), sd[f"{name}.lora_down.weight"].float()
    if f"{name}.lora_mid.weight" in sd:
        w = torch.einsum("ijkl,jr,pi->prkl", sd[f"{name}.lora_mid.weight"].float(),
                         down.reshape(down.shape[0], -1), up.reshape(up.shape[0], -1))
        return w.reshape(w.shape[0], -1)
    return up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)


def stop_cli(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def start_cli(children, name: str, *args) -> tuple:
    """``python -m lycoris_tpu_torch.tools.<name> ... --device cuda`` from
    the checkout, started and registered with the ExitStack ``children``,
    which kills it if it still runs: (the process, its start time)."""
    proc = subprocess.Popen([sys.executable, "-m", f"lycoris_tpu_torch.tools.{name}", *args,
                             "--device", "cuda"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT))
    children.callback(stop_cli, proc)
    return proc, time.perf_counter()


def finish_cli(tag: str, name: str, started: tuple) -> float:
    """Wait for a CLI of :func:`start_cli`; its wall seconds. Fails on a
    nonzero exit (the process is killed after 600 s)."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{tag} the {name} CLI ran past 600 s")
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{tag} the {name} CLI exited {proc.returncode}: {stderr[-2000:]}")
    log(f"{tag} CLI {name}: {stdout.strip().splitlines()[-1]} ({dt:.2f} s)")
    return dt


def tools_extract(config: str, card: str, cli: bool = True) -> dict:
    """The extract leg on the full-width ``config`` UNet in fp32: a tuned
    copy (TOOLS_EXTRACT_TARGETS merged in fp32 by ``merge_to``); pass 1,
    ``extract_diff`` on the card (fixed, linear dim 8, conv dim 4, no CP
    pass) reloaded by ``create_lycoris_from_weights``, every layer's dW
    within rel L2 1e-2 of the true delta (rank <= the extract's: only fp16
    rounding is left) and one extracted layer per adapted one; pass 2, with
    the CP pass (``small_conv``), two 3x3 convs of each shape group
    extracted on the card and by the port on the CPU, the rebuilt dW within
    rel L2 1e-3.
    With ``cli``, both state dicts saved, the extract_locon CLI on them
    (equal to pass 1 bit for bit) and the merge CLI of the pass-1 file into
    the base (the tensors without an adapter bit for bit, the merged ones
    within fp32 rounding of the in-process ``merge``), both run beside
    pass 2. Returns the timings."""
    import copy
    import os
    import tempfile
    from collections import defaultdict

    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.graph import ModelGraph
    from lycoris_tpu_torch.utils import extract as ex
    from lycoris_tpu_torch.utils import safetensors_io
    from lycoris_tpu_torch.utils.merge import merge

    dev = torch.device("cuda")
    tag = f"[tools_extract_{config}]"
    out = {"config": config}
    t0 = time.perf_counter()
    base = build_unet(dev, torch.float32, seed=21, config=config)
    tuned = copy.deepcopy(base)
    net = adapter_net(tuned, "locon", dev, seed=22, targets=TOOLS_EXTRACT_TARGETS,
                      conv_dim=EXTRACT_CONV_DIM, conv_alpha=4.0)
    names = {ln: net.node_map[ln].name for ln in net.lora_map}
    n_conv = sum(1 for lyco in net.loras if len(lyco.shape) == 4 and lyco.shape[2] == 3)
    net.merge_to(1.0)
    del net
    torch.cuda.synchronize()
    log(f"{tag} base and tuned UNets in fp32 ({sum(p.numel() for p in base.parameters())} "
        f"params each), {len(names)} layers adapted ({n_conv} 3x3 convs at dim "
        f"{EXTRACT_CONV_DIM}, the rest at dim {EXTRACT_LINEAR_DIM}) and merged, "
        f"{time.perf_counter() - t0:.2f} s")
    want_layers = {"lora_unet_" + ln[len("lycoris_"):] for ln in names}
    kw = dict(mode="fixed", linear_mode_param=EXTRACT_LINEAR_DIM,
              conv_mode_param=EXTRACT_CONV_DIM)

    # pass 1: the whole model on the card, no CP pass
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    svd_log = []
    sd = ex.extract_diff([], [], base, tuned, extract_device=dev, small_conv=False,
                         svd_log=svd_log, **kw)
    torch.cuda.synchronize()
    out["extract_s"] = time.perf_counter() - t0
    out["svd_s"] = sum(g["seconds"] for g in svd_log)
    out["svd_groups"] = [dict(g) for g in svd_log]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["peak_over_models_gib"] = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    for g in svd_log:
        log(f"{tag} SVD group {tuple(g['shape'])} x {g['count']}: {g['seconds']:.3f} s")
    log(f"{tag} pass 1: extract_diff {out['extract_s']:.2f} s, of it batched SVD "
        f"{out['svd_s']:.2f} s in {len(svd_log)} groups (cuSOLVER gesvd, "
        f"utils.extract._svd); peak device memory "
        f"{out['peak_gib']:.2f} GiB ({out['peak_over_models_gib']:.2f} GiB over the two "
        f"models) ({card})")
    # torch's default driver (cuSOLVER gesvdj) against the extract's gesvd on 8
    # deltas of the slowest group
    slow = max(svd_log, key=lambda g: g["seconds"])
    same = [n for n in names.values()
            if list(base.get_submodule(n).weight.reshape(slow["shape"][0], -1).shape)
            == slow["shape"]][:8]
    stack = torch.stack([(tuned.get_submodule(n).weight - base.get_submodule(n).weight)
                         .detach().reshape(slow["shape"]) for n in same])
    drivers = {}
    for drv in ("gesvd", None):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.linalg.svd(stack, full_matrices=False, driver=drv)
        torch.cuda.synchronize()
        drivers[drv or "default (gesvdj)"] = (time.perf_counter() - t1) / len(same)
    out["svd_s_per_matrix"] = {"shape": slow["shape"], **drivers}
    del stack
    log(f"{tag} s a {tuple(slow['shape'])} delta by driver: "
        f"{json.dumps(out['svd_s_per_matrix'])} ({card})")
    got_layers = {k.split(".", 1)[0] for k in sd}
    if got_layers != want_layers:
        fail(f"{tag} extracted {len(got_layers)} layers, adapted {len(want_layers)}: "
             f"{sorted(got_layers ^ want_layers)[:4]}")
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as children:
        ext_path = os.path.join(tmp, "extracted.safetensors")
        safetensors_io.save_file(sd, ext_path)
        lnet, _ = create_lycoris_from_weights(1.0, ext_path, base, lora_prefix="lora_unet")
        if len(lnet.loras) != len(names):
            fail(f"{tag} the extracted file reloads {len(lnet.loras)} layers of {len(names)}")
        worst = 0.0
        with torch.no_grad():
            for lyco in lnet.loras:
                name = lnet.node_map[lyco.lora_name].name
                true = tuned.get_submodule(name).weight - base.get_submodule(name).weight
                worst = max(worst, rel_l2(lyco.get_diff_weight()[0].reshape(true.shape), true))
        out["pass1_worst_rel_l2"] = worst
        log(f"{tag} pass 1: the file reloaded, {len(lnet.loras)} layers; worst dW rel L2 to "
            f"the true delta {worst:.3e} (bound 1e-2)")
        if not worst <= 1e-2:
            fail(f"{tag} pass 1 dW rel L2 {worst:.3e} over 1e-2")
        del lnet

        paths = {k: os.path.join(tmp, f"{k}.safetensors") for k in ("base", "tuned", "cli_ext",
                                                                    "cli_merged")}
        if cli:  # both state dicts saved, the two CLIs run on them beside pass 2
            t0 = time.perf_counter()
            for k, m in (("base", base), ("tuned", tuned)):
                safetensors_io.save_file(m.state_dict(), paths[k])
            gib = os.path.getsize(paths["base"]) / 2**30
            out["save_s"] = time.perf_counter() - t0
            log(f"{tag} base and tuned state dicts saved, {gib:.2f} GiB each, "
                f"{out['save_s']:.2f} s")
            ext_cli = start_cli(children, "extract_locon", paths["base"], paths["tuned"],
                                paths["cli_ext"], "--mode", "fixed", "--linear_dim",
                                str(EXTRACT_LINEAR_DIM), "--conv_dim", str(EXTRACT_CONV_DIM),
                                "--disable_cp")
            merge_cli = start_cli(children, "merge", paths["base"], ext_path, paths["cli_merged"])

        # pass 2: the CP pass (3x3 convs), card against the port on the CPU,
        # two of each shape group
        groups = defaultdict(list)
        for name in names.values():
            w = base.get_submodule(name).weight
            if w.ndim == 4 and w.shape[2] > 1:
                groups[(w.shape[0], w[0].numel())].append(name)
        pick = [n for g in groups.values() for n in g[:2]]
        sub_b = {f"{n}.weight": base.get_submodule(n).weight.detach() for n in pick}
        sub_t = {f"{n}.weight": tuned.get_submodule(n).weight.detach() for n in pick}
        t0 = time.perf_counter()
        card_sd = ex.extract_diff([], [], ModelGraph.from_state_dict(sub_b),
                                  ModelGraph.from_state_dict(sub_t), extract_device=dev,
                                  small_conv=True, **kw)
        cpu_sd = ex.extract_diff([], [], ModelGraph.from_state_dict(
            {k: v.cpu() for k, v in sub_b.items()}), ModelGraph.from_state_dict(
            {k: v.cpu() for k, v in sub_t.items()}), extract_device="cpu", small_conv=True, **kw)
        if set(card_sd) != set(cpu_sd):
            fail(f"{tag} pass 2 keys differ: {sorted(set(card_sd) ^ set(cpu_sd))[:4]}")
        mids = [k for k in card_sd if k.endswith(".lora_mid.weight")]
        worst = max(rel_l2(lora_rebuild(card_sd, m), lora_rebuild(cpu_sd, m))
                    for m in {k.split(".", 1)[0] for k in card_sd})
        out["pass2_worst_rel_l2"] = worst
        log(f"{tag} pass 2 (small_conv): {len(pick)} 3x3 convs of {len(groups)} shape groups, "
            f"{len(mids)} through the CP pass (lora_mid); card vs CPU rebuilt dW worst rel L2 "
            f"{worst:.3e} (bound 1e-3), {time.perf_counter() - t0:.2f} s")
        if len(mids) != len(pick) or not worst <= 1e-3:
            fail(f"{tag} pass 2: {len(mids)} CP layers of {len(pick)}, rel L2 {worst:.3e}")
        if not cli:
            return out

        # the CLIs' files against the in-process results
        out["cli_extract_s"] = finish_cli(tag, "extract_locon", ext_cli)
        cli_sd = safetensors_io.load_file(paths["cli_ext"])
        if set(cli_sd) != set(sd) or not all(torch.equal(cli_sd[k], sd[k]) for k in sd):
            fail(f"{tag} the extract_locon CLI's file differs from the in-process extract")
        out["cli_merge_s"] = finish_cli(tag, "merge", merge_cli)
        merged, count = merge([], base, sd, device=dev)
        cli_merged = safetensors_io.load_file(paths["cli_merged"])
        base_sd = base.state_dict()
        if set(cli_merged) != set(base_sd) or count != len(names):
            fail(f"{tag} merge CLI: {len(cli_merged)} tensors of {len(base_sd)}, {count} merged")
        worst, unequal = 0.0, 0
        for k, v in base_sd.items():
            name = k.rsplit(".", 1)[0]
            is_merged = name in merged["lora_unet"] and k.endswith(".weight")
            want = merged["lora_unet"][name]["weight"].cpu() if is_merged else v.cpu()
            if not torch.equal(cli_merged[k], want):
                if not is_merged:
                    fail(f"{tag} the merge CLI changed {k}, a tensor with no adapter")
                unequal += 1
                worst = max(worst, rel_l2(cli_merged[k], want))
        log(f"{tag} the extract_locon CLI's file equals pass 1 bit for bit; the merge CLI's "
            f"file: the other {len(base_sd) - count} tensors bit for bit, "
            f"{count - unequal} of {count} merged weights bit for bit, the others within rel "
            f"L2 {worst:.3e} of the in-process merge (bound 1e-6: fp32 rounding)")
        if not worst <= 1e-6:
            fail(f"{tag} the merge CLI's weights {worst:.3e} from the in-process merge")
    return out


def tools_sdxl_merge(model, results, card, tmp: str) -> tuple:
    """The merge leg on the full-width SDXL UNet in bf16: seeded LoHa (dim 8)
    and LoKr files merged by ``utils.merge.merge`` into its state dict on the
    card, each layer within rel L2 1e-3 of ``merge_to`` on a copy, the count
    the file's layers; the LoHa merge's ``hada_fwd`` launches one a layer
    that ``ops.hada.supported`` admits, and the kernel held to
    ``hada_weight_plain`` at each merge shape (fp32 bounds) and timed; then
    one b4 UNet call on the merged weights against the live network's.
    Returns (the copy, the LoHa file's path)."""
    import copy
    import os

    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.graph import ModelGraph
    from lycoris_tpu_torch.ops import hada
    from lycoris_tpu_torch.utils import safetensors_io
    from lycoris_tpu_torch.utils.merge import merge

    dev = torch.device("cuda")
    tag = "[tools_merge]"
    with torch.no_grad():
        files = {"loha": tools_prefix(adapter_state_dict(model, "loha", dev, seed=24)),
                 "lokr": tools_prefix(adapter_state_dict(model, "lokr", dev, seed=25))}
    loha_path = os.path.join(tmp, "sdxl_loha.safetensors")
    safetensors_io.save_file(files["loha"], loha_path)
    files["loha"] = {k: v.to(dev) for k, v in safetensors_io.load_file(loha_path).items()}
    layers = {k: sorted({key.split(".", 1)[0] for key in sd}) for k, sd in files.items()}
    factors = {}
    for ln in layers["loha"]:
        sd = files["loha"]
        w1u, w1d = sd[f"{ln}.hada_w1_a"], sd[f"{ln}.hada_w1_b"]
        w2u, w2d = sd[f"{ln}.hada_w2_a"], sd[f"{ln}.hada_w2_b"]
        r = w1d.shape[0]
        factors[ln] = (w1d.reshape(r, -1).float(), w1u.reshape(-1, r).float(),
                       w2d.reshape(r, -1).float(), w2u.reshape(-1, r).float(),
                       float(sd[f"{ln}.alpha"]) / r)
    supported = sum(hada.supported(f[0], f[1]) for f in factors.values())
    graph = ModelGraph.from_state_dict(model.state_dict())
    twin = copy.deepcopy(model)
    merged_loha = None
    for algo in ("loha", "lokr"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        merged, count = merge([], graph, files[algo], device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        fast, generic = hada.fast_launches, hada.generic_launches
        want_hada = supported if algo == "loha" else 0
        log(f"{tag} {algo}: {count} layers merged into the bf16 state dict in {dt:.3f} s "
            f"({card}); hada_fwd launches {counts['hada_fwd']} ({fast} fast, {generic} generic; "
            f"want {want_hada}, the layers ops.hada.supported admits)")
        if count != len(layers[algo]) or counts["hada_fwd"] != want_hada:
            fail(f"{tag} {algo}: {count} merged of {len(layers[algo])}, hada_fwd "
                 f"{counts['hada_fwd']} launches of {want_hada}")
        twin.load_state_dict(model.state_dict())
        tnet, _ = create_lycoris_from_weights(1.0, None, twin, weights_sd=files[algo],
                                              lora_prefix="lora_unet")
        tnet.merge_to(1.0)
        worst = max(rel_l2(sub["weight"], twin.get_submodule(name).weight.detach())
                    for name, sub in merged["lora_unet"].items())
        log(f"{tag} {algo}: against merge_to on a copy, worst rel L2 {worst:.3e} (bound 1e-3)")
        if not worst <= 1e-3:
            fail(f"{tag} {algo} merge vs merge_to rel L2 {worst:.3e} over 1e-3")
        del tnet
        if algo == "loha":
            merged_loha, loha_counts, loha_s = merged, counts, dt

    # the kernel against its plain version at the merge's shapes
    by_shape = Counter()
    first = {}
    for ln, f in factors.items():
        shape = (f[1].shape[0], f[0].shape[1])
        by_shape[shape] += 1
        first.setdefault(shape, f)
    rows = []
    for shape, n in sorted(by_shape.items()):
        w1d, w1u, w2d, w2u, scale = first[shape]
        got = hada.hada_fwd(w1d, w1u, w2d, w2u, scale)
        want = hada.hada_weight_plain(w1d, w1u, w2d, w2u, scale)
        stats = compare(torch.float32, got, want)
        record(results, "hada_fwd", "merge", stats, f"{shape} x {n} layers")
        o, i = shape
        r = w1d.shape[0]
        bnd = bound(4.0 * o * i * r + 2.0 * o * i, 4.0 * (2 * r * (o + i) + o * i), "float32")
        it = iters_for(4.0 * o * i)
        rows.append({"shape": [o, i], "rank": r, "layers": n, "max_abs_err": stats[2],
                     "ms": graph_ms(lambda: hada.hada_fwd(w1d, w1u, w2d, w2u, scale), it),
                     "plain_ms": graph_ms(lambda: hada.hada_weight_plain(w1d, w1u, w2d, w2u,
                                                                         scale), it),
                     "bound_ms": bnd[0], "bound_by": bnd[1]})
    sums = {k: sum(row[k] * row["layers"] for row in rows) for k in ("ms", "plain_ms", "bound_ms")}
    results["hada_fwd"]["merge"] = {
        "path": "tools_sdxl", "per": "one merge of the SDXL LoHa file (dim 8, attn-mlp, fp32 "
        "factors)", "launches": loha_counts["hada_fwd"], "merge_s": loha_s, **sums,
        "bound_by": max(("bytes", "operations"), key=lambda b: sum(
            row["bound_ms"] * row["layers"] for row in rows if row["bound_by"] == b)),
        "shapes": rows}
    log(f"{tag} hada_fwd at the merge's {len(rows)} shapes, per LoHa file merge: kernel "
        f"{sums['ms']:.3f} ms, plain {sums['plain_ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms "
        f"(device time, {card})")

    # one b4 UNet call on the merged weights against the live network
    missing = twin.load_state_dict(
        {f"{name}.{k}": v for name, sub in merged_loha["lora_unet"].items()
         for k, v in sub.items()},
        strict=False)
    if missing.unexpected_keys:
        fail(f"{tag} merged keys the UNet does not have: {missing.unexpected_keys[:4]}")
    batch = sdxl_batch()
    t = torch.full((SDXL_BATCH,), 501, dtype=torch.int32, device=dev)
    args = (batch["latents"], t, batch["context"])
    live, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=files["loha"],
                                          lora_prefix="lora_unet")
    live.apply_to(merged_forward=True)
    with torch.no_grad():
        want = model(*args, added_cond=batch["added_cond"])
        live.restore()
        got = twin(*args, added_cond=batch["added_cond"])
    err = rel_l2(got, want)
    log(f"{tag} one b{SDXL_BATCH} UNet call on the merged weights vs the live LoHa network: "
        f"rel L2 {err:.3e} (bound 3e-2)")
    if not (err <= 3e-2 and bool(torch.isfinite(got).all())):
        fail(f"{tag} merged UNet call rel L2 {err:.3e} over 3e-2")
    return twin, loha_path


def tools_sdxl_quant(model, twin, tag="[tools_quant]") -> None:
    """The quant leg: ``twin``'s transformer-block Linears swapped for
    ``Int8Linear`` (``quantize_linear_params``), LoKr dim 8 over its
    attn-mlp targets: every quantized layer's adapter in bypass mode, one
    b4 UNet call within rel L2 3e-2 of ``model`` with the dequantized
    weights in bf16 and the same adapters live, and ``merge_to`` leaving the
    int8 weights bit for bit."""
    import torch
    from lycoris_tpu_torch import create_lycoris_from_weights
    from lycoris_tpu_torch.models import layers as L
    from lycoris_tpu_torch.models.unet import BasicTransformerBlock
    from lycoris_tpu_torch.utils.quant import Int8Linear

    dev = torch.device("cuda")
    twin.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    swapped = []
    for bname, blk in twin.named_modules():
        if not isinstance(blk, BasicTransformerBlock):
            continue
        for name, child in list(blk.named_modules()):
            if isinstance(child, L.Linear):
                parent, _, attr = name.rpartition(".")
                setattr(blk.get_submodule(parent) if parent else blk, attr,
                        Int8Linear.from_linear(child, dtype=torch.bfloat16))
                swapped.append(f"{bname}.{name}")
    torch.cuda.synchronize()
    log(f"{tag} {len(swapped)} transformer-block Linears swapped for Int8Linear in "
        f"{time.perf_counter() - t0:.2f} s")
    if len(swapped) != SDXL_QUANT_LINEARS:
        fail(f"{tag} {len(swapped)} Linears swapped, want {SDXL_QUANT_LINEARS}")
    qnet = adapter_net(twin, "lokr", dev, seed=26)
    quant = [lyco for ln, lyco in qnet.lora_map.items() if qnet.node_map[ln].is_quant]
    bypass = sum(lyco.bypass_mode for lyco in quant)
    log(f"{tag} LoKr dim 8: {len(qnet.loras)} adapters, {len(quant)} on int8 layers, "
        f"{bypass} of them in bypass mode")
    if len(quant) != len(swapped) or bypass != len(quant):
        fail(f"{tag} {len(quant)} quantized layers adapted, {bypass} in bypass mode")
    with torch.no_grad():
        for name in swapped:
            model.get_submodule(name).weight.copy_(
                twin.get_submodule(name).dequantized_weight(torch.bfloat16))
    ref, _ = create_lycoris_from_weights(1.0, None, model, weights_sd=qnet.state_dict())
    batch = sdxl_batch()
    args = (batch["latents"], torch.full((SDXL_BATCH,), 501, dtype=torch.int32, device=dev),
            batch["context"])
    qnet.apply_to(merged_forward=True)
    ref.apply_to(merged_forward=True)
    with torch.no_grad():
        got = twin(*args, added_cond=batch["added_cond"])
        want = model(*args, added_cond=batch["added_cond"])
    qnet.restore()
    ref.restore()
    err = rel_l2(got, want)
    log(f"{tag} one b{SDXL_BATCH} UNet call, int8 bases with LoKr bypass vs the dequantized "
        f"bf16 bases with the same LoKr live: rel L2 {err:.3e} (bound 3e-2)")
    if not (err <= 3e-2 and bool(torch.isfinite(got).all())):
        fail(f"{tag} quantized UNet call rel L2 {err:.3e} over 3e-2")
    before = {n: (twin.get_submodule(n).weight_q.clone(), twin.get_submodule(n).scale.clone())
              for n in swapped}
    qnet.merge_to(1.0)
    kept = all(torch.equal(twin.get_submodule(n).weight_q, q) and
               torch.equal(twin.get_submodule(n).scale, s) for n, (q, s) in before.items())
    log(f"{tag} merge_to left every int8 weight and scale bit for bit: {kept}")
    if not kept:
        fail(f"{tag} merge_to changed a quantized layer")


def tools_files(loha_path: str, tmp: str, tag="[tools_files]") -> None:
    """A bundle pack/unpack and an HCP from_webui/to_webui round trip of the
    SDXL LoHa file through files: the same tensors back, bit for bit."""
    import os

    import torch
    from lycoris_tpu_torch.utils import safetensors_io
    from lycoris_tpu_torch.utils.bundle import pack_bundle, unpack_bundle
    from lycoris_tpu_torch.utils.hcp_convert import LoraConverter

    def same(a: dict, b: dict) -> bool:
        return set(a) == set(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                        for k in a)

    loha = safetensors_io.load_file(loha_path)
    gen = torch.Generator().manual_seed(27)
    emb = {"clip_l": torch.randn(2, 768, generator=gen),
           "clip_g": torch.randn(2, 1280, generator=gen)}
    path = os.path.join(tmp, "bundle.safetensors")
    safetensors_io.save_file(pack_bundle(dict(loha), {"sdxl_emb": emb}), path)
    back, embs = unpack_bundle(safetensors_io.load_file(path), emb_format=".safetensors")
    ok_bundle = same(back, loha) and set(embs) == {"sdxl_emb"} and same(embs["sdxl_emb"], emb)
    conv = LoraConverter()
    unet, te = conv.convert_from_webui(dict(loha), "plugin")
    paths = [os.path.join(tmp, f"{k}-sdxl_loha.safetensors") for k in ("unet", "text_encoder")]
    safetensors_io.save_file(unet["plugin"], paths[0])
    safetensors_io.save_file(te["plugin"], paths[1])
    back = conv.convert_to_webui(*(safetensors_io.load_file(p) for p in paths), "plugin")
    ok_hcp = same(back, loha)
    log(f"{tag} the SDXL LoHa file ({len(loha)} tensors): bundle pack/unpack with an SDXL "
        f"embedding bit for bit {ok_bundle}; HCP from_webui/to_webui bit for bit {ok_hcp}")
    if not (ok_bundle and ok_hcp):
        fail(f"{tag} a file round trip changed the tensors (bundle {ok_bundle}, HCP {ok_hcp})")


def phase_tools_sdxl(results, card) -> dict:
    """Phase 30: the extract leg (SD1.5 full width; the full SDXL extract's
    SVDs alone take longer than this phase may, see ``profile_tools.py``)
    with both CLIs, then merge, quant and files on the full-width SDXL UNet."""
    import gc
    import tempfile

    import torch

    t0 = time.perf_counter()
    out = tools_extract("sd15", card)
    gc.collect()
    torch.cuda.empty_cache()
    out["extract_leg_s"] = time.perf_counter() - t0
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_unet(dev, torch.bfloat16, seed=23, config="sdxl")
    with tempfile.TemporaryDirectory() as tmp:
        twin, loha_path = tools_sdxl_merge(model, results, card, tmp)
        out["merge_leg_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tools_sdxl_quant(model, twin)
        out["quant_leg_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tools_files(loha_path, tmp)
        out["files_leg_s"] = time.perf_counter() - t0
    log(f"[tools_sdxl] {json.dumps(out)}")
    return out


def main() -> int:
    if not (ROOT / "lycoris_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: lycoris_tpu_torch/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    from lycoris_tpu_torch.models.unet import sd15_config, sdxl_config

    t_start = time.perf_counter()
    results = new_results()
    results["serving"], results["training"] = {}, {}
    with phase("build"):
        card = phase_build()
    with phase("kernels"):
        phase_kernels(results)
    with phase("kernels_bwd"):
        phase_kernels_bwd(results)
    with phase("lora_fused_op"):
        phase_lora_fused_op(results)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_unet(dev, torch.bfloat16, seed=0)
    log(f"[unet] SD1.5 full width, bf16, {sum(p.numel() for p in model.parameters())} "
        f"params drawn on the card in {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        sds = {"lokr": adapter_state_dict(model, "lokr", dev, seed=1),
               "loha": adapter_state_dict(model, "loha", dev, seed=2),
               "lora": adapter_state_dict(model, "lora", dev, seed=6)}
        sd_conv = adapter_state_dict(model, "locon", dev, seed=7, targets=FULL_UNET_TARGETS)
        sds_dora = {"loha": adapter_state_dict(model, "loha", dev, seed=10, dora=True),
                    "lokr": adapter_state_dict(model, "lokr", dev, seed=11, dora=True)}
    for algo, steps in (("lokr", 20), ("loha", 10), ("lora", 20)):
        with phase(algo):
            serve(model, algo, sds[algo], requests=3, steps=steps, results=results, card=card)
    with phase("e2e"):
        phase_e2e(model, sds["lokr"])
    batch = sd15_batch()
    trained = {}
    for algo, steps in (("lokr", 5), ("loha", 3), ("lora", 5)):
        with phase(f"train_{algo}"):
            want = checked_counts(sd15_config(), TRAIN_BATCH, 64, algo, True, False, SD15_STEP,
                                  SD15_ADAPTED, SD15_FACTORED)
            trained[algo] = train(model, algo, sds[algo], batch, want, steps, results, card,
                                  f"[train_{algo}]")
    trained_lokr = trained.pop("lokr")
    del trained
    with phase("train_locon_conv"):
        full = path_shapes(sd15_config(), TRAIN_BATCH, 64)["full_adapted"]
        if full != SD15_FULL_ADAPTED:
            fail(f"the UNet census gives {full} layers under the full targets, the hand count "
                 f"{SD15_FULL_ADAPTED}")
        want = checked_counts(sd15_config(), TRAIN_BATCH, 64, "locon", True, False,
                              SD15_STEP_FULL, SD15_ADAPTED, SD15_FACTORED, full=True)
        train(model, "locon", sd_conv, batch, want, 3, results, card, "[train_locon_conv]",
              adapted=SD15_FULL_ADAPTED)
    with phase("train_loha_split"):
        phase_loha_split(model, sds["loha"], batch, results, card)
    with phase("train_lokr_dropout"):
        phase_dropout(model, sds["lokr"], batch, results, card)
    for algo, tag in (("lokr", "[train_e2e]"), ("lora", "[train_e2e_lora]")):
        with phase(tag.strip("[]")):
            phase_train_e2e(model, sds[algo], sd15_config(torch.float32), tag)
    with phase("train_e2e_dora"):
        for algo in ("loha", "lokr"):
            phase_train_e2e(model, sds_dora[algo], sd15_config(torch.float32),
                            f"[train_e2e_dora_{algo}]")
    with phase("files"):
        phase_files(model, {"lokr": trained_lokr, "dora_loha": sds_dora["loha"]}, batch, card)
    phase_sd15_algos(model, batch, results, card)
    with phase("train_e2e_oft"):
        phase_e2e_oft(model)

    # SDXL: the SD1.5 model freed first
    del model, sds, sds_dora, sd_conv, batch, trained_lokr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_unet(dev, torch.bfloat16, seed=3, config="sdxl", remat="transformer")
    log(f"[unet] SDXL full width, bf16, remat='transformer', "
        f"{sum(p.numel() for p in model.parameters())} params drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        sds = {"lora": adapter_state_dict(model, "lora", dev, seed=8),
               "lokr": adapter_state_dict(model, "lokr", dev, seed=4),
               "loha": adapter_state_dict(model, "loha", dev, seed=5),
               "dora_loha": adapter_state_dict(model, "loha", dev, seed=9, dora=True)}
    batch = sdxl_batch()
    for algo, steps in (("lora", 4), ("lokr", 4), ("loha", 3)):
        with phase(f"train_sdxl_{algo}"):
            want = checked_counts(sdxl_config(), SDXL_BATCH, SDXL_HW, algo, True, True,
                                  SDXL_STEP, SDXL_ADAPTED, SDXL_FACTORED)
            train(model, algo, sds[algo], batch, want, steps, results, card,
                  f"[train_sdxl_{algo}]", path="train_sdxl")
    with phase("train_sdxl_dora_loha"):
        phase_sdxl_dora_max_norm(model, sds["dora_loha"], batch, results, card)
    with phase("train_sdxl_premerge"):
        phase_sdxl_premerge(model, sds["lokr"], batch, results, card)
    for algo, name in (("diag-oft", "oft"), ("boft", "boft")):
        with phase(f"train_sdxl_{name}"):
            phase_sdxl_oft(model, batch, results, card, algo)
    with phase("train_sdxl_norm"):
        phase_sdxl_norm(model, batch, results, card)
    del batch
    torch.cuda.empty_cache()
    for algo, tag in (("lokr", "[train_sdxl_e2e]"), ("lora", "[train_sdxl_e2e_lora]")):
        with phase(tag.strip("[]")):
            phase_train_e2e(model, sds[algo], sdxl_config(torch.float32), tag, ctx_dim=2048,
                            added_dim=SDXL_ADDED)
    with phase("kohya_sdxl"):
        phase_kohya_sdxl(model, sdxl_batch(), results, card)
    del model, sds
    gc.collect()
    torch.cuda.empty_cache()
    with phase("train_toml_sdxl_lokr"):
        phase_train_toml("lokr_sdxl_tpu.toml", "[train_toml_sdxl_lokr]", results, card,
                         SDXL_ADAPTED)
    with phase("train_toml_sd15_loha"):
        # LoHa dim 16: every hada launch takes the generic variant (the fast one is rank 8)
        phase_train_toml("loha_tpu.toml", "[train_toml_sd15_loha]", results, card,
                         SD15_ADAPTED, hada_variant="generic")
    gc.collect()
    torch.cuda.empty_cache()
    with phase("tools_sdxl"):
        phase_tools_sdxl(results, card)

    for name, meta in KERNELS.items():
        if results[name]["launches"] <= 0:
            fail(f"{name} was never launched on its path ({meta['path']})")
    log(f"[serving] {json.dumps(results['serving'])}")
    log(f"[training] {json.dumps(results['training'])}")
    log(f"[total] {time.perf_counter() - t_start:.2f} s")

    def sums(a):
        return {"ms": a["ms"], "plain_ms": a["plain_ms"], "host_ms": a["host_ms"],
                "bound_ms": a["bound_ms"],
                "bound_by": (max(a["bound_parts"], key=a["bound_parts"].get)
                             if a["bound_parts"] else None),
                "library_ms": a["library_ms"]}

    table = []
    for name, meta in KERNELS.items():
        r = results[name]
        extra = {k: r[k] for k in ("variants", "shapes", "with_dw_db", "route_rows", "merge")
                 if k in r}
        table.append({"name": name, "route": meta["route"], "source": meta["source"],
                      "replaces": meta["replaces"], "path": meta["path"],
                      "per": meta.get("per", PER_SDXL_STEP), "launches": r["launches"],
                      "max_abs_err": r["max_abs_err"], **sums(r["sdxl"]),
                      "sd15": sums(r["sd15"]) if r["sd15"]["ms"] else None,
                      **extra})
    for row in table:
        if row["name"].startswith("flash"):
            for where, r in (("SDXL step", row), ("SD1.5 " + ("call" if "fwd" in row["name"]
                                                             else "b8 step"), row["sd15"])):
                log(f"[kernels] {row['name']} per {where}: {r['ms']:.3f} ms, "
                    f"{r['bound_ms'] / r['ms']:.1%} of its bound, "
                    f"{r['ms'] / r['library_ms']:.2f}x SDPA ({r['library_ms']:.3f} ms)")
        if row["name"] == "layer_norm_bwd":
            for where, r in (("SDXL step", row), ("SD1.5 b8 step", row["sd15"])):
                log(f"[kernels] layer_norm_bwd per {where} (rotating copies): {r['ms']:.3f} ms "
                    f"against F.layer_norm's backward {r['library_ms']:.3f} ms "
                    f"({r['ms'] / r['library_ms']:.2f}x), {r['bound_ms'] / r['ms']:.1%} of its "
                    f"bound {r['bound_ms']:.3f} ms")
            slower = [f"{sh['path']} {tuple(sh['shape'])}" for sh in row["shapes"]
                      if sh["ms"] > sh["library_ms"]]
            log(f"[kernels] layer_norm_bwd path shapes slower than F.layer_norm's backward: "
                f"{slower or 'none'} of {len(row['shapes'])}")
        if row["name"] == "layer_norm_fwd":
            ln_fwd_sums(row, card)
        if row["name"] in ("group_norm_fwd", "group_norm_bwd"):
            gn_step_sums(row)
        if row["name"] == "hada_bwd_split":
            split_step_sums(row)
        if row["name"] in ("hada_fwd", "hada_bwd"):
            for where, r in (("SDXL step", row), ("SD1.5 " + ("call" if "fwd" in row["name"]
                                                             else "b8 step"), row["sd15"])):
                log(f"[kernels] {row['name']} per {where} (fast variant, rotating copies): "
                    f"{r['ms']:.3f} ms, {r['bound_ms'] / r['ms']:.1%} of its bound "
                    f"{r['bound_ms']:.3f} ms; plain {r['plain_ms']:.3f} ms")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
