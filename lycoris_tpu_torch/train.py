"""Fine-tune front end driven by kohya-style TOML configs (counterpart of the
repo's ``train.py``).

    python -m lycoris_tpu_torch.train --config example_configs/training_configs/loha_tpu.toml \\
        [--max_steps N] [--device cuda|cpu]

It reads the same sections: [Basics], [Save], [Network_setup], [LyCORIS]
(``network_args``), [Optimizer] and [Lr_scheduler]; builds the network with
:func:`lycoris_tpu_torch.kohya.create_network` and trains its UNet adapters
with :class:`DiffusionTrainer` on synthetic latents and context (numpy
normals from the config's seed, as the JAX front end draws them). The model
is ``model_config = "tiny"`` (8x8 latents), else SDXL
(``sdxl_config(bf16, remat=True)``) from resolution 1024 on, else SD1.5
(``sd15_config(bf16, remat="transformer")``), its weights drawn from the
seed on the device (the JAX front end's are zeros, which leave every
adapter gradient zero); ``pretrained_model_name_or_path`` is not read, as
in the JAX front end. The optimizer is AdamW (``optimizer_args`` betas and
weight_decay) on :func:`build_lr_schedule`'s schedule after a global-norm
clip at ``max_grad_norm``, the optax chain of the JAX front end.
``scale_weight_norms`` turns on max-norm; ``[Network_setup] resume = true``
resumes from ``output_dir/train_state.pt``, which ``[Save] save_state``
writes with every periodic save, and skips the data draws of the steps
already taken, so that a resumed run repeats the uninterrupted one (the
JAX front end draws them again from the start); the adapter file is saved
in fp16 every ``save_every_n_steps`` and at the end.

It runs on the card unless ``--device cpu`` is given, and exits non-zero
when asked for the card and there is none. Under ``torchrun``:

    torchrun --nproc_per_node N -m lycoris_tpu_torch.train --config ...

every rank joins one NCCL world (gloo with ``--device cpu``) and all ranks
go on the data axis (the JAX front end's mesh over every device):
``train_batch_size`` is the global batch, which must divide by N; each
rank draws the global synthetic batch from the seed and trains on its
rows; the metrics, the weight files and the train state are written by
rank 0 alone.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
import tomllib

import numpy as np


def parse_network_args(args_list) -> dict:
    """["k=v", ...] -> {"k": "v"}."""
    out = {}
    for item in args_list or []:
        k, _, v = item.partition("=")
        out[k.strip()] = v.strip()
    return out


def _polynomial(init, end, power, steps):
    """optax.polynomial_schedule(init, end, power, steps)."""
    def schedule(step):
        count = min(max(step, 0), steps)
        return (init - end) * (1 - count / steps) ** power + end

    return schedule


def build_lr_schedule(cfg: dict, lr: float):
    """step -> lr, the optax schedule of the JAX front end: ``lr_scheduler``
    constant, cosine, linear or polynomial (``lr_scheduler_power``) over
    ``max_train_steps`` - ``lr_warmup_steps``, any other kind constant (so
    ``constant_with_warmup`` is constant after its warmup), with a linear
    warmup from 0 joined in front."""
    sched = cfg.get("Lr_scheduler", {})
    kind = sched.get("lr_scheduler", "constant")
    warmup = int(sched.get("lr_warmup_steps", 0) or 0)
    total = int(cfg.get("Basics", {}).get("max_train_steps", 1000))
    decay = max(1, total - warmup)
    if kind == "cosine":
        def base(step):
            return lr * 0.5 * (1 + math.cos(math.pi * min(step, decay) / decay))
    elif kind == "linear":
        base = _polynomial(lr, 0.0, 1.0, decay)
    elif kind == "polynomial":
        base = _polynomial(lr, 0.0, float(sched.get("lr_scheduler_power", 1.0)), decay)
    else:
        def base(step):
            return lr
    if not warmup:
        return base
    ramp = _polynomial(0.0, lr, 1.0, warmup)
    return lambda step: ramp(step) if step < warmup else base(step - warmup)


def main(argv=None) -> dict:
    """Train from ``--config``; returns {"losses", "seconds" (per step),
    "start_step", "saved" (the final file)}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lycoris_tpu_torch.train: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    with open(args.config, "rb") as f:
        cfg = tomllib.load(f)

    from .kohya import create_network
    from .models import unet as U
    from .observability import MetricLogger, StepTimer
    from .parallel import init_distributed
    from .parallel import sharding as shd
    from .trainer import DiffusionTrainer

    basics = cfg.get("Basics", {})
    net_setup = cfg.get("Network_setup", {})
    lyco_cfg = cfg.get("LyCORIS", {})
    opt_cfg = cfg.get("Optimizer", {})
    save_cfg = cfg.get("Save", {})
    had_group = torch.distributed.is_initialized()
    dev = init_distributed(device=args.device)  # a no-op without torchrun
    mesh = shd.make_mesh()  # every rank on the data axis; None in one process
    main_rank = shd.is_main_process()

    seed = int(basics.get("seed", 0))
    batch = int(opt_cfg.get("train_batch_size", 4))
    max_steps = args.max_steps or int(basics.get("max_train_steps", 100))
    resolution = int(str(basics.get("resolution", "512")).split(",")[0])
    latent_hw = resolution // 8

    # the model: a config named in [Basics] or chosen by the resolution
    model_config = basics.get("model_config", "sdxl" if resolution >= 1024 else "sd15")
    if model_config == "tiny":
        ucfg = U.tiny_unet_config()
        latent_hw = 8
    elif model_config == "sdxl":
        ucfg = U.sdxl_config(dtype=torch.bfloat16, remat=True)
    else:
        ucfg = U.sd15_config(dtype=torch.bfloat16, remat="transformer")
    dtype = ucfg.dtype
    model = U.UNet2DConditionModel(ucfg, device=dev, param_dtype=dtype,
                                   generator=torch.Generator(device=dev).manual_seed(seed))

    # the network from kohya-style args (no text encoder in the synthetic run)
    network_args = parse_network_args(lyco_cfg.get("network_args"))
    net = create_network(
        1.0,
        int(net_setup.get("network_dim", 8)),
        float(net_setup.get("network_alpha", 4)),
        None,
        None,
        model,
        dropout=float(net_setup.get("network_dropout", 0) or 0),
        seed=seed,
        **network_args,
    )
    net.apply_to(
        apply_text_encoder=not net_setup.get("network_train_unet_only", False),
        apply_unet=not net_setup.get("network_train_text_encoder_only", False),
    )
    if net_setup.get("network_weights"):
        net.load_weights(net_setup["network_weights"])

    # the optimizer: AdamW on the schedule after a global-norm clip
    unet_lr = float(opt_cfg.get("unet_lr", opt_cfg.get("learning_rate", 1e-4)))
    opt_args = parse_network_args(opt_cfg.get("optimizer_args"))
    wd = float(opt_args.get("weight_decay", 0.01))
    betas = tuple(float(x) for x in opt_args.get("betas", "0.9,0.999").split(","))
    max_grad_norm = float(opt_cfg.get("max_grad_norm", 0) or 0)
    # kohya --scale_weight_norms: max-norm after every step
    scale_weight_norms = float(
        opt_cfg.get("scale_weight_norms", net_setup.get("scale_weight_norms", 0)) or 0
    )

    unet_sub = net.sub_networks[type(net).LORA_PREFIX_UNET]
    trainer = DiffusionTrainer(
        model, unet_sub, weight_dtype=dtype,
        generator=torch.Generator(device=dev).manual_seed(seed),
        optimizer=lambda groups: torch.optim.AdamW(groups, lr=unet_lr, betas=betas, eps=1e-8,
                                                   weight_decay=wd),
        lr_schedule=build_lr_schedule(cfg, unet_lr), max_grad_norm=max_grad_norm or None,
        scale_weight_norms=scale_weight_norms or None, mesh=mesh,
    )

    out_dir = save_cfg.get("output_dir", "lycoris_out")
    os.makedirs(out_dir, exist_ok=True)
    state_path = os.path.join(out_dir, "train_state.pt")
    if net_setup.get("resume") and os.path.exists(state_path):
        trainer.load_checkpoint(state_path)
        print(f"resumed from step {trainer.step}")
    start_step = trainer.step
    save_state = bool(save_cfg.get("save_state", False))
    every = int(save_cfg.get("save_every_n_steps", 0) or 0)
    name = save_cfg.get("output_name", "lycoris")

    timer = StepTimer()
    metrics = MetricLogger(os.path.join(out_dir, "metrics.jsonl")) if main_rank else None
    data_rng = np.random.default_rng(seed)
    shapes = {"latents": (batch, 4, latent_hw, latent_hw), "context": (batch, 77, ucfg.context_dim)}
    for _ in range(trainer.step):  # a resumed run skips the batches already trained on
        for s in shapes.values():
            data_rng.normal(size=s)
    losses, seconds = [], []
    for step in range(trainer.step, max_steps):
        t0 = time.perf_counter()
        # the global batch from the seed; this rank's rows of it
        batch_data = shd.shard_batch(
            {k: torch.tensor(data_rng.normal(size=s), dtype=torch.float32)
             for k, s in shapes.items()}, mesh)
        batch_data = {k: v.to(dev, dtype) for k, v in batch_data.items()}
        loss = trainer.train_step(batch_data)
        timer.step(loss)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if step % 10 == 0 and main_rank:
            extra = {}
            if trainer.max_norm_stats is not None:
                count, mean_norm, max_norm_v = (float(v) for v in trainer.max_norm_stats)
                # the reference reports (0, 0, 0) when nothing was scaled
                extra = dict(keys_scaled=count, max_norm_mean=mean_norm if count else 0.0,
                             max_norm_max=max_norm_v if count else 0.0)
            metrics.log(step, loss=losses[-1], steps_per_sec=timer.steps_per_sec or 0, **extra)
        if every and step and step % every == 0:
            if main_rank:
                net.save_weights(os.path.join(out_dir, f"{name}-{step:06d}.safetensors"),
                                 dtype=torch.float16, metadata={})
            if save_state:
                trainer.save_checkpoint(state_path)
    out = os.path.join(out_dir, f"{name}.safetensors")
    if main_rank:
        metrics.close()
        net.save_weights(out, dtype=torch.float16, metadata={})
        print(f"saved {out}")
    if torch.distributed.is_initialized() and not had_group:
        torch.distributed.destroy_process_group()
    return {"losses": losses, "seconds": seconds, "start_step": start_step, "saved": out}


if __name__ == "__main__":
    main(sys.argv[1:])
