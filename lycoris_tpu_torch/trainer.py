"""Diffusion fine-tune trainer for adapters (counterpart of
``lycoris_tpu/trainer.py``, the kohya train-loop equivalent).

- DDPM noising with the scaled-linear schedule (``sampler.ddpm_alphas_cumprod``)
  and an eps-prediction MSE loss in fp32;
- the base model frozen (``requires_grad_(False)``) and cast to
  ``weight_dtype``; only the adapter parameters train, with AdamW at the
  JAX package's (optax's) defaults: betas (0.9, 0.999), eps 1e-8 and
  weight decay 1e-4 (not torch's 1e-2);
- the adapters live in the model's forward (``LycorisNetwork.apply_to``),
  merged into each layer's weight by default, so the wide LoKr layers take
  the factored backward (``functional/merged.py``);
- each step draws a dropout seed (the JAX trainer's ``drop_rng``,
  trainer.py:175) from a CPU generator of its own, ``drop_generator``,
  seeded with ``generator``'s seed, and runs its forward and backward
  inside ``LycorisNetwork.training_step(seed)``: adapters with dropout
  train with it. The noise and timestep draws of ``generator`` are
  untouched by it.

The trainer runs on the device of the model it is given and moves nothing
to the CPU. It updates the network's own parameters in place, so
:meth:`DiffusionTrainer.sync_to_network` has nothing to copy.

Not ported yet: ``premerge``, max-norm, param groups, the flat optimizer,
checkpoint/resume and mesh sharding; ``auto_layout`` is XLA machinery and
has no counterpart.
"""

from __future__ import annotations

import time

import torch

from .sampler import ddpm_alphas_cumprod

NUM_TRAIN_TIMESTEPS = 1000
# optax.adamw's default, which the JAX trainer uses; torch's AdamW defaults to 1e-2
WEIGHT_DECAY = 1e-4


class DiffusionTrainer:
    """Fine-tune the adapters of ``net`` on ``model`` with an eps-prediction
    MSE objective."""

    def __init__(self, model, net, lr: float = 1e-4, weight_dtype=torch.bfloat16,
                 merged_forward: bool = True, generator: torch.Generator | None = None):
        self.model = model
        self.net = net
        self.weight_dtype = weight_dtype
        self.device = next(model.parameters()).device
        model.requires_grad_(False)
        model.to(dtype=weight_dtype)
        net.apply_to(merged_forward=merged_forward)
        self.alphas_cumprod = torch.from_numpy(
            ddpm_alphas_cumprod(NUM_TRAIN_TIMESTEPS)).to(self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.drop_generator = torch.Generator().manual_seed(generator.initial_seed())
        params = [p for sub in net.trainable_params().values() for p in sub.values()]
        self.optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=WEIGHT_DECAY)
        self.step = 0

    def loss_fn(self, latents, context, noise, t, added_cond=None):
        """eps-MSE of the adapted model on ``latents`` noised with the given
        ``noise`` (fp32, latents' shape) at timesteps ``t`` (int, (B,))."""
        wd = self.weight_dtype
        b = latents.shape[0]
        a = self.alphas_cumprod[t].reshape(b, 1, 1, 1)
        noisy = (torch.sqrt(a) * latents.float() + torch.sqrt(1 - a) * noise).to(wd)
        kwargs = {} if added_cond is None else {"added_cond": added_cond.to(wd)}
        pred = self.model(noisy, t, context.to(wd), **kwargs)
        return ((pred.float() - noise) ** 2).mean()

    def train_step(self, batch: dict):
        """One AdamW step on ``batch`` (``latents``, ``context``, optionally
        ``added_cond``), noise and timesteps drawn from the trainer's
        generator, the adapters' dropout from the step's drop seed. Returns
        the loss (a 0-dim tensor on the device)."""
        latents = batch["latents"]
        b = latents.shape[0]
        noise = torch.randn(latents.shape, generator=self.generator, device=self.device,
                            dtype=torch.float32)
        t = torch.randint(0, NUM_TRAIN_TIMESTEPS, (b,), generator=self.generator,
                          device=self.device)
        seed = int(torch.randint(0, 2**62, (), generator=self.drop_generator))
        with self.net.training_step(seed):
            loss = self.loss_fn(latents, batch["context"], noise, t, batch.get("added_cond"))
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def benchmark(self, batch: dict, warmup: int = 3, iters: int = 10):
        """(steps per second over ``iters`` steps after ``warmup``, last loss);
        pulling the loss to the host synchronises the device."""
        for _ in range(warmup):
            loss = self.train_step(batch)
        float(loss)
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = self.train_step(batch)
        final = float(loss)
        return iters / (time.perf_counter() - t0), final

    def adapter_tree(self) -> dict:
        """The trainable adapter parameters, ``{lora_name: {key: tensor}}``."""
        return {ln: {k: p.detach() for k, p in sub.items()}
                for ln, sub in self.net.trainable_params().items()}

    def sync_to_network(self) -> None:
        """Nothing to copy: the optimizer steps the network's own parameters."""
