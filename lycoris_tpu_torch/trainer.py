"""Diffusion fine-tune trainer for adapters (counterpart of
``lycoris_tpu/trainer.py``, the kohya train-loop equivalent).

- ``objective="eps"`` (the default): DDPM noising with the scaled-linear
  schedule (``sampler.ddpm_alphas_cumprod``) and an eps-prediction MSE loss
  in fp32; ``objective="flow"``: rectified flow, as Wan and Flux train,
  sigma ~ U(0, 1) from the trainer's generator, x_sigma = (1 - sigma) x0 +
  sigma eps, the model called at t = num_train_timesteps * sigma, and the
  MSE against the velocity eps - x0 in fp32. Latents may have any rank (4-D
  images, 5-D video);
- the base model frozen (``requires_grad_(False)``) and cast to
  ``weight_dtype``; only the adapter parameters train, with AdamW at the
  JAX package's (optax's) defaults: betas (0.9, 0.999), eps 1e-8 and
  weight decay 1e-4 (not torch's 1e-2);
- ``merge_mode="interceptor"`` (the default): the adapters live in the
  model's forward (``LycorisNetwork.apply_to``), merged into each layer's
  weight by default, so the wide LoKr layers take the factored backward
  (``functional/merged.py``); ``merge_mode="premerge"``: each step merges
  every adapter into its layer's weight up front
  (``LycorisNetwork.premerged``), and the model runs as a plain model on
  those weights, with plain autograd back to the adapters;
- each step draws a dropout seed (the JAX trainer's ``drop_rng``,
  trainer.py:175) from a CPU generator of its own, ``drop_generator``,
  seeded with ``generator``'s seed, and runs its forward and backward
  inside ``LycorisNetwork.training_step(seed)``: adapters with dropout
  train with it. The noise and timestep draws of ``generator`` are
  untouched by it;
- ``optimizer``, ``lr_schedule`` and ``max_grad_norm``, the counterpart of
  the optax chain the JAX trainer takes as ``optimizer=`` (``train.py``:
  ``clip_by_global_norm``, then ``adamw`` on a schedule): ``optimizer`` makes
  the torch optimizer from the network's param groups, ``lr_schedule(step)``
  is every group's lr at each step (optax evaluates its schedule at the
  update count, 0 first), and the gradients are first scaled by
  ``max_grad_norm / max(norm, max_grad_norm)`` over their global L2 norm,
  as ``optax.clip_by_global_norm`` does (torch's ``clip_grad_norm_`` adds
  1e-6 to the norm), on the device with no host sync;
- ``scale_weight_norms``: after each optimizer step every module with
  max-norm is scaled in place so that the norm of its dW is at most the
  limit (kohya's ``--scale_weight_norms``), and ``max_norm_stats`` holds
  (modules scaled, mean norm, largest norm) as 0-dim device tensors: the
  step does not wait for the card;
- :meth:`~DiffusionTrainer.save_checkpoint` / ``load_checkpoint`` keep the
  adapter tensors (parameters and buffers), the AdamW state, ``step`` and
  the states of ``generator`` and ``drop_generator`` in one ``torch.save``
  file, so that a resumed run repeats the uninterrupted one (the JAX
  trainer takes its rng from the caller; this one draws its own).

- ``mesh`` (:func:`.parallel.sharding.make_mesh`, one process a rank):
  ``train_step`` takes this rank's rows of the global batch (dim 0 split
  over the ``data`` axis), and ``generator``, seeded the same on every rank,
  draws the noise and timesteps for the global batch, of which the rank
  takes its rows, so that the ranks together take the step one process
  takes on the whole batch (plain dropout likewise, by
  ``LycorisNetwork.training_step``'s ``batch_shard``). The adapters are
  broadcast from the first rank at construction; after each backward their
  gradients and the loss go through one flattened all-reduce over the
  ``data`` group and are divided by its size (DDP is not used: its buckets
  and hooks would add nothing to one all-reduce of a few MB, and the
  adapters are not one module it could wrap); the returned loss is the
  global batch's; the clip, the optimizer and max-norm then run on
  identical gradients and parameters. ``shard_base=True`` also shards the
  frozen base over the ``model`` axis
  (:func:`.parallel.sharding.shard_base_params`). A ``(1, 1)`` mesh with a
  process group runs the all-reduce on one rank; no mesh (None, what
  ``make_mesh`` gives one process without a group) runs no collective.
  :meth:`~DiffusionTrainer.save_checkpoint` writes on global rank 0 only.

The trainer runs on the device of the model it is given and moves nothing
to the CPU. It updates the network's own parameters in place, so
:meth:`DiffusionTrainer.sync_to_network` has nothing to copy.

Not ported: the flat optimizer; ``auto_layout`` is XLA machinery and has
no counterpart; ``param_groups``, which the JAX trainer accepts and never
reads.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from .observability import span
from .parallel import sharding as shd
from .sampler import ddpm_alphas_cumprod

# optax.adamw's default, which the JAX trainer uses; torch's AdamW defaults to 1e-2
WEIGHT_DECAY = 1e-4


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float) -> None:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global L2
    norm is at least ``max_norm`` (``optax.clip_by_global_norm``), with the
    choice made on the device."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)).float())
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class DiffusionTrainer:
    """Fine-tune the adapters of ``net`` on ``model`` with an eps-prediction
    or a flow-matching MSE objective."""

    def __init__(self, model, net, lr: float = 1e-4, weight_dtype=torch.bfloat16,
                 merged_forward: bool = True, generator: torch.Generator | None = None,
                 merge_mode: str = "interceptor", scale_weight_norms: float | None = None,
                 optimizer=None, lr_schedule=None, max_grad_norm: float | None = None,
                 num_train_timesteps: int = 1000, mesh=None, shard_base: bool = False,
                 objective: str = "eps"):
        if merge_mode not in ("interceptor", "premerge"):
            raise ValueError(f"merge_mode must be 'interceptor' or 'premerge', not {merge_mode!r}")
        if objective not in ("eps", "flow"):
            raise ValueError(f"objective must be 'eps' or 'flow', not {objective!r}")
        self.objective = objective
        self.model = model
        self.net = net
        self.weight_dtype = weight_dtype
        self.merge_mode = merge_mode
        self.scale_weight_norms = scale_weight_norms
        self.max_norm_stats = None  # (keys scaled, mean norm, max norm), device tensors
        self.device = next(model.parameters()).device
        model.requires_grad_(False)
        model.to(dtype=weight_dtype)
        if merge_mode == "interceptor":
            net.apply_to(merged_forward=merged_forward)
        self.mesh = mesh
        self.base_specs = None
        if mesh is not None:
            shd.replicate(net, mesh)
            if shard_base:
                self.base_specs = shd.shard_base_params(model, mesh)
        self.alphas_cumprod = torch.from_numpy(
            ddpm_alphas_cumprod(num_train_timesteps)).to(self.device)
        self.num_train_timesteps = num_train_timesteps
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.drop_generator = torch.Generator().manual_seed(generator.initial_seed())
        if optimizer is None:
            optimizer = functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=WEIGHT_DECAY)
        self.optimizer = optimizer(net.prepare_optimizer_params())
        self.lr_schedule = lr_schedule
        self.max_grad_norm = max_grad_norm
        self.step = 0

    def adapted(self):
        """The block the adapted model's forward and backward run in: under
        premerge the network's merged weights (``LycorisNetwork.premerged``),
        else nothing to enter (the adapters are applied)."""
        if self.merge_mode == "premerge":
            return self.net.premerged()
        return contextlib.nullcontext()

    def loss_fn(self, latents, context, noise, t, added_cond=None):
        """The objective's MSE of the adapted model on ``latents`` noised
        with the given ``noise`` (fp32, latents' shape) at ``t`` (B,): eps,
        integer timesteps; flow, sigmas in [0, 1). Under premerge, call it
        and run the backward inside :meth:`adapted`."""
        wd = self.weight_dtype
        b = latents.shape[0]
        bcast = (b,) + (1,) * (latents.ndim - 1)
        kwargs = {} if added_cond is None else {"added_cond": added_cond.to(wd)}
        if self.objective == "flow":
            x0 = latents.float()
            s = t.float().reshape(bcast)
            noisy = ((1 - s) * x0 + s * noise).to(wd)
            pred = self.model(noisy, t.float() * self.num_train_timesteps, context.to(wd),
                              **kwargs)
            return ((pred.float() - (noise - x0)) ** 2).mean()
        a = self.alphas_cumprod[t].reshape(bcast)
        noisy = (torch.sqrt(a) * latents.float() + torch.sqrt(1 - a) * noise).to(wd)
        pred = self.model(noisy, t, context.to(wd), **kwargs)
        return ((pred.float() - noise) ** 2).mean()

    def train_step(self, batch: dict):
        """One AdamW step on ``batch`` (``latents``, ``context``, optionally
        ``added_cond``; under a mesh this rank's rows of the global batch),
        noise and timesteps drawn from the trainer's generator, the
        adapters' dropout from the step's drop seed. Returns the loss (a
        0-dim tensor on the device; under a mesh the global batch's)."""
        return self._step(batch)

    def _draw(self, latents):
        """The global batch's noise and timesteps (sigmas under flow) from
        ``generator``, and the step's drop seed from ``drop_generator``."""
        b = latents.shape[0] * shd.axis_size(self.mesh, "data")  # the global batch
        noise = torch.randn((b, *latents.shape[1:]), generator=self.generator,
                            device=self.device, dtype=torch.float32)
        if self.objective == "flow":
            t = torch.rand((b,), generator=self.generator, device=self.device)
        else:
            t = torch.randint(0, self.num_train_timesteps, (b,), generator=self.generator,
                              device=self.device)
        seed = int(torch.randint(0, 2**62, (), generator=self.drop_generator))
        return noise, t, seed

    def _step(self, batch: dict, noise=None, t=None, seed: int | None = None):
        """The step of :meth:`train_step` on the given noise and timesteps
        of the global batch (this rank takes its rows) and drop seed, or
        on :meth:`_draw`'s where ``noise`` is None. Its phases are sibling
        spans (``observability``), from the draws to the end of the update."""
        # ahead of the first span: the optimizer's own range closes before it
        self.optimizer.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as adapted:
            with span("lycoris.forward"):
                if noise is None:
                    noise, t, seed = self._draw(batch["latents"])
                noise, t = shd.shard_batch((noise, t), self.mesh)
                shard = (shd.axis_index(self.mesh, "data"), shd.axis_size(self.mesh, "data"))
                adapted.enter_context(self.net.training_step(seed, shard))
                adapted.enter_context(self.adapted())
                loss = self.loss_fn(batch["latents"], batch["context"], noise, t,
                                    batch.get("added_cond"))
            with span("lycoris.backward"):
                loss.backward()
                loss = loss.detach()  # the last reference to the graph: freed in the span
        if self.mesh is not None:
            with span("lycoris.all_reduce"):
                loss = self._all_reduce(loss)
        self._update()
        self.step += 1
        return loss

    @torch.no_grad()
    def _all_reduce(self, loss):
        """The adapter gradients and ``loss`` averaged over the data group
        in one flattened all-reduce (fp32); returns the averaged loss."""
        grads = [p.grad for g in self.optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.float().reshape(1)])
        shd.all_reduce_sum(flat, self.mesh.get_group("data"))
        flat /= shd.axis_size(self.mesh, "data")
        for g, v in zip(grads, flat[:-1].split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
        return flat[-1].to(loss.dtype)

    def _update(self) -> None:
        """The optimizer's step on the gradients: the global-norm clip, the
        schedule's lr, the step, then max-norm."""
        if self.max_grad_norm:
            with span("lycoris.clip"):
                clip_by_global_norm(
                    [p.grad for g in self.optimizer.param_groups for p in g["params"]
                     if p.grad is not None], self.max_grad_norm)
        with span("lycoris.optimizer"):
            if self.lr_schedule is not None:
                lr = float(self.lr_schedule(self.step))
                for g in self.optimizer.param_groups:
                    g["lr"] = lr
            self.optimizer.step()
        if self.scale_weight_norms:
            with span("lycoris.max_norm"):
                scaled, norms = self.net.apply_max_norm_stacked(self.scale_weight_norms)
                if norms.numel():
                    self.max_norm_stats = (scaled.sum(), norms.mean(), norms.max())
                else:
                    self.max_norm_stats = (scaled.sum(), norms.sum(), norms.sum())

    def save_checkpoint(self, path) -> None:
        """The adapter tensors (parameters and buffers), the AdamW state,
        ``step`` and both generators' states, in one ``torch.save`` file,
        written by global rank 0 alone (every rank holds the same)."""
        if not shd.is_main_process():
            return
        torch.save({
            "adapters": {f"{lyco.lora_name}.{k}": v.detach()
                         for lyco in self.net.loras for k, v in lyco.params.items()},
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
            "drop_generator": self.drop_generator.get_state(),
        }, path)

    def load_checkpoint(self, path) -> None:
        """Resume from :meth:`save_checkpoint`'s file into this trainer,
        whose network has the same modules."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for lyco in self.net.loras:
                for k, v in lyco.params.items():
                    v.copy_(state["adapters"][f"{lyco.lora_name}.{k}"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        self.drop_generator.set_state(state["drop_generator"])

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
