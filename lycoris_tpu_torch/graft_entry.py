"""Entry points of the port (counterpart of the repo's ``__graft_entry__.py``).

- :func:`entry` -> ``(fn, args)``: the tiny UNet's forward with a LoKr
  adapter applied, and its example arguments, on the card by default;
- :func:`dryrun_multichip` -> one training step of ``DiffusionTrainer`` on
  an ``n``-rank ``(data, model)`` mesh (the frozen base sharded over
  ``model``, the batch over ``data``, the adapters replicated), each rank a
  spawned process on its own card (NCCL), or on the CPU (gloo) when asked,
  held to the same step in one process.

    python -c "from lycoris_tpu_torch import graft_entry as g; g.dryrun_multichip(4)"
    python -c "from lycoris_tpu_torch import graft_entry as g; g.dryrun_multichip(4, 'cpu')"
"""

from __future__ import annotations

import math

import torch


def _setup(batch: int = 8, device="cuda"):
    """The tiny UNet (seed 0), a LoKr network on it (dim 4, factor 4) and
    the JAX entry's inputs: ones, timestep 0, ones context."""
    from . import LycorisNetwork, create_lycoris
    from .models.unet import UNet2DConditionModel, tiny_unet_config

    LycorisNetwork.reset_preset()
    cfg = tiny_unet_config()
    dev = torch.device(device)
    model = UNet2DConditionModel(cfg, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(0))
    net = create_lycoris(model, 1.0, linear_dim=4, linear_alpha=1.0, algo="lokr", factor=4,
                         seed=0, device=dev)
    latents = torch.ones(batch, 4, 8, 8, device=dev)
    t = torch.zeros(batch, dtype=torch.int64, device=dev)
    ctx = torch.ones(batch, 6, cfg.context_dim, device=dev)
    return model, net, (latents, t, ctx)


def entry(device="cuda"):
    """``(fn, args)``: ``fn(latents, t, ctx)`` is the adapted tiny UNet's
    forward (the adapters applied to the model)."""
    model, net, args = _setup(device=device)
    net.apply_to()

    def fwd(latents, t, ctx):
        return model(latents, t, ctx)

    return fwd, args


def _trainer(model, net, mesh=None, shard_base=False):
    from .trainer import DiffusionTrainer

    dev = next(model.parameters()).device
    return DiffusionTrainer(model, net, lr=1e-3, weight_dtype=torch.float32, mesh=mesh,
                            shard_base=shard_base,
                            generator=torch.Generator(device=dev).manual_seed(1))


def _dryrun_rank(rank, world, data, model_axis, batch, device):
    """One rank of :func:`dryrun_multichip`: the sharded step on this
    rank's rows; rank 0 also takes the same step in one process."""
    from .parallel import sharding as shd

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    model, net, (latents, _, ctx) = _setup(batch, dev)
    mesh = shd.make_mesh(data=data, model=model_axis)
    tr = _trainer(model, net, mesh, shard_base=model_axis > 1)
    local = shd.shard_batch({"latents": latents, "context": ctx}, mesh)
    out = {"loss": float(tr.train_step(local)), "sharded": sum(
        d is not None for d in (tr.base_specs or {}).values())}
    if rank == 0:
        model1, net1, _ = _setup(batch, dev)
        out["loss1"] = float(_trainer(model1, net1).train_step(
            {"latents": latents, "context": ctx}))
    return out


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 120.0) -> None:
    """One training step on an ``n_devices``-rank mesh of spawned processes:
    ``(n/2, 2)`` (``(n, 1)`` for odd n) with the base sharded over
    ``model``, the global batch a multiple of ``data``. On the card each
    rank takes its own (NCCL; raises unless there are ``n_devices``
    cards); ``device="cpu"`` runs the ranks on gloo. Raises unless every
    rank's loss is finite, the ranks agree, and the loss is within rel 1e-4
    of the same step in one process (``__graft_entry__.py``'s parity
    check); a failed rank raises with its stderr tail."""
    from .parallel import backend_for, run_world

    n = int(n_devices)
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip({n}) takes one card a rank; "
                           f"{torch.cuda.device_count()} visible (device='cpu' runs on gloo)")
    model_axis = 2 if n % 2 == 0 and n > 1 else 1
    data = n // model_axis
    batch = data * -(-8 // data)
    outs = run_world(_dryrun_rank, n, data, model_axis, batch, device,
                     backend=backend_for(device), timeout=timeout)
    losses = [o["loss"] for o in outs]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss on some rank: {losses}")
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    loss, loss1 = losses[0], outs[0]["loss1"]
    rel = abs(loss - loss1) / max(abs(loss1), 1e-12)
    if not rel < 1e-4:
        raise AssertionError(f"sharded/one-process loss mismatch: {loss} vs {loss1} "
                             f"(rel {rel:.2e})")
    print(f"[dryrun_multichip] ok: ({data},{model_axis}) data x model mesh on {n} "
          f"{torch.device(device).type} ranks, {outs[0]['sharded']} base leaves sharded, "
          f"loss={loss:.6f}, one-process loss={loss1:.6f}, rel_diff={rel:.2e}")
