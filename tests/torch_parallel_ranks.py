"""The ranks of ``test_torch_parallel.py``'s worlds (imported by name in
each spawned process, so it imports no JAX): the port's trainer on the tiny
UNet under a mesh, and the same runs in one process (``mesh=None``).

A run is a dict: ``name``, ``data``/``model`` (the mesh), ``steps``,
optionally ``shard_base`` (the trainer's), ``min_size`` (the base sharded
before the trainer at this size), ``remat``, ``merge_mode``, ``locon_dropout``
(a LoCon network with that dropout in place of the LoKr one), ``fed`` (the
steps take the setup's global noise, timesteps and drop seeds) and
``merge_check`` (after training, the output of the merged model).
"""

import dataclasses

import torch

import lycoris_tpu_torch as tl
from lycoris_tpu_torch.models import unet as tunet
from lycoris_tpu_torch.parallel import sharding as shd
from lycoris_tpu_torch.trainer import DiffusionTrainer

ATTN_MLP = {"target_module": ["Transformer2DModel"]}


def network(m, setup, run):
    if run.get("locon_dropout"):
        tl.LycorisNetwork.apply_preset(ATTN_MLP)
        try:
            return tl.create_lycoris(m, 1.0, linear_dim=4, linear_alpha=2.0, algo="locon",
                                     dropout=run["locon_dropout"], seed=3, device="cpu")
        finally:
            tl.LycorisNetwork.reset_preset()
    return tl.create_lycoris_from_weights(1.0, None, m, weights_sd=setup["adapters"],
                                          device="cpu")[0]


def train(setup, run, mesh):
    """``run``'s steps on ``mesh`` (None: one process, the global batch);
    losses, per-step collective counts, adapter tensors and base bytes."""
    cfg = dataclasses.replace(tunet.tiny_unet_config(), remat=run.get("remat", False))
    m = tunet.UNet2DConditionModel(cfg, device="cpu")
    m.load_state_dict(setup["unet"])
    net = network(m, setup, run)
    full = shd.base_bytes(m)
    if run.get("min_size") and mesh is not None:
        m.requires_grad_(False)
        shd.shard_base_params(m, mesh, min_size=run["min_size"])
    tr = DiffusionTrainer(m, net, lr=1e-3, weight_dtype=torch.float32, mesh=mesh,
                          shard_base=run.get("shard_base", False),
                          merge_mode=run.get("merge_mode", "interceptor"),
                          generator=torch.Generator().manual_seed(7))
    batch = shd.shard_batch(setup["batch"], mesh)
    out = {"losses": [], "counts": [], "full_bytes": full, "bytes": shd.base_bytes(m)}
    for i in range(run["steps"]):
        shd.reset_counts()
        if run.get("fed"):
            f = setup["fed"][i]
            loss = tr._step(batch, f["noise"], f["t"], f["seed"])
        else:
            loss = tr.train_step(batch)
        out["losses"].append(float(loss))
        out["counts"].append({"collectives": dict(shd.collectives), "gathers": dict(shd.gathers)})
    out["sharded"] = sorted(k for k, d in shd_specs(m).items() if d is not None)
    out["adapters"] = {k: v.detach().clone() for k, v in net.state_dict().items()}
    if run.get("merge_check"):
        net.restore()
        net.merge_to()
        with torch.no_grad():
            b = setup["batch"]
            t = torch.full((b["latents"].shape[0],), 500)
            out["merged_out"] = m(*shd.shard_batch((b["latents"], t, b["context"]), mesh))
    return out


def shd_specs(m) -> dict:
    """{qualified leaf name: sharded dim or None} as the model now holds it."""
    return {f"{mn}.{name}" if mn else name: mod._lycoris_shards.leaves[name][0]
            if shd.is_sharded(mod, name) else None
            for mn, mod in m.named_modules() for name in mod._parameters
            if not name.endswith(shd.SHARD_SUFFIX)}


def trainer_runs(rank, world, setup_path, runs):
    """A rank of a world: every run on its own mesh."""
    torch.set_num_threads(1)
    setup = torch.load(setup_path, weights_only=False)
    return {run["name"]: train(setup, run, shd.make_mesh(data=run["data"], model=run["model"]))
            for run in runs}


def fail_on_rank_one(rank, world):
    """A world in which rank 1 raises."""
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank
