"""The SDXL training slice as a whole, port vs JAX package, on a tiny
SDXL-shaped UNet (no attention at the first level, a deeper mid block,
heads from ``head_dim``, the ``add_embedding`` of the pooled text and time
ids): the trainer's loss and every adapter gradient (LoKr and LoHa, the
merged forward) with the port's blocks checkpointed (``remat="transformer"``
and ``True``), against the JAX trainer's loss with the same numpy noise and
timesteps; and checkpointing changes no gradient.

Tolerance: 1e-4 relative for the loss and the gradients (fp32, a whole
forward and backward of the UNet), as tests/test_torch_train.py; 1e-6
between the port with and without checkpointing (the same ops run again).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.models import unet as junet
from lycoris_tpu.trainer import ddpm_alphas_cumprod as jax_acp
from lycoris_tpu_torch.models import unet as tunet
from lycoris_tpu_torch.trainer import DiffusionTrainer

ATTN_MLP = {"target_module": ["Transformer2DModel"]}
REL = 1e-4
TINY = dict(block_out_channels=(32, 64), layers_per_block=1, transformer_depth=(0, 2),
            mid_transformer_depth=2, context_dim=32, head_dim=16, norm_groups=8,
            addition_embed_dim=16)


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


@functools.lru_cache(maxsize=1)
def _jax_unet():
    """The JAX tiny SDXL UNet, its parameters and graph, and numpy inputs,
    added conditioning, noise and timesteps (built once: the init compiles)."""
    rng = np.random.default_rng(0)
    b, hw = 2, 8
    d = dict(lat=rng.standard_normal((b, 4, hw, hw)), ctx=rng.standard_normal((b, 6, 32)),
             added=rng.standard_normal((b, 16)), noise=rng.standard_normal((b, 4, hw, hw)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["t"] = np.array([17, 640], np.int32)
    model = junet.UNet2DConditionModel(junet.UNetConfig(**TINY))
    args = tuple(jnp.asarray(d[k]) for k in ("lat", "t", "ctx", "added"))
    variables = jax.jit(model.init)(jax.random.key(0), *args)
    return model, variables, jl.ModelGraph.from_linen(model, variables, *args), d


def _setup(algo, remat="transformer"):
    """The JAX UNet with adapters whose factors are seeded nonzero, and the
    port's UNet (checkpointed as ``remat`` says) and network loaded from them."""
    model, variables, graph, d = _jax_unet()
    rng = np.random.default_rng(1)
    jl.LycorisNetwork.apply_preset(ATTN_MLP)
    net = jl.create_lycoris(graph, 1.0, 4, 2.0, algo=algo, factor=4, rng=jax.random.key(1))
    jl.LycorisNetwork.reset_preset()
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.05)
    net.set_params_tree(tree)

    m = tunet.UNet2DConditionModel(tunet.UNetConfig(**TINY, remat=remat), device="cpu")
    m.load_state_dict(tunet.state_dict_from_jax(variables["params"]))
    sd = {k: torch.tensor(np.array(v)) for k, v in net.state_dict().items()}
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=sd, device="cpu")
    return model, variables, net, m, tnet, d


def _jax_loss_and_grads(model, variables, net, d):
    """value_and_grad of the JAX trainer's loss (DDPM noising, the adapted
    model with ``added_cond``, eps-MSE) over the trainable adapter tree."""
    trainable = net.trainable_params()
    buffers = {ln: {k: v for k, v in net.lora_map[ln].params.items() if k not in sub}
               for ln, sub in trainable.items()}
    a = jnp.asarray(jax_acp(1000)[d["t"]]).reshape(-1, 1, 1, 1)
    noisy = jnp.sqrt(a) * jnp.asarray(d["lat"]) + jnp.sqrt(1 - a) * jnp.asarray(d["noise"])

    def loss_fn(tree):
        full = {ln: {**buffers[ln], **sub} for ln, sub in tree.items()}
        pred = net({"params": variables["params"]}, noisy, jnp.asarray(d["t"]),
                   jnp.asarray(d["ctx"]), jnp.asarray(d["added"]), adapter_params=full,
                   train=True, rng=jax.random.key(5), model=model, merged_forward=True)
        return jnp.mean((pred.astype(jnp.float32) - jnp.asarray(d["noise"])) ** 2)

    return jax.value_and_grad(loss_fn)(trainable)


def _port_loss_and_grads(m, tnet, d):
    tr = DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32)
    loss = tr.loss_fn(*(torch.tensor(d[k]) for k in ("lat", "ctx", "noise")),
                      torch.tensor(d["t"]).long(), torch.tensor(d["added"]))
    loss.backward()
    grads = {ln: {k: p.grad.clone() for k, p in sub.items()}
             for ln, sub in tnet.trainable_params().items()}
    for p in tnet.parameters():
        p.grad = None
    return float(loss.detach()), grads


def _flat(grads):
    return np.concatenate([np.asarray(grads[ln][k]).ravel()
                           for ln in sorted(grads) for k in sorted(grads[ln])])


@pytest.mark.parametrize("algo", ["lokr", "loha"])
def test_sdxl_trainer_loss_and_grads_match_jax(algo):
    model, variables, net, m, tnet, d = _setup(algo)
    want_loss, want_grads = _jax_loss_and_grads(model, variables, net, d)
    loss, grads = _port_loss_and_grads(m, tnet, d)
    np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
    assert set(grads) == set(want_grads) and len(grads) > 20
    for ln in want_grads:
        assert set(grads[ln]) == set(want_grads[ln]), ln
    g = _flat({ln: {k: v.numpy() for k, v in sub.items()} for ln, sub in grads.items()})
    w = _flat(want_grads)
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(g, w, rtol=REL, atol=REL * np.abs(w).max())
    assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w)


@pytest.mark.parametrize("remat", ["transformer", True])
def test_checkpointing_changes_no_gradient(remat):
    """The same weights with and without checkpointed blocks: the same loss
    and adapter gradients, and the checkpointed forward ran again."""
    _, _, _, m, tnet, d = _setup("lokr", remat=remat)
    calls = []
    block = m.mid_block_attentions_0
    hook = block.register_forward_pre_hook(lambda *_: calls.append(1))
    loss, grads = _port_loss_and_grads(m, tnet, d)
    assert len(calls) == 2  # the forward, and the recompute in the backward
    tnet.restore()
    m.cfg = dataclasses.replace(m.cfg, remat=False)
    calls.clear()
    loss0, grads0 = _port_loss_and_grads(m, tnet, d)
    hook.remove()
    assert len(calls) == 1
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    g, g0 = (_flat({ln: {k: v.numpy() for k, v in sub.items()} for ln, sub in gs.items()})
             for gs in (grads, grads0))
    np.testing.assert_allclose(g, g0, rtol=1e-6, atol=1e-6 * np.abs(g0).max())


@pytest.mark.parametrize("tier", ["attn_out", "attn_ff", "attn_ff_qkv_norm", "blocks"])
def test_named_remat_tiers_raise(tier):
    with pytest.raises(ValueError, match="not ported"):
        tunet.sdxl_config(remat=tier)
    with pytest.raises(ValueError, match="not ported"):
        tunet.UNetConfig(remat=tier)


def test_sdxl_config_matches_jax():
    for remat in (False, "transformer", True):
        t = dataclasses.asdict(tunet.sdxl_config(remat=remat))
        j = dataclasses.asdict(junet.sdxl_config(remat=remat))
        t.pop("dtype"), j.pop("dtype")
        assert t == j
    assert tunet.sd15_config(remat=True).remat is True
