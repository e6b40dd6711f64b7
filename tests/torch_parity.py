"""Shared set-up of the port's whole-model parity tests (``test_torch_dora``,
``test_torch_lifecycle``, ``test_torch_files``): the JAX tiny UNet with
adapters whose factors are seeded nonzero, the port's UNet and network
loaded from them, the JAX trainer's loss and gradients, and the port's.

Inputs are drawn with numpy from a seed; torch gets its own copies
(``torch.tensor``), since a JAX CPU array may alias a numpy buffer.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.models import unet as junet
from lycoris_tpu.trainer import ddpm_alphas_cumprod as jax_acp
from lycoris_tpu_torch.models import unet as tunet
from lycoris_tpu_torch.trainer import DiffusionTrainer

ATTN_MLP = {"target_module": ["Transformer2DModel"]}


@functools.lru_cache(maxsize=2)
def jax_unet(batch=2, hw=8):
    """The JAX tiny UNet, its parameters and graph, and numpy latents,
    context, noise and timesteps (built once per shape: the init compiles)."""
    rng = np.random.default_rng(0)
    d = dict(lat=rng.standard_normal((batch, 4, hw, hw)), ctx=rng.standard_normal((batch, 6, 32)),
             noise=rng.standard_normal((batch, 4, hw, hw)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["t"] = rng.integers(0, 1000, batch).astype(np.int32)
    model = junet.UNet2DConditionModel(junet.tiny_unet_config())
    args = (jnp.asarray(d["lat"]), jnp.asarray(d["t"]), jnp.asarray(d["ctx"]))
    variables = jax.jit(model.init)(jax.random.key(0), *args)
    return model, variables, jl.ModelGraph.from_linen(model, variables, *args), d


def port_unet(variables, remat=False):
    """The port's tiny UNet on the CPU with the JAX model's weights."""
    cfg = dataclasses.replace(tunet.tiny_unet_config(), remat=remat)
    m = tunet.UNet2DConditionModel(cfg, device="cpu")
    m.load_state_dict(tunet.state_dict_from_jax(variables["params"]))
    return m


def setup(algo, batch=2, remat=False, seed=1, **net_kw):
    """(JAX model, variables, JAX network, port UNet, port network, data):
    attn-mlp adapters, dim 4 alpha 2 (LoKr factor 4) and ``net_kw``, every
    trainable tensor moved by noise of std 0.05 (zero-init factors would
    make dW = 0); the port's network loaded from the JAX one's state dict."""
    model, variables, graph, d = jax_unet(batch)
    rng = np.random.default_rng(seed)
    jl.LycorisNetwork.apply_preset(ATTN_MLP)
    try:
        net = jl.create_lycoris(graph, 1.0, 4, 2.0, algo=algo, factor=4,
                                rng=jax.random.key(seed), **net_kw)
    finally:
        jl.LycorisNetwork.reset_preset()
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.05)
    net.set_params_tree(tree)
    m = port_unet(variables, remat)
    sd = {k: torch.tensor(np.array(v)) for k, v in net.state_dict().items()}
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=sd, device="cpu")
    return model, variables, net, m, tnet, d


def noisy_latents(d):
    acp = jax_acp(1000)
    b = d["lat"].shape[0]
    a = jnp.asarray(acp[d["t"]]).reshape(b, 1, 1, 1)
    return jnp.sqrt(a) * jnp.asarray(d["lat"]) + jnp.sqrt(1 - a) * jnp.asarray(d["noise"])


def jax_loss_and_grads(model, variables, net, d, jit=False):
    """value_and_grad of the JAX trainer's loss (the interceptor route,
    merged forward) over the trainable adapter tree; with ``jit`` compiled
    first (faster where the eager dispatch of many small ops dominates)."""
    trainable = net.trainable_params()
    buffers = {ln: {k: v for k, v in net.lora_map[ln].params.items() if k not in sub}
               for ln, sub in trainable.items()}
    noisy = noisy_latents(d)

    def loss_fn(tree):
        full = {ln: {**buffers[ln], **sub} for ln, sub in tree.items()}
        pred = net({"params": variables["params"]}, noisy, jnp.asarray(d["t"]),
                   jnp.asarray(d["ctx"]), adapter_params=full, train=True,
                   rng=jax.random.key(5), model=model, merged_forward=True)
        return jnp.mean((pred.astype(jnp.float32) - jnp.asarray(d["noise"])) ** 2)

    fn = jax.value_and_grad(loss_fn)
    return (jax.jit(fn) if jit else fn)(trainable)


def port_loss_and_grads(m, tnet, d, **trainer_kw):
    """The port trainer's loss on ``d`` and its adapter gradients, the
    backward inside the trainer's route (``adapted``)."""
    tr = DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32, **trainer_kw)
    with tr.adapted():
        loss = tr.loss_fn(*(torch.tensor(d[k]) for k in ("lat", "ctx", "noise")),
                          torch.tensor(d["t"]).long())
        loss.backward()
    grads = {ln: {k: p.grad for k, p in sub.items()} for ln, sub in tnet.trainable_params().items()}
    return tr, float(loss.detach()), grads


def assert_trees_close(got, want, rel):
    """Same (lora_name, key) sets; every leaf within ``rel`` of the largest
    magnitude, and the concatenation within rel L2 ``rel``."""
    assert set(got) == set(want)
    flat_g, flat_w = [], []
    for ln in want:
        assert set(got[ln]) == set(want[ln]), ln
        for k in want[ln]:
            assert got[ln][k] is not None, (ln, k)
            flat_g.append(np.asarray(torch.as_tensor(got[ln][k]).detach()).ravel())
            flat_w.append(np.asarray(want[ln][k]).ravel())
    g, w = np.concatenate(flat_g), np.concatenate(flat_w)
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(g, w, rtol=rel, atol=rel * np.abs(w).max())
    assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w)
