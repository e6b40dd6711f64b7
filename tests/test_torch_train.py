"""The training slice as a whole, port vs JAX package on the tiny UNet: the
trainer's loss and every adapter gradient (LoKr, LoHa and LoRA, the merged
forward), the factored merged backward through the wrapper, one AdamW step
against ``optax.adamw``, and what the trainer leaves alone.

The JAX side's loss mirrors ``lycoris_tpu/trainer.py`` (``loss_fn``: DDPM
noising, ``net(..., train=True, merged_forward=True)``, eps-MSE) with the
same numpy noise and timesteps. Tolerance: 1e-4 relative for the loss and
for the gradients (fp32; a whole forward and backward of the UNet).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.models import unet as junet
from lycoris_tpu.trainer import ddpm_alphas_cumprod as jax_acp
from lycoris_tpu_torch.functional import merged as tmerged
from lycoris_tpu_torch.models import unet as tunet
from lycoris_tpu_torch.ops import flash as tflash
from lycoris_tpu_torch.trainer import DiffusionTrainer

ATTN_MLP = {"target_module": ["Transformer2DModel"]}
REL = 1e-4


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _setup(algo, hw=8, batch=2, seed=0):
    """JAX tiny UNet + adapters with seeded nonzero factors, the port's UNet
    and network loaded from them, and numpy inputs, noise and timesteps."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((batch, 4, hw, hw)).astype(np.float32)
    ctx = rng.standard_normal((batch, 6, 32)).astype(np.float32)
    noise = rng.standard_normal((batch, 4, hw, hw)).astype(np.float32)
    t = np.array([17, 640, 999, 3][:batch], np.int32)

    model = junet.UNet2DConditionModel(junet.tiny_unet_config())
    args = (jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    variables = model.init(jax.random.key(0), *args)
    graph = jl.ModelGraph.from_linen(model, variables, *args)
    jl.LycorisNetwork.apply_preset(ATTN_MLP)
    net = jl.create_lycoris(graph, 1.0, 4, 2.0, algo=algo, factor=4, rng=jax.random.key(1))
    jl.LycorisNetwork.reset_preset()
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.05)
    net.set_params_tree(tree)

    m = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="cpu")
    m.load_state_dict(tunet.state_dict_from_jax(variables["params"]))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in net.state_dict().items()}
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=sd, device="cpu")
    data = dict(lat=lat, ctx=ctx, noise=noise, t=t)
    return model, variables, net, m, tnet, data


def _jax_loss_and_grads(model, variables, net, d):
    """value_and_grad of the JAX trainer's loss over the trainable adapter tree."""
    trainable = net.trainable_params()
    buffers = {ln: {k: v for k, v in net.lora_map[ln].params.items() if k not in sub}
               for ln, sub in trainable.items()}
    acp = jax_acp(1000)
    b = d["lat"].shape[0]
    a = jnp.asarray(acp[d["t"]]).reshape(b, 1, 1, 1)
    noisy = jnp.sqrt(a) * jnp.asarray(d["lat"]) + jnp.sqrt(1 - a) * jnp.asarray(d["noise"])

    def loss_fn(tree):
        full = {ln: {**buffers[ln], **sub} for ln, sub in tree.items()}
        pred = net({"params": variables["params"]}, noisy, jnp.asarray(d["t"]),
                   jnp.asarray(d["ctx"]), adapter_params=full, train=True,
                   rng=jax.random.key(5), model=model, merged_forward=True)
        return jnp.mean((pred.astype(jnp.float32) - jnp.asarray(d["noise"])) ** 2)

    return jax.value_and_grad(loss_fn)(trainable)


def _port_loss_and_grads(m, tnet, d, **trainer_kw):
    tr = DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32, **trainer_kw)
    loss = tr.loss_fn(*(torch.from_numpy(d[k]) for k in ("lat", "ctx", "noise")),
                      torch.from_numpy(d["t"]).long())
    loss.backward()
    grads = {ln: {k: p.grad for k, p in sub.items()} for ln, sub in tnet.trainable_params().items()}
    return tr, float(loss.detach()), grads


def _assert_grads_close(got, want):
    """Same (lora_name, key) sets; every leaf within 1e-4 of the largest
    gradient, and the concatenated gradient within rel L2 1e-4."""
    assert set(got) == set(want)
    flat_g, flat_w = [], []
    for ln in want:
        assert set(got[ln]) == set(want[ln]), ln
        for k in want[ln]:
            assert got[ln][k] is not None, (ln, k)
            flat_g.append(got[ln][k].detach().numpy().ravel())
            flat_w.append(np.asarray(want[ln][k]).ravel())
    g, w = np.concatenate(flat_g), np.concatenate(flat_w)
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(g, w, rtol=REL, atol=REL * np.abs(w).max())
    assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w)


@pytest.mark.parametrize("algo", ["lokr", "loha", "lora"])
def test_trainer_loss_and_grads_match_jax(algo):
    model, variables, net, m, tnet, d = _setup(algo)
    want_loss, want_grads = _jax_loss_and_grads(model, variables, net, d)
    _, loss, grads = _port_loss_and_grads(m, tnet, d)
    np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
    _assert_grads_close(grads, want_grads)


def test_trainer_grads_through_flash_match_jax():
    """32x32 latents: the tiny UNet's first level has T = 1024, so its
    self-attention takes the flash Function (plain both ways on the CPU)."""
    model, variables, net, m, tnet, d = _setup("lokr", hw=32, batch=1)
    want_loss, want_grads = _jax_loss_and_grads(model, variables, net, d)
    n = tflash.bwd_launches
    calls = []
    real = tflash.FlashAttentionFunction.backward

    def spy(ctx, *g):
        calls.append(ctx.saved_tensors[0].shape)
        return real(ctx, *g)

    mp = pytest.MonkeyPatch()
    mp.setattr(tflash.FlashAttentionFunction, "backward", staticmethod(spy))
    try:
        _, loss, grads = _port_loss_and_grads(m, tnet, d)
    finally:
        mp.undo()
    assert calls and all(s[2] == 1024 for s in calls) and tflash.bwd_launches == n
    np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
    _assert_grads_close(grads, want_grads)


def _check_factored_through_the_wrapper(monkeypatch, algo):
    """worth_factoring threshold 0: every adapted linear layer of the tiny
    UNet trains through factored_merged_apply on the port and through the
    JAX package's factored custom_vjp; the grads agree with each other and
    with the port's plain autograd through W + dW."""
    monkeypatch.setenv("LYCORIS_TPU_FACTORED_MIN", "0")
    model, variables, net, m, tnet, d = _setup(algo)
    want_loss, want_grads = _jax_loss_and_grads(model, variables, net, d)

    monkeypatch.setattr(tmerged, "FACTORED_MIN", 0)
    n = tmerged.applications
    _, loss, grads = _port_loss_and_grads(m, tnet, d)
    linears = sum(1 for lyco in tnet.loras if lyco.module_type == "linear")
    assert linears > 0 and tmerged.applications - n == linears
    np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
    _assert_grads_close(grads, want_grads)

    # the same port network with the dense path: plain autograd through W + dW
    monkeypatch.undo()
    for p in tnet.parameters():
        p.grad = None
    n = tmerged.applications
    _, dense_loss, dense = _port_loss_and_grads(m, tnet, d)
    assert tmerged.applications == n
    np.testing.assert_allclose(dense_loss, loss, rtol=1e-6)
    _assert_grads_close(grads, {ln: {k: g.numpy() for k, g in sub.items()}
                                for ln, sub in dense.items()})


def test_factored_backward_through_the_wrapper(monkeypatch):
    _check_factored_through_the_wrapper(monkeypatch, "lokr")


def test_factored_lora_backward_through_the_wrapper(monkeypatch):
    """LoRA's factored cotangents (``LoConModule.factored_merged_fns``), the
    path of SD1.5's 12 widest layers, through the wrapper."""
    _check_factored_through_the_wrapper(monkeypatch, "lora")


def test_adamw_step_matches_optax():
    """One trainer step equals optax.adamw at its defaults (weight decay
    1e-4) applied to the same gradients."""
    _, _, _, m, tnet, d = _setup("lokr")
    tr, _, grads = _port_loss_and_grads(m, tnet, d)
    before = {ln: {k: p.detach().clone() for k, p in sub.items()}
              for ln, sub in tnet.trainable_params().items()}
    tr.optimizer.step()
    after = tr.adapter_tree()

    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), before)
    jgrads = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), grads)
    opt = optax.adamw(1e-3)
    updates, _ = opt.update(jgrads, opt.init(params), params)
    want = optax.apply_updates(params, updates)
    for ln in want:
        for k in want[ln]:
            np.testing.assert_allclose(after[ln][k].numpy(), np.asarray(want[ln][k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{ln}.{k}")
    assert tr.optimizer.defaults["weight_decay"] == 1e-4


def test_train_steps_leave_the_base_untouched():
    _, _, _, m, tnet, d = _setup("loha")
    tr = DiffusionTrainer(m, tnet, lr=1e-3, weight_dtype=torch.float32)
    base = {k: v.clone() for k, v in m.state_dict().items()}
    adapters = {k: v.detach().clone() for k, v in tnet.named_parameters()}
    batch = {"latents": torch.from_numpy(d["lat"]), "context": torch.from_numpy(d["ctx"])}
    losses = [float(tr.train_step(batch)) for _ in range(2)]
    assert np.isfinite(losses).all() and tr.step == 2
    assert all(not p.requires_grad for p in m.parameters())
    for k, v in m.state_dict().items():
        torch.testing.assert_close(v, base[k], atol=0, rtol=0)
    for k, v in tnet.named_parameters():
        assert not torch.equal(v.detach(), adapters[k]), k
        assert v.device.type == "cpu"
    steps_per_s, loss = tr.benchmark(batch, warmup=1, iters=2)
    assert steps_per_s > 0 and np.isfinite(loss) and tr.step == 5


def test_entry_points_default_to_the_card():
    """The UNet is built on the card unless the caller asks for another
    device; adapters follow the model's weights."""
    import inspect

    assert inspect.signature(tunet.UNet2DConditionModel).parameters["device"].default == "cuda"
    m = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="meta")
    assert next(m.parameters()).device.type == "meta"
    cpu = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="cpu")
    tl.LycorisNetwork.apply_preset(ATTN_MLP)
    net = tl.create_lycoris(cpu, 1.0, 4, 2.0, algo="lokr", factor=4)
    assert net.loras and all(p.device.type == "cpu" for p in net.parameters())
