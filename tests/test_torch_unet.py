"""Port vs JAX package on the tiny UNet: forward with weights carried over by
``state_dict_from_jax``, adapter targeting (same ``lora_name`` set and
shapes), state-dict round trips in both directions, live adapters and
``merge_to``.

Tolerance: 1e-4 for whole-UNet outputs (reduction order differs between
XLA and PyTorch over many layers), exact for copied tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.models import unet as junet
from lycoris_tpu_torch.models import unet as tunet

UNET_TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_MLP = {"target_module": ["Transformer2DModel"]}


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 4, 8, 8)).astype(np.float32)
    t = np.array([10, 500, 999, 1][:batch], np.int32)
    ctx = rng.standard_normal((batch, 6, 32)).astype(np.float32)
    return x, t, ctx


def _jax_unet(x, t, ctx):
    model = junet.UNet2DConditionModel(junet.tiny_unet_config())
    variables = model.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    return model, variables


def _torch_unet(variables):
    m = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="cpu")
    m.load_state_dict(tunet.state_dict_from_jax(variables["params"]))
    return m.eval()


def _jax_net(model, variables, x, t, ctx, algo, preset=ATTN_MLP, seed=0):
    graph = jl.ModelGraph.from_linen(model, variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    if preset is not None:
        jl.LycorisNetwork.apply_preset(preset)
    net = jl.create_lycoris(graph, 1.0, 4, 2.0, algo=algo, factor=4, rng=jax.random.key(1))
    jl.LycorisNetwork.reset_preset()
    # LoKr's lokr_w2 / LoHa's hada_w2_a start at zero (dW = 0): fill every
    # trainable factor with seeded nonzero values so the adapter path is tested
    rng = np.random.default_rng(seed)
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.05)
    net.set_params_tree(tree)
    return net, tree


def _torch_sd(sd_np):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd_np.items()}


def test_state_dict_from_jax_covers_every_parameter():
    x, t, ctx = _inputs()
    _, variables = _jax_unet(x, t, ctx)
    sd = tunet.state_dict_from_jax(variables["params"])
    m = tunet.UNet2DConditionModel(tunet.tiny_unet_config(), device="cpu")
    assert set(sd) == set(m.state_dict())
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in m.state_dict().items())


def test_tiny_unet_forward_matches():
    x, t, ctx = _inputs()
    model, variables = _jax_unet(x, t, ctx)
    want = model.apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    m = _torch_unet(variables)
    with torch.no_grad():
        got = m(*map(torch.from_numpy, (x, t, ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)


@pytest.mark.parametrize("algo", ["lokr", "loha", "lora"])
@pytest.mark.parametrize("preset", [ATTN_MLP, None], ids=["attn-mlp", "full"])
def test_targeting_names_and_shapes_match(algo, preset):
    x, t, ctx = _inputs()
    model, variables = _jax_unet(x, t, ctx)
    jnet, _ = _jax_net(model, variables, x, t, ctx, algo, preset)
    m = _torch_unet(variables)
    if preset is not None:
        tl.LycorisNetwork.apply_preset(preset)
    tnet = tl.create_lycoris(m, 1.0, 4, 2.0, algo=algo, factor=4, device="cpu")
    tl.LycorisNetwork.reset_preset()
    assert set(tnet.lora_map) == set(jnet.lora_map)
    jsd, tsd = jnet.state_dict(), tnet.state_dict()
    assert set(jsd) == set(tsd)
    for k in jsd:
        assert tuple(tsd[k].shape) == tuple(np.shape(jsd[k])), k


@pytest.mark.parametrize("algo", ["lokr", "loha", "lora"])
def test_state_dict_round_trip_both_ways(algo):
    x, t, ctx = _inputs()
    model, variables = _jax_unet(x, t, ctx)
    jnet, _ = _jax_net(model, variables, x, t, ctx, algo)
    jsd = jnet.state_dict()
    graph = jl.ModelGraph.from_linen(model, variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))

    def jax_reload(sd):
        net, _ = jl.create_lycoris_from_weights(1.0, None, graph, weights_sd=sd)
        return net.state_dict()

    # what the JAX package itself gives back after loading its own file
    # (a LoKr layer with both factors full reloads with alpha = rank, scale 1)
    want = jax_reload(jsd)
    m = _torch_unet(variables)
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=_torch_sd(jsd), device="cpu")
    tsd = tnet.state_dict()
    assert set(tsd) == set(want) == set(jsd)
    for k in want:
        np.testing.assert_array_equal(tsd[k].numpy(), np.asarray(want[k]), err_msg=k)
    # and back: the port's state dict loads in the JAX package unchanged
    back = jax_reload({k: v.numpy() for k, v in tsd.items()})
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(want[k]), err_msg=k)
    # load_state_dict into a network built by create_lycoris (same targeting)
    tl.LycorisNetwork.apply_preset(ATTN_MLP)
    tnet2 = tl.create_lycoris(_torch_unet(variables), 1.0, 4, 2.0, algo=algo, factor=4, device="cpu")
    tl.LycorisNetwork.reset_preset()
    report = tnet2.load_state_dict(_torch_sd(jsd))
    assert report == {"loaded": len(jnet.loras), "missing": []}
    tsd2 = tnet2.state_dict()
    for k in jsd:
        np.testing.assert_array_equal(tsd2[k].numpy(), np.asarray(jsd[k]), err_msg=k)


@pytest.mark.parametrize("algo", ["lokr", "loha", "lora"])
@pytest.mark.parametrize("merged_forward", [True, False])
def test_live_adapters_and_merge_match(algo, merged_forward):
    x, t, ctx = _inputs()
    model, variables = _jax_unet(x, t, ctx)
    jnet, tree = _jax_net(model, variables, x, t, ctx, algo)
    jx, jt, jc = map(jnp.asarray, (x, t, ctx))
    want = jnet(variables, jx, jt, jc, adapter_params=tree, model=model,
                merged_forward=merged_forward)
    m = _torch_unet(variables)
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, device="cpu",
                                             weights_sd=_torch_sd(jnet.state_dict()))
    tnet.apply_to(merged_forward=merged_forward)
    tx, tt, tc = map(torch.from_numpy, (x, t, ctx))
    with torch.no_grad():
        got = m(tx, tt, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **UNET_TOL)

    # merge_to folds the same weights as the JAX package's merge_to
    tnet.restore()
    tnet.merge_to(1.0)
    merged = tunet.state_dict_from_jax(jnet.merge_to(1.0, adapter_params=tree))
    for k, v in m.state_dict().items():
        np.testing.assert_allclose(v.numpy(), merged[k].numpy(), atol=1e-6, rtol=1e-5, err_msg=k)
    with torch.no_grad():
        got_merged = m(tx, tt, tc)
    np.testing.assert_allclose(got_merged.numpy(), np.asarray(want), **UNET_TOL)


def test_restore_gives_back_the_base_model():
    x, t, ctx = _inputs()
    model, variables = _jax_unet(x, t, ctx)
    jnet, _ = _jax_net(model, variables, x, t, ctx, "lokr")
    m = _torch_unet(variables)
    tx, tt, tc = map(torch.from_numpy, (x, t, ctx))
    with torch.no_grad():
        base = m(tx, tt, tc)
        tnet, _ = tl.create_lycoris_from_weights(1.0, None, m, device="cpu",
                                                 weights_sd=_torch_sd(jnet.state_dict()))
        tnet.apply_to(merged_forward=True)
        adapted = m(tx, tt, tc)
        tnet.restore()
        again = m(tx, tt, tc)
    assert float((adapted - base).abs().max()) > 1e-3
    torch.testing.assert_close(again, base, atol=0, rtol=0)


def test_unported_algorithms_name_themselves():
    """No algorithm of the JAX package is left unported: GLoRA (the last
    one this test once saw refused) builds and its file loads as GLoRA; an
    algorithm neither package has is refused by name."""
    x, t, ctx = _inputs()
    _, variables = _jax_unet(x, t, ctx)
    m = _torch_unet(variables)
    net = tl.create_lycoris(m, 1.0, 4, 2.0, algo="glora", device="cpu")
    assert net.loras and {type(ly).__name__ for ly in net.loras} == {"GLoRAModule"}
    loaded, _ = tl.create_lycoris_from_weights(1.0, None, m, weights_sd=net.state_dict(),
                                               device="cpu")
    assert {type(ly).__name__ for ly in loaded.loras} == {"GLoRAModule"}
    assert len(loaded.loras) == len(net.loras)
    with pytest.raises(ValueError, match="'nope'"):
        tl.create_lycoris(m, 1.0, 4, 2.0, algo="nope", device="cpu")
