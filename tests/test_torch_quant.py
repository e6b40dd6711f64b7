"""The port's int8 quantized bases (QLyCORIS) against ``lycoris_tpu.utils.quant``:
the int8 round trip bit for bit, ``Int8Linear``'s forward (fp32; its
head-split form against the port's ``Linear``), and the wrapper's rules
over quantized layers: bypass forced (also on a network loaded from a
file), ``algo="full"`` refused, no merged route, no premerge, ``merge_to``
leaving the int8 weights, and the adapted output equal to the JAX
network's. Then the port's ``quant_example`` runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn
from torch import nn

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.utils import quant as jq
from lycoris_tpu_torch.graph import ModelGraph, layer_info_for
from lycoris_tpu_torch.models import layers as L
from lycoris_tpu_torch.models.unet import state_dict_from_jax
from lycoris_tpu_torch.utils import quant as tq

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


@pytest.mark.parametrize("shape", [(64, 32), (16, 8, 3, 3), (5, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_round_trip_bit_for_bit(shape, dtype):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[0] = 0.0  # an all-zero row takes the 1e-8 floor of the scale
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.tensor(w).to(getattr(torch, dtype))
    jqv, js = jq.quantize_int8(jw)
    tqv, ts = tq.quantize_int8(tw)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for out in ("float32", "bfloat16"):
        want = np.asarray(jq.dequantize_int8(jqv, js, getattr(jnp, out)), np.float32)
        got = tq.dequantize_int8(tqv, ts, getattr(torch, out)).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_round_half_to_even():
    # 0.5 / 1.5 / 2.5 steps of the scale: to even, as jnp.round
    w = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    q, scale = tq.quantize_int8(w)
    assert float(scale) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


class JQNet(fnn.Module):
    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x):
        h = jq.Int8Linear(64, name="fc1", dtype=self.dtype)(x)
        return jq.Int8Linear(32, name="fc2", use_bias=False, dtype=self.dtype)(h)


class TQNet(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.fc1 = tq.Int8Linear(32, 64, dtype=dtype)
        self.fc2 = tq.Int8Linear(64, 32, bias=False, dtype=dtype)

    def forward(self, x):
        return self.fc2(self.fc1(x))


def quant_models(seed=0):
    """The JAX and the port's two-layer int8 nets with the same quantized
    random weights, and an fp32 input."""
    rng = np.random.default_rng(seed)
    params = {"fc1": jq.quantize_linear_params(
        {"weight": jnp.asarray(rng.standard_normal((64, 32)).astype(np.float32) * 0.2),
         "bias": jnp.asarray(rng.standard_normal(64).astype(np.float32))}),
        "fc2": jq.quantize_linear_params(
        {"weight": jnp.asarray(rng.standard_normal((32, 64)).astype(np.float32) * 0.2)})}
    tmodel = TQNet()
    tmodel.load_state_dict(state_dict_from_jax(params))
    x = rng.standard_normal((3, 32)).astype(np.float32)
    return JQNet(), {"params": params}, tmodel, x


def test_int8_linear_forward_matches_jax():
    jmodel, variables, tmodel, x = quant_models()
    assert tmodel.fc1.weight_q.dtype == torch.int8
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    got = tmodel(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the graph sees the layer (lycoris_layer_info) and its weight dequantized
    li = layer_info_for(tmodel.fc1, "fc1")
    assert li.module_type == "linear" and li.shape == (64, 32) and li.has_bias
    node = ModelGraph.from_torch(tmodel).nodes[1]
    assert node.is_quant
    np.testing.assert_array_equal(
        node.weights()[0].numpy(),
        np.asarray(jq.dequantize_int8(variables["params"]["fc1"]["weight_q"],
                                      variables["params"]["fc1"]["scale"], jnp.float32)))


def test_int8_linear_head_split_and_from_linear():
    torch.manual_seed(0)
    lin = L.Linear(32, 48, bias=False, head_split=(4, 12))
    q = tq.Int8Linear.from_linear(lin, dtype=torch.float32)
    ref = L.Linear(32, 48, bias=False, head_split=(4, 12))
    with torch.no_grad():
        ref.weight.copy_(q.dequantized_weight())
    x = torch.randn(2, 5, 32)
    y = q(x)
    assert y.shape == (2, 4, 5, 12)
    torch.testing.assert_close(y, ref(x), rtol=0, atol=0)
    torch.testing.assert_close(q.from_native(y), ref.from_native(ref(x)), rtol=0, atol=0)
    torch.testing.assert_close(q.forward_with(x, q.dequantized_weight(), None), y, rtol=0, atol=0)


@pytest.mark.parametrize("algo", ["lokr", "locon", "loha"])
def test_quant_network_matches_jax(algo):
    jmodel, variables, tmodel, x = quant_models(seed=1)
    graph = jl.ModelGraph.from_linen(jmodel, variables, jnp.asarray(x))
    jnet = jl.create_lycoris(graph, 1.0, linear_dim=4, linear_alpha=2.0, algo=algo, factor=4,
                             rng=jax.random.key(0))
    tnet = tl.create_lycoris(tmodel, 1.0, linear_dim=4, linear_alpha=2.0, algo=algo, factor=4,
                             device="cpu")
    assert len(tnet.loras) == 2 and all(lyco.bypass_mode for lyco in tnet.loras)
    assert all(lyco.bypass_mode for lyco in jnet.loras)
    tree = jnet.params_tree()
    rng = np.random.default_rng(2)
    for ln, p in tree.items():
        for k in sorted(p):
            if k in jnet.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.1)
    sd = {k: torch.tensor(np.array(v)) for k, v in jnet.state_dict(adapter_params=tree).items()}
    assert set(sd) == set(tnet.state_dict())
    tnet.load_state_dict(sd)
    want = np.asarray(jnet(variables, jnp.asarray(x), adapter_params=tree))

    # the merged route is never taken for a quantized layer, even with
    # merged_forward and bypass switched off by hand
    def refuse(*a, **k):
        raise AssertionError("a quantized layer reached get_merged_weight")

    for lyco in tnet.loras:
        lyco.get_merged_weight = refuse
    tnet.apply_to(merged_forward=True)
    with torch.no_grad():
        got = tmodel(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    tnet.loras[0].bypass_mode = False
    with torch.no_grad():
        tmodel(torch.tensor(x))
    tnet.restore()
    tnet.loras[0].bypass_mode = True

    # merge_to, onfly_merge and premerge leave the int8 weights bit for bit
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tnet.merge_to(1.0)
    tnet.onfly_merge(1.0)
    tnet.onfly_restore()
    with tnet.premerged():
        assert all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())
    assert all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())

    # a network loaded from the file is forced into bypass mode too
    lnet, _ = tl.create_lycoris_from_weights(1.0, None, tmodel, weights_sd=sd, device="cpu",
                                             lora_prefix="lycoris")
    assert len(lnet.loras) == 2 and all(lyco.bypass_mode for lyco in lnet.loras)


def test_full_algo_refuses_quant_layers():
    _, _, tmodel, _ = quant_models()
    with pytest.raises(ValueError, match="Quant layers are not supported in Full algo"):
        tl.create_lycoris(tmodel, 1.0, linear_dim=4, linear_alpha=1.0, algo="full", device="cpu")


def test_quant_linear_params():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    want = jq.quantize_linear_params({"weight": jnp.asarray(w), "bias": jnp.asarray(b)})
    got = tq.quantize_linear_params({"weight": torch.tensor(w), "bias": torch.tensor(b)})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert "bias" not in tq.quantize_linear_params({"weight": torch.tensor(w)})
    assert tq.QUANT_CLASSES == jq.QUANT_CLASSES
    for name in ("Int8Linear", "Linear8bitLt", "Linear"):
        assert tq.is_quant_class(name) == jq.is_quant_class(name)


def test_quant_example_runs(capsys):
    from lycoris_tpu_torch.examples import quant_example

    quant_example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "bypass forced: True" in out
    assert "adapted output shape: (2, 128)" in out
    assert "merge_to kept the int8 weights: True" in out
