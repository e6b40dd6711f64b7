"""The port's CLIP text encoder (``lycoris_tpu_torch/models/clip.py``) against
the JAX package's (``lycoris_tpu/models/clip.py``): the same weights (the
JAX init moved by seeded noise, so that the zero position table and unit
norms are not special) carried over by ``state_dict_from_jax``, the same
token ids, in fp32: the last hidden state within 1e-5 relative, on the tiny
config and on CLIP-L's width (768, 12 heads, 3072) cut to 2 layers. Then
the names presets target, the causal mask, and the tanh GELU.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.config import PRESET as JPRESET
from lycoris_tpu.models import clip as jclip
from lycoris_tpu_torch.models import clip as tclip

REL = 1e-5
CONFIGS = {
    "tiny": (jclip.tiny_clip_config(), tclip.tiny_clip_config(), 16),
    "clip_l_2_layers": (dataclasses.replace(jclip.clip_l_config(), num_layers=2),
                        dataclasses.replace(tclip.clip_l_config(), num_layers=2), 77),
}


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _models(name, seed=0):
    """(JAX model, its params moved by noise, the port's model with them,
    numpy token ids (2, T))."""
    jcfg, tcfg, t = CONFIGS[name]
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, jcfg.vocab_size, (2, t)).astype(np.int32)
    model = jclip.CLIPTextModel(jcfg)
    params = model.init(jax.random.key(seed), jnp.asarray(ids))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.05),
        params)
    port = tclip.CLIPTextModel(tcfg, device="cpu")
    port.load_state_dict(tclip.state_dict_from_jax(params))
    return model, params, port, ids


@pytest.mark.parametrize("name", list(CONFIGS))
def test_clip_matches_jax(name):
    model, params, port, ids = _models(name)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.tensor(ids).long()).numpy()
    assert got.shape == want.shape == (*ids.shape, CONFIGS[name][1].hidden_size)
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * np.abs(want).max())
    assert np.linalg.norm(got - want) <= REL * np.linalg.norm(want)


def test_clip_targets_and_names_match_jax():
    """The text-encoder preset's classes adapt the same layers under the same
    ``lora_name``s in both packages (6 a layer), and the state dict carries
    every JAX parameter over."""
    model, params, port, ids = _models("tiny")
    assert set(port.state_dict()) == set(tclip.state_dict_from_jax(params))
    targets = {"target_module": JPRESET["attn-mlp"]["text_encoder_target_module"]}
    jl.LycorisNetwork.apply_preset(targets)
    jnet = jl.create_lycoris(jl.ModelGraph.from_linen(model, {"params": params},
                                                       jnp.asarray(ids)),
                             1.0, 4, 1.0, algo="lora", rng=jax.random.key(0))
    tl.LycorisNetwork.apply_preset(targets)
    tnet = tl.create_lycoris(port, 1.0, 4, 1.0, algo="lora")
    names = {lyco.lora_name for lyco in tnet.loras}
    assert names == {lyco.lora_name for lyco in jnet.loras} and len(names) == 12
    assert "lycoris_text_model_encoder_layers_1_mlp_fc2" in names


def test_clip_is_causal_and_defaults_to_the_card():
    """Changing the last tokens leaves every earlier position's output as it
    was; the entry point's device defaults to "cuda", as the UNet's."""
    _, _, port, ids = _models("tiny")
    other = ids.copy()
    other[:, -3:] = (other[:, -3:] + 1) % 1000
    with torch.no_grad():
        a = port(torch.tensor(ids).long())
        b = port(torch.tensor(other).long())
    assert torch.equal(a[:, :-3], b[:, :-3]) and not torch.equal(a[:, -3:], b[:, -3:])
    sig = inspect.signature(tclip.CLIPTextModel)
    assert sig.parameters["device"].default == "cuda"


def test_gelu_tanh_matches_jax():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = tclip.gelu_tanh(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
