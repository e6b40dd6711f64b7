"""The port's Flux-style DiT (``lycoris_tpu_torch/models/dit.py``) against the
JAX package's (``lycoris_tpu/models/dit.py``), on the CPU in fp32: the same
weights (seeded numpy values in the tree of the JAX init, norm weights off 1)
carried over by ``state_dict_from_jax``, the same numpy inputs. Outputs
agree within 2e-5 of the largest magnitude, bare (qk-norm on and off), with
live LoKr and LoHa adapters whose factors are seeded nonzero, from a
JAX-saved adapter file, and at T = 512 + 512 tokens, where the port's
attention takes the flash route (its plain version on the CPU). The three
preset cases of ``tests/test_dit.py`` and ``train_norm`` give the same
``lora_name``s and module kinds in both packages, and ``chip_smoke``'s DiT
census (10 adapted layers a double block, 3 a single block, their shapes)
matches the JAX network's layers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.models import dit as jdit
from lycoris_tpu_torch.models import dit as tdit
from lycoris_tpu_torch.ops import flash as tflash

REL = 2e-5
BLOCKS = {"target_module": ["DoubleStreamBlock", "SingleStreamBlock"]}
PRESET_CASES = {
    "blocks": (BLOCKS, dict(algo="lokr", factor=4)),
    "fnmatch_exclude": ({"target_module": [], "target_name": ["single_blocks_*"],
                         "use_fnmatch": True, "exclude_name": ["single_blocks_1*"]},
                        dict(algo="lora")),
    "module_algo_map": ({**BLOCKS, "module_algo_map": {
        "SingleStreamBlock": {"algo": "loha", "dim": 8}}}, dict(algo="lokr", factor=4)),
}


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _configs(qk_norm=True):
    return (dataclasses.replace(jdit.tiny_dit_config(), qk_norm=qk_norm),
            dataclasses.replace(tdit.tiny_dit_config(), qk_norm=qk_norm))


def _data(txt=4, img=16, seed=0):
    """Numpy (img, txt, t) at batch 2 for the tiny config."""
    jcfg, _ = _configs()
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, img, jcfg.in_channels)).astype(np.float32),
            rng.standard_normal((2, txt, jcfg.context_dim)).astype(np.float32),
            rng.integers(0, 1000, 2).astype(np.int32))


@functools.lru_cache(maxsize=2)
def _jax(qk_norm=True):
    """The JAX tiny DiT, seeded numpy params in the tree its init would make
    (found by ``jax.eval_shape``, with no init to compile): linear weights
    N(0, 1/fan_in), biases N(0, 0.05^2), norm weights 1 + N(0, 0.05^2); its
    graph and inputs."""
    jcfg, _ = _configs(qk_norm)
    data = _data()
    model = jdit.FluxTransformer2D(jcfg)
    args = tuple(jnp.asarray(a) for a in data)
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)["params"]
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 2:
            return jnp.asarray(z / np.sqrt(leaf.shape[1]))
        if path[-1].key == "bias":
            return jnp.asarray(z * 0.05)
        return jnp.asarray(1 + z * 0.05)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, params, jl.ModelGraph.from_linen(model, {"params": params}, *args), data


def _port(params, qk_norm=True):
    port = tdit.FluxTransformer2D(_configs(qk_norm)[1], device="cpu")
    port.load_state_dict(tdit.state_dict_from_jax(params))
    return port


def _run_port(port, data):
    with torch.no_grad():
        return port(torch.tensor(data[0]), torch.tensor(data[1]),
                    torch.tensor(data[2]).long()).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * np.abs(want).max())


def _jax_net(graph, seed=1, preset=BLOCKS, **kw):
    """A JAX network under ``preset`` (dim 4, alpha 2), every trainable tensor
    moved by seeded noise (std 0.05), so no delta is zero."""
    jl.LycorisNetwork.apply_preset(preset)
    try:
        net = jl.create_lycoris(graph, 1.0, 4, 2.0, rng=jax.random.key(seed), **kw)
    finally:
        jl.LycorisNetwork.reset_preset()
    rng = np.random.default_rng(seed)
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                noise = rng.standard_normal(p[k].shape).astype(np.float32) * 0.05
                p[k] = jnp.asarray(np.asarray(p[k]) + noise)
    net.set_params_tree(tree)
    return net


def _jax_out(model, params, data, net=None):
    """The JAX model's output on ``data``, bare or with ``net`` live (merged
    forward), jitted: one compile per case instead of one per primitive."""
    args = tuple(jnp.asarray(a) for a in data)
    if net is None:
        return np.asarray(jax.jit(model.apply)({"params": params}, *args))
    return np.asarray(jax.jit(lambda p, *a: net({"params": p}, *a, model=model,
                                                merged_forward=True))(params, *args))


@pytest.mark.parametrize("qk_norm", [True, False])
def test_dit_matches_jax(qk_norm):
    model, params, _, data = _jax(qk_norm)
    port = _port(params, qk_norm)
    assert set(port.state_dict()) == set(tdit.state_dict_from_jax(params))
    want = _jax_out(model, params, data)
    got = _run_port(port, data)
    assert got.shape == want.shape == (2, 16, 8)
    _close(got, want)


@functools.lru_cache(maxsize=2)
def _adapted(algo):
    """A JAX network of ``algo`` (LoKr factor 4, or LoHa) on the block
    targets, and the JAX model's output with it live."""
    model, params, graph, data = _jax()
    net = _jax_net(graph, algo=algo, factor=4)
    return net, _jax_out(model, params, data, net)


@pytest.mark.parametrize("algo", ["lokr", "loha"])
def test_dit_live_adapters_match_jax(algo):
    """LoKr (factor 4) and LoHa on the block targets, loaded into the port
    from the JAX network's state dict, live (merged forward) in both."""
    _, params, _, data = _jax()
    net, want = _adapted(algo)
    assert len(net.loras) == 26
    port = _port(params)
    sd = {k: torch.tensor(np.array(v)) for k, v in net.state_dict().items()}
    tnet, _ = tl.create_lycoris_from_weights(1.0, None, port, weights_sd=sd, device="cpu")
    assert {m.lora_name for m in tnet.loras} == {m.lora_name for m in net.loras}
    bare = _run_port(port, data)
    tnet.apply_to(merged_forward=True)
    got = _run_port(port, data)
    tnet.restore()
    assert np.linalg.norm(want - bare) > 1e-3 * np.linalg.norm(want)  # the adapters act
    _close(got, want)


@pytest.mark.parametrize("case", list(PRESET_CASES))
def test_dit_presets_match_jax(case):
    """``tests/test_dit.py``'s three preset cases: the same ``lora_name``s and
    module kinds (and the mapped LoHa's dim) in both packages."""
    preset, kw = PRESET_CASES[case]
    _, params, graph, _ = _jax()
    jl.LycorisNetwork.apply_preset(preset)
    jnet = jl.create_lycoris(graph, 1.0, 4, 1.0, rng=jax.random.key(0), **kw)
    tl.LycorisNetwork.apply_preset(preset)
    tnet = tl.create_lycoris(_port(params), 1.0, 4, 1.0, **kw)
    kinds = {m.lora_name: (type(m).__name__, m.lora_dim) for m in tnet.loras}
    assert kinds == {m.lora_name: (type(m).__name__, m.lora_dim) for m in jnet.loras}
    assert kinds
    if case == "blocks":
        assert {"lycoris_double_blocks_0_img_attn_qkv", "lycoris_double_blocks_1_txt_mlp_2",
                "lycoris_single_blocks_0_linear1", "lycoris_single_blocks_1_linear2",
                "lycoris_double_blocks_0_img_mod_lin"} <= set(kinds)
        assert not any("img_in" in n or "final_proj" in n for n in kinds)
    if case == "fnmatch_exclude":
        assert all(n.startswith("lycoris_single_blocks_0") for n in kinds)
    if case == "module_algo_map":
        assert kinds["lycoris_single_blocks_0_linear1"] == ("LohaModule", 8)
        assert kinds["lycoris_double_blocks_0_img_attn_qkv"][0] == "LokrModule"


def test_dit_train_norm_adapts_qk_norms():
    """``train_norm`` on the block targets adds Norm modules on the
    LayerNorms and on the qk RMSNorms (``norm.query_norm``/``norm.key_norm``),
    the same set in both packages; the port sees the RMSNorm as one."""
    _, params, graph, _ = _jax()
    jl.LycorisNetwork.apply_preset(BLOCKS)
    jnet = jl.create_lycoris(graph, 1.0, 4, 1.0, algo="lora", train_norm=True,
                             rng=jax.random.key(0))
    tl.LycorisNetwork.apply_preset(BLOCKS)
    port = _port(params)
    tnet = tl.create_lycoris(port, 1.0, 4, 1.0, algo="lora", train_norm=True)
    kinds = {m.lora_name: type(m).__name__ for m in tnet.loras}
    assert kinds == {m.lora_name: type(m).__name__ for m in jnet.loras}
    for name in ("lycoris_double_blocks_0_img_attn_norm_query_norm",
                 "lycoris_double_blocks_1_txt_attn_norm_key_norm",
                 "lycoris_single_blocks_0_norm_query_norm", "lycoris_single_blocks_1_pre_norm"):
        assert kinds[name] == "NormModule", name
    node = tnet.node_map["lycoris_single_blocks_0_norm_key_norm"]
    assert node.layer_info.module_type == "rmsnorm"


@pytest.mark.parametrize("algo", ["lokr", "loha"])
def test_dit_jax_file_loads_in_port(tmp_path, algo):
    """A DiT adapter file saved by the JAX network loads into the port (the
    port's own reader) and gives the JAX live output."""
    _, params, _, data = _jax()
    net, want = _adapted(algo)
    path = str(tmp_path / f"dit_{algo}.safetensors")
    net.save_weights(path)
    port = _port(params)
    tnet, _ = tl.create_lycoris_from_weights(1.0, path, port)
    assert len(tnet.loras) == len(net.loras) == 26
    tnet.apply_to(merged_forward=True)
    _close(_run_port(port, data), want)


def test_dit_census_matches_jax_names():
    """The census ``chip_smoke`` holds the Flux run's launches to: 10 adapted
    layers a double block and 3 a single one, the adapted shapes (O, I)
    those of the JAX network's layers at the tiny config, and at Flux's
    config 304 layers, 57 flash and 115 LayerNorm launches a call."""
    _, params, graph, _ = _jax()
    net = _jax_net(graph, algo="lora")
    by_block = {}
    for m in net.loras:
        block = m.lora_name.split("_")[1] + "_" + m.lora_name.split("_")[3]
        by_block[block] = by_block.get(block, 0) + 1
    census = chip_smoke.dit_census(tdit.tiny_dit_config(), 2, 4, 16)
    assert census["per_block"] == (10, 3)
    assert by_block == {"double_0": 10, "double_1": 10, "single_0": 3, "single_1": 3}
    shapes = {}
    for m in net.loras:
        shapes[tuple(m.shape[:2])] = shapes.get(tuple(m.shape[:2]), 0) + 1
    assert dict(census["hada"]) == shapes
    assert census["adapted"] == len(net.loras) == 26
    flux = chip_smoke.dit_census(tdit.flux_config(), 1, chip_smoke.FLUX_TXT,
                                 chip_smoke.FLUX_IMG)
    assert flux["adapted"] == chip_smoke.DIT_ADAPTED == 304
    assert {"flash_fwd": sum(flux["flash"].values()),
            "layer_norm_fwd": sum(flux["ln"].values())} == chip_smoke.DIT_CALL
    assert dict(flux["flash"]) == {(24, 4608, 128): 57}


def test_dit_flash_route_matches_jax(monkeypatch):
    """Hidden 32, 2 heads, 512 text + 512 image tokens (T = 1024): every
    joint attention takes the port's flash route (its plain version on the
    CPU) and the output still matches JAX, whose CPU path is XLA's."""
    model, params, _, _ = _jax()
    data = _data(txt=512, img=512)
    calls = []
    plain = tflash.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention", counted)
    got = _run_port(_port(params), data)
    assert calls == [(2, 2, 1024, 16)] * 4
    _close(got, _jax_out(model, params, data))


def test_flux_config_matches_jax():
    jcfg, tcfg = jdit.flux_config(), tdit.flux_config()
    for f in dataclasses.fields(jdit.DiTConfig):
        if f.name == "dtype":
            assert str(tcfg.dtype).replace("torch.", "") == jnp.dtype(jcfg.dtype).name
        else:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.hidden_size, tcfg.num_heads, tcfg.depth_double, tcfg.depth_single,
            tcfg.in_channels, tcfg.context_dim) == (3072, 24, 19, 38, 64, 4096)
    assert {f.name for f in dataclasses.fields(tdit.DiTConfig)} == {
        f.name for f in dataclasses.fields(jdit.DiTConfig)}
