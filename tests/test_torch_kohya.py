"""The port's kohya front end (``lycoris_tpu_torch/kohya.py``) against the
JAX package's (``lycoris_tpu/kohya.py``), on the tiny UNet and tiny CLIP text
encoders that both packages build from the same weights: the dual tree and
its ``lora_te``/``lora_te1``/``lora_te2``/``lora_unet`` names, counts and
tensor shapes; LoRA+ groups by names and lr; network_args string coercion;
``apply_to`` trimming (and which trees it patches); the kohya callbacks; the
``sshs_model_hash`` against ``precalculate_safetensors_hashes``; kohya files
saved by one package and loaded by the other, ``merge_to`` agreeing on
every tree (fp32, 1e-5). The tests of ``tests/test_kohya.py``, held to the
JAX package. Each other ``algo=`` (DyLoRA, GLoRA, Full, (IA)^3 with its
preset, Diag-OFT, BOFT) and LoRA with ``train_norm`` builds the JAX
network's adapters, trains a step on the UNet, and crosses files both ways
with ``merge_to`` agreeing on every tree.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors
import torch

import torch_parity as tp
from lycoris_tpu import ModelGraph
from lycoris_tpu import kohya as jk
from lycoris_tpu.models import clip as jclip
from lycoris_tpu.utils import precalculate_safetensors_hashes as jax_hashes
from lycoris_tpu_torch import kohya as tk
from lycoris_tpu_torch.models import clip as tclip
from lycoris_tpu_torch.models.unet import state_dict_from_jax
from lycoris_tpu_torch.utils import precalculate_safetensors_hashes
from lycoris_tpu_torch.utils import safetensors_io

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jk.LycorisNetworkKohya.reset_preset()
    tk.LycorisNetworkKohya.reset_preset()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run as fast on one intra-op thread, and the parallel
    test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_models():
    """The JAX tiny UNet's variables and graph, and two tiny CLIPs'
    variables and graphs (built once: the inits compile)."""
    _, uvars, ugraph, _ = tp.jax_unet()
    tes = []
    for i in range(2):
        te = jclip.CLIPTextModel(jclip.tiny_clip_config())
        ids = jnp.zeros((2, 8), jnp.int32)
        tvars = te.init(jax.random.fold_in(jax.random.key(0), i), ids)
        tes.append((tvars, ModelGraph.from_linen(te, tvars, ids)))
    return uvars, ugraph, tes


def _port_models(jax_models, n_te):
    """The port's tiny UNet and ``n_te`` tiny CLIPs on the CPU with the JAX
    models' weights."""
    uvars, _, tes = jax_models
    unet = tp.port_unet(uvars)
    ports = []
    for tvars, _ in tes[:n_te]:
        m = tclip.CLIPTextModel(tclip.tiny_clip_config(), device="cpu")
        m.load_state_dict(tclip.state_dict_from_jax(tvars["params"]))
        ports.append(m)
    return unet, ports


def _both(jax_models, n_te, **kw):
    """(JAX network, port network, port UNet, port CLIPs) from the same
    ``create_network`` arguments; one text encoder is passed bare, more as a
    list."""
    _, ugraph, tes = jax_models
    jtes = [g for _, g in tes[:n_te]]
    unet, ttes = _port_models(jax_models, n_te)
    jnet = jk.create_network(1.0, 4, 1.0, None, jtes[0] if n_te == 1 else jtes, ugraph,
                             rng=jax.random.key(0), **kw)
    jk.LycorisNetworkKohya.reset_preset()
    tnet = tk.create_network(1.0, 4, 1.0, None, ttes[0] if n_te == 1 else ttes, unet, **kw)
    tk.LycorisNetworkKohya.reset_preset()
    return jnet, tnet, unet, ttes


def _shapes(loras):
    return {(lyco.lora_name, k): tuple(np.shape(v)) for lyco in loras
            for k, v in lyco.params.items()}


def _assert_same_networks(jnet, tnet):
    for attr in ("unet_loras", "text_encoder_loras", "loras"):
        assert ({lyco.lora_name for lyco in getattr(tnet, attr)}
                == {lyco.lora_name for lyco in getattr(jnet, attr)}), attr
    assert _shapes(tnet.loras) == _shapes(jnet.loras)
    assert set(tnet.sub_networks) == set(jnet.sub_networks)
    for prefix, sub in tnet.sub_networks.items():
        assert ({lyco.lora_name for lyco in sub.loras}
                == {lyco.lora_name for lyco in jnet.sub_networks[prefix].loras}), prefix
    # the JAX create_network_from_weights leaves its table empty
    assert tnet.algo_table == dict(Counter(type(lyco).__name__ for lyco in jnet.loras))


def test_create_network_dual_tree(jax_models):
    jnet, tnet, _, _ = _both(jax_models, 1, algo="lokr", preset="attn-mlp", factor=4)
    _assert_same_networks(jnet, tnet)
    assert tnet.unet_loras and tnet.text_encoder_loras
    assert all(lyco.lora_name.startswith("lora_unet_") for lyco in tnet.unet_loras)
    assert all(lyco.lora_name.startswith("lora_te_") for lyco in tnet.text_encoder_loras)
    # tiny CLIP: 2 layers x (q, k, v, out, fc1, fc2)
    assert len(tnet.text_encoder_loras) == 12
    assert set(tnet.state_dict()) == set(jnet.state_dict())


def test_multi_te_prefixes(jax_models):
    """Two text encoders: ``lora_te1``/``lora_te2`` beside ``lora_unet``;
    each adapter module registered once (its tensors once in
    ``parameters()``, ``state_dict()`` and the module tree)."""
    jnet, tnet, _, _ = _both(jax_models, 2, algo="lora", preset="attn-mlp")
    _assert_same_networks(jnet, tnet)
    assert set(tnet.sub_networks) == {"lora_te1", "lora_te2", "lora_unet"}
    for prefix in ("lora_te1", "lora_te2"):
        names = [lyco.lora_name for lyco in tnet.sub_networks[prefix].loras]
        assert len(names) == 12 and all(n.startswith(prefix + "_") for n in names)
    assert "lora_te1_text_model_encoder_layers_0_self_attn_q_proj" in tnet.lora_map
    n_tensors = sum(len(list(lyco.parameters())) for lyco in tnet.loras)
    assert len(list(tnet.parameters())) == n_tensors
    assert len(dict(tnet.named_parameters(remove_duplicate=False))) == n_tensors
    assert sum(1 for m in tnet.modules() if m in set(tnet.loras)) == len(tnet.loras)
    assert len(tnet.state_dict()) == len(jnet.state_dict())


def test_loraplus_param_groups(jax_models):
    """The groups' members (by qualified name), lr and descriptions equal
    the JAX network's."""
    jnet, tnet, _, _ = _both(jax_models, 1, algo="lora", preset="attn-mlp",
                             loraplus_lr_ratio="4")
    for net in (jnet, tnet):
        net.apply_to(apply_text_encoder=True, apply_unet=True)
    jgroups, jdesc = jnet.prepare_optimizer_params(1e-5, 1e-4, 1e-4)
    groups, desc = tnet.prepare_optimizer_params(1e-5, 1e-4, 1e-4)
    assert desc == jdesc and len(groups) == 4
    for g, jg in zip(groups, jgroups):
        assert g["names"] == list(jg["params"]) and g["lr"] == pytest.approx(jg["lr"])
        quals = {f"{lyco.lora_name}.{k}": p for lyco in tnet.loras
                 for k, p in lyco.named_parameters()}
        assert all(p is quals[n] for n, p in zip(g["names"], g["params"]))
    plus = [g for g, d in zip(groups, desc) if "plus" in d]
    assert plus and all("lora_up" in n for g in plus for n in g["names"])
    unet_plus = [g for g, d in zip(groups, desc) if d == "unet plus"][0]
    assert unet_plus["lr"] == pytest.approx(4e-4)
    # the groups build a torch optimizer as they are
    torch.optim.AdamW(groups, lr=1e-4)


def test_string_network_args_coercion(jax_models):
    kw = dict(algo="lokr", preset="attn-mlp", use_tucker="True", full_matrix="False",
              factor="4", conv_dim="8", rs_lora="false", dropout="0", module_dropout="0")
    jnet, tnet, _, _ = _both(jax_models, 1, **kw)
    assert len(tnet.loras) > 0
    _assert_same_networks(jnet, tnet)


def test_apply_flags_trim(jax_models):
    """apply_to(text encoder off): the same trimmed lists as the JAX
    network's; only the UNet's targeted layers are patched."""
    jnet, tnet, unet, (te,) = _both(jax_models, 1, algo="lora", preset="attn-mlp")
    n_unet = len(tnet.unet_loras)
    for net in (jnet, tnet):
        net.apply_to(apply_text_encoder=False, apply_unet=True)
    assert tnet.text_encoder_loras == [] and len(tnet.loras) == n_unet == len(jnet.loras)
    assert set(tnet.lora_map) == set(jnet.lora_map)
    assert not any("forward" in m.__dict__ for m in te.modules())
    patched = {n for n, m in unet.named_modules() if "forward" in m.__dict__}
    assert patched == {tnet.node_map[ln].name for ln in tnet.lora_map}
    tnet.restore()
    assert not any("forward" in m.__dict__ for m in unet.modules())


def test_trainer_callback_surface(jax_models):
    """kohya's train_network.py calls these (reference kohya.py:733-747)."""
    _, tnet, _, _ = _both(jax_models, 1, algo="lora", preset="attn-mlp")
    assert tnet.enable_gradient_checkpointing() is None
    tnet.prepare_grad_etc()
    tnet.on_epoch_start()
    tnet.on_step_start()
    params = tnet.get_trainable_params()
    assert set(params) == {lyco.lora_name for lyco in tnet.loras}
    assert all(p.requires_grad for sub in params.values() for p in sub.values())


@pytest.mark.parametrize("dtype", ["float16", "float32"])
@pytest.mark.parametrize("metadata", [{}, {"ss_network_module": "lycoris.kohya"}])
def test_sshs_hash_matches_jax(dtype, metadata):
    """``precalculate_safetensors_hashes`` (model and legacy hash) equals the
    JAX package's on the same tensors, past 1 MiB so the legacy window
    holds data."""
    rng = np.random.default_rng(0)
    arrays = {f"lora_unet_x{i}.lora_down.weight": rng.standard_normal((64, 1200)).astype(dtype)
              for i in range(6)}
    arrays["lora_unet_x0.alpha"] = np.asarray(4.0, dtype)
    tensors = {k: torch.tensor(v) for k, v in arrays.items()}
    assert precalculate_safetensors_hashes(tensors, metadata) == jax_hashes(arrays, metadata)


def _fill(net_params, seed):
    """Move every trainable tensor of a JAX network off its init."""
    rng = np.random.default_rng(seed)
    for lyco in net_params:
        for k in sorted(lyco.params):
            if k in lyco.trainable:
                lyco.params[k] = lyco.params[k] + jnp.asarray(
                    rng.standard_normal(lyco.params[k].shape).astype(np.float32) * 0.05)


def _flat(tree) -> dict:
    """A JAX params tree as ``{dotted path: numpy array}``."""
    return {k: v.numpy() for k, v in state_dict_from_jax(tree).items()}


def _check_merges(jmerged: dict, tnet, unet, ttes):
    """Every tree's merged weights (JAX dict, port in place) agree."""
    models = {"lora_unet": unet, **{p: te for (p, _), te in zip(tnet.te_graphs_list, ttes)}}
    assert set(jmerged) == set(models)
    for prefix, model in models.items():
        want = _flat(jmerged[prefix])
        want = {k.removeprefix("params."): v for k, v in want.items()}
        got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        if "token_embedding.embedding" in want:
            want["token_embedding.weight"] = want.pop("token_embedding.embedding")
        assert set(got) == set(want), prefix
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{prefix} {k}", **TOL)


@pytest.mark.parametrize("algo", ["loha", "lokr"])
def test_kohya_file_from_jax_loads_in_port(jax_models, tmp_path, algo):
    """A file the JAX kohya network saves (two text encoders and the UNet):
    the port's ``create_network_from_weights`` builds the same adapters and
    its ``merge_to`` gives the JAX ``merge_to``'s weights on every tree."""
    _, ugraph, tes = jax_models
    jnet = jk.create_network(1.0, 4, 1.0, None, [g for _, g in tes], ugraph, algo=algo,
                             preset="attn-mlp", factor=4, rng=jax.random.key(1))
    _fill(jnet.loras, 1)
    f = str(tmp_path / "jax.safetensors")
    jnet.save_weights(f, metadata={"ss_network_module": "lycoris_tpu.kohya"})
    with safetensors.safe_open(f, framework="numpy") as sf:
        assert "sshs_model_hash" in sf.metadata()

    unet, ttes = _port_models(jax_models, 2)
    tnet, sd = tk.create_network_from_weights(1.0, f, None, ttes, unet)
    assert set(sd) == set(jnet.state_dict())
    _assert_same_networks(jnet, tnet)
    jnet2, _ = jk.create_network_from_weights(1.0, f, None, [g for _, g in tes], ugraph)
    tnet.merge_to()
    _check_merges(jnet2.merge_to(), tnet, unet, ttes)


@pytest.mark.parametrize("algo", ["loha", "lokr"])
def test_kohya_file_from_port_loads_in_jax(jax_models, tmp_path, algo):
    """A file the port's kohya network saves (fp32 and fp16) loads in the JAX
    ``create_network_from_weights``; each package's ``merge_to`` of it
    agrees on every tree, and the file's ``sshs_model_hash`` is the JAX
    hash of its tensors."""
    _, ugraph, tes = jax_models
    for dtype in (None, torch.float16):
        unet, ttes = _port_models(jax_models, 2)
        tnet = tk.create_network(1.0, 4, 1.0, None, ttes, unet, algo=algo, preset="attn-mlp",
                                 factor=4, seed=2)
        tk.LycorisNetworkKohya.reset_preset()
        gen = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for p in tnet.parameters():
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
        f = str(tmp_path / f"port_{dtype}.safetensors")
        tnet.save_weights(f, dtype=dtype, metadata={"note": "x"})
        header, _ = safetensors_io.read_header(f)
        meta = header["__metadata__"]
        arrays = {k: v.numpy() for k, v in safetensors_io.load_file(f).items()}
        assert meta["note"] == "x" and meta["sshs_model_hash"] == jax_hashes(arrays, {})[0]

        jnet, _ = jk.create_network_from_weights(1.0, f, None, [g for _, g in tes], ugraph)
        _assert_same_networks(jnet, tnet)
        tnet2, _ = tk.create_network_from_weights(1.0, f, None, ttes, unet)
        tnet2.merge_to()
        _check_merges(jnet.merge_to(), tnet2, unet, ttes)


def test_live_adapters_equal_merge_to(jax_models):
    """The port's network applied (each tree's forward with its adapters
    live, through ``apply_text_encoder``/``apply_unet``) equals the trees
    run plain after ``merge_to``, and the JAX network's live outputs."""
    uvars, ugraph, tes = jax_models
    jnet, tnet, unet, ttes = _both(jax_models, 2, algo="lokr", preset="attn-mlp", factor=4)
    _fill(jnet.loras, 3)
    tnet.load_state_dict({k: torch.tensor(np.array(v)) for k, v in jnet.state_dict().items()})
    tnet.apply_to(apply_text_encoder=True, apply_unet=True)
    ids = np.random.default_rng(4).integers(0, 1000, (2, 8))
    d = tp.jax_unet()[3]
    targs = [torch.tensor(d[k]) for k in ("lat", "t", "ctx")]
    with torch.no_grad():
        live = [tnet.apply_text_encoder(i, torch.tensor(ids)) for i in range(2)]
        live.append(tnet.apply_unet(*targs))
        tnet.merge_to()
        merged = [te(torch.tensor(ids)) for te in ttes] + [unet(*targs)]
    for a, b in zip(live, merged):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    te_model = jclip.CLIPTextModel(jclip.tiny_clip_config())
    for i, (tvars, _) in enumerate(tes):
        sub = jnet.sub_networks[f"lora_te{i + 1}"]
        want = sub(tvars, jnp.asarray(ids, jnp.int32), model=te_model)
        np.testing.assert_allclose(live[i].numpy(), np.asarray(want), **TOL)


OTHER_ALGOS = [("dylora", dict(block_size=2)), ("glora", {}), ("full", {}), ("ia3", {}),
               ("diag-oft", dict(constraint=1e-3, rescaled=True)), ("boft", {}),
               ("lora", dict(train_norm=True))]
OTHER_IDS = ["dylora", "glora", "full", "ia3", "diag-oft", "boft", "train_norm"]


@pytest.mark.parametrize("algo,kw", OTHER_ALGOS, ids=OTHER_IDS)
def test_create_network_other_algorithms(jax_models, tmp_path, algo, kw):
    """``create_network(algo=...)`` over two CLIPs and the UNet: the JAX
    network's adapters, module kinds and shapes; one trainer step of the
    UNet's sub-network (finite loss, every UNet adapter tensor moved); its
    file loads in the JAX package and a JAX file in the port (DyLoRA's as
    LoCon), ``merge_to`` agreeing on every tree."""
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    kw = {"preset": "attn-mlp", **kw}
    _, ugraph, tes = jax_models
    jtes = [g for _, g in tes]
    jnet, tnet, unet, ttes = _both(jax_models, 2, algo=algo, **kw)
    _assert_same_networks(jnet, tnet)
    kinds = {ly.lora_name: type(ly).__name__ for ly in tnet.loras}
    assert kinds == {ly.lora_name: type(ly).__name__ for ly in jnet.loras}
    if kw.get("train_norm"):
        assert "NormModule" in set(kinds.values())

    tnet.apply_to(apply_text_encoder=True, apply_unet=True)
    sub = tnet.sub_networks["lora_unet"]
    before = {(ly.lora_name, k): p.detach().clone() for ly in sub.loras
              for k, p in ly.named_parameters()}
    d = tp.jax_unet()[3]
    tr = DiffusionTrainer(unet, sub, lr=1e-3, weight_dtype=torch.float32)
    loss = tr.train_step({"latents": torch.tensor(d["lat"]), "context": torch.tensor(d["ctx"])})
    assert np.isfinite(float(loss))
    moved = [key for key, v in before.items()
             if not torch.equal(dict(tnet.lora_map[key[0]].named_parameters())[key[1]], v)]
    assert before and len(moved) == len(before)
    tnet.restore()

    for saver in ("port", "jax"):
        unet, ttes = _port_models(jax_models, 2)
        f = str(tmp_path / f"{saver}.safetensors")
        if saver == "jax":
            _fill(jnet.loras, 5)
            jnet.save_weights(f)
        else:
            tnet.save_weights(f)
        jnet2, _ = jk.create_network_from_weights(1.0, f, None, jtes, ugraph)
        tnet2, _ = tk.create_network_from_weights(1.0, f, None, ttes, unet)
        _assert_same_networks(jnet2, tnet2)
        if algo == "dylora":
            assert {type(ly).__name__ for ly in tnet2.loras} == {"LoConModule"}
        tnet2.merge_to()
        _check_merges(jnet2.merge_to(), tnet2, unet, ttes)
