"""The port's tools against the JAX package's on the CPU: ``make_sparse``,
``extract_linear``/``extract_conv`` in every rank mode (the fall back to
"full", the CP pass), ``extract_diff`` over state-dict graphs and torch
modules (sparse bias, ``small_conv``, full mode with norms and an
embedding, two text encoders), ``merge`` of LoCon, LoHa and LoKr files and
of a two-encoder file with diffusers UNet keys, the compvis key remap, the
bundle helpers and both HCP directions with ``BaseConverter``.

SVD factors are defined up to sign and order, so products are compared
(``up @ down``, with ``lora_mid`` rebuilt), never the factors; the test
spectra have clear gaps, so every rank mode picks one rank in LAPACK's and
torch's SVD alike. The extract's fp16 outputs are held to fp16 rounding.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu.utils import bundle as jbundle
from lycoris_tpu.utils import extract as jx
from lycoris_tpu.utils import hcp_convert as jhcp
from lycoris_tpu.utils import merge as jm
from lycoris_tpu_torch.graph import ModelGraph as TG
from lycoris_tpu_torch.utils import bundle as tbundle
from lycoris_tpu_torch.utils import extract as tx
from lycoris_tpu_torch.utils import hcp_convert as thcp
from lycoris_tpu_torch.utils import merge as tm

TOL = dict(atol=1e-5, rtol=1e-5)
F16 = dict(atol=2e-3, rtol=2e-3)  # fp16 outputs: a few roundings of 2**-11


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def gapped(out_dim, in_dim, spectrum, seed):
    """A (out, in) fp32 matrix with singular values ``spectrum`` (then 0)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((out_dim, out_dim)))
    v, _ = np.linalg.qr(rng.standard_normal((in_dim, in_dim)))
    s = np.zeros(min(out_dim, in_dim))
    s[: len(spectrum)] = spectrum
    return (u[:, : len(s)] * s) @ v[: len(s)].astype(np.float64)


SPECTRUM = [8.0, 6.0, 4.5, 3.0, 2.0, 1.2, 0.6, 0.3, 0.1, 0.02]
# each mode's parameter sits between two singular values or partial sums
MODES = [("fixed", 4), ("fixed", 40), ("threshold", 1.0), ("ratio", 0.2), ("quantile", 0.7),
         ("percentile", 0.9), ("full", 0)]


def np_f32(a):
    return np.asarray(a, np.float32)


def check_low_rank(j_out, j_mode, t_out, t_mode, conv=False):
    assert j_mode == t_mode
    if j_mode == "full":
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
        return
    (ja, jb, jd), (ta, tb, td) = j_out, t_out
    assert tuple(ja.shape) == tuple(ta.shape) and tuple(jb.shape) == tuple(tb.shape)
    j_prod = np.asarray(jb).reshape(jb.shape[0], -1) @ np.asarray(ja).reshape(ja.shape[0], -1)
    t_prod = (tb.reshape(tb.shape[0], -1) @ ta.reshape(ta.shape[0], -1)).numpy()
    np.testing.assert_allclose(t_prod, j_prod, **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


@pytest.mark.parametrize("mode,param", MODES)
def test_extract_linear_modes(mode, param):
    w = np_f32(gapped(64, 48, SPECTRUM, 0))
    j = jx.extract_linear(jnp.asarray(w), mode, param)
    t = tx.extract_linear(torch.tensor(w), mode, param)
    check_low_rank(*j, *t)
    if mode == "fixed" and param == 40:
        assert t[1] == "full"  # rank 40 >= 64 / 2: the fall back to full


@pytest.mark.parametrize("mode,param", MODES)
@pytest.mark.parametrize("is_cp", [False, True])
def test_extract_conv_modes(mode, param, is_cp):
    w = np_f32(gapped(32, 16 * 9, SPECTRUM, 1)).reshape(32, 16, 3, 3)
    j = jx.extract_conv(jnp.asarray(w), mode, param, is_cp=is_cp)
    t = tx.extract_conv(torch.tensor(w), mode, param, is_cp=is_cp)
    check_low_rank(*j, *t, conv=True)
    if mode == "fixed" and param == 40:
        assert t[1] == ("low rank" if is_cp else "full")


@pytest.mark.parametrize("sparsity", [0.5, 0.95, 0.98])
@pytest.mark.parametrize("shape", [(64, 32), (7, 1000), (1, 3)])
def test_make_sparse(sparsity, shape):
    rng = np.random.default_rng(3)
    t = np_f32(rng.standard_normal(shape))
    want = jx.make_sparse(t.copy(), sparsity)
    got = tx.make_sparse(torch.tensor(t), sparsity)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# extract_diff
# ---------------------------------------------------------------------------


def checkpoints(seed=0):
    """(base, tuned) numpy state dicts: a rank-4 linear delta, a full-rank
    one, a rank-4 3x3 conv delta, a full-rank 1x1 conv delta, a LayerNorm
    moved, and an untouched linear."""
    rng = np.random.default_rng(seed)
    base = {
        "a.fc.weight": rng.normal(size=(64, 32)), "a.fc.bias": rng.normal(size=(64,)),
        "a.full.weight": rng.normal(size=(48, 40)),
        "a.conv.weight": rng.normal(size=(32, 16, 3, 3)), "a.conv.bias": rng.normal(size=(32,)),
        "a.pw.weight": rng.normal(size=(32, 32, 1, 1)),
        "a.norm.weight": rng.normal(size=(64,)), "a.norm.bias": rng.normal(size=(64,)),
        "b.same.weight": rng.normal(size=(16, 16)),
    }
    base = {k: np_f32(v) for k, v in base.items()}
    db = {k: v.copy() for k, v in base.items()}
    db["a.fc.weight"] += np_f32(rng.normal(size=(64, 4)) @ rng.normal(size=(4, 32)) * 0.02)
    db["a.full.weight"] += np_f32(gapped(48, 40, [0.5, 0.4, 0.3, 0.2, 0.1, 0.05, 0.02, 0.01], 5))
    db["a.conv.weight"] += np_f32(rng.normal(size=(32, 4)) @ rng.normal(size=(4, 144)) * 0.02
                                  ).reshape(32, 16, 3, 3)
    db["a.pw.weight"] += np_f32(rng.normal(size=(32, 32)) * 0.02).reshape(32, 32, 1, 1)
    db["a.norm.weight"] += 0.05
    db["a.norm.bias"] += 0.01
    db["a.fc.bias"] += 0.03
    return base, db


def as_torch(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


def rebuild(sd, name):
    """A low-rank module's dW (O, I*k) from its fp32-cast fp16 factors."""
    get = lambda k: np.asarray(sd[f"{name}.{k}"], np.float32)  # noqa: E731
    up, down = get("lora_up.weight"), get("lora_down.weight")
    if f"{name}.lora_mid.weight" in sd:
        mid = get("lora_mid.weight")
        w = np.einsum("ijkl,jr,pi->prkl", mid, down.reshape(down.shape[0], -1),
                      up.reshape(up.shape[0], -1))
        return w.reshape(w.shape[0], -1)
    return up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)


def sparse_dense(sd, name):
    size = tuple(int(s) for s in np.asarray(sd[f"{name}.bias_size"]))
    out = np.zeros(size, np.float32)
    idx = np.asarray(sd[f"{name}.bias_indices"]).astype(np.int64)
    out[idx[0], idx[1]] = np.asarray(sd[f"{name}.bias_values"], np.float32)
    return out


def compare_extracts(j_sd, t_sd, exact_sparse=()):
    """Same keys and dtypes, alphas equal, everything else within fp16
    rounding. The sparse residual is compared dense: where the delta's rank
    is at most the extract's, the residual is rounding noise and the two
    SVDs keep different noise; the modules of ``exact_sparse`` (a residual
    that is not noise) must keep the same elements."""
    t_sd = {k: v.numpy() for k, v in t_sd.items()}
    assert set(j_sd) == set(t_sd), sorted(set(j_sd) ^ set(t_sd))
    for k, v in t_sd.items():
        assert v.dtype == np.asarray(j_sd[k]).dtype, k
        if ".bias_" not in k or k.split(".", 1)[0] in exact_sparse:
            assert v.shape == np.asarray(j_sd[k]).shape, k
    for name in exact_sparse:
        np.testing.assert_array_equal(t_sd[f"{name}.bias_indices"], j_sd[f"{name}.bias_indices"])
    names = {k.split(".", 1)[0] for k in j_sd if k.endswith(".lora_down.weight")}
    for k in j_sd:
        name, key = k.split(".", 1)
        if key == "alpha":
            np.testing.assert_array_equal(t_sd[k], np.asarray(j_sd[k]))
        elif key in ("diff", "diff_b", "w_norm", "b_norm"):
            np.testing.assert_allclose(t_sd[k].astype(np.float32),
                                       np.asarray(j_sd[k], np.float32), **F16)
        elif key == "bias_indices":
            np.testing.assert_allclose(sparse_dense(t_sd, name), sparse_dense(j_sd, name), **F16)
    for name in names:
        np.testing.assert_allclose(rebuild(t_sd, name), rebuild(j_sd, name), **F16)
    return names


@pytest.mark.parametrize("use_bias,small_conv", [(False, False), (False, True), (True, False),
                                                 (True, True)])
def test_extract_diff_state_dicts(use_bias, small_conv):
    base, db = checkpoints()
    kw = dict(mode="fixed", linear_mode_param=4, conv_mode_param=4, use_bias=use_bias,
              sparsity=0.9, small_conv=small_conv)
    j_sd = jx.extract_diff([], [], jl.ModelGraph.from_state_dict(base),
                           jl.ModelGraph.from_state_dict(db), **kw)
    t_sd = tx.extract_diff([], [], TG.from_state_dict(as_torch(base)),
                           TG.from_state_dict(as_torch(db)), extract_device="cpu", **kw)
    names = compare_extracts(j_sd, t_sd, ("lora_unet_a_full", "lora_unet_a_pw") if use_bias else ())
    assert names == {"lora_unet_a_fc", "lora_unet_a_full", "lora_unet_a_conv", "lora_unet_a_pw"}
    assert ("lora_unet_a_conv.lora_mid.weight" in t_sd) == small_conv
    assert ("lora_unet_a_full.bias_indices" in t_sd) == use_bias
    # rank <= dim: the rebuilt delta is the true one to fp16 rounding
    np.testing.assert_allclose(rebuild({k: v.numpy() for k, v in t_sd.items()}, "lora_unet_a_fc"),
                               db["a.fc.weight"] - base["a.fc.weight"], **F16)


@pytest.mark.parametrize("mode,linear_param,conv_param", [("threshold", 0.15, 0.15),
                                                          ("ratio", 0.3, 0.3),
                                                          ("quantile", 0.6, 0.6), ("full", 0, 0)])
def test_extract_diff_modes(mode, linear_param, conv_param):
    base, db = checkpoints(seed=1)
    kw = dict(mode=mode, linear_mode_param=linear_param, conv_mode_param=conv_param)
    j_sd = jx.extract_diff([], [], jl.ModelGraph.from_state_dict(base),
                           jl.ModelGraph.from_state_dict(db), **kw)
    t_sd = tx.extract_diff([], [], TG.from_state_dict(as_torch(base)),
                           TG.from_state_dict(as_torch(db)), extract_device="cpu", **kw)
    compare_extracts(j_sd, t_sd)
    if mode == "full":
        assert {"lora_unet_a_norm.w_norm", "lora_unet_a_norm.b_norm",
                "lora_unet_a_fc.diff_b"} <= set(t_sd)


class Encoder(nn.Module):
    def __init__(self, vocab=50, dim=32):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, dim)
        self.q_proj = nn.Linear(dim, dim)
        self.ln = nn.LayerNorm(dim)


class Unet(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(32, 64)
        self.conv = nn.Conv2d(8, 16, 3, padding=1)
        self.norm = nn.GroupNorm(4, 16)


def tuned(module, seed):
    rng = np.random.default_rng(seed)
    out = type(module)()
    out.load_state_dict(module.state_dict())
    with torch.no_grad():
        for p in out.parameters():
            p.add_(torch.tensor(np_f32(rng.normal(size=tuple(p.shape)) * 0.02)))
    return out


@pytest.mark.parametrize("mode", ["fixed", "full"])
@pytest.mark.parametrize("n_te", [1, 2])
def test_extract_diff_modules(mode, n_te):
    """Torch modules in both packages (the JAX one through
    ``ModelGraph.from_torch``): the text-encoder prefixes, and in full mode
    the embedding and the norms."""
    torch.manual_seed(0)
    tes = [Encoder() for _ in range(n_te)]
    unet = Unet()
    tes_db = [tuned(t, 10 + i) for i, t in enumerate(tes)]
    unet_db = tuned(unet, 20)
    kw = dict(mode=mode, linear_mode_param=4, conv_mode_param=4)
    j_sd = jx.extract_diff(tes, tes_db, unet, unet_db, **kw)
    t_sd = tx.extract_diff(tes, tes_db, unet, unet_db, extract_device="cpu", **kw)
    compare_extracts(j_sd, t_sd)
    prefix = "lora_te1" if n_te == 2 else "lora_te"
    assert f"{prefix}_q_proj.alpha" in t_sd or f"{prefix}_q_proj.diff" in t_sd
    if mode == "full":
        assert f"{prefix}_token_embedding.diff" in t_sd and "lora_unet_norm.w_norm" in t_sd


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(32, 64)
        self.fc2 = nn.Linear(64, 32, bias=False)
        self.conv = nn.Conv2d(16, 32, 3, 1, 1)
        self.pw = nn.Conv2d(32, 32, 1)


def adapter_sd(model, algo, seed, prefix="lora_unet"):
    """The port's network over ``model`` (every Linear and Conv2d, factors
    moved off zero) as a state dict under ``prefix``."""
    tl.LycorisNetwork.apply_preset({"target_module": ["Linear", "Conv2d"]})
    net = tl.create_lycoris(model, 1.0, linear_dim=4, linear_alpha=2.0, conv_dim=4,
                            conv_alpha=2.0, algo=algo, factor=4, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return {k.replace("lycoris_", f"{prefix}_", 1): v.detach().clone()
            for k, v in net.state_dict().items()}


@pytest.mark.parametrize("algo", ["locon", "loha", "lokr"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_merge_state_dict(algo, scale):
    torch.manual_seed(0)
    model = Tiny()
    base = {k: v.detach().clone() for k, v in model.state_dict().items()}
    lyco = adapter_sd(model, algo, seed=3)
    j_trees, j_count = jm.merge([], jl.ModelGraph.from_state_dict(
        {k: v.numpy() for k, v in base.items()}), {k: v.numpy() for k, v in lyco.items()},
        scale=scale)
    t_trees, t_count = tm.merge([], TG.from_state_dict(base), lyco, scale=scale, device="cpu")
    assert j_count == t_count == 4
    j, t = j_trees["lora_unet"], t_trees["lora_unet"]
    assert set(t) == {"fc1", "fc2", "conv", "pw"}
    for name, sub in t.items():
        for key, v in sub.items():
            assert v.dtype == base[f"{name}.{key}"].dtype
            np.testing.assert_allclose(v.numpy(), np.asarray(j[name][key]), **TOL)
    for name in set(j) - set(t):  # the JAX tree's other layers are the base's
        np.testing.assert_array_equal(np.asarray(j[name]["weight"]), base[f"{name}.weight"])
    # the graph's own tensors are left as they were
    for k, v in base.items():
        assert torch.equal(v, model.state_dict()[k])


def test_merge_module_fp16_base():
    """An ``nn.Module`` graph in fp16: the merge runs in fp32 and casts back."""
    torch.manual_seed(1)
    model = Tiny()
    lyco = adapter_sd(model, "loha", seed=4)
    half = Tiny().half()
    half.load_state_dict({k: v.half() for k, v in model.state_dict().items()})
    j_trees, _ = jm.merge([], half, {k: v.numpy() for k, v in lyco.items()})
    t_trees, count = tm.merge(None, half, lyco, device="cpu")
    assert count == 4
    for name, sub in t_trees["lora_unet"].items():
        assert sub["weight"].dtype == torch.float16
        np.testing.assert_array_equal(sub["weight"].numpy(),
                                      np.asarray(j_trees["lora_unet"][name]["weight"]))


def test_merge_two_encoders_sdxl_keys():
    """Two text encoders: ``lora_te1``/``lora_te2`` and the UNet's diffusers
    keys converted to SGM names (only with more than one encoder)."""
    torch.manual_seed(2)
    te1, te2 = Encoder(dim=32), Encoder(dim=48)
    unet_sd = {"input_blocks.1.1.proj_in.weight": torch.randn(32, 32),
               "input_blocks.1.1.proj_in.bias": torch.randn(32),
               "middle_block.1.proj_out.weight": torch.randn(32, 32),
               "output_blocks.2.0.in_layers.2.weight": torch.randn(16, 8, 3, 3)}
    rng = np.random.default_rng(5)

    def lora(name, out_dim, in_dim, k=()):
        return {f"{name}.lora_down.weight": torch.tensor(np_f32(rng.normal(size=(4, in_dim, *k)))),
                f"{name}.lora_up.weight": torch.tensor(np_f32(rng.normal(size=(out_dim, 4,
                                                                               *[1] * len(k))))),
                f"{name}.alpha": torch.tensor(2.0)}

    lyco = {**lora("lora_te1_q_proj", 32, 32), **lora("lora_te2_q_proj", 48, 48),
            **lora("lora_unet_down_blocks_0_attentions_0_proj_in", 32, 32),
            **lora("lora_unet_mid_block_attentions_0_proj_out", 32, 32),
            **lora("lora_unet_up_blocks_0_resnets_2_conv1", 16, 8, (3, 3)),
            **lora("lora_unet_not_a_layer", 4, 4)}
    np_sd = {k: v.numpy() for k, v in lyco.items()}
    j_trees, j_count = jm.merge([te1, te2], jl.ModelGraph.from_state_dict(
        {k: v.numpy() for k, v in unet_sd.items()}), np_sd)
    t_trees, t_count = tm.merge([te1, te2], TG.from_state_dict(unet_sd), lyco, device="cpu")
    assert j_count == t_count == 5
    assert set(t_trees) == {"lora_te1", "lora_te2", "lora_unet"}
    assert set(t_trees["lora_unet"]) == {"input_blocks.1.1.proj_in", "middle_block.1.proj_out",
                                         "output_blocks.2.0.in_layers.2"}
    for tree, sub in t_trees.items():
        for name, ws in sub.items():
            for key, v in ws.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(j_trees[tree][name][key]), **TOL)


KOHYA_NAMES = [
    "lora_unet_conv_in", "lora_unet_conv_out", "lora_unet_time_embedding_linear_1",
    "lora_unet_time_embedding_linear_2", "lora_unet_down_blocks_0_attentions_1_proj_in",
    "lora_unet_down_blocks_2_resnets_1_conv2", "lora_unet_down_blocks_1_resnets_0_conv_shortcut",
    "lora_unet_mid_block_attentions_0_proj_out", "lora_unet_mid_block_resnets_1_conv1",
    "lora_unet_mid_block_resnets_0_time_emb_proj",
    "lora_unet_up_blocks_3_attentions_0_transformer_blocks_0_attn1_to_q",
    "lora_unet_up_blocks_1_resnets_2_time_emb_proj", "lora_unet_up_blocks_2_resnets_0_norm1",
    "lora_unet_down_blocks_1_downsamplers_0_conv", "lora_unet_up_blocks_2_upsamplers_0_conv",
    # SDXL: ten transformer blocks per attention, three down levels
    "lora_unet_down_blocks_2_attentions_1_transformer_blocks_9_ff_net_0_proj",
    "lora_unet_up_blocks_0_attentions_2_transformer_blocks_7_attn2_to_k",
    "lora_unet_mid_block_attentions_0_transformer_blocks_3_attn1_to_out_0",
    "lora_unet_input_blocks_4_1_proj_in", "lora_te_text_model_encoder_layers_0_self_attn_q_proj",
    "lora_te2_text_model_encoder_layers_31_mlp_fc1",
]


@pytest.mark.parametrize("key", KOHYA_NAMES)
def test_convert_diffusers_name_to_compvis(key):
    assert tm.convert_diffusers_name_to_compvis(key) == jm.convert_diffusers_name_to_compvis(key)


# ---------------------------------------------------------------------------
# bundle and HCP
# ---------------------------------------------------------------------------


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def assert_trees_equal(got, want):
    got = to_np(got)
    assert set(got) == set(want)
    for k, v in got.items():
        if isinstance(v, dict):
            assert_trees_equal(v, want[k])
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, np.asarray(want[k]))
        else:
            assert v == want[k]


@pytest.mark.parametrize("emb_format", [".pt", ".safetensors"])
def test_bundle(emb_format):
    rng = np.random.default_rng(6)
    lora = {"lora_unet_fc.lora_down.weight": np_f32(rng.normal(size=(4, 8))),
            "lora_unet_fc.alpha": np_f32(4.0)}
    embs = {"cat": {"emb_params": np_f32(rng.normal(size=(2, 8)))},
            "dog": {"string_to_param": {"*": np_f32(rng.normal(size=(3, 8)))}}}
    t_lora = {k: torch.tensor(v) for k, v in lora.items()}
    t_embs = {"cat": {"emb_params": torch.tensor(embs["cat"]["emb_params"])},
              "dog": {"string_to_param": {"*": torch.tensor(embs["dog"]["string_to_param"]["*"])}}}
    j_packed = jbundle.pack_bundle(dict(lora), embs)
    t_packed = tbundle.pack_bundle(dict(t_lora), t_embs)
    assert_trees_equal(t_packed, j_packed)
    j_lora, j_embs = jbundle.unpack_bundle(j_packed, step=12, emb_format=emb_format)
    t_lora2, t_embs2 = tbundle.unpack_bundle(t_packed, step=12, emb_format=emb_format)
    assert_trees_equal(t_lora2, j_lora)
    assert_trees_equal(t_embs2, j_embs)
    assert set(t_embs2) == {"cat-12", "dog-12"}


def test_bundle_pairing():
    files = ["a/run-100.safetensors", "a/run-step200.pt", "b/cat-100.safetensors",
             "b/dog-200.pt", "b/other.safetensors"]
    for f in files:
        assert tbundle.extract_step(f) == jbundle.extract_step(f)
    want = jbundle.pair_loras_with_embeddings(files[:2], files[2:])
    assert tbundle.pair_loras_with_embeddings(files[:2], files[2:]) == want
    with pytest.raises(ValueError):
        tbundle.pair_loras_with_embeddings(["x-1.pt", "y-1.pt"], [])


def webui_sd(sdxl, rng):
    names = ["lora_unet_down_blocks_0_attentions_1_transformer_blocks_0_attn1_to_q",
             "lora_unet_mid_block_attentions_0_proj_out",
             "lora_te_text_model_encoder_layers_3_self_attn_q_proj"]
    if sdxl:
        names = ["lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q",
                 "lora_unet_input_blocks_8_1_proj_in", "lora_unet_middle_block_1_proj_out",
                 "lora_unet_output_blocks_5_1_transformer_blocks_1_ff_net_2",
                 "lora_te1_text_model_encoder_layers_3_self_attn_q_proj",
                 "lora_te2_text_model_encoder_layers_30_mlp_fc1"]
    sd = {}
    for name in names:
        sd[f"{name}.lora_down.weight"] = np_f32(rng.normal(size=(4, 16)))
        sd[f"{name}.lora_up.weight"] = np_f32(rng.normal(size=(16, 4)))
        sd[f"{name}.alpha"] = np_f32(4.0)
    return sd


@pytest.mark.parametrize("sdxl", [False, True])
@pytest.mark.parametrize("auto_scale", [False, True])
@pytest.mark.parametrize("save_fp16", [False, True])
def test_hcp_convert(sdxl, auto_scale, save_fp16):
    sd = webui_sd(sdxl, np.random.default_rng(7))
    t_sd = {k: torch.tensor(v) for k, v in sd.items()}
    jc, tc = jhcp.LoraConverter(save_fp16), thcp.LoraConverter(save_fp16)
    j_unet, j_te = jc.convert_from_webui(dict(sd), "lora", auto_scale, sdxl=sdxl)
    t_unet, t_te = tc.convert_from_webui(dict(t_sd), "lora", auto_scale, sdxl=sdxl)
    assert_trees_equal(t_unet, j_unet)
    assert_trees_equal(t_te, j_te)
    # the HCP files' keys back to webui: the same keys as the source file
    j_back = jc.convert_to_webui(j_unet["lora"], j_te["lora"], "lora", auto_scale, sdxl=sdxl)
    t_back = tc.convert_to_webui(t_unet["lora"], t_te["lora"], "lora", auto_scale, sdxl=sdxl)
    assert_trees_equal(t_back, j_back)
    if not sdxl:
        assert set(t_back) == set(sd)
        if not auto_scale and not save_fp16:
            assert_trees_equal(t_back, sd)


@pytest.mark.parametrize("sdxl", [False, True])
def test_hcp_plugin_and_base_converter(sdxl):
    rng = np.random.default_rng(8)
    plugin = {"lora_unet_mid_block_attentions_0_proj_out.lora_down.weight":
              np_f32(rng.normal(size=(4, 16)))}
    if not sdxl:
        j = jhcp.LoraConverter().convert_from_webui(dict(plugin), "plugin")
        t = thcp.LoraConverter().convert_from_webui(
            {k: torch.tensor(v) for k, v in plugin.items()}, "plugin")
        assert_trees_equal(t[0], j[0])
    base_unet = {"conv_in.weight": np_f32(rng.normal(size=(4, 4))),
                 "conv_in.bias": np_f32(rng.normal(size=(4,)))}
    base_te = {"clip_B.text_model.fc.weight": np_f32(rng.normal(size=(4, 4))),
               "clip_bigG.text_model.fc.weight": np_f32(rng.normal(size=(4, 4)))}
    ft_unet = {k: v + np_f32(0.1) for k, v in base_unet.items()}
    ft_te = {k: v - np_f32(0.2) for k, v in base_te.items()}
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}  # noqa: E731
    want = jhcp.BaseConverter(base_unet, base_te, sdxl=sdxl).convert_to_webui(ft_unet, ft_te)
    got = thcp.BaseConverter(t(base_unet), t(base_te), sdxl=sdxl).convert_to_webui(
        t(ft_unet), t(ft_te))
    assert_trees_equal(got, want)
    assert "lora_unet_conv_in.diff_b" in got
