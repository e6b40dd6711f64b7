"""RMSNorm, ``train_norm`` and the parametrize API in the port against the
JAX package: the functional ``rms_norm``, the graph's detection of torch
``nn.RMSNorm`` and of duck-typed modules (a ``weight`` and a callable
``_norm``), ``train_norm`` on a small torch model (the same adapted layers
as the JAX network on ``ModelGraph.from_torch``, zero-init no-op, merged ==
delta), the tiny UNet with ``train_norm`` on the merged and the delta route
against the JAX interceptor, one trainer step's loss and gradients against
the JAX trainer's, and ``parametrize`` through
``torch.nn.utils.parametrize.register_parametrization`` against the JAX
``parametrize_forward``.

Inputs are drawn with numpy from a seed; torch gets its own copies
(``torch.tensor``). Tolerance: fp32 1e-5 per op; 1e-4 relative for
whole-UNet outputs, losses and gradients (as tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.nn.utils import parametrize as tparam

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
import torch_parity as tp
from lycoris_tpu import modules as jmods
from lycoris_tpu.functional.general import rms_norm as jrms_norm
from lycoris_tpu_torch import modules as tmods
from lycoris_tpu_torch.functional.general import rms_norm
from lycoris_tpu_torch.graph import ModelGraph

TOL = dict(atol=1e-5, rtol=1e-5)
REL = 1e-4


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


def _rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()), np.asarray(want),
                               **(tol or TOL))


class LlamaStyleRMSNorm(nn.Module):
    """A duck-typed norm: a ``weight`` and a stats-only ``_norm``, no bias."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.variance_epsilon = eps

    def _norm(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.variance_epsilon)

    def forward(self, x):
        return self._norm(x) * self.weight


class Host(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(16, 32)
        self.ln = nn.LayerNorm(32)
        self.duck = LlamaStyleRMSNorm(32)
        self.rms = nn.RMSNorm(32, eps=1e-6)
        self.gn = nn.GroupNorm(4, 32)

    def forward(self, x):
        h = self.rms(self.duck(self.ln(self.fc(x))))
        return self.gn(h.transpose(1, 2)).transpose(1, 2)


# ---------------------------------------------------------------------------
# RMSNorm: the op and its detection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_rms_norm_matches_jax_and_torch(weighted, bias):
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 2, 5, 32), _rand(rng, 32), _rand(rng, 32)
    w_, b_ = (w if weighted else None), (b if bias else None)
    got = rms_norm(torch.tensor(x), 32, None if w_ is None else torch.tensor(w_),
                   None if b_ is None else torch.tensor(b_), eps=1e-6)
    want = jrms_norm(jnp.asarray(x), (32,), None if w_ is None else jnp.asarray(w_),
                     None if b_ is None else jnp.asarray(b_), eps=1e-6)
    _close(got, want)
    ref = torch.nn.functional.rms_norm(torch.tensor(x), (32,),
                                       None if w_ is None else torch.tensor(w_), eps=1e-6)
    _close(got, (ref + (torch.tensor(b_) if bias else 0)).numpy())


def test_graph_detects_rms_norms_as_jax():
    """torch ``nn.RMSNorm`` and the duck-typed module map to "rmsnorm" with
    the JAX graph's shape and eps; ``LayerInfo.op`` on them is the layer."""
    host = Host()
    got = {n.name: n.layer_info for n in ModelGraph.from_torch(host).nodes if n.is_leaf}
    want = {n.name: n.adapter.layer_info for n in jl.ModelGraph.from_torch(host).nodes
            if n.is_leaf}
    assert set(got) == set(want)
    for name, li in got.items():
        assert (li.module_type, li.shape, li.kw_dict, li.has_bias) == (
            want[name].module_type, want[name].shape, want[name].kw_dict, want[name].has_bias)
    assert got["duck"].module_type == got["rms"].module_type == "rmsnorm"
    x = torch.tensor(_rand(np.random.default_rng(1), 3, 32))
    with torch.no_grad():
        host.duck.weight.mul_(1.5)
        for name in ("duck", "rms"):
            mod = getattr(host, name)
            _close(got[name].op(x, mod.weight), mod(x).numpy())


def test_train_norm_on_torch_model_matches_jax():
    """``train_norm`` with the duck-typed norm targeted by name: the same
    lora names and kinds as the JAX network on ``from_torch``; zero-init is
    a no-op; with moved deltas the delta route equals the merged route and
    ``merge_to``, and the merged weights equal the JAX module's."""
    torch.manual_seed(0)
    host = Host()
    for pkg in (jl, tl):
        pkg.LycorisNetwork.apply_preset({"target_name": ["duck"]})
    jnet = jl.create_lycoris(jl.ModelGraph.from_torch(host), 1.0, linear_dim=4, linear_alpha=1.0,
                             algo="lora", preset="full", train_norm=True, rng=jax.random.key(0))
    tnet = tl.create_lycoris(host, 1.0, linear_dim=4, linear_alpha=1.0, algo="lora",
                             preset="full", train_norm=True, device="cpu")
    kinds = {ln: type(m).__name__ for ln, m in tnet.lora_map.items()}
    assert kinds == {ln: type(m).__name__ for ln, m in jnet.lora_map.items()}
    assert kinds["lycoris_duck"] == kinds["lycoris_rms"] == kinds["lycoris_gn"] == "NormModule"
    x = torch.tensor(_rand(np.random.default_rng(2), 2, 7, 16))
    with torch.no_grad():
        base = host(x)
        tnet.apply_to(merged_forward=True)
        _close(host(x), base.numpy())
        tnet.restore()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for lyco in tnet.loras:
            for p in lyco.parameters():
                p.add_(torch.tensor(_rand(rng, *p.shape, std=0.1)))
    outs = {}
    with torch.no_grad():
        for merged in (True, False):
            tnet.apply_to(merged_forward=merged)
            outs[merged] = host(x)
            tnet.restore()
    _close(outs[False], outs[True].numpy())
    assert float((outs[True] - base).abs().max()) > 1e-3
    sd = {k: np.asarray(v) for k, v in tnet.state_dict().items()}
    jnet.load_state_dict(sd)
    for ln in ("lycoris_duck", "lycoris_rms", "lycoris_gn", "lycoris_ln"):
        node = tnet.node_map[ln]
        w, b = node.weights()
        jw = jnp.asarray(w.detach().numpy())
        jb = None if b is None else jnp.asarray(b.detach().numpy())
        got_w, got_b = tnet.lora_map[ln].get_merged_weight(w, b)
        want_w, want_b = jnet.lora_map[ln].get_merged_weight(jw, jb)
        _close(got_w, want_w)
        if want_b is not None:
            _close(got_b, want_b)
    tnet.merge_to(1.0)
    with torch.no_grad():
        _close(host(x), outs[True].numpy())


# ---------------------------------------------------------------------------
# train_norm on the tiny UNet
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_norm_unet_routes_match_jax(one_thread):
    """LoRA with ``train_norm`` on the tiny UNet's attn-mlp targets: every
    LayerNorm and the GroupNorm of each Transformer2DModel get a Norm
    module, and the UNet's output on the merged and the delta route equals
    the JAX interceptor's."""
    model, variables, jnet, m, tnet, d = tp.setup("lora", train_norm=True)
    kinds = {type(lyco).__name__ for lyco in tnet.loras}
    assert kinds == {"LoConModule", "NormModule"}
    assert {ln for ln, ly in tnet.lora_map.items() if isinstance(ly, tmods.NormModule)} == {
        ln for ln, ly in jnet.lora_map.items() if isinstance(ly, jmods.NormModule)}
    norms = [tnet.node_map[ly.lora_name].class_name for ly in tnet.loras
             if isinstance(ly, tmods.NormModule)]
    transformers = [n for n in tnet.graph.nodes if n.class_name == "Transformer2DModel"]
    assert norms.count("GroupNorm") == len(transformers) == 7
    assert norms.count("LayerNorm") == 3 * len(transformers)
    args = tuple(jnp.asarray(d[k]) for k in ("lat", "t", "ctx"))
    targs = tuple(torch.tensor(d[k]) for k in ("lat", "t", "ctx"))
    for merged in (True, False):
        want = jnet({"params": variables["params"]}, *args, model=model, merged_forward=merged)
        tnet.apply_to(merged_forward=merged)
        with torch.no_grad():
            got = m(*targs)
        tnet.restore()
        _close(got, want, atol=REL, rtol=REL)


def test_train_norm_trainer_step_matches_jax(one_thread, monkeypatch):
    """One trainer loss and every adapter gradient, ``w_norm``/``b_norm``
    included, against the JAX trainer's (merged forward). The JAX
    interceptor's factored-backward gate reads ``shape[1]`` of every adapted
    layer and fails on a norm's 1-d shape, so the JAX side runs with the
    factored backward off (the same gradients, formed densely); the port
    keeps it for its LoRA layers."""
    monkeypatch.setenv("LYCORIS_TPU_FACTORED_GRAD", "0")
    model, variables, net, m, tnet, d = tp.setup("lora", train_norm=True)
    want_loss, want_grads = tp.jax_loss_and_grads(model, variables, net, d)
    assert any("w_norm" in sub for sub in want_grads.values())
    _, loss, grads = tp.port_loss_and_grads(m, tnet, d)
    np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
    tp.assert_trees_close(grads, want_grads, REL)


# ---------------------------------------------------------------------------
# the parametrize API
# ---------------------------------------------------------------------------

PARAM_ALGOS = {
    "locon": (jmods.LoConModule, tmods.LoConModule, {}),
    "loha": (jmods.LohaModule, tmods.LohaModule, {}),
    "lokr": (jmods.LokrModule, tmods.LokrModule, dict(factor=4)),
    "diag-oft": (jmods.DiagOFTModule, tmods.DiagOFTModule, dict(rescaled=True)),
    "boft": (jmods.ButterflyOFTModule, tmods.ButterflyOFTModule, {}),
    "ia3": (jmods.IA3Module, tmods.IA3Module, {}),
    "glora": (jmods.GLoRAModule, tmods.GLoRAModule, {}),
    "dylora": (jmods.DyLoraModule, tmods.DyLoraModule, dict(block_size=2)),
}


@pytest.mark.parametrize("algo", list(PARAM_ALGOS))
@pytest.mark.parametrize("conv", [False, True])
def test_parametrization_matches_jax(algo, conv):
    """``parametrize`` over a plain layer's weight, registered with
    ``register_parametrization``: at init the layer is unchanged; with the
    JAX module's moved tensors copied in, ``layer.weight`` is the JAX
    ``parametrize_forward`` (multiplier 0.7), the layer's output uses it,
    and the adapter's gradients match ``jax.grad``."""
    jcls, tcls, kw = PARAM_ALGOS[algo]
    rng = np.random.default_rng(4)
    layer = nn.Conv2d(16, 32, 3, padding=1) if conv else nn.Linear(24, 32)
    w = layer.weight.detach().numpy().copy()
    x = torch.tensor(_rand(rng, *((2, 16, 6, 6) if conv else (3, 24))))
    base = layer(x).detach()
    tm = tcls.parametrize(layer.weight, 0.7, 4, 2.0, generator=torch.Generator().manual_seed(0),
                          **kw)
    assert tm.lora_name == "" and not tm.bypass_mode
    tparam.register_parametrization(layer, "weight", tm.parametrization())
    assert any(p is tm._p(k) for k in tm.trainable for p in layer.parameters())
    _close(layer(x), base.numpy())
    jm = jcls.parametrize(jnp.asarray(w), 0.7, 4, 2.0, rng=jax.random.key(0), **kw)
    for k in sorted(jm.trainable):
        jm.params[k] = jm.params[k] + jnp.asarray(_rand(rng, *jm.params[k].shape, std=0.1))
    assert set(tm.params) == set(jm.params)
    for k, v in jm.params.items():
        tm._set(k, torch.tensor(np.array(v)).reshape(tm._p(k).shape))
    want = jm.parametrize_forward(jnp.asarray(w))
    _close(layer.weight, want, atol=1e-5, rtol=1e-5)
    tparam.remove_parametrizations(layer, "weight", leave_parametrized=False)
    _close(layer.weight, w)
    tparam.register_parametrization(layer, "weight", tm.parametrization())
    out = layer(x)
    _close(out, (torch.nn.functional.conv2d(x, torch.tensor(np.asarray(want)), layer.bias,
                                            padding=1) if conv else
                 torch.nn.functional.linear(x, torch.tensor(np.asarray(want)), layer.bias))
           .detach().numpy(), atol=1e-4, rtol=1e-5)
    g = _rand(rng, *tuple(want.shape))
    want_g = jax.grad(lambda p: jnp.sum(jm.parametrize_forward(
        jnp.asarray(w), params={**jm.params, **p}) * jnp.asarray(g)))(jm.trainable_params())
    (layer.weight * torch.tensor(g)).sum().backward()
    for k in want_g:
        scale = float(jnp.abs(want_g[k]).max())
        _close(tm._p(k).grad, want_g[k], atol=1e-5 * max(scale, 1.0), rtol=1e-5)


def test_parametrize_refuses_full_and_bad_ranks():
    w = torch.zeros(8, 8)
    with pytest.raises(RuntimeError):
        tmods.FullModule.parametrize(w, 1.0)
    with pytest.raises(ValueError):
        tmods.LoConModule.parametrize(torch.zeros(8), 1.0)
