"""Adapter files across the two packages: the port's safetensors reader and
writer (``utils/safetensors_io.py``) against the ``safetensors`` package in
both directions, and files that one package saves (``.safetensors`` and
``.pt``, fp32 and fp16) loaded by the other, with ``merge_to`` giving the
same weights in fp32 to 1e-5: LoRA (linear layers), LoCon (linear, a 3x3
and a 1x1 conv), LoKr and LoHa, each without DoRA and with DoRA on the
output and on the input side. Then ``save_weights``' keys, dtypes and
metadata, ``load_weights`` into an existing network, and where
``create_lycoris_from_weights(file=...)`` puts the adapters. The other
algorithms cross too, weights and biases merged to 1e-5: Diag-OFT and BOFT
(with the rescale and the constraint), (IA)^3 on the output and on the
input (``on_input``), GLoRA, Full (its bias delta), DyLoRA (whose files
load as LoCon in both packages) and LoRA with ``train_norm`` on a model
that also has a LayerNorm and a GroupNorm.

Both packages wrap the same small torch model (two linear layers, a 3x3 and
a 1x1 conv): the JAX package through ``ModelGraph.from_torch``, the port
directly.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors
import safetensors.torch as st
import torch
from torch import nn

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
from lycoris_tpu_torch.utils import safetensors_io

TOL = dict(atol=1e-5, rtol=1e-5)
LINEAR_ONLY = {"target_module": ["Linear"]}
CASES = [(algo, dora) for algo in ("lora", "locon", "lokr", "loha")
         for dora in (None, "out", "in")]
IDS = [f"{a}-{d or 'plain'}" for a, d in CASES]


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(32, 64)
        self.fc2 = nn.Linear(64, 32)
        self.conv = nn.Conv2d(16, 32, 3, 1, 1)
        self.pw = nn.Conv2d(32, 32, 1)


class TinyNorm(Tiny):
    def __init__(self):
        super().__init__()
        self.ln = nn.LayerNorm(32)
        self.gn = nn.GroupNorm(4, 32)


def _model(cls=Tiny):
    torch.manual_seed(0)
    return cls()


def _net_kw(algo, dora):
    kw = dict(linear_dim=4, linear_alpha=2.0, conv_dim=4, conv_alpha=2.0,
              algo="lora" if algo == "locon" else algo, factor=4)
    if dora:
        kw.update(dora_wd=True, wd_on_output=dora == "out")
    return kw


def _jax_net(model, algo, dora, seed=0):
    """A JAX network on ``model`` with every tensor moved off its init."""
    if algo == "lora":
        jl.LycorisNetwork.apply_preset(LINEAR_ONLY)
    try:
        net = jl.create_lycoris(jl.ModelGraph.from_torch(model), 1.0,
                                rng=jax.random.key(seed), **_net_kw(algo, dora))
    finally:
        jl.LycorisNetwork.reset_preset()
    rng = np.random.default_rng(seed)
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.1)
    net.set_params_tree(tree)
    return net


def _port_net(model, algo, dora, seed=0):
    """A port network on ``model`` with every trainable tensor moved off its init."""
    if algo == "lora":
        tl.LycorisNetwork.apply_preset(LINEAR_ONLY)
    try:
        net = tl.create_lycoris(model, 1.0, seed=seed, **_net_kw(algo, dora))
    finally:
        tl.LycorisNetwork.reset_preset()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return net


def _jax_merged(model, file) -> dict:
    """{layer name: merged weight} of the JAX package's load of ``file``."""
    net, _ = jl.create_lycoris_from_weights(1.0, file, jl.ModelGraph.from_torch(model))
    merged = net.merge_to(1.0)
    return {node.name: np.asarray(merged[node.name]["weight"]) for node in net.node_map.values()}


def _port_merged(model, file) -> dict:
    """{layer name: merged weight} of the port's load of ``file`` onto a copy of ``model``."""
    m = copy.deepcopy(model)
    net, _ = tl.create_lycoris_from_weights(1.0, file, m)
    for lyco in net.loras:
        assert all(v.dtype == torch.float32 for v in lyco.params.values()), lyco.lora_name
    net.merge_to(1.0)
    return {node.name: node.module.weight.detach().numpy() for node in net.node_map.values()}


def _check_merges(model, file, layers):
    got, want = _port_merged(model, file), _jax_merged(model, file)
    assert set(got) == set(want) == layers
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=f"{file} {name}", **TOL)


def _layers(algo):
    return {"fc1", "fc2"} if algo == "lora" else {"fc1", "fc2", "conv", "pw"}


# ---------------------------------------------------------------------------
# the reader and writer against the safetensors package
# ---------------------------------------------------------------------------


def _tensors(case):
    g = torch.Generator().manual_seed(0)
    if case == "empty":
        return {}
    return {"a.w": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).half(),
            "c.scale": torch.randn(2, 1, 4, generator=g).bfloat16(),
            "alpha": torch.tensor(4.0), "z": torch.zeros(0, 3)}


@pytest.mark.parametrize("case,metadata", [
    ("mixed", None), ("mixed", {"ss_network_dim": "8", "note": "é"}), ("empty", None),
    ("empty", {"k": "v"})])
def test_safetensors_io_against_the_package(tmp_path, case, metadata):
    tensors = _tensors(case)
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    safetensors_io.save_file(tensors, ours, metadata)
    st.save_file(tensors, theirs, metadata)
    # the package's layout and order: the same header (its metadata map has
    # no fixed key order) and the same tensor bytes after it
    (h_ours, at_ours), (h_theirs, at_theirs) = (safetensors_io.read_header(p)
                                                for p in (ours, theirs))
    assert h_ours == h_theirs and at_ours == at_theirs
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read()[at_ours:] == g.read()[at_theirs:]
    for path in (ours, theirs):
        for got in (safetensors_io.load_file(path), st.load_file(path)):
            assert set(got) == set(tensors)
            for k, v in tensors.items():
                assert got[k].dtype == v.dtype and torch.equal(got[k], v), (path, k)
        with safetensors.safe_open(path, "pt") as f:
            assert f.metadata() == metadata
        header, start = safetensors_io.read_header(path)
        assert header.get("__metadata__") == metadata and start % 8 == 0


def test_safetensors_io_refuses_what_it_cannot_write(tmp_path):
    path = str(tmp_path / "x.safetensors")
    with pytest.raises(TypeError, match="str to str"):
        safetensors_io.save_file({"a": torch.ones(2)}, path, {"k": 1})
    with pytest.raises(ValueError, match="complex64"):
        safetensors_io.save_file({"a": torch.ones(2, dtype=torch.complex64)}, path)


# ---------------------------------------------------------------------------
# files across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo,dora", CASES, ids=IDS)
def test_jax_file_loads_in_the_port(tmp_path, algo, dora):
    model = _model()
    net = _jax_net(model, algo, dora)
    assert all(lyco.wd == bool(dora) for lyco in net.loras)
    for name, dtype in (("fp32.safetensors", None), ("fp16.pt", np.float16),
                        ("fp16.safetensors", np.float16), ("fp32.pt", None)):
        file = str(tmp_path / name)
        net.save_weights(file, dtype=dtype)
        _check_merges(model, file, _layers(algo))


@pytest.mark.parametrize("algo,dora", CASES, ids=IDS)
def test_port_file_loads_in_jax(tmp_path, algo, dora):
    model = _model()
    net = _port_net(model, algo, dora)
    assert all(lyco.wd == bool(dora) for lyco in net.loras)
    for name, dtype in (("fp32.safetensors", None), ("fp16.pt", torch.float16),
                        ("fp16.safetensors", torch.float16), ("fp32.pt", None)):
        file = str(tmp_path / name)
        net.save_weights(file, dtype=dtype)
        _check_merges(model, file, _layers(algo))


def test_save_weights_keys_dtypes_and_metadata(tmp_path):
    net = _port_net(_model(), "loha", "out")
    sd = net.state_dict()
    for name, dtype, metadata in (("a.safetensors", None, {"ss_network_module": "lycoris"}),
                                  ("b.safetensors", torch.bfloat16, {}),
                                  ("c.pt", torch.float16, None)):
        file = str(tmp_path / name)
        net.save_weights(file, dtype=dtype, metadata=metadata)
        want_dtype = dtype or torch.float32
        if file.endswith(".safetensors"):
            header, _ = safetensors_io.read_header(file)
            assert header.pop("__metadata__", None) == (metadata or None)
            assert set(header) == set(sd)
            assert {h["dtype"] for h in header.values()} == {safetensors_io.NAMES[want_dtype]}
        loaded = tl.wrapper.load_file_sd(file)
        assert set(loaded) == set(sd)
        for k, v in sd.items():
            assert loaded[k].device.type == "cpu" and loaded[k].dtype == want_dtype
            assert torch.equal(loaded[k], v.to(want_dtype)), k


def test_load_weights_into_an_existing_network(tmp_path):
    """``load_weights`` copies a JAX file's tensors into a port network built
    by ``create_lycoris`` with other values, which then merges as the JAX
    package's load of the file does."""
    model = _model()
    file = str(tmp_path / "a.safetensors")
    _jax_net(model, "lokr", "out", seed=1).save_weights(file)
    m = copy.deepcopy(model)
    net = _port_net(m, "lokr", "out", seed=2)
    info = net.load_weights(file)
    assert info == {"loaded": 4, "missing": []}
    want = safetensors_io.load_file(file)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **TOL)
    net.merge_to(1.0)
    jax_merged = _jax_merged(model, file)
    for node in net.node_map.values():
        np.testing.assert_allclose(node.module.weight.detach().numpy(), jax_merged[node.name],
                                   err_msg=node.name, **TOL)


def test_create_from_file_places_adapters(tmp_path):
    """From a file, each adapter goes to ``device`` if given, else to its
    layer's device, its tensors in fp32 (the file here is bf16)."""
    model = _model()
    file = str(tmp_path / "a.safetensors")
    _port_net(model, "locon", None).save_weights(file, dtype=torch.bfloat16)
    net, sd = tl.create_lycoris_from_weights(1.0, file, model)
    assert sd["lycoris_fc1.lora_down.weight"].dtype == torch.bfloat16
    assert len(net.loras) == 4
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for lyco in net.loras for t in lyco.params.values())
    net, _ = tl.create_lycoris_from_weights(1.0, file, model, device="meta")
    assert all(t.device.type == "meta" for lyco in net.loras for t in lyco.params.values())


# ---------------------------------------------------------------------------
# the other algorithms across the packages
# ---------------------------------------------------------------------------

# case -> (create_lycoris kwargs, model class, adapted layers)
OTHER = {
    "diag-oft": (dict(algo="diag-oft", constraint=1e-2, rescaled=True), Tiny, None),
    "boft": (dict(algo="boft", rescaled=True), Tiny, None),
    "ia3": (dict(algo="ia3"), Tiny, None),
    "ia3-input": (dict(algo="ia3", train_on_input=True), Tiny, None),
    "glora": (dict(algo="glora"), Tiny, None),
    "full": (dict(algo="full"), Tiny, None),
    "dylora": (dict(algo="dylora", block_size=2), Tiny, None),
    "train_norm": (dict(algo="lora", train_norm=True), TinyNorm,
                   {"fc1", "fc2", "conv", "pw", "ln", "gn"}),
}


def _other_net(pkg, model, case, seed=0):
    kw = dict(OTHER[case][0], linear_dim=4, linear_alpha=2.0, conv_dim=4, conv_alpha=2.0)
    if pkg is jl:
        net = jl.create_lycoris(jl.ModelGraph.from_torch(model), 1.0, rng=jax.random.key(seed),
                                **kw)
        rng = np.random.default_rng(seed)
        tree = net.params_tree()
        for ln, p in tree.items():
            for k in sorted(p):
                if k in net.lora_map[ln].trainable:
                    p[k] = p[k] + jnp.asarray(
                        rng.standard_normal(p[k].shape).astype(np.float32) * 0.1)
        net.set_params_tree(tree)
        return net
    net = tl.create_lycoris(model, 1.0, seed=seed, **kw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return net


def _merged_params(pkg, model, file) -> tuple:
    """({layer name: (merged weight, merged bias)}, {lora name: module class
    name}) of ``pkg``'s load of ``file``."""
    if pkg is jl:
        net, _ = jl.create_lycoris_from_weights(1.0, file, jl.ModelGraph.from_torch(model))
        merged = net.merge_to(1.0)
        out = {n.name: tuple(None if k not in merged[n.name] else np.asarray(merged[n.name][k])
                             for k in ("weight", "bias")) for n in net.node_map.values()}
    else:
        m = copy.deepcopy(model)
        net, _ = tl.create_lycoris_from_weights(1.0, file, m)
        net.merge_to(1.0)
        out = {n.name: tuple(None if getattr(n.module, k, None) is None else
                             getattr(n.module, k).detach().numpy() for k in ("weight", "bias"))
               for n in net.node_map.values()}
    return out, {ln: type(lyco).__name__ for ln, lyco in net.lora_map.items()}


@pytest.mark.parametrize("case", list(OTHER))
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_other_algorithm_files_cross(tmp_path, case, saver):
    """A file of each other algorithm that one package saves (.safetensors
    fp32, .pt fp16) loads in both as the same module kinds (DyLoRA's as
    LoCon) and merges to the same weights and biases; the file's merge moves
    the layers."""
    _, cls, layers = OTHER[case]
    model = _model(cls)
    net = _other_net(jl if saver == "jax" else tl, model, case)
    for name, dtype in (("fp32.safetensors", None),
                        ("fp16.pt", np.float16 if saver == "jax" else torch.float16)):
        file = str(tmp_path / name)
        net.save_weights(file, dtype=dtype)
        (got, got_kinds), (want, want_kinds) = (_merged_params(pkg, model, file)
                                                for pkg in (tl, jl))
        assert got_kinds == want_kinds
        if case == "dylora":
            assert set(got_kinds.values()) == {"LoConModule"}
        assert set(got) == set(want) == (layers or _layers("locon"))
        moved = 0.0
        for layer in want:
            org = getattr(model, layer)
            for got_t, want_t, base in zip(got[layer], want[layer], (org.weight, org.bias)):
                assert (got_t is None) == (want_t is None)
                if want_t is not None:
                    np.testing.assert_allclose(got_t, want_t, err_msg=f"{file} {layer}", **TOL)
                    moved = max(moved, float(np.abs(want_t - base.detach().numpy()).max()))
        assert moved > 1e-3
