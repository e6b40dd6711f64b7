"""The plain reference against the port's plain path on the CPU at toy
sizes (fp32): the UNet forward, a training step's loss, adapter gradients
and AdamW update, and a DiT call with LoKr live; its parameter lists
against the port's models at full size (on the meta device); and its import
graph, which holds nothing of the port or of JAX."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from bench_h100 import inputs
from bench_h100.reference.common import WeightStore
from bench_h100.reference.dit import dit_forward, dit_spec
from bench_h100.reference.unet import TrainReference, unet_forward, unet_spec
from bench_h100.tiny import REPO, TINY_SIZES

CPU = torch.device("cpu")
LOKR = inputs.algo("lokr")
ADAPTER = {"algo": "lokr", "dim": 8, "alpha": 4.0, "factor": 8}
UNET_TARGETS = {**ADAPTER, "targets": ["Transformer2DModel"]}
DIT_TARGETS = {**ADAPTER, "targets": ["DoubleStreamBlock", "SingleStreamBlock"]}
UNET_FULL = {"in_channels": 4, "out_channels": 4, "block_out_channels": [320, 640, 1280],
             "layers_per_block": 2, "transformer_depth": [0, 2, 10], "mid_transformer_depth": 10,
             "context_dim": 2048, "head_dim": 64, "norm_groups": 32, "addition_embed_dim": 2816}
DIT_FULL = {"hidden_size": 3072, "num_heads": 24, "mlp_ratio": 4.0, "depth_double": 19,
            "depth_single": 38, "in_channels": 64, "context_dim": 4096, "qk_norm": True}


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def port_unet(sizes, base, remat=False):
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    cfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in sizes.items()},
                     remat=remat)
    model = UNet2DConditionModel(cfg, device="meta")
    model.load_state_dict(base, strict=True, assign=True)
    return model


def port_dit(sizes, base):
    from lycoris_tpu_torch.models.dit import DiTConfig, FluxTransformer2D

    model = FluxTransformer2D(DiTConfig(**sizes), device="meta")
    model.load_state_dict(base, strict=True, assign=True)
    return model.eval()


@pytest.mark.parametrize("which", ["unet", "dit"])
def test_spec_is_the_ports_parameter_list_at_full_size(which):
    from lycoris_tpu_torch.models.dit import DiTConfig, FluxTransformer2D
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    if which == "unet":
        spec = unet_spec(UNET_FULL)
        model = UNet2DConditionModel(UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                                   for k, v in UNET_FULL.items()}), device="meta")
        want = 2_567_463_684
    else:
        spec = dit_spec(DIT_FULL)
        model = FluxTransformer2D(DiTConfig(**DIT_FULL), device="meta")
        want = 11_889_169_472
    got = {name: tuple(shape) for name, shape, *_ in spec}
    assert got == {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert sum(torch.Size(s).numel() for s in got.values()) == want


@pytest.mark.parametrize("path", ["configs/sdxl-base-1.0-unet.json", "configs/flux1-dev-dit.json"])
def test_config_files_hold_the_full_sizes(path):
    cfg = json.loads((REPO / "bench_h100" / path).read_text())
    sizes = cfg["run"]["sizes"]
    spec = unet_spec(sizes) if cfg["run"]["model"] == "unet" else dit_spec(sizes)
    assert sum(torch.Size(s).numel() for _, s, *_ in spec) == cfg["parameters"]
    assert sizes == (UNET_FULL if cfg["run"]["model"] == "unet" else DIT_FULL)


def test_unet_forward_matches_the_port():
    sizes = TINY_SIZES["unet"]
    spec = unet_spec(sizes)
    base = inputs.make_weights(spec, 7, torch.float32, CPU)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, generator=g)
    t = torch.tensor([3, 901])
    ctx = torch.randn(2, 77, sizes["context_dim"], generator=g)
    added = torch.randn(2, sizes["addition_embed_dim"], generator=g)
    with torch.no_grad():
        want = unet_forward(sizes, WeightStore(base), x, t, ctx, added)
        got = port_unet(sizes, base)(x, t, ctx, added_cond=added)
    assert rel(got, want) < 1e-5


def test_train_step_matches_the_ports_trainer():
    """Loss, every adapter gradient and the AdamW update of one step with
    LoKr on every Transformer2DModel, the checkpointed UNet on both sides."""
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    sizes = TINY_SIZES["unet"]
    spec = unet_spec(sizes)
    base = inputs.make_weights(spec, 11, torch.float32, CPU)
    theta, scales = inputs.make_adapters(spec, UNET_TARGETS, 11, CPU)
    model = port_unet(sizes, base, remat="transformer")
    net = inputs.port_network(model, UNET_TARGETS, CPU)
    leaves = inputs.load_adapters(net, theta)
    trainer = DiffusionTrainer(model, net, lr=1e-4, weight_dtype=torch.float32,
                               generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(1)
    batch = {"latents": torch.randn(4, 4, 8, 8, generator=g),
             "context": torch.randn(4, 77, sizes["context_dim"], generator=g),
             "added_cond": torch.randn(4, sizes["addition_embed_dim"], generator=g)}
    before = {(layer, key): p.detach().clone() for layer, key, p in leaves}
    loss = float(trainer.train_step(batch))
    ref = TrainReference(sizes, inputs.make_weights(spec, 11, torch.float32, CPU),
                         inputs.make_adapters(spec, UNET_TARGETS, 11, CPU)[0], scales,
                         LOKR.delta, torch.Generator().manual_seed(5), lr=1e-4, block=3)
    ref_loss, grads = ref.step(batch)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    by_key = dict(zip(ref.keys, zip(grads, ref.leaves)))
    for layer, key, p in leaves:
        g_ref, p_ref = by_key[(layer, key)]
        m = trainer.optimizer.state[p]["exp_avg"].reshape(g_ref.shape) / 0.1
        assert rel(m, g_ref) < 1e-4, (layer, key)
        step = p.detach().reshape(p_ref.shape) - before[(layer, key)].reshape(p_ref.shape)
        step_ref = p_ref.detach() - theta[layer][key]
        assert rel(step, step_ref) < 1e-3, (layer, key)


def test_dit_call_with_live_lokr_matches_the_port():
    sizes = TINY_SIZES["dit"]
    spec = dit_spec(sizes)
    base = inputs.make_weights(spec, 13, torch.float32, CPU)
    theta, scales = inputs.make_adapters(spec, DIT_TARGETS, 13, CPU)
    model = port_dit(sizes, base)
    net = inputs.port_network(model, DIT_TARGETS, CPU)
    inputs.load_adapters(net, theta)
    net.apply_to(merged_forward=True)
    g = torch.Generator().manual_seed(2)
    img = torch.randn(1, 16, sizes["in_channels"], generator=g)
    txt = torch.randn(1, 8, sizes["context_dim"], generator=g)
    t = torch.tensor([417.5])
    with torch.no_grad():
        got = model(img, txt, t)
    want = dit_forward(sizes, WeightStore(inputs.make_weights(spec, 13, torch.float32, CPU),
                                          theta, scales, LOKR.delta), img, txt, t)
    assert rel(got, want) < 1e-5
    bare = dit_forward(sizes, WeightStore(base), img, txt, t)
    assert rel(bare, want) > 1e-2  # the adapters move the output


def test_lokr_delta_is_the_ports_kron():
    from lycoris_tpu_torch.functional.lokr import make_kron

    g = torch.Generator().manual_seed(3)
    theta = {"lokr_w1": torch.randn(8, 8, generator=g),
             "lokr_w2_a": torch.randn(160, 8, generator=g),
             "lokr_w2_b": torch.randn(8, 40, generator=g)}
    want = make_kron(theta["lokr_w1"], theta["lokr_w2_a"] @ theta["lokr_w2_b"], 0.5)
    assert torch.allclose(LOKR.delta(theta, 0.5), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("algo", ["lokr", "loha"])
def test_algo_files_make_the_ports_tensors_and_dw(algo):
    """Each algorithm file's shapes are the port's module's trainable
    tensors, and its dW is the port's ``get_weight`` on the same tensors
    (at an SDXL and a Flux layer's width)."""
    from lycoris_tpu_torch import LohaModule, LokrModule
    from lycoris_tpu_torch.modules.base import LayerInfo

    mod = inputs.algo(algo)
    adapter = {"algo": algo, "dim": 8, "alpha": 4.0, "factor": 8}
    cls = LokrModule if algo == "lokr" else LohaModule
    g = torch.Generator().manual_seed(6)
    for o, i in ((1280, 2048), (3072, 12288)):
        lyco = cls("x", LayerInfo.linear(o, i), 1.0, 8, 4.0, **mod.port_kwargs(adapter))
        sh = mod.shapes(o, i, adapter)
        trainable = {k: tuple(p.shape) for k, p in lyco.params.items() if p.requires_grad}
        assert trainable == sh["shapes"]
        theta = {k: torch.randn(s, generator=g) for k, s in sh["shapes"].items()}
        with torch.no_grad():
            for k, v in theta.items():
                lyco.params[k].copy_(v)
            want = lyco.get_weight().reshape(o, i)
        assert rel(mod.delta(theta, sh["scale"]), want) < 1e-5


def test_fp8_control_rounds_the_matmul_operands():
    from bench_h100.reference.common import Ops

    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(64, 256, generator=g), torch.randn(128, 256, generator=g)
    exact = Ops("fp32").linear(x, w)
    low = Ops("fp8").linear(x, w)
    assert torch.equal(exact, x @ w.T) or rel(exact, x @ w.T) < 1e-6
    assert 1e-3 < rel(low, exact) < 0.2


def test_reference_imports_nothing_of_the_port_or_of_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_h100.reference.unet, bench_h100.reference.dit, bench_h100.reference.common\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    names = set(json.loads(out.stdout.replace("'", '"')))
    assert not names & {"lycoris_tpu_torch", "lycoris_tpu", "jax", "jaxlib", "flax", "optax"}
    assert "torch" in names


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    spec = dit_spec(TINY_SIZES["dit"])
    a = inputs.make_weights(spec, 2**31 + 17, torch.bfloat16, CPU)
    b = inputs.make_weights(spec, 2**31 + 17, torch.bfloat16, CPU)
    c = inputs.make_weights(spec, 2**31 + 18, torch.bfloat16, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["img_in.weight"], c["img_in.weight"])
    base = min(t.data_ptr() for t in a.values())  # the flat buffer (CUDA's allocator: 512 B)
    assert all((t.data_ptr() - base) % 256 == 0 for t in a.values())
    theta, _ = inputs.make_adapters(spec, DIT_TARGETS, 2**31 + 17, CPU)
    assert all(bool((v != 0).all()) for sub in theta.values() for v in sub.values())


def test_tiny_sizes_are_port_configs():
    from lycoris_tpu_torch.models.dit import DiTConfig
    from lycoris_tpu_torch.models.unet import UNetConfig

    UNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY_SIZES["unet"].items()})
    assert dataclasses.asdict(DiTConfig(**TINY_SIZES["dit"]))["hidden_size"] == 32
