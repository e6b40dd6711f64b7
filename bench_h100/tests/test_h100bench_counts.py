"""The FLOP and byte counts of the port's kernels and models, and the frozen
census: hand counts at two shapes each, the bound column of PERF.md's
kernel table at the path shapes, the smoke script's hand-counted launches
per step or call, and the port's own calls in a tiny CPU step."""

from __future__ import annotations

import pytest

from bench_h100 import counts

SDXL = {"in_channels": 4, "out_channels": 4, "block_out_channels": [320, 640, 1280],
        "layers_per_block": 2, "transformer_depth": [0, 2, 10], "mid_transformer_depth": 10,
        "context_dim": 2048, "head_dim": 64, "norm_groups": 32, "addition_embed_dim": 2816,
        "remat": "transformer"}
SD15 = {"in_channels": 4, "out_channels": 4, "block_out_channels": [320, 640, 1280, 1280],
        "layers_per_block": 2, "transformer_depth": [1, 1, 1, 0], "mid_transformer_depth": 1,
        "context_dim": 768, "num_heads": 8, "norm_groups": 32, "remat": False}
FLUX = {"hidden_size": 3072, "num_heads": 24, "mlp_ratio": 4.0, "depth_double": 19,
        "depth_single": 38, "in_channels": 64, "context_dim": 4096, "qk_norm": True}


@pytest.mark.parametrize("fn,shape,flops,nbytes", [
    (counts.flash_fwd, (80, 1024, 64), 4 * 80 * 1024**2 * 64, 4 * 80 * 1024 * 64 * 2 + 4 * 80 * 1024),
    (counts.flash_fwd, (24, 4608, 128), 4 * 24 * 4608**2 * 128,
     4 * 24 * 4608 * 128 * 2 + 4 * 24 * 4608),
    (counts.flash_bwd, (80, 1024, 64), 10 * 80 * 1024**2 * 64, 8 * 80 * 1024 * 64 * 2 + 8 * 80 * 1024),
    (counts.flash_bwd, (160, 4096, 64), 10 * 160 * 4096**2 * 64,
     8 * 160 * 4096 * 64 * 2 + 8 * 160 * 4096),
    (counts.layer_norm_bwd, (4096, 1280), 12 * 4096 * 1280, (3 * 4096 * 1280 + 1280) * 2),
    (counts.layer_norm_bwd, (65536, 640), 12 * 65536 * 640, (3 * 65536 * 640 + 640) * 2),
    (counts.group_norm_fwd, (4, 960, 16384), 10 * 4 * 960 * 16384,
     (2 * 4 * 960 * 16384 + 2 * 960) * 2 + 8 * 4 * 32),
    (counts.group_norm_fwd, (16, 320, 4096), 10 * 16 * 320 * 4096,
     (2 * 16 * 320 * 4096 + 2 * 320) * 2 + 8 * 16 * 32),
    (counts.group_norm_bwd, (4, 960, 16384), 16 * 4 * 960 * 16384,
     (3 * 4 * 960 * 16384 + 2 * 960) * 2 + 8 * 4 * 32),
    (counts.group_norm_bwd, (16, 1280, 1024), 16 * 16 * 1280 * 1024,
     (3 * 16 * 1280 * 1024 + 2 * 1280) * 2 + 8 * 16 * 32),
    (counts.geglu_bwd, (4096, 10240), 10 * 4096 * 10240, 2.5 * 4096 * 10240 * 2),
    (counts.geglu_bwd, (65536, 5120), 10 * 65536 * 5120, 2.5 * 65536 * 5120 * 2),
    (counts.hada_fwd, (1280, 1280), 4 * 1280 * 1280 * 8 + 1280 * 1280,
     (2 * 8 * 2560 + 1280 * 1280) * 4),
    (counts.hada_fwd, (21504, 3072), 4 * 21504 * 3072 * 8 + 21504 * 3072,
     (2 * 8 * (21504 + 3072) + 21504 * 3072) * 4),
])
def test_kernel_counts_by_hand(fn, shape, flops, nbytes):
    assert fn(*shape) == (flops, nbytes)


@pytest.mark.parametrize("rows,c,bias,nbytes", [
    (4096, 1280, True, (2 * 4096 * 1280 + 2 * 1280) * 2),
    (4608, 3072, False, (2 * 4608 * 3072 + 3072) * 2),
])
def test_layer_norm_fwd_by_hand(rows, c, bias, nbytes):
    assert counts.layer_norm_fwd(rows, c, bias) == (8 * rows * c, nbytes)


# PERF.md's kernel table: bound ms at the path shapes (4 decimals)
@pytest.mark.parametrize("kernel,shape,kw,ms", [
    ("flash_fwd", (80, 1024, 64), {}, 0.0217),
    ("flash_fwd", (32, 4096, 40), {}, 0.0869),
    ("flash_fwd", (24, 4608, 128), {}, 0.2638),
    ("flash_bwd", (80, 1024, 64), {}, 0.0543),
    ("flash_bwd", (64, 4096, 40), {}, 0.4343),
    ("layer_norm_fwd", (4096, 1280), {}, 0.0063),
    ("layer_norm_fwd", (16384, 640), {}, 0.0125),
    ("layer_norm_fwd", (4096, 3072), {"bias": False}, 0.0150),
    ("layer_norm_fwd", (512, 3072), {"bias": False}, 0.0019),
    ("layer_norm_fwd", (4608, 3072), {"bias": False}, 0.0169),
    ("layer_norm_bwd", (4096, 1280), {}, 0.0094),
    ("layer_norm_bwd", (32768, 320), {}, 0.0188),
    ("group_norm_fwd", (4, 960, 16384), {}, 0.0751),
    ("group_norm_bwd", (4, 960, 16384), {}, 0.1127),
    ("geglu_bwd", (4096, 10240), {}, 0.0626),
    ("geglu_bwd", (32768, 2560), {}, 0.1252),
    ("hada_fwd", (1280, 1280), {}, 0.0020),
    ("hada_fwd", (21504, 3072), {}, 0.0793),
])
def test_bounds_match_the_kernel_table(kernel, shape, kw, ms):
    assert round(counts.bound_s(*counts.KERNELS[kernel](*shape, **kw)) * 1e3, 4) == ms


@pytest.mark.parametrize("sizes,batch,hw,remat,want", [
    (SDXL, 4, 128, True, {"flash_fwd": 140, "layer_norm_fwd": 420, "group_norm_fwd": 57,
                          "flash_bwd": 70, "layer_norm_bwd": 210, "group_norm_bwd": 39,
                          "geglu_bwd": 70, "factored": 240}),
    (SD15, 8, 64, False, {"flash_fwd": 10, "layer_norm_fwd": 48, "group_norm_fwd": 61,
                          "flash_bwd": 10, "layer_norm_bwd": 48, "group_norm_bwd": 58,
                          "geglu_bwd": 16, "factored": 12}),
])
def test_unet_census_is_the_smoke_scripts_hand_count(sizes, batch, hw, remat, want):
    """The model's launches, and LoKr's factored layer applications from
    its algorithm file over the adapted layers of the reference's spec."""
    from bench_h100 import inputs
    from bench_h100.reference.unet import unet_spec

    lokr = inputs.algo("lokr")
    layers = [(shape, counts.unet_passes(sizes, block, True)) for _, shape, block
              in inputs.adapted_layers(unet_spec(sizes), ["Transformer2DModel"])]
    census = counts.with_adapter(counts.unet_census(sizes, batch, hw, train=True),
                                 lokr.census(layers, {"dim": 8}, True))
    assert counts.census_launches(census) == want
    assert lokr.census(layers, {"dim": 8}, False) == {}


def test_sdxl_b16_census_shapes():
    c = counts.unet_census(SDXL, 16, 128, train=True)
    assert c["flash_fwd"] == {(160, 4096, 64): 20, (320, 1024, 64): 120}
    assert c["layer_norm_fwd"] == {(65536, 640): 60, (16384, 1280): 360}
    assert c["geglu_bwd"] == {(65536, 5120): 10, (16384, 10240): 60}


def test_dit_census_is_the_smoke_scripts_hand_count():
    """The DiT's launches; LoHa on its 304 adapted layers adds one hada
    forward a layer (the smoke script's count), LoKr adds nothing."""
    from bench_h100 import inputs
    from bench_h100.reference.dit import dit_spec

    c = counts.dit_census(FLUX, 1, 512, 4096)
    assert counts.census_launches(c) == {"flash_fwd": 57, "layer_norm_fwd": 115}
    assert c["layer_norm_fwd"] == {(4096, 3072): 39, (512, 3072): 38, (4608, 3072): 38}
    layers = [(shape, 1) for _, shape, _ in
              inputs.adapted_layers(dit_spec(FLUX), ["DoubleStreamBlock", "SingleStreamBlock"])]
    assert len(layers) == 304
    assert inputs.algo("lokr").census(layers, {"dim": 8}, False) == {}
    loha = counts.with_adapter(c, inputs.algo("loha").census(layers, {"dim": 8}, False))
    assert counts.census_launches(loha)["hada_fwd"] == 304
    assert loha["hada_fwd"][(21504, 3072, 8)] == 38
    assert loha["hada_fwd"][(18432, 3072, 8)] == 38  # img_mod.lin and txt_mod.lin


def test_census_disagreement_names_the_kernels():
    c = counts.dit_census(FLUX, 1, 512, 4096)
    got = {"flash_fwd": 3 * 57, "layer_norm_fwd": 3 * 115 + 1, "hada_fwd": 0, "factored": 0}
    assert counts.census_disagreeing(got, c, 3) == ["layer_norm_fwd"]
    assert not counts.census_agrees(got, c, 3)
    got["layer_norm_fwd"] -= 1
    assert counts.census_agrees(got, c, 3)
    bounds = counts.census_bounds_s(c, bias=False)
    assert set(bounds) == {"flash_fwd", "layer_norm_fwd"}
    assert sum(bounds.values()) == counts.census_bound_s(c, bias=False)


def test_model_flops():
    """Flux at 512 + 4096 tokens: 59.5 TFLOP of matmuls and 14.9 of attention
    (the Flux kernel table's count); SDXL's forward at 128 x 128 within the usual 5-7 TFLOP a
    sample."""
    f = counts.dit_flops(FLUX, 1, 512, 4096)
    attn = 57 * counts.attention_flops(1, 4608, 4608, 3072)
    assert abs(attn - 14.87e12) < 0.01e12
    assert abs((f - attn) - 59.5e12) < 0.1e12
    per_sample = counts.unet_flops(SDXL, 1, 128)
    assert 5e12 < per_sample < 7e12
    assert counts.unet_flops(SDXL, 16, 128) == pytest.approx(16 * per_sample, rel=1e-12)
    dep = counts.flux_departure_flops(FLUX, 1, 512, 4096)
    assert dep["rope"] / f < 1e-4 and dep["guidance_in"] < 3e7 and dep["vector_in"] < 3e7


@pytest.mark.parametrize("name,kind", [
    ("flash_fwd_bf16_kernel", "own"), ("ln_fwd_vec_kernel", "own"), ("gn_bwd_fast_kernel", "own"),
    ("geglu_bwd_kernel", "own"), ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64", "gemm"),
    ("cudnn_generated_fort_native_sdpa", "conv"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", "elementwise"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<>", "elementwise"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
])
def test_kernel_buckets(name, kind):
    assert counts.bucket(name) == kind


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<64>(CUtensorMap_st, float)", "flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_dkdv_bf16<64>(CUtensorMap_st)", "flash_bwd"),
    ("void (anonymous namespace)::flash_di_kernel<64>(float*)", "flash_bwd"),
    ("ln_fwd_vec_kernel", "layer_norm_fwd"), ("ln_bwd_reduce_kernel", "layer_norm_bwd"),
    ("gn_fwd_fast_kernel", "group_norm_fwd"), ("gn_bwd_wb_kernel", "group_norm_bwd"),
    ("geglu_bwd_kernel", "geglu_bwd"), ("hada_fwd_r8_kernel", "hada_fwd"),
    ("hada_bwd_r8_kernel", None), ("lora_fused_kernel", None),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", None),
])
def test_census_kernel_of_a_device_kernel(name, kernel):
    assert counts.census_kernel(name) == kernel


def test_census_equals_the_ports_calls_in_a_tiny_step(monkeypatch):
    """The port's LayerNorm, GroupNorm and GEGLU Functions run their plain
    directions on the CPU: counted there, one tiny checkpointed training
    step calls each as often as the census says."""
    import torch
    from lycoris_tpu_torch.functional import merged
    from lycoris_tpu_torch.ops import geglu, group_norm, layer_norm
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    from bench_h100 import inputs
    from bench_h100.reference.unet import unet_spec
    from bench_h100.tiny import TINY_SIZES

    calls = dict.fromkeys(("layer_norm_fwd", "layer_norm_bwd", "group_norm_fwd",
                           "group_norm_bwd", "geglu_bwd"), 0)

    def counted(mod, name, key):
        orig = getattr(mod, name)

        def wrap(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrap)

    counted(layer_norm, "layer_norm_plain", "layer_norm_fwd")
    counted(layer_norm, "layer_norm_bwd_plain", "layer_norm_bwd")
    counted(group_norm, "group_norm_plain", "group_norm_fwd")
    counted(group_norm, "group_norm_bwd_plain", "group_norm_bwd")
    counted(geglu, "geglu_bwd_plain", "geglu_bwd")
    sizes = {**TINY_SIZES["unet"], "block_out_channels": [32, 64, 64],
             "transformer_depth": [0, 1, 2]}
    adapter = {"algo": "lokr", "dim": 8, "alpha": 4.0, "factor": 8,
               "targets": ["Transformer2DModel"]}
    cpu = torch.device("cpu")
    spec = unet_spec(sizes)
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    model = UNet2DConditionModel(UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                               for k, v in sizes.items()}, remat="transformer"),
                                 device="meta")
    model.load_state_dict(inputs.make_weights(spec, 3, torch.float32, cpu), assign=True)
    net = inputs.port_network(model, adapter, cpu)
    inputs.load_adapters(net, inputs.make_adapters(spec, adapter, 3, cpu)[0])
    trainer = DiffusionTrainer(model, net, weight_dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0))
    batch = inputs.unet_batches(sizes, {"pool_batches": 1, "batch": 2, "latent_hw": 16,
                                        "context_tokens": 77}, 3, torch.float32, cpu)[0]
    merged.applications = 0
    trainer.train_step(batch)
    remat = {**sizes, "remat": "transformer"}
    layers = [(shape, counts.unet_passes(remat, block, True)) for _, shape, block
              in inputs.adapted_layers(spec, adapter["targets"])]
    want = counts.census_launches(counts.with_adapter(
        counts.unet_census(remat, 2, 16, train=True),
        inputs.algo("lokr").census(layers, adapter, True)))
    assert calls == {k: want[k] for k in calls}
    assert merged.applications == want["factored"]
