"""LoKr factor 8 on an SDXL UNet and its two text encoders (counterpart of
``example/sdxl_finetune_example.py``): fine-tune the UNet adapters a few
steps, save the kohya file, merge, and run DDIM with the merged weights.

Synthetic weights (drawn from a seed) and latents. At full size: the SDXL
UNet in bf16 (``remat=True``) with CLIP-L and CLIP-G; ``--tiny``: the tiny
UNet and two tiny CLIPs, small enough for the CPU.

    python -m lycoris_tpu_torch.examples.sdxl_finetune_example [--tiny] [--device cpu]
"""

import argparse
import os
import tempfile

import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tiny", action="store_true", help="tiny models (a CPU smoke run)")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "sdxl_lokr.safetensors"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")

    from lycoris_tpu_torch.kohya import LycorisNetworkKohya, create_network
    from lycoris_tpu_torch.models import clip as C
    from lycoris_tpu_torch.models import unet as U
    from lycoris_tpu_torch.sampler import make_ddim_sampler
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.tiny:
        ucfg = U.tiny_unet_config()
        ccfgs = [C.tiny_clip_config(), C.tiny_clip_config()]
        latent_hw, ctx_len = 8, 6
    else:
        ucfg = U.sdxl_config(dtype=torch.bfloat16, remat=True)
        ccfgs = [C.clip_l_config(torch.bfloat16), C.clip_g_config(torch.bfloat16)]
        latent_hw, ctx_len = 128, 77
    dtype = ucfg.dtype
    unet = U.UNet2DConditionModel(ucfg, device=dev, param_dtype=dtype, generator=gen)
    # SDXL's two text encoders: CLIP-L and CLIP-G (tiny stand-ins with --tiny)
    tes = [C.CLIPTextModel(c, device=dev, param_dtype=c.dtype, generator=gen) for c in ccfgs]

    net = create_network(1.0, 8, 4.0, None, tes, unet, algo="lokr", factor=8,
                         preset="attn-mlp")
    LycorisNetworkKohya.reset_preset()
    net.apply_to(apply_text_encoder=True, apply_unet=True)
    print(f"UNet adapters: {len(net.unet_loras)}, TE adapters: {len(net.text_encoder_loras)}")

    # the text encoders with their adapters on a batch of token ids
    ids = torch.randint(0, ccfgs[0].vocab_size, (args.batch, ctx_len), generator=gen, device=dev)
    with torch.no_grad():
        hidden = [net.apply_text_encoder(i, ids) for i in range(len(tes))]
    print("text encoder outputs:", [tuple(h.shape) for h in hidden])

    # fine-tune the UNet adapters a few steps
    unet_sub = net.sub_networks[LycorisNetworkKohya.LORA_PREFIX_UNET]
    trainer = DiffusionTrainer(unet, unet_sub, lr=1e-4, weight_dtype=dtype,
                               generator=torch.Generator(device=dev).manual_seed(1))
    shape = (args.batch, 4, latent_hw, latent_hw)
    ctx = torch.randn(args.batch, ctx_len, ucfg.context_dim, generator=gen, device=dev).to(dtype)
    for _ in range(args.steps):
        batch = {"latents": torch.randn(shape, generator=gen, device=dev).to(dtype),
                 "context": ctx}
        loss = trainer.train_step(batch)
    print(f"trained {args.steps} steps, final loss {float(loss):.4f}")

    # save the adapter file (kohya format, sshs hash), merge, sample
    net.save_weights(args.out, dtype=torch.float16, metadata={})
    print(f"saved {args.out}")
    net.merge_to()
    sampler = make_ddim_sampler(lambda x, t, c: unet(x, t, c), num_inference_steps=4,
                                guidance_scale=1.0)
    x0 = torch.randn(shape, generator=gen, device=dev).to(dtype)
    img_latents = sampler(x0, ctx)
    print("merged-weight DDIM sample:", tuple(img_latents.shape),
          "finite:", bool(torch.isfinite(img_latents.float()).all()))


if __name__ == "__main__":
    main()
