"""DDIM sampling with classifier-free guidance -- the serving side of the
fine-tune loop (counterpart of ``lycoris_tpu/sampler.py`` and of
``lycoris_tpu.trainer.ddpm_alphas_cumprod``).

The UNet runs with live adapters (``LycorisNetwork.apply_to``) or with
merged weights (``LycorisNetwork.merge_to``); either way the sampler only
sees ``apply_fn(x, t, ctx) -> eps``. The loop is a Python loop under
``torch.no_grad``; CFG batches (uncond, cond) so the UNet runs once per step.
"""

from __future__ import annotations

import numpy as np
import torch


def ddpm_alphas_cumprod(num_steps: int = 1000, beta_start=0.00085, beta_end=0.012):
    """Scaled-linear beta schedule (kohya SD default) as a float32 numpy array."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_steps, dtype=np.float32) ** 2
    return np.cumprod((1.0 - betas).astype(np.float32), dtype=np.float32)


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000):
    step = num_train_timesteps // num_inference_steps
    return (np.arange(num_inference_steps) * step + 1)[::-1].copy()


def make_ddim_sampler(apply_fn, num_inference_steps: int = 20, num_train_timesteps: int = 1000,
                      guidance_scale: float = 7.5, eta: float = 0.0):
    """Build ``sample(latents, ctx, uncond_ctx=None) -> latents``.

    ``apply_fn(x, t, ctx)`` is the eps-prediction UNet. With ``uncond_ctx``
    the batch is (uncond, cond) and eps = eps_u + g * (eps_c - eps_u). The
    latents are cast back to their dtype after every step."""
    alphas_cumprod = ddpm_alphas_cumprod(num_train_timesteps)
    timesteps = ddim_timesteps(num_inference_steps, num_train_timesteps)
    one = np.float32(1.0)

    @torch.no_grad()
    def sample(latents, ctx, uncond_ctx=None):
        do_cfg = uncond_ctx is not None
        ctx_all = torch.cat([uncond_ctx, ctx], dim=0) if do_cfg else ctx
        x = latents
        for i in range(num_inference_steps):
            t = int(timesteps[i])
            t_prev = int(timesteps[i + 1]) if i + 1 < num_inference_steps else 0
            a_t = alphas_cumprod[t]
            a_prev = alphas_cumprod[t_prev] if t_prev > 0 else one
            x_in = torch.cat([x, x], dim=0) if do_cfg else x
            t_in = torch.full((x_in.shape[0],), t, dtype=torch.int32, device=x.device)
            eps = apply_fn(x_in, t_in, ctx_all).float()
            if do_cfg:
                eps_u, eps_c = eps.chunk(2, dim=0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            x32 = x.float()
            x0 = (x32 - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
            dir_xt = float(np.sqrt(one - a_prev - np.float32(eta**2) * (one - a_t))) * eps
            x = (float(np.sqrt(a_prev)) * x0 + dir_xt).to(latents.dtype)
        return x

    return sample
