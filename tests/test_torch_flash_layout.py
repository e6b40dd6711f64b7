"""The flash wrapper's layout code, on the CPU: which inputs the bf16
kernels' TMA reads in place, and the zero-padded copy made for the others.

- ``needs_pad`` is False for every self-attention that the UNets route to
  the flash kernel: q, k, v are built on the meta device by the port's own
  head-split projection (``linear_head_split``), at the shapes of
  ``sd15_config()`` and ``sdxl_config()``, so no UNet path pays a copy.
- ``pad_head_dim``'s output, fed to the plain version with the true-D
  scale, equals the unpadded result (fp32, 1e-6: the padded columns are
  zeros, so only the summation may differ), and matches the JAX flash
  kernel in interpret mode (1e-5, as tests/test_torch_ops.py holds it).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lycoris_tpu.ops import flash as jflash
from lycoris_tpu_torch.functional.general import linear_head_split
from lycoris_tpu_torch.models.unet import sd15_config, sdxl_config
from lycoris_tpu_torch.ops import flash as tflash
from lycoris_tpu_torch.ops.attention import use_flash


def _self_attentions(cfg, hw):
    """(channels, tokens, heads, head_dim) of each Transformer2DModel level
    whose self-attention takes the flash kernel."""
    chs = cfg.block_out_channels
    levels = {(ch, (hw >> i) ** 2) for i, ch in enumerate(chs) if cfg.transformer_depth[i]}
    if cfg.mid_transformer_depth:
        levels.add((chs[-1], (hw >> (len(chs) - 1)) ** 2))
    out = []
    for ch, t in sorted(levels):
        heads = ch // cfg.head_dim if cfg.head_dim else cfg.num_heads
        if use_flash(t, t, ch // heads):
            out.append((ch, t, heads, ch // heads))
    return out


@pytest.mark.parametrize("name,cfg,batch,hw", [
    ("sd15 serving", sd15_config(), 4, 64),
    ("sd15 training", sd15_config(), 8, 64),
    ("sdxl training", sdxl_config(), 4, 128),
])
def test_unet_self_attention_needs_no_pad(name, cfg, batch, hw):
    levels = _self_attentions(cfg, hw)
    # SD1.5: D40 at T4096 and D80 at T1024; SDXL: D64 at T4096 and T1024
    assert [(t, d) for _, t, _, d in levels] == (
        [(4096, 40), (1024, 80)] if "sd15" in name else [(4096, 64), (1024, 64)])
    for ch, t, heads, d in levels:
        x = torch.empty(batch, t, ch, dtype=torch.bfloat16, device="meta")
        w = torch.empty(ch, ch, dtype=torch.bfloat16, device="meta")
        q = linear_head_split(x, w, None, heads, d)
        assert q.shape == (batch, heads, t, d)
        assert not tflash.needs_pad(q), (name, q.shape, q.stride())
        # the output buffer and a (B, H, T, D)-contiguous cotangent too
        assert not tflash.needs_pad(tflash._bthd_empty(q))
        assert not tflash.needs_pad(torch.empty(q.shape, dtype=q.dtype, device="meta"))


def test_needs_pad_cases():
    base = torch.empty(2, 100, 4 * 40, dtype=torch.bfloat16, device="meta")
    q = base.unflatten(-1, (4, 40)).transpose(1, 2)
    assert not tflash.needs_pad(q)
    assert tflash.needs_pad(torch.empty(2, 4, 100, 100, dtype=torch.bfloat16, device="meta"))
    # a token stride of 4 * 36 = 144 elements is fine, a head offset of 36 is not
    odd = torch.empty(2, 100, 4 * 36, dtype=torch.bfloat16, device="meta")
    assert tflash.needs_pad(odd.unflatten(-1, (4, 36)).transpose(1, 2))
    # a base 8 bytes off 16-byte alignment
    flat = torch.empty(4 + 2 * 100 * 160, dtype=torch.bfloat16, device="meta")
    assert tflash.needs_pad(flat[4:].view(2, 100, 4, 40).transpose(1, 2))
    assert tflash.needs_pad(base[:, :, 1:41].unflatten(-1, (1, 40)).transpose(1, 2))
    assert tflash.needs_pad(q.transpose(-1, -2)[..., :40, :40])
    # an extent-1 dimension's stride is never used
    one = torch.empty(1, 1, 7, 48, dtype=torch.bfloat16, device="meta")
    assert not tflash.needs_pad(one.as_strided((1, 1, 7, 48), (3, 5, 48, 1)))


@pytest.mark.parametrize("d", [20, 100])
def test_pad_head_dim_keeps_the_result(d):
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.standard_normal((2, 3, 37, d)), dtype=torch.float32)
               for _ in range(3))
    sm = d**-0.5
    n = tflash.pad_copies
    padded = [tflash.pad_head_dim(x) for x in (q, k, v)]
    assert tflash.pad_copies == n + 3
    dp = -(-d // 8) * 8
    for x, p in zip((q, k, v), padded):
        assert p.shape == (2, 3, 37, dp) and p.stride() == (37 * 3 * dp, dp, 3 * dp, 1)
        assert torch.equal(p[..., :d], x) and not p[..., d:].any()
        assert not tflash.needs_pad(p.to(torch.bfloat16))
    want, want_lse = tflash.flash_attention_plain(q, k, v, sm)
    got, lse = tflash.flash_attention_plain(*padded, sm)
    torch.testing.assert_close(got[..., :d], want, atol=1e-6, rtol=1e-6)
    assert not got[..., d:].any()
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)


def test_pad_head_dim_matches_jax_kernel(monkeypatch):
    monkeypatch.setattr(jflash, "_INTERPRET", True)
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, 256, 20)).astype(np.float32) for _ in range(3))
    sm = 20**-0.5
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm, 128, 128)
    padded = [tflash.pad_head_dim(torch.tensor(x)) for x in (q, k, v)]
    got, _ = tflash.flash_attention_plain(*padded, sm)
    np.testing.assert_allclose(got[..., :20].numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
