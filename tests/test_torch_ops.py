"""The port's kernel modules: each plain version against the JAX kernel it
replaces, run as the JAX package's own tests run it on the CPU (Pallas in
interpret mode), and the attention dispatch rule. The kernels themselves are
tested on the card by test_torch_kernels_cuda.py.

Tolerance: fp32 atol/rtol 1e-5 against the JAX kernels (summation order
differs).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lycoris_tpu.ops import flash as jflash
from lycoris_tpu_torch.ops import attention as tattn
from lycoris_tpu_torch.ops import flash as tflash
from lycoris_tpu_torch.ops import hada as thada
from lycoris_tpu_torch.ops import layer_norm as tln

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Force pallas_call into interpreter mode for CPU testing."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def test_flash_plain_matches_jax_kernel(monkeypatch):
    monkeypatch.setattr(jflash, "_INTERPRET", True)
    rng = np.random.default_rng(0)
    shape = (1, 2, 1024, 40)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    sm = 1.0 / 40**0.5
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm, 256, 256)
    _, want_lse = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm, 256, 256)
    got, lse = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)), sm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("shape", [(64, 320), (32, 640), (16, 1280)])
def test_layer_norm_plain_matches_jax_kernel(interpret_pallas, shape):
    from lycoris_tpu.ops import layer_norm as jln

    rng = np.random.default_rng(1)
    x = _rand(rng, *shape, std=2.0) + 0.5
    w, b = _rand(rng, shape[1]) + 1.0, _rand(rng, shape[1])
    want = jln._fwd_call(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = tln.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(64, 256, 8), (64, 320, 8), (128, 768, 4)])
def test_hada_plain_matches_jax_kernel(interpret_pallas, shape):
    from lycoris_tpu.ops import hada as jhada

    o, i, r = shape
    rng = np.random.default_rng(2)
    ws = [_rand(rng, r, i), _rand(rng, o, r, std=0.1), _rand(rng, r, i), _rand(rng, o, r, std=0.1)]
    want = jhada.hada_weight_pallas(*map(jnp.asarray, ws), 0.5)
    got = thada.hada_weight(*map(torch.from_numpy, ws), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "tq,tk,d,want",
    [
        (4096, 4096, 40, True),   # SD1.5 level 0 self-attention
        (1024, 1024, 80, True),   # SD1.5 level 1
        (1536, 1536, 64, True),   # T >= 1024 is enough
        (4096, 77, 40, False),    # cross-attention
        (256, 256, 160, False),   # SD1.5 level 2 (short, D > 128)
        (64, 64, 160, False),     # mid block
        (2048, 2048, 160, False),  # D > 128
        (1000, 1000, 64, False),  # under 1024
        (14040, 14040, 128, True),  # Wan 480p x 33 frames: no multiple of any tile
    ],
)
def test_attention_dispatch_rule(tq, tk, d, want):
    assert tattn.use_flash(tq, tk, d) is want


def test_attention_dispatch_routes_through_flash(monkeypatch):
    calls = []
    real = tflash.flash_attention

    def spy(q, k, v, sm):
        calls.append(q.shape)
        return real(q, k, v, sm)

    monkeypatch.setattr(tflash, "flash_attention", spy)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 1024, 40, generator=g)
    ctx = torch.randn(1, 2, 77, 40, generator=g)
    o = tattn.dot_product_attention(q, q, q, layout="BHTD")
    assert calls == [(1, 2, 1024, 40)] and o.shape == (1, 1024, 2, 40)
    o2 = tattn.dot_product_attention(q, ctx, ctx, layout="BHTD")
    assert len(calls) == 1 and o2.shape == (1, 1024, 2, 40)
    # both routes compute the same function
    want = tattn.attention_plain(q, q, q, 1 / 40**0.5).transpose(1, 2)
    np.testing.assert_allclose(o.numpy(), want.numpy(), **TOL)


def _ln_path_shapes(model: str, batch: int, hw: int):
    """(rows, C) of every LayerNorm of one UNet call, from chip_smoke's
    census of the UNet config."""
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    from lycoris_tpu_torch.models.unet import sd15_config, sdxl_config

    cfg = sd15_config() if model == "sd15" else sdxl_config()
    return sorted(chip_smoke.path_shapes(cfg, batch, hw)["ln"])


def _ln_rows_per_block(plan) -> int:
    return plan.warps * (32 // plan.lanes if plan.lanes else 1)


@pytest.mark.parametrize("model,batch,hw", [("sd15", 4, 64), ("sd15", 8, 64), ("sdxl", 4, 128)])
def test_layer_norm_fwd_plan_at_path_shapes(model, batch, hw):
    """The forward's plan at every LayerNorm shape of SD1.5 serving (b4) and
    training (b8) and SDXL training (b4): the vectorised variant at every
    width in bf16 (fp32 too, but at C = 1280), 5 vectors a lane; blocks of
    1-8 warps over a grid that covers every row with no idle block and
    reaches every one of the card's 132 SMs; the generic variant when a
    tensor is not 16-byte aligned."""
    shapes = _ln_path_shapes(model, batch, hw)
    assert shapes and {c for _, c in shapes} <= {320, 640, 1280}
    for rows, c in shapes:
        for es in (2, 4):
            plan = tln.fwd_plan(rows, c, es)
            vec = es == 2 or c != 1280
            assert (plan.lanes > 0) == vec, (rows, c, es)
            if vec:
                assert plan.lanes == tln.vec_lanes(c, es) and c * es == 16 * tln.VECS * plan.lanes
                assert 1 <= plan.warps <= tln.MAX_WARPS and plan.grid >= 132, (rows, c, plan)
            else:
                assert plan.warps == tln.GENERIC_WARPS
            rpb = _ln_rows_per_block(plan)
            assert (plan.grid - 1) * rpb < rows <= plan.grid * rpb, (rows, c, plan)
            assert tln.fwd_plan(rows, c, es, aligned=False) == (
                0, tln.GENERIC_WARPS, -(-rows // tln.GENERIC_WARPS))


@pytest.mark.parametrize("c,es,lanes", [(768, 2, 0), (1280, 2, 32), (768, 4, 0), (1280, 4, 0)])
def test_layer_norm_fwd_plan_at_clip_shapes(c, es, lanes):
    """The CLIP encoders' LayerNorms at b4 x 77 tokens: CLIP-G's C = 1280
    takes the vectorised variant in bf16 (32 lanes, one-warp blocks, a
    block a row group); CLIP-L's C = 768 is no multiple of 40 bf16 values
    (``VECS`` 16-byte vectors a lane) and takes the generic one, as fp32
    does at both widths."""
    rows = 4 * 77
    plan = tln.fwd_plan(rows, c, es)
    assert plan.lanes == lanes == tln.vec_lanes(c, es)
    if lanes:
        assert plan == (32, 1, rows)
    else:
        assert plan == (0, tln.GENERIC_WARPS, rows // tln.GENERIC_WARPS)
    rpb = _ln_rows_per_block(plan)
    assert (plan.grid - 1) * rpb < rows <= plan.grid * rpb


def test_layer_norm_fwd_plan_small_and_odd():
    """SD1.5's smallest shapes spread over the SMs with one-warp blocks
    (256 rows of C = 1280: 256 blocks, not 64 four-warp ones); the largest
    keep bigger blocks; C = 100 and fp32 C = 1280 take the generic variant;
    ragged rows are covered."""
    assert tln.fwd_plan(256, 1280, 2) == (32, 1, 256)
    assert tln.fwd_plan(1024, 1280, 2) == (32, 1, 1024)
    assert tln.fwd_plan(16384, 320, 2) == (8, 2, 2048)
    assert tln.fwd_plan(16384, 640, 2) == (16, 4, 2048)
    assert tln.fwd_plan(4096, 1280, 2) == (32, 2, 2048)
    assert tln.fwd_plan(256, 1280, 2, sms=16) == (32, 2, 128)  # fewer SMs, larger blocks
    for rows, c, es in ((7, 100, 2), (7, 100, 4), (256, 1280, 4), (1000, 2000, 2)):
        assert tln.fwd_plan(rows, c, es) == (0, 4, -(-rows // 4)), (rows, c, es)
    for rows, c in ((7, 320), (1001, 640), (33, 1280), (3 * 10**6, 320)):
        plan = tln.fwd_plan(rows, c, 2)
        rpb = _ln_rows_per_block(plan)
        assert plan.lanes and (plan.grid - 1) * rpb < rows <= plan.grid * rpb, (rows, c, plan)


def test_cpu_wrappers_use_plain_and_count_nothing():
    before = (tflash.launches, tln.launches, tln.fwd_vec_launches, tln.fwd_generic_launches,
              thada.launches)
    x = torch.randn(8, 320)
    tln.layer_norm(x, torch.ones(320), torch.zeros(320), 1e-5)
    thada.hada_weight(torch.randn(4, 128), torch.randn(16, 4), torch.randn(4, 128), torch.randn(16, 4))
    q = torch.randn(1, 1, 1024, 16)
    tflash.flash_attention(q, q, q, 0.25)
    assert (tflash.launches, tln.launches, tln.fwd_vec_launches, tln.fwd_generic_launches,
            thada.launches) == before
