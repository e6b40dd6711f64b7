"""The port's kernel modules: each plain version against the JAX kernel it
replaces, run as the JAX package's own tests run it on the CPU (Pallas in
interpret mode), and the attention dispatch rule. The kernels themselves are
tested on the card by test_torch_kernels_cuda.py.

Tolerance: fp32 atol/rtol 1e-5 against the JAX kernels (summation order
differs).
"""

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
        (1536, 1536, 64, True),   # T % 512 == 0 is enough
        (4096, 77, 40, False),    # cross-attention
        (256, 256, 160, False),   # SD1.5 level 2 (short, D > 128)
        (64, 64, 160, False),     # mid block
        (2048, 2048, 160, False),  # D > 128
        (1000, 1000, 64, False),  # not a multiple of 512
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


def test_cpu_wrappers_use_plain_and_count_nothing():
    before = (tflash.launches, tln.launches, thada.launches)
    x = torch.randn(8, 320)
    tln.layer_norm(x, torch.ones(320), torch.zeros(320), 1e-5)
    thada.hada_weight(torch.randn(4, 128), torch.randn(16, 4), torch.randn(4, 128), torch.randn(16, 4))
    q = torch.randn(1, 1, 1024, 16)
    tflash.flash_attention(q, q, q, 0.25)
    assert (tflash.launches, tln.launches, thada.launches) == before
