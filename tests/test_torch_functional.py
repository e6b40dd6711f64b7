"""Port vs JAX package: the functional math, the modules' delta weights, the
preset tables, and the port's independence from JAX.

Inputs are drawn with numpy from a seed and fed to both packages on the
CPU. Tolerance: fp32 atol/rtol 1e-5 per op (the ROADMAP's parity bound).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lycoris_tpu import config as jax_config
from lycoris_tpu.functional import general as jg
from lycoris_tpu.functional import loha as jloha
from lycoris_tpu.functional import lokr as jlokr
from lycoris_tpu_torch import config as t_config
from lycoris_tpu_torch.functional import general as tg
from lycoris_tpu_torch.functional import loha as tloha
from lycoris_tpu_torch.functional import lokr as tlokr

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **(tol or TOL))


def test_factorization_tables_equal():
    for dim in list(range(1, 400)) + [640, 768, 1280, 2560, 5120, 10240]:
        for factor in (-1, 1, 2, 3, 4, 8, 16, 32):
            assert tg.factorization(dim, factor) == jg.factorization(dim, factor), (dim, factor)
            assert tg.power2factorization(dim, factor) == jg.power2factorization(dim, factor)


def test_make_kron_and_lokr_diff_weight():
    rng = np.random.default_rng(0)
    w1, w2 = _rand(rng, 4, 8), _rand(rng, 16, 10)
    _close(tlokr.make_kron(torch.from_numpy(w1), torch.from_numpy(w2), 0.5),
           jlokr.make_kron(jnp.asarray(w1), jnp.asarray(w2), 0.5))
    # conv-shaped w2 (spatial dims broadcast over w1)
    w2c = _rand(rng, 16, 10, 3, 3)
    _close(tlokr.make_kron(torch.from_numpy(w1), torch.from_numpy(w2c), 2.0),
           jlokr.make_kron(jnp.asarray(w1), jnp.asarray(w2c), 2.0))
    # w1 full, w2 LoRA pair
    w2a, w2b = _rand(rng, 16, 4), _rand(rng, 4, 10)
    args = (w1, None, None, None, w2a, w2b, None)
    _close(tlokr.diff_weight(*[None if a is None else torch.from_numpy(a) for a in args], gamma=3.0),
           jlokr.diff_weight(*[None if a is None else jnp.asarray(a) for a in args], gamma=3.0))


def test_loha_diff_weight():
    rng = np.random.default_rng(1)
    o, i, r = 64, 160, 8
    w1d, w1u, w2d, w2u = _rand(rng, r, i), _rand(rng, o, r, std=0.1), _rand(rng, r, i), _rand(rng, o, r, std=0.1)
    args = (w1d, w1u, w2d, w2u, None, None)
    _close(tloha.diff_weight(*[None if a is None else torch.from_numpy(a) for a in args], gamma=0.5),
           jloha.diff_weight(*[None if a is None else jnp.asarray(a) for a in args], gamma=0.5))


@pytest.mark.parametrize("use_w2", [False, True])
def test_lokr_bypass_matches(use_w2):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 5, 32)
    w1 = _rand(rng, 4, 4)
    if use_w2:
        weights = (w1, None, None, _rand(rng, 8, 8), None, None, None)
    else:
        weights = (w1, None, None, None, _rand(rng, 8, 2), _rand(rng, 2, 8), None)
    got = tlokr.bypass_diff_with_scale(
        torch.from_numpy(x), *[None if w is None else torch.from_numpy(w) for w in weights], scale=0.7)
    want = jlokr.bypass_diff_with_scale(
        jnp.asarray(x), *[None if w is None else jnp.asarray(w) for w in weights], scale=0.7)
    _close(got, want)


def test_linear_and_head_split():
    rng = np.random.default_rng(3)
    x, w, b = _rand(rng, 2, 7, 24), _rand(rng, 16, 24), _rand(rng, 16)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    _close(tg.linear(tx, tw, tb), jg.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tg.linear_head_split(tx, tw, tb, 4, 4)
    assert got.shape == (2, 4, 7, 4)
    _close(got, jg.linear_head_split(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4, 4))


@pytest.mark.parametrize(
    "kw", [dict(stride=1, padding=1), dict(stride=2, padding=1), dict(stride=1, padding=0, groups=2)]
)
def test_convnd(kw):
    rng = np.random.default_rng(4)
    g = kw.get("groups", 1)
    x, w, b = _rand(rng, 2, 8, 9, 9), _rand(rng, 6, 8 // g, 3, 3), _rand(rng, 6)
    _close(tg.convnd(*map(torch.from_numpy, (x, w, b)), **kw),
           jg.convnd(*map(jnp.asarray, (x, w, b)), **kw), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape", [(2, 16, 6, 6), (3, 16, 5), (2, 16)])
def test_group_norm_act(shape, act):
    rng = np.random.default_rng(5)
    x = _rand(rng, *shape, std=2.0) + 0.3
    w, b = _rand(rng, 16) + 1.0, _rand(rng, 16)
    _close(tg.group_norm_act(*map(torch.from_numpy, (x,)), 4, torch.from_numpy(w),
                             torch.from_numpy(b), 1e-6, act=act),
           jg.group_norm_act(jnp.asarray(x), 4, jnp.asarray(w), jnp.asarray(b), 1e-6, act=act))


def test_geglu_tanh_gelu():
    rng = np.random.default_rng(6)
    h = _rand(rng, 2, 5, 32, std=2.0)
    _close(tg.geglu_mul(torch.from_numpy(h)), jg.geglu_mul(jnp.asarray(h)))


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm(with_bias):
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 9, 48, std=3.0) + 1.0
    w, b = _rand(rng, 48) + 1.0, _rand(rng, 48) if with_bias else None
    _close(tg.layer_norm(torch.from_numpy(x), 48, torch.from_numpy(w),
                         None if b is None else torch.from_numpy(b)),
           jg.layer_norm(jnp.asarray(x), 48, jnp.asarray(w), None if b is None else jnp.asarray(b)))


def test_rebuild_tucker():
    rng = np.random.default_rng(8)
    t, wa, wb = _rand(rng, 4, 4, 3, 3), _rand(rng, 4, 6), _rand(rng, 4, 5)
    _close(tg.rebuild_tucker(*map(torch.from_numpy, (t, wa, wb))),
           jg.rebuild_tucker(*map(jnp.asarray, (t, wa, wb))))


def test_kaiming_uniform_bound():
    g = torch.Generator().manual_seed(0)
    w = tg.kaiming_uniform((64, 32, 3, 3), generator=g)
    bound = np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / (32 * 9))
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound


def test_preset_tables_equal():
    assert t_config.PRESET == jax_config.PRESET


def test_port_never_imports_jax():
    code = (
        "import sys, lycoris_tpu_torch, lycoris_tpu_torch.sampler, lycoris_tpu_torch.models.unet, "
        "lycoris_tpu_torch.ops.attention, lycoris_tpu_torch.ops.flash, lycoris_tpu_torch.ops.hada, "
        "lycoris_tpu_torch.ops.layer_norm, lycoris_tpu_torch.ops._build, lycoris_tpu_torch.trainer, "
        "lycoris_tpu_torch.ops.lora_fused, lycoris_tpu_torch.modules.locon, "
        "lycoris_tpu_torch.functional.merged, chip_smoke, profile_train; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'lycoris_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
