"""The port's backward math on the CPU against the JAX package: each plain
backward against the Pallas backward kernel it stands beside (interpret
mode; the LoHa fused1 and split forms, the fused LoRA matmul), the autograd
Functions against autograd of the plain forwards, the LoHa custom-vjp
Functions, and the factored merged cotangents (``functional/merged.py``,
``LokrModule.factored_merged_fns``).

Inputs are drawn with numpy from a seed and fed to both packages.
Tolerance: fp32 atol/rtol 1e-5 per op (summation order differs), 2e-4
relative for gradients that sum over many tokens or go through a chain of
small contractions (as the JAX package's own factored-grad tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lycoris_tpu.functional import loha as jloha
from lycoris_tpu.functional import merged as jmerged
from lycoris_tpu.ops import flash as jflash
from lycoris_tpu_torch.functional import loha as tloha
from lycoris_tpu_torch.functional import merged as tmerged
from lycoris_tpu_torch.functional.general import linear, linear_head_split
from lycoris_tpu_torch.modules import LayerInfo, LokrModule
from lycoris_tpu_torch.ops import flash as tflash
from lycoris_tpu_torch.ops import hada as thada
from lycoris_tpu_torch.ops import layer_norm as tln
from lycoris_tpu_torch.ops import lora_fused as tlf

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=2e-4)


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


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# plain backwards against the JAX backward kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,d", [(1024, 40), (512, 80)])
def test_flash_bwd_plain_matches_jax_kernel(monkeypatch, t, d):
    monkeypatch.setattr(jflash, "_INTERPRET", True)
    rng = np.random.default_rng(0)
    q, k, v, do = (_rand(rng, 1, 2, t, d) for _ in range(4))
    sm = 1.0 / d**0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jflash._flash_fwd(jq, jk, jv, sm, 256, 256)
    want = jflash._bwd_from_res((jq, jk, jv, o, lse), jdo, sm, 256, 256, None, None)
    got = tflash.flash_attention_bwd_plain(
        *_t(q, k, v), torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), sm)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("shape", [(64, 320), (32, 640), (16, 1280)])
def test_layer_norm_bwd_plain_matches_jax_kernel(interpret_pallas, shape):
    from lycoris_tpu.ops import layer_norm as jln

    rng = np.random.default_rng(1)
    x = _rand(rng, *shape, std=2.0) + 0.5
    w = _rand(rng, shape[1]) + 1.0
    dy = _rand(rng, *shape)
    want = jln._vjp_bwd(1e-5, (jnp.asarray(x), jnp.asarray(w)), jnp.asarray(dy))
    got = tln.layer_norm_bwd_plain(*_t(x, w, dy), 1e-5)
    for a, b in zip(got, want):
        _close(a, b, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 256, 8), (256, 640, 8), (128, 768, 4), (16, 128, 128)])
def test_hada_bwd_plain_matches_jax_fused1(interpret_pallas, shape):
    from lycoris_tpu.ops import hada as jhada

    o, i, r = shape
    rng = np.random.default_rng(2)
    ws = [_rand(rng, r, i), _rand(rng, o, r, std=0.1), _rand(rng, r, i), _rand(rng, o, r, std=0.1)]
    g = _rand(rng, o, i)
    want = jhada._hada_bwd_fused1(*map(jnp.asarray, ws), 0.5, jnp.asarray(g), interpret=True)
    got = thada.hada_weight_bwd_plain(*_t(*ws), 0.5, torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a, b, atol=1e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", [(64, 256, 8), (128, 384, 4), (64, 320, 8)])
def test_hada_bwd_split_plain_matches_jax_split(interpret_pallas, monkeypatch, shape):
    """The split plain backward against ``_hada_bwd_pallas`` with
    ``LYCORIS_TPU_HADA_BWD=split`` (the u- and d-kernels), and the port's
    Function following ``ops.hada.BWD`` on the CPU."""
    from lycoris_tpu.ops import hada as jhada

    monkeypatch.setenv("LYCORIS_TPU_HADA_BWD", "split")
    o, i, r = shape
    rng = np.random.default_rng(9)
    ws = [_rand(rng, r, i), _rand(rng, o, r, std=0.1), _rand(rng, r, i), _rand(rng, o, r, std=0.1)]
    g = _rand(rng, o, i)
    want = jhada._hada_bwd_pallas(*map(jnp.asarray, ws), 0.5, jnp.asarray(g))
    got = thada.hada_weight_bwd_split_plain(*(torch.tensor(w) for w in ws), 0.5, torch.tensor(g))
    for a, b in zip(got, want):
        _close(a, b, atol=1e-5, rtol=2e-5)
    monkeypatch.setattr(thada, "BWD", "split")
    grads = _grads(lambda *z: thada.hada_weight(*z, 0.5), [torch.tensor(w) for w in ws],
                   torch.tensor(g))
    for a, b in zip(grads, want):
        _close(a, b, atol=1e-5, rtol=2e-5)
    monkeypatch.setattr(thada, "BWD", "fused")
    with pytest.raises(ValueError, match="fused1"):
        thada.hada_weight_bwd(*(torch.tensor(w) for w in ws), 0.5, torch.tensor(g))


# the shapes of the JAX package's own test (tests/test_ops.py): K = 4096 and
# N = 2560 tile the contraction of the nt and the nn kernel in two steps;
# and rank 320, which the card's kernels take a chunk of ranks at a time
@pytest.mark.parametrize("shape", [(64, 256, 384, 8), (32, 128, 512, 4), (16, 128, 4096, 8),
                                   (16, 2560, 256, 8), (16, 128, 256, 320)])
def test_fused_lora_matmul_matches_jax(interpret_pallas, shape):
    """The port's op (plain versions on the CPU) against the JAX custom_vjp
    (Pallas interpret mode): y and the gradients of x, down and up.
    Tolerance: 1e-5 of the largest magnitude (fp32; K up to 4096 terms)."""
    from lycoris_tpu.ops import lora_fused as jlf

    m, n, k, r = shape
    rng = np.random.default_rng(10)
    x, w, down, up = _rand(rng, m, k), _rand(rng, n, k), _rand(rng, r, k), _rand(rng, n, r)
    g = _rand(rng, m, n)
    jx, jw, jd, ju, jg = map(jnp.asarray, (x, w, down, up, g))
    import jax

    want_y = jlf.fused_lora_matmul(jx, jw, jd, ju, 0.25)
    want = jax.grad(lambda *a: jnp.sum(jlf.fused_lora_matmul(a[0], jw, a[1], a[2], 0.25) * jg),
                    argnums=(0, 1, 2))(jx, jd, ju)
    leaves = [torch.tensor(v).requires_grad_(True) for v in (x, down, up)]
    y = tlf.fused_lora_matmul(leaves[0], torch.tensor(w), leaves[1], leaves[2], 0.25)
    got = torch.autograd.grad((y * torch.tensor(g)).sum(), leaves)
    assert tlf.supported(x.shape, w.shape)
    for a, b in zip((y, *got), (want_y, *want)):
        b = np.asarray(b)
        _close(a, b, atol=1e-5 * float(np.abs(b).max()), rtol=1e-5)


def test_fused_lora_supported_keeps_the_jax_minimums():
    from lycoris_tpu.ops import lora_fused as jlf

    for xs, ws in (((8, 128), (128, 128)), ((7, 128), (128, 128)), ((2, 4, 320), (127, 320)),
                   ((616, 768), (320, 768)), ((8, 100), (256, 100))):
        assert tlf.supported(xs, ws) == (np.prod(xs[:-1]) >= 8 and ws[0] >= 128 and ws[1] >= 128)
    # where the TPU tiles divide, the two gates agree
    assert tlf.supported((64, 384), (256, 384)) and jlf.supported((64, 384), (256, 384))


def test_fused_lora_variant_choice():
    """The wrapper's choice of kernel variant, made in Python: the fast one
    for bf16 activations with a bf16 W whose N and K are multiples of 8 and
    whose data is 16-byte aligned (read by TMA), the generic one otherwise."""
    bf = torch.bfloat16

    def case(m, n, k, adt, wdt, offset=0):
        x = torch.zeros(m * k + offset, dtype=adt)[offset:].view(m, k)
        return tlf.variant(x, torch.zeros(n, k, dtype=wdt))

    assert case(308, 1280, 2048, bf, bf) == "fast"
    assert case(37, 136, 200, bf, bf) == "fast"
    assert case(37, 130, 200, bf, bf) == "generic"  # N % 8
    assert case(37, 136, 196, bf, bf) == "generic"  # K % 8
    assert case(64, 128, 256, bf, bf, offset=1) == "generic"  # x 2 bytes off 16
    assert case(64, 128, 256, torch.float32, torch.float32) == "generic"
    assert case(64, 128, 256, bf, torch.float32) == "generic"
    assert case(64, 128, 256, torch.float32, bf) == "generic"


# (M, N, K) of the LoRA linear layers of the SDXL b4 and SD1.5 b8 legs
# (chip_smoke.path_shapes), and a ragged one
LORA_PATH_SHAPES = ((16384, 640, 640), (308, 640, 2048), (16384, 5120, 640), (16384, 640, 2560),
                    (4096, 1280, 1280), (308, 1280, 2048), (4096, 10240, 1280),
                    (4096, 1280, 5120), (32768, 320, 320), (616, 320, 768), (32768, 2560, 320),
                    (32768, 320, 1280), (8192, 640, 640), (616, 640, 768), (8192, 5120, 640),
                    (8192, 640, 2560), (2048, 1280, 1280), (616, 1280, 768),
                    (2048, 10240, 1280), (2048, 1280, 5120), (512, 1280, 1280),
                    (512, 10240, 1280), (512, 1280, 5120), (37, 136, 200))


def test_fused_lora_fast_plan():
    """The fast kernel's tile height, grid and contraction slices, both
    directions of every path shape on a 132-SM card: 128 or 256 rows, at
    most one block an SM, no empty slice, each slice at least the minimum
    depth; the attn2 k/v layers (M = batch x 77), whose output tiles leave
    most SMs idle, are sliced, and every layer whose tiles fill the card is
    not."""
    sms, bp, bc = 132, tlf._FAST_BP, tlf._FAST_BC
    for m, n, k in LORA_PATH_SHAPES:
        for p, c in ((n, k), (k, n)):  # nt, nn
            bm, splits, grid = tlf.fast_plan(m, p, c, sms)
            tiles = -(-m // bm) * -(-p // bp)
            steps = -(-c // bc)
            cps = -(-steps // splits)
            assert bm in (128, 256) and 1 <= splits <= tlf._MAX_SPLITS
            assert grid == min(tiles * splits, sms)
            assert (splits - 1) * cps < steps  # the last slice is not empty
            assert splits == 1 or cps >= tlf._MIN_SLICE
            if tiles >= sms:
                assert splits == 1
            if tiles * 2 <= sms and steps >= 2 * tlf._MIN_SLICE:
                assert splits > 1, (m, p, c)
    assert tlf.fast_plan(308, 1280, 2048, sms) == (128, 4, 120)
    assert tlf.fast_plan(4096, 1280, 1280, sms) == (256, 1, 132)


# ---------------------------------------------------------------------------
# autograd Functions on the CPU (plain both ways) against autograd of the
# plain forwards
# ---------------------------------------------------------------------------


def _grads(fn, inputs, ct):
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    return torch.autograd.grad((out * ct).sum(), leaves)


def test_functions_match_autograd_of_plain():
    g = torch.Generator().manual_seed(0)
    x, w, b = torch.randn(40, 96, generator=g), torch.randn(96, generator=g), torch.randn(96, generator=g)
    ct = torch.randn(40, 96, generator=g)
    for a, c in zip(_grads(lambda *z: tln.layer_norm(*z, 1e-5), (x, w, b), ct),
                    _grads(lambda *z: tln.layer_norm_plain(*z, 1e-5), (x, w, b), ct)):
        _close(a, c.numpy())

    q, k, v = (torch.randn(1, 2, 128, 16, generator=g) for _ in range(3))
    ct = torch.randn(1, 2, 128, 16, generator=g)
    for a, c in zip(_grads(lambda *z: tflash.flash_attention(*z, 0.25)[0], (q, k, v), ct),
                    _grads(lambda *z: tflash.flash_attention_plain(*z, 0.25)[0], (q, k, v), ct)):
        _close(a, c.numpy())

    ws = (torch.randn(4, 130, generator=g), torch.randn(24, 4, generator=g),
          torch.randn(4, 130, generator=g), torch.randn(24, 4, generator=g))
    ct = torch.randn(24, 130, generator=g)
    for a, c in zip(_grads(lambda *z: thada.hada_weight(*z, 0.5), ws, ct),
                    _grads(lambda *z: thada.hada_weight_plain(*z, 0.5), ws, ct)):
        _close(a, c.numpy())


@pytest.mark.parametrize("tucker", [False, True])
def test_loha_custom_vjps_match_jax(tucker):
    import jax

    rng = np.random.default_rng(3)
    if tucker:
        ws = [_rand(rng, 4, 4, 3, 3), _rand(rng, 4, 6), _rand(rng, 4, 5),
              _rand(rng, 4, 4, 3, 3), _rand(rng, 4, 6), _rand(rng, 4, 5)]
        jfn, tfn = jloha.hada_weight_tucker, tloha.hada_weight_tucker
    else:
        ws = [_rand(rng, 4, 20), _rand(rng, 12, 4), _rand(rng, 4, 20), _rand(rng, 12, 4)]
        jfn, tfn = jloha.hada_weight, tloha.hada_weight
    ct = _rand(rng, *np.shape(jfn(*map(jnp.asarray, ws), 0.7)))
    want = jax.grad(lambda *a: jnp.sum(jfn(*a, 0.7) * ct), argnums=tuple(range(len(ws))))(
        *map(jnp.asarray, ws))
    got = _grads(lambda *a: tfn(*a, 0.7), _t(*ws), torch.from_numpy(ct))
    for a, b in zip(got, want):
        _close(a, b)


# ---------------------------------------------------------------------------
# factored merged cotangents
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("want_scalar", [False, True])
def test_lora_dtheta_matches_jax(want_scalar):
    rng = np.random.default_rng(4)
    x, dy = _rand(rng, 30, 16), _rand(rng, 30, 24)
    up, down = _rand(rng, 24, 4), _rand(rng, 4, 16)
    want = jmerged.lora_dtheta(*map(jnp.asarray, (x, dy, up, down)), want_scalar=want_scalar)
    got = tmerged.lora_dtheta(*_t(x, dy, up, down), want_scalar=want_scalar)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, **GRAD_TOL)


@pytest.mark.parametrize("branch", ["w2_ab", "pivot_in", "pivot_out"])
def test_lokr_dtheta_matches_jax(branch):
    rng = np.random.default_rng(5)
    p, q = 4, 2
    u, v = {"w2_ab": (6, 8), "pivot_in": (6, 4), "pivot_out": (3, 8)}[branch]
    x, dy = _rand(rng, 30, q * v), _rand(rng, 30, p * u)
    w1 = _rand(rng, p, q)
    if branch == "w2_ab":
        w2, ab = None, (_rand(rng, u, 2), _rand(rng, 2, v))
    else:
        w2, ab = _rand(rng, u, v), None
    jab = None if ab is None else tuple(map(jnp.asarray, ab))
    want = jmerged.lokr_dtheta(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(w1),
                               None if w2 is None else jnp.asarray(w2), w2_ab=jab,
                               want_scalar=True)
    got = tmerged.lokr_dtheta(*_t(x, dy, w1), None if w2 is None else torch.from_numpy(w2),
                              w2_ab=None if ab is None else tuple(_t(*ab)), want_scalar=True)
    flat = lambda r: [r[0], *(r[1] if isinstance(r[1], tuple) else (r[1],)), r[2]]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        _close(a, b, **GRAD_TOL)


def test_worth_factoring_threshold():
    assert tmerged.worth_factoring(10240, 1280)  # harmonic 1137: SD1.5 ff net_0
    assert tmerged.worth_factoring(1280, 5120)  # harmonic 1024: SD1.5 ff net_2
    assert not tmerged.worth_factoring(1280, 1280)  # 640: square 1280 stays dense
    assert not tmerged.worth_factoring(5120, 640)
    assert tmerged.worth_factoring(24, 16, threshold=0)
    for dims in ((10240, 1280), (1280, 5120), (1280, 1280), (5120, 640), (320, 320)):
        assert tmerged.worth_factoring(*dims) == jmerged.worth_factoring(*dims, threshold=1024)


OUT, IN = 24, 16


def _noised_lokr(**kw):
    g = torch.Generator().manual_seed(0)
    m = LokrModule("t", LayerInfo.linear(OUT, IN), generator=g, alpha=2, factor=4, **kw)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return m


@pytest.mark.parametrize("apply_kind", ["linear", "head_split"])
@pytest.mark.parametrize("cfg", [dict(lora_dim=2), dict(lora_dim=1, decompose_both=True),
                                 dict(lora_dim=2, full_matrix=True), dict(lora_dim=2, use_scalar=True)],
                         ids=["w2_ab", "w1_ab", "full", "scalar"])
def test_lokr_factored_grads_match_autograd(cfg, apply_kind):
    """factored_merged_apply's adapter grads equal plain autograd through
    W + dW, for each w1/w2 decomposition, the scalar, and both layer ops."""
    m = _noised_lokr(**cfg)
    fns = m.factored_merged_fns(0.7)
    assert fns is not None
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, IN, generator=g, requires_grad=True)
    w, b = torch.randn(OUT, IN, generator=g) * 0.1, torch.randn(OUT, generator=g) * 0.1
    if apply_kind == "linear":
        apply_fn = lambda xx, ww, bb: linear(xx, ww, bb)  # noqa: E731
        native = lambda y: y  # noqa: E731
    else:
        apply_fn = lambda xx, ww, bb: linear_head_split(xx, ww, bb, 4, 6)  # noqa: E731
        native = lambda y: y.transpose(-2, -3).flatten(-2)  # noqa: E731
    ct = torch.randn(apply_fn(x, w, b).shape, generator=g)

    y = tmerged.factored_merged_apply(
        x, w, b, dict(m.params), recon_fn=fns[0], dtheta_fn=fns[1], apply_fn=apply_fn,
        dx_fn=lambda gg, ww: native(gg) @ ww, dy2d_fn=lambda gg: native(gg).reshape(-1, OUT))
    params = [x, *m.parameters()]
    got = torch.autograd.grad((y * ct).sum(), params)
    w_m, b_m = m.get_merged_weight(w, b, multiplier=0.7)
    want = torch.autograd.grad((apply_fn(x, w_m, b_m) * ct).sum(), params)
    _close(y, apply_fn(x, w_m, b_m).detach().numpy())
    for a, c in zip(got, want):
        _close(a, c.numpy(), **GRAD_TOL)


def test_factored_fns_decline_what_needs_autograd():
    conv = LayerInfo.conv(2, OUT, IN, 3, padding=1)
    assert LokrModule("t", conv, lora_dim=2, factor=4).factored_merged_fns(1.0) is None
    assert _noised_lokr(lora_dim=2, rank_dropout=0.5).factored_merged_fns(1.0) is None
    assert _noised_lokr(lora_dim=2).factored_merged_fns(1.0) is not None


def test_layer_norm_bwd_variant_by_width():
    """The vectorised LayerNorm backward takes every width of the SD1.5 and
    SDXL paths (a row split evenly into 16-byte vectors over a group of
    lanes, 5 vectors a lane); C = 100 and 2000 take the generic one."""
    for c, lanes in ((320, 8), (640, 16), (1280, 32)):
        assert tln.bwd_lanes(c, 2) == lanes  # bf16, the path's dtype
        assert c // (8 * lanes) == tln.VECS == 5
    assert (tln.bwd_lanes(320, 4), tln.bwd_lanes(640, 4)) == (16, 32)  # fp32
    assert tln.bwd_lanes(1280, 4) == 0  # fp32: 10 vectors a lane, not built
    for c in (100, 2000):
        assert tln.bwd_lanes(c, 2) == 0 and tln.bwd_lanes(c, 4) == 0
    for c in range(8, 3000, 8):  # any lanes given split the row into 5 vectors a lane
        for es in (2, 4):
            lanes = tln.bwd_lanes(c, es)
            if lanes:
                assert 32 % lanes == 0 and c * es == 16 * tln.VECS * lanes


def test_hada_bwd_rows_per_block_fill_the_card():
    """The backward kernel's rows per block: a multiple of its 16-row tile in
    [16, 256], small layers spread thin, the widest at the cap."""
    for o, i in ((320, 320), (2560, 320), (640, 640), (1280, 1280), (10240, 1280),
                 (1280, 5120), (100, 130)):
        rpb = thada.bwd_rows_per_block(o, i)
        assert 16 <= rpb <= 256 and rpb % 16 == 0, (o, i, rpb)
    assert thada.bwd_rows_per_block(320, 320) == 16
    assert thada.bwd_rows_per_block(10240, 1280) == 256


# (O, I) of the LoHa layers of the SD1.5 (b8) and SDXL (b4) attn-mlp paths
HADA_PATH_SHAPES = ((320, 320), (2560, 320), (320, 1280), (320, 768), (640, 640), (5120, 640),
                    (640, 2560), (640, 768), (640, 2048), (1280, 1280), (10240, 1280),
                    (1280, 5120), (1280, 768), (1280, 2048))


def test_hada_fast_variant_choice():
    """The fast LoHa kernels take rank 8 with I a multiple of 4 and 16-byte
    aligned tensors (every LoHa layer of the SD1.5 and SDXL paths); any
    other rank or width, or a tensor off 16 bytes, takes the generic ones."""
    t = [torch.empty(64, 128) for _ in range(3)]
    for _, i in HADA_PATH_SHAPES:
        assert thada.fast(i, 8, *t)
    for r in (1, 4, 16, 40, 128):
        assert not thada.fast(1280, r, *t)
    assert not thada.fast(1282, 8, *t) and not thada.fast(130, 8, *t)
    off = torch.empty(1025)[1:].view(8, 128)  # contiguous, 4 bytes past 16
    assert off.is_contiguous() and not thada.fast(128, 8, t[0], off)


@pytest.mark.parametrize("sms", [132, 114])
def test_hada_fast_grids(sms):
    """The fast grids cover every row and column once. The backward's blocks
    hold at most 1024 rows, make one wave of one block per SM where the
    layer allows, and keep the fp32 partial sums (2R floats per row and
    column block, 2R per column and block of rows) within a quarter of
    fp32 g's bytes at every path shape; the forward's blocks hold at most
    512 rows, about two blocks per SM."""
    for o, i in HADA_PATH_SHAPES + ((100, 132), (8, 128), (40960, 1280), (7, 4)):
        gx, gy, rpb = thada.bwd_grid(o, i, sms)
        assert (gx - 1) * 128 < i <= gx * 128 and (gy - 1) * rpb < o <= gy * rpb, (o, i)
        assert rpb <= 1024
        if (o, i) in HADA_PATH_SHAPES:
            assert gx * gy <= sms, (o, i)
            assert (gx * o + gy * i) * 16 <= o * i / 4, (o, i)
        fx, fy, frpb = thada.fwd_grid(o, i, sms)
        assert fx == gx and (fy - 1) * frpb < o <= fy * frpb and frpb <= 512, (o, i)
        assert fx * fy <= max(2 * sms, fx * -(-o // 512)), (o, i)


@pytest.mark.parametrize("sms", [132, 114])
def test_hada_split_grid(sms):
    """The fast split backward's two grids cover every row and column once
    with runs of at most 1024 rows. At every path shape the u-pass makes
    about as many blocks as two per SM hold, the d-pass as one per SM
    holds, unless a block would be left with too few rows: a u-pass block
    has a row for each warp, a d-pass block two. The d-pass's partial sums
    stay within fp32 g's elements, the u-pass's within a sixth of them."""
    for o, i in HADA_PATH_SHAPES + ((100, 132), (8, 128), (40960, 1280), (7, 4), (1, 4)):
        gx, gy_u, rpb_u, gy_d, rpb_d = thada.split_grid(o, i, sms)
        assert (gx - 1) * 128 < i <= gx * 128, (o, i)
        for gy, rpb in ((gy_u, rpb_u), (gy_d, rpb_d)):
            assert 1 <= rpb <= 1024 and (gy - 1) * rpb < o <= gy * rpb, (o, i, gy, rpb)
        assert rpb_u >= min(o, 8) and rpb_d >= min(o, 16), (o, i)
        if (o, i) in HADA_PATH_SHAPES:
            assert gx * gy_u <= 2 * sms and gx * gy_d <= sms, (o, i)
            # the fewest rows a run: one row fewer would need more runs than
            # the blocks an SM holds, or leave a block short of rows
            assert -(-o // (rpb_u - 1)) > min(2 * sms // gx, o // 8), (o, i)
            assert -(-o // (rpb_d - 1)) > min(sms // gx, o // 16), (o, i)
            assert gy_d * i * 16 <= o * i and gx * o * 16 <= o * i / 6, (o, i)
    assert thada.split_grid(10240, 1280, 132) == (10, 26, 394, 13, 788)
    assert thada.split_grid(320, 320, 132) == (3, 40, 8, 20, 16)


def test_hada_split_on_cpu_takes_plain_and_counts_nothing():
    """On CPU tensors the split backward takes its plain version and counts
    no launch of either variant; its kernel wrapper raises."""
    rng = np.random.default_rng(5)
    w1d, w2d = (torch.tensor(rng.standard_normal((8, 128)), dtype=torch.float32)
                for _ in range(2))
    w1u, w2u = (torch.tensor(0.1 * rng.standard_normal((64, 8)), dtype=torch.float32)
                for _ in range(2))
    g = torch.tensor(1e-3 * rng.standard_normal((64, 128)), dtype=torch.float32)
    before = (thada.split_launches, thada.split_fast_launches, thada.split_generic_launches)
    old = thada.BWD
    thada.BWD = "split"
    try:
        got = thada.hada_weight_bwd(w1d, w1u, w2d, w2u, 0.5, g)
    finally:
        thada.BWD = old
    want = thada.hada_weight_bwd_split_plain(w1d, w1u, w2d, w2u, 0.5, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (thada.split_launches, thada.split_fast_launches,
            thada.split_generic_launches) == before
    with pytest.raises(RuntimeError, match="no kernel"):
        thada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, g)
