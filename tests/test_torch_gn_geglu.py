"""The port's GroupNorm(+SiLU) and GEGLU modules against the JAX kernels they
replace, run as the JAX package's own tests run them on the CPU (Pallas in
interpret mode): ``group_norm_v2.group_norm_act`` (forward and the vjp in
x, gamma, beta), the v1 ``ops.group_norm.group_norm`` that the same port
kernels serve, and ``geglu.geglu_bwd_dt``. The port side is the autograd
Function each kernel sits in, which takes its plain version on the CPU.

Tolerance: 1e-5 for forwards and 1e-4 for gradients (fp32; summation order
differs), as the JAX package holds its fused GroupNorm to its jnp form.

The GroupNorm wrapper's choice of kernel variant and the fast variant's
split of each group over a thread block cluster are Python, checked here at
every GroupNorm shape of the SD1.5 and SDXL paths.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lycoris_tpu.ops import geglu as jgeglu
from lycoris_tpu.ops import group_norm as jgn1
from lycoris_tpu.ops import group_norm_v2 as jgn2
from lycoris_tpu_torch.functional import general as tgeneral
from lycoris_tpu_torch.ops import geglu as tgeglu
from lycoris_tpu_torch.ops import group_norm as tgn

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)

# (shape, groups): cg = 8, and cg = 30 as at SDXL's 960-channel level
SHAPES = [((2, 64, 16, 16), 8), ((2, 120, 16, 16), 4)]


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


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, gamma, beta, dy


def _port(x, gamma, beta, dy, groups, act, eps):
    """The port's Function: output and (dx, dgamma, dbeta) for cotangent dy."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta)]
    x_, w_, b_ = leaves
    y = tgeneral.group_norm_act(x_, groups, w_, b_, eps, act=act)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    return y.detach().numpy(), [g.numpy() for g in grads]


def _check(got_y, got_g, want_y, want_g):
    np.testing.assert_allclose(got_y, np.asarray(want_y), **FWD)
    for got, want, name in zip(got_g, want_g, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(got, np.asarray(want), **GRAD, err_msg=name)


@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_jax_v2_kernel(monkeypatch, shape, groups, act):
    monkeypatch.setattr(jgn2, "_INTERPRET", True)
    x, gamma, beta, dy = _inputs(shape, 0)
    assert jgn2.supported(shape)  # the JAX call below takes its kernels

    def jfn(*a):
        return jgn2.group_norm_act(*a[:1], groups, *a[1:], eps=1e-5, act=act)

    want_y, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, gamma, beta)))
    want_g = vjp(jnp.asarray(dy))
    got_y, got_g = _port(x, gamma, beta, dy, groups, act, 1e-5)
    _check(got_y, got_g, want_y, want_g)


@pytest.mark.parametrize("shape,groups", SHAPES)
def test_group_norm_matches_jax_v1_kernel(interpret_pallas, shape, groups):
    x, gamma, beta, dy = _inputs(shape, 1)

    def jfn(*a):
        return jgn1.group_norm(a[0], groups, a[1], a[2], 1e-6)

    want_y, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, gamma, beta)))
    want_g = vjp(jnp.asarray(dy))
    got_y, got_g = _port(x, gamma, beta, dy, groups, None, 1e-6)
    _check(got_y, got_g, want_y, want_g)


def test_group_norm_without_affine_and_frozen_weights():
    """No gamma/beta; and frozen gamma/beta get no gradient (the path's case)."""
    x, gamma, beta, dy = _inputs((2, 64, 8, 8), 2)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tgn.group_norm_act(xt, 8, None, None, 1e-5, "silu")
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    want_dx, _, _ = tgn.group_norm_bwd_plain(xt.detach(), torch.from_numpy(dy), 8,
                                             torch.ones(64), torch.zeros(64), 1e-5, "silu")
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), **FWD)
    w, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    y = tgn.group_norm_act(xt, 8, w, b, 1e-5, "silu")
    y.backward(torch.from_numpy(dy))
    assert w.grad is None and b.grad is None and xt.grad is not None
    with pytest.raises(ValueError, match="act"):
        tgn.group_norm_act(xt, 8, w, b, 1e-5, "gelu")


def test_geglu_matches_jax_kernel(monkeypatch):
    monkeypatch.setattr(jgeglu, "_INTERPRET", True)
    rng = np.random.default_rng(3)
    h_full = (rng.standard_normal((1, 512, 512)) * 2.0).astype(np.float32)
    dy = rng.standard_normal((1, 512, 256)).astype(np.float32)
    want = jgeglu.geglu_bwd_dt(jnp.asarray(h_full), jnp.asarray(dy))

    from lycoris_tpu.functional import general as jgeneral

    want_y = jgeneral.geglu_mul(jnp.asarray(h_full))
    # torch gets copies: the JAX CPU arrays may alias the numpy buffers
    ht = torch.tensor(h_full, requires_grad=True)
    y = tgeneral.geglu_mul(ht)
    (got,) = torch.autograd.grad(y, ht, torch.tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **FWD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)


# a fresh interpreter whose first torch computation is the plain GEGLU
# backward, over 8 intra-op threads, on test_geglu_matches_jax_kernel's input
_FIRST_CALL = """
import sys
import numpy as np
rng = np.random.default_rng(3)
h_full = (rng.standard_normal((1, 512, 512)) * 2.0).astype(np.float32)
dy = rng.standard_normal((1, 512, 256)).astype(np.float32)
import torch
from lycoris_tpu_torch.ops.geglu import geglu_bwd_plain
torch.set_num_threads(8)
np.save(sys.argv[1], geglu_bwd_plain(torch.tensor(h_full), torch.tensor(dy)).numpy())
"""


def test_geglu_bwd_plain_first_call_in_fresh_processes(tmp_path):
    """The plain GEGLU backward is right on its first call in a process: 8
    fresh interpreters at once, each against a float64 computation of the
    tanh form at the GRAD bound."""
    import subprocess

    root = Path(__file__).resolve().parent.parent
    outs = [tmp_path / f"d_hfull_{k}.npy" for k in range(8)]
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL, str(out)], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for out in outs]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    rng = np.random.default_rng(3)
    h_full = (rng.standard_normal((1, 512, 512)) * 2.0).astype(np.float32).astype(np.float64)
    d = rng.standard_normal((1, 512, 256)).astype(np.float32).astype(np.float64)
    h, z = h_full[..., :256], h_full[..., 256:]
    k0, k1 = np.sqrt(2.0 / np.pi), 0.044715
    t = np.tanh(k0 * (z + k1 * z**3))
    dgelu = 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * k0 * (1.0 + 3.0 * k1 * z * z)
    want = np.concatenate([d * 0.5 * z * (1.0 + t), d * h * dgelu], axis=-1)
    for out in outs:
        np.testing.assert_allclose(np.load(out), want, **GRAD, err_msg=out.name)


def test_cpu_wrappers_use_plain_and_count_nothing():
    before = (tgn.launches, tgn.bwd_launches, tgn.copies, tgeglu.bwd_launches)
    x = torch.randn(2, 32, 8, 8, requires_grad=True)
    tgn.group_norm_act(x, 8, torch.ones(32), torch.zeros(32), 1e-5, "silu").sum().backward()
    h = torch.randn(2, 16, 64, requires_grad=True)
    tgeglu.geglu_mul(h).sum().backward()
    assert (tgn.launches, tgn.bwd_launches, tgn.copies, tgeglu.bwd_launches) == before


def _census_shapes():
    """(N, C, S) of every GroupNorm of the SD1.5 (64x64 latents, batch 4 for
    serving and 8 for training) and SDXL (128x128, batch 4) UNets, from
    chip_smoke's census of the UNet configs."""
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    from lycoris_tpu_torch.models.unet import sd15_config, sdxl_config

    shapes = set()
    for cfg, n, hw in ((sd15_config(), 4, 64), (sd15_config(), 8, 64), (sdxl_config(), 4, 128)):
        shapes.update((n, c, s) for c, s, _ in chip_smoke.path_shapes(cfg, n, hw)["gn"])
    return sorted(shapes)


def test_group_norm_variant_choice():
    """Fast for bf16 and fp32 path shapes, 16-byte aligned; generic where a
    row does not hold whole 16-byte vectors or a tensor is an offset view."""
    shapes = _census_shapes()
    assert len(shapes) == 34 and (4, 960, 16384) in shapes and (8, 1280, 64) in shapes
    for n, c, s in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.empty((n, c, s), dtype=dt, device="meta")
            assert tgn.variant(x, 32) == "fast", (n, c, s, dt)
            assert tgn.variant(x.view(n, c, s // 8, 8), 32, x) == "fast"
    odd = torch.empty((2, 64, 7, 5))  # S = 35: no whole vectors
    assert tgn.variant(odd, 8) == tgn.variant(odd.bfloat16(), 8) == "generic"
    s36 = torch.empty((2, 64, 6, 6))  # 36 fp32 = 9 vectors, 36 bf16 = 4.5
    assert tgn.variant(s36, 8) == "fast" and tgn.variant(s36.bfloat16(), 8) == "generic"
    for dt in (torch.bfloat16, torch.float32):
        base = torch.zeros(2 * 64 * 256 + 1, dtype=dt)
        x = base[:-1].view(2, 64, 16, 16)
        shifted = base[1:].view(2, 64, 16, 16)  # one element off 16 bytes
        assert tgn.variant(x, 8) == "fast"
        assert tgn.variant(shifted, 8) == "generic" and tgn.variant(x, 8, shifted) == "generic"
    assert tgn.variant(torch.empty((2, 64, 16, 16), dtype=torch.float16), 8) == "generic"


def test_group_norm_plan():
    """Both directions of every path shape, bf16 and fp32: clusters of at
    most 8 CTAs whose slices are whole 16-byte vectors, none empty, covering
    each group exactly; what a CTA stages fits its shared memory, the rest
    of its slice is marked for the re-read (in bf16 only the backward's
    slices over the slice target, at SDXL's largest groups); the persistent
    grid holds no more clusters
    than the card holds at once or than there are groups, and no cluster
    takes more groups than the busiest must."""
    for n, c, s in _census_shapes():
        for dt in (torch.bfloat16, torch.float32):
            es = torch.empty((), dtype=dt).element_size()
            gbytes = c // 32 * s * es
            assert gbytes % 16 == 0
            gvec = gbytes // 16
            for direction, nt in (("fwd", 1), ("bwd", 2)):
                pl = tgn.plan(n, c, s, 32, dt, direction)
                assert 1 <= pl.k <= tgn.MAX_CLUSTER
                lens = [min(pl.slice, gvec - r * pl.slice) for r in range(pl.k)]
                assert min(lens) > 0 and sum(lens) == gvec, (n, c, s, direction)
                assert pl.k == 1 or 16 * nt * pl.slice <= tgn.SLICE_BYTES or pl.k == 8
                assert pl.staged + pl.reread == pl.slice and pl.staged > 0
                assert pl.smem <= tgn.SMEM_MAX
                assert pl.smem >= 16 * nt * pl.staged + 8 * -(-pl.staged // pl.chunk)
                assert 16 * nt * pl.chunk < 2**20  # an mbarrier phase's transaction bytes
                over = 16 * nt * pl.slice > tgn.SLICE_BYTES
                if pl.reread:
                    assert over and (direction == "bwd" or pl.k == tgn.MAX_CLUSTER)
                if dt == torch.bfloat16:
                    assert (pl.reread > 0) == (direction == "bwd" and over), (n, c, s, direction)
                for active in (1, 15, 62, 132, 264, 1056):
                    ctas = tgn.grid(pl, n * 32, active)
                    clusters = ctas // pl.k
                    assert ctas % pl.k == 0 and 1 <= clusters <= min(active, n * 32)
                    turns = -(-n * 32 // clusters)
                    assert turns == -(-n * 32 // min(active, n * 32))
    big = tgn.plan(4, 960, 16384, 32, torch.bfloat16, "bwd")
    assert (big.k, big.slice, big.staged) == (8, 7680, tgn.BWD_STAGE_BYTES // 32)
    assert tgn.plan(8, 1280, 64, 32, torch.bfloat16, "fwd").k == 1
    with pytest.raises(ValueError):
        tgn.plan(2, 64, 35, 8, torch.bfloat16, "fwd")
