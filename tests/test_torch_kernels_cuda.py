"""The port's CUDA kernels against their plain versions, on a CUDA card.

These tests skip without a card. They import no JAX, so they also run on
a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
tests). Bounds: the ROADMAP's per-dtype MSE (fp32 5e-6, bf16 5e-4), and a
relative L2 error (fp32 1e-4, bf16 1e-2) that holds small outputs, such as
flash O at T4096, as tightly as large ones. The backward kernels are held
to the same bounds, and each autograd Function's gradients to those of
autograd through the plain forward.
"""

import pytest
import torch

from lycoris_tpu_torch.ops import flash as tflash
from lycoris_tpu_torch.ops import geglu as tgeglu
from lycoris_tpu_torch.ops import group_norm as tgn
from lycoris_tpu_torch.ops import hada as thada
from lycoris_tpu_torch.ops import layer_norm as tln
from lycoris_tpu_torch.ops import lora_fused as tlf


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want, dtype):
    err = got.float() - want.float()
    mse_bound = {torch.float32: 5e-6, torch.bfloat16: 5e-4}[dtype]
    rel_bound = {torch.float32: 1e-4, torch.bfloat16: 1e-2}[dtype]
    assert float((err * err).mean()) <= mse_bound
    assert float(err.norm() / want.float().norm()) <= rel_bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layer_norm_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    for rows, c in ((4 * 4096, 320), (4 * 1024, 640), (4 * 256, 1280), (7, 100)):
        x = torch.randn(rows, c, device=cuda, generator=g).to(dtype)
        w = torch.randn(c, device=cuda, generator=g).to(dtype)
        b = torch.randn(c, device=cuda, generator=g).to(dtype)
        n = tln.launches
        y = tln.layer_norm(x, w, b, 1e-5)
        assert tln.launches == n + 1
        _check(y, tln.layer_norm_plain(x, w, b, 1e-5), dtype)


# (rows, C) of the LayerNorms of SD1.5 serving (b4) and SDXL training (b4)
# (chip_smoke.path_shapes), then ragged row counts for the vectorised
# variant's last group and a width it does not take
LN_FWD_SHAPES = ((16384, 320), (4096, 640), (1024, 1280), (256, 1280), (16384, 640),
                 (4096, 1280), (7, 320), (1001, 640), (33, 1280), (7, 100))


def _ln_inputs(rows, c, dtype, g, dev, offset=0):
    """x (rows, C), w, b; x with ``offset`` elements in front of it in its
    buffer (1: contiguous but not 16-byte aligned)."""
    buf = torch.randn(rows * c + offset, device=dev, generator=g) * 2 + 0.5
    x = buf.to(dtype)[offset:].view(rows, c)
    w = (torch.randn(c, device=dev, generator=g) * 0.5 + 1).to(dtype)
    b = (torch.randn(c, device=dev, generator=g) * 0.5).to(dtype)
    return x, w, b


def _ln_fwd_counts():
    return tln.launches, tln.fwd_vec_launches, tln.fwd_generic_launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layer_norm_fwd_variants(cuda, dtype):
    """Each shape through the variant ``fwd_plan`` names (vectorised at
    every path width in bf16, and in fp32 but at C = 1280), through the
    generic one when asked for, and through the generic one for an x one
    element off 16 bytes; each against the plain version, counted per
    variant. The unaligned x gives the generic variant's result bit for
    bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    es = torch.tensor([], dtype=dtype).element_size()
    for rows, c in LN_FWD_SHAPES:
        x, w, b = _ln_inputs(rows, c, dtype, g, cuda)
        want = tln.layer_norm_plain(x, w, b, 1e-5)
        vec = tln.vec_lanes(c, es) > 0
        assert vec == (c != 100 and not (dtype == torch.float32 and c == 1280)), (rows, c)
        n = _ln_fwd_counts()
        y = tln.layer_norm(x, w, b, 1e-5)
        gen = tln.layer_norm_fwd(x, w, b, 1e-5, vectorised=False)
        xs = _ln_inputs(rows, c, dtype, g, cuda, offset=1)[0]
        xs.copy_(x)
        assert xs.data_ptr() % 16
        shifted = tln.layer_norm(xs, w, b, 1e-5)
        got = tuple(now - was for now, was in zip(_ln_fwd_counts(), n))
        assert got == (3, int(vec), 3 - int(vec)), (rows, c)
        _check(y, want, dtype)
        _check(gen, want, dtype)
        assert torch.equal(shifted, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [768, 1280])
def test_cuda_layer_norm_fwd_clip_shapes(cuda, dtype, c):
    """The CLIP encoders' LayerNorms at b4 x 77 tokens (CLIP-L C = 768,
    CLIP-G C = 1280) against the plain version, each through the variant
    ``fwd_plan`` names (vectorised only for bf16 C = 1280) and through the
    generic one."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x, w, b = _ln_inputs(4 * 77, c, dtype, g, cuda)
    want = tln.layer_norm_plain(x, w, b, 1e-5)
    vec = int(tln.fwd_plan(4 * 77, c, x.element_size()).lanes > 0)
    assert vec == int(dtype == torch.bfloat16 and c == 1280)
    n = _ln_fwd_counts()
    y = tln.layer_norm(x, w, b, 1e-5)
    gen = tln.layer_norm_fwd(x, w, b, 1e-5, vectorised=False)
    got = tuple(now - was for now, was in zip(_ln_fwd_counts(), n))
    assert got == (2, vec, 2 - vec)
    _check(y, want, dtype)
    _check(gen, want, dtype)


@pytest.mark.cuda
def test_cuda_layer_norm_fwd_repeats_bit_for_bit(cuda):
    """The vectorised variant sums in a fixed order: 50 calls, and a call
    on a second stream, give the same bits (bf16, three path shapes)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for rows, c in ((16384, 320), (4096, 640), (1024, 1280)):
        x, w, b = _ln_inputs(rows, c, torch.bfloat16, g, cuda)
        n = tln.fwd_vec_launches
        want = tln.layer_norm_fwd(x, w, b, 1e-5)
        for _ in range(50):
            assert torch.equal(tln.layer_norm_fwd(x, w, b, 1e-5), want)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            other = tln.layer_norm_fwd(x, w, b, 1e-5)
        torch.cuda.current_stream().wait_stream(s)
        assert torch.equal(other, want)
        assert tln.fwd_vec_launches == n + 52


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layer_norm_fwd_graph_replay(cuda, dtype):
    """Both variants captured in a CUDA graph and replayed equal the eager
    calls, at SD1.5's smallest shape and SDXL's (4096, 640)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for rows, c in ((256, 1280), (4096, 640)):
        x, w, b = _ln_inputs(rows, c, dtype, g, cuda)
        _graph_matches_eager(lambda: (tln.layer_norm_fwd(x, w, b, 1e-5),
                                      tln.layer_norm_fwd(x, w, b, 1e-5, vectorised=False)))


def _heads(b, h, t, d, g, dtype, dev):
    """A (B, H, T, D) head-split view of a (B, T, H*D) tensor: the layout the
    UNet's attention projections give the flash kernels."""
    return torch.randn(b, t, h * d, device=dev, generator=g).to(dtype).unflatten(
        -1, (h, d)).transpose(1, 2)


# (B, H, T, D) of the head-split cases: the UNets' D 40, 64, 80 and a ragged T
FLASH_STRIDED = ((2, 8, 4096, 40), (2, 8, 1024, 80), (2, 10, 4096, 64), (2, 3, 1000, 40))


def _graph_matches_eager(fn):
    """One call of ``fn`` captured in a CUDA graph and replayed equals the
    eager call (the kernels are deterministic: bit for bit)."""
    want = fn()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        got = fn()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, h, t, d in ((4, 8, 4096, 40), (4, 8, 1024, 80), (1, 2, 1000, 128), (4, 10, 4096, 64),
                       (4, 20, 1024, 64)):
        q, k, v = (torch.randn(b, h, t, d, device=cuda, generator=g).to(dtype) for _ in range(3))
        o, lse = tflash.flash_attention(q, k, v, d**-0.5)
        o_ref, lse_ref = tflash.flash_attention_plain(q, k, v, d**-0.5)
        _check(o, o_ref, dtype)
        assert float((lse - lse_ref).abs().max()) < 1e-3
    # the UNet's head-split layout is read in place; D = 100 takes the pad copy
    for (b, h, t, d), copies in [(s, 0) for s in FLASH_STRIDED] + [((1, 2, 1000, 100), 3)]:
        if d == 100:
            q, k, v = (torch.randn(b, h, t, d, device=cuda, generator=g).to(dtype)
                       for _ in range(3))
        else:
            q, k, v = (_heads(b, h, t, d, g, dtype, cuda) for _ in range(3))
        n = tflash.pad_copies
        o, lse = tflash.flash_attention(q, k, v, d**-0.5)
        assert tflash.pad_copies == n + (copies if dtype == torch.bfloat16 else 0)
        o_ref, lse_ref = tflash.flash_attention_plain(q, k, v, d**-0.5)
        _check(o, o_ref, dtype)
        assert float((lse - lse_ref).abs().max()) < 1e-3
    q, k, v = (_heads(2, 10, 1024, 64, g, dtype, cuda) for _ in range(3))
    _graph_matches_eager(lambda: tflash.flash_fwd(q, k, v, 0.125))


# (O, I) of the LoHa layers of the SD1.5 and SDXL paths (rank 8)
HADA_PATH_SHAPES = ((320, 320), (1280, 1280), (10240, 1280), (1280, 5120), (640, 2048))


def _hada_factors(o, i, r, dtype, gen, dev, offset=0):
    """w1d, w1u, w2d, w2u and a cotangent, each with ``offset`` elements in
    front of it in its buffer: 1 leaves them contiguous but not 16-byte
    aligned, so that the generic variants take a rank-8 layer."""
    def rnd(shape, std):
        buf = (torch.randn(shape[0] * shape[1] + offset, device=dev, generator=gen) * std)
        return buf.to(dtype)[offset:].view(shape)

    return rnd((r, i), 1.0), rnd((o, r), 0.1), rnd((r, i), 1.0), rnd((o, r), 0.1), rnd((o, i), 1e-3)


# ((O, I, R), offset, variant): the path's shapes through both variants; a
# ragged last column strip (I = 132) through the fast one; I % 4 != 0 and
# rank 40 through the generic one
HADA_CASES = ([((o, i, 8), 0, "fast") for o, i in HADA_PATH_SHAPES]
              + [((o, i, 8), 1, "generic") for o, i in HADA_PATH_SHAPES]
              + [((100, 132, 8), 0, "fast"), ((100, 130, 8), 0, "generic"),
                 ((100, 130, 40), 0, "generic")])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hada_kernel(cuda, dtype):
    """The forward against its plain version through the variant each case
    names, counted per variant."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for (o, i, r), offset, variant in HADA_CASES:
        w1d, w1u, w2d, w2u, _ = _hada_factors(o, i, r, dtype, g, cuda, offset)
        n = (thada.launches, thada.fast_launches, thada.generic_launches)
        got = thada.hada_weight(w1d, w1u, w2d, w2u, 0.5)
        fast = variant == "fast"
        assert (thada.launches - n[0], thada.fast_launches - n[1],
                thada.generic_launches - n[2]) == (1, int(fast), int(not fast)), (o, i, r, offset)
        _check(got, thada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layer_norm_bwd_kernel(cuda, dtype):
    """Every LayerNorm shape of SD1.5 b8 and SDXL b4 takes the vectorised
    variant in bf16, the path's dtype (fp32 too, but for C = 1280), with
    and without dw/db; C = 100 and C = 2000 take the generic one."""
    g = torch.Generator(device=cuda).manual_seed(1)
    cases = [((8 * 4096, 320), True), ((8 * 1024, 640), True), ((8 * 256, 1280), True),
             ((8 * 64, 1280), True), ((4 * 4096, 640), True), ((4 * 1024, 1280), True),
             ((7, 100), False), ((3000, 2000), False)]
    es = torch.tensor([], dtype=dtype).element_size()
    for (rows, c), vec in cases:
        x = (torch.randn(rows, c, device=cuda, generator=g) * 2 + 0.5).to(dtype)
        w = (torch.randn(c, device=cuda, generator=g) * 0.5 + 1).to(dtype)
        dy = torch.randn(rows, c, device=cuda, generator=g).to(dtype)
        want = tln.layer_norm_bwd_plain(x, w, dy, 1e-5)
        vec = vec and not (dtype == torch.float32 and c == 1280)
        assert (tln.bwd_lanes(c, es) > 0) == vec, (rows, c)
        n, nv, ng = tln.bwd_launches, tln.bwd_vec_launches, tln.bwd_generic_launches
        got = tln.layer_norm_bwd(x, w, dy, 1e-5)
        assert tln.bwd_launches == n + 1
        assert (tln.bwd_vec_launches - nv, tln.bwd_generic_launches - ng) == (
            (1, 0) if vec else (0, 1)), (rows, c)
        for a, b in zip(got, want):
            _check(a, b, dtype)
        nv = tln.bwd_vec_launches
        dx, dw, db = tln.layer_norm_bwd(x, w, dy, 1e-5, want_wb=False)
        assert dw is None and db is None
        _check(dx, want[0], dtype)
        assert tln.bwd_vec_launches - nv == (1 if vec else 0), (rows, c)
        # deterministic: the dw/db sums do not depend on scheduling
        again = tln.layer_norm_bwd(x, w, dy, 1e-5)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bwd_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    cases = [((b, h, t, d), "contiguous", 0) for b, h, t, d in (
        (2, 8, 4096, 40), (2, 8, 1024, 80), (1, 2, 1000, 128), (4, 10, 4096, 64), (2, 20, 1024, 64))]
    # the UNet's head-split layout (dO as the output projection's gradient
    # gives it: a (B, T, H, D) buffer) is read in place; D = 100 takes the
    # pad copy of q, k, v and dO
    cases += [(shape, "strided", 0) for shape in FLASH_STRIDED]
    cases += [((1, 2, 1000, 100), "contiguous", 4)]
    for (b, h, t, d), layout, copies in cases:
        if layout == "strided":
            q, k, v, do = (_heads(b, h, t, d, g, dtype, cuda) for _ in range(4))
        else:
            q, k, v, do = (torch.randn(b, h, t, d, device=cuda, generator=g).to(dtype)
                           for _ in range(4))
        sm = d**-0.5
        o, lse = tflash.flash_fwd(q, k, v, sm)
        want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, sm)
        n, n_pad = tflash.bwd_launches, tflash.pad_copies
        got = tflash.flash_bwd(q, k, v, o, lse, do, sm)
        assert tflash.bwd_launches == n + 1
        assert tflash.pad_copies == n_pad + (copies if dtype == torch.bfloat16 else 0)
        for a, w in zip(got, want):
            assert a.shape == w.shape
            _check(a, w, dtype)
    q, k, v, do = (_heads(2, 10, 1024, 64, g, dtype, cuda) for _ in range(4))
    o, lse = tflash.flash_fwd(q, k, v, 0.125)
    _graph_matches_eager(lambda: tflash.flash_bwd(q, k, v, o, lse, do, 0.125))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hada_bwd_kernel(cuda, dtype):
    """The fused backward against its plain version through the variant
    each case names, counted per variant."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for (o, i, r), offset, variant in HADA_CASES:
        w1d, w1u, w2d, w2u, gr = _hada_factors(o, i, r, dtype, g, cuda, offset)
        want = thada.hada_weight_bwd_plain(w1d, w1u, w2d, w2u, 0.5, gr)
        n = (thada.bwd_launches, thada.bwd_fast_launches, thada.bwd_generic_launches)
        got = thada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, gr)
        fast = variant == "fast"
        assert (thada.bwd_launches - n[0], thada.bwd_fast_launches - n[1],
                thada.bwd_generic_launches - n[2]) == (1, int(fast), int(not fast)), (o, i, r)
        for a, w in zip(got, want):
            assert a.shape == w.shape and a.dtype == w.dtype
            _check(a, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 4, 16, 40, 128, 300])
def test_cuda_hada_any_rank(cuda, dtype, r):
    """Every rank runs on the card, through the generic variants, at an
    SDXL path width; ranks 128 and 300 (which the fused and the split
    backward could not hold in shared memory before each took 32 ranks at
    a time) also through the split backward."""
    g = torch.Generator(device=cuda).manual_seed(10 + r)
    w1d, w1u, w2d, w2u, gr = _hada_factors(1280, 1280, r, dtype, g, cuda)
    n = (thada.generic_launches, thada.bwd_generic_launches)
    _check(thada.hada_weight(w1d, w1u, w2d, w2u, 0.5),
           thada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5), dtype)
    got = thada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, gr)
    assert (thada.generic_launches - n[0], thada.bwd_generic_launches - n[1]) == (1, 1)
    for a, w in zip(got, thada.hada_weight_bwd_plain(w1d, w1u, w2d, w2u, 0.5, gr)):
        _check(a, w, dtype)
    if r >= 128:
        got = thada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, gr)
        for a, w in zip(got, thada.hada_weight_bwd_split_plain(w1d, w1u, w2d, w2u, 0.5, gr)):
            _check(a, w, dtype)


@pytest.mark.cuda
def test_cuda_loha_trains_at_rank_128(cuda):
    """A rank-128 LoHa layer's gradients through HadaWeightFunction, whose
    backward is the fused kernel (generic variant), against autograd of the
    plain forward."""
    g = torch.Generator(device=cuda).manual_seed(11)
    w1d, w1u, w2d, w2u, _ = _hada_factors(1280, 1280, 128, torch.float32, g, cuda)
    n = thada.bwd_generic_launches
    _grads_match(lambda *a: thada.hada_weight(*a, 0.5),
                 lambda *a: thada.hada_weight_plain(*a, 0.5), (w1d, w1u, w2d, w2u),
                 torch.float32)
    assert thada.bwd_generic_launches == n + 1


@pytest.mark.cuda
def test_cuda_hada_bwd_repeats_bit_for_bit(cuda):
    """The fused backward's cross-block sums are added in a fixed order: a
    second call, and one on another stream, give the same bits (fast and
    generic variants, rank 8 and 40)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    side = torch.cuda.Stream()
    for (o, i, r), offset in (((1280, 1280, 8), 0), ((10240, 1280, 8), 0), ((1280, 1280, 8), 1),
                              ((640, 2048, 40), 0)):
        *factors, gr = _hada_factors(o, i, r, torch.float32, g, cuda, offset)
        args = (*factors, 0.5)
        first = thada.hada_bwd(*args, gr)
        again = thada.hada_bwd(*args, gr)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            other = thada.hada_bwd(*args, gr)
        torch.cuda.current_stream().wait_stream(side)
        for a, b, c in zip(first, again, other):
            assert torch.equal(a, b) and torch.equal(a, c), (o, i, r, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hada_graph_replay(cuda, dtype):
    """The fast forward and backward captured in a CUDA graph and replayed
    equal the eager calls."""
    g = torch.Generator(device=cuda).manual_seed(13)
    w1d, w1u, w2d, w2u, gr = _hada_factors(1280, 1280, 8, dtype, g, cuda)
    n = (thada.fast_launches, thada.bwd_fast_launches)
    _graph_matches_eager(lambda: (thada.hada_fwd(w1d, w1u, w2d, w2u, 0.5),))
    _graph_matches_eager(lambda: thada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, gr))
    assert (thada.fast_launches - n[0], thada.bwd_fast_launches - n[1]) == (3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hada_bwd_split_kernel(cuda, dtype, monkeypatch):
    """The split backward against its plain version and against the fused1
    kernel on the same inputs (fp32: rel L2 1e-5, the sums differ only in
    order), the rank-8 layers through the fast variant, and
    HadaWeightFunction's backward following ``hada.BWD``."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for o, i, r in ((320, 320, 8), (10240, 1280, 8), (1280, 5120, 8), (100, 130, 40)):
        w1d, w2d = (torch.randn(r, i, device=cuda, generator=g).to(dtype) for _ in range(2))
        w1u, w2u = ((0.1 * torch.randn(o, r, device=cuda, generator=g)).to(dtype) for _ in range(2))
        gr = (torch.randn(o, i, device=cuda, generator=g) * 1e-3).to(dtype)
        want = thada.hada_weight_bwd_split_plain(w1d, w1u, w2d, w2u, 0.5, gr)
        n = (thada.split_launches, thada.split_fast_launches)
        got = thada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, gr)
        assert (thada.split_launches - n[0], thada.split_fast_launches - n[1]) == (1, int(r == 8))
        fused = thada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, gr)
        for a, w, f in zip(got, want, fused):
            _check(a, w, dtype)
            if dtype == torch.float32:
                assert float((a - f).norm() / f.norm()) <= 1e-5
            else:
                _check(a, f, dtype)
    monkeypatch.setattr(thada, "BWD", "split")
    leaves = [t.detach().clone().requires_grad_(True) for t in (w1d, w1u, w2d, w2u)]
    n, n1 = thada.split_launches, thada.bwd_launches
    (thada.hada_weight(*leaves, 0.5).float() * gr.float()).sum().backward()
    assert (thada.split_launches, thada.bwd_launches) == (n + 1, n1)
    for leaf, w in zip(leaves, thada.hada_weight_bwd_split_plain(w1d, w1u, w2d, w2u, 0.5, gr)):
        _check(leaf.grad, w, dtype)


# ((O, I, R), offset, variant) of the split backward: the path's shapes
# through both variants; ragged O with a ragged last column strip through
# the fast one; I % 4 != 0, and ranks 1, 31, 33 and 100 (one, two and four
# chunks of 32 ranks), through the generic one
SPLIT_CASES = ([((o, i, 8), 0, "fast") for o, i in HADA_PATH_SHAPES]
               + [((o, i, 8), 1, "generic") for o, i in ((320, 320), (1280, 1280), (10240, 1280))]
               + [((1001, 132, 8), 0, "fast"), ((1001, 130, 8), 0, "generic")]
               + [((640, 640, r), 0, "generic") for r in (1, 31, 33, 100)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hada_split_variants(cuda, dtype):
    """Each split case through the variant it names (counted per variant),
    against the split's plain version and against the fused1 kernel on the
    same inputs (fp32: rel L2 1e-5)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    for (o, i, r), offset, variant in SPLIT_CASES:
        w1d, w1u, w2d, w2u, gr = _hada_factors(o, i, r, dtype, g, cuda, offset)
        n = (thada.split_launches, thada.split_fast_launches, thada.split_generic_launches)
        got = thada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, gr)
        fast = variant == "fast"
        assert (thada.split_launches - n[0], thada.split_fast_launches - n[1],
                thada.split_generic_launches - n[2]) == (1, int(fast), int(not fast)), (o, i, r)
        want = thada.hada_weight_bwd_split_plain(w1d, w1u, w2d, w2u, 0.5, gr)
        fused = thada.hada_bwd(w1d, w1u, w2d, w2u, 0.5, gr)
        for a, w, f in zip(got, want, fused):
            assert a.shape == w.shape and a.dtype == w.dtype, (o, i, r)
            _check(a, w, dtype)
            if dtype == torch.float32:
                assert float((a - f).norm() / f.norm()) <= 1e-5, (o, i, r, offset)
            else:
                _check(a, f, dtype)


@pytest.mark.cuda
def test_cuda_hada_split_repeats_bit_for_bit(cuda):
    """The split backward's sums are added in a fixed order: 50 more calls,
    and one on another stream, give the same bits (the fast variant at the
    path's shapes, the generic one at rank 8 off 16 bytes and at rank 33)."""
    g = torch.Generator(device=cuda).manual_seed(15)
    side = torch.cuda.Stream()
    for (o, i, r), offset in (((1280, 1280, 8), 0), ((10240, 1280, 8), 0), ((320, 320, 8), 0),
                              ((1280, 1280, 8), 1), ((640, 640, 33), 0)):
        *factors, gr = _hada_factors(o, i, r, torch.float32, g, cuda, offset)
        args = (*factors, 0.5)
        first = thada.hada_bwd_split(*args, gr)
        for _ in range(50):
            again = thada.hada_bwd_split(*args, gr)
            assert all(torch.equal(a, b) for a, b in zip(first, again)), (o, i, r, offset)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            other = thada.hada_bwd_split(*args, gr)
        torch.cuda.current_stream().wait_stream(side)
        assert all(torch.equal(a, c) for a, c in zip(first, other)), (o, i, r, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hada_split_graph_replay(cuda, dtype):
    """The split backward captured in a CUDA graph and replayed equals the
    eager call, in both variants."""
    g = torch.Generator(device=cuda).manual_seed(16)
    for offset in (0, 1):
        w1d, w1u, w2d, w2u, gr = _hada_factors(1280, 1280, 8, dtype, g, cuda, offset)
        n = (thada.split_fast_launches, thada.split_generic_launches)
        _graph_matches_eager(lambda: thada.hada_bwd_split(w1d, w1u, w2d, w2u, 0.5, gr))
        assert (thada.split_fast_launches - n[0],
                thada.split_generic_launches - n[1]) == ((3, 0) if offset == 0 else (0, 3))


# (M, N, K): the LoRA linear shapes of the paths that the fast variant must
# take (SDXL b4: attn q/k/v/out at 1280 and 640, ff net_0 and net_2 at
# 1280, attn2 k/v with ragged M = batch * 77; SD1.5 b8: ff net_0 at 320,
# attn2 k/v), a net_2 at 320, and two shapes ragged in every dimension (N
# and K multiples of 8 for the fast variant, N = 130 only for the generic)
LORA_SHAPES = ((4096, 1280, 1280), (16384, 640, 640), (4096, 10240, 1280), (4096, 1280, 5120),
               (308, 1280, 2048), (32768, 2560, 320), (616, 320, 768), (32768, 320, 1280),
               (37, 136, 200), (37, 130, 200))


def _lora_inputs(m, n, k, r, dtype, w_dtype, g):
    """x (M, K), W (N, K), down (R, K), up (N, R) and a cotangent (M, N),
    scaled so that y and dx are O(1)."""
    dev = g.device
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    w = (torch.randn(n, k, device=dev, generator=g) * k**-0.5).to(w_dtype)
    down = torch.randn(r, k, device=dev, generator=g) * k**-0.5
    up = torch.randn(n, r, device=dev, generator=g) * 0.1
    gy = (torch.randn(m, n, device=dev, generator=g) * min(1.0, (k / n) ** 0.5)).to(dtype)
    return x, w, down, up, gy


def _lora_both(x, w, down, up, gy, fast):
    """nt and nn once each; both must take the ``fast`` variant or not."""
    c = (tlf.launches, tlf.dx_launches, tlf.launches_fast, tlf.dx_launches_fast)
    y = tlf.lora_fused_nt(x, w, down, up, 0.5)
    dx = tlf.lora_fused_nn(gy, w, down, up, 0.5)
    f = int(fast)
    assert (tlf.launches, tlf.dx_launches, tlf.launches_fast, tlf.dx_launches_fast) == (
        c[0] + 1, c[1] + 1, c[2] + f, c[3] + f)
    return y, dx


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", ["same", "float32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_lora_fused_kernels(cuda, dtype, w_dtype):
    """Both kernels at every path shape and the ragged ones against their
    plain versions, rank 8; bf16 x with a bf16 W takes the fast variant at
    every shape whose N and K are multiples of 8, every other pair the
    generic one."""
    g = torch.Generator(device=cuda).manual_seed(7)
    wdt = dtype if w_dtype == "same" else torch.float32
    for m, n, k in LORA_SHAPES:
        x, w, down, up, gy = _lora_inputs(m, n, k, 8, dtype, wdt, g)
        fast = dtype == wdt == torch.bfloat16 and n % 8 == 0 and k % 8 == 0
        assert tlf.variant(x, w) == ("fast" if fast else "generic")
        y, dx = _lora_both(x, w, down, up, gy, fast)
        assert y.shape == (m, n) and dx.shape == (m, k) and y.dtype == dx.dtype == dtype
        _check(y, tlf.fused_lora_matmul_plain(x, w, down, up, 0.5), dtype)
        _check(dx, tlf.fused_lora_dx_plain(gy, w, down, up, 0.5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fast", "generic"])
@pytest.mark.parametrize("r", [1, 8, 16, 128, 320])
def test_cuda_lora_fused_any_rank(cuda, variant, r):
    """Every rank runs on both variants (fast: bf16; generic: fp32) and
    matches the plain versions: the factors are taken a chunk of ranks at a
    time in a fixed shared memory (rank 320 was refused before), at an SDXL
    width and at the ragged attn2 k/v shape."""
    g = torch.Generator(device=cuda).manual_seed(20 + r)
    dtype = torch.bfloat16 if variant == "fast" else torch.float32
    for m, n, k in ((1024, 1280, 1280), (308, 1280, 2048)):
        x, w, down, up, gy = _lora_inputs(m, n, k, r, dtype, dtype, g)
        y, dx = _lora_both(x, w, down, up, gy, variant == "fast")
        _check(y, tlf.fused_lora_matmul_plain(x, w, down, up, 0.5), dtype)
        _check(dx, tlf.fused_lora_dx_plain(gy, w, down, up, 0.5), dtype)


@pytest.mark.cuda
def test_cuda_lora_fused_repeats_bit_for_bit(cuda):
    """The fast variant gives the same bits 50 times over, at the small-M
    shapes (the contraction cut into slices whose partial sums are added in
    a fixed order) and the wide ones (W_eff built in registers while the
    previous stage's wgmma run)."""
    g = torch.Generator(device=cuda).manual_seed(30)
    for m, n, k in ((308, 1280, 2048), (616, 320, 768), (4096, 10240, 1280), (32768, 2560, 320)):
        x, w, down, up, gy = _lora_inputs(m, n, k, 8, torch.bfloat16, torch.bfloat16, g)
        y0, dx0 = _lora_both(x, w, down, up, gy, True)
        for _ in range(50):
            y, dx = _lora_both(x, w, down, up, gy, True)
            assert torch.equal(y, y0) and torch.equal(dx, dx0), (m, n, k)


@pytest.mark.cuda
def test_cuda_lora_fused_graph_replay(cuda):
    """Both fast kernels captured in a CUDA graph and replayed equal the
    eager calls, with and without the sliced contraction."""
    g = torch.Generator(device=cuda).manual_seed(31)
    for m, n, k in ((4096, 1280, 1280), (308, 1280, 2048)):
        x, w, down, up, gy = _lora_inputs(m, n, k, 8, torch.bfloat16, torch.bfloat16, g)
        n0 = (tlf.launches_fast, tlf.dx_launches_fast)
        _graph_matches_eager(lambda: (tlf.lora_fused_nt(x, w, down, up, 0.5),
                                      tlf.lora_fused_nn(gy, w, down, up, 0.5)))
        assert (tlf.launches_fast - n0[0], tlf.dx_launches_fast - n0[1]) == (3, 3)


# (N, C, H, W, groups): SDXL's 320- and 960-channel levels (cg = 10, 30),
# SD1.5's mid block, and an odd spatial size that takes the generic variant
GN_SHAPES = ((4, 320, 128, 128, 32), (4, 960, 64, 64, 32), (8, 1280, 8, 8, 32), (3, 60, 7, 5, 4))
# (C, H) of every GroupNorm of the SD1.5 (64x64 latents) and SDXL (128x128)
# UNets (chip_smoke.path_shapes): SD1.5 at batch 4 (serving) and 8
# (training), SDXL at batch 4
_SD15_GN = ((320, 32), (320, 64), (640, 16), (640, 32), (640, 64), (960, 32), (960, 64),
            (1280, 8), (1280, 16), (1280, 32), (1920, 16), (1920, 32), (2560, 8), (2560, 16))
_SDXL_GN = ((320, 64), (320, 128), (640, 32), (640, 64), (640, 128), (960, 64), (960, 128),
            (1280, 32), (1280, 64), (1920, 32), (1920, 64), (2560, 32))
GN_PATH_SHAPES = tuple(dict.fromkeys((n, c, h, h, 32) for n, shapes in (
    (4, _SD15_GN), (8, _SD15_GN), (4, _SDXL_GN)) for c, h in shapes))
# more groups than the card holds CTAs (each takes several in turn), and
# S = 36: fast in fp32 (whole 16-byte vectors), generic in bf16
GN_MORE = ((64, 320, 8, 8, 32), (2, 64, 6, 6, 8))


def _gn_inputs(n, c, h, w_, dtype, g, dev):
    x = (torch.randn(n, c, h, w_, device=dev, generator=g) * 2 + 0.5).to(dtype)
    w = (torch.randn(c, device=dev, generator=g) * 0.5 + 1).to(dtype)
    b = (torch.randn(c, device=dev, generator=g) * 0.5).to(dtype)
    dh = torch.randn(n, c, h, w_, device=dev, generator=g).to(dtype)
    return x, w, b, dh


def _gn_counts():
    return (tgn.fast_launches, tgn.generic_launches, tgn.bwd_fast_launches,
            tgn.bwd_generic_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
def test_cuda_group_norm_kernels(cuda, dtype, act):
    """Both directions against the plain versions at GN_SHAPES, every path
    shape and GN_MORE, each call on the variant ``variant`` names (every
    path shape fast), dgamma/dbeta with and without gamma and beta; an
    unaligned view takes the generic variant."""
    g = torch.Generator(device=cuda).manual_seed(5)
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    for n, c, h, w_, groups in GN_SHAPES + GN_PATH_SHAPES + GN_MORE:
        x, w, b, dh = _gn_inputs(n, c, h, w_, dtype, g, cuda)
        fast = (h * w_) % vec == 0
        if (n, c, h, w_, groups) in GN_PATH_SHAPES:
            assert fast
        n0, b0, v0 = tgn.launches, tgn.bwd_launches, _gn_counts()
        y, mean, rstd = tgn.group_norm_fwd(x, groups, w, b, 1e-5, act)
        _check(y, tgn.group_norm_plain(x, groups, w, b, 1e-5, act), dtype)
        got = tgn.group_norm_bwd(x, dh, groups, w, b, mean, rstd, act)
        want = tgn.group_norm_bwd_plain(x, dh, groups, w, b, 1e-5, act)
        for a, ref in zip(got, want):
            _check(a, ref, dtype)
        dx, dw, db = tgn.group_norm_bwd(x, dh, groups, None, None, mean, rstd, act,
                                        want_wb=False)
        assert dw is None and db is None
        ref_mean, ref_rstd = tgn.group_norm_stats_plain(x, groups, 1e-5)
        _check(dx, tgn.group_norm_bwd_plain(x, dh, groups, None, None, 1e-5, act,
                                            (ref_mean, ref_rstd))[0], dtype)
        assert (tgn.launches, tgn.bwd_launches) == (n0 + 1, b0 + 2)
        want_counts = (1, 0, 2, 0) if fast else (0, 1, 0, 2)
        assert tuple(a - b for a, b in zip(_gn_counts(), v0)) == want_counts, (n, c, h, w_)
        del x, dh, y, got, want, dx
    # an aligned shape seen through a view 2 elements off 16 bytes
    base = torch.randn(2 * 64 * 256 + 2, device=cuda, generator=g).to(dtype)
    x, dh = base[2:].view(2, 64, 16, 16), torch.randn(2, 64, 16, 16, device=cuda).to(dtype)
    assert tgn.variant(x, 8) == "generic" and tgn.variant(x.clone(), 8) == "fast"
    v0 = _gn_counts()
    y, mean, rstd = tgn.group_norm_fwd(x, 8, None, None, 1e-5, act)
    _check(y, tgn.group_norm_plain(x, 8, None, None, 1e-5, act), dtype)
    _check(tgn.group_norm_bwd(x, dh, 8, None, None, mean, rstd, act)[0],
           tgn.group_norm_bwd_plain(x, dh, 8, None, None, 1e-5, act)[0], dtype)
    assert tuple(a - b for a, b in zip(_gn_counts(), v0)) == (0, 1, 0, 1)


@pytest.mark.cuda
def test_cuda_group_norm_repeats_bit_for_bit(cuda):
    """The fast variant adds its partial sums in a fixed order, across a
    cluster's CTAs too: 50 calls of both directions, and one on another
    stream, give the same bits, at S = 64 (a CTA a group) and at SDXL's
    (4, 960, 128, 128), a cluster of 8 a group whose backward rereads the
    part of each slice that shared memory does not hold."""
    g = torch.Generator(device=cuda).manual_seed(14)
    side = torch.cuda.Stream()
    bwd_plan = tgn.plan(4, 960, 128 * 128, 32, torch.bfloat16, "bwd")
    assert bwd_plan.k == 8 and bwd_plan.reread > 0
    for n, c, h in ((8, 1280, 8), (4, 960, 128)):
        x, w, b, dh = _gn_inputs(n, c, h, h, torch.bfloat16, g, cuda)

        def both():
            y, mean, rstd = tgn.group_norm_fwd(x, 32, w, b, 1e-5, "silu")
            return (y, mean, rstd, *tgn.group_norm_bwd(x, dh, 32, w, b, mean, rstd, "silu"))

        v0 = _gn_counts()
        first = both()
        for _ in range(50):
            for a, ref in zip(both(), first):
                assert torch.equal(a, ref), (n, c, h)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            other = both()
        torch.cuda.current_stream().wait_stream(side)
        for a, ref in zip(other, first):
            assert torch.equal(a, ref), (n, c, h)
        assert tuple(a - b for a, b in zip(_gn_counts(), v0)) == (52, 0, 52, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_group_norm_graph_replay(cuda, dtype):
    """Both fast directions captured in a CUDA graph and replayed equal the
    eager calls: a clustered shape (SDXL's 320 x 128 x 128) and a CTA a
    group (SD1.5's 1280 x 16 x 16)."""
    g = torch.Generator(device=cuda).manual_seed(15)
    for n, c, h in ((4, 320, 128), (8, 1280, 16)):
        x, w, b, dh = _gn_inputs(n, c, h, h, dtype, g, cuda)
        y, mean, rstd = tgn.group_norm_fwd(x, 32, w, b, 1e-5, "silu")
        v0 = _gn_counts()
        _graph_matches_eager(lambda: (*tgn.group_norm_fwd(x, 32, w, b, 1e-6, None),
                                      tgn.group_norm_bwd(x, dh, 32, w, b, mean, rstd, "silu",
                                                         want_wb=False)[0]))
        assert tuple(a - b for a, b in zip(_gn_counts(), v0)) == (3, 0, 3, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_geglu_bwd_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    for b, t, f in ((4, 4096, 2560), (4, 1024, 5120), (8, 64, 5120), (2, 7, 12)):
        h_full = (torch.randn(b, t, 2 * f, device=cuda, generator=g) * 2).to(dtype)
        dy = torch.randn(b, t, f, device=cuda, generator=g).to(dtype)
        n = tgeglu.bwd_launches
        got = tgeglu.geglu_bwd(h_full, dy)
        assert tgeglu.bwd_launches == n + 1 and got.shape == h_full.shape
        _check(got, tgeglu.geglu_bwd_plain(h_full, dy), dtype)


def _grads_match(fn, plain, inputs, dtype):
    """Gradients of sum(out * ct) through the Function (kernels) and through
    autograd of the plain forward, on the same inputs."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    ct = torch.randn(out.shape, device=out.device, generator=torch.Generator(
        device=out.device).manual_seed(9)).to(out.dtype)
    got = torch.autograd.grad((out.float() * ct.float()).sum(), leaves)
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    want = torch.autograd.grad((plain(*leaves).float() * ct.float()).sum(), leaves)
    for a, b in zip(got, want):
        _check(a, b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_functions_match_autograd_of_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(2048, 640, device=cuda, generator=g) + 0.3).to(dtype)
    w = (torch.randn(640, device=cuda, generator=g) * 0.5 + 1).to(dtype)
    b = torch.randn(640, device=cuda, generator=g).to(dtype)
    _grads_match(lambda *a: tln.layer_norm(*a, 1e-5),
                 lambda *a: tln.layer_norm_plain(*a, 1e-5), (x, w, b), dtype)

    q, k, v = (torch.randn(1, 4, 1024, 40, device=cuda, generator=g).to(dtype) for _ in range(3))
    _grads_match(lambda *a: tflash.flash_attention(*a, 40**-0.5)[0],
                 lambda *a: tflash.flash_attention_plain(*a, 40**-0.5)[0], (q, k, v), dtype)
    # head-split views of (B, T, H*D) leaves, as the UNet's projections give
    # them (the gradients flow back through the views), D 40/64/80, ragged T,
    # and D = 100 through the pad copy
    for h, t, d in ((4, 1024, 40), (2, 1024, 64), (2, 1000, 80), (2, 300, 100)):
        xs = [torch.randn(1, t, h * d, device=cuda, generator=g).to(dtype) for _ in range(3)]

        def split(*a, h=h, d=d):
            return [x.unflatten(-1, (h, d)).transpose(1, 2) for x in a]

        _grads_match(lambda *a, d=d: tflash.flash_attention(*split(*a), d**-0.5)[0],
                     lambda *a, d=d: tflash.flash_attention_plain(*split(*a), d**-0.5)[0], xs,
                     dtype)

    w1d, w2d = (torch.randn(8, 1280, device=cuda, generator=g).to(dtype) for _ in range(2))
    w1u, w2u = ((0.1 * torch.randn(640, 8, device=cuda, generator=g)).to(dtype) for _ in range(2))
    _grads_match(lambda *a: thada.hada_weight(*a, 0.5),
                 lambda *a: thada.hada_weight_plain(*a, 0.5), (w1d, w1u, w2d, w2u), dtype)

    x = (torch.randn(2, 960, 16, 16, device=cuda, generator=g) + 0.3).to(dtype)
    w = (torch.randn(960, device=cuda, generator=g) * 0.5 + 1).to(dtype)
    b = torch.randn(960, device=cuda, generator=g).to(dtype)
    for act in (None, "silu"):
        _grads_match(lambda *a: tgn.group_norm_act(*a[:1], 32, *a[1:], 1e-5, act),
                     lambda *a: tgn.group_norm_plain(*a[:1], 32, *a[1:], 1e-5, act), (x, w, b),
                     dtype)

    h_full = (torch.randn(2, 256, 2560, device=cuda, generator=g) * 2).to(dtype)
    _grads_match(tgeglu.geglu_mul, tgeglu.geglu_fwd_plain, (h_full,), dtype)

    # x scaled so that the factor gradients (sums over 616 tokens) are O(1)
    # and the absolute MSE bound means what it does for the other outputs
    x = (torch.randn(2, 308, 640, device=cuda, generator=g) * 0.05).to(dtype)
    w = (torch.randn(1280, 640, device=cuda, generator=g) * 640**-0.5).to(dtype)
    down = torch.randn(8, 640, device=cuda, generator=g) * 640**-0.5
    up = torch.randn(1280, 8, device=cuda, generator=g) * 0.1
    n0 = tlf.dx_launches
    _grads_match(lambda *a: tlf.fused_lora_matmul(a[0], w, *a[1:], 0.5),
                 lambda *a: tlf.fused_lora_matmul_plain(a[0], w, *a[1:], 0.5), (x, down, up), dtype)
    assert tlf.dx_launches == n0 + 1


@pytest.mark.cuda
def test_cuda_grads_flow_through_layer_norm(cuda):
    x = torch.randn(8, 320, device=cuda, requires_grad=True)
    w = torch.ones(320, device=cuda, requires_grad=True)
    y = tln.layer_norm(x, w, torch.zeros(320, device=cuda), 1e-5)
    n = tln.bwd_launches
    (y * y).sum().backward()
    assert tln.bwd_launches == n + 1
    assert x.grad is not None and w.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.cuda
def test_cuda_norm_bwd_with_dw_db_through_the_functions(cuda):
    """The train_norm route: the LayerNorm and GroupNorm Functions at an
    SDXL b4 path shape (bf16, LayerNorm (4 x 1024, 1280), the act-free
    GroupNorm of a Transformer2DModel (4, 640, 64, 64)) with a weight and a
    bias that need gradients take the dw/db side of the fast variants
    (``bwd_wb_launches``), and dx, dw and db match autograd through the
    plain forwards on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(21)
    dt = torch.bfloat16
    for kind in ("ln", "gn"):
        if kind == "ln":
            x = torch.randn(4 * 1024, 1280, device=cuda, generator=g).to(dt)
            c = 1280
        else:
            x = torch.randn(4, 640, 64, 64, device=cuda, generator=g).to(dt)
            c = 640
        w0 = (torch.randn(c, device=cuda, generator=g) * 0.1 + 1).to(dt)
        b0 = (torch.randn(c, device=cuda, generator=g) * 0.1).to(dt)
        dy = torch.randn(x.shape, device=cuda, generator=g).to(dt)
        grads = []
        for plain in (False, True):
            xx = x.clone().requires_grad_()
            w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
            if kind == "ln":
                n = (tln.bwd_wb_launches, tln.bwd_vec_launches)
                y = (tln.layer_norm_plain(xx, w, b, 1e-5) if plain
                     else tln.layer_norm(xx, w, b, 1e-5))
            else:
                n = (tgn.bwd_wb_launches, tgn.bwd_fast_launches)
                y = (tgn.group_norm_plain(xx, 32, w, b, 1e-5, None) if plain
                     else tgn.group_norm_act(xx, 32, w, b, 1e-5))
            y.backward(dy)
            if not plain:
                ops = tln if kind == "ln" else tgn
                fast = tln.bwd_vec_launches if kind == "ln" else tgn.bwd_fast_launches
                assert (ops.bwd_wb_launches - n[0], fast - n[1]) == (1, 1), kind
            grads.append((xx.grad, w.grad, b.grad))
        for got, want in zip(*grads):
            _check(got, want, dt)


@pytest.mark.cuda
def test_cuda_merge_loha_file_uses_hada_fwd(cuda):
    """``utils.merge.merge`` of a rank-8 LoHa file on the card forms each
    layer's dW by the ``hada_fwd`` kernel (one launch a layer) and merges
    what the CPU merge, on the plain version, merges (fp32 base, fp32 bounds)."""
    import math

    from lycoris_tpu_torch.graph import ModelGraph
    from lycoris_tpu_torch.utils.merge import merge

    g = torch.Generator().manual_seed(0)
    shapes = {"attn.to_q": (1280, 1280), "attn.to_k": (640, 2048), "ff.net_0_proj": (10240, 1280),
              "proj_in": (320, 320, 1, 1)}
    base = {f"{n}.weight": torch.randn(s, generator=g) * 0.02 for n, s in shapes.items()}
    lyco = {}
    for n, (o, i, *k) in shapes.items():
        ln = "lora_unet_" + n.replace(".", "_")
        for w in ("w1", "w2"):
            lyco[f"{ln}.hada_{w}_a"] = torch.randn(o, 8, generator=g) * 0.1
            lyco[f"{ln}.hada_{w}_b"] = torch.randn(8, i * math.prod(k), generator=g) * 0.1
        lyco[f"{ln}.alpha"] = torch.tensor(4.0)
    n0 = thada.launches
    got, count = merge([], ModelGraph.from_state_dict({k: v.to(cuda) for k, v in base.items()}),
                       lyco, scale=0.8, device=cuda)
    assert count == len(shapes) and thada.launches == n0 + len(shapes)
    want, _ = merge([], ModelGraph.from_state_dict(base), lyco, scale=0.8, device="cpu")
    for n in shapes:
        w = base[f"{n}.weight"]
        _check((got["lora_unet"][n]["weight"].cpu() - w), want["lora_unet"][n]["weight"] - w,
               torch.float32)
