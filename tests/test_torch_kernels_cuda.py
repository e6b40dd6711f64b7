"""The port's CUDA kernels against their plain versions, on a CUDA card.

These tests skip without a card. They import no JAX, so they also run on
a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
tests). Bounds: the ROADMAP's per-dtype MSE (fp32 5e-6, bf16 5e-4), and a
relative L2 error (fp32 1e-4, bf16 1e-2) that holds small outputs, such as
flash O at T4096, as tightly as large ones.
"""

import pytest
import torch

from lycoris_tpu_torch.ops import flash as tflash
from lycoris_tpu_torch.ops import hada as thada
from lycoris_tpu_torch.ops import layer_norm as tln


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, h, t, d in ((4, 8, 4096, 40), (4, 8, 1024, 80), (1, 2, 1000, 128)):
        q, k, v = (torch.randn(b, h, t, d, device=cuda, generator=g).to(dtype) for _ in range(3))
        o, lse = tflash.flash_attention(q, k, v, d**-0.5)
        o_ref, lse_ref = tflash.flash_attention_plain(q, k, v, d**-0.5)
        _check(o, o_ref, dtype)
        assert float((lse - lse_ref).abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hada_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    for o, i, r in ((320, 320, 8), (10240, 1280, 8), (100, 130, 40)):
        w1d, w2d = (torch.randn(r, i, device=cuda, generator=g).to(dtype) for _ in range(2))
        w1u, w2u = ((0.1 * torch.randn(o, r, device=cuda, generator=g)).to(dtype) for _ in range(2))
        _check(thada.hada_weight(w1d, w1u, w2d, w2u, 0.5),
               thada.hada_weight_plain(w1d, w1u, w2d, w2u, 0.5), dtype)


@pytest.mark.cuda
def test_cuda_kernels_refuse_autograd(cuda):
    x = torch.randn(8, 320, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        tln.layer_norm(x, torch.ones(320, device=cuda), torch.zeros(320, device=cuda), 1e-5)
