"""DoRA LoHa and max-norm on a CUDA card: a DoRA LoHa layer's gradients
(the four factors and ``dora_scale``) with its dW from the LoHa kernels,
against the same layer with the plain dW, and max-norm on the card against
the CPU. These tests skip without a card and import no JAX:

    python -m pytest --noconftest -q tests/test_torch_dora_cuda.py

Bounds: relative L2 fp32 1e-4, bf16 1e-2 (the ROADMAP's kernel bounds, as
tests/test_torch_kernels_cuda.py).
"""

import pytest
import torch

from lycoris_tpu_torch.modules import LayerInfo, LohaModule
from lycoris_tpu_torch.ops import hada as thada

REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _dora_loha(dev, wd_on_out, seed=0):
    """A (1280, 1280) rank-8 DoRA LoHa layer (a SDXL path shape) with every
    factor nonzero, and its base weight."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(1280, 1280, generator=g, device=dev) * 0.02
    m = LohaModule("t", LayerInfo.linear(1280, 1280), 1.0, 8, 4.0, weight_decompose=True,
                   wd_on_out=wd_on_out, org_weight=w, device=dev)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
    return m, w


def _grads(m, w, x, dy):
    for p in m.parameters():
        p.grad = None
    w_m = m.get_merged_weight(w)[0]
    y = torch.nn.functional.linear(x, w_m.to(x.dtype))
    (y.float() * dy).sum().backward()
    return {k: p.grad.clone() for k, p in m.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd_on_out", [True, False])
def test_cuda_dora_loha_grads_match_plain(cuda, dtype, wd_on_out, monkeypatch):
    m, w = _dora_loha(cuda, wd_on_out)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4096, 1280, generator=g, device=cuda).to(dtype)
    dy = torch.randn(4096, 1280, generator=g, device=cuda)
    w = w.to(dtype)
    fwd, bwd = thada.fast_launches, thada.bwd_fast_launches
    got = _grads(m, w, x, dy)
    assert (thada.fast_launches, thada.bwd_fast_launches) == (fwd + 1, bwd + 1)
    monkeypatch.setattr(thada, "supported", lambda *a: False)  # the plain dW
    want = _grads(m, w, x, dy)
    assert thada.fast_launches == fwd + 1
    assert set(got) == set(want) and "dora_scale" in got
    for k in want:
        assert bool(torch.isfinite(got[k]).all()), k
        assert _rel(got[k], want[k]) <= REL[dtype], (k, _rel(got[k], want[k]))


@pytest.mark.cuda
def test_cuda_max_norm_matches_cpu(cuda):
    """LoHa's max-norm on the card (its dW from the LoHa forward kernel)
    scales ``scalar`` as on the CPU, and returns device tensors."""
    m, _ = _dora_loha(cuda, True)
    cpu = LohaModule("t", LayerInfo.linear(1280, 1280), 1.0, 8, 4.0, weight_decompose=True)
    cpu.load_state_dict({k: v.cpu() for k, v in m.custom_state_dict().items()})
    norm = float(m.get_diff_weight()[0].detach().norm())
    n = thada.launches
    _, scaled, after = m.apply_max_norm(norm / 2)
    assert thada.launches == n + 1
    assert scaled.device.type == "cuda" and after.device.type == "cuda" and bool(scaled)
    _, scaled_cpu, after_cpu = cpu.apply_max_norm(norm / 2)
    assert bool(scaled_cpu)
    assert abs(float(after) - float(after_cpu)) <= 1e-4 * float(after_cpu)
    assert abs(float(m._p("scalar")) - float(cpu._p("scalar"))) <= 1e-4
