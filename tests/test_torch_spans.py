"""The port's program spans (``observability.span``): no RecordFunction
with no profiler running; under ``observability.trace()`` a tiny-UNet
``DiffusionTrainer`` step opens its phases as sibling spans that cover the
step, and one ``lycoris.merge`` for every W + dW the step forms; a tiny-DiT
call with LoKr live opens one ``lycoris.merge`` per adapted layer."""

import json
import os

import pytest
import torch

import lycoris_tpu_torch as tl
from lycoris_tpu_torch import observability
from lycoris_tpu_torch.functional import merged as fm
from lycoris_tpu_torch.models.dit import FluxTransformer2D, tiny_dit_config
from lycoris_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from lycoris_tpu_torch.trainer import DiffusionTrainer

TINY = dict(block_out_channels=(32, 64), layers_per_block=1, transformer_depth=(0, 2),
            mid_transformer_depth=1, context_dim=32, head_dim=16, norm_groups=8,
            addition_embed_dim=16)
PHASES = ("lycoris.forward", "lycoris.backward", "lycoris.all_reduce", "lycoris.clip",
          "lycoris.optimizer", "lycoris.max_norm")


def lokr(model, targets):
    tl.LycorisNetwork.apply_preset({"target_module": targets})
    try:
        net = tl.create_lycoris(model, 1.0, 4, 1.0, algo="lokr", factor=4, device="cpu")
    finally:
        tl.LycorisNetwork.reset_preset()
    with torch.no_grad():  # LoKr starts with dW = 0; give every factor a value
        for p in net.parameters():
            p.add_(0.01 * torch.randn_like(p))
    return net


def ranges(logdir):
    """[(name, start, end)] of the trace's ``user_annotation`` events, by start."""
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"), key=lambda r: r[1])


def test_span_with_no_profiler_is_the_shared_null_context(monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    assert observability.span("lycoris.forward") is observability.span("lycoris.merge")

    def made(*args, **kwargs):
        raise AssertionError("a RecordFunction was made with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", made)
    with observability.span("lycoris.merge"):
        pass


@pytest.mark.parametrize("mode", ["interceptor", "premerge"])
def test_train_step_phases_cover_the_step_and_merges_are_counted(tmp_path, monkeypatch, mode):
    """Interceptor: the merged forward with the 64-wide layers factored
    (``FACTORED_MIN`` 24), so every layer merges in the forward and again in
    its checkpointed block's recompute, and each factored layer once more in
    its backward. Premerge (with the clip and max-norm): one merge a layer."""
    monkeypatch.setattr(fm, "FACTORED_MIN", 24)
    torch.manual_seed(0)
    model = UNet2DConditionModel(UNetConfig(**TINY, remat="transformer"), device="cpu")
    net = lokr(model, ["Transformer2DModel"])
    kw = {} if mode == "interceptor" else {"max_grad_norm": 1.0, "scale_weight_norms": 1.0}
    trainer = DiffusionTrainer(model, net, weight_dtype=torch.float32, merge_mode=mode, **kw)
    batch = {"latents": torch.randn(2, 4, 8, 8), "context": torch.randn(2, 6, 32),
             "added_cond": torch.randn(2, 16)}
    trainer.train_step(batch)  # first-call set-up outside the trace
    with observability.trace(str(tmp_path)):
        with observability.span("test.step"):
            trainer.train_step(batch)
    rs = ranges(tmp_path)
    (_, lo, hi), = [r for r in rs if r[0] == "test.step"]
    phases = [r for r in rs if r[0] in PHASES]
    want = ["lycoris.forward", "lycoris.backward", "lycoris.optimizer"]
    if mode == "premerge":
        want = ["lycoris.forward", "lycoris.backward", "lycoris.clip", "lycoris.optimizer",
                "lycoris.max_norm"]
    assert [name for name, _, _ in phases] == want
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))  # siblings, in order
    assert lo <= phases[0][1] and phases[-1][2] <= hi
    assert sum(e - s for _, s, e in phases) >= 0.95 * (hi - lo)
    n = len(net.loras)
    factored = sum(fm.worth_factoring(*lyco.shape[:2], fm.FACTORED_MIN) for lyco in net.loras
                   if lyco.module_type == "linear")
    assert 0 < factored < n
    merges = [r for r in rs if r[0] == "lycoris.merge"]
    assert len(merges) == (2 * n + factored if mode == "interceptor" else n)
    fwd = phases[0]
    inside = [r for r in merges if fwd[1] <= r[1] and r[2] <= fwd[2]]
    assert len(inside) == n  # the forward's merges nest in its span


def test_dit_call_merges_each_adapted_layer_once(tmp_path):
    torch.manual_seed(0)
    model = FluxTransformer2D(tiny_dit_config(), device="cpu").eval()
    net = lokr(model, ["DoubleStreamBlock", "SingleStreamBlock"])
    net.apply_to(merged_forward=True)
    img, txt = torch.randn(1, 16, 8), torch.randn(1, 8, 16)
    with observability.trace(str(tmp_path)), torch.no_grad():
        model(img, txt, torch.tensor([500.0]))
    assert sum(r[0] == "lycoris.merge" for r in ranges(tmp_path)) == len(net.loras) > 0
