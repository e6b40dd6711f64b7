"""The Wan cell's pieces on the CPU: its three readers on synthetic traces,
its census against the port's calls in a tiny training step and at full
size, its FLOPs, the reference's import graph, and the tiny cell's whole
traced run (the reference against the port at toy size)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_h100 import counts, counts_wan, harness, inputs
from bench_h100.reference.wan import wan_spec
from bench_h100.tiny import REPO, TINY_SIZES, run_cell, tiny_root
from bench_h100.trace import Trace

WAN = "wan-lokr-train-480p-33f"
FULL = harness.load_json(REPO / "bench_h100" / "configs" / "wan2.1-t2v-14b.json")["run"]["sizes"]


def reader(name):
    return harness.Cell(REPO, WAN, 1, 1.0, True).reader(name).read


def _kernels(*items):
    return [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d} for n, ts, d in items]


def test_flash_readers_read_the_flash_kernels_over_steps():
    tr = Trace(_kernels(("void flash_fwd_bf16_kernel<128>", 0, 300.0),
                        ("void flash_bwd_dkdv_bf16<128>", 400, 500.0),
                        ("void flash_di_kernel", 950, 50.0), ("nvjet_tst_gemm", 1000, 900.0)))
    tr.steps = 2
    assert reader("flash_ms_per_step.wan")(tr) == pytest.approx(0.85 / 2)
    tr.census_bounds_s = {"flash_fwd": 150e-6, "flash_bwd": 200e-6, "layer_norm_fwd": 1.0}
    assert reader("flash_roofline.wan")(tr) == pytest.approx(100.0 * 350 / 850)
    tr.census_bounds_s = {"flash_fwd": 150e-6}  # the backward's counter disagreed
    assert reader("flash_roofline.wan")(tr) == pytest.approx(50.0)
    tr.census_bounds_s = {}
    assert reader("flash_roofline.wan")(tr) is None


def test_flash_readers_read_none_without_flash():
    tr = Trace(_kernels(("nvjet_tst_gemm", 0, 900.0)))
    tr.steps, tr.census_bounds_s = 2, {"flash_fwd": 1e-4}
    assert reader("flash_ms_per_step.wan")(tr) is None
    assert reader("flash_roofline.wan")(tr) is None


def test_rope_reader_counts_the_ops_inside_its_spans():
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": d}
          for n, ts, d in (("lycoris.rope", 0, 10), ("lycoris.rope", 20, 5),
                           ("lycoris.forward", 0, 40))]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": ts, "dur": 0.5, "tid": 1}
           for ts in (1, 3, 9, 15, 21, 30)]
    assert reader("rope_ops_per_step.wan")(Trace(ev)) == 4.0
    assert reader("rope_ops_per_step.wan")(Trace(ev[2:])) is None


def test_full_size_census_and_flops():
    """At 480p x 33 frames: 14,040 tokens, flash at (40, 14040, 128) forward
    in both passes of the 40 checkpointed blocks and backward once, the
    cross-attention on the plain path, norm3 on the LayerNorm kernel; 0.505
    PFLOP a forward (0.338 in linears, 0.161 in self-attention)."""
    fhw = (9, 60, 104)
    assert counts_wan.tokens(FULL, fhw) == 14040
    c = counts_wan.wan_census(FULL, 1, fhw, 512, True, True)
    assert c["flash_fwd"] == {(40, 14040, 128): 80} and c["flash_bwd"] == {(40, 14040, 128): 40}
    assert c["layer_norm_fwd"] == {(14040, 5120): 80} and c["layer_norm_bwd"] == {(14040, 5120): 40}
    assert counts_wan.wan_census(FULL, 1, fhw, 512, False, True)["flash_fwd"] == {
        (40, 14040, 128): 40}
    assert not counts_wan.use_flash(14040, 512, 128) and counts_wan.use_flash(14040, 14040, 128)
    attn = 40 * counts.attention_flops(1, 14040, 14040, 5120)
    assert attn == pytest.approx(0.1615e15, rel=1e-3)
    assert counts_wan.wan_flops(FULL, 1, fhw, 512) == pytest.approx(0.5053e15, rel=1e-3)
    bounds = counts.census_bounds_s(c)
    assert bounds["flash_fwd"] == pytest.approx(80 * 4 * 40 * 14040**2 * 128 / counts.PEAK_FLOPS)


def test_census_equals_the_ports_calls_in_a_tiny_step(monkeypatch):
    """The port's flash and LayerNorm Functions run their plain directions
    on the CPU: counted there, one tiny checkpointed flow step at 1,040
    tokens (flash, ragged) calls each as often as the census says."""
    import torch
    from lycoris_tpu_torch.functional import merged
    from lycoris_tpu_torch.models.wan import WanConfig, WanModel
    from lycoris_tpu_torch.ops import flash, layer_norm
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    calls = dict.fromkeys(("flash_fwd", "flash_bwd", "layer_norm_fwd", "layer_norm_bwd"), 0)

    def counted(mod, name, key):
        orig = getattr(mod, name)

        def wrap(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrap)

    counted(flash, "flash_attention_plain", "flash_fwd")
    counted(flash, "flash_attention_bwd_plain", "flash_bwd")
    counted(layer_norm, "layer_norm_plain", "layer_norm_fwd")
    counted(layer_norm, "layer_norm_bwd_plain", "layer_norm_bwd")
    sizes = dict(TINY_SIZES["wan"])
    adapter = {"algo": "lokr", "dim": 4, "alpha": 2.0, "factor": 4,
               "targets": ["WanAttentionBlock"]}
    cpu = torch.device("cpu")
    spec = wan_spec(sizes)
    model = WanModel(WanConfig(**{**sizes, "patch_size": tuple(sizes["patch_size"])}, remat=True),
                     device="meta")
    model.load_state_dict(inputs.make_weights(spec, 3, torch.float32, cpu), assign=True)
    net = inputs.port_network(model, adapter, cpu)
    inputs.load_adapters(net, inputs.make_adapters(spec, adapter, 3, cpu)[0])
    trainer = DiffusionTrainer(model, net, weight_dtype=torch.float32, objective="flow",
                               generator=torch.Generator().manual_seed(0))
    fhw = (5, 16, 52)
    g = torch.Generator().manual_seed(1)
    batch = {"latents": torch.randn(1, 16, *fhw, generator=g),
             "context": torch.randn(1, 7, sizes["text_dim"], generator=g)}
    merged.applications = 0
    trainer.train_step(batch)
    layers = [(shape, 2) for _, shape, _ in inputs.adapted_layers(spec, adapter["targets"])]
    want = counts.census_launches(counts.with_adapter(
        counts_wan.wan_census(sizes, 1, fhw, 7, True, True),
        inputs.algo("lokr").census(layers, adapter, True)))
    assert calls == {k: want[k] for k in calls} and calls["flash_fwd"] == 4
    assert merged.applications == want["factored"]


def test_reference_imports_nothing_of_the_port_or_of_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_h100.reference.wan, bench_h100.counts_wan\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    names = set(json.loads(out.stdout.replace("'", '"')))
    assert not names & {"lycoris_tpu_torch", "lycoris_tpu", "jax", "jaxlib", "flax", "optax"}
    assert "torch" in names


def test_tiny_cell_runs_correct_and_reads_its_metrics(tmp_path):
    """The whole tiny Wan cell, traced, on the CPU: correct against the
    reference, the rope spans read, and the flash metrics None (no kernel
    runs on the CPU: the tiny clip's 48 tokens take the plain path)."""
    root = tiny_root(tmp_path / "checkout")
    line = run_cell(root, WAN, trace=True)
    assert line["correct"] is True, line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["rope_ops_per_step.wan"] > 0 and m["forward_ops_per_step.train"] > 0
    assert "flash_ms_per_step.wan" not in m and "flash_roofline.wan" not in m
    plain = run_cell(root, WAN)
    assert set(plain["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
