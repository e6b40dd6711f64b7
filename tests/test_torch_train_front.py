"""The port's TOML front end (``lycoris_tpu_torch/train.py``), the trainer's
optimizer keywords, observability and examples, against the JAX package and
the repo's ``train.py``:

- ``build_lr_schedule`` equals the JAX front end's optax schedule at every
  step (constant, cosine, linear, polynomial, constant_with_warmup; with
  and without warmup), to fp32 rounding (1e-6 of the value and of lr);
- ``clip_by_global_norm`` equals optax's on both sides of the limit;
- three trainer steps with the optimizer factory (AdamW, betas 0.9/0.99,
  weight decay 0.1), the warmup schedule and the global-norm clip equal the
  JAX trainer's steps with the optax chain on the tiny UNet, on the JAX
  trainer's noise and timesteps (loss 1e-4 relative, adapter tensors 1e-5,
  ``test_torch_lifecycle``'s bounds);
- ``python -m lycoris_tpu_torch.train --device cpu`` on a tiny TOML: the
  file it writes loads in the JAX ``create_network_from_weights``; a resumed
  run continues from the saved step and ends bit for bit where the
  uninterrupted run ends;
- ``StepTimer`` and ``MetricLogger`` give the JAX versions' values and
  records on the same clock;
- the functional ``weight_gen``/``bypass_forward_diff`` of LoKr and LoHa
  against the JAX package's, and each ported example in a subprocess.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lycoris_tpu as jl
import lycoris_tpu_torch as tl
import torch_parity as tp
from lycoris_tpu import kohya as jk
from lycoris_tpu import observability as jobs
from lycoris_tpu.functional import loha as jloha
from lycoris_tpu.functional import lokr as jlokr
from lycoris_tpu.trainer import DiffusionTrainer as JTrainer
from lycoris_tpu_torch import observability as tobs
from lycoris_tpu_torch import train as ttrain
from lycoris_tpu_torch.functional import loha as tloha
from lycoris_tpu_torch.functional import lokr as tlokr
from lycoris_tpu_torch.kohya import LycorisNetworkKohya
from lycoris_tpu_torch.trainer import DiffusionTrainer, clip_by_global_norm

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)
REL = 1e-4


def _jax_front_end():
    """The repo's ``train.py`` (the JAX front end), imported from its path."""
    spec = importlib.util.spec_from_file_location("jax_train_front_end", ROOT / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def reset_presets():
    yield
    jl.LycorisNetwork.reset_preset()
    tl.LycorisNetwork.reset_preset()
    jk.LycorisNetworkKohya.reset_preset()
    LycorisNetworkKohya.reset_preset()


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear", "polynomial",
                                  "constant_with_warmup"])
@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedule_matches_optax(kind, warmup):
    cfg = {"Basics": {"max_train_steps": 40},
           "Lr_scheduler": {"lr_scheduler": kind, "lr_warmup_steps": warmup,
                            "lr_scheduler_power": 2.0}}
    want = _jax_front_end().build_lr_schedule(cfg, 3e-4)
    got = ttrain.build_lr_schedule(cfg, 3e-4)
    for step in range(48):
        # optax computes in fp32: its rounding is relative to lr, not to the value
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-6 * 3e-4,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 5))]
    norm = np.sqrt(sum(float((a * a).sum()) for a in arrays))
    assert (norm > max_norm) == (max_norm == 0.5)
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in arrays],
                                                         optax.EmptyState())
    grads = [torch.tensor(a) for a in arrays]
    clip_by_global_norm(grads, max_norm)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _jax_draws(rng, batch):
    """The JAX trainer's noise and timesteps for ``rng`` (trainer.py:163-166)."""
    noise_rng, t_rng, _ = jax.random.split(rng, 3)
    noise = jax.random.normal(noise_rng, batch.shape, dtype=jnp.float32)
    t = jax.random.randint(t_rng, (batch.shape[0],), 0, 1000)
    return torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(t)).long()


def test_optimizer_schedule_and_clip_match_jax_trainer():
    """Three steps, the lr 0, then lr/2, then lr (a 2-step warmup), each
    step's gradients clipped (the limit under their norm): the losses and
    every adapter tensor equal the JAX trainer's with the optax chain."""
    model, variables, net, m, tnet, d = tp.setup("lokr", batch=8)
    lr, max_norm = 1e-2, 1e-3
    cfg = {"Basics": {"max_train_steps": 10},
           "Lr_scheduler": {"lr_scheduler": "cosine", "lr_warmup_steps": 2}}
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(_jax_front_end().build_lr_schedule(cfg, lr), b1=0.9, b2=0.99,
                                 weight_decay=0.1))
    jtr = JTrainer(model, variables, net, optimizer=tx, weight_dtype=jnp.float32)
    tr = DiffusionTrainer(
        m, tnet, weight_dtype=torch.float32,
        optimizer=lambda groups: torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.99), eps=1e-8,
                                                   weight_decay=0.1),
        lr_schedule=ttrain.build_lr_schedule(cfg, lr), max_grad_norm=max_norm)
    batch = {"latents": d["lat"], "context": d["ctx"]}
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    for i in range(3):
        rng = jax.random.key(20 + i)
        jloss = float(jtr.train_step({k: jnp.asarray(v) for k, v in batch.items()}, rng))
        loss = float(tr._step(tbatch, *_jax_draws(rng, d["lat"]), seed=0))
        np.testing.assert_allclose(loss, jloss, rtol=REL)
        grads = [p.grad for p in tnet.parameters()]
        gnorm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))
        np.testing.assert_allclose(gnorm, max_norm, rtol=1e-5)
        assert tr.optimizer.param_groups[0]["lr"] == pytest.approx([0.0, lr / 2, lr][i])
    jtr.sync_to_network()
    for ln, lyco in tnet.lora_map.items():
        for k, v in net.lora_map[ln].params.items():
            if k != "alpha":
                np.testing.assert_allclose(lyco.params[k].detach().numpy(), np.asarray(v), **TOL)


TINY_TOML = """
[Basics]
model_config = "tiny"
seed = 5
max_train_steps = 20

[Save]
output_dir = "{out}"
output_name = "tiny"
save_every_n_steps = 1
save_state = true

[Network_setup]
network_dim = 4
network_alpha = 2
resume = true

[LyCORIS]
network_args = [ "preset=attn-mlp", "algo=loha",]

[Optimizer]
train_batch_size = 2
unet_lr = 1e-3
max_grad_norm = 1.0
scale_weight_norms = 1.0
optimizer_args = [ "weight_decay=0.1", "betas=0.9,0.99",]

[Lr_scheduler]
lr_scheduler = "cosine"
lr_warmup_steps = 1
"""


def _toml(tmp_path, name):
    out = tmp_path / name
    path = tmp_path / f"{name}.toml"
    path.write_text(TINY_TOML.format(out=out))
    return str(path), out


def test_train_cli_file_loads_in_jax_and_resume_repeats_the_run(tmp_path):
    cfg, out = _toml(tmp_path, "run")
    res = subprocess.run([sys.executable, "-m", "lycoris_tpu_torch.train", "--config", cfg,
                          "--device", "cpu", "--max_steps", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"saved {out / 'tiny.safetensors'}" in res.stdout
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "tiny-000001.safetensors",
                                       "tiny.safetensors", "train_state.pt"]
    rec = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rec] == [0] and np.isfinite(rec[0]["loss"])

    # the file loads in the JAX package's kohya front end, every adapter
    _, _, ugraph, _ = tp.jax_unet()
    jnet, sd = jk.create_network_from_weights(1.0, str(out / "tiny.safetensors"), None, None,
                                              ugraph)
    names = {k.split(".")[0] for k in sd}
    assert len(names) == 84 and {lyco.lora_name for lyco in jnet.loras} == names
    assert type(jnet.loras[0]).__name__ == "LohaModule"

    # resumed from step 2 to 3, against an uninterrupted 3-step run
    resumed = ttrain.main(["--config", cfg, "--device", "cpu", "--max_steps", "3"])
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 1
    cfg2, out2 = _toml(tmp_path, "whole")
    whole = ttrain.main(["--config", cfg2, "--device", "cpu", "--max_steps", "3"])
    assert whole["start_step"] == 0 and resumed["losses"] == whole["losses"][2:]
    a = tl.wrapper.load_file_sd(resumed["saved"])
    b = tl.wrapper.load_file_sd(whole["saved"])
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_train_cli_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m lycoris_tpu_torch.train
    --device cpu`` (gloo, the global batch of 2 split over the data axis):
    the one-process run's losses and file; rank 0 alone writes the files."""
    cfg, out = _toml(tmp_path, "two")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", "-m", "lycoris_tpu_torch.train",
                          "--config", cfg, "--device", "cpu", "--max_steps", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=110, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("saved ") == 1
    cfg1, _ = _toml(tmp_path, "one")
    one = ttrain.main(["--config", cfg1, "--device", "cpu", "--max_steps", "2"])
    rec = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rec] == [0]
    np.testing.assert_allclose(rec[0]["loss"], one["losses"][0], rtol=1e-5)
    a = tl.wrapper.load_file_sd(str(out / "tiny.safetensors"))
    b = tl.wrapper.load_file_sd(one["saved"])
    assert set(a) == set(b)
    for k in a:  # fp16 files: one rounding step apart at most
        torch.testing.assert_close(a[k], b[k], rtol=1e-3, atol=1e-5)


def test_train_needs_the_card_unless_told_cpu(tmp_path, monkeypatch):
    cfg, _ = _toml(tmp_path, "card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--config", cfg, "--max_steps", "1"])
    assert "--device cpu" in str(e.value)


def test_step_timer_and_metric_logger_match_jax(tmp_path, monkeypatch):
    clock = iter(np.arange(100) * 0.25 + np.arange(100) ** 2 * 0.01)
    ticks = [float(next(clock)) for _ in range(100)]
    timers = {"jax": jobs.StepTimer(ema=0.8, sync_every=3),
              "port": tobs.StepTimer(ema=0.8, sync_every=3)}
    seen = {}
    for name, timer in timers.items():
        it = iter(ticks)
        monkeypatch.setattr("time.perf_counter", lambda: next(it))
        seen[name] = [timer.step(None) for _ in range(20)] + [timer.steps_per_sec]
    assert seen["port"] == seen["jax"] and seen["port"][-1] is not None

    monkeypatch.setattr("time.time", lambda: 1234.5)
    paths = {}
    for name, mod, val in (("jax", jobs, jnp.float32(0.25)), ("port", tobs, torch.tensor(0.25))):
        paths[name] = tmp_path / name / "metrics.jsonl"
        logger = mod.MetricLogger(str(paths[name]), stdout_every=2)
        logger.log(0, loss=val, steps_per_sec=3.0, note="x")
        logger.log(10, loss=1.5)
        logger.close()
    assert paths["port"].read_text() == paths["jax"].read_text()


def test_trace_and_first_call_time(tmp_path):
    with tobs.trace(str(tmp_path / "prof")):
        torch.ones(64).sum()
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    out, dt = tobs.log_compile_time(lambda a: a * 2, torch.ones(3), label="probe")
    assert torch.equal(out, torch.full((3,), 2.0)) and dt >= 0


@pytest.mark.parametrize("shape", [(64, 96), (32, 16, 3, 3)])
@pytest.mark.parametrize("decompose_both", [False, True])
def test_functional_weight_gen_and_bypass_match_jax(shape, decompose_both):
    """The port's ``weight_gen`` gives the JAX one's slots and shapes; with
    the JAX factors, ``bypass_forward_diff`` and ``diff_weight`` agree."""
    key = jax.random.key(0)
    jw = jlokr.weight_gen(key, shape, 4, factor=4, decompose_both=decompose_both)
    tw = tlokr.weight_gen(shape, 4, factor=4, decompose_both=decompose_both)
    assert [None if w is None else tuple(w.shape) for w in tw] == [
        None if w is None else tuple(w.shape) for w in jw]
    jh = jloha.weight_gen(key, shape, 4, tucker=len(shape) > 2)
    th = tloha.weight_gen(shape, 4, tucker=len(shape) > 2)
    assert [None if w is None else tuple(w.shape) for w in th] == [
        None if w is None else tuple(w.shape) for w in jh]
    if len(shape) > 2:
        return
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, shape[1])).astype(np.float32)
    for jmod, tmod, ws in ((jlokr, tlokr, jw), (jloha, tloha, jh)):
        ws = [None if w is None else np.asarray(w) + 0.01 for w in ws]
        want = jmod.bypass_forward_diff(jnp.asarray(x), None,
                                        *[None if w is None else jnp.asarray(w) for w in ws])
        got = tmod.bypass_forward_diff(torch.tensor(x), None,
                                       *[None if w is None else torch.tensor(w) for w in ws])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


EXAMPLES = {
    "sdxl_finetune_example": (["--tiny"], "finite: True"),
    "standalone_example": ([], "merged 3 layers"),
    "functional_example": ([], "loha bypass == rebuilt"),
    "stacked_wrapper_demo": (["--train"], "trained stacked lokr 20 steps"),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, marker = EXAMPLES[name]
    if name in ("sdxl_finetune_example", "standalone_example"):
        args = [*args, "--out", str(tmp_path / "adapter.safetensors")]
    res = subprocess.run([sys.executable, "-m", f"lycoris_tpu_torch.examples.{name}",
                          "--device", "cpu", *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert marker in res.stdout
    if name == "functional_example":
        errs = [float(line.split(":")[-1]) for line in res.stdout.splitlines()
                if "bypass == rebuilt" in line]
        assert len(errs) == 2 and max(errs) < 1e-5
