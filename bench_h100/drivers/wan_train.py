"""Closed-loop adapter training of the Wan2.1 video DiT by flow matching:
``DiffusionTrainer.train_step`` back to back on the cell's clips.

As ``unet_train.py``, whose readings and comparison it shares: set-up
builds the port's ``WanModel`` on the meta device and loads the
benchmark's weights into it, applies a LyCORIS network with the
benchmark's adapter tensors, builds one trainer (``objective="flow"``) and
drives it through its first ``check_steps`` steps on distinct clips; the
window runs steps until ``--seconds`` have passed; ``--trace 1`` profiles
``profile_steps`` more steps and one for the host's ops. Once the port's
state is freed, the reference (:class:`..reference.wan.TrainReference`)
follows the first steps from the same seed, and the harness compares each
step's loss, every leaf's first gradient and every leaf's change.

It imports the port's ``models.wan`` before anything else, so that a port
without the model fails within seconds.

Traffic keys: ``batch``, ``latent_fhw`` (latent frames, height, width),
``context_tokens``, ``pool_batches``, ``adapter`` (algo, dim, alpha,
factor, targets), ``lr``, ``merged_forward``, ``objective``,
``check_steps``, ``ref_qblock`` (queries a reference attention block),
``profile_steps``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path


def _log(msg):
    print(f"[wan_train] {msg}", file=sys.stderr, flush=True)


def _unet_train():
    """The UNet driver, whose first-steps readings and comparison this one shares."""
    from bench_h100.harness import load_module

    return load_module(Path(__file__).resolve().parent / "unet_train.py", "driver_unet_train")


def port_config(cfg: dict):
    from lycoris_tpu_torch.models.wan import WanConfig

    sizes = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["run"]["sizes"].items()}
    return WanConfig(**sizes, remat=cfg["run"]["remat"])


def wan_batches(sizes: dict, traffic: dict, seed: int, dtype, device) -> list:
    """``pool_batches`` distinct clips: latents (B, in_dim, F, H, W) fp32 and
    context (B, context_tokens, text_dim) in ``dtype``, as cached VAE
    latents and umT5 outputs would be."""
    import torch

    from bench_h100 import inputs

    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, "batches"))
    p, b = traffic["pool_batches"], traffic["batch"]
    lat = torch.randn((p, b, sizes["in_dim"], *traffic["latent_fhw"]), generator=gen,
                      device=device)
    ctx = torch.randn((p, b, traffic["context_tokens"], sizes["text_dim"]), generator=gen,
                      device=device).to(dtype)
    return [{"latents": lat[i], "context": ctx[i]} for i in range(p)]


def build(cell, dtype, device):
    """The port's model, network and trainer on the benchmark's tensors;
    [(layer, key, parameter)] of the trainable leaves."""
    import torch
    from lycoris_tpu_torch.models.wan import WanModel
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    from bench_h100 import inputs
    from bench_h100.reference.wan import wan_spec

    tr = cell.traffic
    spec = wan_spec(cell.config["run"]["sizes"])
    model = WanModel(port_config(cell.config), device="meta", param_dtype=dtype)
    model.load_state_dict(inputs.make_weights(spec, cell.seed, dtype, device), strict=True,
                          assign=True)
    algo = cell.algo()
    theta, _ = inputs.make_adapters(spec, tr["adapter"], cell.seed, device, algo)
    net = inputs.port_network(model, tr["adapter"], device, algo)
    leaves = inputs.load_adapters(net, theta)
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(cell.seed, "noise"))
    trainer = DiffusionTrainer(model, net, lr=tr["lr"], weight_dtype=dtype,
                               merged_forward=tr["merged_forward"], generator=gen,
                               objective=tr["objective"])
    return trainer, leaves


def reference_steps(cell, n: int, precision: str, device) -> dict:
    """The first steps' readings from the plain reference (or the fp8
    control) on tensors regenerated from the seed."""
    import torch

    from bench_h100 import inputs
    from bench_h100.reference.common import no_tf32
    from bench_h100.reference.wan import TrainReference, wan_spec

    tr = cell.traffic
    sizes = cell.config["run"]["sizes"]
    dtype = getattr(torch, cell.config["run"]["dtype"])
    spec = wan_spec(sizes)
    base = inputs.make_weights(spec, cell.seed, dtype, device)
    algo = cell.algo()
    theta, scales = inputs.make_adapters(spec, tr["adapter"], cell.seed, device, algo)
    batches = wan_batches(sizes, tr, cell.seed, dtype, device)
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(cell.seed, "noise"))
    with no_tf32():
        ref = TrainReference(sizes, base, theta, scales, algo.delta, gen, lr=tr["lr"],
                             precision=precision, qblock=tr["ref_qblock"])
        theta0 = [p.detach().clone() for p in ref.leaves]
        losses, g1 = [], None
        for i in range(n):
            loss, grads = ref.step(batches[i])
            losses.append(loss)
            if i == 0:
                g1 = torch.stack([g.norm() for g in grads])
            del grads
        change = torch.stack([(p.detach() - p0).norm() for p, p0 in zip(ref.leaves, theta0)])
    keys = [f"{layer}/{key}" for layer, key in ref.keys]
    return {"loss": losses, "g1": dict(zip(keys, g1.tolist())),
            "change": dict(zip(keys, change.tolist()))}


def program(cell, dtype, device) -> dict:
    """Set-up, the window and the traced tail; returns host data only, so
    that the port's state is freed when it returns."""
    import lycoris_tpu_torch.models.wan  # noqa: F401  (a port without the model stops here)
    import torch

    from bench_h100 import counts, counts_wan, inputs
    from bench_h100.harness import peak_bytes, sync, window_start
    from bench_h100.trace import traced_tail

    tr = cell.traffic
    sizes = cell.config["run"]["sizes"]
    n = tr["check_steps"]
    t = time.perf_counter()
    trainer, leaves = build(cell, dtype, device)
    batches = wan_batches(sizes, tr, cell.seed, dtype, device)
    sync(device)
    t_built = time.perf_counter()
    first = _unet_train().first_steps(trainer, batches, leaves, n)
    _log(f"set-up: imports {t - cell.t_start:.3f} s, weights, model, network, trainer and "
         f"clips {t_built - t:.3f} s, {n} checked steps (the kernel library's build or load "
         f"with them) {time.perf_counter() - t_built:.3f} s")
    window_start(device)
    t0 = time.perf_counter()
    losses, i = [], n
    while time.perf_counter() - t0 < cell.seconds:
        losses.append(trainer.train_step(batches[i % len(batches)]))
        i += 1
    sync(device)
    window_s = time.perf_counter() - t0
    peak = peak_bytes(device)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    out = {"checked": first, "setup_s": t0 - cell.t_start, "window_s": window_s,
           "steps": len(losses), "peak": peak, "failed": failed, "trace": None}
    if cell.trace:
        from bench_h100.reference.wan import wan_spec

        b, fhw, txt = tr["batch"], tr["latent_fhw"], tr["context_tokens"]
        remat = cell.config["run"]["remat"]
        layers = [(shape, 2 if remat else 1) for _, shape, _ in
                  inputs.adapted_layers(wan_spec(sizes), tr["adapter"]["targets"])]
        census = counts.with_adapter(counts_wan.wan_census(sizes, b, fhw, txt, True, remat),
                                     cell.algo().census(layers, tr["adapter"], True))

        def step(k):
            t = time.perf_counter()
            with torch.profiler.record_function("train_step"):
                trainer.train_step(batches[(i + k) % len(batches)])
            return time.perf_counter() - t

        out["trace"] = traced_tail(step, tr["profile_steps"], device, census,
                                   3 * counts_wan.wan_flops(sizes, b, fhw, txt), len(losses),
                                   window_s)
    return out


def control(cell, device) -> dict:
    """The fp8 control's readings, in the program's place."""
    return reference_steps(cell, cell.traffic["check_steps"], "fp8", device)


def check(cell, got: dict, device) -> dict:
    """The compared numbers of the program's (or the control's) readings
    against the fp32 reference's."""
    n = cell.traffic["check_steps"]
    t = time.perf_counter()
    want = reference_steps(cell, n, "fp32", device)
    _log(f"reference: {n} steps in {time.perf_counter() - t:.1f} s; program losses "
         f"{got['loss']}, reference {want['loss']}")
    return _unet_train().compare(got, want)


def run(cell) -> dict:
    import lycoris_tpu_torch.models.wan  # noqa: F401  (a port without the model stops here)
    import torch

    from bench_h100.harness import free, judge

    dtype = getattr(torch, cell.config["run"]["dtype"])
    device = torch.device(cell.device)
    prog = program(cell, dtype, device)
    free(device)
    checks = check(cell, prog["checked"], device)
    metrics = {"train_samples_per_s": prog["steps"] * cell.traffic["batch"] / prog["window_s"],
               "peak_mem_gib": prog["peak"] / 2**30, "setup_s": prog["setup_s"]}
    _log(f"{prog['steps']} steps in {prog['window_s']:.3f} s; set-up {prog['setup_s']:.3f} s")
    return {"correct": judge(checks, cell.limits) and prog["failed"] == 0 and prog["steps"] > 0,
            "attempted": prog["steps"], "failed": prog["failed"], "metrics": metrics,
            "checks": checks, "peak_bytes": prog["peak"], "trace": prog["trace"]}
