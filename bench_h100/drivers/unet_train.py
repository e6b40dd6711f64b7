"""Closed-loop adapter training of a UNet: ``DiffusionTrainer.train_step``
back to back on the cell's batches.

Set-up builds the port's UNet on the meta device and loads the
benchmark's weights into it, applies a LyCORIS network and loads the
benchmark's adapter tensors, builds one trainer, and drives it through its
first ``check_steps`` steps on distinct batches: these warm up every shape
and are what the reference follows. The window then runs steps until
``--seconds`` have passed and synchronises. ``--trace 1`` profiles
``profile_steps`` more steps, and one more for the host's ops
(:func:`..trace.profile`). Once the window has closed and the port's
state is freed, the reference follows the first steps from the same seed
(:class:`..reference.unet.TrainReference`) and the harness compares each
step's loss, every leaf's first gradient (from AdamW's first moment after
one step) and every leaf's change after the first steps.

Traffic keys: ``batch``, ``latent_hw``, ``context_tokens``,
``pool_batches``, ``adapter`` (algo, dim, alpha, factor, targets), ``lr``,
``merged_forward``, ``check_steps``, ``ref_block`` (rows a reference
block), ``profile_steps``.
"""

from __future__ import annotations

import statistics
import sys
import time

BETA1 = 0.9  # AdamW's first-moment decay: exp_avg after one step is (1 - BETA1) * grad


def _log(msg):
    print(f"[unet_train] {msg}", file=sys.stderr, flush=True)


def port_config(cfg: dict, dtype):
    from lycoris_tpu_torch.models.unet import UNetConfig

    sizes = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["run"]["sizes"].items()}
    return UNetConfig(**sizes, remat=cfg["run"]["remat"], dtype=dtype)


def build(cell, dtype, device):
    """The port's model, network and trainer on the benchmark's tensors;
    [(layer, key, parameter)] of the trainable leaves."""
    import torch
    from lycoris_tpu_torch.models.unet import UNet2DConditionModel
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    from bench_h100 import inputs
    from bench_h100.reference.unet import unet_spec

    tr = cell.traffic
    sizes = cell.config["run"]["sizes"]
    spec = unet_spec(sizes)
    base = inputs.make_weights(spec, cell.seed, dtype, device)
    model = UNet2DConditionModel(port_config(cell.config, dtype), device="meta", param_dtype=dtype)
    model.load_state_dict(base, strict=True, assign=True)
    algo = cell.algo()
    theta, _ = inputs.make_adapters(spec, tr["adapter"], cell.seed, device, algo)
    net = inputs.port_network(model, tr["adapter"], device, algo)
    leaves = inputs.load_adapters(net, theta)
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(cell.seed, "noise"))
    trainer = DiffusionTrainer(model, net, lr=tr["lr"], weight_dtype=dtype,
                               merged_forward=tr["merged_forward"], generator=gen)
    return trainer, leaves


def first_steps(trainer, batches, leaves, n: int) -> dict:
    """The program's readings over its first ``n`` steps: each loss, each
    leaf's first gradient norm (from AdamW's state after step 1) and its
    change after step n, keyed "layer/key"."""
    import torch

    theta0 = [p.detach().clone() for *_, p in leaves]
    losses, g1 = [], None
    for i in range(n):
        losses.append(trainer.train_step(batches[i]))
        if i == 0:
            st = trainer.optimizer.state  # no moment: the step never reached the optimizer
            nan = torch.tensor(float("nan"), device=leaves[0][2].device)
            g1 = torch.stack([st[p]["exp_avg"].norm() if "exp_avg" in st.get(p, {}) else nan
                              for *_, p in leaves]) / (1 - BETA1)
    change = torch.stack([(p.detach() - p0).norm() for (*_, p), p0 in zip(leaves, theta0)])
    keys = [f"{layer}/{key}" for layer, key, _ in leaves]
    return {"loss": [float(x) for x in losses], "g1": dict(zip(keys, g1.tolist())),
            "change": dict(zip(keys, change.tolist()))}


def reference_steps(cell, n: int, precision: str, device) -> dict:
    """The same readings from the plain reference (or the fp8 control) on
    tensors regenerated from the seed."""
    import torch

    from bench_h100 import inputs
    from bench_h100.reference.common import no_tf32
    from bench_h100.reference.unet import TrainReference, unet_spec

    tr = cell.traffic
    sizes = cell.config["run"]["sizes"]
    dtype = getattr(torch, cell.config["run"]["dtype"])
    spec = unet_spec(sizes)
    base = inputs.make_weights(spec, cell.seed, dtype, device)
    algo = cell.algo()
    theta, scales = inputs.make_adapters(spec, tr["adapter"], cell.seed, device, algo)
    batches = inputs.unet_batches(sizes, tr, cell.seed, dtype, device)
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(cell.seed, "noise"))
    with no_tf32():
        ref = TrainReference(sizes, base, theta, scales, algo.delta, gen, lr=tr["lr"],
                             precision=precision, block=tr["ref_block"])
        theta0 = [p.detach().clone() for p in ref.leaves]
        losses, g1 = [], None
        for i in range(n):
            loss, grads = ref.step(batches[i])
            losses.append(loss)
            if i == 0:
                g1 = torch.stack([g.norm() for g in grads])
        change = torch.stack([(p.detach() - p0).norm() for p, p0 in zip(ref.leaves, theta0)])
    keys = [f"{layer}/{key}" for layer, key in ref.keys]
    return {"loss": losses, "g1": dict(zip(keys, g1.tolist())),
            "change": dict(zip(keys, change.tolist()))}


def leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's |norm - reference norm| over the larger of that
    leaf's reference norm and the median leaf's."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def compare(got: dict, want: dict) -> dict:
    """The compared numbers of a program (or control) against the reference.
    The change leaves out leaves whose reference gradient is under a
    thousandth of the median leaf's (moved by round-off alone)."""
    n = len(want["loss"])
    med = statistics.median(want["g1"].values())
    keep = {k for k, v in want["g1"].items() if v >= 1e-3 * med}
    return {"loss_gap": max(abs(g - w) / abs(w) for g, w in zip(got["loss"][:n], want["loss"])),
            "grad_gap": leaf_gap(got["g1"], want["g1"]),
            "change_gap": leaf_gap(got["change"], want["change"], keep)}


def program(cell, dtype, device) -> dict:
    """Set-up, the window and the traced tail; returns host data only, so
    that the port's state is freed when it returns."""
    import torch

    from bench_h100 import counts, inputs
    from bench_h100.harness import peak_bytes, sync, window_start
    from bench_h100.trace import traced_tail

    tr = cell.traffic
    n = tr["check_steps"]
    t = time.perf_counter()
    trainer, leaves = build(cell, dtype, device)
    batches = inputs.unet_batches(cell.config["run"]["sizes"], tr, cell.seed, dtype, device)
    sync(device)
    t_built = time.perf_counter()
    first = first_steps(trainer, batches, leaves, n)
    _log(f"set-up: imports {t - cell.t_start:.3f} s, weights, model, network, trainer and "
         f"batches {t_built - t:.3f} s, {n} checked steps (the kernel library's build or load "
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
        from bench_h100.reference.unet import unet_spec

        sizes, b, hw = cell.config["run"]["sizes"], tr["batch"], tr["latent_hw"]
        remat = {**sizes, "remat": cell.config["run"]["remat"]}
        layers = [(shape, counts.unet_passes(remat, block, True)) for _, shape, block
                  in inputs.adapted_layers(unet_spec(sizes), tr["adapter"]["targets"])]
        census = counts.with_adapter(counts.unet_census(remat, b, hw, train=True),
                                     cell.algo().census(layers, tr["adapter"], True))

        def step(k):
            t = time.perf_counter()
            with torch.profiler.record_function("train_step"):
                trainer.train_step(batches[(i + k) % len(batches)])
            return time.perf_counter() - t

        out["trace"] = traced_tail(step, tr["profile_steps"], device, census,
                                   3 * counts.unet_flops(sizes, b, hw), len(losses), window_s)
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
    return compare(got, want)


def run(cell) -> dict:
    import torch

    from bench_h100.harness import free, judge

    dtype = getattr(torch, cell.config["run"]["dtype"])
    device = torch.device(cell.device)
    tr = cell.traffic
    prog = program(cell, dtype, device)
    free(device)
    checks = check(cell, prog["checked"], device)
    b = tr["batch"]
    metrics = {"train_samples_per_s": prog["steps"] * b / prog["window_s"],
               "peak_mem_gib": prog["peak"] / 2**30, "setup_s": prog["setup_s"]}
    _log(f"{prog['steps']} steps in {prog['window_s']:.3f} s; set-up {prog['setup_s']:.3f} s")
    return {"correct": judge(checks, cell.limits) and prog["failed"] == 0 and prog["steps"] > 0,
            "attempted": prog["steps"], "failed": prog["failed"], "metrics": metrics,
            "checks": checks, "peak_bytes": prog["peak"], "trace": prog["trace"]}

