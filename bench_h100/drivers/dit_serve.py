"""One stream of DiT transformer calls back to back, each synchronised.

Set-up builds the port's DiT on the meta device and loads the benchmark's
weights into it, applies a LyCORIS network with the benchmark's adapter
tensors, and either leaves it live (``adapter_mode: live``: every call
re-forms W + dW in each adapted layer, ``apply_to(merged_forward=True)``)
or folds it into the weights once (``fused``: ``merge_to``). It warms up
with ``warmup_calls`` calls. The window issues calls until ``--seconds``
have passed, each timed from its issue to a synchronise after it; call i
takes request i mod ``pool_requests``. ``--trace 1`` profiles
``profile_calls`` more calls, and one more for the host's ops. Once the
window has closed and the port's state is freed, ``check_calls`` of the
window's calls, drawn from the seed, are run again by the plain
reference with the adapters and without them, and the harness compares
the outputs: the worst relative L2 gap, and the worst share of the
adapters' effect on an output (the reference's output with them less
without) that the port's output misses or overshoots along that effect.

Traffic keys: ``batch``, ``txt_tokens``, ``img_tokens``,
``pool_requests``, ``timesteps`` (rows drawn; call i takes row i mod
that), ``adapter`` (algo, dim, alpha, factor, targets), ``adapter_mode``,
``warmup_calls``, ``check_calls``, ``profile_calls``.
"""

from __future__ import annotations

import random
import statistics
import sys
import time


def _log(msg):
    print(f"[dit_serve] {msg}", file=sys.stderr, flush=True)


def port_config(cfg: dict, dtype):
    from lycoris_tpu_torch.models.dit import DiTConfig

    return DiTConfig(**cfg["run"]["sizes"], dtype=dtype)


def build(cell, dtype, device):
    """The port's model on the benchmark's weights with the benchmark's
    adapters live or merged, as the mix says."""
    import torch
    from lycoris_tpu_torch.models.dit import FluxTransformer2D

    from bench_h100 import inputs
    from bench_h100.reference.dit import dit_spec

    tr = cell.traffic
    spec = dit_spec(cell.config["run"]["sizes"])
    model = FluxTransformer2D(port_config(cell.config, dtype), device="meta", param_dtype=dtype)
    model.load_state_dict(inputs.make_weights(spec, cell.seed, dtype, device), strict=True,
                          assign=True)
    model.eval()
    algo = cell.algo()
    theta, _ = inputs.make_adapters(spec, tr["adapter"], cell.seed, device, algo)
    net = inputs.port_network(model, tr["adapter"], device, algo)
    inputs.load_adapters(net, theta)
    mode = tr["adapter_mode"]
    if mode == "live":
        net.apply_to(merged_forward=True)
    elif mode == "fused":
        with torch.profiler.record_function("merge_to"):
            net.merge_to(1.0)
    else:
        raise ValueError(f"adapter_mode {mode!r}: live or fused")
    return model, net


def program(cell, dtype, device) -> dict:
    """Set-up, the window and the traced tail; returns the outputs of the
    calls to be checked and host data, so that the port's state is freed
    when it returns."""
    import torch

    from bench_h100 import counts, inputs
    from bench_h100.harness import peak_bytes, sync, window_start
    from bench_h100.trace import traced_tail

    tr = cell.traffic
    t_imports = time.perf_counter()
    model, net = build(cell, dtype, device)
    reqs, ts = inputs.dit_requests(cell.config["run"]["sizes"], tr, cell.seed, dtype, device)
    sync(device)
    t_built = time.perf_counter()

    def call(i):
        img, txt = reqs[i % len(reqs)]
        with torch.no_grad():
            return model(img, txt, ts[i % len(ts)])

    n_warm = tr["warmup_calls"]
    for i in range(n_warm):
        call(i)
    window_start(device)
    outs, secs = [], []
    t0 = time.perf_counter()
    i = n_warm
    while time.perf_counter() - t0 < cell.seconds:
        t = time.perf_counter()
        outs.append(call(i))
        sync(device)
        secs.append(time.perf_counter() - t)
        i += 1
    window_s = time.perf_counter() - t0
    peak = peak_bytes(device)
    _log(f"set-up: imports {t_imports - cell.t_start:.3f} s, weights, model and network "
         f"{t_built - t_imports:.3f} s, {n_warm} warm-up calls (the kernel library's build or "
         f"load with them) {t0 - t_built:.3f} s")
    failed = sum(int(not bool(torch.isfinite(o).all())) for o in outs)
    pick = random.Random(inputs.sub_seed(cell.seed, "check")).sample(
        range(len(outs)), min(tr["check_calls"], len(outs)))
    out = {"checked": {n_warm + k: outs[k].float().cpu() for k in sorted(pick)},
           "setup_s": t0 - cell.t_start, "window_s": window_s, "secs": secs, "peak": peak,
           "failed": failed, "trace": None}
    del outs
    if cell.trace:
        from bench_h100.reference.dit import dit_spec

        sizes, b = cell.config["run"]["sizes"], tr["batch"]
        live = tr["adapter_mode"] == "live"  # fused: merged once at set-up, nothing a call
        layers = [(shape, 1) for _, shape, _ in
                  inputs.adapted_layers(dit_spec(sizes), tr["adapter"]["targets"]) if live]
        census = counts.with_adapter(counts.dit_census(sizes, b, tr["txt_tokens"],
                                                       tr["img_tokens"]),
                                     cell.algo().census(layers, tr["adapter"], False))

        def timed(k):
            t = time.perf_counter()
            with torch.profiler.record_function("model_call"):
                call(i + k)
            host = time.perf_counter() - t
            sync(device)
            return host

        out["trace"] = traced_tail(
            timed, tr["profile_calls"], device, census,
            counts.dit_flops(sizes, b, tr["txt_tokens"], tr["img_tokens"]), len(secs), window_s,
            bias=False)
    return out


def rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm())


def adapter_gap(got, want, base) -> float:
    """|<got - want, a> / <a, a>| with a = want - base, the adapters' effect
    on the reference's output: 0 where the port's output holds all of it,
    1 where it holds none of it (or twice it)."""
    a = (want - base).double().flatten()
    return abs(float((got - want).double().flatten() @ a / (a @ a)))


def reference_outputs(cell, calls: list, device, runs=(("fp32", True),)) -> list:
    """For each (precision, adapted) of ``runs``: {call: output} of the
    plain reference (``precision`` "fp8": the control) on the weights,
    adapters (or none) and requests regenerated from the seed."""
    import torch

    from bench_h100 import inputs
    from bench_h100.reference.common import WeightStore, no_tf32
    from bench_h100.reference.dit import dit_forward, dit_spec

    tr = cell.traffic
    sizes = cell.config["run"]["sizes"]
    dtype = getattr(torch, cell.config["run"]["dtype"])
    spec = dit_spec(sizes)
    algo = cell.algo()
    base = inputs.make_weights(spec, cell.seed, dtype, device)
    theta, scales = inputs.make_adapters(spec, tr["adapter"], cell.seed, device, algo)
    reqs, ts = inputs.dit_requests(sizes, tr, cell.seed, dtype, device)
    outs = []
    with no_tf32():
        for precision, adapted in runs:
            store = WeightStore(base, theta, scales, algo.delta) if adapted else WeightStore(base)
            out = {}
            for i in calls:
                img, txt = reqs[i % len(reqs)]
                out[i] = dit_forward(sizes, store, img, txt, ts[i % len(ts)], precision).cpu()
            outs.append(out)
    return outs


def compare(got: dict, want: dict, base: dict) -> dict:
    return {"out_rel_l2": max(rel_l2(got[i], want[i]) for i in want),
            "adapter_gap": max(adapter_gap(got[i], want[i], base[i]) for i in want)}


def control(cell, device) -> dict:
    """The fp8 control's outputs of the first ``check_calls`` window calls,
    in the program's place."""
    warm = cell.traffic["warmup_calls"]
    calls = list(range(warm, warm + cell.traffic["check_calls"]))
    return reference_outputs(cell, calls, device, (("fp8", True),))[0]


def check(cell, got: dict, device) -> dict:
    """The compared numbers of the program's (or the control's) outputs
    against the fp32 reference's, with the adapters and without."""
    t = time.perf_counter()
    want, base = reference_outputs(cell, sorted(got), device, (("fp32", True), ("fp32", False)))
    _log(f"reference: {len(want)} calls with the adapters and without in "
         f"{time.perf_counter() - t:.1f} s")
    return compare(got, want, base)


def p90(xs: list) -> float:
    return statistics.quantiles(xs, n=10, method="inclusive")[-1] if len(xs) > 1 else xs[0]


def run(cell) -> dict:
    import torch

    from bench_h100.harness import free, judge

    dtype = getattr(torch, cell.config["run"]["dtype"])
    device = torch.device(cell.device)
    tr = cell.traffic
    prog = program(cell, dtype, device)
    free(device)
    checks = check(cell, prog["checked"], device)
    secs = prog["secs"]
    n = len(secs)
    if n:
        _log(f"{n} calls in {prog['window_s']:.3f} s: median {statistics.median(secs) * 1e3:.3f} "
             f"ms, p90 {p90(secs) * 1e3:.3f} ms over {n} samples; set-up {prog['setup_s']:.3f} s")
    metrics = {"serve_steps_per_s": n * tr["batch"] / prog["window_s"],
               "serve_call_p90_ms": p90(secs) * 1e3 if n else float("nan"),
               "peak_mem_gib": prog["peak"] / 2**30, "setup_s": prog["setup_s"]}
    return {"correct": judge(checks, cell.limits) and prog["failed"] == 0 and n > 0,
            "attempted": n, "failed": prog["failed"], "metrics": metrics, "checks": checks,
            "peak_bytes": prog["peak"], "trace": prog["trace"]}
