"""Readings that set a cell's limits: the compared numbers of sound runs of
the port over many seeds, of the control (the reference in fp8 in the
port's place) and of planted faults, at the cell's own size, in one
process. The benchmark's runs never run this.

    python3 bench_h100/calibrate.py --workload <cell> --seeds 11 12 13 \\
        [--control 11 12 13] [--fault <fault> [<fault> ...] --fault-seeds 11 12 13] \\
        [--seconds 3] [--out calibrate.jsonl]

with a fault of :func:`planted`.

Each seed prints one JSON line: the cell, the seed, what ran in the port's
place ("program", "control" or the fault) and the compared numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def planted(fault: str | None):
    """The port broken underneath, as a later change could break it:
    ``half_batch``: the loss is the mean over the first half of the batch;
    ``state_unchanged``: the optimizer's step leaves the adapters as they
    were; ``stale_merge``: each LoKr layer keeps the dW its first forward
    formed (the gradients still flow from the current tensors), as a merge
    cache that is never invalidated would; ``answer_altered``: each DiT
    call's first image token is shifted by one; ``adapter_dropped``: the
    network is never applied; ``adapter_half``: it is applied at half its
    multiplier; ``single_blocks_dropped``: the adapters of the DiT's
    single-stream blocks are never applied."""
    import torch
    from lycoris_tpu_torch import LycorisNetwork
    from lycoris_tpu_torch.models.dit import FluxTransformer2D
    from lycoris_tpu_torch.modules.lokr import LokrModule
    from lycoris_tpu_torch.trainer import DiffusionTrainer

    saved, missing = [], object()

    def patch(owner, name, value):
        saved.append((owner, name, owner.__dict__.get(name, missing)))
        setattr(owner, name, value)

    if fault == "half_batch":
        orig = DiffusionTrainer.loss_fn

        def half(self, latents, context, noise, t, added_cond=None):
            h = latents.shape[0] // 2
            return orig(self, latents[:h], context[:h], noise[:h], t[:h],
                        None if added_cond is None else added_cond[:h])
        patch(DiffusionTrainer, "loss_fn", half)
    elif fault == "state_unchanged":
        patch(torch.optim.AdamW, "step", lambda self, closure=None: None)
    elif fault == "stale_merge":
        first = {}
        orig_fns, orig_merged = LokrModule.factored_merged_fns, LokrModule.get_merged_weight

        def stale_fns(self, multiplier):
            fns = orig_fns(self, multiplier)
            if fns is None:
                return None
            recon, dtheta = fns

            def stale_recon(theta, out_dtype=None):
                key = (id(self), out_dtype)
                if key not in first:
                    first[key] = recon(theta, out_dtype).detach()
                return first[key]
            return stale_recon, dtheta

        def stale_merged(self, org_weight, org_bias=None, multiplier=1.0):
            w, b = orig_merged(self, org_weight, org_bias, multiplier)
            key = (id(self), "merged")
            if key not in first:
                first[key] = w.detach()
            return first[key] + (w - w.detach()), b
        patch(LokrModule, "factored_merged_fns", stale_fns)
        patch(LokrModule, "get_merged_weight", stale_merged)
    elif fault == "answer_altered":
        orig_fwd = FluxTransformer2D.forward

        def altered(self, img, txt, timesteps):
            out = orig_fwd(self, img, txt, timesteps)
            out[:, 0] += 1.0
            return out
        patch(FluxTransformer2D, "forward", altered)
    elif fault == "adapter_dropped":
        patch(LycorisNetwork, "apply_to", lambda self, merged_forward=None: self)
    elif fault == "adapter_half":
        orig_apply = LycorisNetwork.apply_to

        def halved(self, merged_forward=None):
            orig_apply(self, merged_forward)
            self.set_multiplier(0.5 * self.multiplier)
            return self
        patch(LycorisNetwork, "apply_to", halved)
    elif fault == "single_blocks_dropped":
        orig_adapted = LycorisNetwork._adapted_forward

        def partial(self, lora_name):
            if "single_blocks" in lora_name:
                return self.node_map[lora_name].module.forward
            return orig_adapted(self, lora_name)
        patch(LycorisNetwork, "_adapted_forward", partial)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            if value is missing:
                delattr(owner, name)
            else:
                setattr(owner, name, value)


def readings(cell, what: str) -> dict:
    """The compared numbers of one seed with the program, a planted fault or
    the control in the program's place, against the fp32 reference."""
    import torch

    from bench_h100.harness import free

    driver = cell.driver()
    device = torch.device(cell.device)
    dtype = getattr(torch, cell.config["run"]["dtype"])
    if what == "control":
        got = driver.control(cell, device)
    else:
        with planted(None if what == "program" else what):
            prog = driver.program(cell, dtype, device)
        got = prog["checked"]
    free(device)
    numbers = driver.check(cell, got, device)
    free(device)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from bench_h100.harness import Cell
    from bench_h100.run import cache_env

    cache_env(ROOT)
    runs = ([("program", s) for s in args.seeds] + [("control", s) for s in args.control]
            + [(f, s) for f in args.fault for s in args.fault_seeds])
    sink = open(args.out, "a") if args.out else None
    try:
        for what, seed in runs:
            cell = Cell(ROOT, args.workload, seed, args.seconds, False)
            cell.t_start = time.perf_counter()
            t = time.perf_counter()
            row = {"workload": args.workload, "seed": seed, "ran": what,
                   "numbers": readings(cell, what), "s": time.perf_counter() - t}
            print(json.dumps(row), flush=True)
            if sink:
                sink.write(json.dumps(row) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
