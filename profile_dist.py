#!/usr/bin/env python3
"""The distributed path through NCCL, one card a rank, at full SD1.5 width.

    python3 profile_dist.py        # four CUDA cards on one host

``chip_smoke.py`` runs the distributed path on one card: a one-rank NCCL
world, and two gloo ranks sharing the card. This script runs it the way
``torchrun`` users do, each rank on its own card through NCCL, with
``chip_smoke.py``'s SD1.5 UNet (full width, bf16, seed 0), its LoKr
adapter (seed 1) and its b8 batch:

1. the plain trainer, 2 steps on cuda:0 (the losses every world is held to);
2. a 2-rank world: a (1, 2) mesh with the base sharded (each sharded leaf
   all-gathered over the model group where its layer runs), then a (2, 1)
   mesh at b4 a rank (the adapter gradients all-reduced over the data
   group);
3. a 4-rank world: a (2, 2) mesh at b4 a rank with the base sharded
   (``replicate`` over both groups, the gathers and the data all-reduce).

Each mesh trains 2 steps with ``chip_smoke.check_dist_sd15``'s checks: the
launches of every kernel per step equal to the census at the rank's batch,
the base bytes a rank and the gathers a step where it is sharded, one
all-reduce a step, the losses within rel 1e-3 of the plain ones, the
adapters equal on every rank after each step. The all-gathers and
all-reduces are timed by CUDA events on the rank's stream (the first step
includes NCCL's communicator set-up). The readings go to
``chiprun_out/profile_dist.json``.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORLDS = ((2, (("mp", 1, 2), ("dp", 2, 1))), (4, (("mp_dp", 2, 2),)))
WORLD_TIMEOUT = 300  # seconds a world may take, start-up included


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("profile_dist: no CUDA device", file=sys.stderr)
        return 1
    need = max(n for n, _ in WORLDS)
    if torch.cuda.device_count() < need:
        print(f"profile_dist: {torch.cuda.device_count()} CUDA cards, the worlds need {need}",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lycoris_tpu_torch.models.unet import sd15_config
    from lycoris_tpu_torch.parallel import run_world

    card = cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = cs.build_unet(dev, torch.bfloat16, seed=0)
    with torch.no_grad():
        sd = cs.adapter_state_dict(model, "lokr", dev, seed=1)
    batch = cs.sd15_batch()
    results = cs.new_results()
    results["training"] = {}
    want = cs.checked_counts(sd15_config(), cs.TRAIN_BATCH, 64, "lokr", True, False,
                             cs.SD15_STEP, cs.SD15_ADAPTED, cs.SD15_FACTORED)
    cs.train(model, "lokr", sd, batch, want, cs.DIST_STEPS, results, card, "[plain_b8]")
    plain = results["training"]["plain_b8"]["losses"]
    report = {"card": card, "plain": results["training"]["plain_b8"], "worlds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        path = cs.dist_sd15_setup(tmp, sd, batch)
        del model
        torch.cuda.empty_cache()
        for n, meshes in WORLDS:
            t0 = time.perf_counter()
            outs = run_world(cs.dist_sd15_rank, n, path, meshes, True, backend="nccl",
                             timeout=WORLD_TIMEOUT)
            wall = time.perf_counter() - t0
            cs.check_dist_sd15(outs, plain, f"nccl_{n}", "device")
            cs.log(f"[nccl_{n}] {n} NCCL ranks, one card each, {cs.DIST_STEPS} steps a mesh: "
                   f"{wall:.2f} s with the processes' start-up ({card})")
            report["worlds"][str(n)] = {"wall_s": wall, "ranks": outs}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_dist.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": True, "card": card, "cards": torch.cuda.device_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
