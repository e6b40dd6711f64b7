#!/usr/bin/env python3
"""Time the SVD extract on the full-width SDXL UNet, on one CUDA card.

    python3 profile_tools.py

Runs the extract leg of ``chip_smoke.py``'s ``tools_sdxl`` phase
(``chip_smoke.tools_extract``) on ``sdxl_config()`` in fp32 in place of
SD1.5: a tuned copy with LoRA dim 8 on the 722 attn-mlp layers and conv
LoCon dim 4 on the ResNet 3x3 convs merged in, ``extract_diff`` on the card
(fixed mode, no CP pass) reloaded and held to the true deltas, then the CP
pass on two 3x3 convs of each shape group against the CPU. Prints the card,
each SVD group's seconds, the extract's seconds and peak memory, and the
whole result as JSON on the last line; the CLIs are not run (their files
would be 10 GiB each). No kernel is built: the extract runs none.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_tools: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    out = cs.tools_extract("sdxl", card, cli=False)
    out["leg_s"] = time.perf_counter() - t0
    out["card"] = card
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
