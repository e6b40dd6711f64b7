"""Run one cell of the port's H100 benchmark and print its result line.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: reads the cell from ``BENCHMARK.json``, makes
every input on the card from ``--seed``, warms up the cell's own shapes,
measures for ``--seconds``, checks the window's output against the plain
reference, and prints one JSON object as the last line of standard output
(``--trace 1``: the per-layer metrics of a profiled tail instead of the
end-to-end ones). Fails without a card, with fewer cards than the cell
asks for, or when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    libraries that could load JAX by themselves are told not to."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def finish(cell, out: dict, device: dict) -> int:
    """Make the result line, then look for JAX: 3, and no line, where a
    module of JAX or of the JAX package is loaded by then (the readers are
    loaded while the line is made); else each compared number beside its
    limit as the last lines on standard error, the line last on standard
    output, and 0."""
    from bench_h100.harness import forbidden_modules, result_line

    line = result_line(cell, out, device)
    card = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {card}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)

    from bench_h100.harness import Cell

    cell = Cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {n}", file=sys.stderr)
        return 2
    cell.t_start = T_START
    out = cell.driver().run(cell)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["peak_bytes"]}
    return finish(cell, out, device)


if __name__ == "__main__":
    sys.exit(main())
