"""Tiny stand-ins of the benchmark's cells for the CPU tests: a root
directory holding ``BENCHMARK.json`` and copies of ``bench_h100``'s files,
with each configuration cut to a toy UNet or DiT and each mix to a few
small rows, so that a whole run (set-up, window, traced tail, reference,
comparison) takes seconds on the CPU. The cells' own limits are kept."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

TINY_SIZES = {
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
             "layers_per_block": 1, "transformer_depth": [1, 1], "mid_transformer_depth": 1,
             "context_dim": 32, "num_heads": 2, "norm_groups": 8, "addition_embed_dim": 24},
    "dit": {"hidden_size": 32, "num_heads": 2, "mlp_ratio": 4.0, "depth_double": 2,
            "depth_single": 2, "in_channels": 8, "context_dim": 16, "qk_norm": True},
}
TINY_TRAFFIC = {
    "unet_train": {"batch": 2, "latent_hw": 8, "pool_batches": 4, "ref_block": 1},
    "dit_serve": {"txt_tokens": 8, "img_tokens": 16, "pool_requests": 3},
}


def tiny_root(dest: Path, dtype: str = "float32") -> Path:
    """``dest`` as a checkout of the benchmark with every configuration and
    mix cut to toy sizes in ``dtype``; returns ``dest``."""
    dest = Path(dest)
    shutil.copytree(REPO / "bench_h100", dest / "bench_h100",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    manifest = json.loads((dest / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["run"]["sizes"] = dict(TINY_SIZES[cfg["run"]["model"]])
        cfg["run"]["dtype"] = dtype
        path.write_text(json.dumps(cfg, indent=1))
    for path in (dest / "bench_h100" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(TINY_TRAFFIC[mix["driver"]])
        path.write_text(json.dumps(mix, indent=1))
    return dest


def run_cell(root: Path, workload: str, seed: int = 12345678901, seconds: float = 0.5,
             trace: bool = False) -> dict:
    """A whole run of a tiny cell on the CPU; the result line's object."""
    import time

    from .harness import Cell, result_line

    cell = Cell(root, workload, seed, seconds, trace, device="cpu")
    cell.t_start = time.perf_counter()
    out = cell.driver().run(cell)
    return result_line(cell, out, {"platform": "cpu", "kind": "cpu", "count": 1,
                                   "memory_peak_bytes": out["peak_bytes"]})
