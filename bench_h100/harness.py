"""The harness: the manifest (``BENCHMARK.json``), a cell's files found by
name, the drivers and per-layer readers loaded from their files, and the
result line.

Everything is looked up under a root directory (the checkout): the cell in
``BENCHMARK.json``'s ``workloads``, its configuration at the path the
manifest gives, its traffic mix at ``bench_h100/traffic/<traffic>.json``,
its limits at ``bench_h100/cells/<workload>.json``, the mix's driver at
``bench_h100/drivers/<driver>.py``, the mix's adapter algorithm at
``bench_h100/algos/<algo>.py`` and each per-layer metric's reader at
``bench_h100/metrics/<metric>.py``. A later cell, mix, configuration,
algorithm or metric is files and manifest entries, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lycoris_tpu"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file as a module of its own (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_h100_" + "".join(c if c.isalnum() else "_" for c in name), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its files, and the run's options."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda"):
        self.root = Path(root)
        self.manifest = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config = load_json(self.root / configs[self.workload["config"]]["file"])
        self.traffic = load_json(self.root / "bench_h100" / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(self.root / "bench_h100" / "cells" / f"{workload}.json")["limits"]
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), bool(trace), device
        self.chips = int(self.workload.get("chips", 1))

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.root / "bench_h100" / "drivers" / f"{name}.py", f"driver_{name}")

    def algo(self):
        from .inputs import algo

        return algo(self.traffic["adapter"]["algo"], self.root)

    def end_to_end(self) -> list:
        """The manifest's end-to-end metrics this cell reports."""
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it, or
        that list no cells and move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in mine)]

    def reader(self, metric: str):
        return load_module(self.root / "bench_h100" / "metrics" / f"{metric}.py",
                           f"metric_{metric}")


def port_counters() -> dict:
    """The port's launch counters (and factored-layer applications), by
    census name."""
    from lycoris_tpu_torch.functional import merged
    from lycoris_tpu_torch.ops import flash, geglu, group_norm, hada, layer_norm

    return {"flash_fwd": flash.launches, "flash_bwd": flash.bwd_launches,
            "layer_norm_fwd": layer_norm.launches, "layer_norm_bwd": layer_norm.bwd_launches,
            "group_norm_fwd": group_norm.launches, "group_norm_bwd": group_norm.bwd_launches,
            "geglu_bwd": geglu.bwd_launches, "hada_fwd": hada.launches,
            "factored": merged.applications}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``lycoris_tpu_torch`` is not
    ``lycoris_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def result_line(cell: Cell, out: dict, device: dict) -> dict:
    """The last line's object: correct, attempted, failed, metrics, device,
    the breakdown of a traced run, and the compared numbers last."""
    metrics = {}
    if cell.trace:
        tr = out["trace"]
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] in out["metrics"]:
                metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if cell.trace:
        tr = out["trace"]
        lo, hi = tr.span_us()
        device["busy_s"] = tr.busy_us() / 1e6
        device["window_s"] = (hi - lo) / 1e6
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.top_idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in out["checks"].items()}
    return line


def judge(checks: dict, limits: dict) -> bool:
    """Every compared number finite and at most its limit."""
    import math

    return all(k in limits and math.isfinite(v) and v <= limits[k] for k, v in checks.items())


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_start(device) -> None:
    """Synchronise and restart the peak-memory reading at the window's start."""
    import torch

    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device) -> None:
    """Return the freed port state's memory before the reference runs."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
