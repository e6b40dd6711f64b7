"""The harness: the manifest against the benchmark's contract, each cell's
files found by name, a configuration, a mix and a metric added as files
alone, the result line, the run path without a card, the import graph,
and planted faults and the fp8 control coming out not correct (toy sizes
on the CPU). The cells on the card: ``-m cuda`` (they skip without one)."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100 import harness
from bench_h100.tiny import REPO, run_cell, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
TRAIN, SERVE = "sdxl-lokr-train-b16", "flux-lokr-live-b1"


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_meets_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(one_line(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert all(not w.endswith(".py") or any(w.startswith(p + "/") for p in m["paths"])
               for w in m["command"])
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        assert (REPO / c["file"]).is_file() and len(c["reduced"]) <= 16
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
        names.add(c["name"])
    assert len(names) == len(m["configs"]) and len({c["file"] for c in m["configs"]}) == len(names)
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (REPO / "bench_h100" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "bench_h100" / "cells" / f"{w['name']}.json").is_file()
    assert {c["name"] for c in m["configs"]} == {w["config"] for w in m["workloads"]}
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
    e2e = {}
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
        assert set(e.get("workloads", CELLS)) <= set(CELLS)
        e2e[e["name"]] = e
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(p["name"]) and UNIT.match(p["unit"]) and p["better"] in ("lower", "higher")
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(p["layer"]) and p["moves"] in e2e
        for w in p["workloads"]:
            assert w in e2e[p["moves"]].get("workloads", CELLS)
        assert (REPO / "bench_h100" / "metrics" / f"{p['name']}.py").is_file()
        if p["name"].endswith("_roofline") or "mfu" in p["name"]:
            assert p["unit"] == "%"
    assert len({n["name"] for n in m["end_to_end"] + m["per_layer"]}) == len(e2e) + len(m["per_layer"])
    for w in CELLS:
        mine = [e for e in m["end_to_end"] if w in e.get("workloads", CELLS)]
        assert "setup_s" in {e["name"] for e in mine} and len(mine) >= 2
        assert any(w in p["workloads"] for p in m["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    for f in (REPO / "bench_h100").rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        assert PATH.match(str(f.relative_to(REPO))), f


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = harness.Cell(REPO, workload, 1, 1.0, True)
    assert cell.traffic["driver"] in ("unet_train", "dit_serve")
    assert hasattr(cell.driver(), "run")
    for m in cell.per_layer():
        assert callable(cell.reader(m["name"]).read)
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    assert {e["name"] for e in cell.end_to_end()} >= {"setup_s", "peak_mem_gib"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench") / "checkout")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(root, workload, trace):
    line = run_cell(root, workload, trace=trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == trace
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = harness.Cell(root, workload, 1, 1.0, trace)
    want = {m["name"] for m in (cell.per_layer() if trace else cell.end_to_end())}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for k, v in line["checks"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_config_mix_and_metric_added_as_files(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and manifest entries: nothing that is there is edited."""
    root = tiny_root(tmp_path / "checkout")
    b = root / "bench_h100"
    cfg = json.loads((b / "configs" / "sdxl-base-1.0-unet.json").read_text())
    cfg["name"] = "tiny-unet-wide"
    cfg["run"]["sizes"]["block_out_channels"] = [32, 96]
    (b / "configs" / "tiny-unet-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "train-lokr-b16.json").read_text())
    mix["batch"] = 3
    (b / "traffic" / "train-lokr-b3.json").write_text(json.dumps(mix))
    (b / "cells" / "tiny-wide-b3.json").write_text(
        (b / "cells" / f"{TRAIN}.json").read_text())
    (b / "metrics" / "traced_steps.train.py").write_text(
        "def read(tr):\n    return float(tr.steps)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-unet-wide", "source": "https://example.org/cfg",
                         "file": "bench_h100/configs/tiny-unet-wide.json", "reduced": [],
                         "why": "wider toy"})
    m["workloads"].append({"name": "tiny-wide-b3", "config": "tiny-unet-wide",
                           "traffic": "train-lokr-b3", "chips": 1, "why": "toy"})
    for e in m["end_to_end"]:
        if "workloads" in e and TRAIN in e["workloads"]:
            e["workloads"].append("tiny-wide-b3")
    m["per_layer"].append({"name": "traced_steps.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "trainer",
                           "moves": "train_samples_per_s", "workloads": ["tiny-wide-b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    line = run_cell(root, "tiny-wide-b3", trace=True)
    assert line["correct"] and line["metrics"]["traced_steps.train"]["value"] == 2.0
    assert "host_ms_per_step.train" not in line["metrics"]  # not listed for the new cell
    assert run_cell(root, "tiny-wide-b3")["metrics"]["train_samples_per_s"]["value"] > 0


def test_run_fails_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", SERVE, "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    import shutil

    shutil.copytree(REPO / "bench_h100", tmp_path / "bench_h100")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", TRAIN, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_import_graph_holds_no_jax(root):
    """The harness's modules import nothing of JAX or the JAX package, and
    neither does a whole tiny run through the port."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import bench_h100.run, bench_h100.calibrate, bench_h100.harness, bench_h100.trace\n"
        "from bench_h100.harness import Cell, forbidden_modules\n"
        "from bench_h100.tiny import run_cell\n"
        "for w in %r:\n"
        "    c = Cell(%r, w, 1, 1, True)\n"
        "    c.driver(); [c.reader(m['name']) for m in c.per_layer()]\n"
        "print('dry', forbidden_modules())\n"
        "for w in %r:\n"
        "    run_cell(%r, w, seconds=0.2)\n"
        "print('run', forbidden_modules(), 'lycoris_tpu_torch' in sys.modules)\n"
    ) % (str(REPO), CELLS, str(root), CELLS, str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    assert "dry []" in out.stdout and "run [] True" in out.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lycoris_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "lycoris_tpux", object())
    assert "lycoris_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


FAULTS = [(TRAIN, "state_unchanged"), (TRAIN, "half_batch"), (SERVE, "answer_altered"),
          (SERVE, "adapter_dropped"), (SERVE, "adapter_half")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_planted_faults_come_out_not_correct(root, workload, fault):
    """The harness's run, the card's look skipped, with the port broken
    underneath: ``correct`` is false (and true without the fault)."""
    from bench_h100.calibrate import planted

    with planted(fault):
        line = run_cell(root, workload, seconds=0.3)
    assert line["correct"] is False
    failed = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert failed, line["checks"]


def test_a_stale_merge_moves_the_loss_gap(root):
    """A LoKr merge that keeps each layer's first dW: at toy size in fp32 it
    reads a loss gap hundreds of times a sound run's (at the cell's own
    size on the card it fails the limit: PERF.md)."""
    from bench_h100.calibrate import planted

    sound = run_cell(root, TRAIN, seconds=0.3)["checks"]["loss_gap"]["value"]
    with planted("stale_merge"):
        stale = run_cell(root, TRAIN, seconds=0.3)["checks"]["loss_gap"]["value"]
    assert stale > 100 * max(sound, 1e-7)


@pytest.mark.parametrize("workload", CELLS)
def test_limits_lie_between_their_readings(workload):
    """Each limit is above the port's worst reading and below the control's
    least where that is three times the port's or more; the control, and
    each fault, read over the limit of one number or more."""
    limits = harness.Cell(REPO, workload, 1, 1.0, False).limits
    readings = json.loads((REPO / "bench_h100" / "cells" / f"{workload}.json").read_text())
    readings = {k: v for k, v in readings["readings"].items() if k in limits}
    assert set(readings) == set(limits)
    faults = {k for r in readings.values() for k in r} - {"port_max"}
    for name, r in readings.items():
        assert r["port_max"] < limits[name], name
        if r["control_min"] >= 3 * r["port_max"]:
            assert limits[name] < r["control_min"], name
    for f in faults:
        assert any(r.get(f, 0) > limits[name] for name, r in readings.items()), f


@pytest.mark.parametrize("workload", CELLS)
def test_fp8_control_comes_out_not_correct(root, workload):
    """The reference in fp8 in the port's place fails the cell's limits."""
    import torch

    cell = harness.Cell(root, workload, 987654321, 0.3, False, device="cpu")
    driver = cell.driver()
    checks = driver.check(cell, driver.control(cell, torch.device("cpu")), torch.device("cpu"))
    assert not harness.judge(checks, cell.limits), checks


def test_adapter_gap_reads_the_share_of_the_adapters_effect():
    import torch

    from bench_h100.harness import load_module

    dit = load_module(REPO / "bench_h100" / "drivers" / "dit_serve.py", "driver_dit_serve")
    g = torch.Generator().manual_seed(8)
    base = torch.randn(4, 16, generator=g)
    want = base + 0.03 * torch.randn(4, 16, generator=g)
    noise = 0.01 * torch.randn(4, 16, generator=g)
    assert dit.adapter_gap(base, want, base) == pytest.approx(1.0)
    assert dit.adapter_gap(base + 0.5 * (want - base), want, base) == pytest.approx(0.5)
    assert dit.adapter_gap(want, want, base) == 0.0
    assert dit.adapter_gap(want + noise, want, base) < 0.5


def test_a_reader_that_loads_jax_leaves_no_result(root, tmp_path):
    """A per-layer reader that imports ``jax`` (a stub here) is loaded while
    the result line is made: the run then exits with 3 and prints no line."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    reader = root / "bench_h100" / "metrics" / "kernels_per_step.train.py"
    text = reader.read_text()
    code = (
        "import json, sys, time; sys.path[:0] = [%r, %r]\n"
        "from bench_h100.harness import Cell\n"
        "from bench_h100.run import finish\n"
        "cell = Cell(%r, %r, 5, 0.2, True, device='cpu'); cell.t_start = time.perf_counter()\n"
        "out = cell.driver().run(cell)\n"
        "sys.exit(finish(cell, out, {'platform': 'cpu', 'kind': 'cpu', 'count': 1,\n"
        "                            'memory_peak_bytes': 0}))\n"
    ) % (str(REPO), str(stub), str(root), TRAIN)
    try:
        reader.write_text("import jax  # noqa: F401\n" + text)
        bad = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=600)
    finally:
        reader.write_text(text)
    assert bad.returncode == 3 and bad.stdout.strip() == "", bad.stderr[-2000:]
    assert "['jax']" in bad.stderr
    good = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert good.returncode == 0, good.stderr[-2000:]
    line = json.loads(good.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and "check loss_gap" in good.stderr.splitlines()[-3]


def test_an_algorithm_added_as_a_file(tmp_path):
    """A LoHa cell is an algorithm file, a traffic mix, a limits file and
    manifest entries: the algorithm file is found by name in the checkout
    (here written anew after the copy), and the run comes out correct."""
    root = tiny_root(tmp_path / "checkout")
    b = root / "bench_h100"
    algo = (b / "algos" / "loha.py").read_text()
    (b / "algos" / "loha.py").unlink()
    (b / "algos" / "loha.py").write_text(algo)
    mix = json.loads((b / "traffic" / "serve-lokr-live-b1.json").read_text())
    mix["adapter"] = {"algo": "loha", "dim": 8, "alpha": 4.0,
                      "targets": ["DoubleStreamBlock", "SingleStreamBlock"]}
    (b / "traffic" / "serve-loha-live-b1.json").write_text(json.dumps(mix))
    (b / "cells" / "flux-loha-live-b1.json").write_text((b / "cells" / f"{SERVE}.json").read_text())
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "flux-loha-live-b1", "config": "flux1-dev-dit",
                           "traffic": "serve-loha-live-b1", "chips": 1, "why": "toy"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e and SERVE in e["workloads"]:
            e["workloads"].append("flux-loha-live-b1")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    line = run_cell(root, "flux-loha-live-b1", trace=True)
    assert line["correct"] is True, line["checks"]
    assert harness.Cell(root, "flux-loha-live-b1", 1, 1, False).algo().__file__ == str(
        b / "algos" / "loha.py")


def test_the_fused_bypass_cell_is_a_data_file(tmp_path):
    """Open question 1's cell: the live mix with ``adapter_mode: fused``
    (merged once at set-up), a limits file and a manifest entry."""
    root = tiny_root(tmp_path / "checkout")
    b = root / "bench_h100"
    mix = json.loads((b / "traffic" / "serve-lokr-live-b1.json").read_text())
    mix["adapter_mode"] = "fused"
    (b / "traffic" / "serve-lokr-fused-b1.json").write_text(json.dumps(mix))
    (b / "cells" / "flux-lokr-fused-b1.json").write_text((b / "cells" / f"{SERVE}.json").read_text())
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "flux-lokr-fused-b1", "config": "flux1-dev-dit",
                           "traffic": "serve-lokr-fused-b1", "chips": 1, "why": "toy"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e and SERVE in e["workloads"]:
            e["workloads"].append("flux-lokr-fused-b1")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    line = run_cell(root, "flux-lokr-fused-b1", trace=True)
    assert line["correct"] is True, line["checks"]


def test_roofline_reads_the_kernels_whose_counters_agree():
    """A census kernel whose launch counter disagrees is left out of
    ``kernel_roofline``; the others are still read."""
    from bench_h100.harness import load_module
    from bench_h100.trace import Trace

    read = load_module(REPO / "bench_h100" / "metrics" / "kernel_roofline.serve.py", "r").read
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d} for n, ts, d in (
        ("flash_fwd_bf16_kernel<128>", 0, 40.0), ("ln_fwd_kernel", 50, 10.0),
        ("nvjet_tst_gemm", 70, 100.0))]
    tr = Trace(ev)
    tr.census_bounds_s = {"flash_fwd": 20e-6, "layer_norm_fwd": 2e-6}
    assert read(tr) == pytest.approx(100.0 * 22 / 50)
    tr.census_bounds_s = {"flash_fwd": 20e-6}  # the LayerNorm's counter disagreed
    assert read(tr) == pytest.approx(50.0)
    tr.census_bounds_s = {}
    assert read(tr) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", workload, "--seed",
                          "3000000019", "--seconds", "5", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_readme_names_every_file_kind():
    text = (REPO / "bench_h100" / "README.md").read_text()
    for word in ("configs/", "traffic/", "metrics/", "cells/", "drivers/", "algos/",
                 "calibrate.py"):
        assert word in text
    assert Path(REPO / "bench_h100" / "run.py").is_file()
