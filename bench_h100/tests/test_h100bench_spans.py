"""The readers of the program's spans (``source: program_span``) on the
tiny cells, traced, on the CPU: each returns a number, the flux cell's
``merges_per_call.serve`` is the tiny DiT's adapted layers, and a trace
without the spans (a program that opens none) gives None, not an error."""

from __future__ import annotations

import pytest

from bench_h100 import harness, inputs
from bench_h100.reference.dit import dit_spec
from bench_h100.tiny import REPO, TINY_SIZES, run_cell, tiny_root
from bench_h100.trace import Trace

SPAN_METRICS = [p["name"] for p in harness.load_json(REPO / "BENCHMARK.json")["per_layer"]
                if p["source"] == "program_span"]
TRAIN, SERVE = "sdxl-lokr-train-b16", "flux-lokr-live-b1"


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("bench") / "checkout")
    return {w: run_cell(root, w, trace=True) for w in (TRAIN, SERVE)}


def test_every_span_metric_reads_a_number_in_its_cell(lines):
    assert len(SPAN_METRICS) == 6
    for w, line in lines.items():
        cell = harness.Cell(REPO, w, 1, 1.0, True)
        mine = [m["name"] for m in cell.per_layer() if m["source"] == "program_span"]
        assert mine
        for name in mine:
            assert line["metrics"][name]["value"] > 0, (w, name)


def test_merges_per_call_is_the_tiny_dits_adapted_layers(lines):
    cell = harness.Cell(REPO, SERVE, 1, 1.0, True)
    layers = inputs.adapted_layers(dit_spec(TINY_SIZES["dit"]), cell.traffic["adapter"]["targets"])
    assert lines[SERVE]["metrics"]["merges_per_call.serve"]["value"] == len(layers) > 0


def test_merge_ops_lie_inside_the_forward_and_backward(lines):
    m = {k: v["value"] for k, v in lines[TRAIN]["metrics"].items()}
    assert m["merge_ops_per_step.train"] < m["forward_ops_per_step.train"] + m[
        "backward_ops_per_step.train"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_trace_without_the_spans_reads_none(name):
    tr = Trace([{"ph": "X", "cat": "user_annotation", "name": "train_step", "ts": 0, "dur": 10},
                {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 2}])
    assert harness.Cell(REPO, TRAIN, 1, 1.0, True).reader(name).read(tr) is None


def test_ops_count_once_over_nested_and_overlapping_ranges():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "lycoris.merge", "ts": ts, "dur": d}
          for ts, d in ((0, 10), (2, 3), (8, 6), (30, 5))]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": ts, "dur": 0.5, "tid": 1}
           for ts in (0, 1, 3, 9, 12, 14, 20, 31, 35)]
    read = harness.Cell(REPO, SERVE, 1, 1.0, True).reader("merge_ops_per_call.serve").read
    assert read(Trace(ev)) == 6.0  # 0, 1, 3, 9, 12 in [0, 14); 31 in [30, 35)
