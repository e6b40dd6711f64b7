"""The readers of the one-pass LoKr merge kernel's launches on synthetic
traces: each counts only the kernels named ``lyc_kron_merge``, over the
traced steps, reads None where none launched, and the kernel's time stays
in the elementwise bucket that ``elementwise_ms_*`` read."""

from __future__ import annotations

import pytest

from bench_h100 import counts, harness
from bench_h100.tiny import REPO
from bench_h100.trace import Trace

KERNEL = "(anonymous namespace)::lyc_kron_merge_kernel(uint4 const*, float const*, " \
         "float4 const*, float const*, float, uint4*, int, int, int, int, int)"
READERS = {"kron_merge_launches_per_call.serve": "flux-lokr-live-b1",
           "kron_merge_launches_per_step.train": "sdxl-lokr-train-b16"}


def _trace(names, steps):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10 * i, "dur": 5}
          for i, n in enumerate(names)]
    ev.append({"ph": "X", "cat": "user_annotation", "name": "lycoris.merge", "ts": 0, "dur": 3})
    tr = Trace(ev)
    tr.steps = steps
    return tr


def _read(metric, tr):
    return harness.Cell(REPO, READERS[metric], 1, 1.0, True).reader(metric).read(tr)


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_counts_the_kernels_launches_over_steps(metric):
    names = [KERNEL] * 12 + ["nvjet_tst_128x256_64x4_2x1_v_bz_TNT",
                             "void at::native::vectorized_elementwise_kernel<4, ...>",
                             "flash_fwd_kernel", "lyc_hada_fwd_r8_kernel"] * 3
    assert _read(metric, _trace(names, 4)) == 3.0


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_is_none_without_the_kernel(metric):
    tr = _trace(["nvjet_tst_128x256", "void at::native::elementwise_kernel<128, 2>"], 2)
    assert _read(metric, tr) is None
    assert _read(metric, Trace([])) is None


def test_the_merge_kernel_is_filed_as_elementwise():
    assert counts.bucket(KERNEL) == "elementwise"
    assert counts.bucket("lyc_kron_merge_kernel") == "elementwise"
    tr = _trace([KERNEL] * 3 + ["nvjet_tst_128x256"], 1)
    assert tr.kernel_us("elementwise") == 15.0
