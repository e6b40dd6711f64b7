"""The traced tail of a run: ``torch.profiler`` over the last steps or
calls, reduced from its own timeline to what the per-layer readers read
and to the ``breakdown`` of the result line.

The tail is two profiled spans. The first records the device alone (CUDA
activity: kernels, copies, sets and the runtime calls that launched
them) over the traced steps: every metric and the device's busy time come
from it. Recording the host's ops as well doubled a SDXL step's host time
on the H100, which would read as device idle time, so the second span
records CPU and CUDA activity over one more step, and only the labels of
the idle gaps (what the host was doing while the device waited) come
from it.

:class:`Trace` holds the device operations (kernels, copies, sets) with
their start and length, the CPU ops and the benchmark's own ranges, the
host milliseconds of each traced call, and what the cell's driver adds (the
steps traced, the census's bounds, the model's FLOPs, the traced run's
whole window). Times are in microseconds as the profiler gives them.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

from . import counts


class Trace:
    def __init__(self, events: list):
        dev, cpu, ranges, runtime = [], [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            item = (e["name"], float(e["ts"]), float(e["dur"]))
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                dev.append(item + (cat,))
            elif cat == "user_annotation":
                ranges.append(item)
            elif cat == "cpu_op":
                cpu.append(item + (e.get("tid"),))
            elif cat == "cuda_runtime":
                runtime.append(item)
        dev.sort(key=lambda x: x[1])
        self.device_ops = dev
        self.kernels = [d for d in dev if d[3] == "kernel"]
        self.cpu_ops = sorted(cpu, key=lambda x: x[1])
        self.ranges = sorted(ranges, key=lambda x: x[1])
        self.runtime = runtime
        self.labels = self  # the trace whose host ops label the idle gaps
        self.host_ms: list = []  # host clock around each traced call, no synchronize
        self.steps = 0  # traced steps or calls
        self.census_bounds_s: dict = {}  # {kernel: Σ bound of its launches in the traced steps},
        # for each census kernel whose launch counter equals the census
        self.flops_per_step = 0.0  # the base model's FLOPs a step or call
        self.window_steps = 0  # steps or calls of the traced run's whole window
        self.window_s = 0.0

    # -- the profiled span and the device's use of it --------------------------
    def span_us(self) -> tuple[float, float]:
        """From the first host range or launch to the last device op's end."""
        starts = [x[1] for x in self.ranges + self.runtime + self.device_ops]
        ends = [x[1] + x[2] for x in self.ranges + self.runtime + self.device_ops]
        return min(starts), max(ends)

    def busy_intervals(self) -> list:
        merged = []
        for _, ts, dur, _ in self.device_ops:
            end = ts + dur
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return merged

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> list:
        """[(start, length)] of the spans with no device op, in the profiled span."""
        lo, hi = self.span_us()
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s - t))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi - t))
        return gaps

    def kernel_us(self, kind: str) -> float:
        return sum(d for name, _, d, _ in self.kernels if counts.bucket(name) == kind)

    def census_kernel_us(self) -> dict:
        """{census kernel: device microseconds of its launches}."""
        out = {}
        for name, _, d, _ in self.kernels:
            k = counts.census_kernel(name)
            if k is not None:
                out[k] = out.get(k, 0.0) + d
        return out

    # -- breakdown --------------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> list:
        by = {}
        for name, _, dur, _ in self.device_ops:
            by[name] = by.get(name, 0.0) + dur
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], us / 1e6] for name, us in top]

    def gap_labels(self, gaps: list) -> list:
        """For each gap, what the host was doing at its middle: the
        benchmark's range open then and the innermost CPU op open then."""
        mids = sorted((s + d / 2, i) for i, (s, d) in enumerate(gaps))
        labels = [""] * len(gaps)
        stacks, k = {}, 0
        ops = self.cpu_ops
        rstarts = [r[1] for r in self.ranges]
        for mid, i in mids:
            while k < len(ops) and ops[k][1] <= mid:
                name, ts, dur, tid = ops[k]
                st = stacks.setdefault(tid, [])
                while st and st[-1][1] + st[-1][2] < ts:
                    st.pop()
                st.append((name, ts, dur))
                k += 1
            inner = None
            for st in stacks.values():
                while st and st[-1][1] + st[-1][2] < mid:
                    st.pop()
                if st and (inner is None or st[-1][1] > inner[1]):
                    inner = st[-1]
            j = bisect.bisect_right(rstarts, mid) - 1
            rng = self.ranges[j][0] if j >= 0 and rstarts[j] + self.ranges[j][2] >= mid else "none"
            labels[i] = f"{rng}/{inner[0] if inner else 'no op'}"[:200]
        return labels

    def top_idle_gaps(self, n: int = 10) -> list:
        """The idle time of the labelling span by what the host was doing,
        the largest totals first."""
        gaps = self.labels.idle_gaps()
        by = {}
        for label, (_, dur) in zip(self.labels.gap_labels(gaps), gaps):
            by[label] = by.get(label, 0.0) + dur
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[label, us / 1e6] for label, us in top]


def _record(fn, first: int, steps: int, device, activities) -> tuple:
    from torch.profiler import profile as tprofile

    from .harness import sync

    sync(device)
    host = []
    with tprofile(activities=activities) as prof:
        for i in range(first, first + steps):
            host.append(fn(i))
        sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return Trace(events), host


def profile(fn, steps: int, device):
    """Run ``fn(i)`` for i in range(steps) under torch.profiler recording
    the device, then ``fn(steps)`` recording the host's ops too; ``fn``
    returns the host seconds of its call into the program."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    tr, host = _record(fn, 0, steps, device,
                       [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
    tr.labels, _ = _record(fn, steps, 1, device,
                           [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    tr.host_ms = [h * 1e3 for h in host]
    tr.steps = steps
    return tr


def traced_tail(fn, calls: int, device, census: dict, flops_per_step: float, window_steps: int,
                window_s: float, bias: bool = True) -> Trace:
    """:func:`profile` of ``calls`` calls of ``fn`` with what the readers
    need besides the timeline: the census's bound for those calls of each
    kernel whose launch counter over the tail (the host-recorded call too)
    equals the census, the model's FLOPs a call and the traced run's
    window. The names whose counters differ go to standard error."""
    import sys

    from .harness import port_counters

    before = port_counters()
    tr = profile(fn, calls, device)
    got = {k: v - before[k] for k, v in port_counters().items()}
    off = counts.census_disagreeing(got, census, calls + 1)
    if off:
        print(f"launch counters {got} over {calls + 1} calls differ from the census "
              f"{counts.census_launches(census)} a call in {off}: left out of kernel_roofline",
              file=sys.stderr)
    tr.census_bounds_s = {k: calls * b for k, b in counts.census_bounds_s(census, bias).items()
                          if k not in off}
    tr.flops_per_step, tr.window_steps, tr.window_s = flops_per_step, window_steps, window_s
    return tr
