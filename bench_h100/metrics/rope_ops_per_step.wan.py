"""Host ops a step in Wan's 3-D rotary positions: the CPU ops that start
inside the program's ``lycoris.rope`` spans (one an application to q or k,
in the forward and in each checkpointed block's recompute), read from the
one step recorded with the host's ops."""

import bisect

SPANS = {"lycoris.rope"}


def read(tr):
    """The labelled step's CPU ops (``cpu_op`` events, any thread) whose
    start lies inside a range of ``SPANS``; None where it holds none."""
    lab = tr.labels
    ranges = sorted((ts, ts + dur) for name, ts, dur in lab.ranges if name in SPANS)
    if not ranges:
        return None
    starts = [op[1] for op in lab.cpu_ops]  # sorted
    n, end = 0, float("-inf")
    for lo, hi in ranges:  # over their union: an op inside two ranges counts once
        lo = max(lo, end)
        if hi > lo:
            n += bisect.bisect_left(starts, hi) - bisect.bisect_left(starts, lo)
            end = hi
    return float(n)
