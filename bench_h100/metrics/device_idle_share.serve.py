"""The share of the profiled span in which no device op ran."""


def read(tr):
    """100 x (1 - the union of the device ops' intervals / the profiled span)."""
    if not tr.device_ops:
        return None
    lo, hi = tr.span_us()
    return 100.0 * (1.0 - tr.busy_us() / (hi - lo))
