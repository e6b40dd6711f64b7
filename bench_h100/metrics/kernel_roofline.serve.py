"""The port's own kernels' share of their roofline over the traced calls
(bounds from the frozen census in ``counts.py``)."""


def read(tr):
    """100 x Σ bound / Σ device time over the census kernels whose launch
    counters equal the census and that ran in the traced steps."""
    us = tr.census_kernel_us()
    kernels = [k for k in tr.census_bounds_s if us.get(k)]
    if not kernels:
        return None
    return 100.0 * sum(tr.census_bounds_s[k] for k in kernels) / (
        sum(us[k] for k in kernels) / 1e6)
