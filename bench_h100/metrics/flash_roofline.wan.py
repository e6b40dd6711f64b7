"""The flash kernels' share of their roofline over the traced steps: Σ
census bound / Σ device time of the forward and backward kernels at the
cell's shapes (bounds from ``counts_wan.wan_census`` and ``counts.py``'s
formulas), in %."""

FLASH = ("flash_fwd", "flash_bwd")


def read(tr):
    """100 x Σ bound / Σ device time over the flash kernels whose launch
    counters equal the census and that ran in the traced steps; None where
    there are none."""
    us = tr.census_kernel_us()
    kernels = [k for k in FLASH if k in tr.census_bounds_s and us.get(k)]
    if not kernels:
        return None
    return 100.0 * sum(tr.census_bounds_s[k] for k in kernels) / (
        sum(us[k] for k in kernels) / 1e6)
