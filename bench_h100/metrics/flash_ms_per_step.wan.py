"""Device ms a step of the flash kernels, forward and backward (``flash_fwd_``,
``flash_bwd_``, ``flash_di_``: the census's ``flash_fwd`` and ``flash_bwd``),
over the traced steps. None where none ran."""

FLASH = ("flash_fwd", "flash_bwd")


def read(tr):
    us = tr.census_kernel_us()
    total = sum(us.get(k, 0.0) for k in FLASH)
    return total / 1e3 / tr.steps if total else None
