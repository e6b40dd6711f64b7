"""Runnable examples of the port, one module each (``python -m
lycoris_tpu_torch.examples.<name> --device cpu``): the counterparts of the
repo's ``example/*.py``."""
