"""Device kernels a traced step: the host model's launches, everything below included."""


def read(tr):
    return len(tr.kernels) / tr.steps if tr.kernels else None
