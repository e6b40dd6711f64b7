"""Device ms a call of the elementwise bucket (the adapters' merge W + dW
and its casts): kernels that are not
GEMMs, convolutions, the port's own kernels or collectives."""


def read(tr):
    if not tr.kernels:
        return None
    return tr.kernel_us("elementwise") / 1e3 / tr.steps
