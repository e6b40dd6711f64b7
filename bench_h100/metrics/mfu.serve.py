"""The base model's matmul, convolution and attention FLOPs
over the traced run's window, as a share of 989 TFLOP/s."""

from bench_h100.counts import PEAK_FLOPS


def read(tr):
    if not tr.window_steps or not tr.window_s or not tr.kernels:
        return None
    return 100.0 * tr.flops_per_step * tr.window_steps / (tr.window_s * PEAK_FLOPS)
