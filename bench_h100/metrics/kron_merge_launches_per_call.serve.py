"""Launches a call of the port's one-pass LoKr merge kernel
(``csrc/kron_merge.cu``, ``lyc_kron_merge``): the traced device kernels whose
name holds it, over the traced calls. None where none launched (a program
without the kernel)."""


def read(tr):
    n = sum("lyc_kron_merge" in name for name, _, _, _ in tr.kernels)
    return n / tr.steps if n else None
