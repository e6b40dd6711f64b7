"""Functional API demo (counterpart of ``example/functional_example.py``).

``weight_gen`` / ``diff_weight`` / ``bypass_forward_diff``, no modules, no
wrapper: the bypass and the rebuilt weight must agree.

    python -m lycoris_tpu_torch.examples.functional_example [--device cpu]
"""

import argparse

import torch

from lycoris_tpu_torch.functional import loha, lokr
from lycoris_tpu_torch.functional.general import linear


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(128, 128, generator=gen, device=dev) * 0.02

    lokr_weights = lokr.weight_gen(w.shape, rank=4, generator=gen, device=dev)
    loha_weights = loha.weight_gen(w.shape, rank=4, tucker=False, generator=gen, device=dev)
    # move the zero-init factors so that the adapters do something
    lokr_weights = tuple(None if x is None else x + 0.01 for x in lokr_weights)
    loha_weights = tuple(None if x is None else x + 0.01 for x in loha_weights)

    x = torch.randn(1, 128, generator=gen, device=dev)
    out = linear(x, w)

    # two ways to apply each algorithm
    out_lokr_bypass = out + lokr.bypass_forward_diff(x, out, *lokr_weights)
    out_loha_bypass = out + loha.bypass_forward_diff(x, out, *loha_weights)
    out_lokr_rebuilt = linear(x, w + lokr.diff_weight(*lokr_weights))
    out_loha_rebuilt = linear(x, w + loha.diff_weight(*loha_weights))

    print("lokr bypass == rebuilt:", float((out_lokr_bypass - out_lokr_rebuilt).abs().max()))
    print("loha bypass == rebuilt:", float((out_loha_bypass - out_loha_rebuilt).abs().max()))


if __name__ == "__main__":
    main()
