"""QLyCORIS (counterpart of ``example/quant_example.py``; reference
example/bnb_example.py): adapters over an int8 weight-only quantized base.
Bypass mode is forced on every quantized layer, so dW never touches the
int8 weight, and ``merge_to`` leaves it as it is.

    python -m lycoris_tpu_torch.examples.quant_example [--device cpu]
"""

import argparse

import torch
import torch.nn.functional as F
from torch import nn

from lycoris_tpu_torch import create_lycoris
from lycoris_tpu_torch.models import layers as L
from lycoris_tpu_torch.utils.quant import Int8Linear


class FloatNet(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.fc1 = L.Linear(128, 256, device=device)
        self.fc2 = L.Linear(256, 128, device=device)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class QuantNet(nn.Module):
    """FloatNet with each Linear quantized to :class:`Int8Linear`."""

    def __init__(self, fnet: FloatNet):
        super().__init__()
        self.fc1 = Int8Linear.from_linear(fnet.fc1)
        self.fc2 = Int8Linear.from_linear(fnet.fc2)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    dev = torch.device(args.device)
    torch.manual_seed(0)
    x = torch.randn(2, 128, device=dev).to(torch.bfloat16)

    fnet = FloatNet(device=dev)
    qnet = QuantNet(fnet)
    net = create_lycoris(qnet, 1.0, linear_dim=8, linear_alpha=4.0, algo="lokr", seed=0)
    print("bypass forced:", all(lyco.bypass_mode for lyco in net.loras))

    with torch.no_grad():
        out_q = qnet(x)
        out_f = fnet(x)
        print(f"int8 vs fp base max err: {float((out_q.float() - out_f.float()).abs().max()):.4f}")
        net.apply_to()
        out_adapted = qnet(x)
    print("adapted output shape:", tuple(out_adapted.shape))
    net.restore()
    weight_q = qnet.fc1.weight_q.clone()
    net.merge_to(1.0)
    print("merge_to kept the int8 weights:", torch.equal(qnet.fc1.weight_q, weight_q))


if __name__ == "__main__":
    main()
