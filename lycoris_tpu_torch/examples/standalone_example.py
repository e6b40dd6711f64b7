"""Standalone usage (counterpart of ``example/standalone_example.py``): wrap a
toy MLP with two stacked LoKr networks, train them jointly on a synthetic
task, save and merge.

The second network is applied on top of the first, so both take the delta
route (``merged_forward=False``): each adapted layer runs the forward it
finds and adds its delta. They come off in reverse order.

    python -m lycoris_tpu_torch.examples.standalone_example [--device cpu] [--out FILE]
"""

import argparse
import os
import tempfile

import torch
import torch.nn.functional as F
from torch import nn

from lycoris_tpu_torch import LycorisNetwork, create_lycoris


class DemoNet(nn.Module):
    """The reference's demo model; its awkward names exercise the targeting."""

    def __init__(self, device=None):
        super().__init__()
        self.test_1 = nn.Linear(784, 2048, device=device)
        self.te_2st = nn.Linear(2048, 784, device=device)
        self._3test = nn.Linear(784, 10, device=device)

    def forward(self, x):
        h = self.te_2st(F.mish(self.test_1(x)))
        return self._3test(x + h)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "demo_lokr.safetensors"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    dev = torch.device(args.device)
    torch.manual_seed(0)
    model = DemoNet(device=dev)

    # two stacked adapter networks targeting layers by regex
    LycorisNetwork.apply_preset({"target_name": [".*te.*"]})
    net1 = create_lycoris(model, 1.0, linear_dim=16, linear_alpha=2.0, algo="lokr", seed=0)
    LycorisNetwork.apply_preset({"target_name": [".*es.*"]})
    net2 = create_lycoris(model, 1.0, linear_dim=16, linear_alpha=2.0, algo="lokr", seed=1)
    LycorisNetwork.reset_preset()
    net1.apply_to(merged_forward=False)
    net2.apply_to(merged_forward=False)

    print(f"#Modules of net1: {len(net1.loras)}")
    print(f"#Modules of net2: {len(net2.loras)}")
    print("Total params:", sum(p.numel() for p in model.parameters()))
    print("Net1 Params:", sum(p.numel() for p in net1.parameters()))
    print("Net2 Params:", sum(p.numel() for p in net2.parameters()))

    # joint training of both adapters on a synthetic classification task
    model.requires_grad_(False)
    opt = torch.optim.AdamW([*net1.parameters(), *net2.parameters()], lr=5e-3,
                            weight_decay=1e-4)
    gen = torch.Generator(device=dev).manual_seed(42)
    for i in range(args.steps):
        xb = torch.randn(32, 784, generator=gen, device=dev)
        yb = xb[:, :10].abs().argmax(-1)
        loss = F.cross_entropy(model(xb), yb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 10 == 0:
            print(f"step {i}: loss {loss.item():.4f}")

    # save net1, then merge it into the plain model
    net2.restore()
    net1.restore()
    net1.save_weights(args.out, metadata={})
    net1.merge_to(1.0)
    print(f"saved {args.out}; merged {len(net1.loras)} layers into the model")


if __name__ == "__main__":
    main()
