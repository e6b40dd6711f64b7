"""Several LyCORIS adapters composed on one model (counterpart of
``example/stacked_wrapper_demo.py``).

As in the reference, stacking chains the patched forwards: the second
network's forward wraps the first's, each adding its delta to what runs
inside it (``merged_forward=False``), so adapters trained apart compose
additively. They come off in reverse order.

    python -m lycoris_tpu_torch.examples.stacked_wrapper_demo [--train] [--device cpu]
"""

import argparse

import torch
import torch.nn.functional as F
from torch import nn

from lycoris_tpu_torch import create_lycoris


class DemoNet(nn.Module):
    """Names intentionally awkward (test_1 / te_2st / _3test) like the
    reference demo: they exercise the lora_name mangling."""

    def __init__(self, device=None):
        super().__init__()
        self.test_1 = nn.Linear(64, 256, device=device)
        self.te_2st = nn.Linear(256, 64, device=device)
        self._3test = nn.Linear(64, 10, device=device)

    def forward(self, x):
        h = self.te_2st(F.mish(self.test_1(x)))
        return self._3test(x + h)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train", action="store_true",
                        help="fit the second adapter on a toy objective")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    dev = torch.device(args.device)
    torch.manual_seed(1)
    model = DemoNet(device=dev).requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(16, 64, generator=gen, device=dev)

    # two independent adapters of different algorithms, factors moved off
    # their zero init
    net_lora = create_lycoris(model, 1.0, linear_dim=8, linear_alpha=4.0, algo="lora", seed=1)
    net_lokr = create_lycoris(model, 1.0, linear_dim=8, linear_alpha=4.0, algo="lokr",
                              factor=4, seed=2)
    with torch.no_grad():
        for net in (net_lora, net_lokr):
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)

    def run(*nets):
        for net in nets:
            net.apply_to(merged_forward=False)
        try:
            return model(x)
        finally:
            for net in reversed(nets):
                net.restore()

    with torch.no_grad():
        base, out1, out2 = run(), run(net_lora), run(net_lokr)
        stacked = run(net_lora, net_lokr)
    d1, d2, d12 = ((o - base).abs().max().item() for o in (out1, out2, stacked))
    add = ((stacked - base) - (out1 - base) - (out2 - base)).abs().max().item()
    print(f"|lora delta|   = {d1:.5f}")
    print(f"|lokr delta|   = {d2:.5f}")
    print(f"|stack delta|  = {d12:.5f}")
    print(f"|stack - (lora+lokr)| = {add:.2e}  (additive within 2nd-order terms)")

    if args.train:
        # fit only the lokr adapter while the lora adapter stays frozen in the stack
        target = torch.randn(16, 10, generator=torch.Generator(device=dev).manual_seed(7),
                             device=dev)
        net_lora.requires_grad_(False)
        opt = torch.optim.Adam(net_lokr.parameters(), lr=1e-2)
        net_lora.apply_to(merged_forward=False)
        net_lokr.apply_to(merged_forward=False)
        for _ in range(20):
            loss = ((model(x) - target) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        net_lokr.restore()
        net_lora.restore()
        print(f"trained stacked lokr 20 steps, loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
