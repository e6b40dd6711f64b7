"""Merge a LyCORIS adapter file into a full model checkpoint (counterpart of
the JAX package's ``tools/merge.py``; reference tools/merge.py:63-127), on
raw state-dict checkpoints of any architecture. Each merged weight is
formed in fp32 on ``--device`` and cast back to its dtype.

    python -m lycoris_tpu_torch.tools.merge <base_ckpt> <lycoris_file> <out_ckpt>
        [--weight 1.0] [--prefix lora_unet] [--dtype float16] [--device cuda]
"""

import argparse

import torch

from ._common import add_device, device, save


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("base_model")
    parser.add_argument("lycoris_model")
    parser.add_argument("output_name")
    parser.add_argument("--weight", type=float, default=1.0)
    parser.add_argument("--prefix", default="lora_unet")
    parser.add_argument("--dtype", default=None, choices=[None, "float16", "bfloat16", "float32"])
    parser.add_argument("--is_sdxl", action="store_true", help="unused; kept for flag parity")
    add_device(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from ..graph import ModelGraph
    from ..utils.merge import merge
    from ..wrapper import load_file_sd

    dev = device(args.device)
    base_sd = load_file_sd(args.base_model)
    lyco_sd = load_file_sd(args.lycoris_model)
    if args.prefix != "lora_unet":
        lyco_sd = {k.replace(f"{args.prefix}_", "lora_unet_", 1): v for k, v in lyco_sd.items()}

    graph = ModelGraph.from_state_dict(base_sd)
    merged_trees, count = merge([], graph, lyco_sd, scale=args.weight, device=dev)

    out_sd = dict(base_sd)
    for name, sub in merged_trees["lora_unet"].items():
        out_sd[f"{name}.weight"] = sub["weight"].cpu()
        if "bias" in sub:
            out_sd[f"{name}.bias"] = sub["bias"].cpu()
    if args.dtype:
        out_sd = {k: v.to(getattr(torch, args.dtype)) for k, v in out_sd.items()}
    save(out_sd, args.output_name)
    print(f"merged {count} modules -> {args.output_name}")


if __name__ == "__main__":
    main()
