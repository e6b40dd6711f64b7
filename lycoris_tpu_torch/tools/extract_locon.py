"""Extract a LoCon adapter from the difference of two model checkpoints
(counterpart of the JAX package's ``tools/extract_locon.py``; reference
tools/extract_locon.py:7-190). Any two raw state-dict checkpoints of one
architecture (.safetensors / .pt) work: layer kinds come from the weights'
shapes, and the SVDs run batched on ``--device``.

    python -m lycoris_tpu_torch.tools.extract_locon [flags] <base_ckpt> <db_ckpt> <out_file>

Flags as the reference's: --mode fixed|threshold|ratio|quantile|full,
--linear_dim/--conv_dim (fixed), --linear_threshold/--conv_threshold, ...
"""

import argparse

from ._common import add_device, device, save


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("base_model", help="base checkpoint (.safetensors/.pt)")
    parser.add_argument("db_model", help="tuned checkpoint (.safetensors/.pt)")
    parser.add_argument("output_name", help="output adapter file (.safetensors)")
    parser.add_argument("--is_sdxl", action="store_true", help="unused; kept for flag parity")
    parser.add_argument("--prefix", default="lora_unet", help="lora_name prefix for all layers")
    parser.add_argument(
        "--mode",
        default="fixed",
        choices=["fixed", "threshold", "ratio", "quantile", "full"],
    )
    parser.add_argument("--safetensors", action="store_true", default=True)
    parser.add_argument("--linear_dim", type=int, default=64)
    parser.add_argument("--conv_dim", type=int, default=64)
    parser.add_argument("--linear_threshold", type=float, default=0.0)
    parser.add_argument("--conv_threshold", type=float, default=0.0)
    parser.add_argument("--linear_ratio", type=float, default=0.0)
    parser.add_argument("--conv_ratio", type=float, default=0.0)
    parser.add_argument("--linear_quantile", type=float, default=0.75)
    parser.add_argument("--conv_quantile", type=float, default=0.75)
    parser.add_argument("--use_sparse_bias", action="store_true")
    parser.add_argument("--sparsity", type=float, default=0.98)
    parser.add_argument("--disable_cp", action="store_true")
    add_device(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from ..graph import ModelGraph
    from ..utils.extract import extract_diff
    from ..wrapper import load_file_sd

    dev = device(args.device)
    mode_params = {
        "fixed": (args.linear_dim, args.conv_dim),
        "threshold": (args.linear_threshold, args.conv_threshold),
        "ratio": (args.linear_ratio, args.conv_ratio),
        "quantile": (args.linear_quantile, args.conv_quantile),
        "full": (0, 0),
    }
    linear_param, conv_param = mode_params[args.mode]

    base = ModelGraph.from_state_dict(load_file_sd(args.base_model))
    db = ModelGraph.from_state_dict(load_file_sd(args.db_model))

    sd = extract_diff(
        [],
        [],
        base,
        db,
        mode=args.mode,
        linear_mode_param=linear_param,
        conv_mode_param=conv_param,
        extract_device=dev,
        use_bias=args.use_sparse_bias,
        sparsity=args.sparsity,
        small_conv=not args.disable_cp,
    )
    if args.prefix != "lora_unet":
        sd = {k.replace("lora_unet_", f"{args.prefix}_", 1): v for k, v in sd.items()}
    save(sd, args.output_name)
    print(f"saved {len(sd)} tensors to {args.output_name}")


if __name__ == "__main__":
    main()
