"""Convert HCP-diffusion <-> webui LoRA files by directory (counterpart of
the JAX package's ``tools/batch_hcp_convert.py``; reference
tools/batch_hcp_convert.py:391-687). The key conversion is
:mod:`lycoris_tpu_torch.utils.hcp_convert`'s; the tensors are moved to
``--device`` for the alpha scaling and casts.

    # HCP (unet-*.safetensors + text_encoder-*.safetensors pairs) -> webui
    python -m lycoris_tpu_torch.tools.batch_hcp_convert to_webui --src <files/dirs...> --dst_dir D [--sdxl] [--auto_scale_alpha]
    # webui -> HCP (writes unet-*.safetensors / text_encoder-*.safetensors)
    python -m lycoris_tpu_torch.tools.batch_hcp_convert from_webui --src <files/dirs...> --dst_dir D [--sdxl] [--auto_scale_alpha]
"""

import argparse
import os
from collections import defaultdict

from ._common import add_device, device, gather, save


def get_unet_te_pairs(files):
    """Pair unet-*/text_encoder-* files by their shared suffix
    (reference batch_hcp_convert.py:427-456)."""
    pairs = defaultdict(lambda: {"unet": None, "TE": None})
    for f in files:
        name, _ = os.path.splitext(os.path.basename(f))
        if name.startswith("unet-"):
            pairs[name[len("unet-"):]]["unet"] = f
        elif name.startswith("text_encoder-"):
            pairs[name[len("text_encoder-"):]]["TE"] = f
    return pairs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("direction", choices=["to_webui", "from_webui"])
    parser.add_argument("--src", nargs="+", required=True)
    parser.add_argument("--dst_dir", required=True)
    parser.add_argument("--network_type", default="lora", choices=["lora", "plugin"])
    parser.add_argument("--sdxl", action="store_true")
    parser.add_argument("--auto_scale_alpha", action="store_true")
    parser.add_argument("--save_fp16", action="store_true")
    parser.add_argument("--recursive", action="store_true")
    add_device(parser)
    args = parser.parse_args(argv)

    from ..utils.hcp_convert import LoraConverter
    from ..wrapper import load_file_sd

    dev = device(args.device)

    def load(path):
        return {k: v.to(dev) for k, v in load_file_sd(path).items()}

    os.makedirs(args.dst_dir, exist_ok=True)
    conv = LoraConverter(save_fp16=args.save_fp16)
    files = gather(args.src, recursive=args.recursive)

    if args.direction == "to_webui":
        for suffix, pair in get_unet_te_pairs(files).items():
            sd_unet = load(pair["unet"]) if pair["unet"] else {}
            sd_te = load(pair["TE"]) if pair["TE"] else {}
            out = conv.convert_to_webui(
                sd_unet, sd_te, args.network_type, args.auto_scale_alpha, args.sdxl
            )
            path = os.path.join(args.dst_dir, f"webui-{suffix}.safetensors")
            save(out, path)
            print(f"saved {path} ({len(out)} tensors)")
    else:
        for f in files:
            sd_unet, sd_te = conv.convert_from_webui(
                load(f), args.network_type, args.auto_scale_alpha, args.sdxl
            )
            name = os.path.splitext(os.path.basename(f))[0]
            p1 = os.path.join(args.dst_dir, f"unet-{name}.safetensors")
            p2 = os.path.join(args.dst_dir, f"text_encoder-{name}.safetensors")
            save(sd_unet[args.network_type], p1)
            save(sd_te[args.network_type], p2)
            print(f"saved {p1} / {p2}")


if __name__ == "__main__":
    main()
