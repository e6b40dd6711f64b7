"""Pack and unpack LoRA <-> bundle files by directory, the webui bundle
format (counterpart of the JAX package's ``tools/batch_bundle_convert.py``),
pairing ``{name}-{step}.{ext}`` files. The tensors pass through as they
are; ``--device`` is only checked.

    python -m lycoris_tpu_torch.tools.batch_bundle_convert pack --lora_path P [...] --emb_path E [...] --dst_dir D
    python -m lycoris_tpu_torch.tools.batch_bundle_convert unpack --lora_path P [...] --dst_dir D
"""

import argparse
import os

from ._common import add_device, device, gather, save


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("action", choices=["pack", "unpack"])
    parser.add_argument("--lora_path", nargs="+", required=True)
    parser.add_argument("--emb_path", nargs="*", default=[])
    parser.add_argument("--dst_dir", required=True)
    parser.add_argument("--recursive", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    add_device(parser)
    args = parser.parse_args(argv)

    from ..utils.bundle import extract_step, pack_bundle, pair_loras_with_embeddings, unpack_bundle
    from ..wrapper import load_file_sd

    device(args.device)
    os.makedirs(args.dst_dir, exist_ok=True)
    lora_files = gather(args.lora_path, recursive=args.recursive)

    if args.action == "pack":
        emb_files = gather(args.emb_path, recursive=args.recursive)
        pairs = pair_loras_with_embeddings(lora_files, emb_files)
        for step, pair in pairs.items():
            if pair["lora"] is None:
                continue
            lora_sd = load_file_sd(pair["lora"])
            embs = {extract_step(e)[0]: load_file_sd(e) for e in pair["embs"]}
            lora_sd = pack_bundle(lora_sd, embs, args.verbose)
            name, st = extract_step(pair["lora"])
            suffix = f"-{st}" if st != "" else ""
            out = os.path.join(args.dst_dir, f"{name}-bundle{suffix}.safetensors")
            save(lora_sd, out)
            print(f"packed {out}")
    else:
        for lf in lora_files:
            lora_sd = load_file_sd(lf)
            name, st = extract_step(lf)
            lora_sd, embs = unpack_bundle(lora_sd, args.verbose, step=st, emb_format=".safetensors")
            suffix = f"-{st}" if st != "" else ""
            if name.endswith("-bundle"):
                name = name[:-7]
            save(lora_sd, os.path.join(args.dst_dir, f"{name}{suffix}.safetensors"))
            for emb, emb_sd in embs.items():
                save(emb_sd, os.path.join(args.dst_dir, f"{emb}.safetensors"))
            print(f"unpacked {lf}: {len(embs)} embeddings")


if __name__ == "__main__":
    main()
