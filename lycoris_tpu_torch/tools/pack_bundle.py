"""Pack textual-inversion embeddings into a LoRA file, the webui bundle
format (counterpart of the JAX package's ``tools/pack_bundle.py``). The
tensors pass through as they are; ``--device`` is only checked.

    python -m lycoris_tpu_torch.tools.pack_bundle <lora.safetensors> <emb1> [emb2 ...] [-o out]
"""

import argparse
import os

from ._common import add_device, device, save


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("lora_model")
    parser.add_argument("embeddings", nargs="+")
    parser.add_argument("-o", "--output", default=None)
    add_device(parser)
    args = parser.parse_args(argv)

    from ..utils.bundle import pack_bundle
    from ..wrapper import load_file_sd

    device(args.device)
    lora_sd = load_file_sd(args.lora_model)
    embs = {
        os.path.splitext(os.path.basename(x))[0]: load_file_sd(x) for x in args.embeddings
    }
    lora_sd = pack_bundle(lora_sd, embs, verbose=True)

    out = args.output or f"{os.path.splitext(args.lora_model)[0]}_bundle.safetensors"
    save(lora_sd, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
