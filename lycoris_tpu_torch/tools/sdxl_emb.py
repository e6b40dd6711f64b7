"""Make a textual-inversion embedding from token ids, SDXL format
(counterpart of the JAX package's ``tools/sdxl_emb.py``; reference
tools/sdxl_emb.py:42-66): the rows of the two CLIP token-embedding tables
(clip_l 768-d, clip_g 1280-d) under the ``clip_l``/``clip_g`` keys A1111
reads. The tables come from text-encoder state-dict checkpoints; pass
token ids, or text and a local tokenizer directory (needs ``transformers``).

    python -m lycoris_tpu_torch.tools.sdxl_emb --te1 te1.safetensors --te2 te2.safetensors \\
        --ids 320 1125 --output my_emb.safetensors
"""

import argparse

import torch

from ._common import add_device, device, save


def find_embedding_table(sd, hints=("token_embedding", "embeddings.token_embedding", "tok_embeddings")):
    for k, v in sd.items():
        if any(h in k for h in hints) and getattr(v, "ndim", 0) == 2:
            return v
    raise KeyError(f"no token embedding table found; keys: {list(sd)[:5]}...")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--te1", required=True, help="clip_l text encoder checkpoint")
    parser.add_argument("--te2", default=None, help="clip_g text encoder checkpoint (SDXL)")
    parser.add_argument("--ids", type=int, nargs="*", default=None, help="token ids")
    parser.add_argument("--text", default=None)
    parser.add_argument("--tokenizer", default=None, help="local tokenizer dir (for --text)")
    parser.add_argument("--output", required=True)
    add_device(parser)
    args = parser.parse_args(argv)

    from ..wrapper import load_file_sd

    dev = device(args.device)
    ids = args.ids
    if ids is None:
        assert args.text and args.tokenizer, "pass --ids, or --text with --tokenizer"
        from transformers import CLIPTokenizer

        tok = CLIPTokenizer.from_pretrained(args.tokenizer)
        ids = tok(args.text)["input_ids"][1:-1]  # strip BOS/EOS
    ids = torch.tensor(ids, dtype=torch.int64, device=dev)

    emb = {"clip_l": find_embedding_table(load_file_sd(args.te1)).to(dev)[ids]}
    if args.te2:
        emb["clip_g"] = find_embedding_table(load_file_sd(args.te2)).to(dev)[ids]

    save(emb, args.output)
    shapes = {k: tuple(v.shape) for k, v in emb.items()}
    print(f"saved {args.output}: {shapes}")


if __name__ == "__main__":
    main()
