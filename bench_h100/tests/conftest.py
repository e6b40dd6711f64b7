"""The toy sizes of the Wan cell's configuration and mix, registered beside
``tiny.py``'s UNet and DiT ones, so that ``tiny.tiny_root`` cuts every
configuration and mix of the manifest."""

from bench_h100 import tiny

tiny.TINY_SIZES.setdefault("wan", {
    "dim": 48, "ffn_dim": 96, "freq_dim": 32, "text_dim": 16, "in_dim": 16, "out_dim": 16,
    "num_heads": 2, "num_layers": 2, "patch_size": [1, 2, 2], "eps": 1e-6})
tiny.TINY_TRAFFIC.setdefault("wan_train", {"latent_fhw": [3, 4, 4], "context_tokens": 7,
                                           "pool_batches": 3, "ref_qblock": 5})
