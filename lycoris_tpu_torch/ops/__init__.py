"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version: LayerNorm (:mod:`.layer_norm`), flash attention
(:mod:`.flash`, dispatched by :mod:`.attention`) and the LoHa delta weight
(:mod:`.hada`). Kernels build on first use (:mod:`._build`)."""
