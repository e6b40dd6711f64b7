"""Hand-written CUDA kernels of the serving and training paths, forward and
backward, each beside its plain PyTorch version and wrapped in an autograd
Function: LayerNorm (:mod:`.layer_norm`), flash attention (:mod:`.flash`,
dispatched by :mod:`.attention`) and the LoHa delta weight (:mod:`.hada`).
Kernels build on first use (:mod:`._build`)."""
