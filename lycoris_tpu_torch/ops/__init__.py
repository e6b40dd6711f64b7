"""Hand-written CUDA kernels of the serving and training paths, forward and
backward, each beside its plain PyTorch version and wrapped in an autograd
Function: LayerNorm (:mod:`.layer_norm`), flash attention (:mod:`.flash`,
dispatched by :mod:`.attention`), the LoHa delta weight (:mod:`.hada`,
with the fused1 and the split backward), GroupNorm with a folded SiLU
(:mod:`.group_norm`), the GEGLU backward (:mod:`.geglu`), the fused LoRA
matmul (:mod:`.lora_fused`) and LoKr's one-pass merge W + c kron(w1, w2)
(:mod:`.kron`, no autograd: taken where no graph runs through the merge).
Kernels build on first use (:mod:`._build`)."""
