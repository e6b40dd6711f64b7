"""The plain PyTorch reference the benchmark holds the port to.

Frozen copies of the UNet's and the DiT's arithmetic (``unet.py``,
``dit.py``) with plain attention and plain norms, an AdamW of its own
(``common.py``); each adapter algorithm's dW is a file of ``../algos/``.
It imports nothing of the port or of the JAX package, and takes only what
the benchmark made: base weights and adapter tensors it regenerates from
the seed, and the inputs. ``precision="fp32"`` is the reference (TF32 off); ``"fp8"`` is the
control: every matmul's, convolution's and attention product's operands
rounded to float8 (e4m3 forward, e5m2 gradients, a scale a tensor).
"""
