"""BOFT (butterfly OFT) adapter module (counterpart of
``lycoris_tpu/modules/boft.py``; reference lycoris/modules/boft.py).

Blocks (boft_m, block_num, b, b) with ``b, block_num =
power2factorization(out_dim, lora_dim)`` (an error where there is none, as
at SD widths for ``lora_dim`` below 10) and boft_m = popcount(block_num -
1) + 1; keys, ``alpha``, ``rescale``, max-norm and module dropout as
Diag-OFT's, detected by a 4-d ``oft_blocks``. The weight (or, in bypass
mode, the base outputs) goes through the m butterfly stages, each stage's
rotation blended toward I by the multiplier
(``functional.boft.rotate_front``/``rotate_last``: dense Q or the direct
chain by shape, under a checkpoint). BOFT takes no rank or plain dropout,
as in the JAX package.
"""

from __future__ import annotations

from ..functional import boft
from ..functional.general import power2factorization
from .diag_oft import DiagOFTModule


class ButterflyOFTModule(DiagOFTModule):
    name = "boft"
    blocks_ndim = 4
    algo_title = "BOFT"

    def _init_blocks(self, out_dim, lora_dim):
        b, block_num = power2factorization(out_dim, lora_dim)
        if b is None or block_num == 0:
            raise ValueError(f"It is impossible to decompose {out_dim} with factor {lora_dim} "
                             "under BOFT constraints.")
        self.block_size = self.boft_b = b
        self.block_num = block_num
        self.boft_m = (block_num - 1).bit_count() + 1
        self.blocks_shape = (self.boft_m, block_num, b, b)

    def make_weight(self, org_weight, scale=1.0, train=False, seed=None):
        """The butterfly-rotated weight in ``org_weight``'s dtype;
        ``train``/``seed`` draw nothing."""
        blocks = self._p("oft_blocks")
        out = boft.rotate_front(org_weight.to(blocks.dtype), blocks, self._constraint,
                                float(scale))
        if self.rescaled:
            out = out * self._p("rescale")
        return out.to(org_weight.dtype)

    def _bypass(self, x, scale, org_forward):
        """The base output butterfly-rotated, the stages blended by ``scale``."""
        blocks = self._p("oft_blocks")
        org_out = org_forward(x)
        out = org_out.to(blocks.dtype)
        if self.layer.is_conv:
            out = out.transpose(1, -1)
        out = boft.rotate_last(out, blocks, self._constraint, float(scale))
        if self.rescaled:
            out = out * self._p("rescale").transpose(0, -1)
        if self.layer.is_conv:
            out = out.transpose(1, -1)
        return out.to(org_out.dtype)
