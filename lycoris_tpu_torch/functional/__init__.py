"""Stateless math of the port: shared ops (:mod:`.general`), LoRA/LoCon
(:mod:`.locon`), LoKr (:mod:`.lokr`), LoHa (:mod:`.loha`), Diag-OFT
(:mod:`.diag_oft`), BOFT (:mod:`.boft`) and the factored merged backward
(:mod:`.merged`)."""

from . import boft, diag_oft, general, locon, loha, lokr, merged

__all__ = ["general", "locon", "loha", "lokr", "diag_oft", "boft", "merged"]
