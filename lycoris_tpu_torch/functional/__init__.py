"""Stateless math of the port: shared ops (:mod:`.general`), LoRA/LoCon
(:mod:`.locon`), LoKr (:mod:`.lokr`), LoHa (:mod:`.loha`) and the factored
merged backward (:mod:`.merged`)."""

from . import general, locon, loha, lokr, merged

__all__ = ["general", "locon", "loha", "lokr", "merged"]
