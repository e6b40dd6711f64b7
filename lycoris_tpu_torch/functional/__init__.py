"""Stateless math of the port: shared ops (:mod:`.general`), LoKr
(:mod:`.lokr`) and LoHa (:mod:`.loha`)."""

from . import general, loha, lokr

__all__ = ["general", "loha", "lokr"]
