"""Stateless math of the port: shared ops (:mod:`.general`), LoKr
(:mod:`.lokr`), LoHa (:mod:`.loha`) and the factored merged backward
(:mod:`.merged`)."""

from . import general, loha, lokr, merged

__all__ = ["general", "loha", "lokr", "merged"]
