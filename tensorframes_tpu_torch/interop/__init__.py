"""Network front ends of the port."""

from .serving import ScoringServer

__all__ = ["ScoringServer"]
