"""Particle-number-sector simulation of UCC ansaetze."""

from .ansatz import UCC, UCCSD, HartreeFock, generate_excitations
from .sector import SectorUCC

__all__ = ["HartreeFock", "SectorUCC", "UCC", "UCCSD",
           "generate_excitations"]
