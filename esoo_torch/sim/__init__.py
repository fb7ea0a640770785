"""Particle-number-sector simulation of UCC ansaetze, and the gate-free
sector of exact CASSCF."""

from .ansatz import (UCC, UCCSD, HartreeFock, OccupationState,
                     generate_excitations)
from .sector import SectorCI, SectorUCC

__all__ = ["HartreeFock", "OccupationState", "SectorCI", "SectorUCC",
           "UCC", "UCCSD", "generate_excitations"]
