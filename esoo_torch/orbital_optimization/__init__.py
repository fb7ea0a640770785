"""OptOrb solvers: integral rotation, Stiefel descent, the fused loop."""

from .fused import FusedOptOrbResult, FusedOptOrbVQE

__all__ = ["FusedOptOrbResult", "FusedOptOrbVQE"]
