"""OptOrb solvers: integral rotation, Stiefel descent, the fused loops
(VQE and exact CASSCF)."""

from .casscf import FusedOptOrbCASSCF, FusedOptOrbSACASSCF
from .fused import (FusedOptOrbEigensolverResult, FusedOptOrbResult,
                    FusedOptOrbVQE)

__all__ = ["FusedOptOrbCASSCF", "FusedOptOrbEigensolverResult",
           "FusedOptOrbResult", "FusedOptOrbSACASSCF", "FusedOptOrbVQE"]
