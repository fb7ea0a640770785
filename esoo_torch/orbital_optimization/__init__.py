"""OptOrb solvers: integral rotation, Stiefel descent, the fused loops
(VQE, the excited-state family, exact CASSCF)."""

from .casscf import FusedOptOrbCASSCF, FusedOptOrbSACASSCF
from .fused import (FusedOptOrbAdaptVQE, FusedOptOrbEigensolverResult,
                    FusedOptOrbMCVQE, FusedOptOrbResult, FusedOptOrbSSVQE,
                    FusedOptOrbVQD, FusedOptOrbVQE)

__all__ = ["FusedOptOrbAdaptVQE", "FusedOptOrbCASSCF",
           "FusedOptOrbEigensolverResult", "FusedOptOrbMCVQE",
           "FusedOptOrbResult", "FusedOptOrbSACASSCF", "FusedOptOrbSSVQE",
           "FusedOptOrbVQD", "FusedOptOrbVQE"]
