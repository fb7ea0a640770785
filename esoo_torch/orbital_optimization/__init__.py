"""OptOrb solvers: integral rotation, Stiefel descent, the class-based
OptOrb loops over the VQE family, and the fused loops (VQE, the
excited-state family, exact CASSCF)."""

from .base import BaseOptOrbResult, BaseOptOrbSolver
from .casscf import FusedOptOrbCASSCF, FusedOptOrbSACASSCF
from .checkpoint import load_checkpoint, save_checkpoint
from .eigensolver import OptOrbEigensolver, OptOrbEigensolverResult
from .fused import (FusedOptOrbAdaptVQE, FusedOptOrbEigensolverResult,
                    FusedOptOrbMCVQE, FusedOptOrbResult, FusedOptOrbSSVQE,
                    FusedOptOrbVQD, FusedOptOrbVQE)
from .kernels import (expand_spin, rotate_one_body, rotate_two_body,
                      rotated_energy_so, rotated_energy_spatial,
                      spin_reduce_rdms, spin_squared_from_rdms)
from .minimum_eigensolver import (OptOrbMinimumEigensolver,
                                  OptOrbMinimumEigensolverResult)
from .opt_orb_adapt_vqe import OptOrbAdaptVQE, OptOrbAdaptVQEResult
from .opt_orb_mcvqe import OptOrbMCVQE, OptOrbMCVQEResult
from .opt_orb_ssvqe import OptOrbSSVQE, OptOrbSSVQEResult
from .opt_orb_vqd import OptOrbVQD, OptOrbVQDResult
from .opt_orb_vqe import OptOrbVQE, OptOrbVQEResult
from .stiefel import PartialUnitaryProjectionOptimizer, StiefelOptResult, orth

__all__ = ["BaseOptOrbResult", "BaseOptOrbSolver", "FusedOptOrbAdaptVQE",
           "FusedOptOrbCASSCF", "FusedOptOrbEigensolverResult",
           "FusedOptOrbMCVQE", "FusedOptOrbResult", "FusedOptOrbSACASSCF",
           "FusedOptOrbSSVQE", "FusedOptOrbVQD", "FusedOptOrbVQE",
           "OptOrbAdaptVQE", "OptOrbAdaptVQEResult", "OptOrbEigensolver",
           "OptOrbEigensolverResult", "OptOrbMCVQE", "OptOrbMCVQEResult",
           "OptOrbMinimumEigensolver", "OptOrbMinimumEigensolverResult",
           "OptOrbSSVQE", "OptOrbSSVQEResult", "OptOrbVQD", "OptOrbVQDResult",
           "OptOrbVQE", "OptOrbVQEResult",
           "PartialUnitaryProjectionOptimizer", "StiefelOptResult",
           "expand_spin", "load_checkpoint", "orth", "rotate_one_body",
           "rotate_two_body", "rotated_energy_so", "rotated_energy_spatial",
           "save_checkpoint", "spin_reduce_rdms", "spin_squared_from_rdms"]
