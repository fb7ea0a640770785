"""Optimizers and eigensolvers: the class-based VQE family (VQE, SSVQE,
MCVQE, VQD, AdaptVQE) and its optimizers, L-BFGS and Davidson."""

from .adapt_vqe import AdaptVQE, AdaptVQEResult, TerminationCriterion
from .davidson import (BlockDavidsonResult, BlockDavidsonState,
                       DavidsonResult, davidson_block, davidson_block_advance,
                       davidson_block_finish, davidson_block_init,
                       davidson_ground)
from .lbfgs import (LBFGSResult, LBFGSState, default_ftol, lbfgs_advance,
                    lbfgs_init, lbfgs_minimize)
from .mcvqe import MCVQE, MCVQEResult
from .optimizers import (ADAM, CG, COBYLA, L_BFGS_B, NELDER_MEAD, POWELL,
                         SLSQP, SPSA, DeviceLBFGS, GradientDescent,
                         Minimizer, Optimizer, OptimizerResult)
from .ssvqe import SSVQE, SSVQEResult
from .vqd import VQD, VQDResult
from .vqe import (VQE, AlgorithmError, NumPyEigensolver,
                  NumPyEigensolverResult, NumPyMinimumEigensolver, VQEResult)

__all__ = ["ADAM", "AdaptVQE", "AdaptVQEResult", "AlgorithmError",
           "BlockDavidsonResult", "BlockDavidsonState", "CG", "COBYLA",
           "DavidsonResult", "DeviceLBFGS", "GradientDescent", "L_BFGS_B",
           "LBFGSResult", "LBFGSState", "MCVQE", "MCVQEResult",
           "Minimizer", "NELDER_MEAD", "NumPyEigensolver",
           "NumPyEigensolverResult", "NumPyMinimumEigensolver", "Optimizer",
           "OptimizerResult", "POWELL", "SLSQP", "SPSA", "SSVQE",
           "SSVQEResult", "TerminationCriterion", "VQD", "VQDResult", "VQE",
           "VQEResult", "davidson_block", "davidson_block_advance",
           "davidson_block_finish", "davidson_block_init", "davidson_ground",
           "default_ftol", "lbfgs_advance", "lbfgs_init", "lbfgs_minimize"]
