"""Optimizers and eigensolvers."""

from .davidson import (BlockDavidsonResult, BlockDavidsonState,
                       DavidsonResult, davidson_block, davidson_block_advance,
                       davidson_block_finish, davidson_block_init,
                       davidson_ground)
from .lbfgs import (LBFGSResult, LBFGSState, default_ftol, lbfgs_advance,
                    lbfgs_init, lbfgs_minimize)

__all__ = ["BlockDavidsonResult", "BlockDavidsonState", "DavidsonResult",
           "LBFGSResult", "LBFGSState", "davidson_block",
           "davidson_block_advance", "davidson_block_finish",
           "davidson_block_init", "davidson_ground", "default_ftol",
           "lbfgs_advance", "lbfgs_init", "lbfgs_minimize"]
