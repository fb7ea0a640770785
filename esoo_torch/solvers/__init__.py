"""Optimizers."""

from .lbfgs import (LBFGSResult, LBFGSState, default_ftol, lbfgs_advance,
                    lbfgs_init, lbfgs_minimize)

__all__ = ["LBFGSResult", "LBFGSState", "default_ftol", "lbfgs_advance",
           "lbfgs_init", "lbfgs_minimize"]
