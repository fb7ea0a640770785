"""OptOrbVQE: ground-state orbital-optimized VQE (arXiv:2208.14431).

Port of esoo_tpu/orbital_optimization/opt_orb_vqe.py (reference:
opt_orb_vqe.py:15-103).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..solvers.vqe import AlgorithmError
from .minimum_eigensolver import (OptOrbMinimumEigensolver,
                                  OptOrbMinimumEigensolverResult)


class OptOrbVQE(OptOrbMinimumEigensolver):
    """VQE-specialized OptOrb loop: warm-starts each VQE at the previous
    optimum, optionally with Gaussian perturbation (ref :88-97)."""

    def __init__(self, *args,
                 minimum_eigensolver_random_perturbation: Optional[float] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        solver = self._ground_state_solver_list[0]
        if solver.__class__.__name__ != "VQE":
            raise AlgorithmError(
                "The ground state solver needs to be of type VQE, not "
                f"{solver.__class__.__name__}")
        self.minimum_eigensolver_random_perturbation = \
            minimum_eigensolver_random_perturbation

    def parameter_update_rule(self, result, iteration: int):
        point = np.asarray(result.optimal_point)
        scale = self.minimum_eigensolver_random_perturbation
        if scale:
            point = point + self._rng.normal(0.0, scale, size=point.size)
        self._ground_state_solver_list[iteration].initial_point = point


class OptOrbVQEResult(OptOrbMinimumEigensolverResult):
    pass
