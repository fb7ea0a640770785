"""OptOrbSSVQE: excited-state orbital optimization over SSVQE
(arXiv:2310.09418).

Port of esoo_tpu/orbital_optimization/opt_orb_ssvqe.py (reference:
opt_orb_ssvqe.py:15-106).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..solvers.vqe import AlgorithmError
from .eigensolver import OptOrbEigensolver, OptOrbEigensolverResult


class OptOrbSSVQE(OptOrbEigensolver):
    def __init__(self, *args,
                 eigensolver_random_perturbation: Optional[float] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        solver = self._excited_states_solver_list[0]
        if solver.__class__.__name__ != "SSVQE":
            raise AlgorithmError(
                "The excited states solver needs to be of type SSVQE, not "
                f"{solver.__class__.__name__}")
        self.eigensolver_random_perturbation = eigensolver_random_perturbation

    def parameter_update_rule(self, result, iteration: int):
        point = np.asarray(result.optimal_point)
        scale = self.eigensolver_random_perturbation
        if scale:
            point = point + self._rng.normal(0.0, scale, size=point.size)
        self._excited_states_solver_list[iteration].initial_point = point


class OptOrbSSVQEResult(OptOrbEigensolverResult):
    pass
