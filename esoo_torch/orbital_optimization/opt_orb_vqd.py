"""OptOrbVQD: excited-state orbital optimization over VQD.

Port of esoo_tpu/orbital_optimization/opt_orb_vqd.py (reference:
opt_orb_vqd.py:15-110).  VQD's initial point is per-state
(one deflation step each), so the warm start updates a list (ref :93-104).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..solvers.vqe import AlgorithmError
from .eigensolver import OptOrbEigensolver, OptOrbEigensolverResult


class OptOrbVQD(OptOrbEigensolver):
    def __init__(self, *args,
                 eigensolver_random_perturbation: Optional[float] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        solver = self._excited_states_solver_list[0]
        if solver.__class__.__name__ != "VQD":
            raise AlgorithmError(
                "The excited states solver needs to be of type VQD, not "
                f"{solver.__class__.__name__}")
        self.eigensolver_random_perturbation = eigensolver_random_perturbation

    def parameter_update_rule(self, result, iteration: int):
        solver = self._excited_states_solver_list[iteration]
        scale = self.eigensolver_random_perturbation
        points = []
        for pt in result.optimal_points:
            pt = np.asarray(pt)
            if scale:
                pt = pt + self._rng.normal(0.0, scale, size=pt.size)
            points.append(pt)
        solver.initial_point = points


class OptOrbVQDResult(OptOrbEigensolverResult):
    pass
