"""OptOrbMCVQE: excited-state orbital optimization over MCVQE.

Port of esoo_tpu/orbital_optimization/opt_orb_mcvqe.py (reference:
opt_orb_mcvqe.py:15-119).  Unique among the variants: the MCVQE
eigensolver needs the *transformed* integral tensors internally (its
CIS/CISD initial states are built from them), so the constructor rotates
the integrals by the initial partial unitary and gives them to every
solver copy (ref :90-103).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..solvers.vqe import AlgorithmError
from .base import _numpy
from .eigensolver import OptOrbEigensolver, OptOrbEigensolverResult


class OptOrbMCVQE(OptOrbEigensolver):
    def __init__(self, *args,
                 eigensolver_random_perturbation: Optional[float] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        solver = self._excited_states_solver_list[0]
        if solver.__class__.__name__ != "MCVQE":
            raise AlgorithmError(
                "The excited states solver needs to be of type MCVQE, not "
                f"{solver.__class__.__name__}")
        self.eigensolver_random_perturbation = eigensolver_random_perturbation

        # the rotated integrals of the initial U, on the device, then on
        # the host for the CI builders
        h_so, g_so = self._rotated_integrals(self.initial_partial_unitary)
        h_so, g_so = _numpy(h_so), _numpy(g_so)
        for s in self._excited_states_solver_list:
            s.one_body_integrals = h_so
            s.two_body_integrals = g_so

    def parameter_update_rule(self, result, iteration: int):
        point = np.asarray(result.optimal_point)
        scale = self.eigensolver_random_perturbation
        if scale:
            point = point + self._rng.normal(0.0, scale, size=point.size)
        self._excited_states_solver_list[iteration].initial_point = point


class OptOrbMCVQEResult(OptOrbEigensolverResult):
    pass
