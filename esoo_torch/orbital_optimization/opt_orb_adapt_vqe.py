"""OptOrbAdaptVQE: ground-state orbital-optimized ADAPT-VQE.

Port of esoo_tpu/orbital_optimization/opt_orb_adapt_vqe.py (reference:
opt_orb_adapt_vqe.py:15-95).  The ansatz is regrown from the
operator pool each outer iteration, so there is no parameter warm start
(ref :86-89).
"""

from __future__ import annotations

from ..solvers.vqe import AlgorithmError
from .minimum_eigensolver import (OptOrbMinimumEigensolver,
                                  OptOrbMinimumEigensolverResult)


class OptOrbAdaptVQE(OptOrbMinimumEigensolver):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        solver = self._ground_state_solver_list[0]
        if solver.__class__.__name__ != "AdaptVQE":
            raise AlgorithmError(
                "The ground state solver needs to be of type AdaptVQE, not "
                f"{solver.__class__.__name__}")

    def parameter_update_rule(self, result, iteration: int):
        # ansatz regrows from scratch each iteration: nothing to warm start
        pass


class OptOrbAdaptVQEResult(OptOrbMinimumEigensolverResult):
    pass
