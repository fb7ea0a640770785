"""Multistate-Contracted VQE (MCVQE).

Port of esoo_tpu/solvers/mcvqe.py (the reference's mcvqe.py, class
MCVQE(SSVQE) :48-487): initial states come from a classical CIS/CISD
diagonalization (initializations/ci.py), the ansatz is optimized
SSVQE-style over those states, and the final eigenvalues are obtained by
diagonalizing the k x k contracted Hamiltonian whose off-diagonal
elements are measured through (|i> +/- |j>)/sqrt(2) superposition states:
H_ij = (E_plus - E_minus) / 2 (reference mcvqe.py:435-465), diagonals
H_ii = E_i.  The superposition states go through the compiled shared
ansatz on the solver's device as one stack.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..initializations.ci import get_CIS_states, get_CISD_states
from ..ops.pauli import SparsePauliOp
from ..sim.circuit import QuantumCircuit
from ..sim.estimator import Estimator
from ..sim.statevector import compile_circuit
from ..utils.config import real_dtype
from .optimizers import Optimizer
from .ssvqe import SSVQE, SSVQEResult, _init_stack, state_energy_fn
from .vqe import AlgorithmError


class MCVQEResult(SSVQEResult):
    def __init__(self):
        super().__init__()
        self.contracted_hamiltonian: Optional[np.ndarray] = None


class MCVQE(SSVQE):
    def __init__(self,
                 estimator: Optional[Estimator] = None,
                 num_particles: Optional[Tuple[int, int]] = None,
                 one_body_integrals: Optional[np.ndarray] = None,
                 two_body_integrals: Optional[np.ndarray] = None,
                 k: Optional[int] = 2,
                 weight_vector: Optional[Sequence[float]] = None,
                 ansatz: Optional[QuantumCircuit] = None,
                 optimizer: Optional[Union[Optimizer, Callable]] = None,
                 initial_point: Optional[Sequence[float]] = None,
                 gradient=None,
                 callback: Optional[Callable] = None,
                 check_input_states_orthogonality: bool = True,
                 excitations: str = None,
                 initial_states: Optional[List[QuantumCircuit]] = None,
                 max_evals_grouped: int = 1,
                 device="cuda"):
        super().__init__(estimator=estimator, k=k, ansatz=ansatz,
                         optimizer=optimizer, initial_point=initial_point,
                         initial_states=initial_states,
                         weight_vector=weight_vector, gradient=gradient,
                         callback=callback,
                         check_input_states_orthogonality=check_input_states_orthogonality,
                         max_evals_grouped=max_evals_grouped, device=device)
        self.num_particles = num_particles
        self.one_body_integrals = (None if one_body_integrals is None
                                   else np.asarray(one_body_integrals))
        self.two_body_integrals = (None if two_body_integrals is None
                                   else np.asarray(two_body_integrals))
        # None (+ no initial_states) falls back to computational-basis
        # initial states, like the reference (mcvqe.py:256-290 runs the CI
        # branches only for 's'/'sd')
        self.excitations = excitations
        self._ci_vectors: Optional[List[torch.Tensor]] = None

    def _state_of(self, circuit: QuantumCircuit) -> torch.Tensor:
        return compile_circuit(circuit).state(device=self.device)

    # -- CI-state preparation ---------------------------------------------
    def initialize_mcvqe(self):
        """Classically diagonalize CIS/CISD and store the k lowest states."""
        if self.initial_states is not None:
            self._ci_vectors = [self._state_of(st)
                                for st in self.initial_states]
            return
        if self.excitations is None:
            # computational-basis defaults (SSVQE default states)
            states = self._resolved_initial_states(self._num_qubits_hint)
            self._ci_vectors = [self._state_of(st) for st in states]
            self.initial_states = states
            return
        if self.one_body_integrals is None or self.two_body_integrals is None:
            raise AlgorithmError(
                "MCVQE needs integrals (or explicit initial_states)")
        if self.excitations == "s":
            states = get_CIS_states(self.one_body_integrals,
                                    self.two_body_integrals,
                                    self.num_particles,
                                    state_representation="dense")
        elif self.excitations in ("sd", "d"):
            states = get_CISD_states(self.one_body_integrals,
                                     self.two_body_integrals,
                                     self.num_particles,
                                     state_representation="dense")
        else:
            raise AlgorithmError(f"unknown excitations {self.excitations!r}")
        if len(states) < self.k:
            raise AlgorithmError(
                f"CI produced {len(states)} states < k={self.k}")
        circs = []
        for vec in states[: self.k]:
            qc = QuantumCircuit(self._num_qubits_hint)
            qc.initialize_statevector(np.asarray(vec))
            circs.append(qc)
        self._ci_vectors = [self._state_of(c) for c in circs]
        self.initial_states = circs

    def compute_eigenvalues(self, operator: SparsePauliOp,
                            aux_operators=None) -> MCVQEResult:
        self._num_qubits_hint = operator.num_qubits
        self.initialize_mcvqe()

        base = super().compute_eigenvalues(operator, aux_operators)

        # contracted Hamiltonian: the superposition-state energies through
        # the compiled shared ansatz, all pairs in one stack
        k = self.k
        Hc = np.diag(np.asarray(base.eigenvalues, dtype=np.float64))
        compiled = compile_circuit(self.ansatz)
        theta = torch.as_tensor(np.asarray(base.optimal_point,
                                           dtype=np.float64),
                                device=self.device).to(real_dtype())
        pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
        if pairs:
            r2 = np.sqrt(2.0)
            vecs = []
            for i, j in pairs:
                vi, vj = self._ci_vectors[i], self._ci_vectors[j]
                vecs += [(vi + vj) / r2, (vi - vj) / r2]
            init = _init_stack(vecs, compiled)
            energy_of = state_energy_fn(operator, operator.num_qubits,
                                        not init.is_complex(), self.device)
            with torch.no_grad():
                e = energy_of(compiled.apply_fn(init, theta)).cpu().numpy()
            for n, (i, j) in enumerate(pairs):
                Hc[i, j] = Hc[j, i] = 0.5 * (e[2 * n] - e[2 * n + 1])

        w, _ = np.linalg.eigh(Hc)

        result = MCVQEResult()
        result.__dict__.update(base.__dict__)
        result.eigenvalues = w
        result.contracted_hamiltonian = Hc
        return result
