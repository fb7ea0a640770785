"""Variational Quantum Deflation (VQD), arXiv:1805.08138.

Port of esoo_tpu/solvers/vqd.py (the reference's vqd.py :47-453,
including its extension allowing a different ansatz per state,
vqd.py:17-18).  State k minimizes

  <psi_k(theta)|H|psi_k(theta)> + sum_{j<k} beta_j |<psi_k(theta)|psi_j>|^2

sequentially over k.  The overlap penalties are computed directly from
statevectors inside one differentiable cost on the solver's device
(exact ComputeUncompute semantics): energy, penalties and the gradient of
their sum in one forward and backward pass per optimizer iterate.

`betas=None` resolves to beta_j = 10 + sum_k |coeff_k| of the observable
(the reference's automatic-beta path is dead code, vqd.py:215,235-245;
this is qiskit's VQD fallback, as in the JAX package).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.pauli import SparsePauliOp
from ..orbital_optimization.stiefel import value_and_grad
from ..sim.circuit import QuantumCircuit
from ..sim.estimator import ComputeUncompute, Estimator
from ..sim.statevector import compile_circuit
from ..utils.config import real_dtype, resolve_device
from .energy import make_evaluators
from .optimizers import Optimizer, OptimizerResult
from .ssvqe import state_energy_fn
from .vqe import AlgorithmError, _check_device, _eval_aux_ops, cached_objective


class VQDResult:
    def __init__(self):
        self.eigenvalues: Optional[np.ndarray] = None
        self.optimal_points: Optional[List[np.ndarray]] = None
        self.optimal_parameters: Optional[List[np.ndarray]] = None
        self.optimal_values: Optional[List[float]] = None
        self.optimal_circuits: Optional[List[QuantumCircuit]] = None
        self.cost_function_evals: Optional[List[int]] = None
        self.optimizer_times: Optional[List[float]] = None
        self.optimizer_results: Optional[List[OptimizerResult]] = None
        self.aux_operators_evaluated: Optional[List] = None


def _deflated_cost_vag(compiled, operator, prev_states, betas, device):
    """Host-facing value_and_grad of the deflated cost

        C(theta) = <psi(theta)|H|psi(theta)>
                   + sum_j beta_j |<psi(theta)|psi_j>|^2

    (reference semantics: vqd.py:353-426 recombines estimator and
    fidelity results per evaluation on the host)."""
    state_fn = compiled.state_fn
    energy_of = state_energy_fn(operator, compiled.num_qubits,
                                compiled.is_real, device)

    if prev_states:
        prev = torch.stack(prev_states)
        if prev.is_complex() and bool((prev.imag == 0).all()):
            prev = prev.real
        b = torch.as_tensor(np.asarray(betas, dtype=np.float64),
                            device=device).to(real_dtype())

        def cost(theta):
            s = state_fn(theta)
            if not s.is_complex() and not prev.is_complex():
                ov = prev.to(s.dtype) @ s
                pen = torch.sum(b * ov * ov)
            else:
                ov = torch.conj(prev.to(torch.complex128)) @ \
                    s.to(torch.complex128)
                pen = torch.sum(b * torch.abs(ov) ** 2)
            return energy_of(s) + pen
    else:
        def cost(theta):
            return energy_of(state_fn(theta))

    vag_t = value_and_grad(cost)

    def vag(theta):
        v, g = vag_t(torch.as_tensor(np.asarray(theta, dtype=np.float64),
                                     device=device).to(real_dtype()))
        return float(v), g.cpu().numpy()

    return vag


class VQD:
    """k states by deflation, one after the other, on `device` ("cuda" by
    default)."""

    def __init__(self,
                 estimator: Optional[Estimator] = None,
                 fidelity: Optional[ComputeUncompute] = None,
                 ansatz: Union[QuantumCircuit, List[QuantumCircuit],
                               None] = None,
                 optimizer: Union[Optimizer, Sequence[Optimizer],
                                  None] = None,
                 *,
                 k: int = 2,
                 betas: Optional[Sequence[float]] = None,
                 initial_point=None,
                 callback: Optional[Callable] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        _check_device("VQD", self.device, optimizer, estimator=estimator,
                      fidelity=fidelity)
        self.estimator = estimator
        self.fidelity = fidelity
        self.ansatz = ansatz
        self.optimizer = optimizer
        self.k = k
        self.betas = betas
        self.initial_point = initial_point
        self.callback = callback

    def compute_eigenvalues(self, operator: SparsePauliOp,
                            aux_operators=None) -> VQDResult:
        k = self.k
        ansatze = self.ansatz if isinstance(self.ansatz, (list, tuple)) \
            else [self.ansatz] * k
        ansatze = list(ansatze)
        if len(ansatze) != k:
            raise AlgorithmError(f"need {k} ansatze, got {len(ansatze)}")
        for a in ansatze:
            if a.num_qubits != operator.num_qubits:
                raise AlgorithmError("ansatz/operator qubit mismatch")

        optimizers = self.optimizer \
            if isinstance(self.optimizer, (list, tuple)) \
            else [self.optimizer] * k

        if self.betas is None:
            bound = float(np.sum(np.abs(operator.coeffs))) + 10.0
            betas = [bound] * (k - 1)
        else:
            betas = list(self.betas)
            if len(betas) < k - 1:
                raise AlgorithmError("betas must have length k-1")

        initial_points = self.initial_point
        if initial_points is None:
            rng = np.random.default_rng(0)
            initial_points = [
                rng.uniform(-np.pi, np.pi, a.num_parameters) for a in ansatze
            ]
        elif not isinstance(initial_points[0], (list, tuple, np.ndarray)):
            initial_points = [np.asarray(initial_points)] * k

        eigenvalues = []
        prev_states: List[torch.Tensor] = []
        result = VQDResult()
        result.optimal_points = []
        result.optimal_parameters = []
        result.optimal_values = []
        result.optimal_circuits = []
        result.cost_function_evals = []
        result.optimizer_times = []
        result.optimizer_results = []

        for step in range(k):
            ansatz = ansatze[step]
            compiled = compile_circuit(ansatz)
            e_fn, _ = make_evaluators(ansatz, operator, self.device)
            vag = _deflated_cost_vag(compiled, operator, prev_states,
                                     betas[: len(prev_states)], self.device)
            value, jac, evals = cached_objective(vag)

            def fun(theta, value=value, evals=evals, step=step):
                v = value(theta)
                if self.callback is not None:
                    self.callback(evals["n"], np.asarray(theta), v, {},
                                  step + 1)
                return v

            t0 = time.perf_counter()
            opt = optimizers[step]
            x0 = np.asarray(initial_points[step], dtype=np.float64)
            if callable(opt) and not isinstance(opt, Optimizer):
                opt_result = opt(fun=fun, x0=x0, jac=jac, bounds=None)
            else:
                opt_result = opt.minimize(fun, x0, jac=jac)
            t1 = time.perf_counter()

            energy = e_fn(opt_result.x)   # deflation-free eigenvalue estimate
            eigenvalues.append(energy)
            with torch.no_grad():
                state = compiled.state(opt_result.x, self.device)
            prev_states.append(state)

            if aux_operators:  # empty list/dict -> None (reference semantics)
                if result.aux_operators_evaluated is None:
                    result.aux_operators_evaluated = []
                result.aux_operators_evaluated.append(
                    _eval_aux_ops(state, aux_operators))

            result.optimal_points.append(np.asarray(opt_result.x))
            result.optimal_parameters.append(np.asarray(opt_result.x))
            result.optimal_values.append(float(opt_result.fun))
            result.optimal_circuits.append(ansatz)
            result.cost_function_evals.append(evals["n"])
            result.optimizer_times.append(t1 - t0)
            result.optimizer_results.append(opt_result)

        result.eigenvalues = np.asarray(eigenvalues)
        return result
