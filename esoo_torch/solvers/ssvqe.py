"""Subspace-Search VQE (SSVQE), arXiv:1810.09434.

Port of esoo_tpu/solvers/ssvqe.py (the reference's ssvqe.py, class SSVQE
:48-576): k mutually orthogonal initial states share one ansatz; the
optimizer minimizes the weighted energy sum
sum_i w_i <psi_i(theta)|H|psi_i(theta)>.

The k initial states are stacked once as a (k, 2^n) tensor on the
solver's device and the shared ansatz is applied to the whole stack (the
statevector simulator takes leading batch axes), so one optimizer iterate
is one forward and one backward pass for all k states: the energies for
the callback and the weighted sum's gradient come out of the same
evaluation.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.pauli import SparsePauliOp
from ..sim.circuit import QuantumCircuit
from ..sim.estimator import Estimator
from ..sim.rdm import rdm_energy
from ..sim.statevector import compile_circuit
from ..utils.config import real_dtype, resolve_device
from .energy import operator_tensors, pauli_expectation, pauli_tables
from .optimizers import Optimizer, OptimizerResult
from .vqe import AlgorithmError, _check_device, _eval_aux_ops


class SSVQEResult:
    def __init__(self):
        self.eigenvalues: Optional[np.ndarray] = None
        self.optimal_point: Optional[np.ndarray] = None
        self.optimal_parameters: Optional[np.ndarray] = None
        self.optimal_value: Optional[float] = None
        self.optimal_circuits: Optional[List[QuantumCircuit]] = None
        self.cost_function_evals: int = 0
        self.optimizer_time: float = 0.0
        self.optimizer_result: Optional[OptimizerResult] = None
        self.aux_operators_evaluated = None


def _init_stack(vecs: List[torch.Tensor], compiled) -> torch.Tensor:
    """(k, 2^n) initial states: real when the circuit and every state
    allow it, else complex128."""
    stack = torch.stack(vecs)
    if stack.is_complex():
        if compiled.is_real and bool((stack.imag == 0).all()):
            return stack.real.to(real_dtype())
        return stack.to(torch.complex128)
    if not compiled.is_real:
        return stack.to(torch.complex128)
    return stack.to(real_dtype())


def state_energy_fn(operator: SparsePauliOp, num_qubits: int, real: bool,
                    device) -> Callable:
    """states (..., 2^n) -> energies (...,): the RDM contraction for a
    chemistry operator, else the Pauli sum."""
    if getattr(operator, "fermionic", None) is not None:
        h, g = operator_tensors(operator, real_dtype(), device)
        return lambda s: rdm_energy(s, h, g)
    tables = pauli_tables(operator, 1 << num_qubits, real, device)
    return lambda s: pauli_expectation(s, tables)


def _batched_evaluators(ansatz, init_states, operator, weights, device):
    """(energies, energies_and_grad, energies_batch, variances) for the k
    states through the shared ansatz on `device`.

    energies(theta) -> (k,) ndarray; energies_and_grad(theta) -> ((k,)
    energies, gradient of the weighted sum) from one forward and backward
    pass; energies_batch((B, P) thetas) -> (B, k) (the reference's
    `max_evals_grouped` batch, ssvqe.py:352-365); variances(theta) -> the
    per-state Var[H] = <H^2> - <H>^2 of the shot-noise metadata."""
    compiled = compile_circuit(ansatz)
    init = _init_stack([compile_circuit(st).state(device=device)
                        for st in init_states], compiled)
    apply = compiled.apply_fn
    w = torch.as_tensor(np.asarray(weights, dtype=np.float64),
                        device=device).to(real_dtype())
    energy_of = state_energy_fn(operator, ansatz.num_qubits,
                                not init.is_complex(), device)

    def theta_t(theta):
        return torch.as_tensor(np.asarray(theta, dtype=np.float64),
                               device=device).to(real_dtype())

    def energies_t(theta):
        return energy_of(apply(init, theta))

    def energies(theta):
        with torch.no_grad():
            return energies_t(theta_t(theta)).cpu().numpy()

    def energies_and_grad(theta):
        th = theta_t(theta).requires_grad_(True)
        with torch.enable_grad():
            es = energies_t(th)
            (g,) = torch.autograd.grad(w @ es, th)
        return es.detach().cpu().numpy(), g.cpu().numpy()

    def energies_batch(thetas):
        with torch.no_grad():
            return np.stack([energies_t(theta_t(t)).cpu().numpy()
                             for t in np.asarray(thetas)])

    h2_tables = []      # lazy (operator @ operator).simplify(): the
    # O(T^2) symbolic Pauli product is paid at most once per
    # compute_eigenvalues, not per callback invocation

    def variances(theta):
        if not h2_tables:
            h2_tables.append(pauli_tables((operator @ operator).simplify(),
                                          1 << ansatz.num_qubits, False,
                                          device))
        with torch.no_grad():
            th = theta_t(theta)
            s = apply(init, th).to(torch.complex128)
            e2 = pauli_expectation(s, h2_tables[0])
            return (e2 - energies_t(th) ** 2).cpu().numpy()

    return energies, energies_and_grad, energies_batch, variances


class SSVQE:
    """Weighted-subspace eigensolver over k orthogonal initial states on
    `device` ("cuda" by default)."""

    def __init__(self,
                 estimator: Optional[Estimator] = None,
                 k: Optional[int] = 2,
                 ansatz: Optional[QuantumCircuit] = None,
                 optimizer: Optional[Union[Optimizer, Callable]] = None,
                 initial_point: Optional[Sequence[float]] = None,
                 initial_states: Optional[List[QuantumCircuit]] = None,
                 weight_vector: Optional[Sequence[float]] = None,
                 gradient=None,
                 callback: Optional[Callable] = None,
                 check_input_states_orthogonality: bool = True,
                 max_evals_grouped: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        _check_device(type(self).__name__, self.device, optimizer,
                      estimator=estimator)
        self.estimator = estimator
        self.k = k
        self.ansatz = ansatz
        self.optimizer = optimizer
        self.initial_point = initial_point
        self.initial_states = initial_states
        self.weight_vector = weight_vector
        self.gradient = gradient
        self.callback = callback
        self.check_initial_states_orthogonal = check_input_states_orthogonality
        # grouped evaluation (reference ssvqe.py:352-365): the objective
        # accepts flat concatenations of several parameter sets; this
        # records the group size for optimizers that consult it
        self.max_evals_grouped = max_evals_grouped

    # -- setup helpers ---------------------------------------------------
    def _resolved_weights(self) -> np.ndarray:
        if self.weight_vector is not None:
            w = np.asarray(self.weight_vector, dtype=np.float64)
            if w.shape[0] != self.k:
                raise AlgorithmError(
                    f"weight_vector has {w.shape[0]} entries, expected "
                    f"k={self.k}")
            if np.any(w <= 0):
                raise AlgorithmError("weight_vector entries must be positive")
            return w
        return np.arange(self.k, 0, -1, dtype=np.float64)

    def _resolved_initial_states(self, num_qubits: int
                                 ) -> List[QuantumCircuit]:
        if self.initial_states is None:
            states = []
            for i in range(self.k):
                qc = QuantumCircuit(num_qubits)
                for q in range(num_qubits):
                    if (i >> q) & 1:
                        qc.x(q)
                states.append(qc)
            return states
        states = list(self.initial_states)
        if len(states) != self.k:
            raise AlgorithmError(
                f"{len(states)} initial states provided, expected k={self.k}")
        for st in states:
            if st.num_qubits != num_qubits:
                raise AlgorithmError(
                    "initial state qubit count does not match the operator")
        if self.check_initial_states_orthogonal:
            vecs = [compile_circuit(s).state(device=self.device)
                    .to(torch.complex128) for s in states]
            for i in range(len(vecs)):
                for j in range(i + 1, len(vecs)):
                    if float(torch.abs(torch.vdot(vecs[i], vecs[j]))) > 1e-8:
                        raise AlgorithmError(
                            f"initial states {i} and {j} are not orthogonal")
        return states

    def _validate_bounds(self, ansatz):
        """Optimizer bounds from the ansatz (reference ssvqe.py:596-640):
        None when the ansatz defines none; otherwise one (low, high) pair
        per parameter."""
        pb = getattr(ansatz, "parameter_bounds", None)
        if pb is None:
            return None
        if len(pb) != ansatz.num_parameters:
            raise AlgorithmError(
                f"ansatz.parameter_bounds has {len(pb)} entries, expected "
                f"{ansatz.num_parameters}")
        return [(None, None) if b is None else tuple(b) for b in pb]

    # -- main ------------------------------------------------------------
    def compute_eigenvalues(self, operator: SparsePauliOp,
                            aux_operators=None) -> SSVQEResult:
        ansatz = self.ansatz
        if ansatz is None:
            raise AlgorithmError("SSVQE requires an ansatz")
        if ansatz.num_parameters == 0:
            raise AlgorithmError("ansatz has no free parameters")
        if ansatz.num_qubits != operator.num_qubits:
            raise AlgorithmError(
                f"ansatz qubits ({ansatz.num_qubits}) != operator qubits "
                f"({operator.num_qubits})")

        weights = self._resolved_weights()
        init_states = self._resolved_initial_states(ansatz.num_qubits)
        circuits = [st.compose(ansatz) for st in init_states]
        energies_fn, energies_and_grad, energies_batch_fn, variances_fn = \
            _batched_evaluators(ansatz, init_states, operator, weights,
                                self.device)

        x0 = self.initial_point
        if x0 is None:
            x0 = np.random.default_rng(0).uniform(
                -np.pi, np.pi, ansatz.num_parameters)
        x0 = np.asarray(x0, dtype=np.float64)
        nparams = ansatz.num_parameters
        if x0.shape[0] != nparams:
            raise AlgorithmError(
                f"initial point has {x0.shape[0]} entries, ansatz expects "
                f"{nparams}")
        bounds = self._validate_bounds(ansatz)

        evals = {"n": 0}
        last = {"x": None, "g": None}
        shots = getattr(self.estimator, "shots", None) \
            if self.estimator is not None else None

        def _metadata(theta):
            if shots is None:
                return {}
            var = np.maximum(np.asarray(variances_fn(theta)), 0.0)
            return {"shots": shots, "variance": var,
                    "std_dev": np.sqrt(var / shots)}

        def fun(theta):
            """Weighted energy sum; accepts one parameter set or the flat
            concatenation of several (reference `max_evals_grouped`
            semantics, ssvqe.py:352-365)."""
            theta = np.array(theta, dtype=np.float64)
            sets = theta.reshape(-1, nparams)
            if sets.shape[0] == 1:
                es, g = energies_and_grad(sets[0])
                last["x"], last["g"] = sets[0], g
                energies = es[None, :]
            else:
                energies = np.asarray(energies_batch_fn(sets))
            values = energies @ weights
            for pt, en in zip(sets, energies):
                evals["n"] += 1
                if self.callback is not None:
                    self.callback(evals["n"], pt, en, _metadata(pt))
            return float(values[0]) if values.shape[0] == 1 else values

        if self.gradient is not None:
            if not callable(self.gradient):
                raise AlgorithmError(
                    "gradient must be a callable theta -> d(weighted sum)/d "
                    "theta")

            def jac(theta):
                return np.asarray(self.gradient(np.asarray(theta)))
        else:
            def jac(theta):
                theta = np.asarray(theta, dtype=np.float64)
                if last["x"] is not None and np.array_equal(last["x"],
                                                            theta):
                    return last["g"].copy()
                return energies_and_grad(theta)[1]

        t0 = time.perf_counter()
        if callable(self.optimizer) and not isinstance(self.optimizer,
                                                       Optimizer):
            opt_result = self.optimizer(fun=fun, x0=x0, jac=jac,
                                        bounds=bounds)
        else:
            opt_result = self.optimizer.minimize(fun, x0, jac=jac,
                                                 bounds=bounds)
        t1 = time.perf_counter()

        final_energies = np.asarray(energies_fn(opt_result.x))

        result = SSVQEResult()
        result.eigenvalues = final_energies
        result.optimal_point = np.asarray(opt_result.x)
        result.optimal_parameters = np.asarray(opt_result.x)
        result.optimal_value = float(opt_result.fun)
        result.optimal_circuits = circuits
        result.cost_function_evals = evals["n"]
        result.optimizer_time = t1 - t0
        result.optimizer_result = opt_result
        if aux_operators:  # empty list/dict -> None (reference semantics)
            result.aux_operators_evaluated = [
                _eval_aux_ops(compile_circuit(c).state(opt_result.x,
                                                       self.device),
                              aux_operators)
                for c in circuits
            ]
        return result
