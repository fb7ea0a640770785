"""Variational Quantum Eigensolver.

Port of esoo_tpu/solvers/vqe.py, the native replacement for
qiskit_algorithms.minimum_eigensolvers.VQE (the one eigensolver the
reference imports rather than implements; tests/test_optorbvqe.py:81).
The cost function is theta -> E(theta) on the solver's device with
autograd gradients (solvers/energy.py); a host optimizer reads one
value-and-gradient evaluation per iterate (the value is kept for the
gradient call at the same point, so each iterate is one device
evaluation).  `DeviceLBFGS` runs the whole minimization on the device.

Every solver takes `device` ("cuda" by default; "cpu" runs on the host)
and raises when its estimator or optimizer was built for another device.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.pauli import SparsePauliOp
from ..sim.circuit import QuantumCircuit
from ..sim.estimator import Estimator
from ..sim.statevector import compile_circuit
from ..utils.config import check_same_device, real_dtype, resolve_device
from .energy import (fermionic_evaluators, make_evaluators, operator_tensors,
                     pauli_evaluators, pauli_expectation, pauli_tables)
from .optimizers import Optimizer, OptimizerResult


class AlgorithmError(Exception):
    pass


class VQEResult:
    def __init__(self):
        self.eigenvalue: Optional[float] = None
        self.optimal_point: Optional[np.ndarray] = None
        self.optimal_parameters: Optional[np.ndarray] = None
        self.optimal_value: Optional[float] = None
        self.optimal_circuit: Optional[QuantumCircuit] = None
        self.cost_function_evals: int = 0
        self.optimizer_time: float = 0.0
        self.optimizer_result: Optional[OptimizerResult] = None
        self.aux_operators_evaluated = None


def cached_objective(vag: Callable) -> tuple:
    """(fun, jac, evaluations) over one value-and-gradient function: a
    host optimizer asks for fun(x) and then jac(x) at the same x, which
    the cache answers from one device evaluation."""
    last = {"x": None, "g": None, "n": 0}

    def evaluate(theta):
        theta = np.array(theta, dtype=np.float64)
        v, g = vag(theta)
        last["n"] += 1
        last["x"], last["v"], last["g"] = theta, v, g
        return v, g

    def fun(theta):
        return evaluate(theta)[0]

    def jac(theta):
        if last["x"] is not None and np.array_equal(
                last["x"], np.asarray(theta, dtype=np.float64)):
            return last["g"].copy()
        return evaluate(theta)[1]

    return fun, jac, last


def _check_device(owner, device, optimizer, **parts) -> None:
    """check_same_device over the solver's parts; `optimizer` may be a
    per-state list."""
    opts = optimizer if isinstance(optimizer, (list, tuple)) else [optimizer]
    check_same_device(owner, device, **parts,
                      **{f"optimizer[{i}]": o for i, o in enumerate(opts)})


class VQE:
    """Minimizes <psi(theta)|H|psi(theta)> over ansatz parameters on
    `device` ("cuda" by default)."""

    def __init__(self,
                 estimator: Optional[Estimator] = None,
                 ansatz: Optional[QuantumCircuit] = None,
                 optimizer: Optional[Optimizer] = None,
                 *,
                 gradient=None,
                 initial_point: Optional[Sequence[float]] = None,
                 callback: Optional[Callable] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        _check_device("VQE", self.device, optimizer, estimator=estimator)
        self.estimator = estimator
        self.ansatz = ansatz
        self.optimizer = optimizer
        self.gradient = gradient
        self.initial_point = initial_point
        self.callback = callback

    def compute_minimum_eigenvalue(self, operator: SparsePauliOp,
                                   aux_operators=None) -> VQEResult:
        ansatz = self.ansatz
        if ansatz is None:
            raise AlgorithmError("VQE requires an ansatz")
        if ansatz.num_parameters == 0:
            raise AlgorithmError("ansatz has no free parameters")
        if ansatz.num_qubits != operator.num_qubits:
            raise AlgorithmError(
                f"ansatz qubits ({ansatz.num_qubits}) != operator qubits "
                f"({operator.num_qubits})")

        x0 = self.initial_point
        if x0 is None:
            x0 = np.random.default_rng(0).uniform(
                -np.pi, np.pi, ansatz.num_parameters)
        x0 = np.asarray(x0, dtype=np.float64)

        t0 = time.perf_counter()
        if getattr(self.optimizer, "is_device_native", False):
            # the whole minimization on the device (per-iterate callbacks
            # are not observable on this path)
            compiled = compile_circuit(ansatz)
            if getattr(operator, "fermionic", None) is not None:
                e_fn, _ = fermionic_evaluators(compiled,
                                               ansatz.fingerprint(),
                                               real_dtype(), self.device)
                args = operator_tensors(operator, real_dtype(), self.device)
                opt_result = self.optimizer.minimize_on_device(e_fn, x0,
                                                               args=args)
            else:
                e_fn, _ = pauli_evaluators(compiled, operator, self.device)
                opt_result = self.optimizer.minimize_on_device(e_fn, x0)
            n_evals = opt_result.nfev
        else:
            _, vag_fn = make_evaluators(ansatz, operator, self.device)
            value, jac, evals = cached_objective(vag_fn)

            def fun(theta):
                v = value(theta)
                if self.callback is not None:
                    self.callback(evals["n"], np.asarray(theta), v, {})
                return v

            if callable(self.optimizer) and not isinstance(self.optimizer,
                                                           Optimizer):
                opt_result = self.optimizer(fun=fun, x0=x0, jac=jac,
                                            bounds=None)
            else:
                opt_result = self.optimizer.minimize(fun, x0, jac=jac)
            n_evals = evals["n"]
        t1 = time.perf_counter()

        result = VQEResult()
        result.eigenvalue = float(opt_result.fun)
        result.optimal_point = np.asarray(opt_result.x)
        result.optimal_parameters = np.asarray(opt_result.x)
        result.optimal_value = float(opt_result.fun)
        result.optimal_circuit = ansatz
        result.cost_function_evals = n_evals
        result.optimizer_time = t1 - t0
        result.optimizer_result = opt_result

        if aux_operators:  # empty list/dict -> None (reference semantics)
            state = compile_circuit(ansatz).state(opt_result.x, self.device)
            result.aux_operators_evaluated = _eval_aux_ops(state,
                                                           aux_operators)
        return result


def _eval_aux_ops(state: torch.Tensor, aux_operators):
    """Evaluate auxiliary operators (list or dict) on a statevector.

    Reference semantics (qiskit_algorithms estimate_observables): list
    entries that are None evaluate to (0.0, dict) in place; dict entries
    that are None are dropped; numeric zero operators evaluate to
    (0.0, dict)."""
    def ev(op):
        if op is None or (isinstance(op, (int, float)) and op == 0):
            return (0.0, {})
        tables = pauli_tables(op, state.shape[-1], False, state.device)
        val = pauli_expectation(state.to(torch.complex128), tables)
        return (float(val), {"variance": 0.0})

    with torch.no_grad():
        if isinstance(aux_operators, dict):
            return {k: ev(op) for k, op in aux_operators.items()
                    if op is not None}
        return [ev(op) for op in aux_operators]


class NumPyMinimumEigensolver:
    """Dense exact diagonalization (test oracle, parity with qiskit's)."""

    def compute_minimum_eigenvalue(self, operator: SparsePauliOp,
                                   aux_operators=None):
        H = operator.to_matrix()
        w, v = np.linalg.eigh(H)
        result = VQEResult()
        result.eigenvalue = float(w[0])
        result.optimal_value = float(w[0])
        return result


class NumPyEigensolverResult:
    def __init__(self):
        self.eigenvalues: Optional[np.ndarray] = None
        self.eigenstates: Optional[np.ndarray] = None


class NumPyEigensolver:
    """Dense exact k-eigenvalue solver (excited-state test oracle, parity
    with qiskit_algorithms.NumPyEigensolver).

    `filter_criterion(state, value, aux) -> bool` restricts the spectrum
    (e.g. to a particle-number sector).
    """

    def __init__(self, k: int = 2, filter_criterion=None):
        self.k = k
        self.filter_criterion = filter_criterion

    def compute_eigenvalues(self, operator: SparsePauliOp,
                            aux_operators=None) -> "NumPyEigensolverResult":
        H = operator.to_matrix()
        w, v = np.linalg.eigh(H)
        if self.filter_criterion is not None:
            keep = [i for i in range(len(w))
                    if self.filter_criterion(v[:, i], w[i], None)]
            w, v = w[keep], v[:, keep]
        result = NumPyEigensolverResult()
        result.eigenvalues = w[: self.k]
        result.eigenstates = v[:, : self.k].T
        return result
