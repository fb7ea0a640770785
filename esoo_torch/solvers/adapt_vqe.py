"""ADAPT-VQE: adaptive derivative-assembled ansatz growth.

Port of esoo_tpu/solvers/adapt_vqe.py.  The reference imports AdaptVQE
from qiskit_algorithms (the only eigensolver it does not implement
itself; used by OptOrbAdaptVQE, opt_orb_adapt_vqe.py).

Two paths, as in the JAX package.  The static-shape path evaluates one
padded circuit of R slots x the whole pool (unselected angles pinned to
zero), where the gradient at the next slot scores the whole pool in one
backward pass.  The growing path appends one pool group per step and
scores the pool directly from the statevector with the commutator
identity (`_make_pool_screener`, all groups in one batched product on the
solver's device).
"""

from __future__ import annotations

import enum
from typing import List, Optional

import numpy as np
import torch
from scipy.optimize import minimize as scipy_minimize

from ..ops.pauli import SparsePauliOp
from ..sim.circuit import QuantumCircuit
from ..sim.statevector import compile_circuit
from ..utils.config import resolve_device, same_device
from .energy import make_evaluators, pauli_tables
from .vqe import (VQE, AlgorithmError, VQEResult, _eval_aux_ops,
                  cached_objective)


class TerminationCriterion(enum.Enum):
    CONVERGED = "converged"
    CYCLICITY = "aborted due to a cyclic selection of evolution operators"
    MAXIMUM = "maximum number of iterations reached"


class AdaptVQEResult(VQEResult):
    def __init__(self):
        super().__init__()
        self.num_iterations: int = 0
        self.final_maximum_gradient: float = 0.0
        self.termination_criterion: Optional[TerminationCriterion] = None
        self.eigenvalue_history: List[float] = []


def _append_group(circuit: QuantumCircuit, group) -> QuantumCircuit:
    """Append one excitation rotation group with a fresh parameter."""
    theta = circuit.parameter()
    for x, z, w in group:
        circuit.pauli_rot(theta * (-2.0 * w), x, z)
    return circuit


def _make_pool_screener(pool, operator: SparsePauliOp, num_qubits: int,
                        device):
    """state -> pool gradients via the commutator identity.

    Our rotations are exp(-i theta/2 * (-2w) P) = exp(i theta w P); with
    G_k = i sum_j w_j P_j (anti-Hermitian, the JW image of T_k - T_k^+),
    dE/dtheta_k at 0 is <psi|[H, G_k]|psi> = 2 Re <H psi|G_k|psi>.
    Pool Pauli terms are padded to a fixed (P, T) block (zero weights in
    the padding), so one batched product scores every group.
    """
    dim = 1 << num_qubits
    h_perm, h_sign, h_w = pauli_tables(operator, dim, False, device)
    T = max(len(g) for g in pool)
    P = len(pool)
    gx = np.zeros((P, T), dtype=np.int64)
    gz = np.zeros((P, T), dtype=np.int64)
    gw = np.zeros((P, T))
    gy = np.zeros((P, T), dtype=np.int64)
    for k, group in enumerate(pool):
        for j, (x, z, w) in enumerate(group):
            gx[k, j], gz[k, j], gw[k, j] = x, z, w
            gy[k, j] = bin(x & z).count("1")
    gphase = (1j) ** (gy % 4) * 1j * gw          # i * w_j * (Y phases)
    g_op = SparsePauliOp((list(gx.ravel()), list(gz.ravel())),
                         np.ones(P * T), num_qubits=num_qubits)
    g_perm, g_sign, _ = pauli_tables(g_op, dim, False, device)
    g_perm = g_perm.reshape(P, T, dim)
    g_sign = g_sign.reshape(P, T, dim)
    g_ph = torch.as_tensor(gphase, device=device)

    def screen(state: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            s = state.to(torch.complex128)
            phi = torch.sum(h_w[:, None] * h_sign * s[h_perm], dim=0)
            gpsi = torch.sum(g_ph[..., None] * g_sign * s[g_perm], dim=1)
            return (2.0 * torch.real(torch.conj(phi) @ gpsi.T)).cpu().numpy()

    return screen


# the static-shape path's limit on R * P padded blocks: past it the padded
# circuit costs more per evaluation than growing one group at a time (the
# JAX package's CPU limit; eager PyTorch has no recompile to amortize, on
# either device, so one limit for both keeps card and CPU on one path)
_STATIC_BLOCKS = 256


class AdaptVQE:
    """Iteratively grows a UCC-style ansatz from an operator pool.

    Args:
        solver: a VQE whose `ansatz` was built by sim.ansatz.UCC/UCCSD —
            the excitation pool and initial state are taken from it.
        gradient_threshold: stop when max |pool gradient| falls below this.
        eigenvalue_threshold: stop when the energy improvement of the last
            growth step falls below this.
        max_iterations: cap on growth steps (None = pool size).
        static_shapes: evaluate through one padded circuit while R * P is
            at most _STATIC_BLOCKS (else grow one group at a time).
        device: the VQE's device by default ("cuda" unless the VQE was
            built for "cpu").
    """

    def __init__(self, solver: VQE, *,
                 gradient_threshold: float = 1e-5,
                 eigenvalue_threshold: float = 1e-5,
                 max_iterations: Optional[int] = None,
                 static_shapes: bool = True,
                 device=None):
        # the wrapped VQE's device unless one is given; the two must agree
        self.device = resolve_device(solver.device if device is None
                                     else device)
        if not same_device(self.device, solver.device):
            raise ValueError(
                f"AdaptVQE runs on {self.device} but its VQE runs on "
                f"{solver.device}; build both with the same device=")
        self.solver = solver
        self.gradient_threshold = gradient_threshold
        self.eigenvalue_threshold = eigenvalue_threshold
        self.max_iterations = max_iterations
        self.static_shapes = static_shapes

    def compute_minimum_eigenvalue(self, operator: SparsePauliOp,
                                   aux_operators=None) -> AdaptVQEResult:
        if self.static_shapes:
            pool = getattr(self.solver.ansatz, "_ucc_pool", None)
            if pool is not None:
                P = len(pool)
                R = self.max_iterations or P
                if R * P <= _STATIC_BLOCKS:
                    return self._compute_static(operator, aux_operators)
        return self._compute_growing(operator, aux_operators)

    # -- static-shape path -------------------------------------------------
    def _compute_static(self, operator: SparsePauliOp,
                        aux_operators=None) -> AdaptVQEResult:
        """ADAPT through one fixed circuit of R pool blocks, growth =
        unmasking one parameter per block."""
        template = self.solver.ansatz
        pool = getattr(template, "_ucc_pool", None)
        if pool is None:
            raise AlgorithmError(
                "AdaptVQE requires an ansatz built by sim.ansatz.UCC/UCCSD "
                "(carrying its excitation pool)")
        initial = getattr(template, "_ucc_initial_state", None)
        nq = operator.num_qubits
        P = len(pool)
        R = self.max_iterations or P

        padded = initial.copy() if initial is not None else QuantumCircuit(nq)
        if padded.num_parameters:
            raise AlgorithmError("AdaptVQE initial state must be parameter-free")
        for _ in range(R):
            for group in pool:
                _append_group(padded, group)
        # the padded circuit is itself UCC-family (pool groups repeated R
        # times): carry the excitation metadata so make_evaluators can
        # dispatch it through the particle-number sector
        excs = getattr(template, "_ucc_excitations", None)
        if excs is not None and len(excs) == P:
            padded._ucc_excitations = list(excs) * R
            padded._ucc_initial_state = initial
        efn, vag = make_evaluators(padded, operator, self.device)

        theta_full = np.zeros(R * P)
        selected: List[int] = []
        history: List[float] = []
        criterion = TerminationCriterion.MAXIMUM
        max_grad_val = 0.0
        prev_energy = None
        n_evals = 0

        for it in range(1, R + 1):
            # pool screening: gradient of slot `it-1` (angles all zero there)
            _, grad = vag(theta_full)
            n_evals += 1
            slot = (it - 1) * P
            pool_grads = np.abs(np.asarray(grad)[slot: slot + P])
            best = int(np.argmax(pool_grads))
            max_grad_val = float(pool_grads[best])
            if max_grad_val < self.gradient_threshold:
                criterion = TerminationCriterion.CONVERGED
                break
            if selected and selected[-1] == best:
                # first immediate repeat terminates (upstream AdaptVQE's
                # consecutive-repeat semantics)
                criterion = TerminationCriterion.CYCLICITY
                break
            selected.append(best)
            active = np.array([r * P + s for r, s in enumerate(selected)])

            # optimize the active angles through the fixed circuit
            def vag_active(alpha, active=active):
                th = theta_full.copy()
                th[active] = alpha
                v, g = vag(th)
                return v, np.asarray(g)[active]

            fun, jac, _ = cached_objective(vag_active)

            x0 = theta_full[active]
            res = scipy_minimize(fun, x0, jac=jac, method="L-BFGS-B")
            n_evals += int(res.nfev)
            theta_full[active] = res.x
            history.append(float(res.fun))
            if prev_energy is not None and \
                    abs(history[-1] - prev_energy) < self.eigenvalue_threshold:
                criterion = TerminationCriterion.CONVERGED
                break
            prev_energy = history[-1]

        result = AdaptVQEResult()
        if history:
            result.eigenvalue = history[-1]
        else:
            result.eigenvalue = float(efn(theta_full))
        # emit the equivalent compact grown circuit + its parameters
        compact = initial.copy() if initial is not None else QuantumCircuit(nq)
        for s in selected:
            _append_group(compact, pool[s])
        alpha = theta_full[[r * P + s for r, s in enumerate(selected)]] \
            if selected else np.zeros(0)
        result.optimal_point = alpha
        result.optimal_parameters = alpha
        result.optimal_value = result.eigenvalue
        result.optimal_circuit = compact
        result.cost_function_evals = n_evals
        result.num_iterations = len(history) if history else 1
        result.final_maximum_gradient = max_grad_val
        result.termination_criterion = criterion
        result.eigenvalue_history = history
        if aux_operators:  # empty list/dict -> None (reference semantics)
            state = compile_circuit(compact).state(alpha, self.device)
            result.aux_operators_evaluated = _eval_aux_ops(state,
                                                           aux_operators)
        return result

    # -- growing path (cross-check) ------------------------------------------
    def _compute_growing(self, operator: SparsePauliOp,
                         aux_operators=None) -> AdaptVQEResult:
        template = self.solver.ansatz
        pool = getattr(template, "_ucc_pool", None)
        if pool is None:
            raise AlgorithmError(
                "AdaptVQE requires an ansatz built by sim.ansatz.UCC/UCCSD "
                "(carrying its excitation pool)")
        initial = getattr(template, "_ucc_initial_state", None)
        nq = operator.num_qubits

        base = initial.copy() if initial is not None else QuantumCircuit(nq)
        if base.num_parameters:
            raise AlgorithmError("AdaptVQE initial state must be parameter-free")

        max_iter = self.max_iterations or len(pool)
        theta: List[float] = []
        selected: List[int] = []
        history: List[float] = []
        result = AdaptVQEResult()
        criterion = TerminationCriterion.MAXIMUM
        max_grad_val = 0.0
        prev_energy = None
        current = base.copy()
        last_vqe: Optional[VQEResult] = None

        if not pool:
            efn, _ = make_evaluators(base if base.gates else current,
                                     operator, self.device)
            result.eigenvalue = float(efn(np.zeros(0)))
            result.optimal_point = np.zeros(0)
            result.optimal_parameters = np.zeros(0)
            result.optimal_value = result.eigenvalue
            result.optimal_circuit = current
            result.num_iterations = 0
            result.termination_criterion = TerminationCriterion.CONVERGED
            return result

        screen = _make_pool_screener(pool, operator, nq, self.device)

        for it in range(1, max_iter + 1):
            # --- pool screening: dE/dtheta_k at theta_k=0 equals
            # <psi|[H, G_k]|psi> = 2 Re<H psi|G_k psi>, computed directly
            # from the current statevector (no probe circuit)
            state = compile_circuit(current).state(np.asarray(theta),
                                                   self.device)
            pool_grads = np.abs(screen(state))
            best = int(np.argmax(pool_grads))
            max_grad_val = float(pool_grads[best])
            if max_grad_val < self.gradient_threshold:
                criterion = TerminationCriterion.CONVERGED
                break
            if len(selected) >= 2 and selected[-1] == best and selected[-2] == best:
                criterion = TerminationCriterion.CYCLICITY
                break

            # --- grow and re-optimize ---------------------------------------
            selected.append(best)
            current = _append_group(current, pool[best])
            vqe = VQE(estimator=self.solver.estimator, ansatz=current,
                      optimizer=self.solver.optimizer,
                      initial_point=np.concatenate([np.asarray(theta), [0.0]]),
                      callback=self.solver.callback, device=self.device)
            last_vqe = vqe.compute_minimum_eigenvalue(operator)
            theta = list(np.asarray(last_vqe.optimal_point))
            history.append(float(last_vqe.eigenvalue))
            if prev_energy is not None and \
                    abs(history[-1] - prev_energy) < self.eigenvalue_threshold:
                criterion = TerminationCriterion.CONVERGED
                break
            prev_energy = history[-1]

        if last_vqe is None:
            # pool converged immediately: evaluate the bare reference state
            efn, _ = make_evaluators(
                current if current.gates else base, operator, self.device)
            result.eigenvalue = float(efn(np.zeros(0)))
            result.optimal_point = np.zeros(0)
            result.optimal_parameters = np.zeros(0)
            result.optimal_value = result.eigenvalue
            result.optimal_circuit = current
        else:
            result.eigenvalue = last_vqe.eigenvalue
            result.optimal_point = last_vqe.optimal_point
            result.optimal_parameters = last_vqe.optimal_parameters
            result.optimal_value = last_vqe.optimal_value
            result.optimal_circuit = current
            result.cost_function_evals = last_vqe.cost_function_evals
            result.optimizer_time = last_vqe.optimizer_time
        result.num_iterations = it
        result.final_maximum_gradient = max_grad_val
        result.termination_criterion = criterion
        result.eigenvalue_history = history
        return result
