"""Excited-state OptOrb outer loop.

Port of esoo_tpu/orbital_optimization/eigensolver.py (the reference's
OptOrbEigensolver, opt_orb_eigensolver.py:18-298): k states per
eigensolver run, per-state RDMs, and the weighted-sum objective
sum_i w_i E_i(U) for the orbital subproblem; convergence is tracked on
the weighted sum (ref :202).  The weighted objective is linear in the
RDMs, so the inner optimizer sees one weight-combined RDM pair on the
device instead of k energy evaluations per iterate (ref :149-169).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Callable, List, Optional, Union

import numpy as np

from ..sim.statevector import compile_circuit
from ..solvers.vqe import AlgorithmError
from .base import BaseOptOrbResult, BaseOptOrbSolver, _numpy
from .checkpoint import load_checkpoint, save_checkpoint


class OptOrbEigensolverResult(BaseOptOrbResult):
    """ref opt_orb_eigensolver.py:271-296."""

    def __init__(self) -> None:
        super().__init__()
        self.eigenvalues: Optional[np.ndarray] = None
        self.optimal_point: Optional[np.ndarray] = None
        self.optimal_points: Optional[List[np.ndarray]] = None
        self.optimal_parameters = None
        self.optimal_circuits = None


class OptOrbEigensolver(BaseOptOrbSolver):
    def __init__(self, num_spin_orbitals: int, excited_states_solver=None,
                 mapper=None, estimator=None, partial_unitary_optimizer=None,
                 problem=None, integral_tensors=None,
                 initial_partial_unitary=None, maxiter: int = 10,
                 stopping_tolerance: float = 1e-5,
                 spin_conserving: bool = False,
                 wavefuntion_real: bool = False,
                 outer_loop_callback: Optional[Callable] = None,
                 partial_unitary_random_perturbation: Optional[float] = None,
                 RDM_ops_batchsize: Optional[int] = 100,
                 weight_vector: Optional[Union[list, np.ndarray]] = None,
                 rdm_measurement: str = "direct",
                 checkpoint_dir: Optional[str] = None,
                 resume_from: Optional[str] = None,
                 seed: Optional[int] = None,
                 mesh=None,
                 device="cuda"):
        super().__init__(num_spin_orbitals=num_spin_orbitals, mapper=mapper,
                         estimator=estimator,
                         partial_unitary_optimizer=partial_unitary_optimizer,
                         problem=problem, integral_tensors=integral_tensors,
                         initial_partial_unitary=initial_partial_unitary,
                         maxiter=maxiter,
                         stopping_tolerance=stopping_tolerance,
                         spin_conserving=spin_conserving,
                         wavefuntion_real=wavefuntion_real,
                         outer_loop_callback=outer_loop_callback,
                         partial_unitary_random_perturbation=partial_unitary_random_perturbation,
                         RDM_ops_batchsize=RDM_ops_batchsize,
                         rdm_measurement=rdm_measurement,
                         checkpoint_dir=checkpoint_dir, seed=seed,
                         mesh=mesh, device=device)
        if excited_states_solver is None:
            raise ValueError("excited_states_solver is required")
        self._check_solver_device(excited_states_solver)
        self._excited_states_solver_list = [
            copy.deepcopy(excited_states_solver)
            for _ in range(int(maxiter) + 1)
        ]
        self.num_states = excited_states_solver.k
        if weight_vector is not None:
            wv = weight_vector
        elif getattr(excited_states_solver, "weight_vector", None) is not None:
            wv = excited_states_solver.weight_vector
        else:
            wv = [self.num_states - n for n in range(self.num_states)]
        self.weight_vector = self._check_weight_vector(wv)
        self._resume_iteration = 0
        if resume_from is not None:
            ck = load_checkpoint(resume_from)
            self._current_partial_unitary = self._to_device(
                ck["partial_unitary"]).to(self._current_partial_unitary.dtype)
            self._energy_convergence_list = ck["energy_convergence_list"]
            self._resume_iteration = ck["iteration"] + 1
            if "optimal_points" in ck:
                for s in self._excited_states_solver_list:
                    s.initial_point = [np.asarray(p)
                                       for p in ck["optimal_points"]]
            elif "optimal_point" in ck:
                for s in self._excited_states_solver_list:
                    s.initial_point = ck["optimal_point"]
            rng_state = (ck.get("extra") or {}).get("rng_state")
            if rng_state is not None:
                # resume replays the same perturbation noise stream
                self._rng.bit_generator.state = rng_state

    def _check_weight_vector(self, weight_vector) -> np.ndarray:
        """ref opt_orb_eigensolver.py:99-108."""
        if weight_vector is None:
            weight_vector = [self.num_states - n
                             for n in range(self.num_states)]
        if len(weight_vector) != self.num_states:
            raise AlgorithmError(
                "The number of weights provided does not match the number "
                "of states.")
        return np.asarray(weight_vector, dtype=np.float64)

    @property
    def excited_states_solver_list(self):
        return self._excited_states_solver_list

    def parameter_update_rule(self, result, iteration: int):
        raise NotImplementedError(
            "subclasses define the eigensolver warm-start rule")

    def compute_rotated_weighted_energy_sum(self, partial_unitary, oneRDM,
                                            twoRDM, one_body_integrals,
                                            two_body_integrals):
        """sum_i w_i E(U; RDM_i): the reference's signature
        (opt_orb_eigensolver.py:149-169), differentiable in U."""
        total = 0.0
        for w, g1, g2 in zip(self.weight_vector, oneRDM, twoRDM):
            total = total + w * self.compute_rotated_energy(
                partial_unitary, g1, g2, one_body_integrals,
                two_body_integrals)
        return total

    def _state_vectors_from_result(self, result) -> list:
        """Reconstruct the k optimal states as statevectors on the
        device."""
        circs = result.optimal_circuits
        if circs is None:
            raise AlgorithmError("eigensolver result lacks optimal_circuits")
        points = getattr(result, "optimal_points", None)
        if points is None:
            points = [result.optimal_point] * len(circs)
        out = []
        for circ, pt in zip(circs, points):
            compiled = compile_circuit(circ)
            if pt is None:
                pt = np.zeros(compiled.num_parameters)
            out.append(compiled.state(np.asarray(pt), self.device))
        return out

    def _bound_circuits_from_result(self, result):
        """(circuit, params) pairs for the k optimal states, or None when
        the result lacks per-state circuits (falls back to statevectors)."""
        circs = getattr(result, "optimal_circuits", None)
        if circs is None:
            return None
        points = getattr(result, "optimal_points", None)
        if points is None:
            points = [result.optimal_point] * len(circs)
        return list(zip(circs, points))

    def compute_energies(self) -> OptOrbEigensolverResult:
        """ref opt_orb_eigensolver.py:171-269."""
        iteration = self._resume_iteration
        optorb_result = OptOrbEigensolverResult()
        optorb_result.energy_convergence_list = self._energy_convergence_list
        optorb_result.metrics = {
            "eigensolver_time": [], "rdm_time": [],
            "rotation_time": [], "hamiltonian_time": [],
        }
        t0 = time.perf_counter()
        self._hamiltonian = self.get_rotated_hamiltonian(
            self._current_partial_unitary)
        optorb_result.metrics["hamiltonian_time"].append(
            time.perf_counter() - t0)
        if self.rdm_measurement == "pauli":
            self.construct_pauli_op_dict(self.mapper)

        while not self.stopping_condition(iteration):
            solver = self._excited_states_solver_list[iteration]
            t0 = time.perf_counter()
            result = solver.compute_eigenvalues(operator=self._hamiltonian)
            optorb_result.metrics["eigensolver_time"].append(
                time.perf_counter() - t0)
            energies = np.real(np.asarray(result.eigenvalues))

            optorb_result.eigenvalues = energies
            optorb_result.optimal_point = getattr(result, "optimal_point", None)
            optorb_result.optimal_points = getattr(result, "optimal_points",
                                                   None)
            optorb_result.optimal_parameters = getattr(
                result, "optimal_parameters", None)
            optorb_result.optimal_circuits = result.optimal_circuits
            optorb_result.optimal_partial_unitary = _numpy(
                self._current_partial_unitary)
            optorb_result.num_vqe_evaluations += 1

            if self.outer_loop_callback is not None:
                self.outer_loop_callback(iteration, result, optorb_result)
            self._energy_convergence_list.append(
                float(np.dot(self.weight_vector, energies)))

            if self.checkpoint_dir is not None:
                pts = getattr(result, "optimal_points", None)
                save_checkpoint(
                    os.path.join(self.checkpoint_dir,
                                 f"optorb_iter_{iteration:04d}.npz"),
                    iteration=iteration,
                    partial_unitary=_numpy(self._current_partial_unitary),
                    energy_convergence_list=self._energy_convergence_list,
                    optimal_point=getattr(result, "optimal_point", None),
                    optimal_points=pts,
                    extra={"rng_state": self._rng.bit_generator.state})

            if self.stopping_condition(iteration):
                break

            # --- per-state RDMs --------------------------------------------
            t0 = time.perf_counter()
            if self.rdm_measurement == "pauli":
                points = getattr(result, "optimal_points", None)
                if points is None:
                    points = [result.optimal_point] * self.num_states
                gammas, Gammas = self._rdms_via_pauli(
                    list(zip(result.optimal_circuits, points)))
            else:
                pairs = self._bound_circuits_from_result(result)
                if pairs is not None:
                    gammas, Gammas = self._rdms_for_bound_circuits(pairs)
                else:
                    svs = self._state_vectors_from_result(result)
                    gammas, Gammas = self._rdms_for_states(svs)
            optorb_result.metrics["rdm_time"].append(time.perf_counter() - t0)

            # --- orbital rotation (weight-combined RDMs) -------------------
            U0 = self._maybe_perturb_unitary(self._current_partial_unitary)
            t0 = time.perf_counter()
            pupo = self._partial_unitary_optimizer_list[iteration]
            U_opt, _ = self._run_inner_optimization(
                pupo, U0, gammas, Gammas, weights=self.weight_vector)
            optorb_result.metrics["rotation_time"].append(
                time.perf_counter() - t0)
            if pupo.last_result is not None:
                optorb_result.orbital_rotation_iterations.append(
                    pupo.last_result.iterations)
            self._current_partial_unitary = U_opt

            t0 = time.perf_counter()
            self._hamiltonian = self.get_rotated_hamiltonian(U_opt)
            optorb_result.metrics["hamiltonian_time"].append(
                time.perf_counter() - t0)
            iteration += 1
            self.parameter_update_rule(result, iteration)

        return optorb_result
