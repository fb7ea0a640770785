"""Ground-state OptOrb outer loop.

Port of esoo_tpu/orbital_optimization/minimum_eigensolver.py (the
reference's OptOrbMinimumEigensolver, opt_orb_minimum_eigensolver.py:
17-253): alternate a quantum eigensolver subproblem with the
orbital-rotation subproblem until the outer energy converges.  The loop
skeleton mirrors ref :150-246; the RDMs and the orbital step run on the
solver's device (base.py).  Checkpoints are the JAX package's .npz
layout (the partial unitary, the warm-start point, the energy history and
the perturbation RNG's state), so a run resumes from either package's
file and replays the same noise stream.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Callable, Optional

import numpy as np

from ..sim.statevector import compile_circuit
from .base import BaseOptOrbResult, BaseOptOrbSolver, _numpy
from .checkpoint import load_checkpoint, save_checkpoint


class OptOrbMinimumEigensolverResult(BaseOptOrbResult):
    """ref opt_orb_minimum_eigensolver.py:248-252."""

    def __init__(self) -> None:
        super().__init__()
        self.eigenvalue: Optional[float] = None
        self.optimal_point: Optional[np.ndarray] = None
        self.optimal_parameters: Optional[np.ndarray] = None
        self.optimal_value: Optional[float] = None
        self.optimal_circuit = None


class OptOrbMinimumEigensolver(BaseOptOrbSolver):
    def __init__(self, num_spin_orbitals: int, ground_state_solver=None,
                 mapper=None, estimator=None, partial_unitary_optimizer=None,
                 problem=None, integral_tensors=None,
                 initial_partial_unitary=None, maxiter: int = 10,
                 stopping_tolerance: float = 1e-5,
                 spin_conserving: bool = False,
                 wavefuntion_real: bool = False,
                 outer_loop_callback: Optional[Callable] = None,
                 partial_unitary_random_perturbation: Optional[float] = None,
                 RDM_ops_batchsize: Optional[int] = 100,
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
        if ground_state_solver is None:
            raise ValueError("ground_state_solver is required")
        self._check_solver_device(ground_state_solver)
        self._ground_state_solver_list = [
            copy.deepcopy(ground_state_solver)
            for _ in range(int(maxiter) + 1)
        ]
        self._resume_iteration = 0
        if resume_from is not None:
            ck = load_checkpoint(resume_from)
            self._current_partial_unitary = self._to_device(
                ck["partial_unitary"]).to(self._current_partial_unitary.dtype)
            self._energy_convergence_list = ck["energy_convergence_list"]
            self._resume_iteration = ck["iteration"] + 1
            if "optimal_point" in ck:
                for s in self._ground_state_solver_list:
                    s.initial_point = ck["optimal_point"]
            rng_state = (ck.get("extra") or {}).get("rng_state")
            if rng_state is not None:
                # resume replays the same perturbation noise stream
                self._rng.bit_generator.state = rng_state

    @property
    def ground_state_solver_list(self):
        return self._ground_state_solver_list

    def parameter_update_rule(self, result, iteration: int):
        raise NotImplementedError(
            "subclasses define the eigensolver warm-start rule")

    def _state_vector_from_result(self, result):
        circ = result.optimal_circuit
        compiled = compile_circuit(circ)
        params = result.optimal_point
        if params is None:
            params = np.zeros(compiled.num_parameters)
        return compiled.state(np.asarray(params), self.device)

    def compute_minimum_energy(self) -> OptOrbMinimumEigensolverResult:
        """ref opt_orb_minimum_eigensolver.py:150-246."""
        iteration = self._resume_iteration
        optorb_result = OptOrbMinimumEigensolverResult()
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
            solver = self._ground_state_solver_list[iteration]
            t0 = time.perf_counter()
            result = solver.compute_minimum_eigenvalue(
                operator=self._hamiltonian)
            optorb_result.metrics["eigensolver_time"].append(
                time.perf_counter() - t0)
            energy = float(np.real(result.eigenvalue))

            optorb_result.eigenvalue = energy
            optorb_result.optimal_point = result.optimal_point
            optorb_result.optimal_parameters = result.optimal_parameters
            optorb_result.optimal_value = result.optimal_value
            optorb_result.optimal_circuit = result.optimal_circuit
            optorb_result.optimal_partial_unitary = _numpy(
                self._current_partial_unitary)
            optorb_result.num_vqe_evaluations += 1

            if self.outer_loop_callback is not None:
                self.outer_loop_callback(iteration, result, optorb_result)
            self._energy_convergence_list.append(energy)

            if self.checkpoint_dir is not None:
                save_checkpoint(
                    os.path.join(self.checkpoint_dir,
                                 f"optorb_iter_{iteration:04d}.npz"),
                    iteration=iteration,
                    partial_unitary=_numpy(self._current_partial_unitary),
                    energy_convergence_list=self._energy_convergence_list,
                    optimal_point=result.optimal_point,
                    extra={"rng_state": self._rng.bit_generator.state})

            if self.stopping_condition(iteration):
                break

            # --- RDM measurement -------------------------------------------
            t0 = time.perf_counter()
            if self.rdm_measurement == "pauli":
                gammas, Gammas = self._rdms_via_pauli(
                    [(result.optimal_circuit, result.optimal_point)])
            else:
                gammas, Gammas = self._rdms_for_bound_circuits(
                    [(result.optimal_circuit, result.optimal_point)])
            optorb_result.metrics["rdm_time"].append(time.perf_counter() - t0)

            # --- orbital rotation ------------------------------------------
            U0 = self._maybe_perturb_unitary(self._current_partial_unitary)
            t0 = time.perf_counter()
            pupo = self._partial_unitary_optimizer_list[iteration]
            U_opt, _ = self._run_inner_optimization(pupo, U0, gammas, Gammas)
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

            if self.checkpoint_dir is not None:
                # overwrite the iteration's snapshot with the POST-rotation
                # state (rotated U, warm-started next initial point, RNG
                # stream position) so `resume_from=` replays the
                # uninterrupted run exactly
                save_checkpoint(
                    os.path.join(self.checkpoint_dir,
                                 f"optorb_iter_{iteration - 1:04d}.npz"),
                    iteration=iteration - 1,
                    partial_unitary=_numpy(self._current_partial_unitary),
                    energy_convergence_list=self._energy_convergence_list,
                    optimal_point=self._ground_state_solver_list[
                        iteration].initial_point,
                    extra={"rng_state": self._rng.bit_generator.state})

        return optorb_result
