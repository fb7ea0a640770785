"""Shared machinery of the OptOrb solver family.

Port of esoo_tpu/orbital_optimization/base.py (the reference's
BaseOptOrbSolver, base_opt_orb_solver.py:19-657): integral ingestion,
initial partial unitary, rotated-Hamiltonian rebuild, RDM measurement,
and the energy functionals handed to the Stiefel optimizer.

Everything heavy lives on the solver's `device` ("cuda" by default): the
starting-basis integrals, the partial unitary U, the RDMs and the orbital
objective.  The rotated Hamiltonian's integrals are rotated there
(kernels.rotated_integrals_spatial: the hand-written transform of
ops/gemm.py on a CUDA tensor) and copied to the host once per outer
iteration for the Pauli coefficients (ops/hamiltonian.py, SciPy); the
operator keeps the device tensors for the eigensolver's energy.  An
eigensolver, estimator or orbital optimizer built for another device
raises.

As in the JAX package:
  * Spatial fast path: spin-block-structured integrals are reduced once
    to spatial m = M/2 tensors and all rotation math runs there.
  * Direct RDMs: sector-native (sim/sector.py) for UCC-family circuits,
    else from the statevector (sim/rdm.py); the per-Pauli reference path
    (`construct_pauli_op_dict` + `get_one/two_RDM_tensor`,
    base_opt_orb_solver.py:247-532) stays under rdm_measurement='pauli'.
  * Complex RDMs (wavefuntion_real=False with a complex state) stay
    complex through the objective, whose value is the real part of the
    physically correct E1 + E2; the reference's complex branch subtracts
    the two-body term (base_opt_orb_solver.py:575-580), which the JAX
    package deliberately does not reproduce, and neither does the port.
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.fermion import FermionicOp
from ..ops.hamiltonian import ActiveSpaceHamiltonianBuilder
from ..ops.jw import JordanWignerMapper
from ..ops.pauli import SparsePauliOp, masks_to_label
from ..sim.estimator import Estimator
from ..sim.rdm import one_rdm, two_rdm
from ..sim.statevector import compile_circuit, pauli_quadforms
from ..utils.config import check_same_device, real_dtype, resolve_device
from .kernels import (expand_spin, expand_spin_tensors, rotate_one_body,
                      rotate_two_body, rotated_energy_so,
                      rotated_energy_so_complex, rotated_energy_spatial,
                      rotated_energy_spatial_complex,
                      rotated_integrals_spatial, spatial_blocks,
                      spin_blocks_consistent, spin_reduce_rdms,
                      spin_reduce_rdms_complex)
from .stiefel import PartialUnitaryProjectionOptimizer, orth


# --- module-level objectives (stable identities: the Stiefel optimizer
# --- caches one value-and-grad per objective)

def _spatial_objective(U, gamma_s, Gamma_s, h_sp, g_sp):
    return rotated_energy_spatial(U, gamma_s, Gamma_s, h_sp, g_sp)


def _so_objective(U, gamma, Gamma, h_so, g_so):
    return rotated_energy_so(U, gamma, Gamma, h_so, g_so)


def _spatial_objective_complex(U, gamma_s, Gamma_s, h_sp, g_sp):
    return rotated_energy_spatial_complex(U, gamma_s, Gamma_s, h_sp, g_sp)


def _so_objective_complex(U, gamma, Gamma, h_so, g_so):
    return rotated_energy_so_complex(U, gamma, Gamma, h_so, g_so)


_hamiltonian_builder_cache: Dict[tuple, tuple] = {}  # key -> (mapper, builder)


def _get_builder(num_spin_orbitals: int,
                 mapper=None) -> ActiveSpaceHamiltonianBuilder:
    """The Hamiltonian builder for N spin orbitals under `mapper`.  Its
    linear (h, g) -> Pauli-coefficient structure depends on the encoding;
    library mappers are stateless per type, so they key on the type name
    (custom mappers key on instance identity, and the cache entry holds
    the mapper so a reused id() can never alias another encoding)."""
    from ..ops.mappers import BravyiKitaevMapper, ParityMapper
    if mapper is None or isinstance(mapper, JordanWignerMapper):
        mkey = "jw"
    elif type(mapper) in (ParityMapper, BravyiKitaevMapper):
        mkey = type(mapper).__name__
    else:
        mkey = id(mapper)
    key = (num_spin_orbitals, mkey)
    hit = _hamiltonian_builder_cache.get(key)
    if hit is not None:
        cached_mapper, b = hit
        if isinstance(mkey, str) or cached_mapper is mapper:
            return b
    b = ActiveSpaceHamiltonianBuilder(num_spin_orbitals, mapper)
    _hamiltonian_builder_cache[key] = (mapper, b)
    return b


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class BaseOptOrbResult:
    """Result fields shared by all OptOrb solvers (ref :628-653)."""

    def __init__(self) -> None:
        self.optimal_partial_unitary: Optional[np.ndarray] = None
        self.num_vqe_evaluations: int = 0
        self.energy_convergence_list: List[float] = []
        self.orbital_rotation_iterations: List[int] = []
        self.metrics: Dict[str, list] = {}


class BaseOptOrbSolver:
    """Shared OptOrb machinery (constructor parity with the reference,
    base_opt_orb_solver.py:19-33, including the historically misspelled
    ``wavefuntion_real`` keyword the shipped examples rely on), plus
    `device`."""

    def __init__(self,
                 num_spin_orbitals: int,
                 mapper: Optional[JordanWignerMapper] = None,
                 estimator: Optional[Estimator] = None,
                 partial_unitary_optimizer: Optional[
                     PartialUnitaryProjectionOptimizer] = None,
                 problem=None,
                 integral_tensors: Optional[Tuple[np.ndarray,
                                                  np.ndarray]] = None,
                 initial_partial_unitary: Optional[np.ndarray] = None,
                 maxiter: int = 10,
                 stopping_tolerance: float = 1e-5,
                 spin_conserving: bool = False,
                 wavefuntion_real: bool = False,
                 outer_loop_callback: Optional[Callable] = None,
                 partial_unitary_random_perturbation: Optional[float] = None,
                 RDM_ops_batchsize: Optional[int] = 100,
                 rdm_measurement: str = "direct",
                 checkpoint_dir: Optional[str] = None,
                 seed: Optional[int] = None,
                 mesh=None,
                 device="cuda"):
        """
        Args (reference parity unless noted):
            num_spin_orbitals: active-space size N.
            mapper: fermion->qubit mapper for RDM ops (default JW).
            estimator: expectation-value primitive (default one on
                `device`).
            partial_unitary_optimizer: the Stiefel/BB inner optimizer
                (default one on `device`).
            problem: an ElectronicStructureProblem (chem.driver) supplying
                integral tensors, or a qiskit-nature one (interop.py).
            integral_tensors: explicit (h, g) dense spin-orbital tensors in
                the reference convention (physicist two-body with the -1
                sign folded, i.e. E2 = sum g * <a+ a+ a a>).
            initial_partial_unitary: spatial (M/2, N/2) initial U; defaults
                to the HF permutation matrix.
            maxiter / stopping_tolerance: outer-loop control.
            spin_conserving / wavefuntion_real: RDM symmetry flags.
            outer_loop_callback: callback(iteration, solver_result,
                optorb_result) per outer iteration.
            partial_unitary_random_perturbation: stddev of the N(0, s)
                noise added to U (then re-orthonormalized) before each
                inner optimization, drawn from a numpy Generator seeded by
                `seed` (the JAX package's stream).
            RDM_ops_batchsize: batch size of the per-Pauli path.
            rdm_measurement: 'direct' (default) or 'pauli'.
            checkpoint_dir: write a resumable checkpoint after every outer
                iteration (the .npz layout of the JAX package).
            mesh: an esoo_torch.parallel.OrbitalMesh led by `device`
                (spin-block-structured integrals only): the orbital
                subproblem runs over g sharded on its last axis
                (parallel.ShardedOrbitalOptimizer, with the partial
                unitary optimizer's settings and without its callback);
                the rotated Hamiltonian is still rebuilt from the
                unsharded g on `device`.
            device: where the integrals, U, the RDMs and the orbital
                optimization live ("cuda" by default; "cpu" on the host).
        """
        self.device = resolve_device(device)
        from .fused import _check_mesh
        _check_mesh(mesh, self.device)
        # drop-in interop: accept qiskit-nature problems / qiskit mappers
        # where the reference does (base_opt_orb_solver.py:22,87-91,115)
        from ..interop import adapt as _interop_adapt
        problem, mapper = _interop_adapt(problem, mapper)
        check_same_device(type(self).__name__, self.device,
                          estimator=estimator,
                          partial_unitary_optimizer=partial_unitary_optimizer)
        self.mapper = mapper or JordanWignerMapper()
        self.estimator = estimator or Estimator(device=self.device)
        self.partial_unitary_optimizer = (
            partial_unitary_optimizer
            or PartialUnitaryProjectionOptimizer(device=self.device))
        dtype = real_dtype()

        def on_device(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                                   device=self.device).to(dtype)

        self.num_spin_orbitals = num_spin_orbitals
        if integral_tensors is None and problem is not None and \
                hasattr(problem, "spatial_integral_tensors"):
            # spatial-direct ingestion: the spin-orbital tensors are never
            # needed on the fast path
            h_sp, g_sp = (_numpy(a) for a in
                          problem.spatial_integral_tensors())
            self.one_body_integrals = self.two_body_integrals = None
            self.num_original_spin_orbitals = 2 * h_sp.shape[0]
            self._spatial_path = True
            self._h_sp, self._g_sp = on_device(h_sp), on_device(g_sp)
            self._h_so = self._g_so = None
        else:
            if integral_tensors is not None:
                h_so, g_so = (np.asarray(a, dtype=np.float64)
                              for a in integral_tensors)
            elif problem is not None:
                h_so, g_so = (np.asarray(a) for a in
                              problem.integral_tensors())
            else:
                raise ValueError(
                    "either `problem` or `integral_tensors` required")
            self.one_body_integrals = h_so
            self.two_body_integrals = g_so
            self.num_original_spin_orbitals = h_so.shape[0]
            # spatial fast path eligibility (verified once, host-side)
            self._spatial_path = spin_blocks_consistent(h_so, g_so)
            if self._spatial_path:
                h_sp, g_sp = spatial_blocks(h_so, g_so)
                self._h_sp, self._g_sp = on_device(h_sp), on_device(g_sp)
            else:
                self._h_sp = self._g_sp = None
            self._h_so, self._g_so = on_device(h_so), on_device(g_so)

        m = self.num_original_spin_orbitals // 2
        n = num_spin_orbitals // 2
        if initial_partial_unitary is None:
            U0 = np.zeros((m, n))
            U0[np.arange(n), np.arange(n)] = 1.0  # HF permutation (ref :93)
        else:
            U0 = _numpy(initial_partial_unitary).astype(np.float64)
            if U0.shape != (m, n):
                raise ValueError(
                    f"initial_partial_unitary must be spatial ({m}, {n}), "
                    f"got {U0.shape}")
        self.initial_partial_unitary = U0
        self._current_partial_unitary = on_device(U0)

        self.maxiter = maxiter
        self.stopping_tolerance = stopping_tolerance
        self.spin_conserving = spin_conserving
        self.wavefunction_real = wavefuntion_real
        self.outer_loop_callback = outer_loop_callback
        self.partial_unitary_random_perturbation = \
            partial_unitary_random_perturbation
        self.RDM_ops_batchsize = RDM_ops_batchsize
        if rdm_measurement not in ("direct", "pauli"):
            raise ValueError("rdm_measurement must be 'direct' or 'pauli'")
        if rdm_measurement == "direct" and \
                not isinstance(self.mapper, JordanWignerMapper):
            # the direct path reads amplitudes in the occupation basis,
            # which only JW preserves; parity/Bravyi-Kitaev take the
            # per-Pauli reference path
            warnings.warn(
                f"rdm_measurement='direct' requires the Jordan-Wigner "
                f"encoding; switching to 'pauli' for "
                f"{type(self.mapper).__name__}", stacklevel=3)
            rdm_measurement = "pauli"
        self.rdm_measurement = rdm_measurement
        self.checkpoint_dir = checkpoint_dir
        self._rng = np.random.default_rng(seed)

        # optional sharding of g over a mesh (parallel/sharded.py): the
        # inner orbital optimization runs over the shards
        self.mesh = mesh
        self._sharded = None
        if mesh is not None:
            if not self._spatial_path:
                raise ValueError(
                    "mesh sharding requires spin-block-structured integrals")
            from ..parallel import (ShardedOrbitalOptimizer,
                                    shard_problem_tensors)
            pupo = self.partial_unitary_optimizer
            h_lead, g_shards = shard_problem_tensors(mesh, self._h_sp,
                                                     self._g_sp)
            self._sharded = {
                "h": h_lead, "g": g_shards,
                "optimizer": ShardedOrbitalOptimizer(
                    mesh, initial_BBstepsize=pupo.BBstepsize,
                    stopping_tolerance=pupo.stopping_tolerance,
                    maxiter=pupo.maxiter, decay_factor=pupo.decay_factor),
            }

        self._hamiltonian: Optional[SparsePauliOp] = None
        self._pauli_op_dict: Optional[Dict[str, SparsePauliOp]] = None
        self._energy_convergence_list: List[float] = []

        # per-iteration copies, mirroring the reference's lifecycle
        # (base_opt_orb_solver.py:75); the copies share the value-and-grad
        # cache
        self._partial_unitary_optimizer_list = [
            copy.copy(self.partial_unitary_optimizer)
            for _ in range(int(maxiter) + 1)
        ]

    def _check_solver_device(self, solver) -> None:
        check_same_device(type(self).__name__, self.device, solver=solver)

    def _to_device(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- properties (parity surface) --------------------------------------
    @property
    def energy_convergence_list(self) -> List[float]:
        return self._energy_convergence_list

    @property
    def current_partial_unitary(self) -> np.ndarray:
        return _numpy(self._current_partial_unitary)

    # -- Stiefel projection ------------------------------------------------
    @staticmethod
    def orth(V):
        """Polar-factor projection onto the Stiefel manifold (ref
        :614-626): a tensor stays a tensor, NumPy stays NumPy."""
        if torch.is_tensor(V):
            return orth(V)
        return orth(torch.as_tensor(np.asarray(V))).numpy()

    # -- energy functionals ------------------------------------------------
    def compute_rotated_energy(self, partial_unitary, oneRDM, twoRDM,
                               one_body_integrals, two_body_integrals):
        """E(U) with explicit spin-orbital RDMs/integrals (reference
        signature, base_opt_orb_solver.py:534-582), differentiable in U.
        Complex RDMs are reduced to their real part; the physically
        correct E1 + E2 is used (see the module docstring)."""
        return _so_objective(partial_unitary, oneRDM, twoRDM,
                             one_body_integrals, two_body_integrals)

    @staticmethod
    def _combined_rdms(gammas, Gammas,
                       weights: Optional[Sequence[float]] = None,
                       keep_complex: bool = False):
        """Weight-combine multi-state RDMs: sum_i w_i E(U; RDM_i) is
        linear in the RDMs, so it is ONE energy evaluation with combined
        RDMs (the reference loops over states,
        opt_orb_eigensolver.py:149-169).  keep_complex keeps complex128
        RDMs (the reference casts to complex128 whenever wavefuntion_real
        is False, base_opt_orb_solver.py:575)."""
        if weights is None:
            weights = [1.0] * len(gammas)
        w = [float(x) for x in weights]
        if keep_complex and any(g.is_complex() for g in gammas):
            gamma = sum(wi * g.to(torch.complex128)
                        for wi, g in zip(w, gammas))
            Gamma = sum(wi * G.to(torch.complex128)
                        for wi, G in zip(w, Gammas))
            return gamma, Gamma

        def real(t):
            return t.real if t.is_complex() else t
        gamma = sum(wi * real(g) for wi, g in zip(w, gammas))
        Gamma = sum(wi * real(G) for wi, G in zip(w, Gammas))
        return gamma, Gamma

    def _inner_objective_and_data(self, gammas, Gammas,
                                  weights: Optional[Sequence[float]] = None):
        """(objective, data tuple on the device) for the Stiefel
        optimizer; complex RDMs (wavefuntion_real=False) keep the complex
        objective."""
        gammas = [self._to_device(g) for g in gammas]
        Gammas = [self._to_device(G) for G in Gammas]
        gamma, Gamma = self._combined_rdms(
            gammas, Gammas, weights,
            keep_complex=not self.wavefunction_real)
        if gamma.is_complex():
            if self._spatial_path:
                gamma_s, Gamma_s = spin_reduce_rdms_complex(gamma, Gamma)
                return _spatial_objective_complex, (gamma_s, Gamma_s,
                                                    self._h_sp, self._g_sp)
            return _so_objective_complex, (gamma, Gamma, self._h_so,
                                           self._g_so)
        if self._spatial_path:
            gamma_s, Gamma_s = spin_reduce_rdms(gamma, Gamma)
            return _spatial_objective, (gamma_s, Gamma_s, self._h_sp,
                                        self._g_sp)
        return _so_objective, (gamma, Gamma, self._h_so, self._g_so)

    def _run_inner_optimization(self, pupo, U0, gammas, Gammas,
                                weights: Optional[Sequence[float]] = None):
        """The orbital-rotation subproblem on the device, or over the
        mesh when one was given: (U, E)."""
        if self._sharded is not None:
            gamma, Gamma = self._combined_rdms(
                [self._to_device(g) for g in gammas],
                [self._to_device(G) for G in Gammas], weights)
            gamma_s, Gamma_s = spin_reduce_rdms(gamma, Gamma)
            return self._sharded["optimizer"].compute_optimal_rotation(
                U0, gamma_s, Gamma_s, self._sharded["h"],
                self._sharded["g"])
        objective, data = self._inner_objective_and_data(gammas, Gammas,
                                                         weights)
        return pupo.compute_optimal_rotation(objective, U0, *data)

    # -- Hamiltonian rebuild -----------------------------------------------
    def _rotated_integrals(self, partial_unitary) -> tuple:
        """Spin-orbital (h, g) of the active space after rotating by U, on
        the device (the K2 transform on a CUDA tensor)."""
        u = self._to_device(partial_unitary).to(real_dtype())
        with torch.no_grad():
            if self._spatial_path:
                h_act, g_act = rotated_integrals_spatial(u, self._h_sp,
                                                         self._g_sp)
                return expand_spin_tensors(h_act, g_act)
            U = expand_spin(u)
            return (rotate_one_body(self._h_so, U),
                    rotate_two_body(self._g_so, U))

    def get_rotated_hamiltonian(self, partial_unitary) -> SparsePauliOp:
        """Qubit Hamiltonian of the active space after rotating by U (ref
        :584-612).  The integrals are rotated on the device; the Pauli
        coefficients are built on the host, and the operator keeps the
        device tensors (`_fermionic_tensors`) for the eigensolver."""
        h_so, g_so = self._rotated_integrals(partial_unitary)
        op = _get_builder(self.num_spin_orbitals, self.mapper).build(
            _numpy(h_so), _numpy(g_so))
        if getattr(op, "fermionic", None) is not None:
            op._fermionic_tensors = (h_so, g_so)
        return op

    # -- RDM measurement: direct paths -------------------------------------
    def measure_rdms_direct(self, state_vector
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gamma, Gamma) on the device from a statevector."""
        N = self.num_spin_orbitals
        sv = self._to_device(state_vector)
        with torch.no_grad():
            return one_rdm(sv, N), two_rdm(sv, N)

    def _rdms_for_bound_circuits(self, pairs) -> Tuple[list, list]:
        """(gammas, Gammas) on the device for (circuit, params) pairs:
        sector-eligible circuits (solvers/energy._sector_for) are measured
        in the particle-number sector, never materializing the 2^N
        statevector; others take the full simulation and the
        imaginary-residue guard."""
        from ..solvers.energy import _sector_for
        gammas, Gammas = [], []
        for circ, params in pairs:
            params = np.zeros(circ.num_parameters) if params is None \
                else np.asarray(params, dtype=np.float64)
            theta = torch.as_tensor(params, device=self.device).to(
                real_dtype())
            sec = _sector_for(circ)
            with torch.no_grad():
                if sec is not None:
                    # sector states/RDMs are real by construction
                    g1, g2 = sec.rdms(sec.state(theta))
                    gammas.append(g1)
                    Gammas.append(g2)
                    continue
                sv = compile_circuit(circ).state(theta)
            g, G = self._rdms_for_states([sv])
            gammas.extend(g)
            Gammas.extend(G)
        return gammas, Gammas

    def _rdms_for_states(self, state_vectors) -> Tuple[list, list]:
        """(gammas, Gammas) for each state; imaginary residue is detected
        and warned about (the reference's flag mechanism,
        base_opt_orb_solver.py:380-401) before real parts feed the
        objective under wavefuntion_real."""
        from ..utils.debug import check_imaginary_residue
        strip = self.wavefunction_real
        gammas, Gammas = [], []
        for sv in state_vectors:
            g1, g2 = self.measure_rdms_direct(sv)
            gammas.append(check_imaginary_residue(g1, what="1-RDM",
                                                  strip=strip))
            Gammas.append(check_imaginary_residue(g2, what="2-RDM",
                                                  strip=strip))
        return gammas, Gammas

    # -- RDM measurement: per-Pauli parity path ----------------------------
    def _rdm_fermionic_terms(self):
        """(kind, indices, FermionicOp) for every RDM element operator,
        with the reference's pruning (p==q / r==s zero, spin
        conservation)."""
        N = self.num_spin_orbitals
        n = N // 2

        def spin(p):
            return 0 if p < n else 1

        for p in range(N):
            for q in range(N):
                if self.spin_conserving and spin(p) != spin(q):
                    continue
                yield ("one", (p, q), FermionicOp({f"+_{p} -_{q}": 1.0}, N))
        for p in range(N):
            for q in range(N):
                if p == q:
                    continue
                for r in range(N):
                    for s in range(N):
                        if r == s:
                            continue
                        if self.spin_conserving and \
                                spin(p) + spin(q) != spin(r) + spin(s):
                            continue
                        yield ("two", (p, q, r, s), FermionicOp(
                            {f"+_{p} +_{q} -_{s} -_{r}": 1.0}, N))

    def construct_pauli_op_dict(self, mapper=None
                                ) -> Dict[str, SparsePauliOp]:
        """Label -> single-Pauli SparsePauliOp for every Pauli string
        needed by any RDM element (ref base_opt_orb_solver.py:247-360),
        each measured once."""
        mapper = mapper or self.mapper
        N = self.num_spin_orbitals
        pauli_dict: Dict[str, SparsePauliOp] = {}
        decomps: Dict[tuple, list] = {}
        for kind, idx, fop in self._rdm_fermionic_terms():
            op = mapper.map(fop)
            terms = []
            for x, z, c in zip(op.xs, op.zs, op.coeffs):
                label = masks_to_label(x, z, N)
                if label not in pauli_dict:
                    pauli_dict[label] = SparsePauliOp(
                        ([x], [z]), [1.0], num_qubits=N)
                terms.append((label, complex(c)))
            decomps[(kind,) + idx] = terms
        self._rdm_decompositions = decomps
        self._pauli_op_dict = pauli_dict
        return pauli_dict

    def measure_pauli_dict(self, state_circuit, params=None,
                           estimator: Optional[Estimator] = None
                           ) -> Dict[str, complex]:
        """Expectation value of every dict Pauli in the given state (the
        reference's one estimator call per op,
        opt_orb_minimum_eigensolver.py:187-202, as batched products on
        the device)."""
        if self._pauli_op_dict is None:
            self.construct_pauli_op_dict(self.mapper)
        compiled = compile_circuit(state_circuit)
        if params is None:
            params = np.zeros(compiled.num_parameters)
        with torch.no_grad():
            state = compiled.state(np.asarray(params, dtype=np.float64),
                                   self.device)
        labels = list(self._pauli_op_dict.keys())
        xs = np.array([self._pauli_op_dict[lb].xs[0] for lb in labels])
        zs = np.array([self._pauli_op_dict[lb].zs[0] for lb in labels])
        ys = np.array([bin(int(x) & int(z)).count("1")
                       for x, z in zip(xs, zs)])
        vals = []
        bs = self.RDM_ops_batchsize or len(labels)
        for lo in range(0, len(labels), bs):
            sl = slice(lo, lo + bs)
            with torch.no_grad():
                q = pauli_quadforms(state, xs[sl], zs[sl]).cpu().numpy()
            vals.append(q * np.power(1j, ys[sl] % 4))
        return dict(zip(labels, np.concatenate(vals)))

    def get_one_RDM_tensor(self, expectval_dict: Dict[str, complex],
                           mapper=None) -> np.ndarray:
        """Assemble gamma from Pauli expectation values (ref :455-532)."""
        N = self.num_spin_orbitals
        dtype = np.float64 if self.wavefunction_real else np.complex128
        gamma = np.zeros((N, N), dtype=dtype)
        vals = []
        for key, terms in self._rdm_decompositions.items():
            if key[0] != "one":
                continue
            _, p, q = key
            val = sum(c * expectval_dict[lb] for lb, c in terms)
            vals.append(val)
            gamma[p, q] = val.real if self.wavefunction_real else val
        self._assembly_residue_check(vals, "1-RDM")
        return gamma

    def get_two_RDM_tensor(self, expectval_dict: Dict[str, complex],
                           mapper=None) -> np.ndarray:
        """Assemble Gamma from Pauli expectation values (ref :362-453)."""
        N = self.num_spin_orbitals
        dtype = np.float64 if self.wavefunction_real else np.complex128
        Gamma = np.zeros((N, N, N, N), dtype=dtype)
        vals = []
        for key, terms in self._rdm_decompositions.items():
            if key[0] != "two":
                continue
            _, p, q, r, s = key
            val = sum(c * expectval_dict[lb] for lb, c in terms)
            vals.append(val)
            Gamma[p, q, r, s] = val.real if self.wavefunction_real else val
        self._assembly_residue_check(vals, "2-RDM")
        return Gamma

    def _rdms_via_pauli(self, circuits_and_params) -> Tuple[list, list]:
        """(gammas, Gammas) on the device from the per-Pauli path."""
        gammas, Gammas = [], []
        for circ, params in circuits_and_params:
            vals = self.measure_pauli_dict(circ, params)
            gammas.append(self._to_device(self.get_one_RDM_tensor(vals)))
            Gammas.append(self._to_device(self.get_two_RDM_tensor(vals)))
        return gammas, Gammas

    def _assembly_residue_check(self, values, what: str) -> None:
        """The reference's flag mechanism on the Pauli assembly path
        (base_opt_orb_solver.py:380-401): under wavefuntion_real, warn
        about imaginary residue in the element values being stripped."""
        if not self.wavefunction_real:
            return
        resid = max((abs(complex(v).imag) for v in values), default=0.0)
        if resid > 1e-8:
            warnings.warn(
                f"{what} elements have imaginary residue {resid:.2e} with "
                f"wavefuntion_real=True; wavefunction may not be real",
                stacklevel=3)

    # -- shared outer-loop helpers ----------------------------------------
    def _maybe_perturb_unitary(self, U: torch.Tensor) -> torch.Tensor:
        scale = self.partial_unitary_random_perturbation
        if scale:
            noise = self._rng.normal(0.0, scale, size=tuple(U.shape))
            return orth(U + torch.as_tensor(noise, device=U.device)
                        .to(U.dtype))
        return U

    def stopping_condition(self, iteration: int) -> bool:
        """ref opt_orb_minimum_eigensolver.py:125-138."""
        lst = self._energy_convergence_list
        if len(lst) >= 2:
            return (iteration >= self.maxiter
                    or abs(lst[-1] - lst[-2]) < self.stopping_tolerance)
        return iteration >= self.maxiter
