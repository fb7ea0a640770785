"""FusedOptOrbVQE: the OptOrbVQE outer loop on one device.

Port of esoo_tpu/orbital_optimization/fused.py (FusedOptOrbVQE and the
one-dispatch program `_fused_optorb_vqe`).  The JAX package compiles the
whole loop into one XLA program; here it is an eager Python loop over
device tensors, with the same stages and the same decisions:

    for each outer iteration:
        rotate the integrals at U          (CUDA: ops/gemm.py kernels)
        L-BFGS over theta of <psi(theta)|H(U)|psi(theta)>  (sector sim)
        string RDMs of the optimum, spin-reduced
        BB/Stiefel descent over U at fixed RDMs
        stop when |E - E_prev| < tol (keeping the U that produced E)
    re-solve at the final U, unconditionally

Every host decision (a stop test, a line-search branch) reads a device
scalar, so the loop syncs with the device several times per step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..solvers.lbfgs import lbfgs_minimize
from ..utils.config import resolve_device
from .checkpoint import load_checkpoint, save_checkpoint
from .kernels import (expand_spin_tensors, rotate_one_body, rotate_two_body,
                      rotated_energy_spatial, spatial_blocks,
                      spin_blocks_consistent, spin_reduce_rdms,
                      spin_squared_from_rdms)
from .stiefel import _bb_loop, orth, value_and_grad

# single source of truth for the orbital objective
_ORBITAL_VAG = value_and_grad(rotated_energy_spatial)


@dataclasses.dataclass
class FusedOptOrbResult:
    eigenvalue: float
    optimal_point: np.ndarray
    optimal_partial_unitary: np.ndarray
    energy_convergence_list: list
    outer_iterations: int
    optimal_circuit: Optional[object] = None
    # natural-orbital occupation numbers of the optimal state (descending
    # eigenvalues of the spin-summed spatial 1-RDM)
    natural_occupations: Optional[np.ndarray] = None
    # total-spin expectation <S^2> of the optimal state
    spin_squared: Optional[float] = None
    # spin-summed spatial 1-RDM over the active (rotated) orbitals, (n, n)
    one_rdm_spatial: Optional[np.ndarray] = None
    # spatial spin density gamma_aa - gamma_bb, (n, n)
    spin_density_spatial: Optional[np.ndarray] = None
    # where the run went, summed over the outer loop: BB iterations,
    # L-BFGS iterations and value-and-grad evaluations, and host-clock
    # seconds of the eigensolver and orbital stages (each ends at a sync
    # the loop makes anyway, so the clock adds none)
    stage_stats: Optional[dict] = None

    @property
    def optimal_parameters(self):
        return self.optimal_point


@dataclasses.dataclass
class FusedOptOrbEigensolverResult:
    """Result of a k-state solver (esoo_tpu fused.py:578)."""
    eigenvalues: np.ndarray
    optimal_point: np.ndarray
    optimal_partial_unitary: np.ndarray
    energy_convergence_list: list     # weighted sums per outer iteration
    outer_iterations: int
    # per-state descending natural occupations (k, n) and <S^2> (k,)
    natural_occupations: Optional[np.ndarray] = None
    spin_squared: Optional[np.ndarray] = None
    # per-state spin-summed spatial 1-RDMs over the active orbitals,
    # (k, n, n)
    one_rdm_spatial: Optional[np.ndarray] = None
    # spin-summed spatial transition 1-RDMs t[i, j] = <psi_i|E_ps|psi_j>,
    # (k, k, n, n)
    transition_rdm1_spatial: Optional[np.ndarray] = None
    # per-state spatial spin densities gamma_aa - gamma_bb, (k, n, n)
    spin_density_spatial: Optional[np.ndarray] = None

    @property
    def optimal_parameters(self):
        return self.optimal_point


def _inner_bb(vag_fn, U0, data, stepsize, tol, decay, maxiter,
              stats: Optional[dict] = None):
    """BB projected-gradient descent (the loop of stiefel.py)."""
    t0 = time.perf_counter()
    U, k, _, _ = _bb_loop(vag_fn, U0, data, stepsize, tol, decay, maxiter)
    if stats is not None:
        seconds = time.perf_counter() - t0
        stats["bb_iterations"] += k - 1
        stats["bb_s"] += seconds
        stats.setdefault("bb_s_per_call", []).append(seconds)
    return U


def _vqe_stage_fns(sector, vqe_maxiter: int, dtype: torch.dtype,
                   ftol=None, stats: Optional[dict] = None):
    """(run_vqe, extract_rdms) for the sector eigensolver stage."""
    gtol = 1e-9 if torch.finfo(dtype).bits >= 64 else 1e-5

    def run_vqe(theta, h_act, g_act):
        t0 = time.perf_counter()
        h_so, g_so = expand_spin_tensors(h_act, g_act)
        vals = sector.build_values(h_so, g_so)
        res = lbfgs_minimize(sector.energy_values, theta, args=(vals,),
                             maxiter=vqe_maxiter, gtol=gtol, ftol=ftol)
        if stats is not None:
            stats["lbfgs_iterations"] += res.nit
            stats["lbfgs_evaluations"] += res.nfev
            stats["lbfgs_s"] += time.perf_counter() - t0
        return res.x, res.fun

    def extract_rdms(theta):
        # sector-native RDMs: never touches the 2^N space
        return sector.rdms(sector.state_matrix(theta))

    return run_vqe, extract_rdms


def _make_program_callback(user_callback, checkpoint_dir):
    """Per-outer-iteration host callback with (iteration, energy, theta,
    U, trace): writes a resumable .npz when `checkpoint_dir` is set, then
    chains to the user's outer_loop_callback(iteration, energy)."""
    if user_callback is None and checkpoint_dir is None:
        return None

    def cb(it, e, theta, U, trace):
        it = int(it)
        if checkpoint_dir is not None:
            hist = np.asarray(trace).reshape(-1)[:it]
            save_checkpoint(
                os.path.join(checkpoint_dir, f"fused_iter_{it:04d}.npz"),
                iteration=it, partial_unitary=np.asarray(U),
                energy_convergence_list=hist,
                optimal_point=np.asarray(theta))
        if user_callback is not None:
            user_callback(it, np.asarray(e) if np.ndim(e) else float(e))
    return cb


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _optorb_loop(solve: Callable, extract_rdms: Callable, state, U0, h_sp,
                 g_sp, outer_tol, inner_tol, bb_stepsize, decay,
                 outer_maxiter: int = 20, inner_maxiter: int = 10000,
                 weights: Optional[torch.Tensor] = None,
                 final_solve: Optional[Callable] = None,
                 callback: Optional[Callable] = None,
                 stats: Optional[dict] = None):
    """The OptOrb outer loop of every fused solver (esoo_tpu
    fused.py:499-574, casscf.py:119-174 and 639-696).

    solve(state, h_act, g_act) -> (state, es) runs the eigensolver stage
    at the rotated integrals (es a scalar, or the (k,) energies whose
    `weights` sum the convergence rule reads); extract_rdms(state) ->
    spin-orbital (gamma, Gamma).  The final re-solve runs `final_solve`
    (default `solve`).  Returns (es, state, U, n_outer, energy_trace)."""
    trace = np.full((outer_maxiter,), np.nan)
    U = orth(U0)
    E_prev = torch.full((), float("inf"), dtype=h_sp.dtype,
                        device=h_sp.device)
    it = 0
    while True:
        h_act = rotate_one_body(h_sp, U)
        g_act = rotate_two_body(g_sp, U)
        state, es = solve(state, h_act, g_act)
        E = es if weights is None else weights @ es
        trace[it] = float(E)
        if callback is not None:
            callback(it + 1, _numpy(es), _numpy(state), _numpy(U), trace)
        converged = bool(torch.abs(E - E_prev) < outer_tol)
        it += 1
        if converged:
            # keep the pre-rotation U (the one that produced E); the JAX
            # program computes and discards the rotated U here
            break
        gamma, Gamma = extract_rdms(state)
        gamma_s, Gamma_s = spin_reduce_rdms(gamma, Gamma)
        U = _inner_bb(_ORBITAL_VAG, U, (gamma_s, Gamma_s, h_sp, g_sp),
                      bb_stepsize, inner_tol, decay, inner_maxiter, stats)
        if it >= outer_maxiter:
            break
        E_prev = E
    # re-solve at the final U so (E, state, U) are mutually consistent even
    # when the loop ended on hit_max (where U is the freshly rotated one)
    h_act = rotate_one_body(h_sp, U)
    g_act = rotate_two_body(g_sp, U)
    state, es = (final_solve or solve)(state, h_act, g_act)
    return es, state, U, it, trace[:it]


def _fused_optorb_vqe(sector, theta0, U0, h_sp, g_sp, outer_tol, inner_tol,
                      bb_stepsize, decay, outer_maxiter: int = 20,
                      inner_maxiter: int = 10000, vqe_maxiter: int = 200,
                      vqe_ftol=None, callback: Optional[Callable] = None,
                      stats: Optional[dict] = None):
    """The VQE outer loop.  Returns (E, theta, U, n_outer, energy_trace)."""
    run_vqe, extract_rdms = _vqe_stage_fns(sector, vqe_maxiter, h_sp.dtype,
                                           ftol=vqe_ftol, stats=stats)
    return _optorb_loop(run_vqe, extract_rdms, theta0, U0, h_sp, g_sp,
                        outer_tol, inner_tol, bb_stepsize, decay,
                        outer_maxiter, inner_maxiter, callback=callback,
                        stats=stats)


def _attach_vqe_diagnostics(result, solver, theta):
    """Natural occupations, <S^2>, spatial 1-RDM and spin density of the
    optimal state (esoo_tpu fused.py:431-478)."""
    if not solver.diagnostics:
        return result
    with torch.no_grad():
        gamma, Gamma = solver._sector.rdms(solver._sector.state_matrix(theta))
        gamma_s, _ = spin_reduce_rdms(gamma, Gamma)
        n = gamma.shape[0] // 2
        result.natural_occupations = _numpy(
            torch.flip(torch.linalg.eigvalsh(gamma_s), dims=(0,)))
        result.spin_squared = float(spin_squared_from_rdms(gamma, Gamma))
        result.one_rdm_spatial = _numpy(gamma_s)
        result.spin_density_spatial = _numpy(gamma[:n, :n] - gamma[n:, n:])
    return result


def _to_dtype(dtype) -> torch.dtype:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class FusedOptOrbVQE:
    """OptOrbVQE with the built-in sector L-BFGS eigensolver (see module
    docstring).  Keywords are esoo_tpu.orbital_optimization.FusedOptOrbVQE's
    plus `device` ("cuda" by default; "cpu" runs the plain versions)."""

    def __init__(self,
                 num_spin_orbitals: int,
                 ansatz,
                 problem=None,
                 integral_tensors=None,
                 initial_partial_unitary=None,
                 initial_point=None,
                 maxiter: int = 20,
                 stopping_tolerance: float = 1e-5,
                 inner_stopping_tolerance: float = 1e-5,
                 inner_maxiter: int = 10000,
                 initial_BBstepsize: float = 1e-3,
                 decay_factor: float = 0.8,
                 vqe_maxiter: int = 200,
                 vqe_ftol: float = None,
                 dtype=None,
                 mesh=None,
                 simulation: str = "auto",
                 dispatch: str = "one",
                 vqe_chunk: Optional[int] = None,
                 outer_loop_callback=None,
                 checkpoint_dir=None,
                 resume_from=None,
                 diagnostics: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.diagnostics = bool(diagnostics)
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (sharded integrals and sector tables) is not ported "
                "yet: ROADMAP queue 1, item 11")
        if simulation not in ("full", "sector", "auto"):
            raise ValueError("simulation must be 'full', 'sector' or 'auto'")
        if simulation == "full":
            raise NotImplementedError(
                "simulation='full' (the 2^N statevector simulator) is not "
                "ported yet: ROADMAP queue 1, item 8")
        if getattr(ansatz, "_ucc_excitations", None) is None:
            raise NotImplementedError(
                "only UCC-family ansaetze (sim.ansatz.UCC/UCCSD) run here: "
                "other circuits need the full-space simulator, ROADMAP "
                "queue 1, item 8")
        enc = getattr(ansatz, "_encoding", "jw")
        if enc != "jw":
            raise ValueError(
                f"fused solvers require a Jordan-Wigner-encoded ansatz; "
                f"got encoding {enc!r}")

        if resume_from is not None:
            ck = load_checkpoint(resume_from)
            initial_partial_unitary = ck["partial_unitary"]
            if "optimal_point" in ck:
                initial_point = ck["optimal_point"]
        if integral_tensors is not None:
            h_so = np.asarray(integral_tensors[0], dtype=np.float64)
            g_so = np.asarray(integral_tensors[1], dtype=np.float64)
            if not spin_blocks_consistent(h_so, g_so):
                raise ValueError(
                    "FusedOptOrbVQE requires spin-block-structured "
                    "integrals")
            h_sp, g_sp = spatial_blocks(h_so, g_so)
        elif problem is not None and hasattr(problem,
                                             "spatial_integral_tensors"):
            h_sp, g_sp = problem.spatial_integral_tensors()
        elif problem is not None:
            h_so, g_so = problem.integral_tensors()
            h_so, g_so = np.asarray(h_so), np.asarray(g_so)
            if not spin_blocks_consistent(h_so, g_so):
                raise ValueError(
                    "FusedOptOrbVQE requires spin-block-structured "
                    "integrals")
            h_sp, g_sp = spatial_blocks(h_so, g_so)
        else:
            raise ValueError("either `problem` or `integral_tensors` required")
        h_sp = h_sp.detach().cpu().numpy() if torch.is_tensor(h_sp) \
            else np.asarray(h_sp)
        g_sp = g_sp.detach().cpu().numpy() if torch.is_tensor(g_sp) \
            else np.asarray(g_sp)
        dtype = _to_dtype(dtype) or _to_dtype(h_sp.dtype)
        self.dtype = dtype
        dev = self.device
        self._h_sp = torch.as_tensor(np.ascontiguousarray(h_sp),
                                     device=dev).to(dtype)
        self._g_sp = torch.as_tensor(np.ascontiguousarray(g_sp),
                                     device=dev).to(dtype)

        self.num_spin_orbitals = num_spin_orbitals
        self.ansatz = ansatz
        self.simulation = "sector"
        self.mesh = None
        from ..sim.sector import SectorUCC
        self._sector = SectorUCC(ansatz, num_spin_orbitals)

        m = h_sp.shape[0]
        n = num_spin_orbitals // 2
        if initial_partial_unitary is None:
            U0 = np.zeros((m, n))
            U0[np.arange(n), np.arange(n)] = 1.0
        else:
            U0 = np.asarray(initial_partial_unitary, dtype=np.float64)
        self._U0 = torch.as_tensor(U0, device=dev).to(dtype)
        if initial_point is None:
            initial_point = np.zeros(ansatz.num_parameters)
        self._theta0 = torch.as_tensor(
            np.asarray(initial_point, dtype=np.float64), device=dev).to(dtype)

        if maxiter < 1:
            raise ValueError("maxiter must be >= 1 (the outer loop always "
                             "runs at least one eigensolver iteration)")
        self.maxiter = maxiter
        self.stopping_tolerance = stopping_tolerance
        self.inner_stopping_tolerance = inner_stopping_tolerance
        self.inner_maxiter = inner_maxiter
        self.initial_BBstepsize = initial_BBstepsize
        self.decay_factor = decay_factor
        self.vqe_maxiter = vqe_maxiter
        # eigensolver plateau-stop override (solvers/lbfgs.py `ftol`):
        # None = auto (32 ulp at f32, disabled at f64)
        self.vqe_ftol = vqe_ftol
        # dispatch/vqe_chunk bound the length of one compiled TPU program in
        # the JAX package; the eager loop has no programs to bound, so both
        # are validated and give the same result as dispatch='one'
        if dispatch not in ("one", "two"):
            raise ValueError("dispatch must be 'one' or 'two'")
        self.dispatch = dispatch
        if vqe_chunk is not None:
            if dispatch != "two":
                raise ValueError("vqe_chunk requires dispatch='two' (it "
                                 "bounds the per-dispatch eigensolver work)")
            if int(vqe_chunk) < 1:
                raise ValueError("vqe_chunk must be a positive iteration "
                                 "count")
        self.vqe_chunk = vqe_chunk
        self.outer_loop_callback = outer_loop_callback
        self.checkpoint_dir = checkpoint_dir

    def compute_minimum_energy(self) -> FusedOptOrbResult:
        with torch.no_grad():
            return self._run()

    def _run(self) -> FusedOptOrbResult:
        dtype, dev = self.dtype, self.device

        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        stats = {"bb_iterations": 0, "lbfgs_iterations": 0,
                 "lbfgs_evaluations": 0, "lbfgs_s": 0.0, "bb_s": 0.0,
                 "bb_s_per_call": []}
        E, theta, U, it, trace = _fused_optorb_vqe(
            self._sector, self._theta0, self._U0, self._h_sp, self._g_sp,
            scalar(self.stopping_tolerance),
            scalar(self.inner_stopping_tolerance),
            scalar(self.initial_BBstepsize), scalar(self.decay_factor),
            outer_maxiter=self.maxiter, inner_maxiter=self.inner_maxiter,
            vqe_maxiter=self.vqe_maxiter, vqe_ftol=self.vqe_ftol,
            callback=_make_program_callback(self.outer_loop_callback,
                                            self.checkpoint_dir),
            stats=stats)
        return _attach_vqe_diagnostics(FusedOptOrbResult(
            eigenvalue=float(E),
            optimal_point=_numpy(theta),
            optimal_partial_unitary=_numpy(U),
            energy_convergence_list=[float(e) for e in trace],
            outer_iterations=it,
            optimal_circuit=self.ansatz,
            stage_stats=stats,
        ), self, theta)
