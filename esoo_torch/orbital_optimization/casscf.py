"""FusedOptOrbCASSCF: orbital optimization around exact active-space
diagonalization (classical two-step CASSCF).

Port of esoo_tpu/orbital_optimization/casscf.py.  The OptOrb outer loop
(fused._optorb_loop) alternates "solve the active-space eigenproblem at
U" with "BB/Stiefel-descend U at fixed RDMs"; here the eigensolver stage
is the exact lowest eigenpair (or, state-averaged, the lowest k) of the
sector Hamiltonian, by Davidson (solvers/davidson.py) on the string sigma
(sim/strings.py), warm-started from the previous outer iteration's
eigenvector:

    for each outer iteration:
        rotate the integrals at U      (CUDA: the K2 transform, ops/gemm.py)
        sigma operators, exact diagonal, Davidson at tol 1e-9 (f64) or
            1e-6 (f32) relative to max(1, |E|)
        string RDMs of the eigenvector(s), weighted for SA
        BB/Stiefel descent over U at fixed RDMs
        stop when |E - E_prev| < tol (keeping the U that produced E)
    re-solve at the final U, unconditionally

`dispatch='two'` with `davidson_chunk` runs each solve through the
k = 1 block machinery in bounded advances (and `davidson_tol_ladder`
loosens the loop's solves 30x; the final solve stays tight), as the JAX
package does; the eager loop gives the same results either way.
`table_storage='compact'` (and 'auto' past 1.1M determinants) keeps the
sector's operator stacks int8 and runs the operator-chunked kernels
(sim/strings.py).  `mesh=` (parallel.make_orbital_mesh) shards the m^4
integral tensor on its last axis over the mesh's devices: each outer
iteration's rotation and every BB step run shard by shard and reduce on
the lead device, as in the JAX package.  The sector's operator stacks
shard over the mesh too (parallel.shard_sector_tables; `table_storage`
reads 'sharded', or 'sharded-compact' with the stacks kept int8 and each
device casting its own shard), and Davidson's sigma, the diagonal, the
RDMs and the transition RDMs run over the shards
(sim/sharded_strings.py).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..sim.sector import SectorCI
from ..solvers.davidson import (davidson_block, davidson_block_advance,
                                davidson_block_finish, davidson_block_init,
                                davidson_ground)
from ..utils.config import resolve_device
from ..utils.profiling import collect, span
from .checkpoint import load_checkpoint
from .fused import (FusedOptOrbEigensolverResult, FusedOptOrbResult,
                    _check_mesh, _loop_stats, _OuterLoopSolver, _numpy,
                    _spatial_integrals, _state_diagnostics,
                    _states_diagnostics, _to_dtype, _transition_rdm1s,
                    _weighted_rdms)
from .kernels import expand_spin_tensors
from .stiefel import orth

_SECTOR_CI_CACHE = {}

_COMPACT_MIN_ND = 1_100_000   # 'auto' -> int8-chunked stacks past this


def _sector_ci_cached(num_spin_orbitals: int,
                      num_particles: Tuple[int, int]) -> SectorCI:
    """SectorCI instances keyed (N, particles): the host table build is
    seconds at the million-determinant shapes (N=28), and the device
    tables are cached on the instance, so a second solver in the process
    builds and sends nothing again."""
    key = (int(num_spin_orbitals), tuple(int(p) for p in num_particles))
    hit = _SECTOR_CI_CACHE.get(key)
    if hit is None:
        hit = _SECTOR_CI_CACHE[key] = SectorCI(*key)
    return hit


def _davidson_tol(dtype: torch.dtype) -> float:
    return 1e-9 if torch.finfo(dtype).bits >= 64 else 1e-6


def _new_stats() -> dict:
    """stage_stats of a CASSCF run: fused._loop_stats, Davidson solves and
    seconds (davidson spans: build_values and the diagonal included),
    matvecs and their seconds (davidson.sigma spans), and per solve its
    matvecs, final residual norm and how it ended: "converged" (rn < tol *
    max(1, |E|)), "stagnant" (the correction fell inside the subspace,
    below 64 eps) or "maxiter"."""
    return {"davidson_solves": 0, "davidson_matvecs": 0, "davidson_s": 0.0,
            "sigma_s": 0.0, "davidson_matvecs_per_solve": [],
            "davidson_residuals": [], "davidson_exits": [], **_loop_stats()}


def _operators(sector: SectorCI, tables: dict, h_act, g_act):
    """(mv, diag) of the sector Hamiltonian at the rotated integrals, its
    values and diagonal under the `davidson.build` span."""
    nB, nA = sector.nB, sector.nA
    with span("davidson.build"):
        h_so, g_so = expand_spin_tensors(h_act, g_act)
        vals = sector.build_values(h_so, g_so, tables)
        diag = sector.diagonal_values(vals, tables).reshape(-1)

    def mv(x):
        return sector.sigma_values(x.reshape(nB, nA), vals,
                                   tables).reshape(-1)

    return mv, diag


def _record(stats, matvecs0, es, rn, tol, iterations, maxiter):
    stats["davidson_matvecs_per_solve"].append(
        stats["davidson_matvecs"] - matvecs0)
    rn = float(rn)
    stats["davidson_residuals"].append(rn)
    if rn < tol * max(1.0, float(es.abs().max())):
        end = "converged"
    else:
        end = "maxiter" if iterations >= maxiter else "stagnant"
    stats["davidson_exits"].append(end)


def _stage_fns(sector: SectorCI, k: Optional[int], weights, max_subspace: int,
               davidson_maxiter: int, dtype: torch.dtype, tables: dict,
               stats: dict, chunk: Optional[int] = None, ladder: bool = False,
               solver_stats: Optional[dict] = None):
    """(solve, extract_rdms, final_solve) of the eigensolver stage.

    k=None, the ground state: solve(v, h_act, g_act) -> (v, E) by
    davidson_ground, or chunked by the k = 1 block machinery.  k states:
    solve(V, h_act, g_act) -> (V, es) by block Davidson, and
    extract_rdms(V) sums the states' RDMs with `weights`.  Chunked solves
    advance `chunk` iterations at a time, at 30x the tolerance in the
    loop when `ladder` (final_solve stays tight), and fill the JAX
    package's per-solve `solver_stats` lists when given (davidson_iters,
    solve_s, and finish_s, the final Rayleigh-Ritz; the JAX package's
    finish program also forms the RDMs)."""
    tight = _davidson_tol(dtype)
    nB, nA = sector.nB, sector.nA

    def solve_at(tol):
        def solve(warm, h_act, g_act):
            n0 = stats["davidson_matvecs"]
            with span("davidson", "davidson_s", "davidson_solves") as sp:
                mv, diag = _operators(sector, tables, h_act, g_act)
                if chunk is None and k is None:
                    res = davidson_ground(mv, diag, warm,
                                          max_subspace=max_subspace,
                                          maxiter=davidson_maxiter, tol=tol)
                elif chunk is None:
                    res = davidson_block(mv, diag, warm, k=k,
                                         max_subspace=max_subspace,
                                         maxiter=davidson_maxiter, tol=tol)
                else:
                    state = davidson_block_init(
                        mv, diag, warm.reshape(k or 1, -1), k=k or 1,
                        max_subspace=max_subspace, tol=tol)
                    while not state.stop and state.it < davidson_maxiter:
                        state = davidson_block_advance(mv, diag, state,
                                                       iters=chunk, tol=tol)
                    t1 = time.perf_counter()
                    res = davidson_block_finish(mv, diag, state, tol=tol)
                    if solver_stats is not None:
                        solver_stats["davidson_iters"].append(state.it)
                        solver_stats["solve_s"].append(t1 - sp.start)
                        solver_stats["finish_s"].append(
                            time.perf_counter() - t1)
            if chunk is None and k is None:
                _record(stats, n0, res.eigenvalue, res.residual_norm, tol,
                        res.iterations, davidson_maxiter)
                return res.eigenvector, res.eigenvalue
            _record(stats, n0, res.eigenvalues, res.residual_norm, tol,
                    res.iterations, davidson_maxiter)
            if k is None:
                return res.eigenvectors[0], res.eigenvalues[0]
            return res.eigenvectors, res.eigenvalues
        return solve

    def extract_rdms(v):
        if k is None:
            return sector.rdms(v.reshape(nB, nA), tables)
        return _weighted_rdms(sector, weights, v, tables)

    loose = tight * 30.0 if ladder else tight
    return solve_at(loose), extract_rdms, solve_at(tight)


class FusedOptOrbCASSCF(_OuterLoopSolver):
    """Orbital-optimized exact active-space diagonalization (CASSCF) as an
    eager loop on one device (see the module docstring).

    Keywords are esoo_tpu.orbital_optimization.FusedOptOrbCASSCF's, plus
    `device` ("cuda" by default; "cpu" runs the plain versions).  Davidson
    starts from the HF determinant, or from a resumed checkpoint's
    eigenvector when its size is the sector's.  Result fields follow
    FusedOptOrbResult; `optimal_point` holds the exact sector eigenvector
    and `stage_stats` where the run went (_new_stats)."""

    def __init__(self,
                 num_spin_orbitals: int,
                 problem=None,
                 integral_tensors=None,
                 num_particles: Optional[Tuple[int, int]] = None,
                 initial_partial_unitary=None,
                 maxiter: int = 20,
                 stopping_tolerance: float = 1e-5,
                 inner_stopping_tolerance: float = 1e-5,
                 inner_maxiter: int = 10000,
                 initial_BBstepsize: float = 1e-3,
                 decay_factor: float = 0.8,
                 max_subspace: int = 16,
                 davidson_maxiter: int = 200,
                 davidson_chunk: Optional[int] = None,
                 davidson_tol_ladder: bool = False,
                 dtype=None,
                 mesh=None,
                 dispatch: str = "one",
                 table_storage: str = "auto",
                 outer_loop_callback=None,
                 checkpoint_dir=None,
                 resume_from=None,
                 device="cuda"):
        self.device = dev = resolve_device(device)
        if table_storage not in ("auto", "dense", "compact"):
            raise ValueError(
                "table_storage must be 'auto', 'dense', or 'compact'")
        _check_mesh(mesh, dev)
        if num_particles is None:
            if problem is None or not hasattr(problem, "num_particles"):
                raise ValueError(
                    "num_particles is required when no problem carrying "
                    "it is given")
            num_particles = tuple(problem.num_particles)

        with span("construct.integrals", "construct_integrals_s"):
            h_sp, g_sp = _spatial_integrals(problem, integral_tensors,
                                            type(self).__name__)
            dtype = _to_dtype(dtype) or _to_dtype(h_sp.dtype)
            self.dtype = dtype
            self._set_integrals(h_sp, g_sp, dtype, mesh)

        self.num_spin_orbitals = num_spin_orbitals
        with span("construct.sector", "construct_sector_s"):
            self._sector = _sector_ci_cached(num_spin_orbitals,
                                             tuple(num_particles))
            storage = table_storage
            if storage == "auto":
                storage = ("compact" if self._sector.dim > _COMPACT_MIN_ND
                           else "dense")
            if mesh is not None:
                # the mesh composes with either storage: the operator
                # stacks sharded over the mesh, int8 for 'compact' (the
                # dense kernels' keys, each device casting only its own
                # shard)
                from ..parallel import shard_sector_tables
                self.table_storage = ("sharded" if storage == "dense"
                                      else "sharded-compact")
                self._sector_tables = shard_sector_tables(
                    mesh, self._sector, dtype, storage=storage)
            else:
                self.table_storage = storage
                # cached on the (cached) sector: a second solver sends
                # nothing
                self._sector_tables = self._sector.device_tables(
                    dtype, device=dev, storage=storage)

        self._v0 = self._sector.hf_matrix(dtype, device=dev).reshape(-1)
        if resume_from is not None:
            ck = load_checkpoint(resume_from)
            initial_partial_unitary = ck["partial_unitary"]
            v_ck = np.asarray(ck.get("optimal_point", ()), dtype=np.float64)
            if v_ck.size == self._sector.dim:
                self._v0 = torch.as_tensor(v_ck.reshape(-1),
                                           device=dev).to(dtype)

        m = h_sp.shape[0]
        n = num_spin_orbitals // 2
        if initial_partial_unitary is None:
            U0 = np.zeros((m, n))
            U0[np.arange(n), np.arange(n)] = 1.0
        else:
            U0 = np.asarray(initial_partial_unitary, dtype=np.float64)
        self._U0 = torch.as_tensor(U0, device=dev).to(dtype)

        self._set_outer_loop(maxiter, stopping_tolerance,
                             inner_stopping_tolerance, inner_maxiter,
                             initial_BBstepsize, decay_factor,
                             outer_loop_callback, checkpoint_dir)
        self.max_subspace = max_subspace
        self.davidson_maxiter = davidson_maxiter
        if dispatch not in ("one", "two"):
            raise ValueError("dispatch must be 'one' or 'two'")
        if davidson_chunk is not None:
            if dispatch != "two":
                raise ValueError(
                    "davidson_chunk requires dispatch='two' (it bounds "
                    "the per-dispatch eigensolver iterations with a "
                    "host-side loop)")
            if int(davidson_chunk) < 1:
                raise ValueError("davidson_chunk must be >= 1")
            davidson_chunk = int(davidson_chunk)
        self.davidson_chunk = davidson_chunk
        if davidson_tol_ladder and davidson_chunk is None:
            raise ValueError(
                "davidson_tol_ladder requires davidson_chunk (it ladders "
                "the tolerance across the bounded advance dispatches)")
        self.davidson_tol_ladder = bool(davidson_tol_ladder)
        self.dispatch = dispatch

    def compute_minimum_energy(self) -> FusedOptOrbResult:
        stats = self._run_stats(_new_stats())
        with torch.no_grad(), collect(stats):
            solve, extract_rdms, final_solve = _stage_fns(
                self._sector, None, None, self.max_subspace,
                self.davidson_maxiter, self.dtype, self._sector_tables, stats,
                chunk=self.davidson_chunk, ladder=self.davidson_tol_ladder)
            E, v, U, it, trace = self._loop(solve, extract_rdms, self._v0,
                                            stats, final_solve=final_solve)
            with span("diagnostics", "diagnostics_s"):
                occ, s2, g1, sd = (_numpy(x) for x in _state_diagnostics(
                    self._sector, v, self._sector_tables))
        return FusedOptOrbResult(
            eigenvalue=float(E),
            optimal_point=_numpy(v),
            optimal_partial_unitary=_numpy(U),
            energy_convergence_list=[float(e) for e in trace],
            outer_iterations=it,
            optimal_circuit=None,
            natural_occupations=occ,
            spin_squared=float(s2),
            one_rdm_spatial=g1,
            spin_density_spatial=sd,
            stage_stats=stats)


class FusedOptOrbSACASSCF(FusedOptOrbCASSCF):
    """State-averaged CASSCF: orbital optimization over the weighted sum
    of the k lowest exact sector eigenvalues (block Davidson), with
    weighted-sum convergence and weight-combined RDMs.

    Extra keywords: `k` (number of states) and `weight_vector`
    (orbital-update weights, default k, k-1, ..., 1).
    `compute_energies()` returns a FusedOptOrbEigensolverResult whose
    `optimal_point` holds the (k, nd) eigenvector block; a chunked
    two-dispatch run also leaves per-solve `stage_stats` lists on the
    solver, as the JAX package does."""

    def __init__(self, num_spin_orbitals: int, k: int = 2,
                 weight_vector=None, **kwargs):
        max_subspace = kwargs.pop("max_subspace", None)
        super().__init__(num_spin_orbitals, **kwargs)
        if k < 1 or k > self._sector.dim:
            raise ValueError(f"k={k} out of range for a "
                             f"{self._sector.dim}-determinant sector")
        self.k = int(k)
        self.max_subspace = (max_subspace if max_subspace is not None
                             else max(24, 4 * self.k))
        if self.max_subspace < 2 * self.k:
            raise ValueError("max_subspace must be >= 2k")
        if weight_vector is None:
            weight_vector = [self.k - i for i in range(self.k)]
        if len(weight_vector) != self.k:
            raise ValueError(f"weight_vector needs {self.k} entries")
        dev, dtype = self.device, self.dtype
        self._weights = torch.as_tensor(
            np.asarray(weight_vector, dtype=np.float64), device=dev).to(dtype)
        # seed: one-hot determinants at the k lowest diagonal entries of
        # the initial (U0-rotated) sector Hamiltonian; as in the JAX
        # package, the ground-state start vector takes its place when its
        # size is k * nd (k = 1: the HF or resumed vector)
        if self._v0.numel() == self.k * self._sector.dim:
            self._V0 = self._v0.reshape(self.k, self._sector.dim)
        else:
            with torch.no_grad():
                h_so, g_so = expand_spin_tensors(*self._rotate(
                    orth(self._U0)))
                vals = self._sector.build_values(h_so, g_so,
                                                 self._sector_tables)
                diag = _numpy(self._sector.diagonal_values(
                    vals, self._sector_tables)).reshape(-1)
            order = np.argsort(diag)[: self.k]
            V0 = np.zeros((self.k, self._sector.dim))
            V0[np.arange(self.k), order] = 1.0
            self._V0 = torch.as_tensor(V0, device=dev).to(dtype)

    def compute_minimum_energy(self):
        raise AttributeError(
            "FusedOptOrbSACASSCF computes k states — use "
            "compute_energies()")

    def compute_energies(self) -> FusedOptOrbEigensolverResult:
        stats = self._run_stats(_new_stats())
        solver_stats = None
        if self.dispatch == "two":
            solver_stats = {"davidson_iters": [], "solve_s": [],
                            "finish_s": [], "orb_s": []}
            self.stage_stats = solver_stats
        with torch.no_grad(), collect(stats):
            solve, extract_rdms, final_solve = _stage_fns(
                self._sector, self.k, self._weights, self.max_subspace,
                self.davidson_maxiter, self.dtype, self._sector_tables,
                stats, chunk=self.davidson_chunk,
                ladder=self.davidson_tol_ladder, solver_stats=solver_stats)
            es, V, U, it, trace = self._loop(solve, extract_rdms, self._V0,
                                             stats, weights=self._weights,
                                             final_solve=final_solve)
            if solver_stats is not None:
                # the JAX package times the loop's BB programs, not the
                # one after the last solve when the loop hits maxiter
                solver_stats["orb_s"] = stats["bb_s_per_call"][:it - 1]
            with span("diagnostics", "diagnostics_s"):
                occ, s2, g1, sd = (_numpy(x) for x in _states_diagnostics(
                    self._sector, V, self._sector_tables))
                t1 = _numpy(_transition_rdm1s(self._sector, V,
                                              self._sector_tables))
        return FusedOptOrbEigensolverResult(
            eigenvalues=_numpy(es),
            optimal_point=_numpy(V),
            optimal_partial_unitary=_numpy(U),
            energy_convergence_list=[float(e) for e in trace],
            outer_iterations=it,
            natural_occupations=occ,
            spin_squared=s2,
            one_rdm_spatial=g1,
            spin_density_spatial=sd,
            transition_rdm1_spatial=t1,
            stage_stats=stats)
