"""The fused OptOrb solvers on one device: FusedOptOrbVQE and the
excited-state family (FusedOptOrbSSVQE, FusedOptOrbMCVQE,
FusedOptOrbVQD, FusedOptOrbAdaptVQE).

Port of esoo_tpu/orbital_optimization/fused.py.  The JAX package compiles
each loop into one XLA program; here it is an eager Python loop over
device tensors, with the same stages and the same decisions:

    for each outer iteration:
        rotate the integrals at U          (CUDA: ops/gemm.py kernels)
        L-BFGS over theta of <psi(theta)|H(U)|psi(theta)>  (sector sim)
        string RDMs of the optimum, spin-reduced
        BB/Stiefel descent over U at fixed RDMs
        stop when |E - E_prev| < tol (keeping the U that produced E)
    re-solve at the final U, unconditionally

The eigensolver stage simulates either the particle-number sector
(sim/sector.py SectorUCC, `simulation='sector'`, what 'auto' picks for a
UCC-family circuit) or the full 2^N statevector (sim/statevector.py,
`simulation='full'`, and 'auto''s fallback for any other real-safe
circuit), whose energy is the direct RDM contraction of sim/rdm.py.
The excited-state solvers run the same loop with k states: SSVQE and
MCVQE push k initial states through one theta (one batched gate scan)
and minimize their weighted energy sum; VQD deflates state by state
(with one circuit per state on the full path); ADAPT regrows its ansatz
from scratch each outer iteration.  What follows the loop differs
by solver, as in the JAX package: VQE re-solves at the final U, VQD
reruns the deflation, ADAPT regrows, while SSVQE and MCVQE only evaluate
the last theta's energies at the final U.

`mesh=` (parallel.make_orbital_mesh) shards the m^4 integral tensor on
its last axis over the mesh's devices: the rotation of each outer
iteration and every BB step then run shard by shard and reduce on the
lead device (parallel/sharded.py).  On the string kernels the sector's
operator stacks shard too (parallel.shard_sector_tables): sigma, the RDMs
and the transition RDMs run over the shards (sim/sharded_strings.py),
while the gate scan stays on the lead device, as in the JAX package.  A
2-D mesh (parallel.make_orbital_state_mesh) splits SSVQE's and MCVQE's k
states into contiguous groups over its 'state' axis: group r runs its
gate scan and energies on state row r (over that row's table shards),
and the weighted energy sum and the combined RDMs are formed on the lead
device.  VQD gathers: it runs its states in sequence on the first row.

Every host decision (a stop test, a line-search branch) reads a device
scalar, so the loop syncs with the device several times per step.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import orbital_vag
from ..sim.circuit import QuantumCircuit
from ..sim.rdm import one_rdm, rdm_energy, two_rdm
from ..sim.statevector import compile_circuit
from ..solvers.lbfgs import LBFGSGraphs, lbfgs_minimize
from ..utils.config import check_same_device, resolve_device
from ..utils.profiling import collect, count, span
from .checkpoint import load_checkpoint, save_checkpoint
from .kernels import (expand_spin_tensors, rotate_one_body, rotate_two_body,
                      rotated_energy_spatial, rotated_integrals_spatial,
                      spatial_blocks, spin_blocks_consistent,
                      spin_reduce_rdms, spin_squared_from_rdms)
from .stiefel import _bb_loop, orth, value_and_grad


def _counted(vag: Callable, key: str) -> Callable:
    """vag, adding one to stage_stats[key] of the running solve a call."""
    def counted(U, *data):
        count(key)
        return vag(U, *data)
    return counted


# single source of truth for the orbital objective: autograd of the
# energy, or, where onepass_route holds, csrc/orbital_vag.cu's value and
# gradient in one pass over g (ops/orbital_vag.py)
_ORBITAL_VAG = _counted(value_and_grad(rotated_energy_spatial),
                        "bb_vag_autograd")
_ORBITAL_ONEPASS_VAG = _counted(orbital_vag.orbital_value_and_grad_cuda,
                                "bb_vag_onepass")


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
    # seconds of the construction and of each stage, from the spans of
    # utils/profiling.py (_vqe_stats, casscf._new_stats)
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
    # where the run went (FusedOptOrbResult.stage_stats)
    stage_stats: Optional[dict] = None

    @property
    def optimal_parameters(self):
        return self.optimal_point


def _inner_bb(vag_fn, U0, data, stepsize, tol, decay, maxiter,
              stats: Optional[dict] = None):
    """BB projected-gradient descent (the loop of stiefel.py) under the
    `outer.bb` span, which adds to `stats`, when given, bb_s, its bb.iter
    spans (bb_iterations) and its seconds in bb_s_per_call."""
    with collect(stats), span("outer.bb", "bb_s") as bb:
        U, _, _, _ = _bb_loop(vag_fn, U0, data, stepsize, tol, decay,
                              maxiter)
    if stats is not None:
        stats.setdefault("bb_s_per_call", []).append(bb.seconds)
    return U


def _vqe_stage_fns(sector, compiled, n_active: int, vqe_maxiter: int,
                   dtype: torch.dtype, ftol=None,
                   stats: Optional[dict] = None, tables=None):
    """(run_vqe, extract_rdms) for the eigensolver stage: in the sector
    (`sector`, over `tables`: a mesh's sector tables, or None for the
    lead device's own), or on the full statevector of `compiled` when
    `sector` is None.  A string-kernel sector's cost on the lead device's
    own tables (no mesh) is marked capture-safe: its solves replay CUDA
    graphs on a card, captured at the first and kept for the stage
    functions' life (solvers/lbfgs.py).  The other costs keep the eager
    loop, as a capture refuses what they do: the full statevector's
    copies host tables to the device at each call (sim/rdm.py, the
    constant gate matrices), and the pairs kernel's builds its gate
    records at its first call on a sector's tables, through host reads
    (ops/pair_scan.py::_stream)."""
    gtol = _gtol(dtype)
    N = 2 * n_active

    if sector is None:
        def vqe_energy(theta, h_so, g_so):
            return rdm_energy(compiled.state_fn(theta, dtype), h_so, g_so)

        def run_vqe(theta, h_act, g_act):
            res = _lbfgs(vqe_energy, theta,
                         expand_spin_tensors(h_act, g_act), vqe_maxiter,
                         gtol, ftol, stats)
            return res.x, res.fun

        def extract_rdms(theta):
            state = compiled.state_fn(theta, dtype)
            return one_rdm(state, N), two_rdm(state, N)

        return run_vqe, extract_rdms

    graphs = (LBFGSGraphs(sector.energy_values)
              if tables is None and sector.kernel == "strings" else None)

    def run_vqe(theta, h_act, g_act):
        vals = _sector_values(sector, h_act, g_act, tables)
        res = _lbfgs(sector.energy_values, theta, (vals, tables),
                     vqe_maxiter, gtol, ftol, stats, graphs)
        return res.x, res.fun

    def extract_rdms(theta):
        # sector-native RDMs: never touches the 2^N space
        return sector.rdms(sector.state_matrix(theta, tables), tables)

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


def _optorb_loop(solve: Callable, extract_rdms: Callable, state, U0,
                 rotate: Callable, orbital_vag: Callable, orbital_data,
                 outer_tol, inner_tol, bb_stepsize, decay,
                 outer_maxiter: int = 20, inner_maxiter: int = 10000,
                 weights: Optional[torch.Tensor] = None,
                 final_solve: Optional[Callable] = None,
                 callback: Optional[Callable] = None,
                 stats: Optional[dict] = None):
    """The OptOrb outer loop of every fused solver (esoo_tpu
    fused.py:499-574, casscf.py:119-174 and 639-696).

    rotate(U) -> (h_act, g_act) rotates the integrals;
    solve(state, h_act, g_act) -> (state, es) runs the eigensolver stage
    at them (es a scalar, or the (k,) energies whose `weights` sum the
    convergence rule reads); extract_rdms(state) -> spin-orbital (gamma,
    Gamma); the BB descent minimizes orbital_vag(U, gamma_s, Gamma_s,
    *orbital_data) (the integrals on one device, or a mesh's shards).
    The final re-solve runs `final_solve` (default `solve`).  Each stage
    runs under its span (utils/profiling.py): outer.rotate (rotate_s),
    outer.solve, outer.rdms (rdms_s), outer.bb (bb_s), and final_solve
    (final_solve_s, its rotation an outer.rotate too).  Returns
    (es, state, U, n_outer, energy_trace)."""
    trace = np.full((outer_maxiter,), np.nan)
    U = orth(U0)
    E_prev = torch.full((), float("inf"), dtype=U.dtype, device=U.device)
    it = 0
    while True:
        with span("outer.rotate", "rotate_s"):
            h_act, g_act = rotate(U)
        with span("outer.solve"):
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
        with span("outer.rdms", "rdms_s"):
            gamma, Gamma = extract_rdms(state)
            gamma_s, Gamma_s = spin_reduce_rdms(gamma, Gamma)
        U = _inner_bb(orbital_vag, U, (gamma_s, Gamma_s) + orbital_data,
                      bb_stepsize, inner_tol, decay, inner_maxiter, stats)
        if it >= outer_maxiter:
            break
        E_prev = E
    # re-solve at the final U so (E, state, U) are mutually consistent even
    # when the loop ended on hit_max (where U is the freshly rotated one)
    with span("final_solve", "final_solve_s"):
        with span("outer.rotate", "rotate_s"):
            h_act, g_act = rotate(U)
        state, es = (final_solve or solve)(state, h_act, g_act)
    return es, state, U, it, trace[:it]


def _state_diagnostics(sector, v: torch.Tensor, tables: dict = None):
    """_rdm_diagnostics of a sector state."""
    return _rdm_diagnostics(*sector.rdms(v.reshape(sector.state_shape),
                                         tables))


def _rdm_diagnostics(gamma: torch.Tensor, Gamma: torch.Tensor):
    """(natural occupations, <S^2>, spin-summed spatial 1-RDM, spatial
    spin density) from spin-orbital RDMs: the descending eigenvalues of
    the spin-summed 1-RDM (sum = n_alpha + n_beta) and the total spin
    (the JAX package's _rdm_diagnostics)."""
    gamma_s, _ = spin_reduce_rdms(gamma, Gamma)
    n = gamma.shape[0] // 2
    return (torch.flip(torch.linalg.eigvalsh(gamma_s), dims=(0,)),
            spin_squared_from_rdms(gamma, Gamma), gamma_s,
            gamma[:n, :n] - gamma[n:, n:])


def _states_diagnostics(sector, V: torch.Tensor, tables: dict = None):
    """_state_diagnostics of each of k states, stacked."""
    per = [_state_diagnostics(sector, v, tables) for v in V]
    return tuple(torch.stack(x) for x in zip(*per))


def _transition_rdm1s(sector, V: torch.Tensor,
                      tables: dict = None) -> torch.Tensor:
    """(k, k, n, n) spin-summed spatial transition 1-RDMs
    t[i, j, p, s] = <psi_i|E_ps|psi_j> between k sector states: one ket
    at a time, each against the whole bra stack."""
    Vg = V.reshape(-1, sector.nB, sector.nA)
    rows = []
    for vj in Vg:
        g = sector.transition_rdm1(Vg, vj, tables)
        n = g.shape[-1] // 2
        rows.append(g[:, :n, :n] + g[:, n:, n:])     # rows[j][i] = <i|E|j>
    return torch.stack(rows).transpose(0, 1)


def _attach_vqe_diagnostics(result, solver, theta):
    """Natural occupations, <S^2>, spatial 1-RDM and spin density of the
    optimal state (esoo_tpu fused.py:431-478), under the `diagnostics`
    span."""
    if not solver.diagnostics:
        return result
    with torch.no_grad(), span("diagnostics", "diagnostics_s"):
        if solver._sector is None:
            state = solver._compiled.state_fn(theta, solver.dtype)
            N = solver.num_spin_orbitals
            occ, s2, g1, sd = _rdm_diagnostics(one_rdm(state, N),
                                               two_rdm(state, N))
        else:
            tables = solver._sector_tables
            occ, s2, g1, sd = _state_diagnostics(
                solver._sector, solver._sector.state_matrix(theta, tables),
                tables)
        result.natural_occupations = _numpy(occ)
        result.spin_squared = float(s2)
        result.one_rdm_spatial = _numpy(g1)
        result.spin_density_spatial = _numpy(sd)
    return result


def _spatial_integrals(problem, integral_tensors, name: str):
    """Spatial (h, g) as NumPy arrays: from spin-orbital
    `integral_tensors` (spin-block structured), or from a problem's
    spatial_integral_tensors() or integral_tensors() (a qiskit-nature
    problem is adapted first, interop.py)."""
    from ..interop import adapt
    problem, _ = adapt(problem)
    if integral_tensors is not None:
        h_so, g_so = (np.asarray(a, dtype=np.float64)
                      for a in integral_tensors)
    elif problem is not None and hasattr(problem, "spatial_integral_tensors"):
        return tuple(a.detach().cpu().numpy() if torch.is_tensor(a)
                     else np.asarray(a)
                     for a in problem.spatial_integral_tensors())
    elif problem is not None:
        h_so, g_so = (np.asarray(a) for a in problem.integral_tensors())
    else:
        raise ValueError("either `problem` or `integral_tensors` required")
    if not spin_blocks_consistent(h_so, g_so):
        raise ValueError(f"{name} requires spin-block-structured integrals")
    return spatial_blocks(h_so, g_so)


def _compile_ansatz(ansatz):
    """The compiled circuit of a fused solver's ansatz.  The fused
    solvers contract RDMs directly from occupation-basis amplitudes,
    which only the Jordan-Wigner encoding keeps (a parity/BK-mapped
    ansatz would give a silently wrong energy), and simulate real-safe
    circuits only."""
    if not isinstance(ansatz, QuantumCircuit):
        raise TypeError(f"the ansatz must be a sim.circuit.QuantumCircuit; "
                        f"got {type(ansatz).__name__}")
    enc = getattr(ansatz, "_encoding", "jw")
    if enc != "jw":
        raise ValueError(
            f"fused solvers require a Jordan-Wigner-encoded ansatz; "
            f"got encoding {enc!r}")
    compiled = compile_circuit(ansatz)
    if not compiled.is_real:
        raise ValueError("fused path requires a real-safe ansatz")
    return compiled


def _sector_or_full(simulation: str, make_sector: Callable):
    """(made, simulation): what `make_sector()` builds (a SectorUCC, or
    one with its projected initial states) for 'sector' and 'auto', which
    resolves to the sector wherever the circuit permits, as in the JAX
    package (on the string kernels, or the pairwise kernels where the
    sector does not factorize over strings); or (None, 'full') for
    'full', and for 'auto' when the circuit or its initial states do not
    fit a sector (make_sector raises ValueError)."""
    if simulation == "full":
        return None, "full"
    try:
        return make_sector(), "sector"
    except ValueError:
        if simulation == "sector":
            raise
        return None, "full"


def _check_mesh(mesh, device) -> None:
    """A mesh must be an OrbitalMesh led by the solver's device, with an
    'orb' axis (and, on a 2-D mesh, a 'state' axis outside it)."""
    if mesh is None:
        return
    from ..parallel import OrbitalMesh
    if not isinstance(mesh, OrbitalMesh):
        raise TypeError(f"mesh must be an esoo_torch.parallel.OrbitalMesh "
                        f"(make_orbital_mesh); got {type(mesh).__name__}")
    if "orb" not in mesh.shape:
        raise ValueError(f"mesh has no 'orb' axis: {mesh.shape}")
    check_same_device("the solver", device, mesh=mesh)


def _place_on_mesh(mesh, h_sp: np.ndarray, g_sp: np.ndarray,
                   dtype: torch.dtype):
    """(h on the lead device, g's shards over the mesh) at `dtype`: g
    sharded on its last axis, each shard sent to its device alone.  The
    solvers take only a mesh whose size divides m, with the JAX package's
    message (parallel.shard_problem_tensors pads)."""
    from ..parallel import shard_problem_tensors
    d = mesh.shape["orb"]
    m = int(g_sp.shape[-1])
    if m % d:
        raise ValueError(
            f"spatial dimension {m} not divisible by mesh size {d}; pad the "
            f"basis or choose a divisor mesh")
    h, shards = shard_problem_tensors(mesh, h_sp, g_sp)
    return h.to(dtype), [s.to(dtype) for s in shards]


def _check_options(mesh, simulation: str, dispatch: str, device) -> None:
    _check_mesh(mesh, device)
    if simulation not in ("full", "sector", "auto"):
        raise ValueError("simulation must be 'full', 'sector' or 'auto'")
    # dispatch bounds the length of one compiled TPU program in the JAX
    # package; the eager loop has no programs to bound, so it is
    # validated and gives the dispatch='one' result
    if dispatch not in ("one", "two"):
        raise ValueError("dispatch must be 'one' or 'two'")


def _initial_partial_unitary(U0, m: int, n: int) -> np.ndarray:
    if U0 is None:
        U0 = np.zeros((m, n))
        U0[np.arange(n), np.arange(n)] = 1.0
    return np.asarray(U0, dtype=np.float64)


def _to_dtype(dtype) -> torch.dtype:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


_CONSTRUCT_KEYS = ("construct_s", "construct_integrals_s",
                   "construct_sector_s", "construct_ansatz_s")


class _Constructed(type):
    """The fused solvers' metaclass: a solver's whole construction,
    whatever chain of __init__ methods runs it, is one `construct` span,
    whose totals and its children's (construct.integrals: the integrals
    to the device at the solver's dtype; construct.sector: the sector and
    its tables; construct.ansatz: the compiled circuit) the solver keeps
    for its results' stage_stats."""

    def __call__(cls, *args, **kwargs):
        stats = dict.fromkeys(_CONSTRUCT_KEYS, 0.0)
        with collect(stats), span("construct", "construct_s"):
            solver = super().__call__(*args, **kwargs)
        solver._construct_stats = stats
        return solver


class _OuterLoopSolver(metaclass=_Constructed):
    """What every fused solver keeps of its outer loop: the stop rule, the
    BB settings, the callback and checkpoint directory, and `_loop`, the
    shared `_optorb_loop` at the solver's integrals and starting U."""

    def _run_stats(self, stats: dict) -> dict:
        """A run's stage_stats: `stats`, which its spans fill, with the
        constructor's span totals."""
        stats.update(self._construct_stats)
        return stats

    def _set_outer_loop(self, maxiter: int, stopping_tolerance: float,
                        inner_stopping_tolerance: float, inner_maxiter: int,
                        initial_BBstepsize: float, decay_factor: float,
                        outer_loop_callback, checkpoint_dir) -> None:
        if maxiter < 1:
            raise ValueError("maxiter must be >= 1 (the outer loop always "
                             "runs at least one eigensolver iteration)")
        self.maxiter = maxiter
        self.stopping_tolerance = stopping_tolerance
        self.inner_stopping_tolerance = inner_stopping_tolerance
        self.inner_maxiter = inner_maxiter
        self.initial_BBstepsize = initial_BBstepsize
        self.decay_factor = decay_factor
        self.outer_loop_callback = outer_loop_callback
        self.checkpoint_dir = checkpoint_dir

    def _set_integrals(self, h_sp: np.ndarray, g_sp: np.ndarray,
                       dtype: torch.dtype, mesh) -> None:
        """The spatial integrals at `dtype`: both on the solver's device
        (`_h_sp`, `_g_sp`), or, with a mesh, h on its lead device and g's
        shards over it (`_g_shards`; `_g_sp` is then None: no device
        holds the whole g).  `_g_pair_symmetric`: None until
        `_orbital_objective` checks g's pair symmetry (ops/orbital_vag.py),
        then whether g passed."""
        self.mesh = mesh
        self._g_shards = None
        self._g_pair_symmetric = None
        if mesh is None:
            dev = self.device
            self._h_sp = torch.as_tensor(np.ascontiguousarray(h_sp),
                                         device=dev).to(dtype)
            self._g_sp = torch.as_tensor(np.ascontiguousarray(g_sp),
                                         device=dev).to(dtype)
        else:
            self._h_sp, self._g_shards = _place_on_mesh(
                mesh, np.asarray(h_sp), np.asarray(g_sp), dtype)
            self._g_sp = None

    def _set_sector_tables(self) -> None:
        """`_sector_tables`: with a mesh and a string-kernel sector, its
        tables sharded over the mesh's 'orb' axis (each state row holding
        the shards on a 2-D mesh); else None (the pairs kernel and the
        full statevector keep the lead device's own tables, as in the
        JAX package)."""
        self._sector_tables = None
        sector = getattr(self, "_sector", None)
        if (self.mesh is not None and sector is not None
                and sector.kernel == "strings"):
            from ..parallel import shard_sector_tables
            self._sector_tables = shard_sector_tables(self.mesh, sector,
                                                      self.dtype)

    def _rotate(self, U: torch.Tensor):
        """(h_act, g_act): the integrals rotated at U (the K2 transform on
        one card, or each shard's K1 chain and a reduction on a mesh)."""
        h_act = rotate_one_body(self._h_sp, U)
        if self._g_shards is None:
            return h_act, rotate_two_body(self._g_sp, U)
        from ..parallel import rotate_two_body_sharded
        return h_act, rotate_two_body_sharded(self.mesh, self._g_shards, U)

    def _orbital_objective(self):
        """(value-and-grad, integral data) of the BB descent: on one
        device the one-pass kernel where `orbital_vag.onepass_route` holds
        for g and U0 (counted in stage_stats as bb_vag_onepass), else the
        autograd of the spatial energy; on a mesh the autograd of the
        sharded one (both counted as bb_vag_autograd).  g's pair symmetry
        is checked at the first call that could take the kernel, once per
        g."""
        if self._g_shards is None:
            g = self._g_sp
            route = functools.partial(orbital_vag.onepass_route, g.device,
                                      g.dtype, g.shape[0], self._U0.shape[1])
            if self._g_pair_symmetric is None and route(True):
                self._g_pair_symmetric = orbital_vag.pair_symmetric(g)
            if route(bool(self._g_pair_symmetric)):
                return _ORBITAL_ONEPASS_VAG, (self._h_sp, g)
            return _ORBITAL_VAG, (self._h_sp, g)
        from ..parallel import sharded_spatial_energy
        vag = getattr(self, "_sharded_vag", None)
        if vag is None:
            vag = self._sharded_vag = _counted(value_and_grad(
                sharded_spatial_energy(self.mesh)), "bb_vag_autograd")
        return vag, (self._h_sp, self._g_shards)

    def _loop(self, solve: Callable, extract_rdms: Callable, state0,
              stats: dict, weights: Optional[torch.Tensor] = None,
              final_solve: Optional[Callable] = None):
        """_optorb_loop from (state0, U0): (es, state, U, n_outer, trace)."""
        scalars = (torch.tensor(v, dtype=self.dtype, device=self.device)
                   for v in (self.stopping_tolerance,
                             self.inner_stopping_tolerance,
                             self.initial_BBstepsize, self.decay_factor))
        return _optorb_loop(
            solve, extract_rdms, state0, self._U0, self._rotate,
            *self._orbital_objective(),
            *scalars, outer_maxiter=self.maxiter,
            inner_maxiter=self.inner_maxiter, weights=weights,
            final_solve=final_solve,
            callback=_make_program_callback(self.outer_loop_callback,
                                            self.checkpoint_dir),
            stats=stats)


class FusedOptOrbVQE(_OuterLoopSolver):
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
        self.device = dev = resolve_device(device)
        self.diagnostics = bool(diagnostics)
        _check_options(mesh, simulation, dispatch, dev)
        with span("construct.ansatz", "construct_ansatz_s"):
            self._compiled = _compile_ansatz(ansatz)

        if resume_from is not None:
            ck = load_checkpoint(resume_from)
            initial_partial_unitary = ck["partial_unitary"]
            if "optimal_point" in ck:
                initial_point = ck["optimal_point"]
        with span("construct.integrals", "construct_integrals_s"):
            h_sp, g_sp = _spatial_integrals(problem, integral_tensors,
                                            type(self).__name__)
            dtype = _to_dtype(dtype) or _to_dtype(h_sp.dtype)
            self.dtype = dtype
            self._set_integrals(h_sp, g_sp, dtype, mesh)

        self.num_spin_orbitals = num_spin_orbitals
        self.ansatz = ansatz
        from ..sim.sector import SectorUCC
        with span("construct.sector", "construct_sector_s"):
            self._sector, self.simulation = _sector_or_full(
                simulation, lambda: SectorUCC(ansatz, num_spin_orbitals))
            self._set_sector_tables()

        self._U0 = torch.as_tensor(_initial_partial_unitary(
            initial_partial_unitary, h_sp.shape[0], num_spin_orbitals // 2),
            device=dev).to(dtype)
        if initial_point is None:
            initial_point = np.zeros(ansatz.num_parameters)
        self._theta0 = torch.as_tensor(
            np.asarray(initial_point, dtype=np.float64), device=dev).to(dtype)

        self._set_outer_loop(maxiter, stopping_tolerance,
                             inner_stopping_tolerance, inner_maxiter,
                             initial_BBstepsize, decay_factor,
                             outer_loop_callback, checkpoint_dir)
        self.vqe_maxiter = vqe_maxiter
        # eigensolver plateau-stop override (solvers/lbfgs.py `ftol`):
        # None = auto (32 ulp at f32, disabled at f64)
        self.vqe_ftol = vqe_ftol
        self.dispatch = dispatch
        if vqe_chunk is not None:
            if dispatch != "two":
                raise ValueError("vqe_chunk requires dispatch='two' (it "
                                 "bounds the per-dispatch eigensolver work)")
            if int(vqe_chunk) < 1:
                raise ValueError("vqe_chunk must be a positive iteration "
                                 "count")
        self.vqe_chunk = vqe_chunk

    def compute_minimum_energy(self) -> FusedOptOrbResult:
        stats = self._run_stats(_vqe_stats())
        with torch.no_grad(), collect(stats):
            return self._run(stats)

    def _run(self, stats: dict) -> FusedOptOrbResult:
        """The loop re-solves at the final U (VQE's tail)."""
        run_vqe, extract_rdms = _vqe_stage_fns(
            self._sector, self._compiled, self.num_spin_orbitals // 2,
            self.vqe_maxiter, self.dtype, ftol=self.vqe_ftol, stats=stats,
            tables=self._sector_tables)
        E, theta, U, it, trace = self._loop(run_vqe, extract_rdms,
                                            self._theta0, stats)
        return _attach_vqe_diagnostics(FusedOptOrbResult(
            eigenvalue=float(E),
            optimal_point=_numpy(theta),
            optimal_partial_unitary=_numpy(U),
            energy_convergence_list=[float(e) for e in trace],
            outer_iterations=it,
            optimal_circuit=self.ansatz,
            stage_stats=stats,
        ), self, theta)


def _loop_stats() -> dict:
    """stage_stats every fused solver's run fills from its spans: BB
    iterations (bb.iter) and seconds (outer.bb, and each call's), and the
    seconds of the rotations (outer.rotate), RDMs (outer.rdms), final
    solve and diagnostics; and the sigmas that went through the
    single-excitation lists (SectorCI.sigma_values; CASSCF on dense or
    int8 tables, 0 elsewhere); and the BB value-and-grads by route,
    bb_vag_onepass (csrc/orbital_vag.cu) and bb_vag_autograd."""
    return {"bb_iterations": 0, "bb_s": 0.0, "bb_s_per_call": [],
            "rotate_s": 0.0, "rdms_s": 0.0, "final_solve_s": 0.0,
            "diagnostics_s": 0.0, "sigma_list_matvecs": 0,
            "bb_vag_onepass": 0, "bb_vag_autograd": 0}


def _vqe_stats() -> dict:
    """stage_stats of the L-BFGS solvers: _loop_stats, L-BFGS iterations,
    value-and-grad evaluations (lbfgs.eval spans) and seconds (lbfgs
    spans), the evaluations by route (lbfgs_graph_evals: a replayed
    trial; lbfgs_eager_evals), and the CUDA-graph captures (lbfgs.capture
    spans: lbfgs_captures, lbfgs_capture_s)."""
    return {"lbfgs_iterations": 0, "lbfgs_evaluations": 0, "lbfgs_s": 0.0,
            "lbfgs_graph_evals": 0, "lbfgs_eager_evals": 0,
            "lbfgs_captures": 0, "lbfgs_capture_s": 0.0, **_loop_stats()}


def _lbfgs(cost, theta, args, vqe_maxiter, gtol, ftol, stats, graphs=None):
    """lbfgs_minimize under the `lbfgs` span (lbfgs_s), its iterations
    added to `stats`; `graphs` (an LBFGSGraphs of `cost`) marks the cost
    capture-safe."""
    with span("lbfgs", "lbfgs_s"):
        res = lbfgs_minimize(cost, theta, args=args, maxiter=vqe_maxiter,
                             gtol=gtol, ftol=ftol, graphs=graphs)
    if stats is not None:
        stats["lbfgs_iterations"] += res.nit
    return res


def _gtol(dtype: torch.dtype) -> float:
    return 1e-9 if torch.finfo(dtype).bits >= 64 else 1e-5


# -- the excited-state family -------------------------------------------------

def _state_vector(state, num_qubits: int) -> np.ndarray:
    """A real 2^N initial-state vector: a circuit's statevector (on the
    host, at the dtype policy's precision, as compile_circuit(st).state()
    in the JAX package) or a NumPy vector."""
    enc = getattr(state, "_encoding", "jw")
    if enc != "jw":
        raise ValueError(
            f"fused solvers require Jordan-Wigner-encoded initial states; "
            f"got encoding {enc!r}")
    if isinstance(state, QuantumCircuit):
        state = compile_circuit(state).state(device="cpu").numpy()
    elif not isinstance(state, np.ndarray):
        raise TypeError(
            f"initial state of type {type(state).__name__}: pass a "
            "sim.circuit.QuantumCircuit or a 2^N NumPy vector")
    if state.shape != (2 ** num_qubits,):
        raise ValueError(f"initial state vector has shape {state.shape}, "
                         f"expected ({2 ** num_qubits},)")
    if not np.allclose(np.imag(state), 0.0):
        raise ValueError("fused path requires real initial states")
    return np.real(state).astype(np.float64)


def _weighted_rdms(sector, weights: torch.Tensor, Vs: torch.Tensor,
                   tables: dict = None):
    """sum_i w_i (gamma_i, Gamma_i) over k sector states, one at a time."""
    gamma = Gamma = 0.0
    for w, v in zip(weights, Vs):
        g1, g2 = sector.rdms(v.reshape(sector.state_shape), tables)
        gamma = gamma + w * g1
        Gamma = Gamma + w * g2
    return gamma, Gamma


def _weighted_full_rdms(weights: torch.Tensor, states: torch.Tensor,
                        N: int):
    """sum_i w_i (gamma_i, Gamma_i) of k full statevectors (k, 2^N)."""
    return (torch.tensordot(weights, one_rdm(states, N), dims=1),
            torch.tensordot(weights, two_rdm(states, N), dims=1))


def _sector_values(sector, h_act, g_act, tables=None) -> dict:
    return sector.build_values(*expand_spin_tensors(h_act, g_act), tables)


def _state_groups(mesh, k: int, tables, lead) -> list:
    """The k states' groups over the 'state' axis of a 2-D mesh, as
    (device, slice of the k states, sector tables): group r is the r-th
    contiguous slice, on state row r's lead device, over that row's
    table shards (None where the sector keeps unsharded tables, which it
    then holds on each row's device).  Without a state axis, one group:
    every state on the lead device."""
    S = mesh.shape.get("state", 1) if mesh is not None else 1
    if k % S:
        raise ValueError(f"k={k} states not divisible by the state mesh "
                         f"axis ({S})")
    if S == 1:
        return [(lead, slice(None), tables)]
    D = len(mesh.devices) // S
    rows = tables.rows if tables is not None else (None,) * S
    return [(mesh.devices[r * D], slice(r * k // S, (r + 1) * k // S),
             rows[r]) for r in range(S)]


def _ssvqe_stage_fns(sector, compiled, n_active: int, init: torch.Tensor,
                     weights: torch.Tensor, groups: list, vqe_maxiter: int,
                     dtype: torch.dtype, ftol=None,
                     stats: Optional[dict] = None):
    """(run_ssvqe, state_energies, batch_rdms) of the SSVQE stage: the k
    initial states `init` (string matrices (k, nB, nA) in the sector, or
    (k, 2^N) statevectors through `compiled` when `sector` is None) go
    through one theta as one batched gate scan a state group
    (`groups`, from _state_groups).
    run_ssvqe minimizes the weighted energy sum and returns theta and the
    k energies (their weighted sum is the L-BFGS minimum); state_energies
    only evaluates them.  The energies and the weight-combined RDMs are
    gathered on the lead device."""
    gtol = _gtol(dtype)
    lead = init.device
    inits = [init[sl].to(dev) for dev, sl, _ in groups]

    def gathered(fn):
        """fn(j, device, tables) of each group, concatenated on the
        lead device."""
        outs = [fn(j, dev, tabs).to(lead)
                for j, (dev, _, tabs) in enumerate(groups)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def combined(fn):
        """The weighted RDMs fn(j, device, weights_j, tables) of each
        group, summed on the lead device."""
        from ..parallel.sharded import reduce_to
        parts = [fn(j, dev, weights[sl].to(dev), tabs)
                 for j, (dev, sl, tabs) in enumerate(groups)]
        return tuple(reduce_to(lead, list(x)) for x in zip(*parts))

    if sector is None:
        N = 2 * n_active

        def spread(h_act, g_act):
            h_so, g_so = expand_spin_tensors(h_act, g_act)
            return [(h_so.to(dev), g_so.to(dev)) for dev, _, _ in groups]

        def full_energies(theta, hg):
            return gathered(lambda j, dev, _: rdm_energy(
                compiled.apply_raw(inits[j], theta.to(dev)), *hg[j]))

        def full_state_energies(theta, h_act, g_act):
            return full_energies(theta, spread(h_act, g_act))

        def run_full(theta, h_act, g_act):
            hg = spread(h_act, g_act)
            res = _lbfgs(lambda th: weights @ full_energies(th, hg), theta,
                         (), vqe_maxiter, gtol, ftol, stats)
            return res.x, full_energies(res.x, hg)

        def full_rdms(theta):
            return combined(lambda j, dev, w, _: _weighted_full_rdms(
                w, compiled.apply_raw(inits[j], theta.to(dev)), N))

        return run_full, full_state_energies, full_rdms

    def values(h_act, g_act):
        return [_sector_values(sector, h_act.to(dev), g_act.to(dev), tabs)
                for dev, _, tabs in groups]

    def energies(theta, vals):
        return gathered(lambda j, dev, tabs: sector.quadform_values(
            sector.apply_matrix(inits[j], theta.to(dev), tabs), vals[j],
            tabs))

    def state_energies(theta, h_act, g_act):
        return energies(theta, values(h_act, g_act))

    def run_ssvqe(theta, h_act, g_act):
        vals = values(h_act, g_act)
        res = _lbfgs(lambda th: weights @ energies(th, vals), theta, (),
                     vqe_maxiter, gtol, ftol, stats)
        return res.x, energies(res.x, vals)

    def batch_rdms(theta):
        return combined(lambda j, dev, w, tabs: _weighted_rdms(
            sector, w, sector.apply_matrix(inits[j], theta.to(dev), tabs),
            tabs))

    return run_ssvqe, state_energies, batch_rdms


def _vqd_stage_fns(sector, applies, n_active: int, init: torch.Tensor,
                   betas: torch.Tensor, weights: torch.Tensor,
                   vqe_maxiter: int, dtype: torch.dtype, ftol=None,
                   stats: Optional[dict] = None, tables=None):
    """(run_vqd, batch_rdms) of the sequential-deflation stage: state j
    minimizes E_j + sum_{i<j} betas[i] <psi_i|psi_j>^2 against the states
    already found in this call, then reports its deflation-free energy.
    On the full path (`sector` None) state j is applies[j] = (apply, P),
    its circuit applied to init[j] at the leading P entries of its theta
    row (rows are end-padded to the widest circuit; the pad's gradient is
    exactly zero, so L-BFGS never moves it)."""
    gtol = _gtol(dtype)
    k = init.shape[0]

    if sector is None:
        N = 2 * n_active

        def state(j, theta):
            apply, P = applies[j]
            return apply(init[j], theta[:P])

        def run_full(thetas, h_act, g_act):
            h_so, g_so = expand_spin_tensors(h_act, g_act)
            thetas = thetas.clone()
            prev, es = [], []

            def deflated(theta, j, P):
                s = state(j, theta)
                e = rdm_energy(s, h_so, g_so)
                if j == 0:
                    return e
                ov = P @ s
                return e + torch.sum(betas[:j] * ov * ov)

            for j in range(k):
                P = torch.stack(prev) if prev else None
                res = _lbfgs(deflated, thetas[j], (j, P), vqe_maxiter, gtol,
                             ftol, stats)
                thetas[j] = res.x
                s = state(j, res.x)
                prev.append(s)
                es.append(rdm_energy(s, h_so, g_so))
            return thetas, torch.stack(es)

        def full_rdms(thetas):
            return _weighted_full_rdms(
                weights, torch.stack([state(j, th)
                                      for j, th in enumerate(thetas)]), N)

        return run_full, full_rdms

    def run_vqd(thetas, h_act, g_act):
        vals = _sector_values(sector, h_act, g_act, tables)
        thetas = thetas.clone()
        prev, es = [], []

        def deflated(theta, j, P):
            V = sector.apply_matrix(init[j], theta, tables)
            e = sector.quadform_values(V, vals, tables)
            if j == 0:
                return e
            ov = P @ V.reshape(-1)
            return e + torch.sum(betas[:j] * ov * ov)

        for j in range(k):
            P = torch.stack(prev).flatten(1) if prev else None
            res = _lbfgs(deflated, thetas[j], (j, P), vqe_maxiter, gtol,
                         ftol, stats)
            thetas[j] = res.x
            V = sector.apply_matrix(init[j], res.x, tables)
            prev.append(V)
            es.append(sector.quadform_values(V, vals, tables))
        return thetas, torch.stack(es)

    def batch_rdms(thetas):
        return _weighted_rdms(sector, weights, torch.stack(
            [sector.apply_matrix(v, th, tables)
             for v, th in zip(init, thetas)]), tables)

    return run_vqd, batch_rdms


class FusedOptOrbSSVQE(_OuterLoopSolver):
    """Excited-state OptOrb loop with the SSVQE eigensolver: k orthonormal
    initial states through one ansatz, minimizing the weighted sum of
    their energies; orbitals descend on the weight-combined RDMs.

    Keywords are esoo_tpu.orbital_optimization.FusedOptOrbSSVQE's plus
    `device`.  Initial states are circuits or real 2^N NumPy vectors; the
    sector is inferred from the first state's dominant determinant, and
    with simulation='auto' states that do not all lie in it (or an ansatz
    the sector cannot take) run on the full statevector."""

    _requires_orthogonal_inits = True   # VQD relaxes this

    def __init__(self,
                 num_spin_orbitals: int,
                 ansatz,
                 initial_states,
                 weight_vector=None,
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
                 vqe_maxiter: int = 300,
                 vqe_ftol: float = None,
                 dtype=None,
                 mesh=None,
                 simulation: str = "auto",
                 dispatch: str = "one",
                 outer_loop_callback=None,
                 checkpoint_dir=None,
                 resume_from=None,
                 diagnostics: bool = True,
                 _spatial_tensors=None,
                 device="cuda"):
        self.device = dev = resolve_device(device)
        self.diagnostics = bool(diagnostics)
        _check_options(mesh, simulation, dispatch, dev)
        with span("construct.ansatz", "construct_ansatz_s"):
            self._compiled = _compile_ansatz(ansatz)
        with span("construct.integrals", "construct_integrals_s"):
            h_sp, g_sp = (_spatial_tensors if _spatial_tensors is not None
                          else _spatial_integrals(problem, integral_tensors,
                                                  type(self).__name__))
            dtype = _to_dtype(dtype) or _to_dtype(h_sp.dtype)
            self.dtype = dtype
            self._set_integrals(h_sp, g_sp, dtype, mesh)
        self.num_spin_orbitals = N = num_spin_orbitals
        self.ansatz = ansatz

        V = np.stack([_state_vector(st, N) for st in initial_states])
        if self._requires_orthogonal_inits:
            if np.abs(V @ V.T - np.eye(len(V))).max() > 1e-8:
                raise ValueError(
                    "initial states must be mutually orthonormal (SSVQE's "
                    "weighted-sum variational argument requires it)")
        self.k = len(initial_states)
        # the sector of the first state's dominant determinant; every
        # state must lie in it (project_full raises otherwise)
        from ..sim.sector import SectorUCC
        nsp = N // 2
        lead = int(np.argmax(np.abs(V[0])))
        parts = (bin(lead & ((1 << nsp) - 1)).count("1"),
                 bin(lead >> nsp).count("1"))

        def make_sector():
            sec = SectorUCC(ansatz, N, num_particles=parts)
            return sec, np.stack([sec.project_full(v) for v in V])

        with span("construct.sector", "construct_sector_s"):
            found, self.simulation = _sector_or_full(simulation,
                                                     make_sector)
            if found is None:
                self._sector = None
                self._init = torch.as_tensor(V, device=dev).to(dtype)
            else:
                sec, init = found
                self._sector = sec
                self._init = torch.as_tensor(sec.to_native(init),
                                             device=dev).to(dtype)
            self._set_sector_tables()
        self._groups = _state_groups(mesh, self.k, self._sector_tables, dev)
        if weight_vector is None:
            weight_vector = [self.k - i for i in range(self.k)]
        self._weights = torch.as_tensor(
            np.asarray(weight_vector, dtype=np.float64), device=dev).to(dtype)

        if resume_from is not None:
            ck = load_checkpoint(resume_from)
            initial_partial_unitary = ck["partial_unitary"]
            if "optimal_point" in ck:
                initial_point = ck["optimal_point"]
        self._U0 = torch.as_tensor(_initial_partial_unitary(
            initial_partial_unitary, h_sp.shape[0], nsp), device=dev).to(dtype)
        if initial_point is None:
            initial_point = np.zeros(ansatz.num_parameters)
        self._theta0 = torch.as_tensor(
            np.asarray(initial_point, dtype=np.float64), device=dev).to(dtype)

        self._set_outer_loop(maxiter, stopping_tolerance,
                             inner_stopping_tolerance, inner_maxiter,
                             initial_BBstepsize, decay_factor,
                             outer_loop_callback, checkpoint_dir)
        self.vqe_maxiter = vqe_maxiter
        self.vqe_ftol = vqe_ftol
        self.dispatch = dispatch

    def _stage(self, stats: dict):
        """(solve, extract_rdms, final_solve) of the outer loop.  SSVQE's
        tail evaluates the last theta's energies at the final U; it does
        not optimize again."""
        run, state_energies, batch_rdms = _ssvqe_stage_fns(
            self._sector, self._compiled, self.num_spin_orbitals // 2,
            self._init, self._weights, self._groups, self.vqe_maxiter,
            self.dtype, ftol=self.vqe_ftol, stats=stats)
        return run, batch_rdms, \
            lambda theta, h, g: (theta, state_energies(theta, h, g))

    def _theta_start(self) -> torch.Tensor:
        return self._theta0

    def _eigenstates(self, thetas: torch.Tensor) -> torch.Tensor:
        """(k, nB, nA): each initial state through the optimized ansatz
        (on the lead device, over the first state row's tables)."""
        return self._sector.apply_matrix(self._init, thetas,
                                         self._sector_tables)

    def _run(self, stats: dict):
        """The outer loop: (energies, thetas, U, n_outer, trace, stats)."""
        solve, extract_rdms, final_solve = self._stage(stats)
        es, thetas, U, it, trace = self._loop(
            solve, extract_rdms, self._theta_start(), stats,
            weights=self._weights, final_solve=final_solve)
        return es, thetas, U, it, trace, stats

    def _result(self, es, thetas, U, it, trace, stats, mix=None):
        """The result with its transition RDMs and, when `diagnostics`,
        the per-state diagnostics; `mix` (k, k) re-expresses the
        eigenstates as mix[:, I]-weighted combinations of the raw states
        (MCVQE's contracted basis).  A full-space run carries neither, and
        nor does a sector on the pairs kernel (None, as in the JAX
        package: transition RDMs need the string kernel)."""
        if self._sector is None or self._sector.kernel != "strings":
            return FusedOptOrbEigensolverResult(
                eigenvalues=_numpy(es), optimal_point=_numpy(thetas),
                optimal_partial_unitary=_numpy(U),
                energy_convergence_list=[float(e) for e in trace],
                outer_iterations=it, stage_stats=stats)
        states = self._eigenstates(thetas)
        t1 = _numpy(_transition_rdm1s(self._sector, states,
                                      self._sector_tables))
        if mix is not None:
            # |I> = sum_a mix[a, I] |raw_a>, orthonormal raw states
            t1 = np.einsum("ai,bj,abps->ijps", mix, mix, t1, optimize=True)
            states = (torch.as_tensor(mix, device=states.device).to(
                states.dtype).T @ states.flatten(1)).reshape(states.shape)
        result = FusedOptOrbEigensolverResult(
            eigenvalues=_numpy(es),
            optimal_point=_numpy(thetas),
            optimal_partial_unitary=_numpy(U),
            energy_convergence_list=[float(e) for e in trace],
            outer_iterations=it,
            transition_rdm1_spatial=t1,
            stage_stats=stats)
        if self.diagnostics:
            occ, s2, g1, sd = _states_diagnostics(self._sector, states,
                                                  self._sector_tables)
            (result.natural_occupations, result.spin_squared,
             result.one_rdm_spatial, result.spin_density_spatial) = (
                _numpy(occ), _numpy(s2), _numpy(g1), _numpy(sd))
        return result

    def compute_energies(self) -> FusedOptOrbEigensolverResult:
        stats = self._run_stats(_vqe_stats())
        with torch.no_grad(), collect(stats):
            out = self._run(stats)
            with span("diagnostics", "diagnostics_s"):
                return self._result(*out)


class FusedOptOrbMCVQE(FusedOptOrbSSVQE):
    """MCVQE: the SSVQE loop from the k lowest CIS (excitations='s') or
    CISD ('sd') states of the integrals rotated at the initial U, then
    the contracted-Hamiltonian post-processing at the final (theta, U):
    H_ii = E_i and H_ij = (E_+ - E_-)/2 with (|i> +- |j>)/sqrt(2) pushed
    through the ansatz, all k + k(k-1) energies evaluated in the sector in
    one batched call.  Eigenvalues, transition RDMs and diagnostics are
    those of the contracted eigenstates."""

    def __init__(self, num_spin_orbitals: int, ansatz, num_particles,
                 k: int = 2, excitations: str = "s", weight_vector=None,
                 problem=None, integral_tensors=None, **kwargs):
        from ..initializations.ci import get_CIS_states, get_CISD_states
        with span("construct.integrals", "construct_integrals_s"):
            h_sp, g_sp = _spatial_integrals(problem, integral_tensors,
                                            "FusedOptOrbMCVQE")
        n = num_spin_orbitals // 2
        U0 = torch.as_tensor(_initial_partial_unitary(
            kwargs.get("initial_partial_unitary"), h_sp.shape[0], n))
        h_act, g_act = rotated_integrals_spatial(
            U0, torch.as_tensor(np.asarray(h_sp, dtype=np.float64)),
            torch.as_tensor(np.asarray(g_sp, dtype=np.float64)))
        h_so, g_so = expand_spin_tensors(h_act, g_act)
        get = get_CIS_states if excitations == "s" else get_CISD_states
        states = get(h_so.numpy(), g_so.numpy(), num_particles,
                     state_representation="dense")
        if len(states) < k:
            raise ValueError(f"CI produced {len(states)} states < k={k}")
        self._ci_vectors = [np.real(np.asarray(s)) for s in states[:k]]
        super().__init__(num_spin_orbitals, ansatz, self._ci_vectors,
                         weight_vector=weight_vector,
                         _spatial_tensors=(h_sp, g_sp), **kwargs)

    def _contracted_energies(self, theta: torch.Tensor,
                             U: torch.Tensor) -> np.ndarray:
        """The k raw energies, then E_+ and E_- of each pair i < j, of
        the CI vectors pushed through the ansatz at theta, under H(U)."""
        vecs = self._ci_vectors
        batch = list(vecs)
        for i in range(self.k):
            for j in range(i + 1, self.k):
                batch.append((vecs[i] + vecs[j]) / np.sqrt(2))
                batch.append((vecs[i] - vecs[j]) / np.sqrt(2))
        sec = self._sector
        h_act, g_act = self._rotate(U)
        if sec is None:
            V0 = torch.as_tensor(np.stack(batch),
                                 device=self.device).to(self.dtype)
            return _numpy(rdm_energy(self._compiled.apply_raw(V0, theta),
                                     *expand_spin_tensors(h_act, g_act)))
        stack = np.stack([sec.project_full(v) for v in batch])
        V0 = torch.as_tensor(sec.to_native(stack),
                             device=self.device).to(self.dtype)
        tabs = self._sector_tables
        vals = _sector_values(sec, h_act, g_act, tabs)
        return _numpy(sec.quadform_values(sec.apply_matrix(V0, theta, tabs),
                                          vals, tabs))

    def compute_energies(self) -> FusedOptOrbEigensolverResult:
        stats = self._run_stats(_vqe_stats())
        with torch.no_grad(), collect(stats):
            es, theta, U, it, trace, stats = self._run(stats)
            E = self._contracted_energies(theta, U)
            kk = self.k
            Hc = np.diag(E[:kk]).astype(np.float64)
            pairs = [(i, j) for i in range(kk) for j in range(i + 1, kk)]
            for idx, (i, j) in enumerate(pairs):
                Hc[i, j] = Hc[j, i] = 0.5 * (E[kk + 2 * idx]
                                             - E[kk + 2 * idx + 1])
            w, Cc = np.linalg.eigh(Hc)
            with span("diagnostics", "diagnostics_s"):
                result = self._result(es, theta, U, it, trace, stats,
                                      mix=Cc)
        result.eigenvalues = w
        return result


class FusedOptOrbVQD(FusedOptOrbSSVQE):
    """Excited-state OptOrb loop with VQD: sequential beta-penalized
    deflation over the k states (state j's penalty reads states < j), each
    state with its own theta row; orbitals descend on the weight-combined
    RDMs.  The default beta is the 1-norm of the U0-rotated integrals plus
    10.  `ansatz` may be a list of k per-state circuits (the reference
    VQD's feature); they run on the full statevector (simulation 'auto'
    or omitted resolves to 'full', 'sector' raises), with parameter rows
    end-padded to the widest circuit (`optimal_point` row i holds ansatz
    i's parameters in its leading slice)."""

    _requires_orthogonal_inits = False  # deflation separates the states

    def __init__(self, num_spin_orbitals: int, ansatz, initial_states,
                 betas=None, weight_vector=None, **kwargs):
        ansatz_list = None
        if isinstance(ansatz, (list, tuple)):
            ansatz_list = list(ansatz)
            if len(ansatz_list) != len(initial_states):
                raise ValueError(
                    f"need one ansatz per state: got {len(ansatz_list)} "
                    f"ansatze for {len(initial_states)} initial states")
            if kwargs.get("simulation", "auto") == "sector":
                raise ValueError(
                    "per-state ansatze require simulation='full'")
            # the sector takes one excitation table: 'auto' would
            # simulate every state with ansatz_list[0]'s circuit
            kwargs["simulation"] = "full"
            user_point = kwargs.pop("initial_point", None)
            ansatz = ansatz_list[0]
        super().__init__(num_spin_orbitals, ansatz, initial_states,
                         weight_vector=weight_vector, **kwargs)
        self._applies = [(self._compiled.apply_raw,
                          ansatz.num_parameters)] * self.k
        if ansatz_list is not None:
            with span("construct.ansatz", "construct_ansatz_s"):
                self._applies = [(_compile_ansatz(a).apply_raw,
                                  a.num_parameters) for a in ansatz_list]
            self._theta0 = torch.as_tensor(
                _per_state_points(user_point, ansatz_list),
                device=self.device).to(self.dtype)
            self._ansatz_list = ansatz_list
        if betas is None:
            # deflation works when beta exceeds the energy gap: a bound
            # from the integrals at the starting partial unitary
            with torch.no_grad():
                h0, g0 = self._rotate(self._U0)
                bound = float(torch.sum(torch.abs(h0))
                              + torch.sum(torch.abs(g0))) + 10.0
            betas = [bound] * (self.k - 1)
        if len(betas) < self.k - 1:
            raise ValueError("betas must have length k-1")
        self._betas = torch.as_tensor(
            np.asarray(betas[: self.k - 1], dtype=np.float64),
            device=self.device).to(self.dtype)

    def _stage(self, stats: dict):
        """VQD's tail reruns the deflation at the final U."""
        run, batch_rdms = _vqd_stage_fns(
            self._sector, self._applies, self.num_spin_orbitals // 2,
            self._init, self._betas, self._weights, self.vqe_maxiter,
            self.dtype, ftol=self.vqe_ftol, stats=stats,
            tables=self._sector_tables)
        return run, batch_rdms, None

    def _theta_start(self) -> torch.Tensor:
        th = self._theta0
        return th if th.dim() == 2 else th.expand(self.k, -1).clone()

    def _eigenstates(self, thetas: torch.Tensor) -> torch.Tensor:
        return torch.stack([self._sector.apply_matrix(v, th,
                                                      self._sector_tables)
                            for v, th in zip(self._init, thetas)])


def _per_state_points(user_point, ansatz_list) -> np.ndarray:
    """(k, max P) starting thetas of per-state VQD circuits: zeros, or the
    user's vector(s) in each row's leading slice."""
    k = len(ansatz_list)
    theta0 = np.zeros((k, max(a.num_parameters for a in ansatz_list)))
    if user_point is None:
        return theta0
    pts = (user_point if isinstance(user_point[0], (list, tuple, np.ndarray))
           else [user_point] * k)
    if len(pts) != k:
        raise ValueError(f"initial_point must provide one vector per state: "
                         f"got {len(pts)} for k={k}")
    for i, (p, a) in enumerate(zip(pts, ansatz_list)):
        p = np.asarray(p, dtype=np.float64)
        if p.shape[0] != a.num_parameters:
            raise ValueError(f"initial point {i} has {p.shape[0]} values "
                             f"for a {a.num_parameters}-parameter ansatz")
        theta0[i, : p.shape[0]] = p
    return theta0


def _append_group(circuit: QuantumCircuit, group) -> QuantumCircuit:
    """Append one excitation rotation group with a fresh parameter (the
    port's copy of esoo_tpu/solvers/adapt_vqe.py::_append_group)."""
    theta = circuit.parameter()
    for x, z, w in group:
        circuit.pauli_rot(theta * (-2.0 * w), x, z)
    return circuit


def _adapt_stage_fns(sector, compiled, n_active: int, R: int, P: int,
                     vqe_maxiter: int, dtype: torch.dtype,
                     grad_tol: torch.Tensor, eig_tol: torch.Tensor,
                     ftol=None, stats: Optional[dict] = None, tables=None):
    """(run_adapt, extract_rdms) of the ADAPT stage: growth by masking
    over R slots of the P-excitation pool (theta has R*P entries,
    unselected ones pinned to zero).  Each growth step screens slot r's
    pool by the raw gradient at the current theta, sets the mask bit of
    the largest, and re-optimizes the selected angles; growth stops on
    the gradient threshold, on an immediate repeat selection, or on an
    energy gain below the eigenvalue threshold."""
    gtol = _gtol(dtype)
    N = 2 * n_active

    def make_energy(h_act, g_act):
        if sector is None:
            h_so, g_so = expand_spin_tensors(h_act, g_act)
            return lambda theta: rdm_energy(compiled.state_fn(theta, dtype),
                                            h_so, g_so)
        vals = _sector_values(sector, h_act, g_act, tables)
        return lambda theta: sector.energy_values(theta, vals, tables)

    def run_adapt(h_act, g_act):
        energy = make_energy(h_act, g_act)

        def masked(theta, mask):
            return energy(theta * mask)

        energy_vag = value_and_grad(energy)
        dev = h_act.device
        theta = torch.zeros(R * P, dtype=dtype, device=dev)
        mask = torch.zeros(R * P, dtype=dtype, device=dev)
        E = energy(theta)
        prev = -1
        for r in range(R):
            _, grad = energy_vag(theta)
            pg = torch.abs(grad[r * P:(r + 1) * P])
            best = int(torch.argmax(pg))
            if bool(pg[best] < grad_tol) or (r > 0 and best == prev):
                break
            mask = mask.clone()
            mask[r * P + best] = 1.0
            res = _lbfgs(masked, theta, (mask,), vqe_maxiter, gtol, ftol,
                         stats)
            theta = res.x * mask
            small_gain = r > 0 and bool(torch.abs(res.fun - E) < eig_tol)
            E, prev = res.fun, best
            if small_gain:
                break
        return theta, mask, E

    def extract_rdms(theta):
        if sector is None:
            state = compiled.state_fn(theta, dtype)
            return one_rdm(state, N), two_rdm(state, N)
        return sector.rdms(sector.state_matrix(theta, tables), tables)

    return run_adapt, extract_rdms


class FusedOptOrbAdaptVQE(FusedOptOrbVQE):
    """OptOrb loop with an ADAPT-VQE eigensolver: the ansatz regrows from
    scratch each outer iteration by masking over a padded UCC ansatz
    whose excitation list is the pool repeated R times (see
    _adapt_stage_fns).  Keywords beyond FusedOptOrbVQE's:
    gradient_threshold and eigenvalue_threshold end the growth,
    max_adapt_iterations is R (default: the pool size).  The result
    carries `selection_mask` (R*P,)."""

    def __init__(self, num_spin_orbitals: int, ansatz,
                 gradient_threshold: float = 1e-5,
                 eigenvalue_threshold: float = 1e-5,
                 max_adapt_iterations: Optional[int] = None,
                 **kwargs):
        if kwargs.get("vqe_chunk") is not None:
            raise ValueError("vqe_chunk is not supported by "
                             "FusedOptOrbAdaptVQE (the ADAPT growth loop "
                             "is one program; use FusedOptOrbVQE for "
                             "chunked eigensolver dispatches)")
        pool = getattr(ansatz, "_ucc_pool", None)
        if pool is None:
            raise ValueError(
                "FusedOptOrbAdaptVQE requires an ansatz built by "
                "sim.ansatz.UCC/UCCSD (carrying its excitation pool)")
        initial = getattr(ansatz, "_ucc_initial_state", None)
        self._P = len(pool)
        self._R = min(max_adapt_iterations or self._P, self._P)
        padded = (initial.copy() if initial is not None
                  else QuantumCircuit(num_spin_orbitals))
        if padded.num_parameters:
            raise ValueError("AdaptVQE initial state must be parameter-free")
        with span("construct.ansatz", "construct_ansatz_s"):
            for _ in range(self._R):
                for group in pool:
                    _append_group(padded, group)
        # the padded circuit is itself UCC-family (pool groups repeated R
        # times, parameter k <-> excitation k): the sector can take it
        excs = getattr(ansatz, "_ucc_excitations", None)
        if excs is not None and len(excs) == self._P:
            padded._ucc_excitations = list(excs) * self._R
            padded._ucc_initial_state = initial
        super().__init__(num_spin_orbitals, padded, **kwargs)
        self.gradient_threshold = gradient_threshold
        self.eigenvalue_threshold = eigenvalue_threshold

    def _run(self, stats: dict) -> FusedOptOrbResult:
        thresholds = (torch.tensor(t, dtype=self.dtype, device=self.device)
                      for t in (self.gradient_threshold,
                                self.eigenvalue_threshold))
        run_adapt, extract_rdms = _adapt_stage_fns(
            self._sector, self._compiled, self.num_spin_orbitals // 2,
            self._R, self._P, self.vqe_maxiter, self.dtype, *thresholds,
            ftol=self.vqe_ftol, stats=stats, tables=self._sector_tables)
        masks = []

        def solve(_, h_act, g_act):
            # regrown from scratch: the previous theta is not read
            theta, mask, E = run_adapt(h_act, g_act)
            masks.append(mask)
            return theta, E

        E, theta, U, it, trace = self._loop(
            solve, extract_rdms, self._theta0.new_zeros(self._R * self._P),
            stats)
        result = FusedOptOrbResult(
            eigenvalue=float(E),
            optimal_point=_numpy(theta),
            optimal_partial_unitary=_numpy(U),
            energy_convergence_list=[float(e) for e in trace],
            outer_iterations=it,
            optimal_circuit=self.ansatz,
            stage_stats=stats)
        result.selection_mask = _numpy(masks[-1])
        return _attach_vqe_diagnostics(result, self, theta)
