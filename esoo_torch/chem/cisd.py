"""CISD: configuration interaction with singles and doubles (+Q).

Copy of esoo_tpu/chem/cisd.py (host NumPy).

Completes the CI rung of the classical method ladder between MP2 and
CCSD, reusing the package's Slater-Condon machinery
(initializations/ci.py — the same determinant convention every solver
shares; reference role: the classical-CI layer of
configuration_interaction_states.py:354, which the reference uses only
for MCVQE initial states, never as an energy method).

CISD is variational (E_FCI <= E_CISD <= E_HF) but famously NOT
size-consistent: E_CISD(A...B at infinity) > E_CISD(A) + E_CISD(B),
because products of monomer doubles are dimer quadruples the truncated
space lacks.  The renormalized Davidson correction
E_Q = (1 - c0^2)/c0^2 * E_corr estimates the missing quadruples from
the ground-state HF-determinant weight c0; the size-consistency test
pins both the failure and the fix.
"""

import warnings
from typing import Tuple

import numpy as np

__all__ = ["cisd"]

# Dense-H feasibility guard: the CISD matrix is (nd, nd) float64, so
# nd = 32768 is already an 8 GB allocation before the eigensolver runs
# (nd grows as o^2 v^2 — this ceiling arrives well before the package's
# sector/string solvers give out).  Past _EIGH_CUTOFF determinants the
# lowest-k roots come from Lanczos (scipy eigsh) instead of full eigh,
# which removes the O(nd^3) time term; the O(nd^2) memory term is what
# _DENSE_LIMIT guards.
_DENSE_LIMIT = 32768
_EIGH_CUTOFF = 2048


def cisd(problem, k: int = 1) -> dict:
    """CISD through exact diagonalization of the singles+doubles space.

    Args:
        problem: an ElectronicStructureProblem (closed or open shell;
            frozen cores via `problem.active_space(...)` first).
        k: number of CISD roots to report in `energies`.

    Returns a dict:
        e_hf    — electronic energy of the reference determinant
        e_corr  — E_CISD - E_HF (the CISD correlation energy)
        e_elec  — ground-state CISD electronic energy
        e_total — e_elec + nuclear repulsion + core_energy
        c0      — |coefficient of the HF determinant| in the ground state
        davidson_q       — renormalized Davidson correction
                           (1-c0^2)/c0^2 * e_corr
        e_total_q        — e_total + davidson_q  (CISD+Q)
        energies         — the lowest k CISD electronic eigenvalues
        n_determinants   — size of the CISD space
    """
    from ..initializations.ci import (ci_matrix, enumerate_determinants,
                                      hf_determinant)

    # pure NumPy on the host, like mp2 and ccsd
    h_so, g_so = problem.integral_tensors()
    n_so = h_so.shape[0]
    if getattr(problem, "num_particles", None) is None:
        raise ValueError(
            "problem.num_particles is None — CISD needs the (n_alpha, "
            "n_beta) electron counts; adapted problems must carry them")
    num_particles: Tuple[int, int] = tuple(problem.num_particles)
    dets = enumerate_determinants(n_so, num_particles, 2)
    nd = len(dets)
    if not 1 <= k <= nd:
        raise ValueError(
            f"k={k} outside the CISD space of {nd} determinants")
    if nd > _DENSE_LIMIT:
        raise ValueError(
            f"CISD space has {nd} determinants; the dense (nd, nd) CI "
            f"matrix past nd={_DENSE_LIMIT} needs "
            f">{_DENSE_LIMIT**2 * 8 / 2**30:.0f} GB — reduce the window "
            "with problem.active_space(...) or use the sector CASSCF/"
            "FCI machinery for large spaces")
    H = ci_matrix(dets, h_so, g_so)
    hf_idx = dets.index(hf_determinant(n_so, num_particles))
    if nd > _EIGH_CUTOFF and k < nd - 1:
        # lowest-k Lanczos on the dense H: O(k nd^2) instead of eigh's
        # O(nd^3) — the advisor-flagged k=1 common case.  ARPACK can
        # fail to converge on clustered/degenerate low roots; nd is
        # capped at _DENSE_LIMIT so the dense eigh is always a feasible
        # fallback (advisor round 4).
        from scipy.sparse.linalg import ArpackNoConvergence, eigsh
        try:
            w, v = eigsh(H, k=k, which="SA")
            order = np.argsort(w)
            w, v = w[order], v[:, order]
        except ArpackNoConvergence:
            w, v = np.linalg.eigh(H)
    else:
        w, v = np.linalg.eigh(H)
    e_hf = float(H[hf_idx, hf_idx])
    e_elec = float(w[0])
    e_corr = e_elec - e_hf
    c0 = float(abs(v[hf_idx, 0]))
    if c0 < 0.8:
        warnings.warn(
            f"CISD reference weight c0={c0:.3f} < 0.8: the state is "
            "strongly multireference, the single-reference Davidson +Q "
            "denominator c0^2 is outside its regime of validity and "
            "davidson_q/e_total_q may be wildly overshooting",
            stacklevel=2)
    dq = (1.0 - c0 * c0) / (c0 * c0) * e_corr
    offset = (problem.nuclear_repulsion_energy
              + getattr(problem, "core_energy", 0.0))
    return {
        "e_hf": e_hf,
        "e_corr": e_corr,
        "e_elec": e_elec,
        "e_total": e_elec + offset,
        "c0": c0,
        "davidson_q": dq,
        "e_total_q": e_elec + dq + offset,
        "energies": np.asarray(w[:k], dtype=np.float64),
        "n_determinants": len(dets),
    }
