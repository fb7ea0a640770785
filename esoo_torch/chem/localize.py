"""Orbital localization: Pipek-Mezey and Foster-Boys.

Copy of esoo_tpu/chem/localize.py (host NumPy).

Localized molecular orbitals (cores / lone pairs / two-center bonds)
are the standard chemically-motivated starting point for choosing an
OptOrb/CASSCF active space, complementing the MP2-natural-orbital
selector (chem.mp2).  The reference library left every orbital-machinery
role to PySCF (`pyscf.lo`); this is the native equivalent.

Both localizers maximize a diagonal-dominance metric over orthogonal
rotations W of a chosen MO window by classic 2x2 Jacobi sweeps
(Edmiston-Ruedenberg style closed-form angle):

- Pipek-Mezey: maximize sum_i sum_A [Q^A_ii]^2, with Q^A the Mulliken
  atomic charge matrix of atom A (Pipek & Mezey, JCP 90, 4916 (1989)).
- Foster-Boys: maximize sum_i |<i|r|i>|^2 — equivalent to minimizing
  the summed orbital spread sum_i (<r^2>_i - <r>_i^2), since the trace
  of r in the rotated window is invariant (Foster & Boys, Rev. Mod.
  Phys. 32, 300 (1960)).

Because the rotation is unitary within the window, the determinant
(and hence any observable of a state occupying that window — SCF
density, energy, dipole) is exactly invariant; tests pin this.
"""

from typing import Optional, Sequence

import numpy as np

__all__ = ["localize_orbitals"]


def _jacobi_maximize(M: np.ndarray, max_sweeps: int, tol: float):
    """Maximize sum_a sum_i M[a, i, i]^2 over orthogonal congruences
    M[a] <- W.T M[a] W by 2x2 Jacobi rotations.

    For a pair (s, t) and angle alpha the metric change is
    A + A*cos(4a) ... with the standard closed form: defining
      A_st = sum_a [ M[a,s,t]^2 - (M[a,s,s] - M[a,t,t])^2 / 4 ]
      B_st = sum_a [ M[a,s,t] * (M[a,s,s] - M[a,t,t]) ]
    the optimal 4*alpha = atan2(B, -A) and the metric gain is
    A + sqrt(A^2 + B^2) >= 0.

    Returns (W, history, converged, sweeps): W (k, k) orthogonal with
    the final M[a] = W.T M0[a] W, history the metric after each sweep
    (history[0] is the initial metric), converged bool.
    """
    M = np.array(M, dtype=np.float64, copy=True)
    k = M.shape[1]
    W = np.eye(k)
    history = [float(np.sum(M.diagonal(axis1=1, axis2=2) ** 2))]
    converged = k < 2
    sweeps = 0
    for sweep in range(max_sweeps if k >= 2 else 0):
        sweeps = sweep + 1
        gain_total = 0.0
        # metric-relative stop: the Boys metric scales with the squared
        # molecular extent, so an absolute threshold would never fire
        # (or spin on rounding noise) for spatially extended systems
        thresh = tol * max(1.0, abs(history[-1]))
        for s in range(k - 1):
            for t in range(s + 1, k):
                mst = M[:, s, t]
                d = M[:, s, s] - M[:, t, t]
                A = float(np.sum(mst * mst - 0.25 * d * d))
                B = float(np.sum(mst * d))
                r = np.hypot(A, B)
                gain = A + r
                if gain <= 1e-15:
                    continue
                alpha = 0.25 * np.arctan2(B, -A)
                c, sn = np.cos(alpha), np.sin(alpha)
                # columns of W
                ws, wt = W[:, s].copy(), W[:, t].copy()
                W[:, s] = c * ws + sn * wt
                W[:, t] = -sn * ws + c * wt
                # congruence update of every M[a] on rows+cols (s, t)
                Ms, Mt = M[:, :, s].copy(), M[:, :, t].copy()
                M[:, :, s] = c * Ms + sn * Mt
                M[:, :, t] = -sn * Ms + c * Mt
                Ms, Mt = M[:, s, :].copy(), M[:, t, :].copy()
                M[:, s, :] = c * Ms + sn * Mt
                M[:, t, :] = -sn * Ms + c * Mt
                gain_total += gain
        history.append(float(np.sum(M.diagonal(axis1=1, axis2=2) ** 2)))
        if gain_total < thresh:
            converged = True
            break
    return W, M, np.asarray(history), converged, sweeps


def localize_orbitals(problem,
                      orbitals: Optional[Sequence[int]] = None,
                      method: str = "pipek",
                      max_sweeps: int = 200,
                      tol: float = 1e-10) -> dict:
    """Localize a window of the problem's molecular orbitals.

    Args:
        problem: a MoleculeDriver problem (needs `mo_coeff_ao` and
            `ao_basis`; bare-tensor/FCIDUMP problems carry no AO
            structure and raise).
        orbitals: MO indices (into the problem's MO window) to mix.
            Default: the doubly-occupied spatial orbitals of the
            reference determinant.  Rotations never leave this window,
            so occupied-window localization preserves the SCF state
            exactly.
        method: 'pipek' (Mulliken-charge localization; keeps
            sigma/pi separation) or 'boys' (dipole-centroid
            localization).
        max_sweeps / tol: Jacobi sweep limit and per-sweep metric-gain
            convergence threshold.

    Returns a dict:
        coefficients: (nbf, k) AO-basis localized orbitals
            C_loc = C[:, orbitals] @ rotation.
        rotation: (k, k) orthogonal W.
        metric_history: localization metric after each sweep
            (index 0 = canonical orbitals); nondecreasing.
        converged, sweeps.
        populations: (k, natom) per-orbital Mulliken atomic
            populations of each localized orbital (rows sum to 1).
        centroids: (k, 3) dipole centroids <i|r|i> in bohr.
    """
    C_all = getattr(problem, "mo_coeff_ao", None)
    ao = getattr(problem, "ao_basis", None)
    if C_all is None or ao is None:
        raise ValueError(
            "problem carries no AO-basis structure (mo_coeff_ao / "
            "ao_basis); build it with chem.MoleculeDriver")
    C_all = np.asarray(C_all, dtype=np.float64)
    if orbitals is None:
        n_docc = min(problem.num_particles)
        orbitals = np.arange(n_docc)
    orbitals = np.asarray(orbitals)
    if orbitals.dtype == bool:                   # accept boolean masks
        if orbitals.size != C_all.shape[1]:
            raise ValueError(
                f"boolean orbital mask has {orbitals.size} entries but "
                f"the MO window has {C_all.shape[1]} orbitals")
        orbitals = np.flatnonzero(orbitals)
    orbitals = orbitals.astype(int)
    if orbitals.size == 0:
        raise ValueError(
            "empty orbital selection: localization needs at least one "
            "orbital (orbitals=[] / an all-False mask is almost surely "
            "a caller error)")
    if orbitals.size and (orbitals.min() < 0
                          or orbitals.max() >= C_all.shape[1]):
        raise ValueError(
            f"orbital indices {orbitals} outside the problem's MO "
            f"window of {C_all.shape[1]} orbitals")
    if np.unique(orbitals).size != orbitals.size:
        raise ValueError(f"duplicate orbital indices in {orbitals}")
    C = np.ascontiguousarray(C_all[:, orbitals])
    k = C.shape[1]
    S = np.asarray(ao.overlap, dtype=np.float64)
    atoms = np.asarray(ao.ao_atoms)
    natom = len(ao.symbols)

    # Mulliken charge matrices Q^A_ij = 1/2 sum_{mu in A}
    #   [C_{mu i} (SC)_{mu j} + (SC)_{mu i} C_{mu j}]  — (natom, k, k)
    SC = S @ C
    Q = np.zeros((natom, k, k))
    for a in range(natom):
        m = atoms == a
        Ca, SCa = C[m], SC[m]
        Q[a] = 0.5 * (Ca.T @ SCa + SCa.T @ Ca)

    # dipole matrices over the chosen window (the Boys objective +
    # centroid diagnostics for both methods): the problem already
    # carries <p|r_d|q> about origin 0, window-reduced by active_space
    # in lockstep with mo_coeff_ao — reuse it instead of re-evaluating
    # AO integrals; fall back to a fresh engine only when absent
    D_mo = getattr(problem, "dipole_mo", None)
    if D_mo is not None:
        D_win = np.asarray(D_mo, dtype=np.float64)[
            :, orbitals[:, None], orbitals[None, :]]
    elif ao.shells is not None:
        from .integrals import IntegralEngine
        D_ao = IntegralEngine(ao.shells, ao.atomic_numbers,
                              ao.coords).dipole()      # (3, nbf, nbf)
        D_win = np.einsum("ui,duv,vj->dij", C, D_ao, C, optimize=True)
    else:
        D_win = None

    m = method.lower()
    is_boys = m in ("boys", "foster-boys")
    if m in ("pipek", "pipek-mezey", "pm"):
        M0 = Q
    elif is_boys:
        if D_win is None:
            raise ValueError(
                "Boys localization needs dipole integrals (the problem "
                "carries neither dipole_mo nor AO shell data)")
        M0 = D_win
    else:
        raise ValueError("method must be 'pipek' or 'boys'")

    W, M_rot, history, converged, sweeps = _jacobi_maximize(
        M0, max_sweeps, tol)
    C_loc = C @ W
    # diagnostics in the LOCALIZED basis (both methods report both)
    SCl = S @ C_loc
    pops = np.zeros((k, natom))
    for a in range(natom):
        mask = atoms == a
        pops[:, a] = np.einsum("ui,ui->i", C_loc[mask], SCl[mask])
    if is_boys:
        # the rotated objective matrices' diagonals ARE the centroids
        cents = np.ascontiguousarray(
            M_rot.diagonal(axis1=1, axis2=2).T)
    elif D_win is not None:
        cents = np.einsum("ji,djk,ki->id", W, D_win, W, optimize=True)
    else:
        cents = np.full((k, 3), np.nan)
    return {
        "coefficients": C_loc,
        "rotation": W,
        "metric_history": history,
        "converged": converged,
        "sweeps": sweeps,
        "populations": pops,
        "centroids": cents,
    }
