"""Hartree-Fock (RHF / ROHF / UHF) with DIIS (host-side, numpy float64).

Frozen copy of esoo_torch/chem/scf.py (the benchmark's inputs): produces the MO coefficients that define
the large starting basis the OptOrb solvers reduce from.  ROHF (Roothaan
effective Fock, Guest-Saunders coupling) keeps ONE set of spatial
orbitals shared by both spins, the form the spatial partial unitary U
requires.  UHF seeds the ROHF guess and serves validation and standalone
SCF use.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.linalg import eigh


@dataclasses.dataclass
class SCFResult:
    energy_total: float
    energy_electronic: float
    nuclear_repulsion: float
    mo_coeff: np.ndarray       # (nbf, nmo)
    mo_energy: np.ndarray
    converged: bool
    n_iter: int


def nuclear_repulsion(charges, centers) -> float:
    e = 0.0
    n = len(charges)
    for i in range(n):
        for j in range(i):
            e += charges[i] * charges[j] / np.linalg.norm(centers[i] - centers[j])
    return float(e)


def _gwh_fock(S, hcore, k: float = 1.75) -> np.ndarray:
    """Generalized Wolfsberg-Helmholz initial Fock:
    F0_ij = k/2 (h_ii + h_jj) S_ij, F0_ii = h_ii.  Unlike the bare-core
    guess it sees the overlap structure, which keeps pi-degenerate
    systems (N2, CO, ...) out of symmetry-broken SCF saddles — the core
    guess converges N2/STO-3G to a state 0.73 Ha ABOVE the literature
    RHF energy (-106.766 vs -107.4959, caught by the Mayer bond-order
    anchor B(N2) = 3)."""
    hd = np.diag(hcore)
    F0 = 0.5 * k * S * (hd[:, None] + hd[None, :])
    np.fill_diagonal(F0, hd)
    return F0


def rhf(S, hcore, eri, n_electrons, charges, centers,
        max_iter: int = 100, conv_tol: float = 1e-10,
        diis_size: int = 8) -> SCFResult:
    """Closed-shell restricted Hartree-Fock.

    Args:
        S: overlap matrix (nbf, nbf).
        hcore: T + V core Hamiltonian.
        eri: two-electron integrals (pq|rs), chemist notation.
        n_electrons: total electron count (must be even).
    """
    if n_electrons % 2:
        raise ValueError("rhf requires an even number of electrons")
    nocc = n_electrons // 2
    e_nn = nuclear_repulsion(charges, centers)

    # symmetric orthogonalization with linear-dependency screening
    sval, svec = np.linalg.eigh(S)
    keep = sval > 1e-10
    X = svec[:, keep] / np.sqrt(sval[keep])

    def fock(D):
        J = np.einsum("pqrs,rs->pq", eri, D, optimize=True)
        K = np.einsum("prqs,rs->pq", eri, D, optimize=True)
        return hcore + 2.0 * J - K

    def solve(F):
        Fp = X.T @ F @ X
        eps, Cp = np.linalg.eigh(Fp)
        C = X @ Cp
        return eps, C

    eps, C = solve(_gwh_fock(S, hcore))
    D = C[:, :nocc] @ C[:, :nocc].T

    diis_F, diis_err = [], []
    e_old = 0.0
    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        F = fock(D)
        # DIIS extrapolation
        err = F @ D @ S - S @ D @ F
        diis_F.append(F.copy())
        diis_err.append(err.copy())
        if len(diis_F) > diis_size:
            diis_F.pop(0)
            diis_err.pop(0)
        if len(diis_F) > 1:
            m = len(diis_F)
            B = -np.ones((m + 1, m + 1))
            B[m, m] = 0.0
            for i in range(m):
                for j in range(m):
                    B[i, j] = np.sum(diis_err[i] * diis_err[j])
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.solve(B, rhs)[:m]
                F = sum(wi * Fi for wi, Fi in zip(w, diis_F))
            except np.linalg.LinAlgError:
                pass
        eps, C = solve(F)
        D = C[:, :nocc] @ C[:, :nocc].T
        e_elec = float(np.sum(D * (hcore + fock(D))))
        if abs(e_elec - e_old) < conv_tol and it > 2:
            converged = True
            break
        e_old = e_elec

    e_elec = float(np.sum(D * (hcore + fock(D))))
    return SCFResult(
        energy_total=e_elec + e_nn,
        energy_electronic=e_elec,
        nuclear_repulsion=e_nn,
        mo_coeff=C,
        mo_energy=eps,
        converged=converged,
        n_iter=it,
    )


def _ab_focks(hcore, eri, Da, Db):
    """Spin Fock matrices Fa, Fb from alpha/beta densities."""
    J = np.einsum("pqrs,rs->pq", eri, Da + Db, optimize=True)
    Ka = np.einsum("prqs,rs->pq", eri, Da, optimize=True)
    Kb = np.einsum("prqs,rs->pq", eri, Db, optimize=True)
    return hcore + J - Ka, hcore + J - Kb


def _scf_energy(hcore, Da, Db, Fa, Fb) -> float:
    return float(0.5 * (np.sum((Da + Db) * hcore)
                        + np.sum(Da * Fa) + np.sum(Db * Fb)))


class _DIIS:
    """Pulay DIIS extrapolation over (Fock, error) pairs."""

    def __init__(self, size: int = 8):
        self.size = size
        self.F: list = []
        self.err: list = []

    def step(self, F, err):
        self.F.append(np.copy(F))
        self.err.append(np.ravel(err))
        if len(self.F) > self.size:
            self.F.pop(0)
            self.err.pop(0)
        m = len(self.F)
        if m < 2:
            return F
        B = -np.ones((m + 1, m + 1))
        B[m, m] = 0.0
        for i in range(m):
            for j in range(m):
                B[i, j] = self.err[i] @ self.err[j]
        rhs = np.zeros(m + 1)
        rhs[m] = -1.0
        try:
            w = np.linalg.solve(B, rhs)[:m]
        except np.linalg.LinAlgError:
            return F
        return sum(wi * Fi for wi, Fi in zip(w, self.F))


def _ortho(S, lindep: float = 1e-10):
    sval, svec = np.linalg.eigh(S)
    keep = sval > lindep
    return svec[:, keep] / np.sqrt(sval[keep])


def rohf(S, hcore, eri, n_alpha, n_beta, charges, centers,
         max_iter: int = 200, conv_tol: float = 1e-10,
         diis_size: int = 8, level_shift: float = 0.0,
         C0=None, _retry_shifts=(0.3, 1.0, 3.0)) -> SCFResult:
    """Restricted open-shell Hartree-Fock (Roothaan effective Fock).

    One common set of spatial orbitals: `n_beta` doubly occupied (closed),
    `n_alpha - n_beta` singly occupied (open, alpha).  Effective Fock
    coupling follows the Guest-Saunders scheme:

        block        closed     open       virtual
        closed      (Fa+Fb)/2    Fb       (Fa+Fb)/2
        open          Fb      (Fa+Fb)/2      Fa
        virtual    (Fa+Fb)/2     Fa       (Fa+Fb)/2
    """
    if n_alpha < n_beta:
        n_alpha, n_beta = n_beta, n_alpha
    e_nn = nuclear_repulsion(charges, centers)
    X = _ortho(S)
    nmo = X.shape[1]

    def densities(C):
        Da = C[:, :n_alpha] @ C[:, :n_alpha].T
        Db = C[:, :n_beta] @ C[:, :n_beta].T
        return Da, Db

    if C0 is not None:
        C = np.asarray(C0)
    else:
        # UHF-seeded guess: degenerate open shells (p^1/p^2 atoms) need a
        # symmetry-adapted starting occupation that the bare-hcore guess
        # does not provide; a loose UHF finds it cheaply.
        try:
            C = uhf(S, hcore, eri, n_alpha, n_beta, charges, centers,
                    max_iter=60, conv_tol=1e-8,
                    diis_size=diis_size).mo_coeff_a
        except Exception:
            eps, C = np.linalg.eigh(X.T @ _gwh_fock(S, hcore) @ X)
            C = X @ C
    Da, Db = densities(C)

    diis = _DIIS(diis_size)
    e_old, converged, it = 0.0, False, 0
    for it in range(1, max_iter + 1):
        Fa, Fb = _ab_focks(hcore, eri, Da, Db)
        # assemble the effective Fock in the current MO basis
        Fa_mo = C.T @ Fa @ C
        Fb_mo = C.T @ Fb @ C
        Fc = 0.5 * (Fa_mo + Fb_mo)
        Feff = Fc.copy()
        c = slice(0, n_beta)            # closed
        o = slice(n_beta, n_alpha)      # open (singly occupied, alpha)
        v = slice(n_alpha, nmo)         # virtual
        Feff[c, o] = Fb_mo[c, o]
        Feff[o, c] = Fb_mo[o, c]
        Feff[o, v] = Fa_mo[o, v]
        Feff[v, o] = Fa_mo[v, o]
        # DIIS error: the occupied-virtual orbital gradient (zero at a
        # stationary point of the ROHF energy)
        grad = np.zeros_like(Feff)
        grad[c, o] = Feff[c, o]
        grad[c, v] = Feff[c, v]
        grad[o, v] = Feff[o, v]
        err = grad - grad.T
        Feff = diis.step(Feff, err)
        Feff = 0.5 * (Feff + Feff.T)
        if level_shift:
            # stabilizes oscillating occupations (degenerate open shells)
            Feff[v, v] += level_shift * np.eye(nmo - n_alpha)
            Feff[o, o] += 0.5 * level_shift * np.eye(n_alpha - n_beta)
        eps, W = np.linalg.eigh(Feff)
        if it > 5:
            # maximum-overlap occupation locking: degenerate partially
            # filled shells (p^1, p^2 atoms) make pure-aufbau selection
            # oscillate between symmetry-equivalent occupations.  The
            # current MO basis IS the previous eigenbasis, so the overlap
            # of new orbital j with the old alpha-occupied space is the
            # squared weight of W[:n_alpha, j].
            wa = np.sum(W[:n_alpha, :] ** 2, axis=0)
            occ_a = np.sort(np.argsort(-wa)[:n_alpha])
            wb = np.sum(W[:n_beta, :] ** 2, axis=0)
            wb_sel = wb[occ_a]
            closed_sel = occ_a[np.sort(np.argsort(-wb_sel)[:n_beta])]
            open_sel = np.array([i for i in occ_a if i not in closed_sel],
                                dtype=int)
            virt_sel = np.array([i for i in range(nmo) if i not in occ_a],
                                dtype=int)
            order = np.concatenate([closed_sel, open_sel, virt_sel])
            W = W[:, order]
            eps = eps[order]
        C = C @ W
        Da, Db = densities(C)
        Fa_n, Fb_n = _ab_focks(hcore, eri, Da, Db)
        e_elec = _scf_energy(hcore, Da, Db, Fa_n, Fb_n)
        if abs(e_elec - e_old) < conv_tol and it > 3:
            converged = True
            break
        e_old = e_elec

    if not converged and _retry_shifts:
        # degenerate open shells oscillate without a level shift; retry
        # with progressively stronger shifts and keep the best converged
        best = None
        for shift in _retry_shifts:
            res = rohf(S, hcore, eri, n_alpha, n_beta, charges, centers,
                       max_iter=max_iter, conv_tol=conv_tol,
                       diis_size=diis_size, level_shift=shift,
                       _retry_shifts=())
            if res.converged and (best is None
                                  or res.energy_total < best.energy_total):
                best = res
        if best is not None:
            return best

    Fa, Fb = _ab_focks(hcore, eri, Da, Db)
    e_elec = _scf_energy(hcore, Da, Db, Fa, Fb)
    return SCFResult(
        energy_total=e_elec + e_nn,
        energy_electronic=e_elec,
        nuclear_repulsion=e_nn,
        mo_coeff=C,
        mo_energy=eps,
        converged=converged,
        n_iter=it,
    )


@dataclasses.dataclass
class UHFResult:
    energy_total: float
    energy_electronic: float
    nuclear_repulsion: float
    mo_coeff_a: np.ndarray
    mo_coeff_b: np.ndarray
    mo_energy_a: np.ndarray
    mo_energy_b: np.ndarray
    spin_squared: float
    converged: bool
    n_iter: int


def uhf(S, hcore, eri, n_alpha, n_beta, charges, centers,
        max_iter: int = 200, conv_tol: float = 1e-10,
        diis_size: int = 8, guess_mix: float = 0.0) -> UHFResult:
    """Unrestricted Hartree-Fock with per-spin DIIS.

    `guess_mix` rotates the initial alpha HOMO/LUMO pair by the given
    angle (radians) to break spatial symmetry when a UHF solution below
    ROHF is sought.
    """
    e_nn = nuclear_repulsion(charges, centers)
    X = _ortho(S)

    def solve(F):
        eps, Cp = np.linalg.eigh(X.T @ F @ X)
        return eps, X @ Cp

    eps_a, Ca = solve(_gwh_fock(S, hcore))
    eps_b, Cb = eps_a.copy(), Ca.copy()
    if guess_mix and n_alpha < Ca.shape[1]:
        h_, l_ = n_alpha - 1, n_alpha
        ch, cl = Ca[:, h_].copy(), Ca[:, l_].copy()
        ct, st = np.cos(guess_mix), np.sin(guess_mix)
        Ca[:, h_], Ca[:, l_] = ct * ch + st * cl, -st * ch + ct * cl
    Da = Ca[:, :n_alpha] @ Ca[:, :n_alpha].T
    Db = Cb[:, :n_beta] @ Cb[:, :n_beta].T

    diis = _DIIS(diis_size)
    e_old, converged, it = 0.0, False, 0
    for it in range(1, max_iter + 1):
        Fa, Fb = _ab_focks(hcore, eri, Da, Db)
        erra = Fa @ Da @ S - S @ Da @ Fa
        errb = Fb @ Db @ S - S @ Db @ Fb
        Fab = diis.step(np.concatenate([Fa[None], Fb[None]]),
                        np.concatenate([erra.ravel(), errb.ravel()]))
        eps_a, Ca = solve(Fab[0])
        eps_b, Cb = solve(Fab[1])
        Da = Ca[:, :n_alpha] @ Ca[:, :n_alpha].T
        Db = Cb[:, :n_beta] @ Cb[:, :n_beta].T
        Fa, Fb = _ab_focks(hcore, eri, Da, Db)
        e_elec = _scf_energy(hcore, Da, Db, Fa, Fb)
        if abs(e_elec - e_old) < conv_tol and it > 3:
            converged = True
            break
        e_old = e_elec

    # <S^2> = S_z(S_z+1) + n_beta - sum_ij |<a_i|b_j>|^2
    ov = Ca[:, :n_alpha].T @ S @ Cb[:, :n_beta]
    sz = 0.5 * (n_alpha - n_beta)
    s2 = sz * (sz + 1) + n_beta - float(np.sum(ov * ov))
    return UHFResult(
        energy_total=e_elec + e_nn,
        energy_electronic=e_elec,
        nuclear_repulsion=e_nn,
        mo_coeff_a=Ca, mo_coeff_b=Cb,
        mo_energy_a=eps_a, mo_energy_b=eps_b,
        spin_squared=s2,
        converged=converged,
        n_iter=it,
    )
