"""Molecular properties from RDMs (dipole moments and friends).

Copy of esoo_tpu/chem/properties.py (host NumPy).

The reference library obtained property integrals from PySCF and never
evaluated them (its results are energies only).  Every OptOrb-family
result carries (or can reconstruct) the active-space 1-RDM and the
optimal partial unitary U, which is all a one-body property needs:

    μ = Σ_A Z_A R_A  −  [ ⟨r⟩_core + Σ_pq (Uᵀ D U)[p,q] γ[q,p] ]

with D the MO-basis dipole-operator matrices computed by the integral
engine (chem/integrals.py `IntegralEngine.dipole`), γ the spin-summed
spatial 1-RDM of the active-space state, and ⟨r⟩_core the frozen-core
contribution accumulated by `ElectronicStructureProblem.active_space`.

Because every solver in the package is variational, the Hellmann-
Feynman theorem holds at the optimum: dE/dF for the field-perturbed
Hamiltonian h → h + F·D equals tr(γD).  tests/test_properties.py
enforces exactly this identity (finite-field SCF and finite-field
FusedOptOrbCASSCF against the analytic RDM dipole).

Solver results hand their RDMs and U over as NumPy arrays; a torch tensor
(on any device) passed instead is copied to the host by `_host`, here at
the boundary, so everything below is NumPy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# 1 atomic unit of electric dipole = ea0 = 2.541746473 Debye (CODATA)
AU_TO_DEBYE = 2.541746473
_BOHR_TO_ANGSTROM = 0.52917721092
# 1 atomic unit of quadrupole = ea0^2 = 1.3450 Buckingham (Debye*Angstrom)
AU_TO_BUCKINGHAM = AU_TO_DEBYE * _BOHR_TO_ANGSTROM


def _host(a) -> np.ndarray:
    """`a` as a float64 NumPy array; a torch tensor is detached and copied
    to the host first."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def hf_density_spatial(problem) -> np.ndarray:
    """Spin-summed spatial 1-RDM of the problem's mean-field reference
    in its own MO basis: diag(2,...,2,1,...,1,0,...) — doubly occupied
    up to n_beta, singly (alpha) occupied up to n_alpha (ROHF order)."""
    na, nb = problem.num_particles
    n = problem.num_spatial_orbitals
    occ = np.zeros(n)
    occ[:nb] = 2.0
    occ[nb:na] = 1.0
    return np.diag(occ)


def spin_summed(gamma_so: np.ndarray) -> np.ndarray:
    """Reduce a spin-orbital 1-RDM (block ordering, alpha first) to the
    spin-summed spatial 1-RDM γ_sp = γ_αα + γ_ββ."""
    gamma_so = _host(gamma_so)
    half = gamma_so.shape[0] // 2
    return gamma_so[:half, :half] + gamma_so[half:, half:]


def dipole_moment(problem,
                  gamma_spatial: Optional[np.ndarray] = None,
                  partial_unitary: Optional[np.ndarray] = None,
                  unit: str = "au") -> np.ndarray:
    """Electric dipole moment vector of the state described by
    `gamma_spatial` (spin-summed spatial 1-RDM over the problem's
    orbitals, or over the rotated/active orbitals when
    `partial_unitary` is given).

    Args:
        problem: an `ElectronicStructureProblem` from `MoleculeDriver`
            (must carry `dipole_mo`; problems built from bare tensors
            cannot evaluate properties).
        gamma_spatial: (n, n) spin-summed spatial 1-RDM.  Default: the
            mean-field reference density (HF dipole).  A spin-orbital
            (2n, 2n) block matrix is accepted and spin-reduced.
        partial_unitary: optional (m, n) spatial partial unitary — the
            `optimal_partial_unitary` of an OptOrb result, mapping the
            problem's m orbitals onto the n active orbitals γ lives in.
        unit: 'au' (default) or 'debye'.

    Returns (3,) dipole vector μ = μ_nuc − ⟨r⟩_elec.
    """
    D = getattr(problem, "dipole_mo", None)
    if D is None:
        raise ValueError(
            "problem carries no dipole integrals (dipole_mo is None); "
            "build it with chem.MoleculeDriver — problems ingested from "
            "bare integral tensors cannot evaluate properties")
    D = np.asarray(D, dtype=np.float64)
    if gamma_spatial is None:
        gamma = hf_density_spatial(problem)
    else:
        gamma = _host(gamma_spatial)
    if partial_unitary is not None:
        U = _host(partial_unitary)
        if U.shape[0] != D.shape[1]:
            raise ValueError(
                f"partial unitary rows ({U.shape[0]}) do not match the "
                f"problem's {D.shape[1]} spatial orbitals")
        D = np.einsum("dpq,pi,qj->dij", D, U, U, optimize=True)
    if gamma.shape[0] == 2 * D.shape[1]:
        gamma = spin_summed(gamma)
    if gamma.shape != D.shape[1:]:
        raise ValueError(
            f"1-RDM shape {gamma.shape} does not match the "
            f"{D.shape[1]}-orbital dipole operator; pass the "
            f"partial_unitary for active-space RDMs")
    elec = np.einsum("dpq,qp->d", D, gamma) + np.asarray(
        problem.dipole_core, dtype=np.float64)
    mu = np.asarray(problem.nuclear_dipole, dtype=np.float64) - elec
    return _to_unit(mu, unit)


def _to_unit(mu: np.ndarray, unit: str) -> np.ndarray:
    if unit.lower() in ("debye", "d"):
        return mu * AU_TO_DEBYE
    if unit.lower() != "au":
        raise ValueError("unit must be 'au' or 'debye'")
    return mu


def transition_dipoles(problem,
                       trdm1_spatial: np.ndarray,
                       partial_unitary: Optional[np.ndarray] = None,
                       unit: str = "au") -> np.ndarray:
    """Dipole-moment matrix (k, k, 3) over the states whose spin-summed
    spatial (transition) 1-RDMs are given as (k, k, n, n) — the
    `transition_rdm1_spatial` of an SA-CASSCF result.

    Diagonal entries are state dipole moments (nuclear + frozen-core
    terms included, identical to `dipole_moment` per state); off-
    diagonal entries are transition dipole moments μ_IJ = −⟨I|r̂|J⟩
    (the nuclear and frozen-core terms multiply ⟨I|J⟩ = 0 for
    orthogonal states).  Combine with the state energies via
    `oscillator_strengths`.
    """
    D = getattr(problem, "dipole_mo", None)
    if D is None:
        raise ValueError(
            "problem carries no dipole integrals (dipole_mo is None); "
            "build it with chem.MoleculeDriver — problems ingested from "
            "bare integral tensors cannot evaluate properties")
    D = np.asarray(D, dtype=np.float64)
    t = _host(trdm1_spatial)
    if t.ndim != 4 or t.shape[0] != t.shape[1] or t.shape[2] != t.shape[3]:
        raise ValueError(
            f"trdm1_spatial must be (k, k, n, n), got {t.shape}")
    if partial_unitary is not None:
        U = _host(partial_unitary)
        D = np.einsum("dpq,pi,qj->dij", D, U, U, optimize=True)
    if t.shape[2] != D.shape[1]:
        raise ValueError(
            f"transition 1-RDMs live in {t.shape[2]} orbitals but the "
            f"dipole operator has {D.shape[1]}; pass the "
            f"partial_unitary for active-space RDMs")
    mu = -np.einsum("dps,ijps->ijd", D, t, optimize=True)
    k = t.shape[0]
    diag = (np.asarray(problem.nuclear_dipole, dtype=np.float64)
            - np.asarray(problem.dipole_core, dtype=np.float64))
    mu[np.arange(k), np.arange(k)] += diag
    return _to_unit(mu, unit)


def quadrupole_moment(problem,
                      gamma_spatial: Optional[np.ndarray] = None,
                      partial_unitary: Optional[np.ndarray] = None,
                      traceless: bool = True,
                      unit: str = "au") -> np.ndarray:
    """Electric quadrupole-moment tensor (3, 3) of the state described
    by `gamma_spatial` (RDM / partial-unitary plumbing identical to
    `dipole_moment`; default: the mean-field density).

    Primitive moment (origin at 0): Q_ab = Σ_A Z_A R_a R_b − ⟨r_a r_b⟩;
    with `traceless=True` (default) the Buckingham convention
    Θ = (3Q − tr(Q)·I)/2 is returned — origin-independent for neutral
    molecules with zero dipole.  unit: 'au' (e·a0²) or 'buckingham'
    (Debye·Å, AU_TO_BUCKINGHAM).
    """
    M = getattr(problem, "quadrupole_mo", None)
    ao = getattr(problem, "ao_basis", None)
    if M is None or ao is None:
        raise ValueError(
            "problem carries no quadrupole integrals (quadrupole_mo / "
            "ao_basis is None); build it with chem.MoleculeDriver")
    M = np.asarray(M, dtype=np.float64)
    if gamma_spatial is None:
        gamma = hf_density_spatial(problem)
    else:
        gamma = _host(gamma_spatial)
    if partial_unitary is not None:
        U = _host(partial_unitary)
        M = np.einsum("dpq,pi,qj->dij", M, U, U, optimize=True)
    if gamma.shape[0] == 2 * M.shape[1]:
        gamma = spin_summed(gamma)
    if gamma.shape != M.shape[1:]:
        raise ValueError(
            f"1-RDM shape {gamma.shape} does not match the "
            f"{M.shape[1]}-orbital quadrupole operator; pass the "
            f"partial_unitary for active-space RDMs")
    elec6 = (np.einsum("dpq,qp->d", M, gamma)
             + np.asarray(problem.quadrupole_core, dtype=np.float64))
    Z = np.asarray(ao.atomic_numbers, dtype=np.float64)
    R = np.asarray(ao.coords, dtype=np.float64)
    nuc = np.einsum("a,ai,aj->ij", Z, R, R)
    iu = np.triu_indices(3)
    elec = np.zeros((3, 3))
    elec[iu] = elec6
    elec = elec + elec.T - np.diag(np.diagonal(elec))
    Q = nuc - elec
    if traceless:
        Q = 1.5 * Q - 0.5 * np.trace(Q) * np.eye(3)
    if unit.lower() in ("buckingham", "b", "debye*angstrom"):
        return Q * AU_TO_BUCKINGHAM
    if unit.lower() != "au":
        raise ValueError("unit must be 'au' or 'buckingham'")
    return Q


def density_ao(problem,
               gamma_spatial: Optional[np.ndarray] = None,
               partial_unitary: Optional[np.ndarray] = None,
               include_core: bool = True) -> np.ndarray:
    """Total spin-summed AO-basis density matrix P of the state whose
    MO-basis 1-RDM is `gamma_spatial` (default: the mean-field
    reference): P = C γ Cᵀ + P_core, with C the AO coefficients of the
    problem's MO window and P_core the accumulated frozen-core density
    of `active_space` reductions.  tr(PS) = total electron count.
    include_core=False skips P_core — required when γ is a SPIN density
    (γ_αα − γ_ββ; the closed-shell core carries none)."""
    C = getattr(problem, "mo_coeff_ao", None)
    if C is None:
        raise ValueError(
            "problem carries no AO-basis MO coefficients (mo_coeff_ao "
            "is None); build it with chem.MoleculeDriver")
    C = np.asarray(C, dtype=np.float64)
    if gamma_spatial is None:
        gamma = hf_density_spatial(problem)
    else:
        gamma = _host(gamma_spatial)
        if gamma.shape[0] == 2 * problem.num_spatial_orbitals:
            gamma = spin_summed(gamma)
    if partial_unitary is not None:
        U = _host(partial_unitary)
        gamma = U @ gamma @ U.T
    if gamma.shape[0] != C.shape[1]:
        raise ValueError(
            f"1-RDM has {gamma.shape[0]} orbitals but the problem's MO "
            f"window has {C.shape[1]}; pass the partial_unitary for "
            f"active-space RDMs")
    P = C @ gamma @ C.T
    core = getattr(problem, "density_core_ao", None)
    if include_core and core is not None:
        P = P + core
    return P


def populations(problem,
                gamma_spatial: Optional[np.ndarray] = None,
                partial_unitary: Optional[np.ndarray] = None,
                method: str = "mulliken",
                include_core: bool = True):
    """Per-atom electron populations and partial charges.

    method='mulliken': pop_μ = (P S)_μμ summed over the AOs of each
    atom; method='lowdin': (S^½ P S^½)_μμ (basis-orthogonalized, less
    basis-set pathological).  Charges are q_A = Z_A − pop_A.  The RDM /
    partial-unitary plumbing matches `dipole_moment` (default:
    mean-field density; OptOrb results pass their active-space 1-RDM +
    optimal U).

    With a SPIN density (γ_αα − γ_ββ, e.g. a result's
    `spin_density_spatial`) pass include_core=False: 'populations' are
    then atomic spin populations summing to 2·S_z, and the returned
    'charges' Z − pop are not meaningful.

    Returns (populations (natom,), charges (natom,)).
    """
    ao = getattr(problem, "ao_basis", None)
    if ao is None:
        raise ValueError(
            "problem carries no AO basis metadata (ao_basis is None); "
            "build it with chem.MoleculeDriver")
    P = density_ao(problem, gamma_spatial, partial_unitary,
                   include_core=include_core)
    S = np.asarray(ao.overlap, dtype=np.float64)
    m = method.lower()
    if m == "mulliken":
        per_ao = np.einsum("uv,vu->u", P, S)
    elif m == "lowdin":
        w, V = np.linalg.eigh(S)
        S_half = (V * np.sqrt(w)) @ V.T
        per_ao = np.einsum("uv,vw,wu->u", S_half, P, S_half,
                           optimize=True)
    else:
        raise ValueError("method must be 'mulliken' or 'lowdin'")
    natom = len(ao.symbols)
    pop = np.zeros(natom)
    np.add.at(pop, np.asarray(ao.ao_atoms), per_ao)
    return pop, np.asarray(ao.atomic_numbers, dtype=np.float64) - pop


def bond_orders(problem,
                gamma_spatial: Optional[np.ndarray] = None,
                partial_unitary: Optional[np.ndarray] = None,
                spin_density_spatial: Optional[np.ndarray] = None
                ) -> np.ndarray:
    """Mayer bond-order matrix B (natom, natom):

        B_AB = Σ_{μ∈A, ν∈B} [ (P S)_μν (P S)_νμ + (Pˢ S)_μν (Pˢ S)_νμ ]

    with P the total AO density (density_ao of the given MO-basis 1-RDM,
    default mean-field) and Pˢ the AO spin density (pass the result's
    `spin_density_spatial` for open shells; closed shells omit it).
    Classic anchors (enforced by tests): RHF/STO-3G gives exactly 1 for
    H2 and exactly 3 for N2; a dissociating FCI H2 decays toward 0
    (Mayer, Chem. Phys. Lett. 97, 270 (1983))."""
    ao = getattr(problem, "ao_basis", None)
    if ao is None:
        raise ValueError(
            "problem carries no AO basis metadata (ao_basis is None); "
            "build it with chem.MoleculeDriver")
    S = np.asarray(ao.overlap, dtype=np.float64)
    PS = density_ao(problem, gamma_spatial, partial_unitary) @ S
    M = PS * PS.T
    if spin_density_spatial is not None:
        PsS = density_ao(problem, spin_density_spatial, partial_unitary,
                         include_core=False) @ S
        M = M + PsS * PsS.T
    natom = len(ao.symbols)
    atoms = np.asarray(ao.ao_atoms)
    B = np.zeros((natom, natom))
    np.add.at(B, (atoms[:, None], atoms[None, :]), M)
    np.fill_diagonal(B, 0.0)
    return B


def natural_orbitals(problem,
                     gamma_spatial: np.ndarray,
                     partial_unitary: Optional[np.ndarray] = None):
    """Natural orbitals of an MO-basis 1-RDM in the AO basis.

    Diagonalizes `gamma_spatial` (n, n) and back-transforms the
    eigenvectors through the (optionally U-rotated) MO window to AO
    coefficients: C_NO = C_act V with C_act = mo_coeff_ao [@ U].

    Returns (occupations (n,) descending, coefficients (nbf, n)) —
    S-orthonormal (C_NOᵀ S C_NO = 1, tested), ready for visualization
    or as a correlated-orbital initial guess."""
    C = getattr(problem, "mo_coeff_ao", None)
    if C is None:
        raise ValueError(
            "problem carries no AO coefficients (mo_coeff_ao is None); "
            "build it with chem.MoleculeDriver")
    C = np.asarray(C, dtype=np.float64)
    gamma = _host(gamma_spatial)
    if partial_unitary is not None:
        C = C @ _host(partial_unitary)
    if C.shape[1] != gamma.shape[0]:
        raise ValueError(
            f"1-RDM is {gamma.shape[0]} orbitals but the (rotated) MO "
            f"window has {C.shape[1]}")
    occ, V = np.linalg.eigh(0.5 * (gamma + gamma.T))
    order = np.argsort(occ)[::-1]
    return occ[order], C @ V[:, order]


def apply_field(problem, field: np.ndarray):
    """The problem in a uniform static electric field F (a.u.):
    h → h + Σ_d F_d·D_d (the electron-position coupling; the scalar
    nuclear term −F·μ_nuc shifts all states equally and is omitted —
    energy DIFFERENCES and derivative-based electronic properties are
    unaffected).  Returns a new problem; the input is untouched."""
    import dataclasses

    D = getattr(problem, "dipole_mo", None)
    if D is None:
        raise ValueError(
            "problem carries no dipole integrals (dipole_mo is None); "
            "build it with chem.MoleculeDriver")
    field = np.asarray(field, dtype=np.float64)
    return dataclasses.replace(
        problem, hcore_mo=problem.hcore_mo + np.einsum(
            "d,dpq->pq", field, np.asarray(D, dtype=np.float64)))


def polarizability(problem, solve_energy, field: float = 2e-3,
                   components=None) -> np.ndarray:
    """Static dipole polarizability tensor α_ab = −∂²E/∂F_a∂F_b by
    central finite fields: 2nd differences on the diagonal, 4-point
    stencils off it (6 + 12 energy evaluations for the full tensor).

    `solve_energy(problem) -> float` must return the VARIATIONAL ground
    energy of the field-perturbed problem (e.g.
    ``lambda p: FusedOptOrbCASSCF(num_spin_orbitals=2*p.num_spatial_orbitals,
    problem=p).compute_minimum_energy().eigenvalue`` — a full-space
    U absorbs the orbital response).  `components` restricts to a list
    of (a, b) pairs (e.g. [(2, 2)] for α_zz only); the rest stay 0.

    The Hellmann-Feynman consistency α_ab = ∂μ_a/∂F_b is enforced by
    tests/test_properties.py."""
    F = float(field)
    e0 = None
    alpha = np.zeros((3, 3))
    pairs = ([(a, b) for a in range(3) for b in range(a, 3)]
             if components is None else list(components))

    def E(fa, fb, a, b):
        f = np.zeros(3)
        f[a] += fa
        f[b] += fb
        return float(solve_energy(apply_field(problem, f)))

    for a, b in pairs:
        if a == b:
            if e0 is None:
                e0 = float(solve_energy(problem))
            val = -(E(F, 0, a, a) - 2.0 * e0 + E(-F, 0, a, a)) / F ** 2
        else:
            val = -(E(F, F, a, b) - E(F, -F, a, b)
                    - E(-F, F, a, b) + E(-F, -F, a, b)) / (4.0 * F ** 2)
        alpha[a, b] = alpha[b, a] = val
    return alpha


def oscillator_strengths(energies: np.ndarray,
                         dipole_matrix: np.ndarray) -> np.ndarray:
    """Length-gauge oscillator strengths f_IJ = (2/3)(E_J − E_I)|μ_IJ|²
    from state energies (k,) (electronic or total — differences agree)
    and a `transition_dipoles` matrix in ATOMIC UNITS.  f[i, j] > 0 for
    an upward transition i → j (antisymmetric in i↔j; diagonal 0)."""
    e = np.asarray(energies, dtype=np.float64)
    mu = np.asarray(dipole_matrix, dtype=np.float64)
    dE = e[None, :] - e[:, None]
    return (2.0 / 3.0) * dE * np.einsum("ijd,ijd->ij", mu, mu)
