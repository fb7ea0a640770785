"""Nuclear gradients + geometry optimization over any variational solver.

Copy of esoo_tpu/chem/geometry.py (host NumPy; the solvers it builds run
on `device`).

The reference has no geometry capability at all (it consumed one fixed
PySCF problem); the native chem frontend makes geometries first-class,
so this module closes the loop: finite-difference nuclear gradients dE/dR (central stencils over
fully re-converged total energies — exact for variational solvers up to
O(step²)) and a BFGS geometry optimizer driving them.

The `energy_fn` contract is one callable `atom_string -> total energy`
(electronic + core + nuclear repulsion, Hartree); `casscf_energy_fn`
builds the batteries-included exact-CASSCF instance.  The factories of
solver-backed callables (`casscf_*_fn`, `ccsd_energy_fn`) take the port's
`device=` ("cuda" by default, raising without a card; "cpu" runs on the
host) and pass it to every solver they build.  Every energy is an
independent full solve, so the gradients inherit the solver's
variational stationarity (no Pulay/response terms are ever needed).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..utils import resolve_device
from .basis import ANGSTROM_TO_BOHR, parse_geometry


def geometry_string(symbols, coords_bohr: np.ndarray) -> str:
    """Re-assemble a geometry string (Angstrom, the package convention)
    from symbols + bohr coordinates."""
    coords = np.asarray(coords_bohr, dtype=np.float64) / ANGSTROM_TO_BOHR
    return "; ".join(
        f"{s} {x:.12f} {y:.12f} {z:.12f}"
        for s, (x, y, z) in zip(symbols, coords))


def nuclear_gradient(atom: str, energy_fn: Callable[[str], float],
                     step: float = 1e-3) -> np.ndarray:
    """Central finite-difference nuclear gradient dE/dR, (natom, 3) in
    Hartree/bohr.  `step` is the displacement in bohr; 6·natom energy
    evaluations.  Translational invariance (Σ_A ∇_A E = 0) holds to the
    solver's convergence floor and is enforced by tests."""
    symbols, coords = parse_geometry(atom)
    g = np.zeros_like(coords)
    for a in range(len(symbols)):
        for d in range(3):
            es = []
            for sgn in (+1.0, -1.0):
                c = coords.copy()
                c[a, d] += sgn * step
                es.append(float(energy_fn(geometry_string(symbols, c))))
            g[a, d] = (es[0] - es[1]) / (2.0 * step)
    return g


def optimize_geometry(atom: str, energy_fn: Callable[[str], float],
                      gtol: float = 3e-4, maxiter: int = 50,
                      step: float = 1e-3, callback=None):
    """Minimize the total energy over nuclear coordinates (BFGS with
    central-FD gradients).  Returns a dict with the optimized geometry
    string ('atom'), coordinates in bohr ('coords'), final 'energy',
    final 'gradient' (Hartree/bohr), 'converged', and 'n_evaluations'.

    gtol: max-abs gradient component threshold (Hartree/bohr; 3e-4 is
    a standard tight-ish criterion).  callback(atom_string, energy,
    gradient) fires once per accepted BFGS iterate."""
    from scipy import optimize as _sopt

    symbols, coords0 = parse_geometry(atom)
    shape = coords0.shape
    nev = [0]

    def fun(x):
        nev[0] += 1
        return float(energy_fn(geometry_string(symbols,
                                               x.reshape(shape))))

    def jac(x):
        nev[0] += 2 * x.size
        return nuclear_gradient(geometry_string(symbols,
                                                x.reshape(shape)),
                                energy_fn, step=step).ravel()

    cb = None
    if callback is not None:
        def cb(x):
            s = geometry_string(symbols, x.reshape(shape))
            callback(s, fun(x), jac(x).reshape(shape))

    res = _sopt.minimize(fun, coords0.ravel(), jac=jac, method="BFGS",
                         callback=cb,
                         options={"gtol": gtol, "maxiter": maxiter,
                                  "norm": np.inf})
    coords = res.x.reshape(shape)
    return {
        "atom": geometry_string(symbols, coords),
        "coords": coords,
        "energy": float(res.fun),
        "gradient": np.asarray(res.jac).reshape(shape),
        "converged": bool(res.success),
        "n_iterations": int(res.nit),
        "n_evaluations": nev[0],
    }


# most-abundant-isotope masses (amu), H-Ar — the standard choice for
# harmonic analysis (vibrations are isotope-specific)
ISOTOPE_MASSES = {
    "H": 1.00782503207, "He": 4.002603254, "Li": 7.01600455,
    "Be": 9.0121822, "B": 11.0093054, "C": 12.0, "N": 14.0030740048,
    "O": 15.99491461956, "F": 18.99840322, "Ne": 19.9924401754,
    "Na": 22.9897692809, "Mg": 23.98504170, "Al": 26.98153863,
    "Si": 27.9769265325, "P": 30.97376163, "S": 31.97207100,
    "Cl": 34.96885268, "Ar": 39.9623831225,
    "K": 38.96370649, "Ca": 39.96259086, "Sc": 44.95590828,
    "Ti": 47.94794198, "V": 50.94395704, "Cr": 51.94050623,
    "Mn": 54.93804391, "Fe": 55.93493633, "Co": 58.93319429,
    "Ni": 57.93534241, "Cu": 62.92959772, "Zn": 63.92914201,
    "Ga": 68.9255735, "Ge": 73.921177761, "As": 74.92159457,
    "Se": 79.9165218, "Br": 78.9183376, "Kr": 83.9114977282,
}
_AMU_TO_ME = 1822.888486209          # electron masses per amu
_HARTREE_TO_CM1 = 219474.6313705     # wavenumbers per Hartree


def hessian(atom: str, energy_fn: Callable[[str], float],
            step: float = 5e-3) -> np.ndarray:
    """Nuclear Hessian d²E/dR_i dR_j (Hartree/bohr²), (3N, 3N), by
    central energy stencils (symmetric by construction): 3-point on the
    diagonal, 4-point off it — 1 + 6N + 2·3N(3N−1) energy evaluations,
    every one a fully re-converged total."""
    symbols, coords = parse_geometry(atom)
    n = coords.size

    def E(dx):
        c = coords + dx.reshape(coords.shape)
        return float(energy_fn(geometry_string(symbols, c)))

    e0 = E(np.zeros(n))
    H = np.zeros((n, n))
    for i in range(n):
        dx = np.zeros(n)
        dx[i] = step
        H[i, i] = (E(dx) - 2.0 * e0 + E(-dx)) / step ** 2
    for i in range(n):
        for j in range(i + 1, n):
            dij = np.zeros(n)
            dij[i] = step
            dij[j] = step
            dij_m = np.zeros(n)
            dij_m[i] = step
            dij_m[j] = -step
            H[i, j] = H[j, i] = (E(dij) - E(dij_m) - E(-dij_m)
                                 + E(-dij)) / (4.0 * step ** 2)
    return H


def harmonic_frequencies(atom: str, energy_fn: Callable[[str], float],
                         step: float = 5e-3, project: bool = True):
    """Harmonic vibrational analysis at `atom` (which should be an
    optimized geometry): mass-weighted FD Hessian, translation/rotation
    projection, frequencies in cm⁻¹.

    Returns a dict with 'frequencies_cm1' (3N,) ascending — imaginary
    modes reported as NEGATIVE wavenumbers, projected-out trans/rot
    modes as (near-)zeros — plus 'modes' (3N, N, 3) mass-weighted
    normal-mode displacements, 'hessian', and 'n_vibrations'
    (3N−5 linear / 3N−6 nonlinear).  Cross-validated against an
    independent reduced-mass diatomic computation in
    tests/test_geometry.py."""
    symbols, coords = parse_geometry(atom)
    H = hessian(atom, energy_fn, step=step)
    return _frequencies_from_hessian(symbols, coords, H, project=project)


def _frequencies_from_hessian(symbols, coords, H, project: bool = True):
    """Mass-weighting + trans/rot projection + frequencies for a
    precomputed Cartesian Hessian (the harmonic_frequencies core,
    shared with optimize_transition_state)."""
    natom = len(symbols)
    masses = np.array([ISOTOPE_MASSES[s] for s in symbols]) * _AMU_TO_ME
    m3 = np.repeat(masses, 3)
    Hw = H / np.sqrt(np.outer(m3, m3))

    # trans/rot null-space basis in mass-weighted coordinates
    com = (masses @ coords) / masses.sum()
    rel = coords - com
    basis = []
    for d in range(3):
        t = np.zeros((natom, 3))
        t[:, d] = np.sqrt(masses)
        basis.append(t.ravel())
    for d in range(3):
        e = np.zeros(3)
        e[d] = 1.0
        r = np.cross(rel, e) * np.sqrt(masses)[:, None]
        basis.append(r.ravel())
    B = []
    for v in basis:
        for u in B:
            v = v - (u @ v) * u
        nv = np.linalg.norm(v)
        if nv > 1e-8:
            B.append(v / nv)
    n_tr = len(B)                      # 5 linear / 6 nonlinear
    if project and n_tr:
        P = np.eye(3 * natom) - np.array(B).T @ np.array(B)
        Hw = P @ Hw @ P
    w, V = np.linalg.eigh(Hw)
    freqs = np.sign(w) * np.sqrt(np.abs(w)) * _HARTREE_TO_CM1
    # vibrational-vs-trans/rot flag per mode (the projected null space
    # comes out of eigh as an ARBITRARY mix of translations/rotations;
    # ir_intensities must not attribute rigid-rotation dipole
    # reorientation to them)
    if n_tr:
        Bm = np.array(B)
        tr_frac = np.linalg.norm(Bm @ V, axis=0)
        vib_mask = tr_frac < 0.5
    else:
        vib_mask = np.ones(3 * natom, dtype=bool)
    return {
        "frequencies_cm1": freqs,
        "modes": V.T.reshape(-1, natom, 3),
        "hessian": H,
        "n_vibrations": 3 * natom - n_tr,
        "vib_mask": vib_mask,
    }


def dipole_derivatives(atom: str, dipole_fn, step: float = 5e-3
                       ) -> np.ndarray:
    """Central-FD dipole-derivative matrix ∂μ_a/∂R_i (3, 3N) in a.u.
    (e; dipole per bohr), from 6N re-converged dipole evaluations.
    `dipole_fn(atom_string) -> (3,)` returns the dipole vector in a.u.
    (e.g. `casscf_dipole_fn`)."""
    symbols, coords = parse_geometry(atom)
    n = coords.size
    d = np.zeros((3, n))
    for i in range(n):
        mus = []
        for sgn in (+1.0, -1.0):
            c = coords.copy()
            c.ravel()[i] += sgn * step
            mus.append(np.asarray(
                dipole_fn(geometry_string(symbols, c)), dtype=np.float64))
        d[:, i] = (mus[0] - mus[1]) / (2.0 * step)
    return d


# (D/A)^2 amu^-1  ->  km/mol (the standard IR-intensity conversion)
_DA2_AMU_TO_KM_MOL = 42.2561


def ir_intensities(atom: str, dipole_fn, freq_result,
                   step: float = 5e-3) -> np.ndarray:
    """Double-harmonic IR intensities (km/mol), one per mode of a
    `harmonic_frequencies` result (same ordering): the FD dipole-
    derivative matrix projected onto each mass-weighted normal mode,
    I_k = 42.2561 · |∂μ/∂Q_k|² with ∂μ/∂Q in (D/Å)·amu^(−1/2).

    Trans/rot modes are reported as exactly 0 (a rigid rotation of a
    polar molecule reorients μ — microwave, not vibrational, activity —
    and eigh mixes the projected null space arbitrarily, so those rows
    are masked via the result's `vib_mask`).  Exact zeros for
    homonuclear diatomics are enforced by tests/test_geometry.py."""
    from .properties import AU_TO_DEBYE

    symbols, coords = parse_geometry(atom)
    dmu = dipole_derivatives(atom, dipole_fn, step=step)     # (3, 3N)
    masses = np.array([ISOTOPE_MASSES[s] for s in symbols]) * _AMU_TO_ME
    m3 = np.repeat(masses, 3)
    modes = np.asarray(freq_result["modes"]).reshape(-1, coords.size)
    vib = np.asarray(freq_result.get(
        "vib_mask", np.ones(modes.shape[0], dtype=bool)))
    conv = (AU_TO_DEBYE / (1.0 / ANGSTROM_TO_BOHR)) * np.sqrt(_AMU_TO_ME)
    out = np.zeros(modes.shape[0])
    for k, v in enumerate(modes):
        if not vib[k]:
            continue
        dmu_dq = dmu @ (v / np.sqrt(m3)) * conv   # (D/A) amu^-1/2
        out[k] = _DA2_AMU_TO_KM_MOL * float(dmu_dq @ dmu_dq)
    return out


# a.u. polarizability volume -> Angstrom^3, per (bohr -> Angstrom) of
# displacement: (a0[A])^3 * (1/a0[A]) combined below as a0^2
_BOHR_ANG = 1.0 / ANGSTROM_TO_BOHR


def raman_activities(atom: str, alpha_fn, freq_result,
                     step: float = 0.01):
    """Raman scattering activities (Å⁴/amu) per mode of a
    `harmonic_frequencies` result, by finite differences of the
    polarizability tensor ALONG each mass-weighted normal mode (2 α
    evaluations per vibration — far cheaper than a full 3×3×3N Cartesian
    derivative when every α is itself a finite-field calculation).

    `alpha_fn(atom_string) -> (3, 3)` returns the static polarizability
    in a.u. (e.g. `casscf_polarizability_fn`).  `step` is the
    normal-coordinate displacement in bohr·√amu.

    Activity per mode: S_k = 45·ā′² + 7·γ′² with ā′ = tr(α′)/3 and
    γ′² = ½Σ(α′_aa−α′_bb)² + 3Σ_{a<b}α′_ab², α′ = ∂α/∂Q_k in
    Å²·amu^(−1/2) — the standard Gaussian-style double-harmonic
    convention.  Returns (activities (3N,), depolarization ratios (3N,)
    — ρ_k = 3γ′²/(45ā′²+4γ′²), NaN where the activity vanishes);
    trans/rot rows (vib_mask False) are exact zeros.

    The centrosymmetric mutual-exclusion rule (H2: IR-dark but
    Raman-ACTIVE) is enforced by tests/test_geometry.py."""
    symbols, coords = parse_geometry(atom)
    masses_amu = np.array([ISOTOPE_MASSES[s] for s in symbols])
    m3 = np.repeat(masses_amu, 3)
    modes = np.asarray(freq_result["modes"]).reshape(-1, coords.size)
    vib = np.asarray(freq_result.get(
        "vib_mask", np.ones(modes.shape[0], dtype=bool)))
    conv = _BOHR_ANG ** 2                 # a.u./(bohr √amu) -> Å²/√amu
    acts = np.zeros(modes.shape[0])
    depol = np.full(modes.shape[0], np.nan)
    for k, v in enumerate(modes):
        if not vib[k]:
            continue
        u = (v / np.sqrt(m3)).reshape(coords.shape)   # bohr per √amu·Q
        alphas = []
        for sgn in (+1.0, -1.0):
            c = coords + sgn * step * u
            alphas.append(np.asarray(
                alpha_fn(geometry_string(symbols, c)), dtype=np.float64))
        ap = (alphas[0] - alphas[1]) / (2.0 * step) * conv
        ap = 0.5 * (ap + ap.T)
        abar = np.trace(ap) / 3.0
        d = np.diag(ap)
        gamma2 = (0.5 * ((d[0] - d[1]) ** 2 + (d[1] - d[2]) ** 2
                         + (d[2] - d[0]) ** 2)
                  + 3.0 * (ap[0, 1] ** 2 + ap[1, 2] ** 2
                           + ap[0, 2] ** 2))
        acts[k] = 45.0 * abar ** 2 + 7.0 * gamma2
        if acts[k] > 1e-14:
            depol[k] = 3.0 * gamma2 / (45.0 * abar ** 2 + 4.0 * gamma2)
    return acts, depol


def casscf_polarizability_fn(basis: str = "sto-3g",
                             num_spin_orbitals: Optional[int] = None,
                             charge: int = 0, spin: int = 0,
                             n_frozen: Optional[int] = 0,
                             custom_basis=None, field: float = 2e-3,
                             components=None, device="cuda", **solver_kwargs):
    """`atom_string -> (3,3) static polarizability (a.u.)` by finite
    fields over exact-CASSCF solves (the `casscf_dipole_fn` analogue for
    Raman activities / polarizability surfaces).  The field is applied
    to the FULL-space problem before any frozen-core reduction so the
    core sees it too."""
    from ..orbital_optimization import FusedOptOrbCASSCF
    from .driver import MoleculeDriver
    from .properties import polarizability

    resolve_device(device)
    defaults = dict(maxiter=30, stopping_tolerance=1e-10,
                    inner_stopping_tolerance=1e-10, device=device)
    defaults.update(solver_kwargs)

    def solve_energy(p) -> float:
        target = p.active_space(n_frozen=n_frozen) if n_frozen else p
        nso = (2 * target.num_spatial_orbitals
               if num_spin_orbitals is None else num_spin_orbitals)
        r = FusedOptOrbCASSCF(num_spin_orbitals=nso, problem=target,
                              **defaults).compute_minimum_energy()
        # core_energy varies with the field when cores are frozen — it
        # carries the frozen-core contribution to the response
        return r.eigenvalue + target.core_energy

    def alpha(atom: str) -> np.ndarray:
        problem = MoleculeDriver(atom, basis=basis, charge=charge,
                                 spin=spin,
                                 custom_basis=custom_basis).run()
        return polarizability(problem, solve_energy, field=field,
                              components=components)

    return alpha


def casscf_dipole_fn(basis: str = "sto-3g",
                     num_spin_orbitals: Optional[int] = None,
                     charge: int = 0, spin: int = 0,
                     n_frozen: Optional[int] = 0,
                     custom_basis=None, device="cuda", **solver_kwargs):
    """`atom_string -> (3,) dipole (a.u.)` from the exact-CASSCF 1-RDM
    (the `casscf_energy_fn` analogue for dipole surfaces / IR
    intensities)."""
    from ..orbital_optimization import FusedOptOrbCASSCF
    from .driver import MoleculeDriver
    from .properties import dipole_moment

    resolve_device(device)
    defaults = dict(maxiter=30, stopping_tolerance=1e-10,
                    inner_stopping_tolerance=1e-10, device=device)
    defaults.update(solver_kwargs)

    def dipole(atom: str) -> np.ndarray:
        problem = MoleculeDriver(atom, basis=basis, charge=charge,
                                 spin=spin,
                                 custom_basis=custom_basis).run()
        target = problem
        if n_frozen:
            target = problem.active_space(n_frozen=n_frozen)
        nso = (2 * target.num_spatial_orbitals
               if num_spin_orbitals is None else num_spin_orbitals)
        r = FusedOptOrbCASSCF(num_spin_orbitals=nso, problem=target,
                              **defaults).compute_minimum_energy()
        return dipole_moment(target, gamma_spatial=r.one_rdm_spatial,
                             partial_unitary=r.optimal_partial_unitary)

    return dipole


def casscf_state_energy_fn(basis: str = "sto-3g", state: int = 1,
                           k: Optional[int] = None, weight_vector=None,
                           num_spin_orbitals: Optional[int] = None,
                           charge: int = 0, spin: int = 0,
                           n_frozen: Optional[int] = 0,
                           custom_basis=None, device="cuda", **solver_kwargs):
    """`atom_string -> total energy of excited state `state`` from an
    SA-CASSCF solve (FusedOptOrbSACASSCF over k states, orbitals
    optimized for the weighted average) — the excited-state potential
    energy surface.  Feeding it to `nuclear_gradient` /
    `optimize_geometry` / `harmonic_frequencies` gives excited-state
    gradients, relaxed excited-state geometries (hence ADIABATIC vs
    vertical excitation energies), and excited-state frequencies; every
    FD point is an independent fully re-converged solve, so no response
    terms are needed.  k defaults to state+1; state=0, k=1 reduces
    exactly to `casscf_energy_fn`."""
    from ..orbital_optimization import FusedOptOrbSACASSCF
    from .driver import MoleculeDriver

    kk = (state + 1) if k is None else int(k)
    if not 0 <= state < kk:
        raise ValueError(f"state={state} out of range for k={kk}")
    resolve_device(device)
    defaults = dict(maxiter=30, stopping_tolerance=1e-10,
                    inner_stopping_tolerance=1e-10, device=device)
    defaults.update(solver_kwargs)

    def energy(atom: str) -> float:
        problem = MoleculeDriver(atom, basis=basis, charge=charge,
                                 spin=spin,
                                 custom_basis=custom_basis).run()
        if n_frozen:
            problem = problem.active_space(n_frozen=n_frozen)
        nso = (2 * problem.num_spatial_orbitals
               if num_spin_orbitals is None else num_spin_orbitals)
        r = FusedOptOrbSACASSCF(num_spin_orbitals=nso, k=kk,
                                weight_vector=weight_vector,
                                problem=problem,
                                **defaults).compute_energies()
        return (float(r.eigenvalues[state]) + problem.core_energy
                + problem.nuclear_repulsion_energy)

    return energy


def casscf_energy_fn(basis: str = "sto-3g",
                     num_spin_orbitals: Optional[int] = None,
                     charge: int = 0, spin: int = 0,
                     n_frozen: Optional[int] = 0,
                     custom_basis=None, device="cuda", **solver_kwargs):
    """`atom_string -> total energy` using exact active-space CASSCF
    (FusedOptOrbCASSCF — the package's variational upper baseline).
    num_spin_orbitals=None uses the FULL orbital space (FCI quality);
    n_frozen (default 0 = correlate everything) feeds active_space when
    a window is requested.  Total = electronic + core + nuclear
    repulsion."""
    from ..orbital_optimization import FusedOptOrbCASSCF
    from .driver import MoleculeDriver

    resolve_device(device)
    defaults = dict(maxiter=30, stopping_tolerance=1e-10,
                    inner_stopping_tolerance=1e-10, device=device)
    defaults.update(solver_kwargs)

    def energy(atom: str) -> float:
        problem = MoleculeDriver(atom, basis=basis, charge=charge,
                                 spin=spin,
                                 custom_basis=custom_basis).run()
        if n_frozen:
            problem = problem.active_space(n_frozen=n_frozen)
        nso = (2 * problem.num_spatial_orbitals
               if num_spin_orbitals is None else num_spin_orbitals)
        r = FusedOptOrbCASSCF(num_spin_orbitals=nso, problem=problem,
                              **defaults).compute_minimum_energy()
        return (r.eigenvalue + problem.core_energy
                + problem.nuclear_repulsion_energy)

    return energy


def optimize_transition_state(atom: str, energy_fn, gtol: float = 3e-4,
                              maxiter: int = 15, step: float = 1e-3,
                              hessian_step: float = 5e-3,
                              max_step: float = 0.3, callback=None):
    """First-order saddle-point (transition-state) search: full Newton
    steps on the central-FD gradient and Hessian with rigid-body
    motions PROJECTED OUT (Eckart-style Cartesian trans/rot basis —
    noisy near-zero FD eigenvalues would otherwise amplify gradient
    noise into large rigid displacements; a spectrum-relative cutoff
    drops the projected null modes).  Plain Newton converges to the
    saddle whose basin contains the starting guess — start near the
    expected TS.

    Returns a dict like optimize_geometry's plus:
      'hessian'     — the FD Hessian at the FINAL geometry (always
                      freshly evaluated there),
      'frequencies' — the `harmonic_frequencies`-style dict from that
                      Hessian (callers need no second Hessian pass),
      'n_negative'  — negative projected vibrational frequencies at the
                      solution (1 certifies a true TS).
    callback(atom, energy, gradient) fires once per iterate with all
    three evaluated at the SAME geometry.  `max_step` caps the
    per-iteration displacement norm (bohr)."""
    symbols, coords = parse_geometry(atom)
    natom = len(symbols)
    x = coords.ravel().copy()
    nev = [0]

    def _rigid_basis(xc):
        c = xc.reshape(coords.shape)
        rel = c - c.mean(axis=0)
        basis = []
        for d in range(3):
            t = np.zeros_like(c)
            t[:, d] = 1.0
            basis.append(t.ravel())
        for d in range(3):
            e = np.zeros(3)
            e[d] = 1.0
            basis.append(np.cross(rel, e).ravel())
        B = []
        for v in basis:
            for u in B:
                v = v - (u @ v) * u
            nv = np.linalg.norm(v)
            if nv > 1e-8:
                B.append(v / nv)
        return np.array(B)

    def _grad(at):
        nev[0] += 6 * natom
        return nuclear_gradient(at, energy_fn, step=step).ravel()

    g = None
    g_is_current = False
    converged = False
    for _ in range(maxiter):
        at = geometry_string(symbols, x.reshape(coords.shape))
        g = _grad(at)
        g_is_current = True
        if callback is not None:
            nev[0] += 1
            callback(at, float(energy_fn(at)), g.reshape(coords.shape))
        if np.abs(g).max() < gtol:
            converged = True
            break
        H = hessian(at, energy_fn, step=hessian_step)
        nev[0] += 1 + 6 * natom + 2 * 3 * natom * (3 * natom - 1)
        B = _rigid_basis(x)
        P = np.eye(3 * natom) - B.T @ B
        Hp = P @ H @ P
        gp = P @ g
        w, V = np.linalg.eigh(Hp)
        keep = np.abs(w) > 1e-6 * np.abs(w).max()
        dx = -(V[:, keep] @ ((V[:, keep].T @ gp) / w[keep]))
        norm = np.linalg.norm(dx)
        if norm > max_step:
            dx *= max_step / norm
        x = x + dx
        g_is_current = False

    at = geometry_string(symbols, x.reshape(coords.shape))
    e = float(energy_fn(at))
    nev[0] += 1
    if not g_is_current:
        g = _grad(at)
    # the certificate Hessian is ALWAYS evaluated at the final geometry
    H = hessian(at, energy_fn, step=hessian_step)
    nev[0] += 1 + 6 * natom + 2 * 3 * natom * (3 * natom - 1)
    fr = _frequencies_from_hessian(symbols, x.reshape(coords.shape), H)
    f = fr["frequencies_cm1"][fr["vib_mask"]]
    return {
        "atom": at,
        "coords": x.reshape(coords.shape),
        "energy": e,
        "gradient": g.reshape(coords.shape),
        "converged": bool(np.abs(g).max() < gtol),
        "hessian": H,
        "frequencies": fr,
        "n_negative": int(np.sum(f < -50.0)),
        "n_evaluations": nev[0],
    }


def reaction_path(atom: str, energy_fn, mode, direction: int = +1,
                  step: float = 0.05, max_steps: int = 40,
                  gtol: float = 3e-4, grad_step: float = 1e-3,
                  callback=None):
    """IRC-style reaction path: mass-weighted steepest descent from a
    transition state.  The first displacement follows ±`mode` (the
    imaginary-frequency mass-weighted normal mode from
    `harmonic_frequencies` at the TS); every further step follows
    −∇E in mass-weighted coordinates (damped Euler), `step` bohr·√amu
    per step, until max|∇E| < gtol (a minimum basin) or `max_steps`.

    Returns a dict: 'atoms' (list of geometry strings, TS first),
    'energies' (matching list), 'converged' (reached gtol).  Energies
    decrease monotonically along a correct descent path — certified by
    the H+H2 exchange test, whose two directions end in the two
    (equivalent) H2 + H valleys."""
    symbols, coords = parse_geometry(atom)
    m_amu = np.repeat(np.array([ISOTOPE_MASSES[s] for s in symbols]), 3)
    x = coords.ravel().copy()
    v = np.asarray(mode, dtype=np.float64).ravel()
    v = v / np.linalg.norm(v)
    # initial kick off the saddle along the transition mode
    x = x + direction * step * v / np.sqrt(m_amu)
    atoms = [atom]
    energies = [float(energy_fn(atom))]
    converged = False
    for _ in range(max_steps):
        at = geometry_string(symbols, x.reshape(coords.shape))
        e = float(energy_fn(at))
        atoms.append(at)
        energies.append(e)
        if callback is not None:
            callback(at, e)
        g = nuclear_gradient(at, energy_fn, step=grad_step).ravel()
        if np.abs(g).max() < gtol:
            converged = True
            break
        g_mw = g / np.sqrt(m_amu)
        x = x - step * (g_mw / np.linalg.norm(g_mw)) / np.sqrt(m_amu)
    return {"atoms": atoms, "energies": energies, "converged": converged}


def ccsd_energy_fn(basis: str = "sto-3g", charge: int = 0,
                   n_frozen: int = 0, triples: bool = False,
                   custom_basis=None, device="cuda", **cc_kwargs):
    """`atom_string -> total energy` at the CCSD (or CCSD(T)) level —
    the `casscf_energy_fn` analogue for the coupled-cluster surface,
    usable with optimize_geometry / harmonic_frequencies / hessian.
    For two-electron systems this surface is EXACTLY the FCI one
    (CCSD is exact there), which tests exploit.  `ccsd` itself is host
    NumPy; `device` is checked as every factory here checks it, so that a
    surface asked of the card raises where there is none."""
    from .cc import ccsd

    resolve_device(device)
    from .driver import MoleculeDriver

    def energy(atom: str) -> float:
        problem = MoleculeDriver(atom, basis=basis, charge=charge,
                                 custom_basis=custom_basis).run()
        r = ccsd(problem, n_frozen=n_frozen, triples=triples,
                 **cc_kwargs)
        if not r["converged"]:
            # a stale energy would silently corrupt FD gradients
            raise RuntimeError(
                f"CCSD did not converge at geometry '{atom}' "
                f"({r['n_iter']} iterations) — stretched-bond regions "
                f"are a known CC failure mode; use casscf_energy_fn "
                f"there")
        e = r["e_total_ccsd_t"] if triples else r["e_total"]
        return float(e)

    return energy


def _ghostify(fragment: str) -> str:
    from .basis import is_ghost

    parts = []
    for part in fragment.split(";"):
        toks = part.split()
        if not toks:
            continue
        sym = toks[0] if is_ghost(toks[0]) else "@" + toks[0]
        parts.append(" ".join([sym] + toks[1:]))
    return "; ".join(parts)


def counterpoise_interaction(fragment_a: str, fragment_b: str,
                             energy_fn) -> dict:
    """Boys–Bernardi counterpoise-corrected interaction energy between
    two fragments (geometry strings, Angstrom), over any total-energy
    callable (`casscf_energy_fn`, `ccsd_energy_fn`, ...):

        E_int^CP = E(AB) − E(A·@B) − E(@A·B)

    with @X the ghost version of fragment X (its basis functions, no
    nuclei/electrons).  Returns {'e_int_cp', 'e_int_raw' (monomer-basis
    monomers), 'bsse' = e_int_raw − e_int_cp ≤ 0 — the raw interaction
    is always artificially over-attractive (tested)}."""
    e_ab = float(energy_fn(fragment_a + "; " + fragment_b))
    e_a_cp = float(energy_fn(fragment_a + "; " + _ghostify(fragment_b)))
    e_b_cp = float(energy_fn(_ghostify(fragment_a) + "; " + fragment_b))
    e_a = float(energy_fn(fragment_a))
    e_b = float(energy_fn(fragment_b))
    e_cp = e_ab - e_a_cp - e_b_cp
    e_raw = e_ab - e_a - e_b
    return {"e_int_cp": e_cp, "e_int_raw": e_raw,
            "bsse": e_raw - e_cp}
