"""Ideal-gas RRHO thermochemistry on top of the harmonic analysis.

Copy of esoo_tpu/chem/thermo.py (host NumPy).

Given a geometry and a `harmonic_frequencies` result (or a raw list of
vibrational wavenumbers), computes the standard rigid-rotor /
harmonic-oscillator partition-function corrections: zero-point energy,
thermal internal energy / enthalpy, entropy (translational, rotational,
vibrational, electronic), and Gibbs free energy — the numbers every
quantum-chemistry package prints after a frequency job.  The reference
library evaluates no observables beyond the energy.

Conventions (matching Gaussian/ORCA/Psi4 "thermochemistry" output):
- ZPE is included in the thermal internal-energy correction.
- H = U + k_B T (ideal gas), G = H − T·S.
- Rotations are classical (high-T limit), vibrations quantum harmonic.
- `symmetry_number` is the external rotational symmetry number σ of the
  point group (H2/H2O: 2, NH3: 3, CH4: 12, C1/Cs/C∞v: 1).  It is NOT
  auto-detected — pass it, as every standard package requires.
- Imaginary modes and projected trans/rot modes are excluded from the
  vibrational sums (counted in `n_imaginary`).

All energies are returned in Hartree (per molecule); entropies also in
J/(mol·K) for direct comparison with tabulated gas-phase values.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .basis import parse_geometry
from .geometry import ISOTOPE_MASSES

# CODATA 2018 (SI)
_KB = 1.380649e-23            # J/K
_H = 6.62607015e-34           # J s
_NA = 6.02214076e23           # 1/mol
_C_CM = 2.99792458e10         # cm/s
_AMU_KG = 1.66053906660e-27   # kg
_BOHR_M = 0.529177210903e-10  # m
_HARTREE_J = 4.3597447222071e-18  # J
_R = _KB * _NA                # J/(mol K)


def _principal_moments(symbols, coords_bohr: np.ndarray) -> np.ndarray:
    """Principal moments of inertia (kg·m²), ascending."""
    m = np.array([ISOTOPE_MASSES[s] for s in symbols]) * _AMU_KG
    r = np.asarray(coords_bohr, dtype=np.float64) * _BOHR_M
    com = (m @ r) / m.sum()
    rel = r - com
    I = np.zeros((3, 3))
    for mi, ri in zip(m, rel):
        I += mi * ((ri @ ri) * np.eye(3) - np.outer(ri, ri))
    return np.sort(np.linalg.eigvalsh(I))


def thermochemistry(atom: str,
                    freq_result: Optional[dict] = None,
                    *,
                    frequencies_cm1: Optional[Sequence[float]] = None,
                    temperature: float = 298.15,
                    pressure: float = 101325.0,
                    symmetry_number: int = 1,
                    multiplicity: int = 1,
                    electronic_energy: Optional[float] = None) -> dict:
    """Ideal-gas RRHO thermochemistry at (T, P).

    Vibrations come either from `freq_result` (a `harmonic_frequencies`
    dict — its `vib_mask` filters trans/rot rows, and negative
    wavenumbers = imaginary modes are dropped) or from an explicit
    `frequencies_cm1` list of REAL vibrational wavenumbers (e.g.
    experimental values, for validating against tabulated entropies).

    Returns a dict (energies in Hartree unless suffixed):
      zpe, thermal_energy (E_trans+E_rot+E_vib incl. ZPE),
      enthalpy_correction (thermal_energy + k_B T),
      entropy_* (trans/rot/vib/elec/total, Hartree/K),
      entropy_J_mol_K (total, J/(mol·K)),
      gibbs_correction (enthalpy_correction − T·S_total),
      n_imaginary, and — when `electronic_energy` (total electronic +
      nuclear-repulsion Hartree) is given — internal_energy, enthalpy,
      gibbs_free_energy absolutes.
    """
    if temperature <= 0.0:
        raise ValueError("temperature must be positive (Kelvin)")
    symbols, coords = parse_geometry(atom)
    natom = len(symbols)
    T, P = float(temperature), float(pressure)

    # vibrational wavenumber list
    n_imag = 0
    if frequencies_cm1 is not None:
        nus = np.asarray(frequencies_cm1, dtype=np.float64)
        if np.any(nus <= 0):
            raise ValueError("explicit frequencies_cm1 must be positive "
                             "real vibrational wavenumbers")
    elif freq_result is not None:
        f = np.asarray(freq_result["frequencies_cm1"], dtype=np.float64)
        mask = np.asarray(freq_result.get(
            "vib_mask", np.ones(f.size, dtype=bool)))
        vib = f[mask]
        n_imag = int(np.sum(vib < 0))
        nus = vib[vib > 0]
    elif natom == 1:
        nus = np.zeros(0)
    else:
        raise ValueError("pass freq_result= (harmonic_frequencies "
                         "output) or frequencies_cm1=")

    # --- translation: Sackur–Tetrode ---------------------------------
    mass = sum(ISOTOPE_MASSES[s] for s in symbols) * _AMU_KG
    q_t = ((2.0 * np.pi * mass * _KB * T / _H ** 2) ** 1.5
           * _KB * T / P)
    S_t = _R * (np.log(q_t) + 2.5)
    E_t = 1.5 * _R * T

    # --- rotation (classical rigid rotor) ----------------------------
    sigma = float(symmetry_number)
    if natom == 1:
        S_r, E_r = 0.0, 0.0
    else:
        I1, I2, I3 = _principal_moments(symbols, coords)
        linear = I1 / I3 < 1e-8
        if linear:
            theta = _H ** 2 / (8.0 * np.pi ** 2 * I3 * _KB)
            q_r = T / (sigma * theta)
            S_r = _R * (np.log(q_r) + 1.0)
            E_r = _R * T
        else:
            thetas = _H ** 2 / (8.0 * np.pi ** 2 * _KB
                                * np.array([I1, I2, I3]))
            q_r = (np.sqrt(np.pi) / sigma
                   * np.sqrt(T ** 3 / np.prod(thetas)))
            S_r = _R * (np.log(q_r) + 1.5)
            E_r = 1.5 * _R * T

    # --- vibration (quantum harmonic, ZPE-inclusive energy) ----------
    theta_v = _H * _C_CM * nus / _KB          # vibrational temperatures
    x = theta_v / T
    ex = np.expm1(x)                          # e^x - 1, stable
    zpe_J = 0.5 * _H * _C_CM * float(nus.sum())        # per molecule
    E_v = _R * float(np.sum(theta_v * (0.5 + 1.0 / ex)))
    S_v = _R * float(np.sum(x / ex - np.log1p(-np.exp(-x))))

    # --- electronic ---------------------------------------------------
    S_e = _R * np.log(float(multiplicity))

    # assemble (J/mol → Hartree per molecule)
    to_h = 1.0 / (_HARTREE_J * _NA)
    zpe = zpe_J / _HARTREE_J
    thermal_energy = (E_t + E_r + E_v) * to_h          # includes ZPE
    enthalpy_corr = thermal_energy + _R * T * to_h
    S_total = S_t + S_r + S_v + S_e
    gibbs_corr = enthalpy_corr - T * S_total * to_h

    out = {
        "temperature": T,
        "pressure": P,
        "zpe": zpe,
        "thermal_energy": thermal_energy,
        "enthalpy_correction": enthalpy_corr,
        "entropy_trans": S_t * to_h,
        "entropy_rot": S_r * to_h,
        "entropy_vib": S_v * to_h,
        "entropy_elec": S_e * to_h,
        "entropy_total": S_total * to_h,
        "entropy_J_mol_K": S_total,
        "gibbs_correction": gibbs_corr,
        "n_imaginary": n_imag,
    }
    if electronic_energy is not None:
        e0 = float(electronic_energy)
        out["internal_energy"] = e0 + thermal_energy
        out["enthalpy"] = e0 + enthalpy_corr
        out["gibbs_free_energy"] = e0 + gibbs_corr
    return out


def eyring_rate(delta_g_activation: float,
                temperature: float = 298.15) -> float:
    """Transition-state-theory rate constant (transmission coefficient
    1): k(T) = (k_B T / h)·exp(−ΔG‡ / k_B T), with ΔG‡ in Hartree (the
    Gibbs free energy of activation from two `thermochemistry` calls —
    the TS one computed from a `harmonic_frequencies` result whose
    imaginary mode is automatically excluded).  Returns 1/s for a
    unimolecular step; for bimolecular reactions multiply by the
    standard-state volume factor of your ΔG‡ convention."""
    if temperature <= 0.0:
        raise ValueError("temperature must be positive (Kelvin)")
    kT = _KB * temperature
    return (kT / _H) * float(np.exp(-float(delta_g_activation)
                                    * _HARTREE_J / kT))
