"""RHF molecular-orbital integrals of a molecule: the benchmark's inputs.

The part of esoo_torch/chem/driver.py (`MoleculeDriver.run`) that the
benchmark needs, over the frozen copies beside this file: AO integrals
(native C++ ERI when g++ can build it), closed-shell RHF, and the AO -> MO
quarter transforms in chemist order (pq|rs).  The port is handed these
tensors as a bare-integral problem; the reference reads the same tensors.
"""

from __future__ import annotations

import numpy as np

from .basis import ATOMIC_NUMBERS, build_shells, element_symbol, is_ghost
from .integrals import IntegralEngine
from .scf import rhf


def rhf_mo_integrals(atom: str, basis: str, charge: int = 0,
                     spin: int = 0) -> dict:
    """{"h": (m, m) MO core Hamiltonian, "eri": (m, m, m, m) chemist MO
    ERIs, "nuclear_repulsion", "num_particles": (na, nb), "rhf_energy"
    (total), "eri_engine"}, all float64."""
    if spin != 0:
        raise ValueError("the benchmark's inputs are closed-shell RHF")
    shells, symbols, coords = build_shells(atom, basis)
    charges = np.array(
        [0.0 if is_ghost(s) else ATOMIC_NUMBERS[element_symbol(s)]
         for s in symbols], dtype=np.float64)
    n_electrons = int(charges.sum()) - charge
    engine = IntegralEngine(shells, charges, coords)
    S, T, V = engine.one_electron()
    eri = engine.eri()
    hcore = T + V
    scf = rhf(S, hcore, eri, n_electrons, charges, coords)
    if not scf.converged:
        raise RuntimeError(f"RHF did not converge for {atom!r} {basis}")
    C = scf.mo_coeff
    h_mo = C.T @ hcore @ C
    tmp = np.einsum("pqrs,pi->iqrs", eri, C, optimize=True)
    tmp = np.einsum("iqrs,qj->ijrs", tmp, C, optimize=True)
    tmp = np.einsum("ijrs,rk->ijks", tmp, C, optimize=True)
    eri_mo = np.einsum("ijks,sl->ijkl", tmp, C, optimize=True)
    n_a = n_electrons // 2
    return {"h": h_mo, "eri": np.ascontiguousarray(eri_mo),
            "nuclear_repulsion": float(scf.nuclear_repulsion),
            "num_particles": (n_a, n_electrons - n_a),
            "rhf_energy": float(scf.energy_total),
            "eri_engine": engine.eri_engine}
